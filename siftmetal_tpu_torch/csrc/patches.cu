// Per-keypoint patch histograms: orientation (36 bins) and descriptor
// (4 x 4 x 8 bins).
//
// Replace the TPU kernels siftmetal_tpu/ops/pallas/patches.py
// _orientation_kernel (through orientation_hist_lanes_pallas) and
// _descriptor_kernel (through descriptor_lanes_pallas). What they compute
// is the same (IPOL Anatomy of SIFT, Alg. 11 and 12):
//
//   orientation: for a keypoint lane, the raw histogram over the box
//     |dm|, |dn| <= 3 lambda_ori sigma of gradient orientation
//     round(atan2(gj, gi) / (2 pi / n_bins)) mod n_bins, weighted by the
//     gradient magnitude and a Gaussian of width lambda_ori sigma;
//   descriptor: for a (keypoint, orientation) lane, the raw histogram over
//     the theta-rotated box |xr|, |yr| < lambda_descr (n+1)/n, with
//     trilinear (tent) soft assignment to n x n spatial cells and n_ori
//     orientation bins, weighted by magnitude and a Gaussian of width
//     lambda_descr.
//
// The patch is centred on the rounded keypoint with a static radius, and
// samples outside the image contribute nothing (IPOL's rule, which the
// TPU reproduced with zero padding). Invalid lanes write zeros.
//
// Layout: one block per lane; threads stride over the sample box, which
// is cut to the sigma-dependent window (never wider than the static
// radius). Each thread adds into its own histogram column in shared
// memory ([bin][thread], so thread t always hits bank t % 32 and no atomics
// are needed); the columns are summed in a fixed order at the end, so a
// run repeats bit for bit. A sample's descriptor weight is non-zero in at
// most 2 x 2 x 2 bins. atan2f is used directly (the TPU needed a
// polynomial).
//
// Fused form (replaces _orient_desc_kernel, through
// orient_desc_lanes_pallas): one block per KEYPOINT builds the orientation
// histogram as above, then one thread runs the circular box smoothings,
// the peak test (local maximum, >= peak_thr * max, > 0) and the parabolic
// refinement on the shared-memory histogram, keeps the first max_ori peaks
// in BIN order (IPOL's emission order; the staged path keeps the highest
// max_ori, which differs only for a keypoint with more peaks than that),
// and the block then accumulates one descriptor per kept peak with the
// same device functions as the staged kernels. Nothing between the two
// stages goes through device memory and no lanes are compacted on the
// host. Invalid lanes and missing peaks write zeros.
//
// Resident-tile form (replaces _lanes_banded_call, siftmetal_tpu/ops/pallas/
// patches.py:1053, the band-resident mode of the two staged TPU kernels):
// the same histograms in the caller's lane order, with the gradient region
// that a group of neighbouring lanes reads copied on chip once. The TPU
// kept a 128-row full-width band of the stacked field in VMEM (megabytes);
// a block here has 227 KB, so the resident region is a 2-D tile of one
// (frame, scale) plane: all lanes whose clamped rounded centre falls in one
// tile x tile square form a run (the wrapper sorts lanes by tile, stably,
// in PyTorch), one block takes one run, copies the bounding box of its
// lanes' sample windows (never more than (tile + 2 radius)^2 pixels of gi
// and gj) into shared memory with coalesced loads, and then accumulates
// lane after lane with the staged kernels' device functions, thread order
// and block size, reading gi/gj from the copy. Each lane's row goes
// straight to out[lane], so the result equals the staged kernel's bit for
// bit and no un-permute pass exists. Shared memory: orientation tile 32,
// radius 18: 68^2 x 2 x 4 B = 37 KB + 36 x 128 x 4 B of columns = 55 KB
// (four blocks an SM); descriptor tile 16, radius 40: 96^2 x 2 x 4 B =
// 74 KB + 128 x 64 x 4 B = 106 KB (two blocks an SM; a 48-pixel tile would
// need 160 KB and leave an SM one block of two warps). Every octave takes
// this form: the TPU's rows >= band-rows gate was a buffer-size condition.
// What bounds it: as the staged kernels, plus the copy, which pays only
// where several lanes share a tile (a keypoint's orientations always do).
//
// Bound on an H100, by chip_smoke.py's count at the main path's octave-0
// lanes (each distinct gradient pixel read once; about 90 fp32 operations
// per orientation sample and 284 per descriptor sample, a division counted
// 8, sqrt 6, exp 6, atan2 35): the descriptor, fused and resident
// descriptor kernels by operations, the two orientation kernels by bytes,
// the two sides never more than 2x apart. Every kernel runs 14-110x above
// that: what they wait for is latency (one block of 64-128 threads a lane,
// windows that hit L1/L2, the special-function unit), not a roofline.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr double kPi = 3.14159265358979323846;
constexpr float kTwoPi = 6.28318548202514648f;  // fp32(2 pi)

__device__ __forceinline__ float mod_2pi(float a) {
  // Floor-mod with the divisor's sign (jnp.mod / torch.remainder).
  float m = fmodf(a, kTwoPi);
  if (m != 0.f && m < 0.f) m += kTwoPi;
  return m;
}

struct Lane {
  int f, s, ci, cj;
  float x, y, sg;
};

__device__ __forceinline__ Lane lane_of(int l, int B, int S, int H, int W,
                                        const int* frame, const int* scale,
                                        const float* x, const float* y,
                                        const float* sigma) {
  Lane ln;
  ln.f = min(max(frame[l], 0), B - 1);
  ln.s = min(max(scale[l], 1), S) - 1;
  ln.x = x[l];
  ln.y = y[l];
  ln.sg = sigma[l];
  ln.ci = min(max((int)rintf(ln.x), 0), H - 1);
  ln.cj = min(max((int)rintf(ln.y), 0), W - 1);
  return ln;
}

// The sample box of a lane: rows u0..u1, columns v0..v1 of its plane, the
// sigma-dependent reach cut to the static radius and to the image.
struct Window {
  int u0, u1, v0, v1;
};

__device__ __forceinline__ Window window_of(const Lane& ln, int reach, int H,
                                            int W) {
  Window wd;
  wd.u0 = max(ln.ci - reach, 0);
  wd.u1 = min(ln.ci + reach, H - 1);
  wd.v0 = max(ln.cj - reach, 0);
  wd.v1 = min(ln.cj + reach, W - 1);
  return wd;
}

__device__ __forceinline__ Window orientation_window(const Lane& ln, int H,
                                                     int W, int radius,
                                                     float lam) {
  const float r_max = (float)(3.0 * (double)lam) * ln.sg;
  return window_of(ln, min(radius, (int)ceilf(r_max) + 1), H, W);
}

__device__ __forceinline__ Window descriptor_window(const Lane& ln, int H,
                                                    int W, int radius,
                                                    int n_hist, float lam) {
  const float half = (float)((double)lam * (n_hist + 1) / n_hist);
  return window_of(
      ln, min(radius, (int)ceilf(1.41421356f * half * ln.sg + 0.5f) + 1), H, W);
}

// A rectangle of the lane's (frame, scale) plane of gi and gj: pixel
// (u, v) is at [(u - r0) * pitch + (v - c0)]. The staged kernels pass the
// plane itself in device memory, the resident-tile kernels a copy of part
// of it in shared memory.
struct Field {
  const float* __restrict__ gi;
  const float* __restrict__ gj;
  int pitch, r0, c0;
};

__device__ __forceinline__ Field plane_field(const Lane& ln, const float* gi,
                                             const float* gj, int S, int H,
                                             int W) {
  const long long base = ((long long)ln.f * S + ln.s) * H * W;
  return Field{gi + base, gj + base, W, 0, 0};
}

// Adds lane `ln`'s orientation samples into the per-thread columns
// hist[bin * nt + tid] (zeroed by the caller).
__device__ __forceinline__ void orientation_accumulate(
    float* hist, int tid, int nt, const Lane& ln, const Field& fd, int H, int W,
    int radius, int n_bins, float lam) {
  const float r_max = (float)(3.0 * (double)lam) * ln.sg;
  const float ls = lam * ln.sg;
  const float den = 2.0f * (ls * ls);
  const float bin_scale = (float)((double)n_bins / (2.0 * kPi));
  const Window wd = orientation_window(ln, H, W, radius, lam);
  const int u0 = wd.u0, v0 = wd.v0;
  const int nv = wd.v1 - v0 + 1;
  const int n = (wd.u1 - u0 + 1) * nv;
  for (int p = tid; p < n; p += nt) {
    const int u = u0 + p / nv, v = v0 + p % nv;
    const float dm = (float)u - ln.x;
    const float dn = (float)v - ln.y;
    if (!(fabsf(dm) <= r_max && fabsf(dn) <= r_max)) continue;
    const int o = (u - fd.r0) * fd.pitch + (v - fd.c0);
    const float a = fd.gi[o], b = fd.gj[o];
    const float mag = sqrtf(a * a + b * b);
    const float w = expf(-(dm * dm + dn * dn) / den) * mag;
    const float th = mod_2pi(atan2f(b, a));
    int bin = (int)rintf(th * bin_scale);
    bin = ((bin % n_bins) + n_bins) % n_bins;
    hist[bin * nt + tid] += w;
  }
}

// Sum of column k over the threads, in a fixed (bank-staggered) order.
__device__ __forceinline__ float column_sum(const float* hist, int k, int nt) {
  float acc = 0.f;
  for (int t = 0; t < nt; ++t) acc += hist[k * nt + (t + k) % nt];
  return acc;
}

__global__ void orientation_kernel(const float* __restrict__ gi,
                                   const float* __restrict__ gj, int B, int S,
                                   int H, int W, const uint8_t* __restrict__ valid,
                                   const int* __restrict__ frame,
                                   const int* __restrict__ scale,
                                   const float* __restrict__ x,
                                   const float* __restrict__ y,
                                   const float* __restrict__ sigma, int radius,
                                   int n_bins, float lam,
                                   float* __restrict__ out) {
  extern __shared__ float hist[];  // [n_bins][NT]
  const int l = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  float* out_l = out + (long long)l * n_bins;
  if (!valid[l]) {
    for (int k = tid; k < n_bins; k += nt) out_l[k] = 0.f;
    return;
  }
  for (int k = 0; k < n_bins; ++k) hist[k * nt + tid] = 0.f;
  const Lane ln = lane_of(l, B, S, H, W, frame, scale, x, y, sigma);
  orientation_accumulate(hist, tid, nt, ln, plane_field(ln, gi, gj, S, H, W),
                         H, W, radius, n_bins, lam);
  __syncthreads();
  for (int k = tid; k < n_bins; k += nt) out_l[k] = column_sum(hist, k, nt);
}

constexpr int kMaxHist = 8;
constexpr int kMaxOri = 16;

// Adds lane `ln`'s descriptor samples for reference orientation `th` into
// the per-thread columns hist[bin * nt + tid] (zeroed by the caller).
__device__ __forceinline__ void descriptor_accumulate(
    float* hist, int tid, int nt, const Lane& ln, float th, const Field& fd,
    int H, int W, int radius, int n_hist, int n_ori, float lam) {
  const float ct = cosf(th), st = sinf(th);
  const float half = (float)((double)lam * (n_hist + 1) / n_hist);
  const float den = (float)(2.0 * (double)lam * (double)lam);
  const float cell = (float)(2.0 * (double)lam / n_hist);
  const float c_off = (float)((n_hist + 1) / 2.0);
  const float o_step = (float)(2.0 * kPi / n_ori);
  const float o_scale = (float)(n_ori / (2.0 * kPi));
  const Window wd = descriptor_window(ln, H, W, radius, n_hist, lam);
  const int u0 = wd.u0, v0 = wd.v0;
  const int nv = wd.v1 - v0 + 1;
  const int n = (wd.u1 - u0 + 1) * nv;
  for (int p = tid; p < n; p += nt) {
    const int u = u0 + p / nv, v = v0 + p % nv;
    const float dm = (float)u - ln.x;
    const float dn = (float)v - ln.y;
    const float xr = (ct * dm + st * dn) / ln.sg;
    const float yr = (-st * dm + ct * dn) / ln.sg;
    if (!(fabsf(xr) < half && fabsf(yr) < half)) continue;
    const int o = (u - fd.r0) * fd.pitch + (v - fd.c0);
    const float a = fd.gi[o], b = fd.gj[o];
    const float mag = sqrtf(a * a + b * b);
    const float contrib = expf(-(xr * xr + yr * yr) / den) * mag;
    float wr[kMaxHist], wc[kMaxHist], wo[kMaxOri];
    for (int c = 0; c < n_hist; ++c) {
      const float center = ((float)(c + 1) - c_off) * cell;
      wr[c] = fmaxf(0.f, 1.f - fabsf(xr - center) / cell);
      wc[c] = fmaxf(0.f, 1.f - fabsf(yr - center) / cell);
    }
    const float phi = mod_2pi(atan2f(b, a) - th);
    for (int k = 0; k < n_ori; ++k) {
      float d = fabsf(phi - (float)k * o_step);
      d = fminf(d, kTwoPi - d);
      wo[k] = fmaxf(0.f, 1.f - d * o_scale);
    }
    for (int r = 0; r < n_hist; ++r) {
      if (wr[r] == 0.f) continue;
      const float cr = contrib * wr[r];
      for (int c = 0; c < n_hist; ++c) {
        if (wc[c] == 0.f) continue;
        const float crc = cr * wc[c];
        float* hb = hist + ((r * n_hist + c) * n_ori) * nt + tid;
        for (int k = 0; k < n_ori; ++k)
          if (wo[k] != 0.f) hb[k * nt] += crc * wo[k];
      }
    }
  }
}

__global__ void descriptor_kernel(const float* __restrict__ gi,
                                  const float* __restrict__ gj, int B, int S,
                                  int H, int W, const uint8_t* __restrict__ valid,
                                  const int* __restrict__ frame,
                                  const int* __restrict__ scale,
                                  const float* __restrict__ x,
                                  const float* __restrict__ y,
                                  const float* __restrict__ sigma,
                                  const float* __restrict__ theta, int radius,
                                  int n_hist, int n_ori, float lam,
                                  float* __restrict__ out) {
  extern __shared__ float hist[];  // [n_hist * n_hist * n_ori][NT]
  const int l = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int n_out = n_hist * n_hist * n_ori;
  float* out_l = out + (long long)l * n_out;
  if (!valid[l]) {
    for (int k = tid; k < n_out; k += nt) out_l[k] = 0.f;
    return;
  }
  for (int k = 0; k < n_out; ++k) hist[k * nt + tid] = 0.f;
  const Lane ln = lane_of(l, B, S, H, W, frame, scale, x, y, sigma);
  descriptor_accumulate(hist, tid, nt, ln, theta[l],
                        plane_field(ln, gi, gj, S, H, W), H, W, radius, n_hist,
                        n_ori, lam);
  __syncthreads();
  for (int k = tid; k < n_out; k += nt) out_l[k] = column_sum(hist, k, nt);
}

constexpr int kMaxBins = 64;
constexpr int kMaxPeaks = 8;

__global__ void orient_desc_kernel(
    const float* __restrict__ gi, const float* __restrict__ gj, int B, int S,
    int H, int W, const uint8_t* __restrict__ valid,
    const int* __restrict__ frame, const int* __restrict__ scale,
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ sigma, int ori_radius, int n_bins, float lam_ori,
    int smooth_iters, float peak_thr, int max_ori, int desc_radius, int n_hist,
    int n_ori, float lam_desc, float* __restrict__ raw,
    float* __restrict__ theta, uint8_t* __restrict__ ori_valid) {
  extern __shared__ float hist[];  // [max(n_bins, n_hist^2 n_ori)][NT]
  __shared__ float h[2][kMaxBins];
  __shared__ float th_p[kMaxPeaks];
  __shared__ int n_peaks;
  const int l = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int n_out = n_hist * n_hist * n_ori;
  float* raw_l = raw + (long long)l * max_ori * n_out;
  if (!valid[l]) {
    for (int k = tid; k < max_ori * n_out; k += nt) raw_l[k] = 0.f;
    for (int k = tid; k < max_ori; k += nt) {
      theta[(long long)l * max_ori + k] = 0.f;
      ori_valid[(long long)l * max_ori + k] = 0;
    }
    return;
  }
  const Lane ln = lane_of(l, B, S, H, W, frame, scale, x, y, sigma);

  // Orientation histogram.
  for (int k = 0; k < n_bins; ++k) hist[k * nt + tid] = 0.f;
  const Field fd = plane_field(ln, gi, gj, S, H, W);
  orientation_accumulate(hist, tid, nt, ln, fd, H, W, ori_radius, n_bins,
                         lam_ori);
  __syncthreads();
  for (int k = tid; k < n_bins; k += nt) h[0][k] = column_sum(hist, k, nt);
  __syncthreads();

  // Smoothing, peaks and the parabolic offset: n_bins values, one thread.
  // Products and sums round separately, as the plain version's do.
  if (tid == 0) {
    int cur = 0;
    for (int it = 0; it < smooth_iters; ++it) {
      for (int k = 0; k < n_bins; ++k) {
        const float pv = h[cur][(k + n_bins - 1) % n_bins];
        const float nx = h[cur][(k + 1) % n_bins];
        h[cur ^ 1][k] = __fadd_rn(__fadd_rn(pv, h[cur][k]), nx) / 3.0f;
      }
      cur ^= 1;
    }
    float hmax = h[cur][0];
    for (int k = 1; k < n_bins; ++k) hmax = fmaxf(hmax, h[cur][k]);
    const float floor_v = __fmul_rn(peak_thr, hmax);
    const float bin_w = (float)(2.0 * kPi / n_bins);
    const float pi_f = (float)kPi;
    int np = 0;
    for (int k = 0; k < n_bins && np < max_ori; ++k) {
      const float c = h[cur][k];
      const float pv = h[cur][(k + n_bins - 1) % n_bins];
      const float nx = h[cur][(k + 1) % n_bins];
      if (!(c > pv && c > nx && c >= floor_v && c > 0.f)) continue;
      const float den = __fmul_rn(
          2.0f, __fsub_rn(__fadd_rn(pv, nx), __fmul_rn(2.0f, c)));
      const float off = __fsub_rn(pv, nx) / den;
      const float t = __fmul_rn(__fadd_rn(__fadd_rn((float)k, 0.5f), off), bin_w);
      th_p[np++] = __fsub_rn(mod_2pi(__fadd_rn(t, pi_f)), pi_f);
    }
    n_peaks = np;
  }
  __syncthreads();
  const int np = n_peaks;
  for (int k = tid; k < max_ori; k += nt) {
    theta[(long long)l * max_ori + k] = k < np ? th_p[k] : 0.f;
    ori_valid[(long long)l * max_ori + k] = k < np ? 1 : 0;
  }

  // One descriptor per kept peak.
  for (int p = 0; p < max_ori; ++p) {
    float* out_p = raw_l + (long long)p * n_out;
    if (p >= np) {
      for (int k = tid; k < n_out; k += nt) out_p[k] = 0.f;
      continue;
    }
    __syncthreads();  // the previous peak's column sums are done
    for (int k = 0; k < n_out; ++k) hist[k * nt + tid] = 0.f;
    descriptor_accumulate(hist, tid, nt, ln, th_p[p], fd, H, W, desc_radius,
                          n_hist, n_ori, lam_desc);
    __syncthreads();
    for (int k = tid; k < n_out; k += nt) out_p[k] = column_sum(hist, k, nt);
  }
}

// Resident-tile form of the two staged kernels (kDesc: descriptor, else
// orientation). Block p takes the run of sorted lanes that starts at
// position p (first[p]) and ends before run_end[p]; src[q] is the lane at
// sorted position q. Every lane of a run has the same (frame, scale) and
// its centre in the same tile x tile square. pa, pb: (n_bins, unused) or
// (n_hist, n_ori). Rows of lanes that belong to no run (invalid lanes)
// are not written: the wrapper hands in zeros.
template <bool kDesc>
__global__ void resident_kernel(
    const float* __restrict__ gi, const float* __restrict__ gj, int B, int S,
    int H, int W, const uint8_t* __restrict__ first,
    const int* __restrict__ run_end, const int* __restrict__ src,
    const int* __restrict__ frame, const int* __restrict__ scale,
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ sigma, const float* __restrict__ theta,
    int radius, int tile, int pa, int pb, float lam, int n_out,
    float* __restrict__ out) {
  extern __shared__ float smem[];  // [n_out][NT] columns, then gi, gj copies
  __shared__ int box[4];
  const int p = blockIdx.x;
  if (!first[p]) return;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int end = run_end[p];
  const int side = tile + 2 * radius;
  float* hist = smem;
  float* reg_i = smem + n_out * nt;
  float* reg_j = reg_i + side * side;

  // Bounding box of the run's sample windows.
  if (tid == 0) {
    box[0] = H;
    box[1] = -1;
    box[2] = W;
    box[3] = -1;
  }
  __syncthreads();
  for (int q = p + tid; q < end; q += nt) {
    const Lane ln = lane_of(src[q], B, S, H, W, frame, scale, x, y, sigma);
    const Window wd = kDesc ? descriptor_window(ln, H, W, radius, pa, lam)
                            : orientation_window(ln, H, W, radius, lam);
    atomicMin(&box[0], wd.u0);
    atomicMax(&box[1], wd.u1);
    atomicMin(&box[2], wd.v0);
    atomicMax(&box[3], wd.v1);
  }
  __syncthreads();
  const int r0 = box[0], c0 = box[2];
  const int rows = box[1] - r0 + 1, pitch = box[3] - c0 + 1;
  if (rows > side || pitch > side) {
    // The run was not laid out with this tile: refuse loudly rather than
    // write past the copy.
    for (int q = p; q < end; ++q)
      for (int k = tid; k < n_out; k += nt)
        out[(long long)src[q] * n_out + k] = nanf("");
    return;
  }
  const Lane l0 = lane_of(src[p], B, S, H, W, frame, scale, x, y, sigma);
  const Field plane = plane_field(l0, gi, gj, S, H, W);
  for (int i = tid; i < rows * pitch; i += nt) {
    const int o = (r0 + i / pitch) * W + (c0 + i % pitch);
    reg_i[i] = plane.gi[o];
    reg_j[i] = plane.gj[o];
  }
  __syncthreads();
  const Field fd{reg_i, reg_j, pitch, r0, c0};

  for (int q = p; q < end; ++q) {
    const int l = src[q];
    const Lane ln = lane_of(l, B, S, H, W, frame, scale, x, y, sigma);
    for (int k = 0; k < n_out; ++k) hist[k * nt + tid] = 0.f;
    if (kDesc)
      descriptor_accumulate(hist, tid, nt, ln, theta[l], fd, H, W, radius, pa,
                            pb, lam);
    else
      orientation_accumulate(hist, tid, nt, ln, fd, H, W, radius, pa, lam);
    __syncthreads();
    float* out_l = out + (long long)l * n_out;
    for (int k = tid; k < n_out; k += nt) out_l[k] = column_sum(hist, k, nt);
    __syncthreads();  // the sums are read before the next lane zeroes them
  }
}

constexpr int kMaxDynamicShared = 232448;  // 227 KB a block on sm_90

template <bool kDesc>
int launch_resident(const float* gi, const float* gj, int B, int S, int H,
                    int W, int L, const uint8_t* first, const int* run_end,
                    const int* src, const int* frame, const int* scale,
                    const float* x, const float* y, const float* sigma,
                    const float* theta, int radius, int tile, int pa, int pb,
                    float lam, int n_out, int nt, float* out,
                    cudaStream_t stream) {
  if (tile < 1 || radius < 0) return (int)cudaErrorInvalidValue;
  const long long side = (long long)tile + 2 * radius;
  const long long bytes =
      ((long long)n_out * nt + 2 * side * side) * (long long)sizeof(float);
  if (bytes > kMaxDynamicShared) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      resident_kernel<kDesc>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  if (L > 0)
    resident_kernel<kDesc><<<L, nt, (size_t)bytes, stream>>>(
        gi, gj, B, S, H, W, first, run_end, src, frame, scale, x, y, sigma,
        theta, radius, tile, pa, pb, lam, n_out, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int orientation_hist(const float* gi, const float* gj, int B,
                                int S, int H, int W, int L,
                                const uint8_t* valid, const int* frame,
                                const int* scale, const float* x,
                                const float* y, const float* sigma,
                                int radius, int n_bins, float lam, float* out,
                                cudaStream_t stream) {
  const int nt = 128;
  if (L > 0)
    orientation_kernel<<<L, nt, n_bins * nt * sizeof(float), stream>>>(
        gi, gj, B, S, H, W, valid, frame, scale, x, y, sigma, radius, n_bins,
        lam, out);
  return (int)cudaGetLastError();
}

extern "C" int descriptor_hist(const float* gi, const float* gj, int B,
                               int S, int H, int W, int L,
                               const uint8_t* valid, const int* frame,
                               const int* scale, const float* x,
                               const float* y, const float* sigma,
                               const float* theta, int radius, int n_hist,
                               int n_ori, float lam, float* out,
                               cudaStream_t stream) {
  if (n_hist > kMaxHist || n_ori > kMaxOri) return (int)cudaErrorInvalidValue;
  const int nt = 64;
  if (L > 0)
    descriptor_kernel<<<L, nt, n_hist * n_hist * n_ori * nt * sizeof(float),
                        stream>>>(gi, gj, B, S, H, W, valid, frame, scale, x,
                                  y, sigma, theta, radius, n_hist, n_ori, lam,
                                  out);
  return (int)cudaGetLastError();
}

extern "C" int orient_desc(const float* gi, const float* gj, int B, int S,
                           int H, int W, int L, const uint8_t* valid,
                           const int* frame, const int* scale, const float* x,
                           const float* y, const float* sigma, int ori_radius,
                           int n_bins, float lam_ori, int smooth_iters,
                           float peak_thr, int max_ori, int desc_radius,
                           int n_hist, int n_ori, float lam_desc, float* raw,
                           float* theta, uint8_t* ori_valid,
                           cudaStream_t stream) {
  if (n_hist > kMaxHist || n_ori > kMaxOri || n_bins > kMaxBins ||
      max_ori > kMaxPeaks || max_ori < 1)
    return (int)cudaErrorInvalidValue;
  const int nt = 64;
  const int n_out = n_hist * n_hist * n_ori;
  const int cols = n_out > n_bins ? n_out : n_bins;
  if (L > 0)
    orient_desc_kernel<<<L, nt, cols * nt * sizeof(float), stream>>>(
        gi, gj, B, S, H, W, valid, frame, scale, x, y, sigma, ori_radius,
        n_bins, lam_ori, smooth_iters, peak_thr, max_ori, desc_radius, n_hist,
        n_ori, lam_desc, raw, theta, ori_valid);
  return (int)cudaGetLastError();
}

// Resident-tile forms: `first`, `run_end`, `src` are the [L] tile layout
// of the lanes (see resident_kernel); `out` must be zeroed by the caller.
// Block sizes are the staged kernels', so the results equal theirs.
extern "C" int orientation_hist_banded(
    const float* gi, const float* gj, int B, int S, int H, int W, int L,
    const uint8_t* first, const int* run_end, const int* src, const int* frame,
    const int* scale, const float* x, const float* y, const float* sigma,
    int radius, int tile, int n_bins, float lam, float* out,
    cudaStream_t stream) {
  return launch_resident<false>(gi, gj, B, S, H, W, L, first, run_end, src,
                                frame, scale, x, y, sigma, nullptr, radius,
                                tile, n_bins, 0, lam, n_bins, 128, out, stream);
}

extern "C" int descriptor_hist_banded(
    const float* gi, const float* gj, int B, int S, int H, int W, int L,
    const uint8_t* first, const int* run_end, const int* src, const int* frame,
    const int* scale, const float* x, const float* y, const float* sigma,
    const float* theta, int radius, int tile, int n_hist, int n_ori, float lam,
    float* out, cudaStream_t stream) {
  if (n_hist > kMaxHist || n_ori > kMaxOri) return (int)cudaErrorInvalidValue;
  return launch_resident<true>(gi, gj, B, S, H, W, L, first, run_end, src,
                               frame, scale, x, y, sigma, theta, radius, tile,
                               n_hist, n_ori, lam, n_hist * n_hist * n_ori, 64,
                               out, stream);
}
