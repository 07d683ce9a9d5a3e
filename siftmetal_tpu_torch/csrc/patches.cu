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
// Bound on an H100: operations (exp, atan2, sqrt and the tent weights per
// sample), not bytes: the gradient windows are small and hit L1/L2.

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

// Adds lane `ln`'s orientation samples into the per-thread columns
// hist[bin * nt + tid] (zeroed by the caller).
__device__ __forceinline__ void orientation_accumulate(
    float* hist, int tid, int nt, const Lane& ln, const float* __restrict__ gi,
    const float* __restrict__ gj, int S, int H, int W, int radius, int n_bins,
    float lam) {
  const float r_max = (float)(3.0 * (double)lam) * ln.sg;
  const float ls = lam * ln.sg;
  const float den = 2.0f * (ls * ls);
  const float bin_scale = (float)((double)n_bins / (2.0 * kPi));
  const int reach = min(radius, (int)ceilf(r_max) + 1);
  const int u0 = max(ln.ci - reach, 0), u1 = min(ln.ci + reach, H - 1);
  const int v0 = max(ln.cj - reach, 0), v1 = min(ln.cj + reach, W - 1);
  const int nv = v1 - v0 + 1;
  const int n = (u1 - u0 + 1) * nv;
  const long long base = ((long long)ln.f * S + ln.s) * H * W;
  for (int p = tid; p < n; p += nt) {
    const int u = u0 + p / nv, v = v0 + p % nv;
    const float dm = (float)u - ln.x;
    const float dn = (float)v - ln.y;
    if (!(fabsf(dm) <= r_max && fabsf(dn) <= r_max)) continue;
    const long long o = base + (long long)u * W + v;
    const float a = gi[o], b = gj[o];
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
  orientation_accumulate(hist, tid, nt, ln, gi, gj, S, H, W, radius, n_bins,
                         lam);
  __syncthreads();
  for (int k = tid; k < n_bins; k += nt) out_l[k] = column_sum(hist, k, nt);
}

constexpr int kMaxHist = 8;
constexpr int kMaxOri = 16;

// Adds lane `ln`'s descriptor samples for reference orientation `th` into
// the per-thread columns hist[bin * nt + tid] (zeroed by the caller).
__device__ __forceinline__ void descriptor_accumulate(
    float* hist, int tid, int nt, const Lane& ln, float th,
    const float* __restrict__ gi, const float* __restrict__ gj, int S, int H,
    int W, int radius, int n_hist, int n_ori, float lam) {
  const float ct = cosf(th), st = sinf(th);
  const float half = (float)((double)lam * (n_hist + 1) / n_hist);
  const float den = (float)(2.0 * (double)lam * (double)lam);
  const float cell = (float)(2.0 * (double)lam / n_hist);
  const float c_off = (float)((n_hist + 1) / 2.0);
  const float o_step = (float)(2.0 * kPi / n_ori);
  const float o_scale = (float)(n_ori / (2.0 * kPi));
  const int reach =
      min(radius, (int)ceilf(1.41421356f * half * ln.sg + 0.5f) + 1);
  const int u0 = max(ln.ci - reach, 0), u1 = min(ln.ci + reach, H - 1);
  const int v0 = max(ln.cj - reach, 0), v1 = min(ln.cj + reach, W - 1);
  const int nv = v1 - v0 + 1;
  const int n = (u1 - u0 + 1) * nv;
  const long long base = ((long long)ln.f * S + ln.s) * H * W;
  for (int p = tid; p < n; p += nt) {
    const int u = u0 + p / nv, v = v0 + p % nv;
    const float dm = (float)u - ln.x;
    const float dn = (float)v - ln.y;
    const float xr = (ct * dm + st * dn) / ln.sg;
    const float yr = (-st * dm + ct * dn) / ln.sg;
    if (!(fabsf(xr) < half && fabsf(yr) < half)) continue;
    const long long o = base + (long long)u * W + v;
    const float a = gi[o], b = gj[o];
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
  descriptor_accumulate(hist, tid, nt, ln, theta[l], gi, gj, S, H, W, radius,
                        n_hist, n_ori, lam);
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
  orientation_accumulate(hist, tid, nt, ln, gi, gj, S, H, W, ori_radius,
                         n_bins, lam_ori);
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
    descriptor_accumulate(hist, tid, nt, ln, th_p[p], gi, gj, S, H, W,
                          desc_radius, n_hist, n_ori, lam_desc);
    __syncthreads();
    for (int k = tid; k < n_out; k += nt) out_p[k] = column_sum(hist, k, nt);
  }
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
