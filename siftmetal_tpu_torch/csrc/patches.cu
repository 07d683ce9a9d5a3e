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
// Orientation layout: every octave of a batch in one launch (an octave
// table in the kernel's parameter). A resident grid of blocks of 128
// threads scans the lanes 32 at a time, zeroing the invalid ones and
// queueing the valid ones, then takes queued lanes one at a time; a valid
// lane gets the whole block: threads stride over
// the sample box, which is cut to the sigma-dependent window (never wider
// than the static radius). Each thread adds into its own histogram column
// in shared memory ([bin][thread], so thread t always hits bank t % 32 and
// no atomics are needed); the columns are summed in a fixed order at the
// end, so a run repeats bit for bit. atan2f is used directly (the TPU
// needed a polynomial); its result lies in [-pi, pi], so the floor-mod by
// 2 pi and the bin's wrap are one conditional each.
//
// Descriptor layout: a lane is split over kParts warps (8 for the (4, 8)
// shape, the only one any preset uses; one block a lane), each warp taking
// every kParts-th round of 32 window candidates. A warp of an invalid lane
// writes zeros and leaves. Per round each thread rotates its candidate
// (xr, yr: divided by sigma as before) and tests the box; a ballot appends
// the accepted ones, in window order, to the warp's queue. Once 32 wait,
// each thread takes one, reads gi/gj, computes magnitude, Gaussian weight,
// phi and the tent weights with the same expressions as before, and stages
// the sample's 16 spatial products (contrib * wr) * wc and 8 orientation
// weights in shared memory; the warp then contracts the chunk, a [16 x 32]
// by [32 x 8] product in fp32 FMA (the counterpart of the TPU kernel's MXU
// entry reduction): thread t owns bins (2m, 2m + 1) x (2q, 2q + 1),
// m = t / 4, q = t % 4, in registers, and adds the chunk into them in
// sample order. The warps' partial histograms are summed in warp order.
// No atomics, one fixed order: a run repeats bit for bit. Every other
// shape the launcher admits (n_hist <= 8, n_ori <= 16) takes a generic
// instance: one warp per lane, the bins in the warp's shared memory.
// cos / sin of theta come from sincospif (see descriptor_warp).
//
// Fused form (replaces _orient_desc_kernel, through
// orient_desc_lanes_pallas): one block per KEYPOINT of the staged
// descriptor block's shape (8 warps for (4, 8), 4 for the generic
// instance). Its first 128 threads build the orientation histogram with
// the staged orientation kernel's columns and thread order, so the raw
// histogram is that kernel's bit for bit. One warp then runs the circular
// box smoothings, the peak test (local maximum, >= peak_thr * max, > 0)
// and the parabolic refinement with the bins across its lanes (neighbours
// by shuffle, every sum and product rounded as the plain version rounds
// them), and ranks the peaks in BIN order by ballot: the first max_ori
// are kept (IPOL's emission order; the staged path keeps the highest
// max_ori, which differs only for a keypoint with more peaks than that).
// Each kept peak then goes through descriptor_lane, the staged
// descriptor kernel's routine, with the block's warps on one peak at a
// time (Hist48) or one warp a peak (HistAny), so the fused descriptor at
// (keypoint, theta) equals the staged kernel's at the same theta bit for
// bit. The histogram columns and the descriptor scratch share their
// shared memory (never live together). Nothing between the two stages
// goes through device memory and no lanes are compacted on the host.
// Invalid lanes and missing peaks write zeros.
//
// Resident-tile form (replaces _lanes_banded_call, siftmetal_tpu/ops/pallas/
// patches.py:1053, the band-resident mode of the two staged TPU kernels):
// the same histograms in the caller's lane order, with the gradient region
// that a group of neighbouring lanes reads copied on chip once. The TPU
// kept a 128-row full-width band of the stacked field in VMEM (megabytes);
// a block here has 227 KB, so the resident region is a 2-D tile of one
// (frame, scale) plane: all lanes whose clamped rounded centre falls in one
// tile x tile square form a run. A block copies the bounding box of its
// run's sample windows (never more than (tile + 2 radius)^2 pixels of gi
// and gj) into shared memory and computes the run's lanes reading gi/gj
// from the copy, each lane's row straight to out[lane] (no un-permute
// pass). Both forms lay the lanes out with tile_runs, a counting sort in
// three small kernels (no host synchronisation), and run a persistent grid
// of blocks that take the runs from a counter and copy each run's region
// by cp.async. Orientation: blocks of 128 threads with the staged
// kernel's device functions and thread order, so the result equals it bit
// for bit; radius 18, (tile + 36)^2 x 8 B of region + 18 KB of columns; the
// tile side (ORI_TILE in ops/kernels/patches.py) spends the least device
// time, kernel and layout together, in a measured sweep over 8-32
// (chip_smoke.py): the call itself is host-bound. Descriptor: the block's 8
// warps compute one lane at a time with descriptor_warp, so the result
// equals the staged kernel's bit for bit. Tile 16, radius 40: 96^2 x 8 B =
// 74 KB + 35 KB of staging = 109 KB, two blocks (16 warps) an SM; the sweep
// finds 16 fastest: runs hold 1.5-1.6 lanes at every side there, and above
// 16 an SM keeps one block. Every octave takes this form: the TPU's
// rows >= band-rows gate was a buffer-size condition.
//
// Bound on an H100, by chip_smoke.py's count at the main path's octave-0
// lanes (each distinct gradient pixel read once; about 90 fp32 operations
// per orientation sample and 284 per descriptor sample, a division counted
// 8, sqrt 6, exp 6, atan2 35): the descriptor, fused and resident
// descriptor kernels by operations, the two orientation kernels by bytes,
// the two sides never more than 2x apart. What the kernels wait for is
// latency (windows that hit L1/L2, the special-function unit's divisions,
// exp and atan2, and, for the resident forms, the region copy and few
// blocks an SM), not a roofline; PERF.md keeps each one's distance from
// its bound.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "device_facts.cuh"

namespace {

constexpr double kPi = 3.14159265358979323846;
constexpr float kTwoPi = 6.28318548202514648f;  // fp32(2 pi)

constexpr int kOriThreads = 128;  // an orientation histogram's threads
constexpr unsigned kFullWarp = 0xffffffffu;

__device__ __forceinline__ float mod_2pi(float a) {
  // Floor-mod with the divisor's sign (jnp.mod / torch.remainder).
  float m = fmodf(a, kTwoPi);
  if (m != 0.f && m < 0.f) m += kTwoPi;
  return m;
}

// mod_2pi of an atan2f result, which lies in [-pi, pi] (fp32 pi < 2 pi):
// fmodf leaves it as it is, so the floor-mod is one conditional add. Equal
// to mod_2pi there, -0 and NaN included (neither is < 0).
__device__ __forceinline__ float wrap_angle(float a) {
  return a < 0.f ? a + kTwoPi : a;
}

// ((bin % n) + n) % n for a bin rint(th * n / 2 pi) of th = wrap_angle(..)
// in [0, 2 pi) (NaN converts to 0): the bin lies in [0, n], so only n wraps.
__device__ __forceinline__ int wrap_bin(int bin, int n) {
  return bin == n ? 0 : bin;
}

struct Lane {
  int f, s, ci, cj;
  float x, y, sg;
};

// Lane l with frame index `fr` (clamped into the batch, as the scale is).
__device__ __forceinline__ Lane lane_from(int l, int fr, int B, int S, int H,
                                         int W, const int* scale,
                                         const float* x, const float* y,
                                         const float* sigma) {
  Lane ln;
  ln.f = min(max(fr, 0), B - 1);
  ln.s = min(max(scale[l], 1), S) - 1;
  ln.x = x[l];
  ln.y = y[l];
  ln.sg = sigma[l];
  ln.ci = min(max((int)rintf(ln.x), 0), H - 1);
  ln.cj = min(max((int)rintf(ln.y), 0), W - 1);
  return ln;
}

__device__ __forceinline__ Lane lane_of(int l, int B, int S, int H, int W,
                                        const int* frame, const int* scale,
                                        const float* x, const float* y,
                                        const float* sigma) {
  return lane_from(l, frame[l], B, S, H, W, scale, x, y, sigma);
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
    if (fabsf(dm) <= r_max && fabsf(dn) <= r_max) {
      const int o = (u - fd.r0) * fd.pitch + (v - fd.c0);
      const float a = fd.gi[o], b = fd.gj[o];
      const float mag = sqrtf(a * a + b * b);
      const float w = expf(-(dm * dm + dn * dn) / den) * mag;
      const float th = wrap_angle(atan2f(b, a));
      hist[wrap_bin((int)rintf(th * bin_scale), n_bins) * nt + tid] += w;
    }
  }
}

// Sum of column k over the kOriThreads threads, in a fixed
// (bank-staggered) order: thread (t + k) % 128 for t = 0..127, one fp32
// chain (the order every orientation form shares, so they stay equal bit
// for bit). The loads run ahead of the chain; four chains of 32 measured
// no faster (PERF.md), the chain's latency hidden by other blocks.
__device__ __forceinline__ float column_sum(const float* hist, int k) {
  const float* col = hist + k * kOriThreads;
  float acc = 0.f;
#pragma unroll 16
  for (int t = 0; t < kOriThreads; ++t) acc += col[(t + k) & (kOriThreads - 1)];
  return acc;
}

// --- Orientation: every octave of a batch in one launch --------------------
//
// A resident grid of blocks of kOriThreads threads works in two kinds of
// task, both handed out by counters in a small work buffer. A scan takes
// kOriScan lanes of one octave (octave by octave in table order, the
// largest first): one warp reads their flags and queues the valid lanes,
// and the block writes the zeros of the invalid ones, so the ~70% of
// lanes that compaction left empty cost a share of one coalesced pass. A
// block scans while scans are left, then pops queued lanes one at a time
// and gives each the whole block: its threads add the lane's samples into
// their own columns (orientation_accumulate) and the columns are summed
// in column_sum's order. Popping lanes one by one keeps the blocks busy
// to the end though compaction puts the valid lanes first in each frame's
// budget; a counter drawn once a lane (the first design of this launch)
// spent ~0.03 ms on its draws alone, and drawing the next lane's slot
// ahead measured slower (PERF.md). Lanes are read from
// each octave's own arrays, and row (frame f, slot k) of an octave is
// written at out + (f row_stride + k) n_bins, so a batch's octaves land
// in one [B, sum of budgets, n_bins] array.

constexpr int kMaxOriOctaves = 16;
constexpr int kOriScan = 32;  // lanes a scan: one warp's flags

struct OriOctave {
  const float* gi;  // [B, S, H, W]
  const float* gj;
  const uint8_t* valid;  // [lanes]
  const int* frame;      // [lanes], or null: lane l is of frame l / budget
  const int* scale;
  const float* x;
  const float* y;
  const float* sigma;
  float* out;  // the octave's first row
  int B, S, H, W;
  int lanes, budget, row_stride;
  int scan0;  // first scan of the octave
  int lane0;  // first lane of the octave in the launch's numbering
};

// The work buffer (zeroed before the launch): the next scan, the queue's
// tail, the scans finished, the queue's head, then one slot a lane
// holding the queued lane's number + 1 (0 until written).
enum { kNextScan, kTail, kScansDone, kHead, kQueue };

struct OriLaunch {
  OriOctave oct[kMaxOriOctaves];
  int n_oct, scans, lanes, radius, n_bins;
  float lam;
  int* work;
};

constexpr int kNoTask = -0x7fffffff;

// Thread 0's next lane from the queue, or kNoTask once every scan has
// finished and the queue holds no lane for this draw.
__device__ int pop_lane(const OriLaunch& L) {
  const int h = atomicAdd(L.work + kHead, 1);
  if (h >= L.lanes) return kNoTask;
  volatile int* w = L.work;
  for (;;) {
    const int v = w[kQueue + h];
    if (v != 0) return v - 1;
    if (w[kScansDone] == L.scans) {  // the tail is final
      __threadfence();
      const int again = w[kQueue + h];
      if (again != 0) return again - 1;
      if (w[kTail] <= h) return kNoTask;
    }
    __nanosleep(64);
  }
}

__device__ __forceinline__ int octave_of(const OriLaunch& L, int lane) {
  int o = 0;
  while (o + 1 < L.n_oct && lane >= L.oct[o + 1].lane0) ++o;
  return o;
}

__device__ __forceinline__ float* row_of(const OriOctave& oc, int l, int n_bins) {
  const int f = l / oc.budget;
  return oc.out + ((long long)f * oc.row_stride + (l - f * oc.budget)) * n_bins;
}

__global__ void __launch_bounds__(kOriThreads)
    orientation_kernel(const __grid_constant__ OriLaunch L) {
  extern __shared__ float hist[];  // [n_bins][kOriThreads]
  __shared__ int task, base;
  __shared__ unsigned mask;
  const int tid = threadIdx.x;
  const int n_bins = L.n_bins;
  bool scanning = true;  // thread 0: scans may be left
  for (;;) {
    if (tid == 0) {
      int t = kNoTask;
      if (scanning) {
        const int c = atomicAdd(L.work + kNextScan, 1);
        if (c < L.scans) t = -1 - c;
        else scanning = false;
      }
      task = t != kNoTask ? t : pop_lane(L);
    }
    __syncthreads();
    const int t = task;
    __syncthreads();  // every thread has the task before the next draw
    if (t == kNoTask) return;
    if (t < 0) {  // scan -1 - t: queue the valid lanes, zero the others
      const int c = -1 - t;
      int o = 0;
      while (o + 1 < L.n_oct && c >= L.oct[o + 1].scan0) ++o;
      const OriOctave& oc = L.oct[o];
      const int l0 = (c - oc.scan0) * kOriScan;
      const int n = min(kOriScan, oc.lanes - l0);
      if (tid < 32) {
        const bool v = tid < n && oc.valid[l0 + tid];
        const unsigned m = __ballot_sync(kFullWarp, v);
        if (tid == 0) {
          mask = m;
          base = m ? atomicAdd(L.work + kTail, __popc(m)) : 0;
        }
        __syncwarp();
        if (v)
          L.work[kQueue + base + __popc(m & ((1u << tid) - 1))] =
              oc.lane0 + l0 + tid + 1;
        __threadfence();  // the queued lanes before the scan counts as done
      }
      __syncthreads();
      const unsigned m = mask;
      for (int i = tid; i < n * n_bins; i += kOriThreads) {
        const int q = i / n_bins;
        if (!((m >> q) & 1)) row_of(oc, l0 + q, n_bins)[i - q * n_bins] = 0.f;
      }
      if (tid == 0) atomicAdd(L.work + kScansDone, 1);
      continue;
    }
    const OriOctave& oc = L.oct[octave_of(L, t)];
    const int l = t - oc.lane0;
    for (int k = 0; k < n_bins; ++k) hist[k * kOriThreads + tid] = 0.f;
    const int f = l / oc.budget;
    const Lane ln = lane_from(l, oc.frame != nullptr ? oc.frame[l] : f, oc.B,
                              oc.S, oc.H, oc.W, oc.scale, oc.x, oc.y, oc.sigma);
    orientation_accumulate(hist, tid, kOriThreads, ln,
                           plane_field(ln, oc.gi, oc.gj, oc.S, oc.H, oc.W),
                           oc.H, oc.W, L.radius, n_bins, L.lam);
    __syncthreads();
    float* out_l = row_of(oc, l, n_bins);
    for (int k = tid; k < n_bins; k += kOriThreads) out_l[k] = column_sum(hist, k);
    __syncthreads();  // the sums are read before the next lane zeroes them
  }
}

// The old and the cheap wrap of an angle and of a bin, side by side, on
// the gradients (gi, gj) of [n] samples: for the card test that holds the
// two equal on signed zeros, +-pi and NaN.
__global__ void wrap_pairs_kernel(const float* gi, const float* gj, int n,
                                  int n_bins, float* th, int* bins) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float a = atan2f(gj[i], gi[i]);
  const float bin_scale = (float)((double)n_bins / (2.0 * kPi));
  const float t_old = mod_2pi(a), t_new = wrap_angle(a);
  const int b_old = (int)rintf(t_old * bin_scale);
  th[2 * i] = t_old;
  th[2 * i + 1] = t_new;
  bins[2 * i] = ((b_old % n_bins) + n_bins) % n_bins;
  bins[2 * i + 1] = wrap_bin((int)rintf(t_new * bin_scale), n_bins);
}

constexpr int kMaxHist = 8;
constexpr int kMaxOri = 16;

// --- Descriptor: Hist::kParts warps per lane ---------------------------------


// The per-lane constants of IPOL Alg. 12.
struct DescConst {
  float half, den, cell, c_off, o_step, o_scale;
};

__device__ __forceinline__ DescConst desc_const(int n_hist, int n_ori,
                                                float lam) {
  DescConst g;
  g.half = (float)((double)lam * (n_hist + 1) / n_hist);
  g.den = (float)(2.0 * (double)lam * (double)lam);
  g.cell = (float)(2.0 * (double)lam / n_hist);
  g.c_off = (float)((n_hist + 1) / 2.0);
  g.o_step = (float)(2.0 * kPi / n_ori);
  g.o_scale = (float)(n_ori / (2.0 * kPi));
  return g;
}

// Tent weight of spatial cell c for a rotated coordinate z.
__device__ __forceinline__ float spatial_tent(float z, int c,
                                              const DescConst& g) {
  const float center = ((float)(c + 1) - g.c_off) * g.cell;
  return fmaxf(0.f, 1.f - fabsf(z - center) / g.cell);
}

// Tent weight of orientation bin k for a relative angle phi in [0, 2 pi).
__device__ __forceinline__ float orient_tent(float phi, int k,
                                             const DescConst& g) {
  float d = fabsf(phi - (float)k * g.o_step);
  d = fminf(d, kTwoPi - d);
  return fmaxf(0.f, 1.f - d * g.o_scale);
}

constexpr int kChunk = 32;  // staged samples per contraction

// Histogram of the (4, 8) shape in registers. Each lane is split over
// kParts warps. Thread t of a warp owns bins (rc, k) in {2m, 2m + 1} x
// {2q, 2q + 1}, m = t / 4, q = t % 4; a staged sample is 8 pairs of
// spatial products and 4 pairs of orientation weights, [pair][sample]
// with a padded row so that the contraction's loads hit distinct banks.
struct Hist48 {
  static constexpr int kParts = 8, kMaxOut = 128;
  struct Scratch {
    float2 s[8][kChunk + 1];
    float2 o[4][kChunk + 1];
  };
  float acc[4];
  __device__ Hist48(int, int) {}
  __device__ static constexpr int n_hist() { return 4; }
  __device__ static constexpr int n_ori() { return 8; }
  __device__ static constexpr int n_out() { return 128; }
  __device__ void zero(Scratch&, int) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] = 0.f;
  }
  __device__ void stage(Scratch& sc, int slot, float xr, float yr,
                        float contrib, float phi, const DescConst& g) const {
    float wr[4], wc[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      wr[c] = spatial_tent(xr, c, g);
      wc[c] = spatial_tent(yr, c, g);
    }
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const float cr = contrib * wr[m >> 1];
      const int c = (m & 1) * 2;
      sc.s[m][slot] = make_float2(cr * wc[c], cr * wc[c + 1]);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
      sc.o[q][slot] = make_float2(orient_tent(phi, 2 * q, g),
                                  orient_tent(phi, 2 * q + 1, g));
  }
  __device__ void product(const Scratch& sc, int n, int lane) {
    const int m = lane >> 2, q = lane & 3;
    for (int i = 0; i < n; ++i) {
      const float2 a = sc.s[m][i], b = sc.o[q][i];
      acc[0] = fmaf(a.x, b.x, acc[0]);
      acc[1] = fmaf(a.x, b.y, acc[1]);
      acc[2] = fmaf(a.y, b.x, acc[2]);
      acc[3] = fmaf(a.y, b.y, acc[3]);
    }
  }
  __device__ void store(const Scratch&, float* out_l, int lane) const {
    const int m = lane >> 2, q = lane & 3;
    float2* o = reinterpret_cast<float2*>(out_l + 16 * m + 2 * q);
    o[0] = make_float2(acc[0], acc[1]);
    o[4] = make_float2(acc[2], acc[3]);
  }
};

// Any shape with n_hist <= kMaxHist and n_ori <= kMaxOri: one warp per
// lane, the staged weights and the bins in the warp's shared memory;
// thread t owns the bins t, t + 32, ... and adds each over the chunk in
// sample order.
struct HistAny {
  static constexpr int kParts = 1, kMaxOut = kMaxHist * kMaxHist * kMaxOri;
  struct Scratch {
    float s[kMaxHist * kMaxHist][kChunk + 1];
    float o[kMaxOri][kChunk + 1];
    float acc[kMaxHist * kMaxHist * kMaxOri];
  };
  int nh, no;
  __device__ HistAny(int n_hist, int n_ori) : nh(n_hist), no(n_ori) {}
  __device__ int n_hist() const { return nh; }
  __device__ int n_ori() const { return no; }
  __device__ int n_out() const { return nh * nh * no; }
  __device__ void zero(Scratch& sc, int lane) const {
    for (int b = lane; b < n_out(); b += 32) sc.acc[b] = 0.f;
  }
  __device__ void stage(Scratch& sc, int slot, float xr, float yr,
                        float contrib, float phi, const DescConst& g) const {
    for (int r = 0; r < nh; ++r) {
      const float cr = contrib * spatial_tent(xr, r, g);
      for (int c = 0; c < nh; ++c)
        sc.s[r * nh + c][slot] = cr * spatial_tent(yr, c, g);
    }
    for (int k = 0; k < no; ++k) sc.o[k][slot] = orient_tent(phi, k, g);
  }
  __device__ void product(Scratch& sc, int n, int lane) const {
    for (int b = lane; b < n_out(); b += 32) {
      const int rc = b / no, k = b - rc * no;
      float a = sc.acc[b];
      for (int i = 0; i < n; ++i) a = fmaf(sc.s[rc][i], sc.o[k][i], a);
      sc.acc[b] = a;
    }
  }
  __device__ void store(const Scratch& sc, float* out_l, int lane) const {
    for (int b = lane; b < n_out(); b += 32) out_l[b] = sc.acc[b];
  }
};

// One warp's shared memory: the queue of accepted candidates (rotated
// coordinates and field offset, in sample order) and the staged chunk.
template <class Hist>
struct WarpScratch {
  typename Hist::Scratch h;
  float qx[2 * kChunk], qy[2 * kChunk];
  int qo[2 * kChunk];
};

// Part `part` of Hist::kParts of the raw descriptor of lane `ln` at
// reference orientation `th`, accumulated into `hist` by the calling warp
// (all 32 threads, converged): the rounds part, part + kParts, ... of 32
// window candidates. The accepted samples of those rounds reach the contraction
// in window order and every bin adds them in that order, so staged and
// resident kernels, which differ only in where `fd` points, agree bit for
// bit.
template <class Hist>
__device__ __forceinline__ void descriptor_warp(
    WarpScratch<Hist>& ws, Hist& hist, const Lane& ln, float th,
    const Field& fd, int H, int W, int radius, float lam, int part) {
  const int lane = threadIdx.x & 31;
  const DescConst g = desc_const(hist.n_hist(), hist.n_ori(), lam);
  // cos and sin of th through sincospif: the same values to an ulp as
  // cosf / sinf, without their large-argument reduction, whose local
  // array would give the kernel a stack frame.
  float st, ct;
  sincospif(th * (float)(1.0 / kPi), &st, &ct);
  const Window wd = descriptor_window(ln, H, W, radius, hist.n_hist(), lam);
  const int u0 = wd.u0, v0 = wd.v0;
  const int nv = wd.v1 - v0 + 1;
  const int n = (wd.u1 - u0 + 1) * nv;
  const unsigned below = (1u << lane) - 1u;
  hist.zero(ws.h, lane);

  // Weights of the first m queued samples, then their contraction.
  auto flush = [&](int m) {
    __syncwarp();
    if (lane < m) {
      const float xr = ws.qx[lane], yr = ws.qy[lane];
      const int o = ws.qo[lane];
      const float a = fd.gi[o], b = fd.gj[o];
      const float mag = sqrtf(a * a + b * b);
      const float contrib = expf(-(xr * xr + yr * yr) / g.den) * mag;
      const float phi = mod_2pi(atan2f(b, a) - th);
      hist.stage(ws.h, lane, xr, yr, contrib, phi, g);
    }
    __syncwarp();
    hist.product(ws.h, m, lane);
    __syncwarp();
  };

  int nq = 0;
  for (int p0 = part * 32; p0 < n; p0 += Hist::kParts * 32) {
    const int p = p0 + lane;
    bool in = false;
    float xr = 0.f, yr = 0.f;
    int o = 0;
    if (p < n) {
      const int u = u0 + p / nv, v = v0 + p % nv;
      const float dm = (float)u - ln.x;
      const float dn = (float)v - ln.y;
      xr = (ct * dm + st * dn) / ln.sg;
      yr = (-st * dm + ct * dn) / ln.sg;
      in = fabsf(xr) < g.half && fabsf(yr) < g.half;
      o = (u - fd.r0) * fd.pitch + (v - fd.c0);
    }
    const unsigned ball = __ballot_sync(kFullWarp, in);
    if (in) {
      const int slot = nq + __popc(ball & below);
      ws.qx[slot] = xr;
      ws.qy[slot] = yr;
      ws.qo[slot] = o;
    }
    nq += __popc(ball);
    if (nq >= kChunk) {
      flush(kChunk);
      const int rest = nq - kChunk;
      if (lane < rest) {
        ws.qx[lane] = ws.qx[kChunk + lane];
        ws.qy[lane] = ws.qy[kChunk + lane];
        ws.qo[lane] = ws.qo[kChunk + lane];
      }
      nq = rest;
      __syncwarp();
    }
  }
  if (nq > 0) flush(nq);
}

// Barrier of the Hist::kParts warps of lane group g (named barrier 1 + g).
template <class Hist>
__device__ __forceinline__ void group_sync(int g) {
  if (Hist::kParts == 1)
    __syncwarp();
  else
    asm volatile("bar.sync %0, %1;" ::"r"(1 + g), "r"(Hist::kParts * 32)
                 : "memory");
}

// One lane by the Hist::kParts warps of group g (descriptor_warp each);
// their partial histograms are summed in part order into out_l. `red`
// holds the group's kParts * n_out floats.
template <class Hist>
__device__ __forceinline__ void descriptor_lane(
    WarpScratch<Hist>& ws, float* red, Hist& hist, int g, int part,
    const Lane& ln, float th, const Field& fd, int H, int W, int radius,
    float lam, float* out_l) {
  const int lane = threadIdx.x & 31;
  descriptor_warp(ws, hist, ln, th, fd, H, W, radius, lam, part);
  if (Hist::kParts == 1) {
    hist.store(ws.h, out_l, lane);
    return;
  }
  const int n_out = hist.n_out();
  hist.store(ws.h, red + part * n_out, lane);
  group_sync<Hist>(g);
  for (int b = part * 32 + lane; b < n_out; b += Hist::kParts * 32) {
    float v = red[b];
    for (int k = 1; k < Hist::kParts; ++k) v += red[k * n_out + b];
    out_l[b] = v;
  }
  group_sync<Hist>(g);  // red is read before the group's next lane
}

// Warps of a staged block (one lane of Hist48, four lanes of HistAny) and
// of a fused block.
template <class Hist>
__host__ __device__ constexpr int staged_warps() {
  return Hist::kParts > 4 ? Hist::kParts : 4;
}

// Shared memory of `warps` warps (a staged or fused block, or a resident
// block before its region): the warps' scratch, then the groups' reduction
// rows.
template <class Hist>
__host__ __device__ constexpr int lane_smem(int warps) {
  return warps * (int)sizeof(WarpScratch<Hist>) +
         (Hist::kParts > 1 ? warps * Hist::kMaxOut * (int)sizeof(float) : 0);
}

template <class Hist>
__global__ void __launch_bounds__(staged_warps<Hist>() * 32)
    descriptor_kernel(const float* __restrict__ gi,
                      const float* __restrict__ gj, int B, int S, int H, int W,
                      int L, const uint8_t* __restrict__ valid,
                      const int* __restrict__ frame,
                      const int* __restrict__ scale,
                      const float* __restrict__ x, const float* __restrict__ y,
                      const float* __restrict__ sigma,
                      const float* __restrict__ theta, int radius, int n_hist,
                      int n_ori, float lam, float* __restrict__ out) {
  constexpr int kWarps = staged_warps<Hist>();
  extern __shared__ __align__(16) unsigned char warp_smem[];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = w / Hist::kParts, part = w % Hist::kParts;
  const long long l = (long long)blockIdx.x * (kWarps / Hist::kParts) + g;
  if (l >= L) return;
  Hist hist(n_hist, n_ori);
  const int n_out = hist.n_out();
  float* out_l = out + l * n_out;
  if (!valid[l]) {
    for (int k = part * 32 + lane; k < n_out; k += Hist::kParts * 32)
      out_l[k] = 0.f;
    return;
  }
  WarpScratch<Hist>* wsa = reinterpret_cast<WarpScratch<Hist>*>(warp_smem);
  float* red =
      reinterpret_cast<float*>(wsa + kWarps) + g * Hist::kParts * n_out;
  const Lane ln = lane_of((int)l, B, S, H, W, frame, scale, x, y, sigma);
  descriptor_lane(wsa[w], red, hist, g, part, ln, theta[l],
                  plane_field(ln, gi, gj, S, H, W), H, W, radius, lam, out_l);
}

// --- Fused orientation + descriptors -----------------------------------------

constexpr int kMaxBins = 64;
constexpr int kMaxPeaks = 8;

// Bin k of a histogram held across a warp: slot k / 32 of thread k % 32.
// Every thread of the warp calls it (two shuffles).
__device__ __forceinline__ float warp_bin(const float (&v)[2], int k) {
  const float a = __shfl_sync(kFullWarp, v[0], k & 31);
  const float b = __shfl_sync(kFullWarp, v[1], k & 31);
  return k < 32 ? a : b;
}

// The circular box smoothings, the peak test and the parabolic refinement
// of the raw histogram h[0 .. n_bins) by the calling warp (all 32 threads,
// converged), with the plain version's roundings. The thetas of the first
// max_ori peaks in bin order go to th[0 ..); returns their number.
__device__ __forceinline__ int warp_peaks(const float* h, int n_bins,
                                          int smooth_iters, float peak_thr,
                                          int max_ori, float* th) {
  const int lane = threadIdx.x & 31;
  const int k0 = lane, k1 = lane + 32;
  float v[2] = {k0 < n_bins ? h[k0] : 0.f, k1 < n_bins ? h[k1] : 0.f};
  // Bins k - 1 and k + 1 of each slot (any k: slots past n_bins are never
  // read as a neighbour and never tested).
  const int pk[2] = {(k0 + n_bins - 1) % n_bins, (k1 + n_bins - 1) % n_bins};
  const int nk[2] = {(k0 + 1) % n_bins, (k1 + 1) % n_bins};
  for (int it = 0; it < smooth_iters; ++it) {
    float s[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float pv = warp_bin(v, pk[i]), nx = warp_bin(v, nk[i]);
      s[i] = __fadd_rn(__fadd_rn(pv, v[i]), nx) / 3.0f;
    }
    v[0] = s[0];
    v[1] = s[1];
  }
  float hmax = k0 < n_bins ? v[0] : -INFINITY;
  if (k1 < n_bins) hmax = fmaxf(hmax, v[1]);
  for (int off = 16; off > 0; off >>= 1)
    hmax = fmaxf(hmax, __shfl_xor_sync(kFullWarp, hmax, off));
  const float floor_v = __fmul_rn(peak_thr, hmax);
  const float bin_w = (float)(2.0 * kPi / n_bins);
  const float pi_f = (float)kPi;
  bool peak[2];
  float t[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int k = lane + 32 * i;
    const float c = v[i], pv = warp_bin(v, pk[i]), nx = warp_bin(v, nk[i]);
    peak[i] = k < n_bins && c > pv && c > nx && c >= floor_v && c > 0.f;
    const float den =
        __fmul_rn(2.0f, __fsub_rn(__fadd_rn(pv, nx), __fmul_rn(2.0f, c)));
    const float off = __fsub_rn(pv, nx) / den;
    const float a = __fmul_rn(__fadd_rn(__fadd_rn((float)k, 0.5f), off), bin_w);
    t[i] = __fsub_rn(mod_2pi(__fadd_rn(a, pi_f)), pi_f);
  }
  // Rank in bin order: the peaks below this bin in the warp's two ballots.
  const unsigned below = (1u << lane) - 1u;
  const unsigned b0 = __ballot_sync(kFullWarp, peak[0]);
  const unsigned b1 = __ballot_sync(kFullWarp, peak[1]);
  const int r0 = __popc(b0 & below), r1 = __popc(b0) + __popc(b1 & below);
  if (peak[0] && r0 < max_ori) th[r0] = t[0];
  if (peak[1] && r1 < max_ori) th[r1] = t[1];
  return min(__popc(b0) + __popc(b1), max_ori);
}

// One block of staged_warps<Hist>() warps per keypoint lane: the staged
// orientation kernel's histogram (its 128 columns and thread order), the
// peaks by warp 0, then each kept peak by descriptor_lane (group g of
// Hist::kParts warps takes peaks g, g + groups, ...). The dynamic shared
// memory holds first the orientation columns, then the warps' descriptor
// scratch and reduction rows.
template <class Hist>
__global__ void __launch_bounds__(staged_warps<Hist>() * 32)
    orient_desc_kernel(const float* __restrict__ gi,
                       const float* __restrict__ gj, int B, int S, int H,
                       int W, const uint8_t* __restrict__ valid,
                       const int* __restrict__ frame,
                       const int* __restrict__ scale,
                       const float* __restrict__ x, const float* __restrict__ y,
                       const float* __restrict__ sigma, int ori_radius,
                       int n_bins, float lam_ori, int smooth_iters,
                       float peak_thr, int max_ori, int desc_radius, int n_hist,
                       int n_ori, float lam_desc, float* __restrict__ raw,
                       float* __restrict__ theta,
                       uint8_t* __restrict__ ori_valid) {
  constexpr int kWarps = staged_warps<Hist>();
  constexpr int kGroups = kWarps / Hist::kParts;
  extern __shared__ __align__(16) unsigned char warp_smem[];
  __shared__ float h_raw[kMaxBins];
  __shared__ float th_p[kMaxPeaks];
  __shared__ int n_peaks;
  const int l = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int w = tid >> 5;
  Hist hist(n_hist, n_ori);
  const int n_out = hist.n_out();
  float* raw_l = raw + (long long)l * max_ori * n_out;
  float* theta_l = theta + (long long)l * max_ori;
  uint8_t* ov_l = ori_valid + (long long)l * max_ori;
  if (!valid[l]) {
    for (int k = tid; k < max_ori * n_out; k += nt) raw_l[k] = 0.f;
    for (int k = tid; k < max_ori; k += nt) {
      theta_l[k] = 0.f;
      ov_l[k] = 0;
    }
    return;
  }
  const Lane ln = lane_of(l, B, S, H, W, frame, scale, x, y, sigma);
  const Field fd = plane_field(ln, gi, gj, S, H, W);

  float* cols = reinterpret_cast<float*>(warp_smem);  // [n_bins][kOriThreads]
  if (tid < kOriThreads) {
    for (int k = 0; k < n_bins; ++k) cols[k * kOriThreads + tid] = 0.f;
    orientation_accumulate(cols, tid, kOriThreads, ln, fd, H, W, ori_radius,
                           n_bins, lam_ori);
  }
  __syncthreads();
  for (int k = tid; k < n_bins; k += nt)
    h_raw[k] = column_sum(cols, k);
  __syncthreads();
  if (w == 0) {
    const int np = warp_peaks(h_raw, n_bins, smooth_iters, peak_thr, max_ori,
                              th_p);
    if (tid == 0) n_peaks = np;
  }
  __syncthreads();  // the columns are dead from here: the scratch takes them
  const int np = n_peaks;
  for (int k = tid; k < max_ori; k += nt) {
    theta_l[k] = k < np ? th_p[k] : 0.f;
    ov_l[k] = k < np ? 1 : 0;
  }
  for (int k = np * n_out + tid; k < max_ori * n_out; k += nt) raw_l[k] = 0.f;

  WarpScratch<Hist>* wsa = reinterpret_cast<WarpScratch<Hist>*>(warp_smem);
  const int g = w / Hist::kParts, part = w % Hist::kParts;
  float* red =
      reinterpret_cast<float*>(wsa + kWarps) + g * Hist::kParts * n_out;
  for (int p = g; p < np; p += kGroups)
    descriptor_lane(wsa[w], red, hist, g, part, ln, th_p[p], fd, H, W,
                    desc_radius, lam_desc, raw_l + (long long)p * n_out);
}

// --- Tile layout of the resident forms: a counting sort ------------------
//
// key(l) = (frame, scale, row tile, column tile) of lane l's clamped rounded
// centre, n_tiles for an invalid lane. count[key] and each lane's rank in
// its key come from one atomic pass, start[] from one exclusive scan, and
// the scatter puts lane l at start[key] + rank: runs sit in key order as
// after tile_layout's stable sort, and the order inside a run (free: each
// lane's row is computed alone) follows the atomics.

__device__ __forceinline__ int tile_key(int l, int B, int S, int H, int W,
                                        const uint8_t* valid, const int* frame,
                                        const int* scale, const float* x,
                                        const float* y, int tile, int tr,
                                        int tc, int n_tiles) {
  if (!valid[l]) return n_tiles;
  const int f = min(max(frame[l], 0), B - 1);
  const int s = min(max(scale[l], 1), S) - 1;
  const int ci = min(max((int)rintf(x[l]), 0), H - 1);
  const int cj = min(max((int)rintf(y[l]), 0), W - 1);
  return ((f * S + s) * tr + ci / tile) * tc + cj / tile;
}

__global__ void layout_count_kernel(int B, int S, int H, int W, int L,
                                    const uint8_t* __restrict__ valid,
                                    const int* __restrict__ frame,
                                    const int* __restrict__ scale,
                                    const float* __restrict__ x,
                                    const float* __restrict__ y, int tile,
                                    int tr, int tc, int n_tiles,
                                    int* __restrict__ count,
                                    int* __restrict__ rank) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  const int key =
      tile_key(l, B, S, H, W, valid, frame, scale, x, y, tile, tr, tc, n_tiles);
  rank[l] = atomicAdd(&count[key], 1);
}

constexpr int kScanThreads = 1024;

// Exclusive scan of count[0..n) into start[], in one block: each warp
// sums a contiguous segment with coalesced loads, the block scans the 32
// segment sums, and each warp scans its segment 32 entries at a time.
__global__ void __launch_bounds__(kScanThreads)
    layout_scan_kernel(const int* __restrict__ count, int n,
                       int* __restrict__ start) {
  __shared__ int seg_start[32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int seg = (n + 31) / 32;
  const int b0 = min(w * seg, n), b1 = min(b0 + seg, n);
  int sum = 0;
  for (int i = b0 + lane; i < b1; i += 32) sum += count[i];
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(kFullWarp, sum, off);
  if (lane == 0) seg_start[w] = sum;
  __syncthreads();
  if (w == 0) {
    const int own = seg_start[lane];
    int v = own;
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(kFullWarp, v, off);
      if (lane >= off) v += t;
    }
    seg_start[lane] = v - own;
  }
  __syncthreads();
  int carry = seg_start[w];
  for (int i0 = b0; i0 < b1; i0 += 32) {
    const int i = i0 + lane;
    const int c = i < b1 ? count[i] : 0;
    int v = c;
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(kFullWarp, v, off);
      if (lane >= off) v += t;
    }
    if (i < b1) start[i] = carry + v - c;
    carry += __shfl_sync(kFullWarp, v, 31);
  }
}

// runs[0] counts the run heads written to heads[] (in no fixed order).
__global__ void layout_scatter_kernel(
    int B, int S, int H, int W, int L, const uint8_t* __restrict__ valid,
    const int* __restrict__ frame, const int* __restrict__ scale,
    const float* __restrict__ x, const float* __restrict__ y, int tile, int tr,
    int tc, int n_tiles, const int* __restrict__ count,
    const int* __restrict__ start, const int* __restrict__ rank,
    int* __restrict__ src, uint8_t* __restrict__ first,
    int* __restrict__ run_end, int* __restrict__ heads,
    int* __restrict__ runs) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  const int key =
      tile_key(l, B, S, H, W, valid, frame, scale, x, y, tile, tr, tc, n_tiles);
  const int pos = start[key] + rank[l];
  const bool head = rank[l] == 0 && key < n_tiles;
  src[pos] = l;
  run_end[pos] = start[key] + count[key];
  first[pos] = head;
  if (head) heads[atomicAdd(&runs[0], 1)] = pos;
}

// One 4-byte copy from device to shared memory that does not hold the
// thread (cp.async): a block issues its whole region before it waits.
__device__ __forceinline__ void copy_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// --- Resident-tile forms: a persistent grid over the tile runs ---------------

// The run a persistent resident block holds: sorted positions p .. end - 1,
// and the bounding box of its lanes' windows, rows r0 .. r0 + rows - 1 and
// columns c0 .. c0 + pitch - 1 of their plane. p < 0: no run is left.
struct Run {
  int p, end, r0, c0, rows, pitch;
};

// Hands the calling block its next run. runs[1] counts the runs handed out,
// heads[] holds their first sorted positions, run_end[] their ends, src[]
// the lane at each sorted position; window(l) is lane l's sample window;
// sh is 5 ints of the block's shared memory. Every thread calls it.
template <class WindowOf>
__device__ __forceinline__ Run next_run(int* sh, const int* heads, int* runs,
                                        const int* run_end, const int* src,
                                        int H, int W, WindowOf window) {
  if (threadIdx.x == 0) {
    const int r = atomicAdd(&runs[1], 1);
    sh[0] = r < runs[0] ? heads[r] : -1;
    sh[1] = H;
    sh[2] = -1;
    sh[3] = W;
    sh[4] = -1;
  }
  __syncthreads();
  Run run{sh[0], 0, 0, 0, 0, 0};
  if (run.p < 0) return run;
  run.end = run_end[run.p];
  for (int q = run.p + threadIdx.x; q < run.end; q += blockDim.x) {
    const Window wd = window(src[q]);
    atomicMin(&sh[1], wd.u0);
    atomicMax(&sh[2], wd.u1);
    atomicMin(&sh[3], wd.v0);
    atomicMax(&sh[4], wd.v1);
  }
  __syncthreads();
  run.r0 = sh[1];
  run.rows = sh[2] - sh[1] + 1;
  run.c0 = sh[3];
  run.pitch = sh[4] - sh[3] + 1;
  return run;
}

// Copies the run's box of `plane` (row pitch W) into reg_i / reg_j by
// cp.async, waits, and returns the copy as a Field (after a barrier).
__device__ __forceinline__ Field copy_run(const Run& run, const Field& plane,
                                          int W, float* reg_i, float* reg_j) {
  for (int i = threadIdx.x; i < run.rows * run.pitch; i += blockDim.x) {
    const int o = (run.r0 + i / run.pitch) * W + (run.c0 + i % run.pitch);
    copy_async4(reg_i + i, plane.gi + o);
    copy_async4(reg_j + i, plane.gj + o);
  }
  copy_async_wait();
  __syncthreads();
  return Field{reg_i, reg_j, run.pitch, run.r0, run.c0};
}

// A run whose box exceeds the copy was not laid out with this tile: its
// lanes' rows (width values each) become NaN rather than be read past the
// copy.
__device__ __forceinline__ void refuse_run(const Run& run, const int* src,
                                           int width, float* out) {
  for (int q = run.p; q < run.end; ++q)
    for (int k = threadIdx.x; k < width; k += blockDim.x)
      out[(long long)src[q] * width + k] = nanf("");
}

// Resident-tile form of the staged orientation kernel: each block of
// kOriThreads threads takes runs with next_run and computes the run's
// lanes one after another from the copy, with the staged kernel's columns
// and thread order. Rows of lanes in no run are not written: the wrapper
// hands in zeros.
__global__ void __launch_bounds__(kOriThreads) resident_orientation_kernel(
    const float* __restrict__ gi, const float* __restrict__ gj, int B, int S,
    int H, int W, const int* __restrict__ heads, int* __restrict__ runs,
    const int* __restrict__ run_end, const int* __restrict__ src,
    const int* __restrict__ frame, const int* __restrict__ scale,
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ sigma, int radius, int tile, int n_bins,
    float lam, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];  // columns, then gi, gj copies
  __shared__ int sh[5];
  const int tid = threadIdx.x;
  const int side = tile + 2 * radius;
  float* cols = smem;  // [n_bins][kOriThreads]
  float* reg_i = smem + n_bins * kOriThreads;
  float* reg_j = reg_i + side * side;
  const auto lane = [&](int l) {
    return lane_of(l, B, S, H, W, frame, scale, x, y, sigma);
  };
  for (;;) {
    const Run run = next_run(sh, heads, runs, run_end, src, H, W, [&](int l) {
      return orientation_window(lane(l), H, W, radius, lam);
    });
    if (run.p < 0) return;
    if (run.rows > side || run.pitch > side) {
      refuse_run(run, src, n_bins, out);
    } else {
      const Field fd = copy_run(
          run, plane_field(lane(src[run.p]), gi, gj, S, H, W), W, reg_i, reg_j);
      for (int q = run.p; q < run.end; ++q) {
        const int l = src[q];
        for (int k = 0; k < n_bins; ++k) cols[k * kOriThreads + tid] = 0.f;
        orientation_accumulate(cols, tid, kOriThreads, lane(l), fd, H, W,
                               radius, n_bins, lam);
        __syncthreads();
        float* out_l = out + (long long)l * n_bins;
        for (int k = tid; k < n_bins; k += kOriThreads)
          out_l[k] = column_sum(cols, k);
        __syncthreads();  // the sums are read before the next lane zeroes them
      }
    }
    __syncthreads();  // the copy and sh are done with before the next run
  }
}

// Resident-tile form of the staged descriptor kernel: each block takes runs
// with next_run, and its warps take the run's lanes in turn (Hist::kParts
// warps a lane), each with descriptor_warp reading gi/gj from the copy.
// Rows of lanes in no run are not written: the wrapper hands in zeros.
template <class Hist>
__global__ void resident_descriptor_kernel(
    const float* __restrict__ gi, const float* __restrict__ gj, int B, int S,
    int H, int W, const int* __restrict__ heads, int* __restrict__ runs,
    const int* __restrict__ run_end, const int* __restrict__ src,
    const int* __restrict__ frame, const int* __restrict__ scale,
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ sigma, const float* __restrict__ theta,
    int radius, int tile, int n_hist, int n_ori, float lam,
    float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char warp_smem[];
  __shared__ int sh[5];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int w = tid >> 5, nw = nt >> 5;
  const int side = tile + 2 * radius;
  Hist hist(n_hist, n_ori);
  const int n_out = hist.n_out();
  const int g = w / Hist::kParts, part = w % Hist::kParts;
  const int groups = nw / Hist::kParts;
  WarpScratch<Hist>* wsa = reinterpret_cast<WarpScratch<Hist>*>(warp_smem);
  float* red = reinterpret_cast<float*>(wsa + nw) + g * Hist::kParts * n_out;
  float* reg_i = reinterpret_cast<float*>(warp_smem + lane_smem<Hist>(nw));
  float* reg_j = reg_i + side * side;
  const auto lane = [&](int l) {
    return lane_of(l, B, S, H, W, frame, scale, x, y, sigma);
  };
  for (;;) {
    const Run run = next_run(sh, heads, runs, run_end, src, H, W, [&](int l) {
      return descriptor_window(lane(l), H, W, radius, hist.n_hist(), lam);
    });
    if (run.p < 0) return;
    if (run.rows > side || run.pitch > side) {
      refuse_run(run, src, n_out, out);
    } else {
      const Field fd = copy_run(
          run, plane_field(lane(src[run.p]), gi, gj, S, H, W), W, reg_i, reg_j);
      for (int q = run.p + g; q < run.end; q += groups) {
        const int l = src[q];
        descriptor_lane(wsa[w], red, hist, g, part, lane(l), theta[l], fd, H,
                        W, radius, lam, out + (long long)l * n_out);
      }
    }
    __syncthreads();  // the copy and sh are done with before the next run
  }
}

constexpr int kMaxDynamicShared = 232448;  // 227 KB a block on sm_90

template <class Hist>
int launch_descriptor(const float* gi, const float* gj, int B, int S, int H,
                      int W, int L, const uint8_t* valid, const int* frame,
                      const int* scale, const float* x, const float* y,
                      const float* sigma, const float* theta, int radius,
                      int n_hist, int n_ori, float lam, float* out,
                      cudaStream_t stream) {
  constexpr int kWarps = staged_warps<Hist>(), kLanes = kWarps / Hist::kParts;
  const int bytes = lane_smem<Hist>(kWarps);
  const int err =
      device_facts::allow_shared((const void*)descriptor_kernel<Hist>, bytes);
  if (err != 0) return err;
  if (L > 0)
    descriptor_kernel<Hist>
        <<<(L + kLanes - 1) / kLanes, kWarps * 32, bytes,
           stream>>>(gi, gj, B, S, H, W, L, valid, frame, scale, x, y, sigma,
                     theta, radius, n_hist, n_ori, lam, out);
  return (int)cudaGetLastError();
}

// Launches a resident-tile kernel as a persistent grid (SMs x the blocks of
// `threads` threads and `bytes` of dynamic shared memory that an SM holds,
// known once per device), after resetting runs[1] so that the runs are
// handed out from the first.
template <class Kernel, class... Args>
int launch_resident(Kernel kernel, int threads, long long bytes, int* runs,
                    cudaStream_t stream, Args... args) {
  if (bytes > kMaxDynamicShared) return (int)cudaErrorInvalidValue;
  int grid = 0;
  int err = device_facts::resident_grid((const void*)kernel, threads, bytes,
                                        &grid);
  if (err != 0) return err;
  if ((err = (int)cudaMemsetAsync(runs + 1, 0, sizeof(int), stream)) != 0)
    return err;
  kernel<<<grid, threads, (size_t)bytes, stream>>>(args...);
  return (int)cudaGetLastError();
}

// A resident descriptor block takes one lane of Hist48 at a time (its
// kParts warps) and four lanes of HistAny, fewer where the region leaves
// no room.
template <class Hist>
int launch_resident_descriptor(const float* gi, const float* gj, int B, int S,
                               int H, int W, const int* heads, int* runs,
                               const int* run_end, const int* src,
                               const int* frame, const int* scale,
                               const float* x, const float* y,
                               const float* sigma, const float* theta,
                               int radius, int tile, int n_hist, int n_ori,
                               float lam, float* out, cudaStream_t stream) {
  if (tile < 1 || radius < 0) return (int)cudaErrorInvalidValue;
  const long long region =
      2 * ((long long)tile + 2 * radius) * ((long long)tile + 2 * radius) *
      (long long)sizeof(float);
  int warps = staged_warps<Hist>();
  while (warps > Hist::kParts &&
         region + lane_smem<Hist>(warps) > kMaxDynamicShared)
    warps -= Hist::kParts;
  return launch_resident(resident_descriptor_kernel<Hist>, warps * 32,
                         region + lane_smem<Hist>(warps), runs, stream, gi, gj,
                         B, S, H, W, heads, runs, run_end, src, frame, scale, x,
                         y, sigma, theta, radius, tile, n_hist, n_ori, lam,
                         out);
}

bool shape48(int n_hist, int n_ori) { return n_hist == 4 && n_ori == 8; }

bool shape_ok(int n_hist, int n_ori) {
  return n_hist >= 1 && n_ori >= 1 && n_hist <= kMaxHist && n_ori <= kMaxOri;
}

}  // namespace

// Orientation histograms of every octave in `table` (host, int64; ops/
// kernels/patches.py orientation_plan): n_oct, then per octave gi, gj,
// valid, frame (0: lane l is of frame l / budget), scale, x, y, sigma, out,
// B, S, H, W, lanes, budget, row_stride, first scan, first lane. `work`
// (4 + lanes ints) must be zeroed.
extern "C" int orientation_octaves(const long long* table, int radius,
                                   int n_bins, float lam, int* work,
                                   cudaStream_t stream) {
  OriLaunch L = {};
  L.n_oct = (int)table[0];
  if (L.n_oct < 1 || L.n_oct > kMaxOriOctaves || n_bins < 1 || radius < 0)
    return (int)cudaErrorInvalidValue;
  long long scans = 0, lanes = 0;
  for (int o = 0; o < L.n_oct; ++o) {
    const long long* t = table + 1 + 18 * o;
    OriOctave& oc = L.oct[o];
    oc.gi = (const float*)t[0];
    oc.gj = (const float*)t[1];
    oc.valid = (const uint8_t*)t[2];
    oc.frame = (const int*)t[3];
    oc.scale = (const int*)t[4];
    oc.x = (const float*)t[5];
    oc.y = (const float*)t[6];
    oc.sigma = (const float*)t[7];
    oc.out = (float*)t[8];
    oc.B = (int)t[9];
    oc.S = (int)t[10];
    oc.H = (int)t[11];
    oc.W = (int)t[12];
    oc.lanes = (int)t[13];
    oc.budget = (int)t[14];
    oc.row_stride = (int)t[15];
    oc.scan0 = (int)t[16];
    oc.lane0 = (int)t[17];
    if (oc.B < 1 || oc.S < 1 || oc.H < 1 || oc.W < 1 || oc.lanes < 0 ||
        oc.budget < 1 || oc.scan0 != scans || oc.lane0 != lanes)
      return (int)cudaErrorInvalidValue;
    scans += (oc.lanes + kOriScan - 1) / kOriScan;
    lanes += oc.lanes;
  }
  if (lanes >= 0x7fffffff) return (int)cudaErrorInvalidValue;
  L.scans = (int)scans;
  L.lanes = (int)lanes;
  L.radius = radius;
  L.n_bins = n_bins;
  L.lam = lam;
  L.work = work;
  if (scans == 0) return 0;
  const long long bytes = (long long)n_bins * kOriThreads * sizeof(float);
  int grid = 0;
  const int err = device_facts::resident_grid((const void*)orientation_kernel,
                                              kOriThreads, bytes, &grid);
  if (err != 0) return err;
  void* args[] = {&L};
  return (int)cudaLaunchKernel((const void*)orientation_kernel, dim3(grid),
                               dim3(kOriThreads), args, (size_t)bytes, stream);
}

// The card test's probe of wrap_angle and wrap_bin (wrap_pairs_kernel):
// th [n][2] (old, new) and bins [n][2].
extern "C" int orientation_wrap_pairs(const float* gi, const float* gj, int n,
                                      int n_bins, float* th, int* bins,
                                      cudaStream_t stream) {
  if (n_bins < 1) return (int)cudaErrorInvalidValue;
  if (n > 0)
    wrap_pairs_kernel<<<(n + 127) / 128, 128, 0, stream>>>(gi, gj, n, n_bins,
                                                           th, bins);
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
  if (shape48(n_hist, n_ori))
    return launch_descriptor<Hist48>(gi, gj, B, S, H, W, L, valid, frame,
                                     scale, x, y, sigma, theta, radius, n_hist,
                                     n_ori, lam, out, stream);
  if (shape_ok(n_hist, n_ori))
    return launch_descriptor<HistAny>(gi, gj, B, S, H, W, L, valid, frame,
                                      scale, x, y, sigma, theta, radius,
                                      n_hist, n_ori, lam, out, stream);
  return (int)cudaErrorInvalidValue;
}

// Fused form: one block per keypoint lane, of the staged descriptor
// block's shape for (n_hist, n_ori).
extern "C" int orient_desc(const float* gi, const float* gj, int B, int S,
                           int H, int W, int L, const uint8_t* valid,
                           const int* frame, const int* scale, const float* x,
                           const float* y, const float* sigma, int ori_radius,
                           int n_bins, float lam_ori, int smooth_iters,
                           float peak_thr, int max_ori, int desc_radius,
                           int n_hist, int n_ori, float lam_desc, float* raw,
                           float* theta, uint8_t* ori_valid,
                           cudaStream_t stream) {
  const bool k48 = shape48(n_hist, n_ori);
  if (!shape_ok(n_hist, n_ori) || n_bins < 1 || n_bins > kMaxBins ||
      max_ori < 1 || max_ori > kMaxPeaks)
    return (int)cudaErrorInvalidValue;
  const auto kernel =
      k48 ? orient_desc_kernel<Hist48> : orient_desc_kernel<HistAny>;
  const int warps = k48 ? staged_warps<Hist48>() : staged_warps<HistAny>();
  const int scratch =
      k48 ? lane_smem<Hist48>(warps) : lane_smem<HistAny>(warps);
  const int cols = kOriThreads * n_bins * (int)sizeof(float);
  const int bytes = cols > scratch ? cols : scratch;
  const int err = device_facts::allow_shared((const void*)kernel, bytes);
  if (err != 0) return err;
  if (L > 0)
    kernel<<<L, warps * 32, bytes, stream>>>(
        gi, gj, B, S, H, W, valid, frame, scale, x, y, sigma, ori_radius,
        n_bins, lam_ori, smooth_iters, peak_thr, max_ori, desc_radius, n_hist,
        n_ori, lam_desc, raw, theta, ori_valid);
  return (int)cudaGetLastError();
}

// Resident orientation form over a tile_runs layout made with the same
// tile; `out` must be zeroed by the caller. The block size is the staged
// kernel's, so the result equals its.
extern "C" int orientation_hist_banded(
    const float* gi, const float* gj, int B, int S, int H, int W,
    const int* heads, int* runs, const int* run_end, const int* src,
    const int* frame, const int* scale, const float* x, const float* y,
    const float* sigma, int radius, int tile, int n_bins, float lam,
    float* out, cudaStream_t stream) {
  if (tile < 1 || radius < 0 || n_bins < 1) return (int)cudaErrorInvalidValue;
  const long long side = (long long)tile + 2 * radius;
  return launch_resident(
      resident_orientation_kernel, kOriThreads,
      ((long long)n_bins * kOriThreads + 2 * side * side) *
          (long long)sizeof(float),
      runs, stream, gi, gj, B, S, H, W, heads, runs, run_end, src, frame, scale,
      x, y, sigma, radius, tile, n_bins, lam, out);
}

// Tile layout of [L] lanes for the resident forms. Scratch: count and
// start hold n_tiles + 1 ints (n_tiles = B S ceil(H / tile)
// ceil(W / tile)), rank L. Out: src, first, run_end as tile_layout's (the
// order inside a run aside), heads[0 .. runs[0]) the runs' first
// positions, runs[1] = 0.
extern "C" int tile_runs(int B, int S, int H, int W, int L,
                         const uint8_t* valid, const int* frame,
                         const int* scale, const float* x, const float* y,
                         int tile, int* count, int* start, int* rank, int* src,
                         uint8_t* first, int* run_end, int* heads, int* runs,
                         cudaStream_t stream) {
  if (tile < 1) return (int)cudaErrorInvalidValue;
  const int tr = (H + tile - 1) / tile, tc = (W + tile - 1) / tile;
  const long long nk = (long long)B * S * tr * tc;
  if (nk >= (1LL << 30)) return (int)cudaErrorInvalidValue;
  const int n_tiles = (int)nk;
  cudaError_t err =
      cudaMemsetAsync(count, 0, (size_t)(n_tiles + 1) * sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(runs, 0, 2 * sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  if (L > 0) {
    const int nb = (L + 255) / 256;
    layout_count_kernel<<<nb, 256, 0, stream>>>(B, S, H, W, L, valid, frame,
                                                scale, x, y, tile, tr, tc,
                                                n_tiles, count, rank);
    layout_scan_kernel<<<1, kScanThreads, 0, stream>>>(count, n_tiles + 1,
                                                      start);
    layout_scatter_kernel<<<nb, 256, 0, stream>>>(
        B, S, H, W, L, valid, frame, scale, x, y, tile, tr, tc, n_tiles, count,
        start, rank, src, first, run_end, heads, runs);
  }
  return (int)cudaGetLastError();
}

// Resident descriptor form over a tile_runs layout made with the same
// tile; `out` must be zeroed by the caller.
extern "C" int descriptor_hist_banded(
    const float* gi, const float* gj, int B, int S, int H, int W,
    const int* heads, int* runs, const int* run_end, const int* src,
    const int* frame, const int* scale, const float* x, const float* y,
    const float* sigma, const float* theta, int radius, int tile, int n_hist,
    int n_ori, float lam, float* out, cudaStream_t stream) {
  if (shape48(n_hist, n_ori))
    return launch_resident_descriptor<Hist48>(
        gi, gj, B, S, H, W, heads, runs, run_end, src, frame, scale, x, y,
        sigma, theta, radius, tile, n_hist, n_ori, lam, out, stream);
  if (shape_ok(n_hist, n_ori))
    return launch_resident_descriptor<HistAny>(
        gi, gj, B, S, H, W, heads, runs, run_end, src, frame, scale, x, y,
        sigma, theta, radius, tile, n_hist, n_ori, lam, out, stream);
  return (int)cudaErrorInvalidValue;
}
