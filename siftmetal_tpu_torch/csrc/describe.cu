// The describe stage's bookkeeping between detection and the descriptor
// rows, in three launches a call (sift/batched.py _describe_octaves on a
// card), each over every octave and every frame of the batch:
//
//   keypoint_compact_kernel: each octave's valid keypoint slots (cand_valid
//     and pass_border of the refinement tail's lists), in ascending slot
//     order, into the octave's keypoint budget, with the fields the patch
//     kernels read (x_oct = i + ofst_i, y_oct = j + ofst_j, sigma_oct =
//     sigma / delta) and those the rows keep; the slots that do not fit
//     are counted (sift/detect.py compact_octave_keypoints, every octave);
//   lane_peaks_kernel: on the orientation kernel's raw histograms, each
//     keypoint's circular box smoothings, peak map and its max_ori highest
//     peaks (sift/describe.py _smooth_circular, orientation_peaks), then
//     each octave's (keypoint, peak) pairs compacted in ascending order
//     into its lane slots, the dropped ones counted: the descriptor
//     kernel's lane arrays and the descriptor rows' fields in one pass;
//   quantize_rows_kernel: every octave's raw descriptor rows normalised,
//     clipped at 0.2, renormalised and quantised to uint8
//     (sift/describe.py quantize_descriptors).
//
// None replaces a Pallas kernel: the JAX package's steps here are XLA glue
// around its patch kernels. Each output equals the port's PyTorch route
// (sift/describe.py orientation_lanes_plain and its neighbours) run on the
// card on the same inputs, bit for bit, padding slots included: those hold
// index 0's values, as the route's gathers read them. So every sum and
// product below is rounded as the route's separate kernels round it
// (explicit __fadd_rn / __fmul_rn / __fdiv_rn, and -fmad=false for this
// file): PyTorch on a card divides by a Python number as a product with its
// fp32 reciprocal (the smoothing's / 3 and sigma / delta), and by a tensor
// as a division (the parabola's offset, the quantisation). The
// quantisation's two norms sum a row as torch.linalg.vector_norm does for
// 128 contiguous floats (each of 32 lanes squares a float4 and adds its four
// squares in order, then the warp adds by shuffles at offsets 16, 8, 4, 2,
// 1); any other row length takes one fixed order of its own.
//
// Layout: one thread-block cluster of 8 blocks a frame for the two
// compactions (as the refinement tail): block r owns the r-th share of
// every octave's slots, its shares one after another in a "flat" order.
// It counts its valid slots an octave, reads the other blocks' counts from
// their shared memory after a cluster barrier, and writes every octave's
// share at its place in ascending order in one pass over the flat order
// (ranks by a block scan, a chunk of 2,048 slots or 512 keypoints at a
// time, so the octaves do not wait on each other); the padding past every
// octave's count is split over the cluster; block 0 sums the dropped
// counts. The peaks are computed once, one keypoint a thread in registers
// (a 36-bin, 4-peak instance and a generic one), by block k mod 8 for
// keypoint k (the valid keypoints lead each octave, so the work spreads
// over the cluster), and written into the shared memory of the block that
// owns the keypoint, which compacts the lanes from there. Quantisation: a
// warp a row. Two or three cluster barriers a launch; no atomics leave a
// block.
//
// Nothing allocates, nothing reads back to the host, every launch goes on
// the stream it is given (so a CUDA graph captures all three).
//
// Bound on an H100: bytes, and far from them: at 480x640 in the parity
// configuration a frame has ~34k keypoint slots to scan (2 bytes each),
// 4,992 keypoint rows of 36 bins (0.7 MB), 7,552 lanes of 11 fields and
// 7,552 descriptor rows of 512 bytes in and 128 out (4.8 MB): ~6 MB, 1.8 us
// at 3.35 TB/s. The two compactions are ordered and small, so latency
// (cluster barriers, block scans) sets their time.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "device_facts.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kMaxOctaves = 16;
constexpr int kCluster = 8;  // blocks a frame: one thread-block cluster
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 4;        // slots a thread takes in a chunk of the keypoint scan
constexpr int kMaxBins = 64;   // the generic peak instance's bins
constexpr int kMaxOri = 8;     // and its peaks a keypoint
constexpr int kQuantWarps = 8;  // rows a block of the quantisation
constexpr unsigned kFullWarp = 0xffffffffu;

// Slots [share(n, r), share(n, r + 1)) of n are block r's.
__device__ __forceinline__ int share(int n, int r) {
  return (int)((long long)n * r / kCluster);
}

// The exclusive prefix of v over the block in thread order; *total gets
// the block's sum. Every thread calls it (two barriers; the first frees
// sm from the previous call's readers).
__device__ __forceinline__ int block_scan(int v, int* sm, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFullWarp, x, d);
    if (lane >= d) x += y;
  }
  __syncthreads();
  if (lane == 31) sm[warp] = x;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int s = sm[w];
    before += w < warp ? s : 0;
    all += s;
  }
  *total = all;
  return before + x - v;
}

// ---------------------------------------------------------------------------
// Keypoint compaction.

struct CompactOctave {
  const uint8_t* cand_valid;  // [B, width] each: the octave's slot lists
  const uint8_t* pass_border;
  const int* scale;
  const int* i;
  const int* j;
  const float* ofst_i;
  const float* ofst_j;
  const float* x;
  const float* y;
  const float* sigma;
  const float* value;
  long long out0;   // first output slot: B x the budgets of the octaves before
  int width, budget;
  float inv_delta;  // fp32(1 / fp32(delta))
};

struct CompactLaunch {
  CompactOctave oct[kMaxOctaves];
  int n_oct, B;
  long long total;  // B x the sum of the budgets
  uint8_t* valid;   // [total]
  int* scale;       // [total]
  float* reals;     // [7][total]: x_oct, y_oct, sigma_oct, x, y, sigma, value
  int* dropped;     // [B]
};

__device__ __forceinline__ void put_keypoint(const CompactLaunch& L, const CompactOctave& oc,
                                             int b, int src, int dst, bool valid) {
  const long long in = (long long)b * oc.width + src;
  const long long out = oc.out0 + (long long)b * oc.budget + dst;
  const long long t = L.total;
  const float sigma = oc.sigma[in];
  float* r = L.reals + out;
  L.valid[out] = valid;
  L.scale[out] = oc.scale[in];
  r[0] = __fadd_rn(__int2float_rn(oc.i[in]), oc.ofst_i[in]);
  r[t] = __fadd_rn(__int2float_rn(oc.j[in]), oc.ofst_j[in]);
  r[2 * t] = __fmul_rn(sigma, oc.inv_delta);
  r[3 * t] = oc.x[in];
  r[4 * t] = oc.y[in];
  r[5 * t] = sigma;
  r[6 * t] = oc.value[in];
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
    keypoint_compact_kernel(const __grid_constant__ CompactLaunch L) {
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ int scan_sm[kWarps];
  // This block's shares of the octaves one after another ("flat" slots):
  // share o is flat [first[o], first[o + 1]); the padding past every
  // octave's count, one after another over the cluster, likewise.
  __shared__ int first[kMaxOctaves + 1], pad_first[kMaxOctaves + 1];
  __shared__ int n_in[kMaxOctaves], in0[kMaxOctaves];     // this block's valid slots, an
                                                          // octave, and in the octaves before
  __shared__ int before[kMaxOctaves], all[kMaxOctaves];  // in the blocks before, in all
  const int r = (int)cluster.block_rank(), b = blockIdx.x / kCluster, tid = threadIdx.x;
  if (tid == 0) {
    int f = 0;
    for (int o = 0; o < L.n_oct; ++o) {
      first[o] = f;
      f += share(L.oct[o].width, r + 1) - share(L.oct[o].width, r);
    }
    first[L.n_oct] = f;
  }
  if (tid < kMaxOctaves) n_in[tid] = 0;
  __syncthreads();
  const int n_flat = first[L.n_oct];
  // Flat slot s -> its octave o and whether it is valid (l: its slot).
  auto flag = [&](int s, int& o, int& l) {
    o = 0;
    while (s >= first[o + 1]) ++o;
    const CompactOctave& oc = L.oct[o];
    l = share(oc.width, r) + s - first[o];
    const long long in = (long long)b * oc.width + l;
    return oc.cand_valid[in] != 0 && oc.pass_border[in] != 0;
  };
  // Count: kPer consecutive slots a thread, every load before its use.
  for (int s0 = tid * kPer; s0 < n_flat; s0 += kThreads * kPer) {
    bool f[kPer];
    int o[kPer], l;
#pragma unroll
    for (int k = 0; k < kPer; ++k) f[k] = s0 + k < n_flat && flag(s0 + k, o[k], l);
#pragma unroll
    for (int k = 0; k < kPer; ++k)
      if (f[k]) atomicAdd(n_in + o[k], 1);
  }
  cluster.sync();  // every block's counts are in
  if (tid < L.n_oct) {
    int bf = 0, al = 0;
    for (int q = 0; q < kCluster; ++q) {
      const int v = cluster.map_shared_rank(n_in, q)[tid];
      bf += q < r ? v : 0;
      al += v;
    }
    before[tid] = bf;
    all[tid] = al;
  }
  __syncthreads();
  if (tid == 0) {
    int in = 0, pad = 0, drop = 0;
    for (int o = 0; o < L.n_oct; ++o) {
      in0[o] = in;
      in += n_in[o];
      pad_first[o] = pad;
      pad += max(L.oct[o].budget - all[o], 0);
      drop += max(all[o] - L.oct[o].budget, 0);
    }
    pad_first[L.n_oct] = pad;
    if (r == 0) L.dropped[b] = drop;
  }
  __syncthreads();
  // Write: a chunk of kThreads x kPer flat slots at a time; a valid slot's
  // place is its rank among the octave's valid slots of the blocks before
  // and of this block's share before it.
  int base = 0;  // this block's valid slots before the chunk
  for (int c = 0; c < n_flat; c += kThreads * kPer) {
    const int s0 = c + tid * kPer;
    bool f[kPer];
    int o[kPer], l[kPer], n = 0;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      f[k] = s0 + k < n_flat && flag(s0 + k, o[k], l[k]);
      n += f[k];
    }
    int total;
    int rank = base + block_scan(n, scan_sm, &total);
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (!f[k]) continue;
      const CompactOctave& oc = L.oct[o[k]];
      const int dst = before[o[k]] + rank - in0[o[k]];
      if (dst < oc.budget) put_keypoint(L, oc, b, l[k], dst, true);
      ++rank;
    }
    base += total;
  }
  // Slots past an octave's count hold slot 0's values (compact_indices
  // pads with index 0), not valid.
  for (int p = r * kThreads + tid; p < pad_first[L.n_oct]; p += kCluster * kThreads) {
    int o = 0;
    while (p >= pad_first[o + 1]) ++o;
    const CompactOctave& oc = L.oct[o];
    put_keypoint(L, oc, b, 0, oc.budget - (pad_first[o + 1] - p), false);
  }
  cluster.sync();  // no block leaves while another reads its counts
}

// ---------------------------------------------------------------------------
// Peaks and lanes.

struct LaneOctave {
  const uint8_t* kp_valid;  // [B, budget] each: the octave's compacted keypoints
  const int* scale;
  const float* x_oct;
  const float* y_oct;
  const float* sigma_oct;
  const float* x;
  const float* y;
  const float* sigma;
  long long out0;  // first lane: B x the lanes of the octaves before
  int row0;        // the octave's first histogram row in a frame
  int budget, n_lanes;
};

struct LaneLaunch {
  LaneOctave oct[kMaxOctaves];
  const float* hist;        // [B, rows, n_bins]: the orientation kernel's raw rows
  const int* dropped_in;    // [B]: the keypoint compaction's count
  int n_oct, B, rows, n_bins, max_ori, smooth_iters;
  int stash_n;              // stash slots a block: at least the sum of its shares' sizes
  float third, peak_thr, bin_w, pi, two_pi;  // fp32 constants, as the route rounds them
  long long total;          // B x the lanes of every octave
  uint8_t* valid;           // [total]
  int* ints;                // [3][total]: scale, frame, octave
  float* reals;             // [7][total]: x_oct, y_oct, sigma_oct, theta, x, y, sigma
  int* dropped;             // [B]
};

__device__ __forceinline__ float mod_2pi(float a, float two_pi) {
  // Floor-mod with the divisor's sign (torch.remainder).
  float m = fmodf(a, two_pi);
  if (m != 0.f && m < 0.f) m = __fadd_rn(m, two_pi);
  return m;
}

// One keypoint's raw histogram row -> the thetas of its highest peaks,
// at most max_ori, highest first (ties: the lower bin first, as the stable
// descending sort orders them) into th; returns their number. NB > 0
// fixes the bins (the row in registers), NB = 0 reads them from L (local
// arrays); MO likewise the peaks.
template <int NB, int MO>
__device__ __forceinline__ int row_peaks(const LaneLaunch& L, const float* row, float* th) {
  constexpr bool kFixed = NB > 0;
  constexpr int kN = kFixed ? NB : kMaxBins;
  const int n = kFixed ? NB : L.n_bins;
  const int mo = MO > 0 ? MO : L.max_ori;
  float h[kN], t[kN];
  if (kFixed && NB % 4 == 0) {
    const float4* r4 = reinterpret_cast<const float4*>(row);
#pragma unroll
    for (int k = 0; k < kN / 4; ++k) {
      const float4 v = __ldg(r4 + k);
      h[4 * k] = v.x;
      h[4 * k + 1] = v.y;
      h[4 * k + 2] = v.z;
      h[4 * k + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kN; ++k) h[k] = k < n ? __ldg(row + k) : 0.f;
  }
  // (h[k-1] + h[k]) + h[k+1], times fp32(1/3), in place: prev holds the
  // old h[k-1], first the old h[0] for the wrap.
  for (int it = 0; it < L.smooth_iters; ++it) {
    const float first = h[0];
    float prev = h[kFixed ? kN - 1 : 0];
    if (!kFixed) {
#pragma unroll
      for (int k = 0; k < kN; ++k) prev = k == n - 1 ? h[k] : prev;
    }
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      if (k < n) {
        const float cur = h[k];
        const float nxt = k + 1 < n ? h[k + 1 < kN ? k + 1 : 0] : first;
        h[k] = __fmul_rn(__fadd_rn(__fadd_rn(prev, cur), nxt), L.third);
        prev = cur;
      }
    }
  }
  float hmax = h[0];
#pragma unroll
  for (int k = 1; k < kN; ++k)
    if (k < n) hmax = fmaxf(hmax, h[k]);
  const float floor_v = __fmul_rn(L.peak_thr, hmax);
  unsigned long long peaks = 0;
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    t[k] = 0.f;
    if (k >= n) continue;
    const float c = h[k];
    float pv = h[k == 0 ? (kFixed ? kN - 1 : 0) : k - 1];
    if (!kFixed && k == 0) {
#pragma unroll
      for (int q = 0; q < kN; ++q) pv = q == n - 1 ? h[q] : pv;
    }
    const float nx = k + 1 < n ? h[k + 1 < kN ? k + 1 : 0] : h[0];
    if (c > pv && c > nx && c >= floor_v && c > 0.f) {
      peaks |= 1ull << k;
      // offset = (prev - next) / (2 (prev + next - 2 h)); theta = (k + 0.5
      // + offset) * bin width; remainder(theta + pi, 2 pi) - pi.
      const float den = __fmul_rn(2.0f, __fsub_rn(__fadd_rn(pv, nx), __fmul_rn(2.0f, c)));
      const float off = __fdiv_rn(__fsub_rn(pv, nx), den);
      const float a = __fmul_rn(__fadd_rn(__fadd_rn((float)k, 0.5f), off), L.bin_w);
      t[k] = __fsub_rn(mod_2pi(__fadd_rn(a, L.pi), L.two_pi), L.pi);
    }
  }
  int np = 0;
#pragma unroll
  for (int p = 0; p < (MO > 0 ? MO : kMaxOri); ++p) {
    if (p >= mo || peaks == 0) break;
    int best = -1;
    float hb = 0.f, tb = 0.f;
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      if (((peaks >> k) & 1ull) && (best < 0 || h[k] > hb)) {
        best = k;
        hb = h[k];
        tb = t[k];
      }
    }
    th[np++] = tb;
    peaks &= ~(1ull << best);
  }
  return np;
}

__device__ __forceinline__ void put_lane(const LaneLaunch& L, const LaneOctave& oc, int o,
                                         int b, int k, float theta, int s, bool valid) {
  const long long in = (long long)b * oc.budget + k;
  const long long out = oc.out0 + (long long)b * oc.n_lanes + s;
  const long long t = L.total;
  float* r = L.reals + out;
  L.valid[out] = valid;
  L.ints[out] = oc.scale[in];
  L.ints[t + out] = b;
  L.ints[2 * t + out] = o;
  r[0] = oc.x_oct[in];
  r[t] = oc.y_oct[in];
  r[2 * t] = oc.sigma_oct[in];
  r[3 * t] = theta;
  r[4 * t] = oc.x[in];
  r[5 * t] = oc.y[in];
  r[6 * t] = oc.sigma[in];
}

// The block whose share of an octave of n keypoints holds keypoint k.
__device__ __forceinline__ int owner(int n, int k) {
  int q = min(kCluster - 1, (int)(((long long)kCluster * (k + 1) + n - 1) / n) - 1);
  while (q + 1 < kCluster && share(n, q + 1) <= k) ++q;
  while (q > 0 && share(n, q) > k) --q;
  return q;
}

template <int NB, int MO>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
    lane_peaks_kernel(const __grid_constant__ LaneLaunch L) {
  cg::cluster_group cluster = cg::this_cluster();
  // The peaks of this block's shares of the octaves, one after another
  // ("flat" slots: block q's share of octave o is its flat [first[q][o],
  // first[q][o + 1])): [stash_n][max_ori] thetas, then [stash_n] pair
  // counts (0 for an invalid keypoint).
  extern __shared__ float stash[];
  __shared__ int scan_sm[kWarps];
  __shared__ int first[kCluster][kMaxOctaves + 1];
  // The keypoints this block computes: k = r, r + 8, ... of each octave
  // (the valid ones lead each octave, so every block gets its part), flat
  // as well; and the padding past every octave's count.
  __shared__ int mine[kMaxOctaves + 1], pad_first[kMaxOctaves + 1];
  __shared__ int n_in[kMaxOctaves], in0[kMaxOctaves];    // this block's pairs, an octave,
                                                         // and in the octaves before
  __shared__ int before[kMaxOctaves], all[kMaxOctaves];  // in the blocks before, in all
  __shared__ float th0[kMaxOctaves];  // theta of (keypoint 0, peak 0): block 0's
  __shared__ float pad[kMaxOctaves];  // block 0's, for the padding
  const int r = (int)cluster.block_rank(), b = blockIdx.x / kCluster, tid = threadIdx.x;
  const int mo = MO > 0 ? MO : L.max_ori;
  const long long cnt0 = (long long)L.stash_n * mo;  // the counts' first byte, in floats
  if (tid <= kCluster) {
    int f = 0;
    for (int o = 0; o < L.n_oct; ++o) {
      const int n = L.oct[o].budget;
      if (tid < kCluster) {
        first[tid][o] = f;
        f += share(n, tid + 1) - share(n, tid);
      } else {
        mine[o] = f;
        f += n > r ? (n - r + kCluster - 1) / kCluster : 0;
      }
    }
    if (tid < kCluster) first[tid][L.n_oct] = f;
    else mine[L.n_oct] = f;
  }
  if (tid < kMaxOctaves) n_in[tid] = 0;
  __syncthreads();
  // The peaks of every keypoint this block computes, one a thread, into
  // the stash of the block whose share holds it.
  for (int s = tid; s < mine[L.n_oct]; s += kThreads) {
    int o = 0;
    while (s >= mine[o + 1]) ++o;
    const LaneOctave& oc = L.oct[o];
    const int k = r + kCluster * (s - mine[o]);
    const int q = owner(oc.budget, k);
    const int slot = first[q][o] + k - share(oc.budget, q);
    float* th = cluster.map_shared_rank(stash, q) + (long long)slot * mo;
    const bool v = oc.kp_valid[(long long)b * oc.budget + k] != 0;
    int np = 0;
    if (v || k == 0) {
      np = row_peaks<NB, MO>(L, L.hist + ((long long)b * L.rows + oc.row0 + k) * L.n_bins, th);
      if (k == 0) th0[o] = np > 0 ? th[0] : 0.f;
    }
    reinterpret_cast<uint8_t*>(cluster.map_shared_rank(stash, q) + cnt0)[slot] =
        (uint8_t)(v ? np : 0);
  }
  cluster.sync();  // every block's stash is complete
  const uint8_t* cnt = reinterpret_cast<const uint8_t*>(stash + cnt0);
  const int* mine_first = first[r];
  const int n_flat = mine_first[L.n_oct];
  for (int s = tid; s < n_flat; s += kThreads) {
    int o = 0;
    while (s >= mine_first[o + 1]) ++o;
    if (cnt[s]) atomicAdd(n_in + o, cnt[s]);
  }
  cluster.sync();  // every block's counts are in
  if (tid < L.n_oct) {
    int bf = 0, al = 0;
    for (int q = 0; q < kCluster; ++q) {
      const int v = cluster.map_shared_rank(n_in, q)[tid];
      bf += q < r ? v : 0;
      al += v;
    }
    before[tid] = bf;
    all[tid] = al;
    pad[tid] = cluster.map_shared_rank(th0, 0)[tid];
  }
  __syncthreads();
  if (tid == 0) {
    int in = 0, n_pad = 0, drop = L.dropped_in[b];
    for (int o = 0; o < L.n_oct; ++o) {
      in0[o] = in;
      in += n_in[o];
      pad_first[o] = n_pad;
      n_pad += max(L.oct[o].n_lanes - all[o], 0);
      drop += max(all[o] - L.oct[o].n_lanes, 0);
    }
    pad_first[L.n_oct] = n_pad;
    if (r == 0) L.dropped[b] = drop;
  }
  __syncthreads();
  // The lanes: a keypoint a thread, a chunk of kThreads flat slots at a
  // time; a pair's place is its rank among the octave's pairs of the
  // blocks before and of this block's share before it.
  int base = 0;  // this block's pairs before the chunk
  for (int c = 0; c < n_flat; c += kThreads) {
    const int s = c + tid;
    int o = 0;
    while (o < L.n_oct - 1 && s >= mine_first[o + 1]) ++o;
    const int np = s < n_flat ? cnt[s] : 0;
    int total;
    const int rank = base + block_scan(np, scan_sm, &total);
    if (np > 0) {
      const LaneOctave& oc = L.oct[o];
      const int k = share(oc.budget, r) + s - mine_first[o];
      const int dst = before[o] + rank - in0[o];
      for (int p = 0; p < np && dst + p < oc.n_lanes; ++p)
        put_lane(L, oc, o, b, k, stash[(long long)s * mo + p], dst + p, true);
    }
    base += total;
  }
  // Lanes past an octave's count hold pair 0's values: keypoint 0 and its
  // first theta (zero without a peak), not valid.
  for (int p = r * kThreads + tid; p < pad_first[L.n_oct]; p += kCluster * kThreads) {
    int o = 0;
    while (p >= pad_first[o + 1]) ++o;
    const LaneOctave& oc = L.oct[o];
    put_lane(L, oc, o, b, 0, pad[o], oc.n_lanes - (pad_first[o + 1] - p), false);
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

// ---------------------------------------------------------------------------
// Quantisation.

struct QuantPart {
  const float* raw;  // [rows, D]
  long long rows, row0;  // its rows, and its first row of the output
};

struct QuantLaunch {
  QuantPart part[kMaxOctaves];
  int n_part, D;
  long long rows;
  uint8_t* out;  // [rows, D]
};

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s = __fadd_rn(s, __shfl_down_sync(kFullWarp, s, off));
  return __shfl_sync(kFullWarp, s, 0);
}

__device__ __forceinline__ uint8_t level(float c, float den) {
  const float q = fminf(floorf(__fdiv_rn(__fmul_rn(512.0f, c), den)), 255.0f);
  return (uint8_t)(long long)q;
}

// One warp a row: norm, clip at 0.2 norm, second norm, min(floor(512 v /
// max(norm2, 1e-12)), 255). k128: the row is 128 floats, a float4 a lane.
template <bool k128>
__global__ void __launch_bounds__(kQuantWarps * 32)
    quantize_rows_kernel(const __grid_constant__ QuantLaunch L) {
  const long long row = (long long)blockIdx.x * kQuantWarps + (threadIdx.x >> 5);
  if (row >= L.rows) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  int p = 0;
  while (p + 1 < L.n_part && row >= L.part[p + 1].row0) ++p;
  const float* src = L.part[p].raw + (row - L.part[p].row0) * L.D;
  uint8_t* dst = L.out + row * L.D;
  if (k128) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(src) + lane);
    const float a[4] = {v.x, v.y, v.z, v.w};
    float s = __fmul_rn(a[0], a[0]);
#pragma unroll
    for (int i = 1; i < 4; ++i) s = __fadd_rn(s, __fmul_rn(a[i], a[i]));
    const float clip = __fmul_rn(0.2f, __fsqrt_rn(warp_sum(s)));
    float c[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) c[i] = fminf(a[i], clip);
    s = __fmul_rn(c[0], c[0]);
#pragma unroll
    for (int i = 1; i < 4; ++i) s = __fadd_rn(s, __fmul_rn(c[i], c[i]));
    const float den = fmaxf(__fsqrt_rn(warp_sum(s)), 1e-12f);
    reinterpret_cast<uchar4*>(dst)[lane] =
        make_uchar4(level(c[0], den), level(c[1], den), level(c[2], den), level(c[3], den));
  } else {
    float s = 0.f;
    for (int i = lane; i < L.D; i += 32) s = __fadd_rn(s, __fmul_rn(src[i], src[i]));
    const float clip = __fmul_rn(0.2f, __fsqrt_rn(warp_sum(s)));
    s = 0.f;
    for (int i = lane; i < L.D; i += 32) {
      const float c = fminf(src[i], clip);
      s = __fadd_rn(s, __fmul_rn(c, c));
    }
    const float den = fmaxf(__fsqrt_rn(warp_sum(s)), 1e-12f);
    for (int i = lane; i < L.D; i += 32) dst[i] = level(fminf(src[i], clip), den);
  }
}

}  // namespace

// The keypoint compaction of every octave of one batch, one cluster of 8
// blocks a frame. `table` (host, int64; ops/kernels/describe.py
// keypoint_compact_octaves): n_oct, B, then per octave the pointers
// cand_valid, pass_border, scale, i, j, ofst_i, ofst_j, x, y, sigma, value
// ([B, width] each), width, budget, first output slot. `inv_delta` (host,
// float32): an octave's fp32(1 / delta). Outputs: valid [total], scale
// [total], reals [7][total], dropped [B].
extern "C" int keypoint_compact_octaves(const long long* table, const float* inv_delta,
                                        long long total, uint8_t* valid, int* scale,
                                        float* reals, int* dropped, cudaStream_t stream) {
  CompactLaunch L = {};
  L.n_oct = (int)table[0];
  L.B = (int)table[1];
  if (L.n_oct < 1 || L.n_oct > kMaxOctaves || L.B < 1) return (int)cudaErrorInvalidValue;
  long long out = 0;
  for (int k = 0; k < L.n_oct; ++k) {
    const long long* t = table + 2 + 14 * k;
    CompactOctave& o = L.oct[k];
    o.cand_valid = (const uint8_t*)t[0];
    o.pass_border = (const uint8_t*)t[1];
    o.scale = (const int*)t[2];
    o.i = (const int*)t[3];
    o.j = (const int*)t[4];
    o.ofst_i = (const float*)t[5];
    o.ofst_j = (const float*)t[6];
    o.x = (const float*)t[7];
    o.y = (const float*)t[8];
    o.sigma = (const float*)t[9];
    o.value = (const float*)t[10];
    o.out0 = t[13];
    o.inv_delta = inv_delta[k];
    if (t[11] < 1 || t[11] > 0x7fffffff || t[12] < 1 || t[12] > 0x7fffffff || o.out0 != out)
      return (int)cudaErrorInvalidValue;
    o.width = (int)t[11];
    o.budget = (int)t[12];
    out += (long long)L.B * o.budget;
  }
  if (out != total) return (int)cudaErrorInvalidValue;
  L.total = total;
  L.valid = valid;
  L.scale = scale;
  L.reals = reals;
  L.dropped = dropped;
  void* args[] = {&L};
  return (int)cudaLaunchKernel((const void*)keypoint_compact_kernel,
                               dim3((unsigned)L.B * kCluster), dim3(kThreads), args, 0, stream);
}

// Peaks and lanes of every octave of one batch, one cluster of 8 blocks a
// frame. `table` (host, int64; ops/kernels/describe.py lane_peaks_octaves):
// n_oct, B, rows, n_bins, max_ori, smooth_iters, the hist pointer ([B,
// rows, n_bins]), the keypoint compaction's dropped [B], then per octave
// the pointers kp_valid, scale, x_oct, y_oct, sigma_oct, x, y, sigma ([B,
// budget] each), first histogram row, budget, lanes, first output lane.
// `consts` (host, float32): 1/3, peak threshold, bin width, pi, 2 pi.
// Outputs: valid [total], ints [3][total], reals [7][total], dropped [B].
extern "C" int lane_peaks_octaves(const long long* table, const float* consts,
                                  long long total, uint8_t* valid, int* ints, float* reals,
                                  int* dropped, cudaStream_t stream) {
  LaneLaunch L = {};
  L.n_oct = (int)table[0];
  L.B = (int)table[1];
  L.rows = (int)table[2];
  L.n_bins = (int)table[3];
  L.max_ori = (int)table[4];
  L.smooth_iters = (int)table[5];
  L.hist = (const float*)table[6];
  L.dropped_in = (const int*)table[7];
  if (L.n_oct < 1 || L.n_oct > kMaxOctaves || L.B < 1 || L.n_bins < 3 ||
      L.n_bins > kMaxBins || L.max_ori < 1 || L.max_ori > kMaxOri || L.smooth_iters < 0)
    return (int)cudaErrorInvalidValue;
  long long out = 0;
  int row = 0, stash = 0;
  for (int k = 0; k < L.n_oct; ++k) {
    const long long* t = table + 8 + 12 * k;
    LaneOctave& o = L.oct[k];
    o.kp_valid = (const uint8_t*)t[0];
    o.scale = (const int*)t[1];
    o.x_oct = (const float*)t[2];
    o.y_oct = (const float*)t[3];
    o.sigma_oct = (const float*)t[4];
    o.x = (const float*)t[5];
    o.y = (const float*)t[6];
    o.sigma = (const float*)t[7];
    if (t[8] != row || t[9] < 1 || t[9] > 0x7fffffff || t[10] < 1 || t[10] > 0x7fffffff ||
        t[11] != out)
      return (int)cudaErrorInvalidValue;
    o.row0 = row;
    o.budget = (int)t[9];
    o.n_lanes = (int)t[10];
    o.out0 = out;
    row += o.budget;
    stash += (o.budget + kCluster - 1) / kCluster;
    out += (long long)L.B * o.n_lanes;
  }
  if (out != total || row != L.rows) return (int)cudaErrorInvalidValue;
  L.stash_n = stash;
  L.third = consts[0];
  L.peak_thr = consts[1];
  L.bin_w = consts[2];
  L.pi = consts[3];
  L.two_pi = consts[4];
  L.total = total;
  L.valid = valid;
  L.ints = ints;
  L.reals = reals;
  L.dropped = dropped;
  const bool fixed = L.n_bins == 36 && L.max_ori == 4 && ((uintptr_t)L.hist & 15) == 0;
  const void* kernel = fixed ? (const void*)lane_peaks_kernel<36, 4>
                             : (const void*)lane_peaks_kernel<0, 0>;
  const long long bytes = (long long)stash * (L.max_ori * (long long)sizeof(float) + 1);
  int err = device_facts::allow_shared(kernel, bytes);
  if (err != 0) return err;
  void* args[] = {&L};
  return (int)cudaLaunchKernel(kernel, dim3((unsigned)L.B * kCluster), dim3(kThreads), args,
                               (size_t)bytes, stream);
}

// Every octave's raw descriptor rows quantised in one launch, a warp a
// row. `table` (host, int64; ops/kernels/describe.py quantize_rows):
// n_part, then per part the raw pointer ([rows, D] float32), its rows, its
// first output row. Output: out [rows, D] uint8.
extern "C" int quantize_rows(const long long* table, int D, long long rows, uint8_t* out,
                             cudaStream_t stream) {
  QuantLaunch L = {};
  L.n_part = (int)table[0];
  L.D = D;
  L.rows = rows;
  L.out = out;
  if (L.n_part < 1 || L.n_part > kMaxOctaves || D < 1) return (int)cudaErrorInvalidValue;
  long long row = 0;
  bool aligned = ((uintptr_t)out & 3) == 0;
  for (int k = 0; k < L.n_part; ++k) {
    const long long* t = table + 1 + 3 * k;
    L.part[k].raw = (const float*)t[0];
    L.part[k].rows = t[1];
    L.part[k].row0 = t[2];
    if (t[1] < 0 || t[2] != row) return (int)cudaErrorInvalidValue;
    aligned = aligned && (t[0] & 15) == 0;
    row += t[1];
  }
  if (row != rows) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const void* kernel = D == 128 && aligned ? (const void*)quantize_rows_kernel<true>
                                           : (const void*)quantize_rows_kernel<false>;
  void* args[] = {&L};
  const long long blocks = (rows + kQuantWarps - 1) / kQuantWarps;
  return (int)cudaLaunchKernel(kernel, dim3((unsigned)blocks), dim3(kQuantWarps * 32), args, 0,
                               stream);
}
