// Separable Gaussian passes: the pyramid kernels of the port.
//
// Replaces the TPU kernels siftmetal_tpu/ops/pallas/pyramid.py
// _oneshot_kernel (through seed_octave_pallas and octave_oneshot_pallas)
// and siftmetal_tpu/ops/pallas/blur.py _blur_kernel (blur_pallas).
//
// Both 1-D passes of slice s apply that slice's Gaussian taps t[0..2r]
// (host: ops/kernels/pyramid.py slice_taps) to the input read through the
// half-sample reflection: output i is sum_k t[k] x[reflect(i - r + k)],
// one chain from 0, tap 0 first, at every output alike, so a constant
// input gives a constant slice. (The TPU kernel folds the reflected taps
// into the edge outputs' matrix rows instead; on a flat image that leaves
// rounding noise which the extremum test reads as extrema.) The
// reflection lives in the window load: each padded window index reads its
// reflected source. For the seed at delta_min 0.5 the window holds the 2x
// bilinear upsample of the input, made as it is loaded (even samples
// copy, odd ones are neighbour midpoints 0.5 (a + b), the last sample
// repeated: ops/image.py upsample_bilinear_2x, rounded as there), and the
// passes blur that plane, as the plain version does.
//
// band_tiles (the seed, the one-shot octave and the one-slice blur): one
// block per kTile x kTile output tile of one frame. It copies every
// slice's taps and the tile's window (the tile and R, the largest radius,
// on every side) into shared memory once (cp.async for an fp32 input read
// as it is), then for each slice runs the X pass from the window into a
// shared X buffer (the tile's columns at the kTile + 2r rows its Y pass
// reads) and the Y pass from the X buffer into gauss[s]. A thread computes
// kBlock neighbouring outputs of two rows (X) or of two columns (Y) and
// slides a register window of kBlock inputs along the taps: a shared load
// a row or column and one broadcast tap for 2 kBlock multiply-adds. The
// DoG comes from the previous slice, which each thread keeps in
// registers. Nothing goes to device memory but the outputs.
//
// blur_cascade (the incremental cascade of one octave under 176 rows, in
// one launch): a cooperative grid of resident blocks walks the same tiles
// stage by stage, each stage being band_tiles' tile body for one slice
// read from the slice before it (gauss[:, s], L2-resident at these sizes)
// and a grid.sync() between stages. The same body on the same tables
// gives the per-stage route's values bit for bit; no shape gate.
//
// Arithmetic: fp32 outputs use contracted FMAs, tap 0 first. The bf16
// blur chain's X pass (mid_bf16) multiplies and adds with separate
// roundings (__fmul_rn/__fadd_rn) and rounds its fp32 sum once to bf16, as
// the plain PyTorch version does. bf16 inputs are read exactly; in the
// cascade's bf16 mode every stage reads its input rounded to bf16, and
// every Gaussian and DoG it writes is fp32.
//
// Bound on an H100: bytes (the seed of a 640x480 batch of 8 writes 11
// planes of 8 x 960 x 1280 fp32, 432 MB); the seed's radii (5 to 20 at the
// 2x resolution) make 2 x 150 multiply-adds a sample, 2.9 G in all, 0.09
// ms at the fp32 rate, plus the X pass's halo rows. No tensor cores, no
// TF32.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_facts.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 64;      // output rows and columns of a tile
constexpr int kBlock = 4;      // neighbouring outputs of a thread
constexpr int kThreads = 512;  // 16 warps: one Y-pass row block each
constexpr int kWarps = kThreads / 32;
constexpr int kXGroups = kTile / kBlock;  // X-pass column groups of a tile
constexpr int kXPitch = kTile + 1;        // odd: X-pass stores down rows
static_assert(kTile / kBlock == kWarps, "one Y row block a warp");
static_assert(kTile == 64, "a lane owns columns lane and lane + 32");

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The taps of a launch (host: slice_taps): slice s applies
// taps[s * K + k], k <= 2 radius[s].
struct Taps {
  const float* taps;  // [S][K]
  const int* radius;  // [S]
  int K;
};

// One call of the tile body: S slices of the input `in` [B, h_in, w_in]
// (frame stride in_frame; with `up`, of its 2x upsample) into gauss
// planes g_off + s and dog planes g_off + s - 1 (frame strides g_frame,
// d_frame). `prev` [B, h_out, w_out] (frame stride prev_frame), where
// given, is the slice before slice 0: the first DoG starts from it, and
// with copy_prev it is also written to gauss plane g_off - 1.
struct Band {
  const void* in;
  long long in_frame;
  int h_in, w_in, up, S, h_out, w_out;
  Taps t;
  const void* prev;
  long long prev_frame;
  int copy_prev;
  float* gauss;
  long long g_frame;
  int g_off;
  float* dog;
  long long d_frame;
};

// Side of the window of a tile whose largest radius is R.
__host__ __device__ inline int win_side(int R) { return kTile + 2 * R; }
// Floats of the taps in shared memory (a float4 multiple).
__host__ __device__ inline int tap_floats(int S, int K) { return (S * K + 3) & ~3; }

// Floats of shared memory a block takes: taps, X buffer, window.
__host__ __device__ inline long long band_smem_floats(int S, int K, int R) {
  const long long n = win_side(R);
  return tap_floats(S, K) + n * kXPitch + n * (n | 1);
}

// The period-2n half-sample reflection (ops/gaussian.py conv1d_sym): any
// padded index, a radius above n included.
__device__ __forceinline__ int reflect(int i, int n) {
  const int p = 2 * n;
  int m = i % p;
  if (m < 0) m += p;
  return m < n ? m : p - 1 - m;
}

// One input sample. kConst: nothing in the launch writes the input, so it
// goes through the read-only cache; otherwise to L2 (__ldcg), which the
// cascade needs after a grid.sync(). kRound: read rounded to bf16.
template <class T, bool kRound, bool kConst>
__device__ __forceinline__ float load_in(const T* p) {
  float v;
  if constexpr (kConst)
    v = to_f32(__ldg(p));
  else
    v = to_f32(__ldcg(p));
  return kRound ? round_bf16(v) : v;
}

// Column c of the 2x column upsample of row i of `src` [h, w].
template <class T, bool kRound, bool kConst>
__device__ __forceinline__ float up_col(const T* src, int w, int i, int c) {
  const T* row = src + (long long)i * w;
  const int j = c >> 1;
  const float v = load_in<T, kRound, kConst>(row + j);
  if (!(c & 1)) return v;
  return __fmul_rn(0.5f, __fadd_rn(v, load_in<T, kRound, kConst>(row + min(j + 1, w - 1))));
}

// Sample (r, c) of the 2x bilinear upsample of `src` [h, w]
// (ops/image.py upsample_bilinear_2x: columns first, then rows).
template <class T, bool kRound, bool kConst>
__device__ __forceinline__ float upsampled(const T* src, int h, int w, int r, int c) {
  const int i = r >> 1;
  const float v = up_col<T, kRound, kConst>(src, w, i, c);
  if (!(r & 1)) return v;
  return __fmul_rn(0.5f, __fadd_rn(v, up_col<T, kRound, kConst>(src, w, min(i + 1, h - 1), c)));
}

// acc + t v: contracted (fp32 outputs) or with separate roundings (the
// bf16 chain's X pass).
template <bool kSeparate>
__device__ __forceinline__ float mad(float t, float v, float acc) {
  return kSeparate ? __fadd_rn(acc, __fmul_rn(t, v)) : __fmaf_rn(t, v, acc);
}

// The tile (tx, ty) of frame b. kConst: see load_in; an fp32 input
// without `up` then comes in by cp.async. kRound: the input is read
// rounded to bf16. kMidBf16: the X pass is the bf16 chain's.
//
// Each slice waits at two barriers: after its X pass and after its Y
// pass (the X buffer is then free for the next slice, or the window and
// the taps for the block's next tile in the cascade).
template <class TIn, class TPrev, bool kRound, bool kMidBf16, bool kConst>
__device__ void band_tile(const Band& a, int tx, int ty, int b, float* smem) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int R = 0;
  for (int s = 0; s < a.S; ++s) R = max(R, __ldg(a.t.radius + s));
  const int n = win_side(R), ip = n | 1, K = a.t.K;
  float* taps = smem;                          // [S][K]
  float* xb = taps + tap_floats(a.S, K);       // [kTile + 2 r][kXPitch]
  float* win = xb + n * kXPitch;               // [n][ip]
  const int i0 = ty * kTile, j0 = tx * kTile;  // the tile's first output

  for (int k = tid; k < a.S * K; k += kThreads) taps[k] = __ldg(a.t.taps + k);
  {
    // Window sample (r, c) is padded output (i0 - R + r, j0 - R + c).
    const TIn* src = (const TIn*)a.in + (long long)b * a.in_frame;
    const int hp = a.up ? 2 * a.h_in : a.h_in, wp = a.up ? 2 * a.w_in : a.w_in;
    for (int p = tid; p < n * n; p += kThreads) {
      const int r = p / n, c = p - r * n;
      const int sr = reflect(i0 - R + r, hp), sc = reflect(j0 - R + c, wp);
      float* d = win + r * ip + c;
      if (a.up) {
        *d = upsampled<TIn, kRound, kConst>(src, a.h_in, a.w_in, sr, sc);
      } else {
        const TIn* g = src + (long long)sr * a.w_in + sc;
        if constexpr (kConst && !kRound && sizeof(TIn) == sizeof(float))
          __pipeline_memcpy_async(d, g, sizeof(float));
        else
          *d = load_in<TIn, kRound, kConst>(g);
      }
    }
  }
  __pipeline_commit();

  // Each thread's outputs: rows i0 + warp kBlock + p, columns
  // j0 + lane + 32 q.
  const long long plane = (long long)a.h_out * a.w_out;
  const int iw = i0 + warp * kBlock, jl = j0 + lane;
  float prev[2][kBlock];
#pragma unroll
  for (int p = 0; p < kBlock; ++p)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      prev[q][p] = 0.f;
      const int i = iw + p, j = jl + 32 * q;
      if (a.prev && i < a.h_out && j < a.w_out) {
        const long long o = (long long)i * a.w_out + j;
        prev[q][p] = to_f32(
            __ldcg((const TPrev*)a.prev + (long long)b * a.prev_frame + o));
        if (a.copy_prev)
          a.gauss[(long long)b * a.g_frame + (a.g_off - 1) * plane + o] =
              prev[q][p];
      }
    }
  __pipeline_wait_prior(0);
  __syncthreads();

  for (int s = 0; s < a.S; ++s) {
    const int r = __ldg(a.t.radius + s), nk = 2 * r + 1;
    const float* tp = taps + s * K;

    // X pass: window rows R - r + row, row < kTile + 2 r (the rows the Y
    // pass reads), at the tile's columns. A thread takes rows `row` and
    // `row + half` of one column group (neighbouring threads on
    // neighbouring rows); output p of the group reads window column
    // R - r + g kBlock + p + k at tap k.
    const int nr = kTile + 2 * r, half = (nr + 1) >> 1;
    for (int t = tid; t < half * kXGroups; t += kThreads) {
      const int row = t % half, g = t / half;
      const int row2 = min(row + half, nr - 1);
      const float* src0 = win + (R - r + row) * ip + (R - r + g * kBlock);
      const float* src1 = src0 + (row2 - row) * ip;
      float acc0[kBlock] = {0.f, 0.f, 0.f, 0.f};
      float acc1[kBlock] = {0.f, 0.f, 0.f, 0.f};
      float v0[kBlock], v1[kBlock];
#pragma unroll
      for (int p = 0; p + 1 < kBlock; ++p) {
        v0[p] = src0[p];
        v1[p] = src1[p];
      }
#pragma unroll 4
      for (int k = 0; k < nk; ++k) {
        v0[kBlock - 1] = src0[k + kBlock - 1];
        v1[kBlock - 1] = src1[k + kBlock - 1];
        const float tk = tp[k];
#pragma unroll
        for (int p = 0; p < kBlock; ++p) {
          acc0[p] = mad<kMidBf16>(tk, v0[p], acc0[p]);
          acc1[p] = mad<kMidBf16>(tk, v1[p], acc1[p]);
        }
#pragma unroll
        for (int p = 0; p + 1 < kBlock; ++p) {
          v0[p] = v0[p + 1];
          v1[p] = v1[p + 1];
        }
      }
      float* dst0 = xb + row * kXPitch + g * kBlock;
      float* dst1 = xb + (row + half) * kXPitch + g * kBlock;
#pragma unroll
      for (int p = 0; p < kBlock; ++p) {
        dst0[p] = kMidBf16 ? round_bf16(acc0[p]) : acc0[p];
        if (row + half < nr) dst1[p] = kMidBf16 ? round_bf16(acc1[p]) : acc1[p];
      }
    }
    __syncthreads();

    // Y pass: warp w takes the tile's rows [w kBlock, (w + 1) kBlock) at
    // columns lane and lane + 32; output row w kBlock + p reads X buffer
    // row w kBlock + p + k at tap k. Then the Gaussian and the DoG.
    {
      const float* src = xb + warp * kBlock * kXPitch + lane;
      float acc[2][kBlock] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      float v[2][kBlock];
#pragma unroll
      for (int p = 0; p + 1 < kBlock; ++p) {
        v[0][p] = src[p * kXPitch];
        v[1][p] = src[p * kXPitch + 32];
      }
#pragma unroll 4
      for (int k = 0; k < nk; ++k) {
        v[0][kBlock - 1] = src[(k + kBlock - 1) * kXPitch];
        v[1][kBlock - 1] = src[(k + kBlock - 1) * kXPitch + 32];
        const float tk = tp[k];
#pragma unroll
        for (int p = 0; p < kBlock; ++p) {
          acc[0][p] = __fmaf_rn(tk, v[0][p], acc[0][p]);
          acc[1][p] = __fmaf_rn(tk, v[1][p], acc[1][p]);
        }
#pragma unroll
        for (int p = 0; p + 1 < kBlock; ++p) {
          v[0][p] = v[0][p + 1];
          v[1][p] = v[1][p + 1];
        }
      }
      const bool dog = a.dog && (s > 0 || a.prev);
      float* gp = a.gauss + (long long)b * a.g_frame + (long long)(a.g_off + s) * plane;
      float* dp = dog ? a.dog + (long long)b * a.d_frame +
                            (long long)(a.g_off + s - 1) * plane
                      : nullptr;
#pragma unroll
      for (int p = 0; p < kBlock; ++p)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int i = iw + p, j = jl + 32 * q;
          if (i < a.h_out && j < a.w_out) {
            const long long o = (long long)i * a.w_out + j;
            gp[o] = acc[q][p];
            if (dog) dp[o] = acc[q][p] - prev[q][p];
          }
          prev[q][p] = acc[q][p];
        }
    }
    __syncthreads();
  }
}

template <class TIn, class TPrev, bool kMidBf16>
__global__ void __launch_bounds__(kThreads, 2) band_tiles_kernel(Band a) {
  extern __shared__ float4 smem4[];
  band_tile<TIn, TPrev, false, kMidBf16, true>(a, blockIdx.x, blockIdx.y,
                                               blockIdx.z, (float*)smem4);
}

// Stage s of the cascade: slice s (first, or gauss[:, s]) blurred by the
// taps of slice s into gauss[:, s + 1] and dog[:, s].
__device__ inline Band stage_of(const Band& a, int s, const void* first,
                                long long plane) {
  Band st = a;
  st.S = 1;
  st.t.taps += (long long)s * a.t.K;
  st.t.radius += s;
  st.in = s == 0 ? first : (const void*)(a.gauss + s * plane);
  st.in_frame = s == 0 ? plane : a.g_frame;
  st.prev = st.in;
  st.prev_frame = st.in_frame;
  st.copy_prev = s == 0;
  st.g_off = s + 1;
  return st;
}

// a.S stages over B frames; a.in is the octave's first slice [B, H, W].
template <class TFirst, bool kBf16>
__global__ void __launch_bounds__(kThreads) blur_cascade_kernel(Band a, int B) {
  extern __shared__ float4 smem4[];
  float* smem = (float*)smem4;
  cg::grid_group grid = cg::this_grid();
  const long long plane = (long long)a.h_out * a.w_out;
  const int nx = (a.w_out + kTile - 1) / kTile, ny = (a.h_out + kTile - 1) / kTile;
  const int tiles = nx * ny;
  for (int s = 0; s < a.S; ++s) {
    const Band st = stage_of(a, s, a.in, plane);
    for (int t = blockIdx.x; t < tiles * B; t += gridDim.x) {
      const int b = t / tiles, r = t - b * tiles;
      if (s == 0)
        band_tile<TFirst, TFirst, kBf16, kBf16, false>(st, r % nx, r / nx, b, smem);
      else
        band_tile<float, float, kBf16, kBf16, false>(st, r % nx, r / nx, b, smem);
    }
    if (s + 1 < a.S) grid.sync();
  }
}

// The host table of a launch (ops/kernels/pyramid.py launch_table), one
// int64 each: the taps and radius pointers, the slice count S, the taps a
// slice K and the largest radius R.
enum Table { kTapsPtr = 0, kRadiusPtr, kSlices, kTapsPerSlice, kMaxRadius };

// The Band of a launch of S slices over `in` [B, H_in, W_in] (with `up`,
// its 2x upsample) into `gauss`/`dog`; the caller sets prev and the frame
// strides. Returns the shared-memory bytes a block takes in *bytes.
int make_band(const long long* t, const void* in, int H_in, int W_in, int S,
              int up, float* gauss, float* dog, Band* a, long long* bytes) {
  if (S < 1 || t[kSlices] != S || t[kTapsPerSlice] < 1 || t[kMaxRadius] < 0 ||
      t[kTapsPerSlice] < 2 * t[kMaxRadius] + 1 || H_in < 1 || W_in < 1)
    return (int)cudaErrorInvalidValue;
  a->in = in;
  a->in_frame = (long long)H_in * W_in;
  a->h_in = H_in;
  a->w_in = W_in;
  a->up = up != 0;
  a->S = S;
  a->h_out = up ? 2 * H_in : H_in;
  a->w_out = up ? 2 * W_in : W_in;
  a->t = Taps{(const float*)t[kTapsPtr], (const int*)t[kRadiusPtr],
              (int)t[kTapsPerSlice]};
  a->prev = nullptr;
  a->prev_frame = 0;
  a->copy_prev = 0;
  a->gauss = gauss;
  a->g_frame = 0;
  a->g_off = 0;
  a->dog = dog;
  a->d_frame = 0;
  *bytes = band_smem_floats(S, (int)t[kTapsPerSlice], (int)t[kMaxRadius]) *
           (long long)sizeof(float);
  return 0;
}

}  // namespace

// One launch of the tiled band kernel: in [B, H_in, W_in] (fp32, or bf16
// with in_bf16) -> gauss [B, S (+1 with `first`), H_out, W_out] and, when
// `dog` is given, the DoG of consecutive slices; H_out, W_out are H_in,
// W_in, or twice them with `up` (the passes then blur the input's 2x
// bilinear upsample). `first` [B, H_out, W_out] (bf16 with first_bf16) is
// the one-shot octave's slice 0: copied to gauss[:, 0], and dog[:, 0] =
// gauss[:, 1] - first. mid_bf16 rounds the X pass to bf16 (the bf16 blur
// chain; bf16 input, no `first` and no `up` only). `table` is the launch's
// host table (see Table).
extern "C" int band_tiles(const long long* table, const void* in, int in_bf16,
                          int B, int H_in, int W_in, int S, int up,
                          const void* first, int first_bf16, float* gauss,
                          float* dog, int mid_bf16, cudaStream_t stream) {
  Band a;
  long long bytes = 0;
  int err = make_band(table, in, H_in, W_in, S, up, gauss, dog, &a, &bytes);
  if (err != 0) return err;
  const int nx = (a.w_out + kTile - 1) / kTile, ny = (a.h_out + kTile - 1) / kTile;
  if (B < 1 || B > 65535 || ny > 65535) return (int)cudaErrorInvalidValue;
  const long long plane = (long long)a.h_out * a.w_out;
  const int g = S + (first ? 1 : 0);
  a.prev = first;
  a.prev_frame = plane;
  a.copy_prev = first != nullptr;
  a.g_off = first ? 1 : 0;
  a.g_frame = g * plane;
  a.d_frame = (g - 1) * plane;
  const void* kernel;
  if (!in_bf16 && !first_bf16 && !mid_bf16)
    kernel = (const void*)band_tiles_kernel<float, float, false>;
  else if (in_bf16 && (!first || first_bf16) && !mid_bf16)
    kernel = (const void*)band_tiles_kernel<bf16, bf16, false>;
  else if (in_bf16 && !first && !up && mid_bf16)
    kernel = (const void*)band_tiles_kernel<bf16, bf16, true>;
  else
    return (int)cudaErrorInvalidValue;
  if ((err = device_facts::allow_shared(kernel, bytes)) != 0) return err;
  void* args[] = {&a};
  return (int)cudaLaunchKernel(kernel, dim3(nx, ny, B), dim3(kThreads), args,
                               (size_t)bytes, stream);
}

// The incremental cascade of one octave in one cooperative launch: first
// [B, H, W] (fp32, or bf16 with first_bf16) -> gauss [B, n_stage + 1, H, W]
// (gauss[:, 0] = first) and dog [B, n_stage, H, W]; stage s applies slice
// s of the table to gauss[:, s]. bf16_chain: every stage reads its input
// rounded to bf16 and rounds its X pass to bf16 (the fast preset's chain).
extern "C" int blur_cascade(const long long* table, const void* first,
                            int first_bf16, int bf16_chain, int B, int H,
                            int W, int n_stage, float* gauss, float* dog,
                            cudaStream_t stream) {
  Band a;
  long long bytes = 0;
  int err = make_band(table, first, H, W, n_stage, 0, gauss, dog, &a, &bytes);
  if (err != 0) return err;
  if (B < 1 || (first_bf16 && !bf16_chain)) return (int)cudaErrorInvalidValue;
  const long long plane = (long long)H * W;
  a.g_frame = (n_stage + 1) * plane;
  a.d_frame = n_stage * plane;
  const void* kernel =
      first_bf16 ? (const void*)blur_cascade_kernel<bf16, true>
      : bf16_chain ? (const void*)blur_cascade_kernel<float, true>
                   : (const void*)blur_cascade_kernel<float, false>;
  int grid = 0;
  if ((err = device_facts::resident_grid(kernel, kThreads, bytes, &grid)) != 0)
    return err;
  const long long tiles = (long long)((W + kTile - 1) / kTile) *
                          ((H + kTile - 1) / kTile) * B;
  if (tiles < grid) grid = (int)tiles;
  void* args[] = {&a, &B};
  return (int)cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kThreads),
                                          args, (size_t)bytes, stream);
}
