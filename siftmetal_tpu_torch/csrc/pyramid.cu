// Banded separable Gaussian passes: the pyramid kernels of the port.
//
// Replaces the TPU kernels siftmetal_tpu/ops/pallas/pyramid.py
// _oneshot_kernel (through seed_octave_pallas and octave_oneshot_pallas)
// and siftmetal_tpu/ops/pallas/blur.py _blur_kernel (blur_pallas).
//
// Every 1-D pass of every slice is a banded matrix with the half-sample
// reflection folded in (and, for the seed, the 2x bilinear upsample
// composed in). The host (ops/kernels/pyramid.py tile_pass) hands it over
// in blocks of kBlock neighbouring outputs: for block g of slice s, a
// first input base[s][g], a reach span[s][g] and taps[s][g][m][p], the tap
// of output p on input base + m, zero outside that output's own taps. A
// thread then slides one window of inputs under its kBlock outputs, for
// two rows (X pass) or two columns (Y pass) at once: one float4 tap load
// and two input loads for 2 kBlock multiply-adds. Since
// the zero taps before an output's first tap leave its sum at +0 and those
// after its last add +-0, every output is the sum of its own taps in table
// order, tap 0 first: the per-output sum of the parent kernels, bit for
// bit.
//
// band_tiles (the seed, the one-shot octave and the one-slice blur): one
// block per kTileRows x kTileCols output tile of one frame. It copies the
// input window that the tile's taps reach over all slices (host table
// `win`) into shared memory once (cp.async for fp32), then for each slice
// runs the X pass from that window into a shared X buffer (the window's
// rows x the tile's columns) and the Y pass from the X buffer into
// gauss[s]. The tile's taps of a slice are staged in shared memory by
// cp.async behind the pass before them. The DoG comes from the previous
// slice, which each thread keeps in registers. Nothing goes to device
// memory but the outputs.
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
// planes of 8 x 960 x 1280 fp32, 432 MB; its 1.2 G taps are 0.04 ms at the
// fp32 rate). No tensor cores, no TF32.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_facts.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kTileRows = 64;  // output rows of a tile
constexpr int kTileCols = 64;  // output columns of a tile
constexpr int kBlock = 4;      // outputs of a tap block
constexpr int kThreads = 512;  // 16 warps: one Y-pass row block each
constexpr int kWarps = kThreads / 32;
constexpr int kXBlocks = kTileCols / kBlock;  // X-pass tap blocks of a tile
constexpr int kYBlocks = kTileRows / kBlock;  // Y-pass tap blocks of a tile
constexpr int kXPitch = kTileCols + 1;        // odd: X-pass stores down rows
static_assert(kYBlocks == kWarps, "one Y row block a warp");
static_assert(kTileCols == 64, "a lane owns columns lane and lane + 32");

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// One pass direction's tables in tap blocks (host: tile_pass).
struct Pass {
  const int* base;    // [S][nb]
  const int* span;    // [S][nb]
  const float* taps;  // [S][nb][kp][kBlock]
  const int* win;     // [S][n_tiles][2]: input rows/cols [lo, hi) of a tile
  int nb, kp, n_tiles;
};

// One call of the tile body: S slices of the input `in` [B, h_in, w_in]
// (frame stride in_frame) into gauss planes g_off + s and dog planes
// g_off + s - 1 (frame strides g_frame, d_frame). `prev` [B, h_out, w_out]
// (frame stride prev_frame), where given, is the slice before slice 0:
// the first DoG starts from it, and with copy_prev it is also written to
// gauss plane g_off - 1.
struct Band {
  const void* in;
  long long in_frame;
  int h_in, w_in, S, h_out, w_out;
  Pass x, y;
  const void* prev;
  long long prev_frame;
  int copy_prev;
  float* gauss;
  long long g_frame;
  int g_off;
  float* dog;
  long long d_frame;
  int rows_in, cols_in, rows_x;  // shared extents: window and X buffer rows
};

__host__ __device__ inline int in_pitch(int cols_in) { return cols_in | 1; }

// Floats of shared memory a block takes (taps first: float4-aligned).
__host__ __device__ inline long long band_smem_floats(const Band& a) {
  return (long long)kXBlocks * a.x.kp * kBlock +
         (long long)kYBlocks * a.y.kp * kBlock +
         (long long)a.rows_x * kXPitch +
         (long long)a.rows_in * in_pitch(a.cols_in);
}

template <class T>
__device__ __forceinline__ T load_cg(const T* p) {
  return __ldcg(p);
}

// Copies n float4 of taps from global to shared memory with cp.async (the
// caller commits); the tables are read-only, so the copy reads L2 only.
__device__ __forceinline__ void copy_taps(float* dst, const float* src, int n) {
  for (int k = threadIdx.x; k < n; k += kThreads)
    __pipeline_memcpy_async((float4*)dst + k, (const float4*)src + k, 16);
}

// The tile (tx, ty) of frame b. kAsync: fp32 input through cp.async (only
// where no other block of the launch writes it); otherwise every global
// read of the input and of `prev` goes to L2 (__ldcg), which the cascade
// needs after a grid.sync(). kRound: the input is read rounded to bf16.
//
// A slice's X taps are copied while the previous slice's Y pass runs and
// its Y taps while its own X pass runs (cp.async), so each slice waits at
// two barriers: before its X pass and before its Y pass.
template <class TIn, class TPrev, bool kRound, bool kMidBf16, bool kAsync>
__device__ void band_tile(const Band& a, int tx, int ty, int b, float* smem) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* xt = smem;                                  // [kXBlocks][kp][kBlock]
  float* yt = xt + kXBlocks * a.x.kp * kBlock;       // [kYBlocks][kp][kBlock]
  float* xb = yt + kYBlocks * a.y.kp * kBlock;       // [rows_x][kXPitch]
  float* win = xb + a.rows_x * kXPitch;              // [rows_in][ip]
  const int ip = in_pitch(a.cols_in);
  const int nx = kXBlocks * a.x.kp, ny = kYBlocks * a.y.kp;  // float4 a slice
  const float* xtaps = a.x.taps + (long long)tx * kXBlocks * a.x.kp * kBlock;
  const float* ytaps = a.y.taps + (long long)ty * kYBlocks * a.y.kp * kBlock;
  const long long x_slice = (long long)a.x.nb * a.x.kp * kBlock;
  const long long y_slice = (long long)a.y.nb * a.y.kp * kBlock;

  // The window every slice's taps reach.
  int r0 = 1 << 30, r1 = 0, c0 = 1 << 30, c1 = 0;
  for (int s = 0; s < a.S; ++s) {
    const int* wy = a.y.win + 2 * ((long long)s * a.y.n_tiles + ty);
    const int* wx = a.x.win + 2 * ((long long)s * a.x.n_tiles + tx);
    r0 = min(r0, wy[0]);
    r1 = max(r1, wy[1]);
    c0 = min(c0, wx[0]);
    c1 = max(c1, wx[1]);
  }
  // A block that walks several tiles (the cascade) is past the last X
  // pass of its previous tile here: the window and the X taps are free.
  copy_taps(xt, xtaps, nx);
  {
    const TIn* src = (const TIn*)a.in + (long long)b * a.in_frame;
    const int nc = c1 - c0, n = (r1 - r0) * nc;
    for (int p = tid; p < n; p += kThreads) {
      const int r = p / nc, c = p - r * nc;
      const TIn* g = src + (long long)(r0 + r) * a.w_in + c0 + c;
      float* d = win + r * ip + c;
      if constexpr (kAsync) {
        __pipeline_memcpy_async(d, g, sizeof(float));
      } else {
        const float v = to_f32(load_cg(g));
        *d = kRound ? round_bf16(v) : v;
      }
    }
  }
  __pipeline_commit();

  // Each thread's outputs: rows ty*T + warp*kBlock + p, columns
  // tx*64 + lane + 32 q.
  const long long plane = (long long)a.h_out * a.w_out;
  const int i0 = ty * kTileRows + warp * kBlock, j0 = tx * kTileCols + lane;
  float prev[2][kBlock];
#pragma unroll
  for (int p = 0; p < kBlock; ++p)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      prev[q][p] = 0.f;
      const int i = i0 + p, j = j0 + 32 * q;
      if (a.prev && i < a.h_out && j < a.w_out) {
        const long long o = (long long)i * a.w_out + j;
        prev[q][p] = to_f32(
            load_cg((const TPrev*)a.prev + (long long)b * a.prev_frame + o));
        if (a.copy_prev)
          a.gauss[(long long)b * a.g_frame + (a.g_off - 1) * plane + o] =
              prev[q][p];
      }
    }

  for (int s = 0; s < a.S; ++s) {
    // X taps (and on slice 0 the window) have landed for every thread, and
    // the previous slice's Y pass is done with xb and the Y taps.
    __pipeline_wait_prior(0);
    __syncthreads();
    copy_taps(yt, ytaps + s * y_slice, ny);
    __pipeline_commit();

    // X pass: the rows slice s's Y taps reach, every tap block of the
    // tile's columns. A thread takes rows `row` and `row + half` of one
    // block (neighbouring threads on neighbouring rows) and slides one
    // window of inputs under the block's outputs.
    const int* wy = a.y.win + 2 * ((long long)s * a.y.n_tiles + ty);
    const int xlo = wy[0], nr = wy[1] - wy[0], half = (nr + 1) >> 1;
    {
      const int* xbase = a.x.base + (long long)s * a.x.nb + tx * kXBlocks;
      const int* xspan = a.x.span + (long long)s * a.x.nb + tx * kXBlocks;
      for (int t = tid; t < half * kXBlocks; t += kThreads) {
        const int row = t % half, g = t / half;
        const int row2 = min(row + half, nr - 1);
        const float* src0 = win + (xlo - r0 + row) * ip + (xbase[g] - c0);
        const float* src1 = src0 + (row2 - row) * ip;
        const float4* tp = (const float4*)(xt + g * a.x.kp * kBlock);
        const int span = xspan[g];
        float acc0[kBlock] = {0.f, 0.f, 0.f, 0.f};
        float acc1[kBlock] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
        for (int m = 0; m < span; ++m) {
          const float4 t4 = tp[m];
          const float v0 = src0[m], v1 = src1[m];
          if constexpr (kMidBf16) {
            acc0[0] = __fadd_rn(acc0[0], __fmul_rn(t4.x, v0));
            acc0[1] = __fadd_rn(acc0[1], __fmul_rn(t4.y, v0));
            acc0[2] = __fadd_rn(acc0[2], __fmul_rn(t4.z, v0));
            acc0[3] = __fadd_rn(acc0[3], __fmul_rn(t4.w, v0));
            acc1[0] = __fadd_rn(acc1[0], __fmul_rn(t4.x, v1));
            acc1[1] = __fadd_rn(acc1[1], __fmul_rn(t4.y, v1));
            acc1[2] = __fadd_rn(acc1[2], __fmul_rn(t4.z, v1));
            acc1[3] = __fadd_rn(acc1[3], __fmul_rn(t4.w, v1));
          } else {
            acc0[0] = __fmaf_rn(t4.x, v0, acc0[0]);
            acc0[1] = __fmaf_rn(t4.y, v0, acc0[1]);
            acc0[2] = __fmaf_rn(t4.z, v0, acc0[2]);
            acc0[3] = __fmaf_rn(t4.w, v0, acc0[3]);
            acc1[0] = __fmaf_rn(t4.x, v1, acc1[0]);
            acc1[1] = __fmaf_rn(t4.y, v1, acc1[1]);
            acc1[2] = __fmaf_rn(t4.z, v1, acc1[2]);
            acc1[3] = __fmaf_rn(t4.w, v1, acc1[3]);
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
    }
    // xb is filled and the X taps are free; the Y taps have landed.
    __pipeline_wait_prior(0);
    __syncthreads();
    if (s + 1 < a.S) copy_taps(xt, xtaps + (s + 1) * x_slice, nx);
    __pipeline_commit();

    // Y pass: warp w takes the tile's rows [w kBlock, (w + 1) kBlock) at
    // columns lane and lane + 32, and writes the Gaussian and the DoG.
    {
      const int g = ty * kYBlocks + warp;
      const int base = a.y.base[(long long)s * a.y.nb + g];
      const int span = a.y.span[(long long)s * a.y.nb + g];
      const float* src = xb + (base - xlo) * kXPitch + lane;
      const float4* tp = (const float4*)(yt + warp * a.y.kp * kBlock);
      float acc[2][kBlock] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll 4
      for (int m = 0; m < span; ++m) {
        const float4 t4 = tp[m];
        const float v0 = src[m * kXPitch], v1 = src[m * kXPitch + 32];
        acc[0][0] = __fmaf_rn(t4.x, v0, acc[0][0]);
        acc[0][1] = __fmaf_rn(t4.y, v0, acc[0][1]);
        acc[0][2] = __fmaf_rn(t4.z, v0, acc[0][2]);
        acc[0][3] = __fmaf_rn(t4.w, v0, acc[0][3]);
        acc[1][0] = __fmaf_rn(t4.x, v1, acc[1][0]);
        acc[1][1] = __fmaf_rn(t4.y, v1, acc[1][1]);
        acc[1][2] = __fmaf_rn(t4.z, v1, acc[1][2]);
        acc[1][3] = __fmaf_rn(t4.w, v1, acc[1][3]);
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
          const int i = i0 + p, j = j0 + 32 * q;
          if (i < a.h_out && j < a.w_out) {
            const long long o = (long long)i * a.w_out + j;
            gp[o] = acc[q][p];
            if (dog) dp[o] = acc[q][p] - prev[q][p];
          }
          prev[q][p] = acc[q][p];
        }
    }
  }
}

template <class TIn, class TPrev, bool kMidBf16>
__global__ void __launch_bounds__(kThreads, 2) band_tiles_kernel(Band a) {
  extern __shared__ float4 smem4[];
  constexpr bool kAsync = sizeof(TIn) == sizeof(float);
  band_tile<TIn, TPrev, false, kMidBf16, kAsync>(a, blockIdx.x, blockIdx.y,
                                                 blockIdx.z, (float*)smem4);
}

// Stage s of the cascade: slice s (first, or gauss[:, s]) blurred by the
// tables' slice s into gauss[:, s + 1] and dog[:, s].
__device__ inline Band stage_of(const Band& a, int s, const void* first,
                                long long plane) {
  Band st = a;
  st.S = 1;
  st.x.base += (long long)s * a.x.nb;
  st.x.span += (long long)s * a.x.nb;
  st.x.taps += (long long)s * a.x.nb * a.x.kp * kBlock;
  st.x.win += 2LL * s * a.x.n_tiles;
  st.y.base += (long long)s * a.y.nb;
  st.y.span += (long long)s * a.y.nb;
  st.y.taps += (long long)s * a.y.nb * a.y.kp * kBlock;
  st.y.win += 2LL * s * a.y.n_tiles;
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
  const int tiles = a.x.n_tiles * a.y.n_tiles;
  for (int s = 0; s < a.S; ++s) {
    const Band st = stage_of(a, s, a.in, plane);
    for (int t = blockIdx.x; t < tiles * B; t += gridDim.x) {
      const int b = t / tiles, r = t - b * tiles;
      if (s == 0)
        band_tile<TFirst, TFirst, kBf16, kBf16, false>(st, r % a.x.n_tiles,
                                                       r / a.x.n_tiles, b, smem);
      else
        band_tile<float, float, kBf16, kBf16, false>(st, r % a.x.n_tiles,
                                                     r / a.x.n_tiles, b, smem);
    }
    if (s + 1 < a.S) grid.sync();
  }
}

// The host table of a launch (ops/kernels/pyramid.py launch_tables), one
// int64 each: per pass (x, then y) base, span, taps and win pointers, nb,
// kp, n_tiles; then rows_in, cols_in, rows_x and the tile geometry the
// tables were cut for (tile rows, tile columns, block), which must be the
// compiled one.
enum Table {
  kXPass = 0,
  kYPass = 7,
  kRowsIn = 14,
  kColsIn,
  kRowsX,
  kGeomRows,
  kGeomCols,
  kGeomBlock,
};

Pass pass_of(const long long* t) {
  return Pass{(const int*)t[0], (const int*)t[1], (const float*)t[2],
              (const int*)t[3], (int)t[4], (int)t[5], (int)t[6]};
}

// The Band of a launch over `in` [B, H_in, W_in] into `gauss`/`dog` of
// H_out x W_out planes; the caller sets prev and the frame strides.
int make_band(const long long* t, const void* in, int H_in, int W_in, int S,
              int H_out, int W_out, float* gauss, float* dog, Band* a) {
  if (t[kGeomRows] != kTileRows || t[kGeomCols] != kTileCols ||
      t[kGeomBlock] != kBlock || S < 1)
    return (int)cudaErrorInvalidValue;
  a->in = in;
  a->in_frame = (long long)H_in * W_in;
  a->h_in = H_in;
  a->w_in = W_in;
  a->S = S;
  a->h_out = H_out;
  a->w_out = W_out;
  a->x = pass_of(t + kXPass);
  a->y = pass_of(t + kYPass);
  a->prev = nullptr;
  a->prev_frame = 0;
  a->copy_prev = 0;
  a->gauss = gauss;
  a->g_frame = 0;
  a->g_off = 0;
  a->dog = dog;
  a->d_frame = 0;
  a->rows_in = (int)t[kRowsIn];
  a->cols_in = (int)t[kColsIn];
  a->rows_x = (int)t[kRowsX];
  return 0;
}

}  // namespace

// One launch of the tiled band kernel: in [B, H_in, W_in] (fp32, or bf16
// with in_bf16) -> gauss [B, S (+1 with `first`), H_out, W_out] and, when
// `dog` is given, the DoG of consecutive slices. `first` [B, H_out, W_out]
// (bf16 with first_bf16) is the one-shot octave's slice 0: copied to
// gauss[:, 0], and dog[:, 0] = gauss[:, 1] - first. mid_bf16 rounds the X
// pass to bf16 (the bf16 blur chain; bf16 input and no `first` only).
// `tables` is the launch's host table (see Table).
extern "C" int band_tiles(const long long* tables, const void* in, int in_bf16,
                          int B, int H_in, int W_in, int S, int H_out,
                          int W_out, const void* first, int first_bf16,
                          float* gauss, float* dog, int mid_bf16,
                          cudaStream_t stream) {
  Band a;
  int err = make_band(tables, in, H_in, W_in, S, H_out, W_out, gauss, dog, &a);
  if (err != 0) return err;
  if (B < 1 || B > 65535 || a.y.n_tiles > 65535)
    return (int)cudaErrorInvalidValue;
  const long long plane = (long long)H_out * W_out;
  const int g = S + (first ? 1 : 0);
  a.prev = first;
  a.prev_frame = plane;
  a.copy_prev = first != nullptr;
  a.g_off = first ? 1 : 0;
  a.g_frame = g * plane;
  a.d_frame = (g - 1) * plane;
  const long long bytes = band_smem_floats(a) * (long long)sizeof(float);
  const void* kernel;
  if (!in_bf16 && !first_bf16 && !mid_bf16)
    kernel = (const void*)band_tiles_kernel<float, float, false>;
  else if (in_bf16 && (!first || first_bf16) && !mid_bf16)
    kernel = (const void*)band_tiles_kernel<bf16, bf16, false>;
  else if (in_bf16 && !first && mid_bf16)
    kernel = (const void*)band_tiles_kernel<bf16, bf16, true>;
  else
    return (int)cudaErrorInvalidValue;
  if ((err = device_facts::allow_shared(kernel, bytes)) != 0) return err;
  void* args[] = {&a};
  return (int)cudaLaunchKernel(kernel, dim3(a.x.n_tiles, a.y.n_tiles, B),
                               dim3(kThreads), args, (size_t)bytes, stream);
}

// The incremental cascade of one octave in one cooperative launch: first
// [B, H, W] (fp32, or bf16 with first_bf16) -> gauss [B, n_stage + 1, H, W]
// (gauss[:, 0] = first) and dog [B, n_stage, H, W]; stage s applies slice
// s of the tables to gauss[:, s]. bf16_chain: every stage reads its input
// rounded to bf16 and rounds its X pass to bf16 (the fast preset's chain).
extern "C" int blur_cascade(const long long* tables, const void* first,
                            int first_bf16, int bf16_chain, int B, int H,
                            int W, int n_stage, float* gauss, float* dog,
                            cudaStream_t stream) {
  Band a;
  int err = make_band(tables, first, H, W, n_stage, H, W, gauss, dog, &a);
  if (err != 0) return err;
  if (B < 1 || (first_bf16 && !bf16_chain)) return (int)cudaErrorInvalidValue;
  const long long plane = (long long)H * W;
  a.g_frame = (n_stage + 1) * plane;
  a.d_frame = n_stage * plane;
  const long long bytes = band_smem_floats(a) * (long long)sizeof(float);
  const void* kernel =
      first_bf16 ? (const void*)blur_cascade_kernel<bf16, true>
      : bf16_chain ? (const void*)blur_cascade_kernel<float, true>
                   : (const void*)blur_cascade_kernel<float, false>;
  int grid = 0;
  if ((err = device_facts::resident_grid(kernel, kThreads, bytes, &grid)) != 0)
    return err;
  const long long tiles = (long long)a.x.n_tiles * a.y.n_tiles * B;
  if (tiles < grid) grid = (int)tiles;
  void* args[] = {&a, &B};
  return (int)cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kThreads),
                                          args, (size_t)bytes, stream);
}
