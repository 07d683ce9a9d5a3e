// Fused DoG extrema detection with deterministic per-row slot compaction,
// every octave of a batch in one launch.
//
// Replaces the TPU kernel siftmetal_tpu/ops/pallas/detect.py
// _detect_kernel (through detect_candidates_pallas, both emit_fields
// forms). What it computes is the same: for each (frame, scale, row) of an
// octave's [B, S, H, W] DoG stack, the columns of the first `slots` soft
// extrema (a strict extremum over the 26 neighbours with |D| > soft_thr),
// and at each of them the Taylor step (ofst_i, ofst_j, ofst_s, value) with
// the one-reciprocal formulas and the IPOL edge test |tr^2/det| <= bound.
// Per (octave, frame) it counts raw extrema, soft extrema and soft extrema
// lost to full rows. Column and edge flag are separate outputs (the TPU
// packed them in one word). The lean form (emit_fields=False) leaves out
// the Taylor step and the edge flag; both forms are one template, so the
// outputs they share are equal bit for bit.
//
// Design. A task is one (octave, frame, band of R output rows) with all
// its scales; the host lays the tasks out largest octave first
// (ops/kernels/detect.py launch_plan), and a resident grid (two blocks of
// 256 threads an SM) takes them from a ticket counter, so the small
// octaves fill the SMs that the large ones leave idle. A block walks its
// band from left to right in chunks of C output columns (C = 256 / (R / 8):
// a thread owns one column and 8 output rows of the chunk). Each chunk's S
// planes x (R + 2) rows x (C + 4) columns go to shared memory once, by
// 16-byte cp.async where the rows allow it (4-byte copies otherwise),
// double-buffered: chunk k+1's copy runs under chunk k's test. So each DoG
// sample crosses from device memory once, plus the band's two halo rows.
//
// The test is separable: per plane and row a thread forms the max/min of
// its column's left and right neighbours and, with the centre, of the
// three; down its rows it keeps them in registers, so a plane's 3x3 max
// and min are formed once and serve the (up to) three centre scales that
// read that plane. The centre plane keeps its own 8-neighbour max/min
// (the centre left out), so the test stays strict. fmaxf/fminf ignore
// NaN, as the one-thread fold from -inf/+inf did; where every neighbour
// is NaN the test is written so as to give that fold's answer.
//
// Ranks are the first `slots` soft extrema of each (frame, scale, row) in
// column order: each warp's soft ballot of a (scale, row) goes to shared
// memory; after the next chunk's barrier, thread t walks band row t's
// ballots in column order and keeps the row's running count, so ranks and
// kept columns need one barrier a chunk and no atomic append. The Taylor
// step and the edge test run at the kept slots once the band is done, all
// threads at once, reading the DoG from device memory with the expressions
// of the one-thread kernel; the file is built with -fmad=false, so the
// fields equal the plain PyTorch version bit for bit. Every slot is
// written, the zeros past a row's count included. The per-(octave, frame)
// counters take one integer atomicAdd a task.
//
// Bound on an H100: bytes, one read of each octave's DoG stack plus the
// band halo ((R + 2) / R of the rows, from L2 where the neighbouring band
// ran before): 8 x 5 x 960 x 1280 fp32 = 197 MB at octave 0 of a 640x480
// batch of 8 (0.060 ms at 3.35 TB/s with the slots written), 262 MB over
// its seven octaves (0.080 ms). Measured (chip_smoke.py, H100 SXM at 700
// W): 0.114 ms at octave 0 (52% of the bound), 0.140 ms for the seven
// octaves in one launch (57%). The test alone (no copies) takes ~0.080 ms
// and the copies alone ~0.080 ms there: the two overlap only in part.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "device_facts.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGroupRows = 8;  // output rows a thread walks in a chunk
constexpr int kMaxOctaves = 16;

// Shared-memory floats of a block: two chunk buffers, the soft ballots of
// two chunks, the running count of each (scale, row) and three counters.
__host__ __device__ constexpr int cols_of(int R) {
  return kThreads / (R / kGroupRows);
}
__host__ __device__ constexpr int pitch_of(int R) { return cols_of(R) + 4; }
__host__ __device__ constexpr long long smem_floats(int S, int R) {
  return 2LL * S * (R + 2) * pitch_of(R) + 2 * (S - 2) * R * (cols_of(R) / 32) +
         (S - 2) * R + 4;
}

struct Octave {
  const float* dog;  // [B, S, H, W]
  long long out0;    // first output element of the octave
  int H, W;
  int bands;         // ceil((H - 2) / R)
  int task0;         // first task of the octave
  int vec;           // W % 4 == 0 and dog 16-byte aligned: 16-byte copies
};

struct Launch {
  Octave oct[kMaxOctaves];
  int n_oct, B, slots;
  float soft_thr, edge_bound;
  int* cand_col;
  uint8_t* slot_ok;
  float* c_oi;
  float* c_oj;
  float* c_os;
  float* c_val;
  uint8_t* c_edge;
  int* counts;  // [3][n_oct][B]: raw, soft, row-dropped
  int* ticket;  // the next task (zeroed before the launch)
  int tasks;    // (octave, frame, band) tasks: sum of B x bands
};

// Chunk (r0, c0) of frame b into `buf` ([S][R + 2][pitch]); rows past H
// and columns past W are left as they are (no output reads them). Warps
// take rows, lanes the 16-byte (or, off 16-byte alignment, 4-byte) copies
// of a row; one commit group a chunk.
template <int S, int R>
__device__ __forceinline__ void copy_chunk(const Octave& o, int b, int r0,
                                           int c0, float* buf) {
  constexpr int kPitch = pitch_of(R), kPlane = (R + 2) * kPitch;
  constexpr int kWarps = kThreads / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long plane = (long long)o.H * o.W;
  const float* src = o.dog + (long long)b * S * plane + (long long)r0 * o.W + c0;
  const int rows = min(R + 2, o.H - r0);
  if (o.vec) {
    const int n4 = min(kPitch / 4, (o.W - c0) / 4);
#pragma unroll
    for (int p = 0; p < S; ++p)
      for (int y = warp; y < rows; y += kWarps)
        for (int m = lane; m < n4; m += 32)
          __pipeline_memcpy_async(buf + p * kPlane + y * kPitch + 4 * m,
                                  src + p * plane + (long long)y * o.W + 4 * m,
                                  16);
  } else {
    const int n1 = min(cols_of(R) + 2, o.W - c0);
#pragma unroll
    for (int p = 0; p < S; ++p)
      for (int y = warp; y < rows; y += kWarps)
        for (int m = lane; m < n1; m += 32)
          __pipeline_memcpy_async(buf + p * kPlane + y * kPitch + m,
                                  src + p * plane + (long long)y * o.W + m, 4);
  }
  __pipeline_commit();
}

// The kept slots of band row t (scale t / R, band row t % R) of the chunk
// at column c0, from its soft ballots `mk` in column order: rank = the
// row's running count `n`, which counts every soft extremum.
template <int S, int R>
__device__ __forceinline__ int emit_row(const Launch& L, const Octave& o,
                                        int b, int r0, int t, int c0,
                                        const unsigned* mk, int n) {
  constexpr int kWarpsRow = cols_of(R) / 32;
  const int s = t / R, r = r0 + t - s * R;
  const int rows = o.H - 2, slots = L.slots;
  for (int w = 0; w < kWarpsRow; ++w) {
    unsigned msk = mk[t * kWarpsRow + w];
    while (msk != 0u && n < slots) {
      const long long oo =
          o.out0 + (((long long)b * (S - 2) + s) * rows + r) * slots + n;
      L.cand_col[oo] = c0 + 32 * w + __ffs(msk) - 1;
      L.slot_ok[oo] = 1;
      msk &= msk - 1u;
      ++n;
    }
    n += __popc(msk);  // the row's soft extrema past its slots
  }
  return n;
}

// The Taylor step and the edge flag of the kept slot `oo` at (scale s, row
// r, column c) of frame b, read from device memory, with the one-thread
// kernel's expressions.
template <int S>
__device__ __forceinline__ void taylor_slot(const Launch& L, const Octave& o,
                                            int b, int s, int r, int c,
                                            long long oo) {
  const long long plane = (long long)o.H * o.W;
  const int W = o.W;
  const float* q =
      o.dog + ((long long)b * S + (s + 1)) * plane + (long long)(r + 1) * W + c + 1;
#define NB(ds, di, dj) q[(ds) * plane + (di) * W + (dj)]
  const float cc0 = q[0];
  const float gi = 0.5f * (NB(0, 1, 0) - NB(0, -1, 0));
  const float gj = 0.5f * (NB(0, 0, 1) - NB(0, 0, -1));
  const float gs = 0.5f * (NB(1, 0, 0) - NB(-1, 0, 0));
  const float hii = NB(0, 1, 0) + NB(0, -1, 0) - 2.0f * cc0;
  const float hjj = NB(0, 0, 1) + NB(0, 0, -1) - 2.0f * cc0;
  const float hss = NB(1, 0, 0) + NB(-1, 0, 0) - 2.0f * cc0;
  const float hij = 0.25f * (NB(0, 1, 1) - NB(0, 1, -1) -
                             NB(0, -1, 1) + NB(0, -1, -1));
  const float his = 0.25f * (NB(1, 1, 0) - NB(1, -1, 0) -
                             NB(-1, 1, 0) + NB(-1, -1, 0));
  const float hjs = 0.25f * (NB(1, 0, 1) - NB(1, 0, -1) -
                             NB(-1, 0, 1) + NB(-1, 0, -1));
#undef NB
  const float det = hii * (hjj * hss - hjs * hjs) -
                    hij * (hij * hss - hjs * his) +
                    his * (hij * hjs - hjj * his);
  const float inv = 1.0f / det;
  const float aa = (hjj * hss - hjs * hjs) * inv;
  const float ab = (his * hjs - hij * hss) * inv;
  const float ac = (hij * hjs - his * hjj) * inv;
  const float bb = (hii * hss - his * his) * inv;
  const float bc = (his * hij - hii * hjs) * inv;
  const float cc = (hii * hjj - hij * hij) * inv;
  const float oi = -(aa * gi + ab * gj + ac * gs);
  const float oj = -(ab * gi + bb * gj + bc * gs);
  const float os = -(ac * gi + bc * gj + cc * gs);
  const float val = cc0 + 0.5f * (gi * oi + gj * oj + gs * os);
  const float tr = hii + hjj;
  const float er = tr * tr / (hii * hjj - hij * hij);
  L.c_oi[oo] = oi;
  L.c_oj[oo] = oj;
  L.c_os[oo] = os;
  L.c_val[oo] = val;
  L.c_edge[oo] = fabsf(er) <= L.edge_bound ? 1 : 0;
}

// Task `task` of the launch: frame b's band of R rows of one octave, all
// its scales, chunk by chunk.
template <bool kFields, int S, int R>
__device__ __forceinline__ void detect_band(const Launch& L, int task,
                                            float* smem) {
  constexpr int kScales = S - 2;
  constexpr int kCols = cols_of(R), kPitch = pitch_of(R);
  constexpr int kPlane = (R + 2) * kPitch, kBuf = S * kPlane;
  constexpr int kWarpsRow = kCols / 32;
  constexpr int kMasks = kScales * R * kWarpsRow;
  unsigned* masks = (unsigned*)(smem + 2 * kBuf);  // [2][kScales][R][kWarpsRow]
  int* run = (int*)(masks + 2 * kMasks);           // [kScales][R]
  int* red = run + kScales * R;                    // raw, soft, dropped

  int oct = 0;
  while (oct + 1 < L.n_oct && task >= L.oct[oct + 1].task0) ++oct;
  const Octave o = L.oct[oct];
  const int local = task - o.task0;
  const int b = local / o.bands;
  const int r0 = (local - b * o.bands) * R;
  const int rows = o.H - 2, cols = o.W - 2;
  const int n_chunks = (cols + kCols - 1) / kCols;
  const int slots = L.slots;

  const int tid = threadIdx.x, lane = tid & 31;
  const int g = tid / kCols, x = tid - g * kCols;
  const int wc = x >> 5;
  const float soft_thr = L.soft_thr;

  for (int t = tid; t < kScales * R; t += kThreads) run[t] = 0;
  if (tid < 3) red[tid] = 0;
  int raw_cnt = 0;  // this thread's raw extrema

  // One barrier a chunk: after it, chunk k is in shared memory, and every
  // thread is past chunk k-1's test, so its buffer takes chunk k+1 and
  // its ballots are complete. Band row t's ranks are kept by thread t (run[t]).
  copy_chunk<S, R>(o, b, r0, 0, smem);
  for (int k = 0; k < n_chunks; ++k) {
    const int c0 = k * kCols;
    __pipeline_wait_prior(0);
    __syncthreads();
    if (k + 1 < n_chunks)
      copy_chunk<S, R>(o, b, r0, c0 + kCols, smem + ((k + 1) & 1) * kBuf);
    if (k > 0)
      for (int t = tid; t < kScales * R; t += kThreads)
        if (r0 + t % R < rows)
          run[t] = emit_row<S, R>(L, o, b, r0, t, c0 - kCols,
                                           masks + ((k - 1) & 1) * kMasks, run[t]);
    const float* cur = smem + (k & 1) * kBuf;
    unsigned* mk = masks + (k & 1) * kMasks;

    // Phase 1: the extremum test of this thread's column over its rows.
    {
      const bool col_ok = c0 + x < cols;
      const float* at = cur + g * kGroupRows * kPitch + x;
      // Rows y-2 (P) and y-1 (Q) of the walk: 3-wide max/min (Pm, Pn, Qm,
      // Qn), Q's left/right max/min (Qx, Qy) and Q's centre value (Qv).
      float Pm[S], Pn[S], Qm[S], Qn[S], Qx[S], Qy[S], Qv[S];
#pragma unroll
      for (int y = 0; y < kGroupRows + 2; ++y) {
        float m[S], n[S], xm[S], xn[S], v[S];
#pragma unroll
        for (int p = 0; p < S; ++p) {
          const float* q = at + p * kPlane + y * kPitch;
          const float a = q[0], c = q[1], d = q[2];
          xm[p] = fmaxf(a, d);
          xn[p] = fminf(a, d);
          m[p] = fmaxf(xm[p], c);
          n[p] = fminf(xn[p], c);
          v[p] = c;
        }
        if (y >= 2) {
          const int rr = g * kGroupRows + y - 2;  // band row of the test
          const bool ok = col_ok && r0 + rr < rows;
          // Per plane the 3x3 max/min around Q's centre (fm, fn); for a
          // centre plane first without the centre (c8m, c8n).
          float fm[S], fn[S], c8m[S], c8n[S];
#pragma unroll
          for (int p = 0; p < S; ++p) {
            if (p == 0 || p == S - 1) {
              fm[p] = fmaxf(fmaxf(Pm[p], Qm[p]), m[p]);
              fn[p] = fminf(fminf(Pn[p], Qn[p]), n[p]);
            } else {
              c8m[p] = fmaxf(fmaxf(Pm[p], m[p]), Qx[p]);
              c8n[p] = fminf(fminf(Pn[p], n[p]), Qy[p]);
              fm[p] = fmaxf(c8m[p], Qv[p]);
              fn[p] = fminf(c8n[p], Qv[p]);
            }
          }
#pragma unroll
          for (int s = 0; s < kScales; ++s) {
            const float hi = fmaxf(fmaxf(fm[s], fm[s + 2]), c8m[s + 1]);
            const float lo = fminf(fminf(fn[s], fn[s + 2]), c8n[s + 1]);
            const float c = Qv[s + 1];
            // hi and lo are NaN only when all 26 neighbours are; the fold
            // from -inf / +inf then gave a raw extremum at any c but NaN.
            // Otherwise !(c <= hi) is c > hi or c NaN, and c == c drops NaN.
            const bool raw = ok && (!(c <= hi) || !(c >= lo)) && c == c;
            const bool soft = raw && fabsf(c) > soft_thr;
            raw_cnt += raw;
            const unsigned msoft = __ballot_sync(0xffffffffu, soft);
            mk[(s * R + rr) * kWarpsRow + wc] = msoft;  // same word, every lane
          }
        }
#pragma unroll
        for (int p = 0; p < S; ++p) {
          Pm[p] = Qm[p];
          Pn[p] = Qn[p];
          Qm[p] = m[p];
          Qn[p] = n[p];
          Qx[p] = xm[p];
          Qy[p] = xn[p];
          Qv[p] = v[p];
        }
      }
    }
  }
  __syncthreads();  // the last chunk's ballots are in
  for (int t = tid; t < kScales * R; t += kThreads)
    if (r0 + t % R < rows)
      run[t] = emit_row<S, R>(L, o, b, r0, t, (n_chunks - 1) * kCols,
                                       masks + ((n_chunks - 1) & 1) * kMasks, run[t]);
  __syncthreads();  // every running count and kept column is written

  // The Taylor step at the kept slots, the zeros past each row's count;
  // the block's counters.
  for (int e = tid; e < kScales * R * slots; e += kThreads) {
    const int t = e / slots, kk = e - t * slots;
    const int s = t / R, rr = t - s * R, r = r0 + rr;
    if (r >= rows) continue;
    const long long oo =
        o.out0 + (((long long)b * kScales + s) * rows + r) * slots + kk;
    if (kk < run[t]) {
      if (kFields) taylor_slot<S>(L, o, b, s, r, L.cand_col[oo], oo);
      continue;
    }
    L.cand_col[oo] = 0;
    L.slot_ok[oo] = 0;
    if (kFields) {
      L.c_oi[oo] = 0.f;
      L.c_oj[oo] = 0.f;
      L.c_os[oo] = 0.f;
      L.c_val[oo] = 0.f;
      L.c_edge[oo] = 0;
    }
  }
  int soft = 0, drop = 0;
  for (int t = tid; t < kScales * R; t += kThreads) {
    if (r0 + t % R >= rows) continue;
    soft += run[t];
    drop += max(run[t] - slots, 0);
  }
  raw_cnt = __reduce_add_sync(0xffffffffu, raw_cnt);
  soft = __reduce_add_sync(0xffffffffu, soft);
  drop = __reduce_add_sync(0xffffffffu, drop);
  if (lane == 0) {
    atomicAdd(red + 0, raw_cnt);
    atomicAdd(red + 1, soft);
    atomicAdd(red + 2, drop);
  }
  __syncthreads();
  if (tid < 3 && red[tid] != 0)
    atomicAdd(L.counts + ((long long)tid * L.n_oct + oct) * L.B + b, red[tid]);
}

// A resident grid takes the (octave, frame, band) tasks in launch order,
// largest octave first, from a ticket counter, so the small octaves fill
// the SMs that the large ones leave idle at the end.
template <bool kFields, int S, int R>
__global__ void __launch_bounds__(kThreads, S <= 6 ? 2 : 1)
    detect_kernel(const __grid_constant__ Launch L) {
  extern __shared__ __align__(16) float smem[];
  int* next = (int*)smem + smem_floats(S, R) - 1;  // the ticket's last draw
  for (;;) {
    if (threadIdx.x == 0) *next = atomicAdd(L.ticket, 1);
    __syncthreads();
    const int task = *next;
    if (task >= L.tasks) break;
    detect_band<kFields, S, R>(L, task, smem);
  }
}

// The instances built: band height kRows for every plane count S, and the
// band-height sweep's 8 and 16 at S = 5 (the presets' n_scales_per_octave
// 3) only, which keeps the build short.
constexpr int kRows = 32;

template <bool F>
const void* pick(int S, int R) {
  if (S == 5 && R == 8) return (const void*)detect_kernel<F, 5, 8>;
  if (S == 5 && R == 16) return (const void*)detect_kernel<F, 5, 16>;
  if (R != kRows) return nullptr;
  switch (S) {
    case 3: return (const void*)detect_kernel<F, 3, kRows>;
    case 4: return (const void*)detect_kernel<F, 4, kRows>;
    case 5: return (const void*)detect_kernel<F, 5, kRows>;
    case 6: return (const void*)detect_kernel<F, 6, kRows>;
    case 7: return (const void*)detect_kernel<F, 7, kRows>;
    case 8: return (const void*)detect_kernel<F, 8, kRows>;
  }
  return nullptr;
}

}  // namespace

// Detection over the octaves of one batch in one launch. `table` (host,
// int64; ops/kernels/detect.py launch_plan): n_oct, B, S, slots, R, then
// per octave dog pointer, H, W, bands, first task, first output element.
// Outputs are flat over the octaves; the fields and c_edge are null in
// the lean form (emit_fields = 0). counts ([3][n_oct][B] and one ticket
// int after them) must be zeroed.
extern "C" int detect_octaves(const long long* table, float soft_thr,
                              float edge_bound, int emit_fields,
                              int* cand_col, uint8_t* slot_ok, float* c_oi,
                              float* c_oj, float* c_os, float* c_val,
                              uint8_t* c_edge, int* counts,
                              cudaStream_t stream) {
  Launch L = {};
  L.n_oct = (int)table[0];
  L.B = (int)table[1];
  const int S = (int)table[2];
  L.slots = (int)table[3];
  const int R = (int)table[4];
  if (L.n_oct < 1 || L.n_oct > kMaxOctaves || L.B < 1 || L.slots < 1 ||
      L.slots > 32)
    return (int)cudaErrorInvalidValue;
  long long tasks = 0;
  for (int k = 0; k < L.n_oct; ++k) {
    const long long* t = table + 5 + 6 * k;
    Octave& o = L.oct[k];
    o.dog = (const float*)t[0];
    o.H = (int)t[1];
    o.W = (int)t[2];
    o.bands = (int)t[3];
    o.task0 = (int)t[4];
    o.out0 = t[5];
    o.vec = o.W % 4 == 0 && ((uintptr_t)o.dog & 15) == 0;
    if (o.H < 3 || o.W < 3 || o.task0 != tasks ||
        o.bands != (o.H - 2 + R - 1) / R)
      return (int)cudaErrorInvalidValue;
    tasks += (long long)L.B * o.bands;
  }
  L.soft_thr = soft_thr;
  L.edge_bound = edge_bound;
  L.cand_col = cand_col;
  L.slot_ok = slot_ok;
  L.c_oi = c_oi;
  L.c_oj = c_oj;
  L.c_os = c_os;
  L.c_val = c_val;
  L.c_edge = c_edge;
  L.counts = counts;
  L.ticket = counts + 3LL * L.n_oct * L.B;
  const void* kernel = emit_fields ? pick<true>(S, R) : pick<false>(S, R);
  if (kernel == nullptr || tasks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const long long bytes = smem_floats(S, R) * (long long)sizeof(float);
  int grid = 0;
  int err = device_facts::resident_grid(kernel, kThreads, bytes, &grid);
  if (err != 0) return err;
  L.tasks = (int)tasks;
  if (tasks < grid) grid = (int)tasks;
  void* args[] = {&L};
  return (int)cudaLaunchKernel(kernel, dim3((unsigned)grid), dim3(kThreads),
                               args, (size_t)bytes, stream);
}
