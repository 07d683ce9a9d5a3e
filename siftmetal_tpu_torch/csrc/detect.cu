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
//
// The refinement tail (refine_tail_kernel, refine_tail_octaves below)
// replaces no Pallas kernel: the JAX package's cross-octave tail
// (siftmetal_tpu/sift/detect.py detect_all_octaves_batch after the
// detection call) is XLA glue, and the port's plain version
// (sift/detect.py _tail_all_octaves) dispatched ~1,100 small PyTorch ops a
// call. One launch does all of it, bit for bit: the iteration-1 acceptance
// of every octave's slot grid, the lean form's compaction to the candidate
// budget and its stencil step, the shared mover block in ascending lane
// order (overflow counted), the IPOL walk of the movers, the final
// acceptance, the per-octave copies of the mover block and the counters.
// It reads each octave's DoG through its own pointer (no concatenation).
//
// Bound on an H100: bytes. At 480x640 in the parity configuration a frame
// has 34,038 slot lanes (22 bytes read, 45 written each) and a mover block
// of 1,024 lanes written to 7 octaves: ~2.8 MB a frame, 0.85 us at 3.35
// TB/s. The work is small and ordered (the movers keep lane order), so
// latency, not bytes, sets the time; the design spreads a frame over a
// thread-block cluster of 8 blocks of 512 threads, each taking an eighth of
// every octave's slot lanes in chunks of 2,048 (4 a thread, coalesced,
// every load of a chunk issued before its use). A chunk's ranks (the lean
// compaction, the movers) are ballots and one warp's scan of the 64 ballot
// counts, two barriers a scan; what a block needs of the others' counts
// (where its candidates fall in the lean budget, where its movers fall in
// the frame's block) it reads from their shared memory after a cluster
// barrier, so no atomics cross blocks and the movers keep ascending lane
// order. Each thread then walks its block's movers in registers, 19 DoG
// reads a step through the read-only cache, and writes every octave's copy
// of its lane; block 0 sums the cluster's counters.

#include <cooperative_groups.h>
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

// A Taylor step: the offsets, the interpolated value and the edge flag.
struct Step {
  float oi, oj, os, val;
  bool edge;
};

// The Taylor step and the IPOL edge test from the 19-point stencil, with
// the one-thread kernel's one-reciprocal expressions (ops/kernels/detect.py
// taylor_step and edge_ok): nb(ds, di, dj) is the DoG value at that offset
// from the centre. The detection kernel and the refinement tail both call
// it, so their fields cannot drift apart.
template <class Nb>
__device__ __forceinline__ Step taylor_step(const Nb& nb, float edge_bound) {
  const float cc0 = nb(0, 0, 0);
  const float gi = 0.5f * (nb(0, 1, 0) - nb(0, -1, 0));
  const float gj = 0.5f * (nb(0, 0, 1) - nb(0, 0, -1));
  const float gs = 0.5f * (nb(1, 0, 0) - nb(-1, 0, 0));
  const float hii = nb(0, 1, 0) + nb(0, -1, 0) - 2.0f * cc0;
  const float hjj = nb(0, 0, 1) + nb(0, 0, -1) - 2.0f * cc0;
  const float hss = nb(1, 0, 0) + nb(-1, 0, 0) - 2.0f * cc0;
  const float hij = 0.25f * (nb(0, 1, 1) - nb(0, 1, -1) -
                             nb(0, -1, 1) + nb(0, -1, -1));
  const float his = 0.25f * (nb(1, 1, 0) - nb(1, -1, 0) -
                             nb(-1, 1, 0) + nb(-1, -1, 0));
  const float hjs = 0.25f * (nb(1, 0, 1) - nb(1, 0, -1) -
                             nb(-1, 0, 1) + nb(-1, 0, -1));
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
  Step t;
  t.oi = -(aa * gi + ab * gj + ac * gs);
  t.oj = -(ab * gi + bb * gj + bc * gs);
  t.os = -(ac * gi + bc * gj + cc * gs);
  t.val = cc0 + 0.5f * (gi * t.oi + gj * t.oj + gs * t.os);
  const float tr = hii + hjj;
  const float er = tr * tr / (hii * hjj - hij * hij);
  t.edge = fabsf(er) <= edge_bound;
  return t;
}

// The Taylor step and the edge flag of the kept slot `oo` at (scale s, row
// r, column c) of frame b, read from device memory.
template <int S>
__device__ __forceinline__ void taylor_slot(const Launch& L, const Octave& o,
                                            int b, int s, int r, int c,
                                            long long oo) {
  const long long plane = (long long)o.H * o.W;
  const int W = o.W;
  const float* q =
      o.dog + ((long long)b * S + (s + 1)) * plane + (long long)(r + 1) * W + c + 1;
  const Step t = taylor_step(
      [&](int ds, int di, int dj) { return q[ds * plane + di * W + dj]; },
      L.edge_bound);
  L.c_oi[oo] = t.oi;
  L.c_oj[oo] = t.oj;
  L.c_os[oo] = t.os;
  L.c_val[oo] = t.val;
  L.c_edge[oo] = t.edge ? 1 : 0;
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

// --- the refinement tail ----------------------------------------------------

constexpr int kTailThreads = 512;
constexpr int kTailWarps = kTailThreads / 32;
constexpr int kTailPer = 4;  // slot lanes a thread takes in a chunk
constexpr int kTailChunk = kTailThreads * kTailPer;
constexpr int kTailWords = kTailPer * kTailWarps;  // ballot words a chunk
constexpr int kMaxSigmas = 9;  // Gaussian slices an octave at 8 DoG planes
constexpr int kTailCluster = 8;  // blocks a frame: one thread-block cluster
static_assert(kTailWords == 64, "chunk_ranks gives each lane of a warp two words");

struct TailOctave {
  const float* dog;       // [B, S, H, W]
  const int* cand_col;    // [B, S - 2, H - 2, slots]: the detection's slots
  const uint8_t* slot_ok;
  const float* c_oi;      // the four fields and the edge flag: null when lean
  const float* c_oj;
  const float* c_os;
  const float* c_val;
  const uint8_t* c_edge;
  const int* n_raw;       // [B] each: the detection's counters
  const int* n_soft;
  const int* n_drop;
  long long out0;         // first output element of the octave
  int H, W;
  int grid;               // grid lanes of its output: the slots, or the lean budget
  float delta;
};

struct TailLaunch {
  TailOctave oct[kMaxOctaves];
  float sigma[kMaxOctaves * kMaxSigmas];  // [n_oct][n_sig]
  int n_oct, B, S, slots, n_sig, k_move, iterations;
  float mo, dog_thr, edge_bound, ratio;
  long long total;  // elements of one output field over every octave
  uint8_t* flags;   // [5][total]: cand_valid, converged, pass_hard, pass_edge, pass_border
  int* ints;        // [3][total]: scale, i, j
  float* reals;     // [7][total]: ofst_i, ofst_j, ofst_s, x, y, sigma, value
  int* counters;    // [8][B]
  int2* movers;     // [B][kTailCluster][k_move]: each block's list of its movers'
                    // starts (i, j << 8 | s << 4 | octave)
};

// The acceptance of one lane (sift/detect.py _tail_all_octaves accept):
// pass_hard, pass_edge and pass_border before the candidate mask, and the
// position and blur in input-image units.
struct Accepted {
  bool hard, edge, border;
  float x, y, sigma;
};

__device__ __forceinline__ Accepted accept(const TailLaunch& L, int o, bool conv,
                                           int s, int i, int j, const Step& t) {
  const TailOctave& oc = L.oct[o];
  const float dlt = oc.delta;
  Accepted a;
  a.hard = conv && fabsf(t.val) > L.dog_thr;
  a.edge = a.hard && t.edge;
  a.x = ((float)i + t.oi) * dlt;
  a.y = ((float)j + t.oj) * dlt;
  a.sigma = L.sigma[o * L.n_sig + s] * powf(L.ratio, t.os);
  const float img_h = (float)oc.H * dlt, img_w = (float)oc.W * dlt;
  a.border = a.edge && a.x - a.sigma > 0.0f && a.x + a.sigma < img_h &&
             a.y - a.sigma > 0.0f && a.y + a.sigma < img_w;
  return a;
}

// Output lane `e` of every field; each flag masked by `cand`.
__device__ __forceinline__ void put(const TailLaunch& L, long long e, bool cand,
                                    bool conv, const Accepted& a, int s, int i,
                                    int j, const Step& t) {
  const long long T = L.total;
  uint8_t* f = L.flags + e;
  f[0] = cand;
  f[T] = cand && conv;
  f[2 * T] = cand && a.hard;
  f[3 * T] = cand && a.edge;
  f[4 * T] = cand && a.border;
  int* n = L.ints + e;
  n[0] = s;
  n[T] = i;
  n[2 * T] = j;
  float* v = L.reals + e;
  v[0] = t.oi;
  v[T] = t.oj;
  v[2 * T] = t.os;
  v[3 * T] = a.x;
  v[4 * T] = a.y;
  v[5 * T] = a.sigma;
  v[6 * T] = t.val;
}

// The Taylor step at (s, i, j) of frame b's octave o, read through the
// read-only cache.
__device__ __forceinline__ Step tail_step(const TailLaunch& L, int o, int b,
                                          int s, int i, int j) {
  const TailOctave& oc = L.oct[o];
  const long long plane = (long long)oc.H * oc.W;
  const int W = oc.W;
  const float* q = oc.dog + ((long long)b * L.S + s) * plane + (long long)i * W + j;
  return taylor_step(
      [&](int ds, int di, int dj) { return __ldg(q + ds * plane + di * W + dj); },
      L.edge_bound);
}

// The clamped move of a lane that did not converge (_refine_batched).
__device__ __forceinline__ void clamped_move(const TailLaunch& L, int o,
                                             const Step& t, int& s, int& i,
                                             int& j) {
  const float mo = L.mo;
  const int H = L.oct[o].H, W = L.oct[o].W, n_sc = L.S - 2;
  const int di = (t.oi > mo && i + 1 <= H - 2) - (t.oi < -mo && i - 1 >= 1);
  const int dj = (t.oj > mo && j + 1 <= W - 2) - (t.oj < -mo && j - 1 >= 1);
  const int ds = (t.os > mo && s + 1 <= n_sc) - (t.os < -mo && s - 1 >= 1);
  s += ds;
  i += di;
  j += dj;
}

__device__ __forceinline__ bool converged(const TailLaunch& L, const Step& t) {
  return fabsf(t.oi) < L.mo && fabsf(t.oj) < L.mo && fabsf(t.os) < L.mo;
}

// The ranks of the set flags among a chunk's lanes in lane order (lane
// c0 + r * kTailThreads + thread holds flag[r]); returns the chunk's count.
// `sm` holds kTailWords + 1 ints; two scans in a row take two buffers, so
// that the second's counts never overwrite what a thread of the first
// still reads.
__device__ __forceinline__ int chunk_ranks(const bool (&flag)[kTailPer],
                                           int (&rank)[kTailPer], int* sm) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned m[kTailPer];
#pragma unroll
  for (int r = 0; r < kTailPer; ++r) {
    m[r] = __ballot_sync(0xffffffffu, flag[r]);
    if (lane == 0) sm[r * kTailWarps + warp] = __popc(m[r]);
  }
  __syncthreads();
  if (warp == 0) {  // exclusive prefix of the 64 word counts, two a lane
    const int a = sm[2 * lane], c = sm[2 * lane + 1];
    int incl = a + c;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += v;
    }
    sm[2 * lane] = incl - a - c;
    sm[2 * lane + 1] = incl - c;
    if (lane == 31) sm[kTailWords] = incl;
  }
  __syncthreads();
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int r = 0; r < kTailPer; ++r)
    rank[r] = sm[r * kTailWarps + warp] + __popc(m[r] & below);
  return sm[kTailWords];
}

// The block's sum of each thread's `v[c]` into `out[c]` (n values;
// `out` zeroed before, the caller synchronises after).
template <int n>
__device__ __forceinline__ void block_sum(const int (&v)[n], int* out) {
#pragma unroll
  for (int c = 0; c < n; ++c) {
    const int w = __reduce_add_sync(0xffffffffu, v[c]);
    if ((threadIdx.x & 31) == 0 && w != 0) atomicAdd(out + c, w);
  }
}

// One cluster of kTailCluster blocks a frame; block r takes the r-th
// share of every octave's slot lanes. Lean: first each block counts its
// candidates an octave, so that every block knows where its candidates
// fall in the octave's budget. The grid pass walks the block's lanes in
// chunks (iteration-1 acceptance, written at once; the movers' starts
// appended to the block's list in lane order). Then each block reads the
// others' mover counts, so each of its movers knows its place in the
// frame's block, and walks those that fit; last block 0 sums the counters.
// kFields: the detection kernel's fields (else the lean form).
template <bool kFields, int kPer>
__global__ void __cluster_dims__(kTailCluster, 1, 1) __launch_bounds__(kTailThreads)
    refine_tail_kernel(const __grid_constant__ TailLaunch L) {
  static_assert(kPer == kTailPer, "one chunk shape");
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ int scan_sm[2][kTailWords + 1];
  __shared__ int n_ok[kMaxOctaves], n_mv[kMaxOctaves];  // this block's, an octave
  __shared__ int ok0[kMaxOctaves], ok_all[kMaxOctaves];  // lean: before this block, in all
  // The frame's movers before this block's, in all, and before the
  // octave's in the block's list.
  __shared__ int mv0[kMaxOctaves], mv_all[kMaxOctaves], mv_in[kMaxOctaves];
  __shared__ int red[4];
  const int r = (int)cluster.block_rank(), b = blockIdx.x / kTailCluster;
  const int tid = threadIdx.x;
  const int n_sc = L.S - 2, slots = L.slots;
  if (tid < kMaxOctaves) n_ok[tid] = n_mv[tid] = 0;
  if (tid < 4) red[tid] = 0;
  __syncthreads();
  // This block's share [lo, hi) of octave o's lanes.
  auto share = [&](int o, int& lo, int& hi) {
    const long long lanes = (long long)n_sc * (L.oct[o].H - 2) * slots;
    lo = (int)(lanes * r / kTailCluster);
    hi = (int)(lanes * (r + 1) / kTailCluster);
  };
  if (!kFields) {
    for (int o = 0; o < L.n_oct; ++o) {
      int lo, hi;
      share(o, lo, hi);
      const uint8_t* ok = L.oct[o].slot_ok +
                          (long long)b * n_sc * (L.oct[o].H - 2) * slots;
      int n[1] = {0};
      for (int l = lo + tid; l < hi; l += kTailThreads) n[0] += ok[l] != 0;
      block_sum(n, n_ok + o);
    }
    cluster.sync();  // every block's counts are in
    if (tid < L.n_oct) {
      int before = 0, all = 0;
      for (int q = 0; q < kTailCluster; ++q) {
        const int v = cluster.map_shared_rank(n_ok, q)[tid];
        before += q < r ? v : 0;
        all += v;
      }
      ok0[tid] = before;
      ok_all[tid] = all;
    }
    __syncthreads();
  }

  int cnt[4] = {0, 0, 0, 0};  // converged, hard, edge, border of this thread's lanes
  int n_list = 0;             // the block's movers so far (the same in every thread)
  int scan = 0;
  int2* list = L.movers + ((long long)b * kTailCluster + r) * L.k_move;
  for (int o = 0; o < L.n_oct; ++o) {
    const TailOctave& oc = L.oct[o];
    const int per_scale = (oc.H - 2) * slots;
    const long long in0 = (long long)b * n_sc * per_scale;
    const long long out_b = oc.out0 + (long long)b * (oc.grid + L.k_move);
    int lo, hi;
    share(o, lo, hi);
    int kept = kFields ? 0 : ok0[o];  // lean: the octave's candidates before the chunk
    const int list0 = n_list;
    for (int c0 = lo; c0 < hi; c0 += kTailChunk) {
      bool ok[kPer], mv[kPer];
      int s[kPer], i[kPer], j[kPer], g[kPer];
      Step t[kPer];
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int l = c0 + k * kTailThreads + tid;
        const bool in = l < hi;
        const long long e = in0 + l;
        ok[k] = in && oc.slot_ok[e];
        s[k] = l / per_scale;
        const int rem = l - s[k] * per_scale;
        s[k] += 1;
        i[k] = rem / slots + 1;
        j[k] = (in ? oc.cand_col[e] : 0) + 1;
        g[k] = in ? l : -1;  // the lane's grid lane (-1: none)
        t[k] = Step{0.0f, 0.0f, 0.0f, 0.0f, false};
        if (kFields && in) {
          t[k].oi = oc.c_oi[e];
          t[k].oj = oc.c_oj[e];
          t[k].os = oc.c_os[e];
          t[k].val = oc.c_val[e];
          t[k].edge = oc.c_edge[e] != 0;
        }
      }
      if (!kFields) {
        // Compact to the octave's budget in slot order; the kept lanes take
        // the Taylor step from the stencil.
        int rank[kPer];
        const int n = chunk_ranks(ok, rank, scan_sm[scan++ & 1]);
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          g[k] = ok[k] ? kept + rank[k] : -1;
          if (g[k] >= oc.grid) g[k] = -1;
          ok[k] = g[k] >= 0;
          if (ok[k]) t[k] = tail_step(L, o, b, s[k], i[k], j[k]);
        }
        kept += n;
      }
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const bool conv1 = converged(L, t[k]);
        if (g[k] >= 0) {
          const bool cand = ok[k] && conv1;
          const Accepted a = accept(L, o, cand, s[k], i[k], j[k], t[k]);
          put(L, out_b + g[k], cand, cand, a, s[k], i[k], j[k], t[k]);
          cnt[0] += cand;
          cnt[1] += cand && a.hard;
          cnt[2] += cand && a.edge;
          cnt[3] += cand && a.border;
        }
        mv[k] = ok[k] && !conv1;
        if (mv[k]) clamped_move(L, o, t[k], s[k], i[k], j[k]);
      }
      int rank[kPer];
      const int n = chunk_ranks(mv, rank, scan_sm[scan++ & 1]);
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        // A mover's place in the frame's block is at least its place in
        // the block's list, so the list keeps the first k_move.
        const int q = n_list + rank[k];
        if (mv[k] && q < L.k_move) list[q] = make_int2(i[k], j[k] << 8 | s[k] << 4 | o);
      }
      n_list += n;
    }
    if (tid == 0) n_mv[o] = n_list - list0;
    if (!kFields) {
      // The budget's unused lanes, shared by the blocks: no candidate, the
      // step at (1, 1, 1).
      const Step t1 = tail_step(L, o, b, 1, 1, 1);
      const Accepted a = accept(L, o, false, 1, 1, 1, t1);
      for (int q = min(ok_all[o], oc.grid) + r * kTailThreads + tid; q < oc.grid;
           q += kTailCluster * kTailThreads)
        put(L, out_b + q, false, false, a, 1, 1, 1, t1);
    }
  }
  cluster.sync();  // every block's mover counts (and list) are in
  if (tid < L.n_oct) {
    int before = 0, all = 0;  // the frame's movers before this block's in octave `tid`
    for (int q = 0; q < kTailCluster; ++q) {
      const int* v = cluster.map_shared_rank(n_mv, q);
      for (int o = 0; o < L.n_oct; ++o)
        before += (o < tid || (o == tid && q < r)) ? v[o] : 0;
      all += v[tid];
    }
    mv0[tid] = before;
    mv_all[tid] = all;
    int in_list = 0;
    for (int o = 0; o < tid; ++o) in_list += n_mv[o];
    mv_in[tid] = in_list;
  }
  __syncthreads();
  int n_move = 0;  // the frame's movers
  for (int o = 0; o < L.n_oct; ++o) n_move += mv_all[o];

  // The walk: each mover of the block's list that fits in the frame's
  // block, for `iterations` steps at most, in registers; the block's lanes
  // past the frame's movers start at (1, 1, 1) of octave 0, done. Each
  // lane is written to every octave's copy of the block, its flags masked
  // to its octave.
  const int n_mov = min(n_move, L.k_move);
  const int walked = min(n_list, L.k_move);
  const int pads = (L.k_move - n_mov + kTailCluster - 1 - r) / kTailCluster;
  for (int k = tid; k < walked + pads; k += kTailThreads) {
    const bool valid = k < walked;
    int s = 1, i = 1, j = 1, o = 0, q = n_mov + r + (k - walked) * kTailCluster;
    bool conv = false;
    Step t = Step{0.0f, 0.0f, 0.0f, 0.0f, false};
    if (valid) {
      const int2 m = list[k];
      i = m.x;
      j = m.y >> 8;
      s = (m.y >> 4) & 15;
      o = m.y & 15;
      q = mv0[o] + k - mv_in[o];
      if (q >= L.k_move) continue;
      for (int it = 0; it < L.iterations; ++it) {
        t = tail_step(L, o, b, s, i, j);
        conv = converged(L, t);
        if (conv) break;
        clamped_move(L, o, t, s, i, j);
      }
    }
    const Accepted a = accept(L, o, valid && conv, s, i, j, t);
    cnt[0] += valid && conv;
    cnt[1] += valid && a.hard;
    cnt[2] += valid && a.edge;
    cnt[3] += valid && a.border;
    for (int w = 0; w < L.n_oct; ++w) {
      const TailOctave& ow = L.oct[w];
      put(L, ow.out0 + (long long)b * (ow.grid + L.k_move) + ow.grid + q,
          valid && o == w, valid && conv, a, s, i, j, t);
    }
  }
  block_sum(cnt, red);
  cluster.sync();  // every block's counts are in
  if (r == 0 && tid == 0) {
    int sums[4] = {0, 0, 0, 0};
    for (int q = 0; q < kTailCluster; ++q) {
      const int* v = cluster.map_shared_rank(red, q);
      for (int c = 0; c < 4; ++c) sums[c] += v[c];
    }
    int raw = 0, soft = 0, drop = 0;
    for (int o = 0; o < L.n_oct; ++o) {
      raw += L.oct[o].n_raw[b];
      soft += L.oct[o].n_soft[b];
      drop += L.oct[o].n_drop[b];
      if (!kFields) drop += max(ok_all[o] - L.oct[o].grid, 0);
    }
    int* c = L.counters + b;
    const int B = L.B;
    c[0] = raw;
    c[B] = soft;
    for (int k = 0; k < 4; ++k) c[(2 + k) * B] = sums[k];
    c[6 * B] = drop + (n_move - n_mov);
    c[7 * B] = n_move;
  }
  cluster.sync();  // no block leaves while block 0 reads its shared memory
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

// The refinement tail over the octaves of one batch in one launch, one
// cluster of 8 blocks a frame. `table` (host, int64; ops/kernels/detect.py
// refine_tail_octaves): n_oct, B, S, slots, k_move, iterations, n_sig,
// emit_fields, then per octave the pointers dog, cand_col, slot_ok, c_oi,
// c_oj, c_os, c_val, c_edge, n_raw, n_soft, n_drop (the four fields and
// c_edge 0 when lean), H, W, grid lanes, first output element. `reals`
// (host, float32): max_offset, dog_threshold, edge bound, the scale ratio,
// each octave's delta, then the sigma table [n_oct][n_sig]. Outputs: flags
// [5][total] (bool), ints [3][total], reals_out [7][total], counters
// [8][B]; movers is scratch of B x 8 x k_move int2 (8-byte aligned).
extern "C" int refine_tail_octaves(const long long* table, const float* reals,
                                   long long total, uint8_t* flags, int* ints,
                                   float* reals_out, int* counters, int* movers,
                                   cudaStream_t stream) {
  TailLaunch L = {};
  L.n_oct = (int)table[0];
  L.B = (int)table[1];
  L.S = (int)table[2];
  L.slots = (int)table[3];
  L.k_move = (int)table[4];
  L.iterations = (int)table[5];
  L.n_sig = (int)table[6];
  const bool fields = table[7] != 0;
  if (L.n_oct < 1 || L.n_oct > kMaxOctaves || L.B < 1 || L.S < 3 || L.S > 8 ||
      L.slots < 1 || L.k_move < 1 || L.iterations < 0 || L.n_sig < L.S - 1 ||
      L.n_sig > kMaxSigmas)
    return (int)cudaErrorInvalidValue;
  L.mo = reals[0];
  L.dog_thr = reals[1];
  L.edge_bound = reals[2];
  L.ratio = reals[3];
  long long out = 0;
  for (int k = 0; k < L.n_oct; ++k) {
    const long long* t = table + 8 + 15 * k;
    TailOctave& o = L.oct[k];
    o.dog = (const float*)t[0];
    o.cand_col = (const int*)t[1];
    o.slot_ok = (const uint8_t*)t[2];
    o.c_oi = (const float*)t[3];
    o.c_oj = (const float*)t[4];
    o.c_os = (const float*)t[5];
    o.c_val = (const float*)t[6];
    o.c_edge = (const uint8_t*)t[7];
    o.n_raw = (const int*)t[8];
    o.n_soft = (const int*)t[9];
    o.n_drop = (const int*)t[10];
    o.H = (int)t[11];
    o.W = (int)t[12];
    o.grid = (int)t[13];
    o.out0 = t[14];
    o.delta = reals[4 + k];
    const long long slot_lanes = (long long)(L.S - 2) * (o.H - 2) * L.slots;
    // A mover's start packs j into 23 bits, s and the octave into 4 each.
    if (o.H < 3 || o.W < 3 || o.W >= (1 << 23) || slot_lanes > 0x7fffffff ||
        o.grid < 1 || (fields && o.grid != slot_lanes) || o.out0 != out ||
        (fields && (!o.c_oi || !o.c_oj || !o.c_os || !o.c_val || !o.c_edge)))
      return (int)cudaErrorInvalidValue;
    out += (long long)L.B * (o.grid + L.k_move);
  }
  if (out != total) return (int)cudaErrorInvalidValue;
  for (int k = 0; k < L.n_oct * L.n_sig; ++k) L.sigma[k] = reals[4 + L.n_oct + k];
  L.total = total;
  L.flags = flags;
  L.ints = ints;
  L.reals = reals_out;
  L.counters = counters;
  L.movers = (int2*)movers;
  const void* kernel = fields ? (const void*)refine_tail_kernel<true, kTailPer>
                              : (const void*)refine_tail_kernel<false, kTailPer>;
  void* args[] = {&L};
  return (int)cudaLaunchKernel(kernel, dim3((unsigned)L.B * kTailCluster),
                               dim3(kTailThreads), args, 0, stream);
}
