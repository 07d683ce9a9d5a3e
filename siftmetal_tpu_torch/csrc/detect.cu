// Fused DoG extrema detection with deterministic per-row slot compaction.
//
// Replaces the TPU kernel siftmetal_tpu/ops/pallas/detect.py
// _detect_kernel (through detect_candidates_pallas, emit_fields=True).
// What it computes is the same: for each (frame, scale, row) of a
// [B, S, H, W] DoG stack, the columns of the first `slots` soft extrema
// (a strict extremum over the 26 neighbours with |D| > soft_thr), and at
// each of them the Taylor step (ofst_i, ofst_j, ofst_s, value) with the
// one-reciprocal formulas and the IPOL edge test |tr^2/det| <= bound.
// Per frame it counts raw extrema, soft extrema and soft extrema lost to
// full rows.
//
// Layout: one warp per (frame, scale, row); each lane takes one column
// of a 32-column chunk. Slots are ranked with __ballot_sync/__popc prefix
// counts in column order, so the slot set is deterministic (no atomic
// append); only the per-frame counters use integer atomicAdd. Column
// and edge flag are separate outputs (the TPU packed them in one word).
//
// Bound on an H100: bytes (the DoG stack is read once: 197 MB at octave 0
// of a 640x480 batch of 8); the 26 neighbour reads of a sample hit L1/L2.
// The Taylor step runs only at soft extrema. Built with -fmad=false so
// each product and sum rounds as in the plain PyTorch version.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__global__ void detect_kernel(const float* __restrict__ dog, int B, int S,
                              int H, int W, float soft_thr, float edge_bound,
                              int slots, int* __restrict__ cand_col,
                              uint8_t* __restrict__ slot_ok,
                              float* __restrict__ c_oi,
                              float* __restrict__ c_oj,
                              float* __restrict__ c_os,
                              float* __restrict__ c_val,
                              uint8_t* __restrict__ c_edge,
                              int* __restrict__ n_raw,
                              int* __restrict__ n_soft,
                              int* __restrict__ n_drop) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int nsc = S - 2;
  const int rows = H - 2;
  const long long total = (long long)B * nsc * rows;
  if (warp >= total) return;  // uniform across the warp
  const int r = (int)(warp % rows);
  const long long t = warp / rows;
  const int s = (int)(t % nsc);
  const int b = (int)(t / nsc);
  const long long plane = (long long)H * W;
  // Center row (r + 1) of center scale (s + 1).
  const float* row =
      dog + ((long long)b * S + (s + 1)) * plane + (long long)(r + 1) * W;
  const long long out0 = (((long long)b * nsc + s) * rows + r) * slots;
  const unsigned below = (1u << lane) - 1u;

  int count = 0;
  int raw_cnt = 0;
  for (int c0 = 0; c0 < W - 2; c0 += 32) {
    const int c = c0 + lane;
    bool raw = false, soft = false;
    const float* q = row + c + 1;
    float v = 0.f;
    if (c < W - 2) {
      v = q[0];
      float hi = -INFINITY, lo = INFINITY;
#pragma unroll
      for (int ds = -1; ds <= 1; ++ds)
#pragma unroll
        for (int di = -1; di <= 1; ++di)
#pragma unroll
          for (int dj = -1; dj <= 1; ++dj) {
            if (ds == 0 && di == 0 && dj == 0) continue;
            const float n = q[ds * plane + di * W + dj];
            hi = fmaxf(hi, n);
            lo = fminf(lo, n);
          }
      raw = (v > hi) || (v < lo);
      soft = raw && (fabsf(v) > soft_thr);
    }
    const unsigned mraw = __ballot_sync(0xffffffffu, raw);
    const unsigned msoft = __ballot_sync(0xffffffffu, soft);
    raw_cnt += __popc(mraw);
    if (soft) {
      const int rank = count + __popc(msoft & below);
      if (rank < slots) {
#define NB(ds, di, dj) q[(ds) * plane + (di) * W + (dj)]
        const float cc0 = v;
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
        const long long o = out0 + rank;
        cand_col[o] = c;
        slot_ok[o] = 1;
        c_oi[o] = oi;
        c_oj[o] = oj;
        c_os[o] = os;
        c_val[o] = val;
        c_edge[o] = fabsf(er) <= edge_bound ? 1 : 0;
      }
    }
    count += __popc(msoft);
  }
  if (lane < slots && lane >= count) {
    const long long o = out0 + lane;
    cand_col[o] = 0;
    slot_ok[o] = 0;
    c_oi[o] = 0.f;
    c_oj[o] = 0.f;
    c_os[o] = 0.f;
    c_val[o] = 0.f;
    c_edge[o] = 0;
  }
  if (lane == 0) {
    atomicAdd(n_raw + b, raw_cnt);
    atomicAdd(n_soft + b, count);
    if (count > slots) atomicAdd(n_drop + b, count - slots);
  }
}

}  // namespace

extern "C" int detect_candidates(const float* dog, int B, int S, int H,
                                 int W, float soft_thr, float edge_bound,
                                 int slots, int* cand_col, uint8_t* slot_ok,
                                 float* c_oi, float* c_oj, float* c_os,
                                 float* c_val, uint8_t* c_edge, int* n_raw,
                                 int* n_soft, int* n_drop,
                                 cudaStream_t stream) {
  const long long warps = (long long)B * (S - 2) * (H - 2);
  const int threads = 256;
  const long long blocks = (warps * 32 + threads - 1) / threads;
  if (blocks > 0)
    detect_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
        dog, B, S, H, W, soft_thr, edge_bound, slots, cand_col, slot_ok,
        c_oi, c_oj, c_os, c_val, c_edge, n_raw, n_soft, n_drop);
  return (int)cudaGetLastError();
}
