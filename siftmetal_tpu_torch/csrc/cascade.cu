// Fused incremental Gaussian cascade + DoG of one octave, streamed down
// column strips.
//
// Replaces the TPU kernel siftmetal_tpu/ops/pallas/cascade.py
// _cascade_kernel (through octave_cascade_pallas). What it computes is the
// same: from the first Gaussian slice g0 [B, H, W], the n incremental
// separable blurs of the octave in IPOL order (slice s + 1 = slice s
// blurred by rho[s -> s + 1]) and the DoG of consecutive slices, every
// output written once and no slice read back from device memory.
//
// Half-sample-symmetric extension commutes with a symmetric convolution,
// so g0 is extended once by the total radius R = sum of the stage radii
// (the period-2n reflection map) and every stage is computed over the
// extended plane, never mirrored again: plane P_s (slice s) is known R -
// m_s beyond the image on every side, m_s the radii of the stages before
// s. Each output sums its taps in the order k = 0..2r as one fmaf chain
// from 0, the X pass before the Y pass, so every value equals the tiled
// first design's bit for bit.
//
// Layout (ops/kernels/cascade.py cascade_plan): one block per (frame, row
// band, column strip). The block owns `strip` output columns and walks its
// band's rows, kG = 8 rows a superstep, with ring buffers per stage in
// shared memory: the P_s rows its X pass reads (kG rows; 2 kG for the
// input, whose next rows are copied by cp.async behind the current ones)
// and the X_s rows its Y pass reads (2 r_s + kG). Stage s runs s
// supersteps behind stage 0, so within a superstep the X passes of all
// stages are independent of one another, and so are the Y passes: two
// barriers a superstep, whatever the number of stages. The Y halo is paid
// once per band and the X halo shrinks stage by stage (R - m_{s+1}
// columns on each side of the strip). The DoG reads slice s back at the
// band's rows: g0 itself, or what stage s - 1 stored a superstep or more
// before (L2). The band height makes the grid one wave of resident blocks.
//
// Passes: an X task computes 8 neighbouring outputs of one row from one
// window read as float4 (one 16-byte shared load per ~25 multiply-adds at
// the default radii); its taps sit in the kernel's parameter (constant
// bank), and the default radii (5, 7, 8, 10, 13) have their own instance
// with every radius and tap index known at compile time, so a tap is an
// FFMA operand (other configurations take the generic instance, a sliding
// scalar window). A Y task computes a 4 x 4 block (4 rows of 4 columns)
// reading each X row of its reach once as a float4, 16 multiply-adds a
// load, in one loop for every radius (a constant-bank tap a row; full
// unrolling per stage made the kernel slower: PERF.md).
//
// Bound on an H100: bytes (one plane read, 2n + 1 planes written); the
// multiply-adds, 2 sum(2 r + 1) a pixel plus the halos, stay under the
// fp32 rate. What the kernel waits for is latency: PERF.md keeps its
// distance from the bound and the split of its time by pass.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_facts.cuh"

namespace {

constexpr int kThreads = 320;  // 10 warps (2 blocks an SM: at most 102 registers)
constexpr int kG = 8;            // rows a superstep
constexpr int kY = 4;            // rows of a Y task
constexpr int kXC = 8;           // columns of an X task
constexpr int kMaxStages = 12;
constexpr int kMaxTaps = 512;

struct Stage {
  int r, toff;  // radius, first tap in Launch::taps
  int m;        // radii of the stages before (P_s starts R - m past the strip)
  int wx;       // columns of X_s and of P_{s+1}: strip + 2 (R - m - r)
  int gx;       // 4-column groups of an X ring row: ceil((ax + wx) / 4)
  int px, dx, ox;  // X ring: pitch, depth (rows), offset in floats
  int pp, dp, op;  // P_s ring: pitch, depth, offset
  int ax;       // physical column of X_s's (and P_{s+1}'s) column 0
  int ap;       // physical column of P_s's column 0
};

struct Launch {
  const float* g0;
  float* gauss;
  float* dog;
  int B, H, W, n, R, strip, band;
  int oc;   // offset (floats) of the reflected column table (ints)
  int vec;  // W % 4 == 0 and 16-byte aligned planes: float4 output rows
  Stage st[kMaxStages];
  float taps[kMaxTaps];
};

// The default schedule's radii (SiftConfig(): sigma_min 0.8, delta_min 0.5,
// 3 scales an octave), known at compile time.
struct Default {
  static constexpr int n = 5;
  __host__ __device__ static constexpr int r(int s) {
    return s == 0 ? 5 : s == 1 ? 7 : s == 2 ? 8 : s == 3 ? 10 : 13;
  }
  __host__ __device__ static constexpr int toff(int s) {
    return s == 0 ? 0 : toff(s - 1) + 2 * r(s - 1) + 1;
  }
  // Physical columns (ops/kernels/cascade.py _stages): X_s's column 0 at
  // 4 + (-e) mod 4, e = R - m_{s+1} its extension past the strip; P_0's at 4.
  __host__ __device__ static constexpr int m(int s) {
    return s == 0 ? 0 : m(s - 1) + r(s - 1);
  }
  __host__ __device__ static constexpr int ax(int s) {
    return 4 + (4 - (m(n) - m(s + 1)) % 4) % 4;
  }
  __host__ __device__ static constexpr int ap(int s) {
    return s == 0 ? 4 : ax(s - 1);
  }
};

// Any other schedule: radii read from the launch.
struct Generic {
  static constexpr int n = 0;
};

__device__ __forceinline__ int reflect(int i, int n) {
  const int p = 2 * n;
  int m = i % p;
  if (m < 0) m += p;
  return m < n ? m : p - 1 - m;
}

// Ring slot of row i (any sign) in a ring of d rows.
__device__ __forceinline__ int slot(int i, int d) {
  const int m = i % d;
  return m < 0 ? m + d : m;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// X task: X_s at one row, physical columns kXC g .. kXC g + kXC - 1 of its
// ring (X-local kXC g - ax on), from P_s's ring, whose window starts at
// physical kXC g + ap - ax; `sp` / `sx`: the row's slots in P_s's and
// X_s's rings.
template <int KR, int KT, int KD>
__device__ __forceinline__ void x_task(const Launch& L, const Stage& S,
                                       float* sm, int sp, int sx, int g) {
  const float* row = sm + S.op + sp * S.pp + kXC * g;
  float acc[kXC];
  if constexpr (KR > 0) {
    // KD = ap - ax in [-3, 3]: the window is read as float4 from the
    // aligned column at or before it, offset ko.
    constexpr int lo = KD >= 0 ? 0 : -4, ko = KD - lo;
    constexpr int kn = 2 * KR + 1;
    constexpr int nw = (ko + 2 * KR + kXC + 3) / 4;
    float w[4 * nw];
#pragma unroll
    for (int v = 0; v < nw; ++v) {
      const float4 t = reinterpret_cast<const float4*>(row + lo)[v];
      w[4 * v] = t.x;
      w[4 * v + 1] = t.y;
      w[4 * v + 2] = t.z;
      w[4 * v + 3] = t.w;
    }
#pragma unroll
    for (int c = 0; c < kXC; ++c) {
      float a = 0.f;
#pragma unroll
      for (int k = 0; k < kn; ++k) a = fmaf(L.taps[KT + k], w[ko + c + k], a);
      acc[c] = a;
    }
  } else {
    const float* in = row + S.ap - S.ax;
    const int kn = 2 * S.r + 1;
    const float* t = L.taps + S.toff;
    float x[kXC];
#pragma unroll
    for (int c = 0; c < kXC; ++c) {
      acc[c] = 0.f;
      x[c] = in[c];
    }
    for (int k = 0; k < kn; ++k) {
      const float tk = t[k];
#pragma unroll
      for (int c = 0; c < kXC; ++c) acc[c] = fmaf(tk, x[c], acc[c]);
#pragma unroll
      for (int c = 0; c < kXC - 1; ++c) x[c] = x[c + 1];
      x[kXC - 1] = in[k + kXC];
    }
  }
  float4* out = reinterpret_cast<float4*>(sm + S.ox + sx * S.px + kXC * g);
#pragma unroll
  for (int v = 0; v < kXC / 4; ++v)
    out[v] = make_float4(acc[4 * v], acc[4 * v + 1], acc[4 * v + 2], acc[4 * v + 3]);
}

// What stage s does in a superstep, the same for every thread: thread s
// works it out once, the others read it (two buffers, by the superstep's
// parity).
struct Step {
  int xn;          // rows of the X pass (0: none)
  int xp, xx;      // its first row's slots in P_s's and X_s's rings
  int yon;         // the Y pass runs
  int y0, lo, hi;  // its first row; P_{s+1}'s rows are [lo, hi)
  int yx, yn;      // slots of X_s's ring at y0 - r and of P_{s+1}'s at y0
};

__device__ __forceinline__ int wrap(int i, int d) { return i >= d ? i - d : i; }



__device__ __forceinline__ void fma4(float4& a, float t, const float4& v) {
  a.x = fmaf(t, v.x, a.x);
  a.y = fmaf(t, v.y, a.y);
  a.z = fmaf(t, v.z, a.z);
  a.w = fmaf(t, v.w, a.w);
}

// Y task: P_{s+1} at rows y0..y0+3, columns 4g..4g+3 (local), from X_s's
// ring; then the next ring, the outputs of the band's rows and the DoG.
// Row y0 + q takes taps k = 0..2r from X rows y0 + q - r + k, in that
// order: the first three rows read start the chain of rows 0-2, the last
// three finish rows 1-3, and the loop between feeds all four, each its
// own tap (a window of four taps rotates through registers). One loop for
// every radius keeps the code small.
__device__ __forceinline__ void y_task(const Launch& L, int s, const Step& p,
                                       float* sm, int g, int h, int r0,
                                       int r1, int c0, const float* src,
                                       float* gb, float* db, long long plane) {
  const Stage& S = L.st[s];
  const int lc = 4 * g;
  const int r = S.r;
  const int y0 = p.y0 + kY * h;
  if (y0 + kY <= p.lo || y0 >= p.hi) return;
  const float* tp = L.taps + S.toff;
  const float* ring = sm + S.ox + lc;
  int sl = wrap(p.yx + kY * h, S.dx);
  const auto row = [&]() {
    const float4 v = *reinterpret_cast<const float4*>(ring + sl * S.px);
    sl = sl + 1 == S.dx ? 0 : sl + 1;
    return v;
  };
  float4 a0 = make_float4(0.f, 0.f, 0.f, 0.f), a1 = a0, a2 = a0, a3 = a0;
  float tb = tp[2], tc = tp[1], td = tp[0];
  float4 v = row();
  fma4(a0, td, v);
  v = row();
  fma4(a0, tc, v);
  fma4(a1, td, v);
  v = row();
  fma4(a0, tb, v);
  fma4(a1, tc, v);
  fma4(a2, td, v);
#pragma unroll 4
  for (int kk = 3; kk <= 2 * r; ++kk) {  // taps kk, kk - 1, kk - 2, kk - 3
    const float ta = tp[kk];
    v = row();
    fma4(a0, ta, v);
    fma4(a1, tb, v);
    fma4(a2, tc, v);
    fma4(a3, td, v);
    td = tc;
    tc = tb;
    tb = ta;
  }
  v = row();  // tb, tc, td: taps 2r, 2r - 1, 2r - 2
  fma4(a1, tb, v);
  fma4(a2, tc, v);
  fma4(a3, td, v);
  v = row();
  fma4(a2, tb, v);
  fma4(a3, tc, v);
  v = row();
  fma4(a3, tb, v);

  const float4 acc[4] = {a0, a1, a2, a3};
  const bool has_next = s + 1 < L.n;
  const Stage& N = L.st[has_next ? s + 1 : s];
  const int e1 = L.R - S.m - r;   // P_{s+1} starts e1 columns before the strip
  const int j0 = c0 - e1 + lc - S.ax;  // global column of physical column lc
  const int jend = min(c0 + L.strip, L.W);
  const bool out_cols = j0 + 3 >= c0 && j0 < jend;
  // Slice s at the band's rows is read back for the DoG: g0 itself for
  // s = 0, else what stage s - 1 stored at least a superstep ago (after a
  // barrier, so this block's stores are visible).
  const float* slice_s = s == 0 ? src : gb + (long long)s * plane;
  int sn = wrap(p.yn + kY * h, N.dp);
#pragma unroll
  for (int q = 0; q < kY; ++q, sn = sn + 1 == N.dp ? 0 : sn + 1) {
    const int y = y0 + q;
    if (y < p.lo || y >= p.hi) continue;
    if (has_next)
      *reinterpret_cast<float4*>(sm + N.op + sn * N.pp + lc) = acc[q];
    if (!out_cols || y < r0 || y >= r1) continue;
    const long long o = (long long)y * L.W;
    if (L.vec) {  // j0 and jend are multiples of 4: the 4 columns are all out
      const float4 prev = *reinterpret_cast<const float4*>(slice_s + o + j0);
      const float4 cur = acc[q];
      *reinterpret_cast<float4*>(gb + (long long)(s + 1) * plane + o + j0) = cur;
      *reinterpret_cast<float4*>(db + (long long)s * plane + o + j0) = make_float4(
          cur.x - prev.x, cur.y - prev.y, cur.z - prev.z, cur.w - prev.w);
      if (s == 0) *reinterpret_cast<float4*>(gb + o + j0) = prev;
      continue;
    }
    const float cur[4] = {acc[q].x, acc[q].y, acc[q].z, acc[q].w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + c;
      if (j < c0 || j >= jend) continue;
      const float prev = slice_s[o + j];
      gb[(long long)(s + 1) * plane + o + j] = cur[c];
      db[(long long)s * plane + o + j] = cur[c] - prev;
      if (s == 0) gb[o + j] = prev;
    }
  }
}

template <class K, int S = 0>
__device__ __forceinline__ void x_dispatch(const Launch& L, int s, float* sm,
                                           int sp, int sx, int g) {
  if constexpr (K::n == 0) {
    x_task<0, 0, 0>(L, L.st[s], sm, sp, sx, g);
  } else if constexpr (S + 1 < K::n) {
    if (s == S)
      x_task<K::r(S), K::toff(S), K::ap(S) - K::ax(S)>(L, L.st[S], sm, sp, sx, g);
    else
      x_dispatch<K, S + 1>(L, s, sm, sp, sx, g);
  } else {
    x_task<K::r(S), K::toff(S), K::ap(S) - K::ax(S)>(L, L.st[S], sm, sp, sx, g);
  }
}

template <class K>
__global__ void __launch_bounds__(kThreads, 2)
    stream_kernel(const __grid_constant__ Launch L) {
  extern __shared__ __align__(16) float sm[];
  __shared__ Step steps[2][kMaxStages];
  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * L.strip;
  const int r0 = blockIdx.y * L.band;
  const int r1 = min(r0 + L.band, L.H);
  const int b = blockIdx.z;
  const int n = K::n > 0 ? K::n : L.n;
  const int R = L.R;
  const long long plane = (long long)L.H * L.W;
  const float* src = L.g0 + (long long)b * plane;
  float* gb = L.gauss + (long long)b * (n + 1) * plane;
  float* db = L.dog + (long long)b * n * plane;
  int* col = reinterpret_cast<int*>(sm + L.oc);
  const int wp0 = L.strip + 2 * R;
  for (int k = tid; k < wp0; k += kThreads) col[k] = reflect(c0 - R + k, L.W);

  const int top = r0 - R;            // first row of the extended band
  const int n_in = r1 - r0 + 2 * R;  // its rows
  // Superstep t: stage s takes P_s rows [bs, bs + kG), bs = top + (t - s)
  // kG - m_s, those inside P_s's rows [top + m_s, r1 + R - m_s), and makes
  // P_{s+1} rows [bs - r_s, bs - r_s + kG).
  const auto plan = [&](int t) {
    if (tid >= n) return;
    const Stage& S = L.st[tid];
    Step& p = steps[t & 1][tid];
    const int bs = top + (t - tid) * kG - S.m;
    const int qa = max(0, top + S.m - bs), qb = min(kG, r1 + R - S.m - bs);
    p.xn = max(0, qb - qa);
    p.xp = slot(bs + qa, S.dp);
    p.xx = slot(bs + qa, S.dx);
    p.y0 = bs - S.r;
    p.lo = top + S.m + S.r;
    p.hi = r1 + R - S.m - S.r;
    p.yon = p.y0 + kG > p.lo && p.y0 < p.hi;
    p.yx = slot(p.y0 - S.r, S.dx);
    p.yn = tid + 1 < n ? slot(p.y0, L.st[tid + 1].dp) : 0;
  };
  const Stage& S0 = L.st[0];
  const auto load = [&](int t) {  // input rows of superstep t
    for (int q = 0; q < kG; ++q) {
      const int i = top + t * kG + q;
      if (i >= top + n_in) break;
      const float* srow = src + (long long)reflect(i, L.H) * L.W;
      float* dst = sm + S0.op + slot(i, S0.dp) * S0.pp + S0.ap;
      for (int k = tid; k < wp0; k += kThreads) cp_async4(dst + k, srow + col[k]);
    }
    cp_async_commit();
  };
  plan(0);
  __syncthreads();  // the column table
  load(0);
  const int n_steps = n - 1 + (n_in + kG - 1) / kG;
  for (int t = 0; t < n_steps; ++t) {
    cp_async_wait_all();
    __syncthreads();  // this superstep's input rows and plan; the last Y phase done
    if (t + 1 < n_steps) plan(t + 1);
    if ((t + 1) * kG < n_in) load(t + 1);
    const Step* st = steps[t & 1];
    // Each phase deals the tasks of every stage, the last (widest) stage's
    // first, to the threads back and forth: round k forwards, round k + 1
    // backwards, so a thread's heavy tasks pair with light ones.
    // X tasks of kXC columns: xg(s) a row.
    const auto xg = [&](int s) { return (4 * L.st[s].gx + kXC - 1) / kXC; };
    int total = 0;
    for (int s = 0; s < n; ++s) total += st[s].xn * xg(s);
    for (int k = 0;; ++k) {  // X phase
      int i = k * kThreads + (k & 1 ? kThreads - 1 - tid : tid);
      if (i >= total) break;
      int s = n - 1;
      for (; i >= st[s].xn * xg(s); --s) i -= st[s].xn * xg(s);
      const int gx = xg(s);
      const int q = i / gx;  // row of the X pass
      x_dispatch<K>(L, s, sm, wrap(st[s].xp + q, L.st[s].dp), wrap(st[s].xx + q, L.st[s].dx),
                    i - q * gx);
    }
    __syncthreads();
    total = 0;
    for (int s = 0; s < n; ++s) total += st[s].yon * 2 * L.st[s].gx;
    for (int k = 0;; ++k) {  // Y phase
      int i = k * kThreads + (k & 1 ? kThreads - 1 - tid : tid);
      if (i >= total) break;
      int s = n - 1;
      for (; i >= st[s].yon * 2 * L.st[s].gx; --s) i -= st[s].yon * 2 * L.st[s].gx;
      const int gx = L.st[s].gx;
      y_task(L, s, st[s], sm, i - (i >= gx) * gx, i >= gx, r0, r1, c0, src, gb, db, plane);
    }
  }
}

}  // namespace

// The streamed cascade of [B, H, W] fp32 g0. `table` (host, int32;
// ops/kernels/cascade.py cascade_plan): B, H, W, n, R, strip, band,
// strips, bands, smem bytes, column-table offset, then per stage r, toff,
// m, wx, gx, px, dx, ox, pp, dp, op, ax, ap. `taps` (host): the stages' taps, one
// after the other. gauss [B, n + 1, H, W], dog [B, n, H, W].
extern "C" int octave_cascade(const float* g0, const int* table,
                              const float* taps, int n_taps, float* gauss,
                              float* dog, cudaStream_t stream) {
  Launch L = {};
  L.g0 = g0;
  L.gauss = gauss;
  L.dog = dog;
  L.B = table[0];
  L.H = table[1];
  L.W = table[2];
  L.n = table[3];
  L.R = table[4];
  L.strip = table[5];
  L.band = table[6];
  const int strips = table[7], bands = table[8], bytes = table[9];
  L.oc = table[10];
  if (L.n < 1 || L.n > kMaxStages || n_taps < 1 || n_taps > kMaxTaps ||
      L.B < 1 || L.B > 65535 || L.strip < 4 || L.strip % 4 != 0 ||
      L.band < 1 || strips < 1 || bands < 1 || bands > 65535 ||
      (long long)strips * L.strip < L.W || (long long)bands * L.band < L.H)
    return (int)cudaErrorInvalidValue;
  bool deflt = L.n == Default::n;
  int m = 0;
  for (int s = 0; s < L.n; ++s) {
    const int* t = table + 11 + 13 * s;
    Stage& S = L.st[s];
    S.r = t[0];
    S.toff = t[1];
    S.m = t[2];
    S.wx = t[3];
    S.gx = t[4];
    S.px = t[5];
    S.dx = t[6];
    S.ox = t[7];
    S.pp = t[8];
    S.dp = t[9];
    S.op = t[10];
    S.ax = t[11];
    S.ap = t[12];
    if (S.r < 1 || S.m != m || S.toff + 2 * S.r + 1 > n_taps ||
        S.dx < 2 * S.r + kG || S.dp < (s == 0 ? 2 * kG : kG) || S.px % 4 || S.pp % 4 ||
        S.ox % 4 || S.op % 4 || S.op < 4 || S.ax < 4 || S.ax > 7 ||
        S.ap != (s == 0 ? 4 : L.st[s - 1].ax) || S.gx * 4 < S.ax + S.wx ||
        S.px < (4 * S.gx + kXC - 1) / kXC * kXC)
      return (int)cudaErrorInvalidValue;
    deflt = deflt && S.r == Default::r(s) && S.toff == Default::toff(s) &&
            S.ax == Default::ax(s);
    m += S.r;
  }
  if (m != L.R) return (int)cudaErrorInvalidValue;
  L.vec = L.W % 4 == 0 && ((uintptr_t)g0 & 15) == 0 &&
          ((uintptr_t)gauss & 15) == 0 && ((uintptr_t)dog & 15) == 0;
  for (int k = 0; k < n_taps; ++k) L.taps[k] = taps[k];
  const void* kernel = deflt ? (const void*)stream_kernel<Default>
                             : (const void*)stream_kernel<Generic>;
  const int e = device_facts::allow_shared(kernel, bytes);
  if (e != 0) return e;
  void* args[] = {&L};
  return (int)cudaLaunchKernel(kernel, dim3(strips, bands, L.B), dim3(kThreads),
                               args, (size_t)bytes, stream);
}
