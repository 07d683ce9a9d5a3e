// Fused incremental Gaussian cascade + DoG of one octave.
//
// Replaces the TPU kernel siftmetal_tpu/ops/pallas/cascade.py
// _cascade_kernel (through octave_cascade_pallas). What it computes is the
// same: from the first Gaussian slice g0 [B, H, W], the n incremental
// separable blurs of the octave in IPOL order (slice s = slice s-1 blurred
// by rho[s-1 -> s]) and the DoG of consecutive slices, every output
// written once and no slice read back from device memory.
//
// Half-sample-symmetric extension commutes with a symmetric convolution,
// so extending g0 once by the total radius R = sum of the stage radii is
// the same as extending before every stage (to fp32 rounding: a mirrored
// sample sums its taps in mirrored order).
//
// Layout: one block per T x T output tile of one frame. The tile and a
// halo of R on every side are loaded into shared memory through the
// period-2n reflection map; each stage runs its X pass from buffer A into
// buffer B and its Y pass back into A, over a valid region that shrinks by
// the stage radius, until exactly the tile is left. Each thread keeps the
// previous slice of its tile pixels in registers for the DoG. Frames are
// a grid dimension (the TPU looped over frames on the host).
//
// Bound on an H100: bytes (one plane read, 2n + 1 planes written; the
// taps cost 2 * sum(2 r + 1) multiply-adds per pixel per stage pair, well
// under the fp32 rate). The halo makes a block redo (T + 2R)^2 / T^2 of
// the first stage's work; T = 64 with two (64 + 2R)^2 fp32 buffers is what
// 227 KB of shared memory holds at the default R = 43. The passes run out
// of shared memory, so each thread computes four neighbouring outputs
// from one sliding window: a tap and an input are loaded once for four
// multiply-adds.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_facts.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kMaxTile = 64;
constexpr int kPerThread = kMaxTile * kMaxTile / kThreads;
constexpr int kBlock = 4;  // outputs per thread in a pass

__device__ __forceinline__ int reflect(int i, int n) {
  const int p = 2 * n;
  int m = i % p;
  if (m < 0) m += p;
  return m < n ? m : p - 1 - m;
}

__global__ void cascade_kernel(const float* __restrict__ g0, int B, int H,
                               int W, const float* __restrict__ taps,
                               const int* __restrict__ radii, int n_stage,
                               int k_max, int R, int T,
                               float* __restrict__ gauss,
                               float* __restrict__ dog) {
  extern __shared__ float smem[];
  const int side = T + 2 * R;
  const int pitch = side | 1;  // odd: threads walking down a column hit 32 banks
  float* A = smem;
  float* Bf = smem + side * pitch;
  float* tp = Bf + (side + kBlock) * pitch;  // [n_stage][k_max], behind B's pad rows
  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int i0 = blockIdx.y * T, j0 = blockIdx.x * T;
  const long long plane = (long long)H * W;
  const float* src = g0 + (long long)b * plane;

  for (int k = tid; k < n_stage * k_max; k += kThreads) tp[k] = taps[k];
  for (int p = tid; p < side * side; p += kThreads) {
    const int li = p / side, lj = p - li * side;
    A[li * pitch + lj] =
        src[(long long)reflect(i0 - R + li, H) * W + reflect(j0 - R + lj, W)];
  }
  __syncthreads();

  float* gb = gauss + (long long)b * (n_stage + 1) * plane;
  float* db = dog + (long long)b * n_stage * plane;
  float prev[kPerThread];
#pragma unroll
  for (int n = 0; n < kPerThread; ++n) {
    const int p = tid + n * kThreads;
    prev[n] = 0.f;
    if (p < T * T) {
      const int ti = p / T, tj = p - ti * T;
      const int gi = i0 + ti, gj = j0 + tj;
      prev[n] = A[(R + ti) * pitch + R + tj];
      if (gi < H && gj < W) gb[(long long)gi * W + gj] = prev[n];
    }
  }

  int m = 0;  // margin already consumed on every side
  for (int s = 0; s < n_stage; ++s) {
    const int r = radii[s];
    const int kn = 2 * r + 1;
    const float* t = tp + s * k_max;
    // X pass: rows [m, side - m), cols [m + r, side - m - r). A thread
    // owns kBlock neighbouring outputs and slides one window over their
    // inputs, so a tap and an input are each read once per kBlock
    // multiply-adds. The last group of a row may read up to kBlock
    // values past the valid columns (still inside the buffers) into
    // accumulators that are not stored.
    {
      const int nr = side - 2 * m, nc = side - 2 * (m + r);
      const int ng = (nc + kBlock - 1) / kBlock;
      for (int p = tid; p < nr * ng; p += kThreads) {
        const int i = m + p % nr, jg = kBlock * (p / nr);  // threads run down rows
        const float* a = A + i * pitch + m + jg;
        float acc[kBlock], x[kBlock];
#pragma unroll
        for (int q = 0; q < kBlock; ++q) {
          acc[q] = 0.f;
          x[q] = a[q];
        }
        for (int k = 0; k < kn; ++k) {
          const float tk = t[k];
#pragma unroll
          for (int q = 0; q < kBlock; ++q) acc[q] += tk * x[q];
#pragma unroll
          for (int q = 0; q + 1 < kBlock; ++q) x[q] = x[q + 1];
          x[kBlock - 1] = a[k + kBlock];
        }
#pragma unroll
        for (int q = 0; q < kBlock; ++q)
          if (jg + q < nc) Bf[i * pitch + m + r + jg + q] = acc[q];
      }
    }
    __syncthreads();
    // Y pass: rows and cols [m + r, side - m - r), kBlock neighbouring rows
    // of one column per thread (reads past the last row land in the pad
    // rows behind buffer B).
    {
      const int nc = side - 2 * (m + r);
      const int ng = (nc + kBlock - 1) / kBlock;
      for (int p = tid; p < ng * nc; p += kThreads) {
        const int ig = kBlock * (p / nc), j = m + r + p % nc;
        const float* c = Bf + (m + ig) * pitch + j;
        float acc[kBlock], x[kBlock];
#pragma unroll
        for (int q = 0; q < kBlock; ++q) {
          acc[q] = 0.f;
          x[q] = c[q * pitch];
        }
        for (int k = 0; k < kn; ++k) {
          const float tk = t[k];
#pragma unroll
          for (int q = 0; q < kBlock; ++q) acc[q] += tk * x[q];
#pragma unroll
          for (int q = 0; q + 1 < kBlock; ++q) x[q] = x[q + 1];
          x[kBlock - 1] = c[(k + kBlock) * pitch];
        }
#pragma unroll
        for (int q = 0; q < kBlock; ++q)
          if (ig + q < nc) A[(m + r + ig + q) * pitch + j] = acc[q];
      }
    }
    __syncthreads();
    m += r;
#pragma unroll
    for (int n = 0; n < kPerThread; ++n) {
      const int p = tid + n * kThreads;
      if (p < T * T) {
        const int ti = p / T, tj = p - ti * T;
        const int gi = i0 + ti, gj = j0 + tj;
        const float cur = A[(R + ti) * pitch + R + tj];
        if (gi < H && gj < W) {
          const long long o = (long long)gi * W + gj;
          gb[(long long)(s + 1) * plane + o] = cur;
          db[(long long)s * plane + o] = cur - prev[n];
        }
        prev[n] = cur;
      }
    }
  }
}

}  // namespace

// taps [n_stage][k_max] (row s holds 2 radii[s] + 1 taps), tile T <= 64.
// gauss [B, n_stage + 1, H, W], dog [B, n_stage, H, W].
extern "C" int octave_cascade(const float* g0, int B, int H, int W,
                              const float* taps, const int* radii,
                              int n_stage, int k_max, int total_radius,
                              int tile, float* gauss, float* dog,
                              cudaStream_t stream) {
  if (tile < 1 || tile > kMaxTile || B < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const int side = tile + 2 * total_radius;
  const size_t bytes = ((size_t)(2 * side + kBlock) * (side | 1) +
                        (size_t)n_stage * k_max) * sizeof(float);
  const int e = device_facts::allow_shared((const void*)cascade_kernel,
                                           (long long)bytes);
  if (e != 0) return e;
  dim3 grid((W + tile - 1) / tile, (H + tile - 1) / tile, B);
  cascade_kernel<<<grid, kThreads, bytes, stream>>>(
      g0, B, H, W, taps, radii, n_stage, k_max, total_radius, tile, gauss,
      dog);
  return (int)cudaGetLastError();
}
