// Banded separable Gaussian passes: the pyramid kernel of the port.
//
// Replaces the TPU kernel siftmetal_tpu/ops/pallas/pyramid.py
// _oneshot_kernel (through seed_octave_pallas and octave_oneshot_pallas)
// and siftmetal_tpu/ops/pallas/blur.py _blur_kernel (blur_pallas).
//
// Every 1-D pass of every slice is a banded matrix with the half-sample
// reflection folded in (and, for the seed, the 2x bilinear upsample
// composed in), given as a table: for output i, taps[s][k][i] applied to
// input start[s][i] + k, k < ks[s]. One table format serves the fused
// seed, the one-shot octaves and the cascade blurs.
//
// band_x: in [B, H, W_in] -> out [B, S, H, W_out] (all S slices read the
//         same input rows; one thread per output sample).
// band_y: xs [B, S, H_in, W] -> gauss and DoG. One thread per (b, i, j)
//         walks the S slices in order and writes each Gaussian once; the
//         DoG of consecutive slices is formed in registers, so no slice
//         is read back. With `first` (the one-shot octave form) slice 0
//         is `first` itself, copied into gauss[:, 0], and dog[s] =
//         g[s+1] - g[s] starts from it.
//
// bf16 forms (the fast preset's blur chain, replacing _oneshot_kernel on
// a bf16 input and the bf16 branch of ops/gaussian.py blur): band_x reads
// bf16 exactly and accumulates in fp32; it writes fp32 for the seed and
// the one-shot octave (no rounding between the passes) or bf16 for the
// incremental cascade (one round-to-nearest-even after the fp32 sum).
// That bf16-writing pass multiplies and adds with separate roundings
// (__fmul_rn/__fadd_rn, tap 0 first), as the plain PyTorch version does,
// so both round the same fp32 sum and agree bit for bit; with contracted
// FMAs a last-bit difference would now and then flip a bf16 rounding,
// 2^-8 relative. band_y reads that bf16 scratch, and in the one-shot form
// a bf16 `first`, upcast; every Gaussian and DoG it writes is fp32.
//
// Bound on an H100: bytes. The seed of a 640x480 batch of 8 writes
// 11 planes of 8 x 960 x 1280 fp32 (442 MB) plus the X-pass scratch;
// the arithmetic (<= ~22 taps per pass) stays below the fp32 rate.
// Design: direct fp32 (no tensor cores, no TF32), tap tables transposed
// so a warp's table reads are contiguous (band_x) or broadcast (band_y),
// input reads coalesced along the row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// TOut = float: contracted FMAs (the fp32 pyramid's arithmetic).
// TOut = bf16: separate roundings, then one round-to-nearest-even.
template <typename TIn, typename TOut>
__global__ void band_x_kernel(const TIn* __restrict__ in, int B, int H,
                              int W_in, const int* __restrict__ start,
                              const float* __restrict__ taps,
                              const int* __restrict__ ks, int S, int K,
                              int W_out, TOut* __restrict__ out) {
  const long long total = (long long)B * S * H * W_out;
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const int j = (int)(idx % W_out);
    long long t = idx / W_out;
    const int h = (int)(t % H);
    t /= H;
    const int s = (int)(t % S);
    const int b = (int)(t / S);
    const TIn* row =
        in + ((long long)b * H + h) * W_in + start[(long long)s * W_out + j];
    const float* tp = taps + (long long)s * K * W_out + j;
    const int kn = ks[s];
    float acc = 0.f;
    if constexpr (sizeof(TOut) == sizeof(float)) {
      for (int k = 0; k < kn; ++k)
        acc += tp[(long long)k * W_out] * to_f32(row[k]);
      out[idx] = acc;
    } else {
      for (int k = 0; k < kn; ++k)
        acc = __fadd_rn(acc, __fmul_rn(tp[(long long)k * W_out], to_f32(row[k])));
      out[idx] = __float2bfloat16_rn(acc);
    }
  }
}

template <typename TXs, typename TFirst>
__global__ void band_y_kernel(const TXs* __restrict__ xs, int B, int S,
                              int H_in, int W, const int* __restrict__ start,
                              const float* __restrict__ taps,
                              const int* __restrict__ ks, int K, int H_out,
                              const TFirst* __restrict__ first,
                              float* __restrict__ gauss,
                              float* __restrict__ dog) {
  const long long total = (long long)B * H_out * W;
  const long long plane = (long long)H_out * W;
  const int g0 = first ? 1 : 0;
  const int G = S + g0;
  const int D = first ? S : S - 1;
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const int j = (int)(idx % W);
    const long long t = idx / W;
    const int i = (int)(t % H_out);
    const int b = (int)(t / H_out);
    const long long pix = (long long)i * W + j;
    float* gb = gauss + (long long)b * G * plane + pix;
    float* db = dog ? dog + (long long)b * D * plane + pix : nullptr;
    float prev = 0.f;
    if (first) {
      prev = to_f32(first[(long long)b * plane + pix]);
      gb[0] = prev;
    }
    for (int s = 0; s < S; ++s) {
      const TXs* col =
          xs + (((long long)b * S + s) * H_in + start[(long long)s * H_out + i]) * W + j;
      const float* tp = taps + (long long)s * K * H_out + i;
      const int kn = ks[s];
      float acc = 0.f;
      for (int k = 0; k < kn; ++k)
        acc += tp[(long long)k * H_out] * to_f32(col[(long long)k * W]);
      gb[(long long)(s + g0) * plane] = acc;
      if (db) {
        if (first)
          db[(long long)s * plane] = acc - prev;
        else if (s > 0)
          db[(long long)(s - 1) * plane] = acc - prev;
      }
      prev = acc;
    }
  }
}

int grid_for(long long total, int threads) {
  long long blocks = (total + threads - 1) / threads;
  const long long cap = 132LL * 64;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  return (int)blocks;
}

typedef __nv_bfloat16 bf16;

}  // namespace

// in_bf16 / out_bf16 say which of `in` and `out` hold bf16 (else fp32);
// an fp32 input with a bf16 output is not a form the pyramid has.
extern "C" int band_x(const void* in, int in_bf16, int B, int H, int W_in,
                      const int* start, const float* taps, const int* ks,
                      int S, int K, int W_out, void* out, int out_bf16,
                      cudaStream_t stream) {
  const long long total = (long long)B * S * H * W_out;
  const int g = grid_for(total, 256);
  if (!in_bf16 && !out_bf16)
    band_x_kernel<float, float><<<g, 256, 0, stream>>>(
        (const float*)in, B, H, W_in, start, taps, ks, S, K, W_out,
        (float*)out);
  else if (in_bf16 && !out_bf16)
    band_x_kernel<bf16, float><<<g, 256, 0, stream>>>(
        (const bf16*)in, B, H, W_in, start, taps, ks, S, K, W_out,
        (float*)out);
  else if (in_bf16 && out_bf16)
    band_x_kernel<bf16, bf16><<<g, 256, 0, stream>>>(
        (const bf16*)in, B, H, W_in, start, taps, ks, S, K, W_out,
        (bf16*)out);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// xs_bf16 / first_bf16 say which of `xs` and `first` hold bf16. A bf16
// scratch comes only from the cascade blur, which has no `first`.
extern "C" int band_y(const void* xs, int xs_bf16, int B, int S, int H_in,
                      int W, const int* start, const float* taps,
                      const int* ks, int K, int H_out, const void* first,
                      int first_bf16, float* gauss, float* dog,
                      cudaStream_t stream) {
  const long long total = (long long)B * H_out * W;
  const int g = grid_for(total, 256);
  if (!xs_bf16 && !first_bf16)
    band_y_kernel<float, float><<<g, 256, 0, stream>>>(
        (const float*)xs, B, S, H_in, W, start, taps, ks, K, H_out,
        (const float*)first, gauss, dog);
  else if (!xs_bf16 && first_bf16)
    band_y_kernel<float, bf16><<<g, 256, 0, stream>>>(
        (const float*)xs, B, S, H_in, W, start, taps, ks, K, H_out,
        (const bf16*)first, gauss, dog);
  else if (xs_bf16 && !first)
    band_y_kernel<bf16, float><<<g, 256, 0, stream>>>(
        (const bf16*)xs, B, S, H_in, W, start, taps, ks, K, H_out,
        (const float*)nullptr, gauss, dog);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
