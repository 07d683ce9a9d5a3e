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
// Bound on an H100: bytes. The seed of a 640x480 batch of 8 writes
// 11 planes of 8 x 960 x 1280 fp32 (442 MB) plus the X-pass scratch;
// the arithmetic (<= ~22 taps per pass) stays below the fp32 rate.
// Design: direct fp32 (no tensor cores, no TF32), tap tables transposed
// so a warp's table reads are contiguous (band_x) or broadcast (band_y),
// input reads coalesced along the row.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void band_x_kernel(const float* __restrict__ in, int B, int H,
                              int W_in, const int* __restrict__ start,
                              const float* __restrict__ taps,
                              const int* __restrict__ ks, int S, int K,
                              int W_out, float* __restrict__ out) {
  const long long total = (long long)B * S * H * W_out;
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const int j = (int)(idx % W_out);
    long long t = idx / W_out;
    const int h = (int)(t % H);
    t /= H;
    const int s = (int)(t % S);
    const int b = (int)(t / S);
    const float* row =
        in + ((long long)b * H + h) * W_in + start[(long long)s * W_out + j];
    const float* tp = taps + (long long)s * K * W_out + j;
    const int kn = ks[s];
    float acc = 0.f;
    for (int k = 0; k < kn; ++k) acc += tp[(long long)k * W_out] * row[k];
    out[idx] = acc;
  }
}

__global__ void band_y_kernel(const float* __restrict__ xs, int B, int S,
                              int H_in, int W, const int* __restrict__ start,
                              const float* __restrict__ taps,
                              const int* __restrict__ ks, int K, int H_out,
                              const float* __restrict__ first,
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
      prev = first[(long long)b * plane + pix];
      gb[0] = prev;
    }
    for (int s = 0; s < S; ++s) {
      const float* col =
          xs + (((long long)b * S + s) * H_in + start[(long long)s * H_out + i]) * W + j;
      const float* tp = taps + (long long)s * K * H_out + i;
      const int kn = ks[s];
      float acc = 0.f;
      for (int k = 0; k < kn; ++k)
        acc += tp[(long long)k * H_out] * col[(long long)k * W];
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

}  // namespace

extern "C" int band_x(const float* in, int B, int H, int W_in,
                      const int* start, const float* taps, const int* ks,
                      int S, int K, int W_out, float* out,
                      cudaStream_t stream) {
  const long long total = (long long)B * S * H * W_out;
  band_x_kernel<<<grid_for(total, 256), 256, 0, stream>>>(
      in, B, H, W_in, start, taps, ks, S, K, W_out, out);
  return (int)cudaGetLastError();
}

extern "C" int band_y(const float* xs, int B, int S, int H_in, int W,
                      const int* start, const float* taps, const int* ks,
                      int K, int H_out, const float* first, float* gauss,
                      float* dog, cudaStream_t stream) {
  const long long total = (long long)B * H_out * W;
  band_y_kernel<<<grid_for(total, 256), 256, 0, stream>>>(
      xs, B, S, H_in, W, start, taps, ks, K, H_out, first, gauss, dog);
  return (int)cudaGetLastError();
}
