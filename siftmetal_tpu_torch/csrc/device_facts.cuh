// Per-device launch facts of the port's kernels, cached by device index.
//
// A kernel's dynamic shared-memory limit (cudaFuncSetAttribute), the SM
// count and a kernel's resident blocks per SM belong to one device. Each
// launcher runs under the caller's device guard (the tensor's device is
// current), reads the current device and looks the facts up here, so a
// second device gets its own attribute call and its own grid, and no
// launch asks the CUDA runtime again once a fact is known.

#pragma once

#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <tuple>

namespace device_facts {

inline std::mutex& lock() {
  static std::mutex m;
  return m;
}

// Lets `kernel` take `bytes` of dynamic shared memory on the current
// device; the attribute is set once per (kernel, device) and raised only
// when a launch asks for more than the largest so far.
inline int allow_shared(const void* kernel, long long bytes) {
  if (bytes <= 48 * 1024) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  static std::map<std::pair<const void*, int>, long long> allowed;
  std::lock_guard<std::mutex> guard(lock());
  long long& have = allowed[{kernel, dev}];
  if (have >= bytes) return 0;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return (int)err;
  have = bytes;
  return 0;
}

// The largest grid of `kernel` (with `threads` threads and `bytes` of
// dynamic shared memory a block) whose blocks are all resident at once on
// the current device: SMs x blocks per SM. Allows the shared memory first.
inline int resident_grid(const void* kernel, int threads, long long bytes,
                         int* grid) {
  int err = allow_shared(kernel, bytes);
  if (err != 0) return err;
  int dev = 0;
  if ((err = (int)cudaGetDevice(&dev)) != 0) return err;
  static std::map<std::tuple<const void*, int, int, long long>, int> grids;
  std::lock_guard<std::mutex> guard(lock());
  const auto key = std::make_tuple(kernel, dev, threads, bytes);
  const auto hit = grids.find(key);
  if (hit != grids.end()) {
    *grid = hit->second;
    return 0;
  }
  int sms = 0, per_sm = 0;
  err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != 0) return err;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, threads, (size_t)bytes);
  if (err != 0) return err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  grids[key] = *grid = sms * per_sm;
  return 0;
}

}  // namespace device_facts
