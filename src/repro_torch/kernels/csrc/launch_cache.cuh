// Host-side facts that a persistent-grid launch needs, looked up once per
// kernel and device rather than on every launch: the SM count, the dynamic
// shared-memory attribute, and how many blocks of the kernel fit an SM at a
// given dynamic shared memory. Without it each launch makes four runtime
// calls (cudaGetDevice, cudaDeviceGetAttribute, cudaFuncSetAttribute and the
// occupancy query) where one (cudaGetDevice) will do.
//
// Each kernel instantiation keeps its own cache: a launcher declares
// `static LaunchCache cache;` and passes it with the kernel, whose block
// size is fixed.

#pragma once

#include <cuda_runtime.h>

#include <mutex>

constexpr int LAUNCH_CACHE_DEVICES = 64;

struct LaunchCache {
  struct Entry {
    int sms = 0;           // SMs of the device; 0 until looked up
    int smem_allowed = 0;  // the kernel's dynamic shared-memory attribute
    int smem = -1;         // the shared memory `per_sm` was reckoned for
    int per_sm = 0;        // resident blocks per SM at `smem`
  };
  std::mutex mu;
  Entry dev[LAUNCH_CACHE_DEVICES];
};

// Sets *blocks to the number of blocks of `kernel` (`threads` threads,
// `smem` bytes of dynamic shared memory) resident on the current device at
// once, raising the kernel's shared-memory attribute to `smem` first if it
// is lower. Returns the first runtime error, or cudaSuccess.
template <class Kernel>
cudaError_t resident_blocks(LaunchCache& cache, Kernel kernel, int threads,
                            int smem, int* blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= LAUNCH_CACHE_DEVICES) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(cache.mu);
  LaunchCache::Entry& e = cache.dev[dev];
  if (e.sms == 0) {
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    e.sms = sms;
  }
  if (smem > e.smem_allowed) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    e.smem_allowed = smem;
  }
  if (smem != e.smem) {
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
    if (err != cudaSuccess) return err;
    e.smem = smem;
    e.per_sm = per_sm;
  }
  *blocks = e.sms * e.per_sm;
  return cudaSuccess;
}
