// Set a kernel's dynamic shared-memory limit once per device and size, not
// on every launch. Included by the launchers of decode_attention.cu and
// flash_attention.cu; build.py hashes this header into their libraries'
// names, so an edit here rebuilds them.
#pragma once
#include <atomic>
#include <cuda_runtime.h>

constexpr int SMEM_MAX_DEVICES = 64;

// Raise fn's dynamic shared-memory limit to `bytes` and ask for the largest
// shared-memory carveout, unless this device already has a limit of at
// least `bytes`. `done` (SMEM_MAX_DEVICES entries, one static array per
// kernel instance) holds, per device, the largest size set so far; a
// device index past the array is set on every call.
template <typename F>
cudaError_t allow_smem(F* fn, std::atomic<int>* done, int bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < SMEM_MAX_DEVICES && done[dev].load() >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fn,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && dev < SMEM_MAX_DEVICES) {
    int prev = done[dev].load();
    while (prev < bytes && !done[dev].compare_exchange_weak(prev, bytes)) {
    }
  }
  return err;
}
