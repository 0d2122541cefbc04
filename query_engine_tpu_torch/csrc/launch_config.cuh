// Launch-time queries of the port's kernels, made once per process.
//
// A launch wrapper needs the card's SM count, its per-block opt-in shared
// memory, a kernel's dynamic shared-memory attribute and its occupancy.
// Asked on every call, those queries would also run while PyTorch captures a
// compiled query into a CUDA graph. Cached here, the first (eager) run of a
// query makes them, and a capture after it calls nothing but the launch and
// cudaGetLastError.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace qe {

constexpr int kMaxDevices = 64;

struct DeviceLimits {
  int sms = 0;
  int smem_optin = 0;  // bytes of dynamic shared memory a block can opt into
};

// The current device and its limits.
inline cudaError_t device_limits(int* dev, DeviceLimits* out) {
  static DeviceLimits cache[kMaxDevices];
  static bool have[kMaxDevices] = {};
  cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return err;
  if (*dev < 0 || *dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!have[*dev]) {
    DeviceLimits l;
    err = cudaDeviceGetAttribute(&l.sms, cudaDevAttrMultiProcessorCount, *dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &l.smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, *dev);
    if (err != cudaSuccess) return err;
    cache[*dev] = l;
    have[*dev] = true;
  }
  *out = cache[*dev];
  return cudaSuccess;
}

// Per kernel: the opt-in shared-memory attribute, set once per device to the
// device's maximum, and the resident blocks per SM for a few recent dynamic
// shared-memory sizes.
template <typename Kernel>
struct LaunchCache {
  static constexpr int kSlots = 16;
  bool smem_set[kMaxDevices] = {};
  int slot_dev[kSlots];
  size_t slot_bytes[kSlots];
  int slot_blocks[kSlots];
  int used = 0;
  int next = 0;

  // Blocks of `threads` threads with `smem` bytes that one SM holds at once
  // (at least 1); raises the kernel's shared-memory limit first if needed.
  cudaError_t blocks_per_sm(Kernel kernel, int dev, const DeviceLimits& l,
                            int threads, size_t smem, int* out) {
    if (smem > 48 * 1024 && !smem_set[dev]) {
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, l.smem_optin);
      if (err != cudaSuccess) return err;
      smem_set[dev] = true;
    }
    for (int i = 0; i < used; ++i) {
      if (slot_dev[i] == dev && slot_bytes[i] == smem) {
        *out = slot_blocks[i];
        return cudaSuccess;
      }
    }
    int per_sm = 0;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, threads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) per_sm = 1;
    const int i = used < kSlots ? used++ : (next++ % kSlots);
    slot_dev[i] = dev;
    slot_bytes[i] = smem;
    slot_blocks[i] = per_sm;
    *out = per_sm;
    return cudaSuccess;
  }
};

}  // namespace qe
