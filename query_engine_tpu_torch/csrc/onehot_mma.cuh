// Shared pieces of the one-hot tensor-core aggregate kernels
// (agg_onehot_bytes.cu, agg_onehot_factorized.cu, agg_onehot_s8.cu): the
// exact byte-to-float and bf16 packing of the chunk operand, the int64
// flush of an accumulator, and the row grid of a launch.
//
// Each of them computes per-group chunk totals tot[g, l] = sum over the rows
// r with gid[r] == g of chunk l of row r, as the product of a one-hot group
// matrix A [groups x rows] and a chunk matrix B [rows x lanes] on the tensor
// cores (wgmma, through onehot_wgmma.cuh), and adds each accumulator into
// the int64 output with 64-bit atomics. Integer addition does not depend on
// order, so the output has the same bits on every run.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_config.cuh"

namespace qe {

constexpr uint32_t kBf16One = 0x3F80u;  // 1.0 in bfloat16

// Byte k (0..3) of x as an exact float, without a conversion instruction:
// the byte permute builds the float 2^23 + b (bits 0x4B0000bb), and
// subtracting 2^23 leaves b.
__device__ __forceinline__ float byte_as_float(uint32_t x, uint32_t k) {
  return __uint_as_float(__byte_perm(x, 0x4B000000u, k | 0x7440u)) -
         8388608.0f;
}

// Two floats that are integers 0..256 as a bf16 pair, `lo` in the low half
// (the lower k). Exact: bf16 keeps 8 significant bits, so a float's upper
// half is its value.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632u);
}

__device__ __forceinline__ uint32_t onehot_pair(bool lo, bool hi) {
  return (lo ? kBf16One : 0u) | (hi ? kBf16One << 16 : 0u);
}

// Adds a block's accumulator into the int64 total (sums wrap mod 2^64).
__device__ __forceinline__ void flush_add(int64_t* tot, int64_t i,
                                          unsigned long long v) {
  if (v != 0ull) atomicAdd(reinterpret_cast<unsigned long long*>(tot + i), v);
}

// The grid of a row-range kernel: at most the blocks the card holds at
// once (with `smem` bytes of dynamic shared memory each), each walking a
// contiguous range of whole `step`-row steps.
struct RowGrid {
  int blocks;
  int64_t rows_per_block;
};

template <typename Kernel>
cudaError_t plan_rows(LaunchCache<Kernel>& cache, Kernel kernel, int threads,
                      int64_t n, int64_t step, RowGrid* out,
                      size_t smem = 0) {
  int dev = 0;
  DeviceLimits lim;
  cudaError_t err = device_limits(&dev, &lim);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cache.blocks_per_sm(kernel, dev, lim, threads, smem, &per_sm);
  if (err != cudaSuccess) return err;
  const int64_t steps = (n + step - 1) / step;
  const int64_t full = (int64_t)per_sm * lim.sms;
  const int64_t blocks = steps < full ? steps : full;
  const int64_t steps_per_block = (steps + blocks - 1) / blocks;
  out->blocks = (int)((steps + steps_per_block - 1) / steps_per_block);
  out->rows_per_block = steps_per_block * step;
  return cudaSuccess;
}

}  // namespace qe
