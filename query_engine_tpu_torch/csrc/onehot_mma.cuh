// Shared pieces of the one-hot tensor-core aggregate kernels
// (agg_onehot_bytes.cu, agg_onehot_factorized.cu, agg_onehot_s8.cu).
//
// Each of them computes per-group chunk totals tot[g, l] = sum over the rows
// r with gid[r] == g of chunk l of row r, as the product of a one-hot group
// matrix A [groups x rows] and a chunk matrix B [rows x lanes] on the tensor
// cores (mma.sync in agg_onehot_factorized.cu, wgmma through
// onehot_wgmma.cuh in the other two), and adds each block's totals into the
// int64 output with 64-bit atomics. Integer addition does not depend on
// order, so the output has the same bits on every run.
//
// Fragment layout of mma.m16n8k16 bf16 (PTX ISA, "Matrix fragments for
// mma.m16n8k16"): with lane = 4 * grp + tig (grp = lane / 4, tig = lane % 4)
//   A regs {0,1,2,3} = rows {grp, grp+8, grp, grp+8} x k pairs {2tig, 2tig,
//                      2tig+8, 2tig+8} (+0 low half, +1 high)
//   B regs {0,1}     = k pairs {2tig, 2tig+8} (+0, +1), col grp
//   accumulators {0,1,2,3} = (row grp, col 2tig), (grp, 2tig+1),
//                      (grp+8, 2tig), (grp+8, 2tig+1)
// So in a k16 step each thread needs rows 2tig, 2tig+1, 2tig+8, 2tig+9 of the
// step: the same rows feed its A and its B fragments.

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

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One row of the three input planes; rows at or past `end` read as
// excluded (gid -1, value 0), so the ragged edge is never read past.
struct Row {
  int32_t gid;
  uint32_t lo, hi;
};

__device__ __forceinline__ Row load_row(const int32_t* __restrict__ gid,
                                        const uint32_t* __restrict__ vlo,
                                        const uint32_t* __restrict__ vhi,
                                        int64_t r, int64_t end) {
  if (r >= end) return Row{-1, 0u, 0u};
  return Row{__ldg(gid + r), __ldg(vlo + r), __ldg(vhi + r)};
}

// Rows r and r + 1 (r even; the planes 16-byte aligned), as 8-byte loads
// when both lie before `end`.
__device__ __forceinline__ void load_pair(const int32_t* __restrict__ gid,
                                          const uint32_t* __restrict__ vlo,
                                          const uint32_t* __restrict__ vhi,
                                          int64_t r, int64_t end, Row* out) {
  if (r + 1 < end) {
    const int2 g = __ldg(reinterpret_cast<const int2*>(gid + r));
    const uint2 l = __ldg(reinterpret_cast<const uint2*>(vlo + r));
    const uint2 h = __ldg(reinterpret_cast<const uint2*>(vhi + r));
    out[0] = Row{g.x, l.x, h.x};
    out[1] = Row{g.y, l.y, h.y};
  } else {
    out[0] = load_row(gid, vlo, vhi, r, end);
    out[1] = load_row(gid, vlo, vhi, r + 1, end);
  }
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
