// Grouped SUM/COUNT of int64 columns: the Hopper kernel of the GROUP BY
// aggregate.
//
// Replaces the TPU kernel `_make_kernel_fact`, launched by
// `_mxu_chunk_totals_fact`, in query_engine_tpu/ops/pallas/group_agg.py.
// That kernel turned the scatter into a bf16 one-hot matmul over 8-bit value
// chunks because the TPU has no 64-bit integer adds; Hopper has native
// 64-bit integer atomics, so this kernel adds the words directly.
//
// Contract (the same as the TPU kernel's):
//   gid    [n]    int32; a row belongs to group gid[r] when 0 <= gid < G,
//                 any other id excludes it (-1 by convention)
//   vals   [C, n] int64, row-major: column c starts at vals + c * n
//   ok     [C, n] uint8 (torch bool): row r counts in column c iff ok != 0
//   sums   [C, G] int64, counts [C, G] int64: zero-filled by the caller,
//                 accumulated here. Sums wrap mod 2^64.
// 64-bit integer addition mod 2^64 does not depend on order, so the results
// are exact and the same bits on every run, whatever the atomic order.
// Float columns reach this kernel as fixed-point int64 planes (quantized in
// ops/group_agg.py, outside the kernel, as the JAX package does outside its
// pallas_call).
//
// What bounds it on an H100: device-memory bytes, about 8 B of value + 1 B
// of ok per row and column plus 4 B of gid per row; and, when G is small,
// contention on the atomics, since many rows hit the same few addresses.
// The design answers the contention with privatization: each block
// accumulates into its own copy of the [C, G] sums and counts in shared
// memory and flushes it to device memory once, so device-memory atomics
// are O(blocks * C * G) instead of O(n * C). When the 16 * C * G bytes of
// the private copy do not fit a block's shared memory, the rows add straight
// into device memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_config.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void add_row(
    const int32_t* __restrict__ gid, const int64_t* __restrict__ vals,
    const uint8_t* __restrict__ ok, int64_t n, int C, int G, int64_t r,
    unsigned long long* sums, unsigned long long* counts) {
  const int g = gid[r];
  if (g < 0 || g >= G) return;
  for (int c = 0; c < C; ++c) {
    const int64_t i = (int64_t)c * n + r;
    if (ok[i]) {
      atomicAdd(&sums[(int64_t)c * G + g], (unsigned long long)vals[i]);
      atomicAdd(&counts[(int64_t)c * G + g], 1ull);
    }
  }
}

// One private [C, G] table per block in dynamic shared memory.
__global__ void __launch_bounds__(kThreads) sum_count_shared(
    const int32_t* __restrict__ gid, const int64_t* __restrict__ vals,
    const uint8_t* __restrict__ ok, int64_t n, int C, int G,
    unsigned long long* __restrict__ sums,
    unsigned long long* __restrict__ counts) {
  extern __shared__ unsigned long long table[];  // sums [C*G], counts [C*G]
  const int cg = C * G;
  unsigned long long* t_sum = table;
  unsigned long long* t_cnt = table + cg;
  for (int i = threadIdx.x; i < 2 * cg; i += blockDim.x) table[i] = 0ull;
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += stride) {
    add_row(gid, vals, ok, n, C, G, r, t_sum, t_cnt);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < cg; i += blockDim.x) {
    const unsigned long long c = t_cnt[i];
    if (c != 0ull) {  // an empty slot's sum is 0 too: skip both atomics
      atomicAdd(&sums[i], t_sum[i]);
      atomicAdd(&counts[i], c);
    }
  }
}

// Rows add straight into the [C, G] tables in device memory.
__global__ void __launch_bounds__(kThreads) sum_count_global(
    const int32_t* __restrict__ gid, const int64_t* __restrict__ vals,
    const uint8_t* __restrict__ ok, int64_t n, int C, int G,
    unsigned long long* __restrict__ sums,
    unsigned long long* __restrict__ counts) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += stride) {
    add_row(gid, vals, ok, n, C, G, r, sums, counts);
  }
}

}  // namespace

// Returns a cudaError_t: 0 when every attribute query and the launch
// succeeded. Launches on `stream` and does not synchronise. The attribute
// queries are cached (launch_config.cuh), so a launch inside a CUDA graph
// capture, after a first eager launch, makes none.
extern "C" int qe_group_sum_count_i64(const int32_t* gid, const int64_t* vals,
                                      const uint8_t* ok, int64_t n, int C,
                                      int G, int64_t* sums, int64_t* counts,
                                      cudaStream_t stream) {
  static qe::LaunchCache<decltype(&sum_count_shared)> shared_cache;
  if (n <= 0 || C <= 0 || G <= 0) return (int)cudaSuccess;
  int dev = 0;
  qe::DeviceLimits lim;
  cudaError_t err = qe::device_limits(&dev, &lim);
  if (err != cudaSuccess) return (int)err;

  const int64_t row_blocks = (n + kThreads - 1) / kThreads;
  auto* s = reinterpret_cast<unsigned long long*>(sums);
  auto* c = reinterpret_cast<unsigned long long*>(counts);
  const size_t table_bytes = (size_t)C * G * 2 * sizeof(unsigned long long);
  if (table_bytes <= (size_t)lim.smem_optin) {
    int per_sm = 0;
    err = shared_cache.blocks_per_sm(sum_count_shared, dev, lim, kThreads,
                                     table_bytes, &per_sm);
    if (err != cudaSuccess) return (int)err;
    // enough blocks to fill the card, few enough that each one's table
    // zero-fill and flush stay small next to its rows
    const int64_t full = (int64_t)per_sm * lim.sms;
    const int grid = (int)(row_blocks < full ? row_blocks : full);
    sum_count_shared<<<grid, kThreads, table_bytes, stream>>>(
        gid, vals, ok, n, C, G, s, c);
  } else {
    const int64_t full = (int64_t)lim.sms * 8;
    const int grid = (int)(row_blocks < full ? row_blocks : full);
    sum_count_global<<<grid, kThreads, 0, stream>>>(gid, vals, ok, n, C, G,
                                                    s, c);
  }
  return (int)cudaGetLastError();
}
