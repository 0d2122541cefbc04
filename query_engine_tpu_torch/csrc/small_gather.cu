// Small-table gather of packed 32-bit words: the Hopper kernel of the FK
// join's lookup route.
//
// Replaces the TPU kernel `_kernel`, launched by `mxu_gather_words`, in
// query_engine_tpu/ops/pallas/small_gather.py. On the TPU a random gather is
// nearly element-serial, so that kernel turned it into a bf16 one-hot matmul
// over the table's byte lanes and recombined the bytes outside. Hopper
// gathers natively; this kernel reads each row's word from a copy of the
// table in shared memory.
//
// Contract (the same as the TPU kernel's):
//   idx    [n]    int32 row indices into the table
//   table  [T, W] 32-bit words, row-major (torch int32 bit patterns)
//   out    [n, W] 32-bit words: out[r, w] = table[idx[r], w] when
//                 0 <= idx[r] < T, else 0 (the -1 of an unmatched row, pad
//                 rows and any other out-of-range index give zeros)
//
// What bounds it on an H100: device-memory bytes, 4 B of idx per row and
// 4 * W B of output per row; the table (T <= 4096 rows in the engine, 16 KB
// per word) is read once per block. Each thread writes output elements
// e = r * W + w, so neighbouring threads store to neighbouring addresses.
// When the T * W * 4 bytes of the table exceed what a block can opt into,
// the blocks read it from device memory instead, where it stays in L2.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_config.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void gather_range(
    const int32_t* __restrict__ idx, const int32_t* table, int64_t n, int T,
    int W, int32_t* __restrict__ out) {
  const int64_t total = n * W;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += stride) {
    const int64_t r = W == 1 ? e : e / W;
    const int w = (int)(e - r * W);
    const int32_t i = __ldg(idx + r);
    // one unsigned compare covers i < 0 and i >= T
    out[e] = (uint32_t)i < (uint32_t)T ? table[(int64_t)i * W + w] : 0;
  }
}

// The table staged in dynamic shared memory by every block.
__global__ void __launch_bounds__(kThreads) gather_words_shared(
    const int32_t* __restrict__ idx, const int32_t* __restrict__ table,
    int64_t n, int T, int W, int32_t* __restrict__ out) {
  extern __shared__ int32_t s_table[];
  const int tw = T * W;
  for (int i = threadIdx.x; i < tw; i += blockDim.x) s_table[i] = table[i];
  __syncthreads();
  gather_range(idx, s_table, n, T, W, out);
}

// The table read from device memory (L2) when it does not fit a block.
__global__ void __launch_bounds__(kThreads) gather_words_global(
    const int32_t* __restrict__ idx, const int32_t* __restrict__ table,
    int64_t n, int T, int W, int32_t* __restrict__ out) {
  gather_range(idx, table, n, T, W, out);
}

}  // namespace

// Returns a cudaError_t: 0 when the launch succeeded. Launches on `stream`
// and does not synchronise; `out` is written in full, so the caller need not
// zero it.
extern "C" int qe_small_gather_u32(const int32_t* idx, const int32_t* table,
                                   int64_t n, int T, int W, int32_t* out,
                                   cudaStream_t stream) {
  static qe::LaunchCache<decltype(&gather_words_shared)> shared_cache;
  if (n <= 0 || W <= 0) return (int)cudaSuccess;
  int dev = 0;
  qe::DeviceLimits lim;
  cudaError_t err = qe::device_limits(&dev, &lim);
  if (err != cudaSuccess) return (int)err;

  const int64_t blocks_needed = (n * W + kThreads - 1) / kThreads;
  const size_t table_bytes = (size_t)T * W * sizeof(int32_t);
  if (T > 0 && table_bytes <= (size_t)lim.smem_optin) {
    int per_sm = 0;
    err = shared_cache.blocks_per_sm(gather_words_shared, dev, lim, kThreads,
                                     table_bytes, &per_sm);
    if (err != cudaSuccess) return (int)err;
    // resident blocks only: each one stages the table once and then strides
    // over the rows
    const int64_t full = (int64_t)per_sm * lim.sms;
    const int grid = (int)(blocks_needed < full ? blocks_needed : full);
    gather_words_shared<<<grid, kThreads, table_bytes, stream>>>(
        idx, table, n, T, W, out);
  } else {
    const int64_t full = (int64_t)lim.sms * 8;
    const int grid = (int)(blocks_needed < full ? blocks_needed : full);
    gather_words_global<<<grid, kThreads, 0, stream>>>(idx, table, n, T, W,
                                                       out);
  }
  return (int)cudaGetLastError();
}
