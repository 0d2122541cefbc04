// Grouped SUM/COUNT chunk totals as a factorized one-hot bf16 product on
// the tensor cores: the Hopper kernels of the v4 and v5 aggregate probes.
//
// Replaces the TPU kernels `_kernel_v4` (launched by `_run_v4`) and
// `_kernel_v5` (launched by `_run_v5`) in benchmarks/probe_agg_variants.py.
// A group id splits as gid = ghi * 128 + glo (ghi 0..7, 1024 groups). A is
// the one-hot of glo [128 x rows]; B [rows x 72] holds a row's 9 lanes
// (bytes 0..7 and a count of 1) only in the 8 columns of its ghi, zero in
// the others. D = A x B is [128 x 72] instead of [1024 x 9]: 72 mma.sync
// m16n8k16 per 16 rows instead of 128. Column 8 * k + ghi of D is lane k of
// group ghi * 128 + glo, so n8 tile k is chunk k and its column is ghi.
//
// Contract (wrapper: query_engine_tpu_torch/ops/agg_variants.py):
//   gid [n] int32; row r belongs to group gid[r] when 0 <= gid < 1024
//   vlo, vhi [n] uint32: the low and high words of the row's 64-bit value
//   tot [1024, 9] int64, zero-filled by the caller: bytes 0..7, count
//
// A block of 8 warps covers the 128 glo values, one m16 tile per warp, and
// each warp runs the 9 n8 tiles. Two instantiations, as on the TPU:
//   v4 (kStaged): the block builds each 64-row tile's A and B once in shared
//      memory, and the warps load their fragments with ldmatrix;
//   v5: every thread builds its fragments in registers, in the PTX fragment
//      layout, from the rows it loads itself, with no trip through shared
//      memory (the counterpart of v5's "no relayout"); the B build is
//      repeated by each of the 8 warps.
//
// Exactness: bytes and 1.0 are exact in bf16, products exact in f32, and
// each block moves its f32 accumulators (exact below 2^24; 255 * 65,536 <
// 2^24) into the int64 total at least every 65,536 rows.
//
// What bounds it on an H100: the tensor-core work (2 * 128 * 72 flops a
// row) and the integer work of building B (9 lanes, masked by ghi); bytes
// are 12 B a row. v4 trades the repeated B build for shared-memory stores
// and ldmatrix loads.

#include <cuda_runtime.h>
#include <stdint.h>

#include "onehot_mma.cuh"

namespace {

constexpr int kLanes = 9;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kStep = 16;       // rows per mma (k16)
constexpr int kTileRows = 64;   // rows per shared-memory tile (v4)
constexpr int kPad = kTileRows + 8;  // row stride in bf16: 144 B, so the 8
                                     // addresses of an ldmatrix hit 8
                                     // distinct 16-byte bank groups
constexpr int64_t kFlushRows = 65536;

// Chunk k of a row, as an exact float, for ghi column `col`: byte k (k <
// 8) or the count 1 (k == 8) when the row's ghi is col, else 0. gid < 0 has
// ghi < 0 and gid >= 1024 has ghi >= 8, so an excluded row matches no
// column.
__device__ __forceinline__ float chunk_in_col(const qe::Row& w, int k,
                                              int col) {
  const uint32_t on = (w.gid >> 7) == col ? ~0u : 0u;
  if (k == 8) return on ? 1.f : 0.f;
  return qe::byte_as_float((k < 4 ? w.lo : w.hi) & on, k & 3);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2],
                                            const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(s));
}

// v4 at 4 resident blocks (<= 64 registers) and v5 with the registers it
// wants were the faster choices on an H100 (PERF.md)
template <bool kStaged>
__global__ void __launch_bounds__(kThreads, kStaged ? 4 : 1) onehot_factorized(
    const int32_t* __restrict__ gid, const uint32_t* __restrict__ vlo,
    const uint32_t* __restrict__ vhi, int64_t n, int64_t rows_per_block,
    int64_t* __restrict__ tot) {
  // v4's tiles: A_s[glo][row] (the one-hot, m-major as mma's A), B_s[8k +
  // ghi][row] (B transposed, n-major as mma's "col" B wants); rows of the
  // tile in the fast dimension, so ldmatrix needs no transpose
  __shared__ __align__(16) uint16_t A_s[kStaged ? 128 : 1][kPad];
  __shared__ __align__(16) uint16_t B_s[kStaged ? 8 * kLanes : 1][kPad];
  __shared__ qe::Row R_s[kStaged ? kTileRows : 1];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  const int64_t begin = (int64_t)blockIdx.x * rows_per_block;
  const int64_t stop = begin + rows_per_block;
  const int64_t end = stop < n ? stop : n;

  float acc[kLanes][4];
  auto zero = [&]() {
#pragma unroll
    for (int k = 0; k < kLanes; ++k)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[k][q] = 0.f;
  };
  auto flush = [&]() {
#pragma unroll
    for (int k = 0; k < kLanes; ++k)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int glo = 16 * warp + grp + 8 * (q >> 1);
        const int ghi = 2 * tig + (q & 1);
        qe::flush_add(tot, (int64_t)(ghi * 128 + glo) * kLanes + k,
                      (unsigned long long)acc[k][q]);
      }
  };
  zero();
  int64_t since_flush = 0;
  const int glo_lo = 16 * warp + grp, glo_hi = glo_lo + 8;

  if constexpr (kStaged) {
    for (int64_t t0 = begin; t0 < end; t0 += kTileRows) {
      if (threadIdx.x < kTileRows)
        R_s[threadIdx.x] = qe::load_row(gid, vlo, vhi, t0 + threadIdx.x, end);
      __syncthreads();
      // A_s: 128 glo x 8 groups of 8 rows, one 16-byte store each
      for (int c = threadIdx.x; c < 128 * (kTileRows / 8); c += kThreads) {
        const int glo = c >> 3, r8 = (c & 7) * 8;
        uint32_t v[4];
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const qe::Row& x = R_s[r8 + 2 * p];
          const qe::Row& y = R_s[r8 + 2 * p + 1];
          // ghi is checked in B; the glo of gid -1 (127) meets a zero B
          v[p] = qe::onehot_pair((x.gid & 127) == glo, (y.gid & 127) == glo);
        }
        *reinterpret_cast<uint4*>(&A_s[glo][r8]) =
            make_uint4(v[0], v[1], v[2], v[3]);
      }
      // B_s: 72 columns x 8 groups of 8 rows
      for (int c = threadIdx.x; c < 8 * kLanes * (kTileRows / 8);
           c += kThreads) {
        const int col = c >> 3, r8 = (c & 7) * 8;
        const int k = col >> 3, ghi = col & 7;
        uint32_t v[4];
#pragma unroll
        for (int p = 0; p < 4; ++p)
          v[p] = qe::pack_bf16(chunk_in_col(R_s[r8 + 2 * p], k, ghi),
                               chunk_in_col(R_s[r8 + 2 * p + 1], k, ghi));
        *reinterpret_cast<uint4*>(&B_s[col][r8]) =
            make_uint4(v[0], v[1], v[2], v[3]);
      }
      __syncthreads();
      const int mi = lane >> 3, mr = lane & 7;
#pragma unroll
      for (int s = 0; s < kTileRows / kStep; ++s) {
        uint32_t a[4];
        // matrices 0..3: (glo +0, k +0), (+8, +0), (+0, +8), (+8, +8)
        ldmatrix_x4(a, &A_s[16 * warp + 8 * (mi & 1) + mr]
                           [kStep * s + 8 * (mi >> 1)]);
#pragma unroll
        for (int k = 0; k < kLanes - 1; k += 2) {
          // matrices 0..3: (tile k, k +0), (k, +8), (k+1, +0), (k+1, +8)
          uint32_t b4[4];
          ldmatrix_x4(b4, &B_s[8 * (k + (mi >> 1)) + mr]
                              [kStep * s + 8 * (mi & 1)]);
          const uint32_t b0[2] = {b4[0], b4[1]};
          const uint32_t b1[2] = {b4[2], b4[3]};
          qe::mma_bf16_16816(acc[k], a, b0);
          qe::mma_bf16_16816(acc[k + 1], a, b1);
        }
        uint32_t b8[2];  // tile 8 (the count); lanes 16..31's addresses
                         // are ignored by .x2 but kept in bounds
        ldmatrix_x2(b8, &B_s[8 * (kLanes - 1) + mr]
                            [kStep * s + 8 * (mi & 1)]);
        qe::mma_bf16_16816(acc[kLanes - 1], a, b8);
      }
      since_flush += kTileRows;
      if (since_flush == kFlushRows) {
        flush();
        zero();
        since_flush = 0;
      }
      __syncthreads();  // the tile is consumed before the next overwrites it
    }
  } else {
    // this thread's rows of a step at r0: r0 + 2tig + {0, 1, 8, 9}, loaded
    // one step ahead so the loads overlap the previous step's work
    qe::Row nw[4];
    qe::load_pair(gid, vlo, vhi, begin + 2 * tig, end, nw);
    qe::load_pair(gid, vlo, vhi, begin + 2 * tig + 8, end, nw + 2);
    for (int64_t r0 = begin; r0 < end; r0 += kStep) {
      qe::Row w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) w[i] = nw[i];
      qe::load_pair(gid, vlo, vhi, r0 + kStep + 2 * tig, end, nw);
      qe::load_pair(gid, vlo, vhi, r0 + kStep + 2 * tig + 8, end, nw + 2);
      uint32_t a[4];
      int glo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) glo[i] = w[i].gid & 127;
      a[0] = qe::onehot_pair(glo[0] == glo_lo, glo[1] == glo_lo);
      a[1] = qe::onehot_pair(glo[0] == glo_hi, glo[1] == glo_hi);
      a[2] = qe::onehot_pair(glo[2] == glo_lo, glo[3] == glo_lo);
      a[3] = qe::onehot_pair(glo[2] == glo_hi, glo[3] == glo_hi);
      // B column grp of every n8 tile holds the rows whose ghi is grp: mask
      // each row's words once, then its chunks
      uint32_t lo[4], hi[4];
      bool on[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        on[i] = (w[i].gid >> 7) == grp;
        lo[i] = on[i] ? w[i].lo : 0u;
        hi[i] = on[i] ? w[i].hi : 0u;
      }
#pragma unroll
      for (int k = 0; k < kLanes; ++k) {
        uint32_t b[2];
        if (k == 8) {
          b[0] = qe::onehot_pair(on[0], on[1]);
          b[1] = qe::onehot_pair(on[2], on[3]);
        } else {
          const uint32_t* x = k < 4 ? lo : hi;
          b[0] = qe::pack_bf16(qe::byte_as_float(x[0], k & 3),
                               qe::byte_as_float(x[1], k & 3));
          b[1] = qe::pack_bf16(qe::byte_as_float(x[2], k & 3),
                               qe::byte_as_float(x[3], k & 3));
        }
        qe::mma_bf16_16816(acc[k], a, b);
      }
      since_flush += kStep;
      if (since_flush == kFlushRows) {
        flush();
        zero();
        since_flush = 0;
      }
    }
  }
  flush();
}

}  // namespace

// Returns a cudaError_t: 0 when the launch succeeded. `staged` 1 runs v4
// (shared-memory tiles and ldmatrix), 0 runs v5 (fragments in registers).
// Launches on `stream` and does not synchronise.
extern "C" int qe_onehot_factorized(const int32_t* gid, const uint32_t* vlo,
                                    const uint32_t* vhi, int64_t n,
                                    int staged, int64_t* tot,
                                    cudaStream_t stream) {
  static qe::LaunchCache<decltype(&onehot_factorized<true>)> cache_v4;
  static qe::LaunchCache<decltype(&onehot_factorized<false>)> cache_v5;
  if (n <= 0) return (int)cudaSuccess;
  qe::RowGrid grid;
  cudaError_t err;
  if (staged) {
    err = qe::plan_rows(cache_v4, &onehot_factorized<true>, kThreads, n,
                        kTileRows, &grid);
    if (err != cudaSuccess) return (int)err;
    onehot_factorized<true><<<grid.blocks, kThreads, 0, stream>>>(
        gid, vlo, vhi, n, grid.rows_per_block, tot);
  } else {
    err = qe::plan_rows(cache_v5, &onehot_factorized<false>, kThreads, n,
                        kStep, &grid);
    if (err != cudaSuccess) return (int)err;
    onehot_factorized<false><<<grid.blocks, kThreads, 0, stream>>>(
        gid, vlo, vhi, n, grid.rows_per_block, tot);
  }
  return (int)cudaGetLastError();
}
