// Grouped SUM/COUNT chunk totals as a one-hot int8 product on the tensor
// cores, over 4-bit chunks: the Hopper kernel of the s8 nibble probe.
//
// Replaces the TPU kernel `_kernel_s8`, launched by `grouped_sum_count_s8`,
// in benchmarks/probe_int8_mxu.py. There the MXU multiplied an s8 one-hot
// [rows x 1024 groups] by the rows' 16 nibbles and a count lane with s32
// accumulation; here mma.sync.m16n8k32 (s8 x s8 -> s32) does the same.
//
// Contract (wrapper: query_engine_tpu_torch/ops/agg_variants.py):
//   gid [n] int32; row r belongs to group gid[r] when 0 <= gid < G <= 1024
//   vlo, vhi [n] uint32: the low and high words of the row's 64-bit value
//   tot [G, 17] int64, zero-filled by the caller: nibbles 0..15, count
//
// Layout: D[group, lane] = A[group, row] x B[row, lane]. A block of 16 warps
// covers 1024 groups, 64 per warp (4 m16 tiles); the 17 lanes are three n8
// tiles (nibbles of vlo; nibbles of vhi; the count). Each thread builds its
// fragments in registers from the 8 rows of each 32-row step that the
// fragment layout gives it (onehot_mma.cuh). Warps whose groups all lie at
// or past G skip the work.
//
// Exactness: a nibble (0..15) and 1 are exact in s8, and an s32 accumulator
// stays exact while 15 * rows < 2^31. Each block moves its accumulators into
// the int64 total at least every 2^24 rows (15 * 2^24 < 2^31), so the sums
// are exact at any n, not only up to the JAX design's 2^27 rows.
//
// What bounds it on an H100: the tensor-core work (2 * 1024 * 24 int8 ops a
// row, at twice the bf16 rate) and the integer work of building the one-hot
// fragments (per thread and 32-row step: 8 slot bits, then a shift and a
// mask per A register); bytes are 12 B a row.

#include <cuda_runtime.h>
#include <stdint.h>

#include "onehot_mma.cuh"

namespace {

constexpr int kGroups = 1024;
constexpr int kLanes = 17;
constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kTiles = kGroups / kWarps / 16;  // m16 tiles per warp
constexpr int kStep = 32;                      // rows per mma (k32)
constexpr int64_t kFlushRows = int64_t(1) << 24;

__global__ void __launch_bounds__(kThreads) onehot_s8(
    const int32_t* __restrict__ gid, const uint32_t* __restrict__ vlo,
    const uint32_t* __restrict__ vhi, int64_t n, int G,
    int64_t rows_per_block, int64_t* __restrict__ tot) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  const int g_base = warp * (kTiles * 16);
  if (g_base >= G) return;  // the whole warp: no mma is left half-issued
  const int64_t begin = (int64_t)blockIdx.x * rows_per_block;
  const int64_t stop = begin + rows_per_block;
  const int64_t end = stop < n ? stop : n;

  int acc[kTiles][3][4];
  auto zero = [&]() {
#pragma unroll
    for (int t = 0; t < kTiles; ++t)
#pragma unroll
      for (int j = 0; j < 3; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[t][j][q] = 0;
  };
  auto flush = [&]() {
#pragma unroll
    for (int t = 0; t < kTiles; ++t)
#pragma unroll
      for (int j = 0; j < 3; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int g = g_base + 16 * t + grp + 8 * (q >> 1);
          const int l = 8 * j + 2 * tig + (q & 1);
          if (g < G && l < kLanes)
            qe::flush_add(tot, (int64_t)g * kLanes + l,
                          (unsigned long long)(uint32_t)acc[t][j][q]);
        }
  };
  zero();
  int64_t since_flush = 0;
  for (int64_t r0 = begin; r0 < end; r0 += kStep) {
    // this thread's rows: 4tig + {0..3} (i = 0..3), 4tig + 16 + {0..3}
    qe::Row w[8];
    qe::load_quad(gid, vlo, vhi, r0 + 4 * tig, end, w);
    qe::load_quad(gid, vlo, vhi, r0 + 4 * tig + 16, end, w + 4);
    // B: n-tile 0 lane grp = nibble grp of vlo, n-tile 1 = nibble grp of
    // vhi, n-tile 2 lane 16 (grp 0) = the count; byte i of a register is
    // row i
    uint32_t b[3][2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t lo = 0, hi = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const qe::Row& x = w[4 * h + i];
        lo |= ((x.lo >> (4 * grp)) & 0xFu) << (8 * i);
        hi |= ((x.hi >> (4 * grp)) & 0xFu) << (8 * i);
      }
      b[0][h] = lo;
      b[1][h] = hi;
      b[2][h] = grp == 0 ? 0x01010101u : 0u;
    }
    // A: row i is 1 in A row g_base + grp + 8s (s = 2t + half) when its gid
    // is that group: slot bit s of row i, gathered into byte i of k0 (rows
    // 0..3) and k1 (rows 4..7), so one shift and mask per register gives
    // its four 0/1 bytes. Rows with gid < 0 or past this warp's groups set
    // no bit; those in [G, 1024) land in groups that the flush drops.
    uint32_t k0 = 0, k1 = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      k0 |= qe::slot_bit(w[i].gid - g_base - grp, 2 * kTiles) << (8 * i);
      k1 |= qe::slot_bit(w[4 + i].gid - g_base - grp, 2 * kTiles) << (8 * i);
    }
#pragma unroll
    for (int t = 0; t < kTiles; ++t) {
      uint32_t a[4];
      a[0] = (k0 >> (2 * t)) & 0x01010101u;
      a[1] = (k0 >> (2 * t + 1)) & 0x01010101u;
      a[2] = (k1 >> (2 * t)) & 0x01010101u;
      a[3] = (k1 >> (2 * t + 1)) & 0x01010101u;
#pragma unroll
      for (int j = 0; j < 3; ++j) qe::mma_s8_16832(acc[t][j], a, b[j]);
    }
    since_flush += kStep;
    if (since_flush == kFlushRows) {
      flush();
      zero();
      since_flush = 0;
    }
  }
  flush();
}

}  // namespace

// Returns a cudaError_t: 0 when the launch succeeded. Launches on `stream`
// and does not synchronise.
extern "C" int qe_onehot_s8(const int32_t* gid, const uint32_t* vlo,
                            const uint32_t* vhi, int64_t n, int G,
                            int64_t* tot, cudaStream_t stream) {
  static qe::LaunchCache<decltype(&onehot_s8)> cache;
  if (n <= 0 || G <= 0) return (int)cudaSuccess;
  if (G > kGroups) return (int)cudaErrorInvalidValue;
  qe::RowGrid grid;
  cudaError_t err = qe::plan_rows(cache, &onehot_s8, kThreads, n, kStep,
                                  &grid);
  if (err != cudaSuccess) return (int)err;
  onehot_s8<<<grid.blocks, kThreads, 0, stream>>>(gid, vlo, vhi, n, G,
                                                  grid.rows_per_block, tot);
  return (int)cudaGetLastError();
}
