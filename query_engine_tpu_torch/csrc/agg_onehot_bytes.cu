// Grouped SUM/COUNT chunk totals as a full one-hot bf16 product on the
// tensor cores: the Hopper kernel of the v1 and v2 aggregate probes.
//
// Replaces the TPU kernels `_kernel_v1` and `_kernel_v2`, both launched by
// `_run_byte_kernel`, in benchmarks/probe_agg_variants.py. There the MXU
// multiplied a bf16 one-hot [rows x 1024 groups] by the rows' byte chunks;
// here mma.sync.m16n8k16 (bf16 in, f32 accumulate) does the same product.
//
// Contract (wrapper: query_engine_tpu_torch/ops/agg_variants.py):
//   gid   [n] int32; row r belongs to group gid[r] when 0 <= gid < 1024
//   vlo, vhi [n] uint32: the low and high words of the row's 64-bit value
//   flags [n] uint32 (v1 only; bits 0..2 summed as lanes 9..11)
//   tot   [1024, L] int64, zero-filled by the caller: L = 12 (v1: bytes
//         0..7, count, 3 flag bits) or 9 (v2: bytes 0..7, count)
//
// Layout: D[group, lane] = A[group, row] x B[row, lane]. A block of 8 warps
// covers the 1024 groups, 128 per warp (8 m16 tiles); the 16 lanes are two n8
// tiles (bytes 0..7; count and flags). Each thread builds its A (one-hot)
// and B (byte) fragments in registers from the 4 rows of each 16-row step
// that the fragment layout gives it (onehot_mma.cuh), loaded one step
// ahead; bytes become bf16 by a byte permute and a float subtract, with no
// conversion instruction.
//
// Exactness: a byte (0..255) and 1.0 are exact in bf16, and the products are
// exact in f32. An f32 accumulator holds integers exactly below 2^24, and
// 255 * 65,536 < 2^24, so each block moves its accumulators into the int64
// total at least every 65,536 rows (kFlushRows).
//
// What bounds it on an H100: not bytes (12-16 B a row) but the tensor-core
// work of a 1024-wide one-hot, 2 * 1024 * 16 flops a row, and the integer
// instructions that build the fragments (per thread and 16-row step: 4
// slot bits, then a shift, a mask and a multiply per A register). The
// design keeps everything in registers; the rows each warp reads are the
// same for all 8 warps of a block and come from L1.

#include <cuda_runtime.h>
#include <stdint.h>

#include "onehot_mma.cuh"

namespace {

constexpr int kGroups = 1024;
// 8 warps of 8 m16 tiles: each thread's B fragments (the same in every
// warp) serve 8 tiles, and 2 blocks fit an SM at <= 128 registers
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTiles = kGroups / kWarps / 16;  // m16 tiles per warp
constexpr int kStep = 16;                      // rows per mma (k16)
constexpr int64_t kFlushRows = 65536;

template <bool WITH_FLAGS>
__global__ void __launch_bounds__(kThreads, 2) onehot_bytes(
    const int32_t* __restrict__ gid, const uint32_t* __restrict__ vlo,
    const uint32_t* __restrict__ vhi, const uint32_t* __restrict__ flags,
    int64_t n, int64_t rows_per_block, int64_t* __restrict__ tot) {
  constexpr int L = WITH_FLAGS ? 12 : 9;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  const int g_base = warp * (kTiles * 16);
  const int64_t begin = (int64_t)blockIdx.x * rows_per_block;
  const int64_t stop = begin + rows_per_block;
  const int64_t end = stop < n ? stop : n;

  float acc[kTiles][2][4];
  auto zero = [&]() {
#pragma unroll
    for (int t = 0; t < kTiles; ++t)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[t][j][q] = 0.f;
  };
  auto flush = [&]() {
#pragma unroll
    for (int t = 0; t < kTiles; ++t)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int g = g_base + 16 * t + grp + 8 * (q >> 1);
          const int l = 8 * j + 2 * tig + (q & 1);
          if (l < L)
            qe::flush_add(tot, (int64_t)g * L + l,
                          (unsigned long long)acc[t][j][q]);
        }
  };
  // this thread's rows of a step at r0: r0 + 2tig + {0, 1, 8, 9}, loaded
  // one step ahead so the loads overlap the previous step's work
  auto load = [&](int64_t r0, qe::Row (&w)[4], uint32_t (&fl)[4]) {
    qe::load_pair(gid, vlo, vhi, r0 + 2 * tig, end, w);
    qe::load_pair(gid, vlo, vhi, r0 + 2 * tig + 8, end, w + 2);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t r = r0 + 2 * tig + (i & 1) + 8 * (i >> 1);
      fl[i] = WITH_FLAGS && r < end ? __ldg(flags + r) : 0u;
    }
  };
  // B, n-tile 0: lane grp is byte grp of the row's value
  const bool high_word = grp >= 4;
  const uint32_t byte_sel = (uint32_t)(grp & 3);
  // B, n-tile 1: lane 8 + grp is the count (grp 0) or, in v1, flag bit
  // grp - 1 (grp 1..3); in v2 it depends on nothing but grp
  const uint32_t count_pair = grp == 0 ? qe::onehot_pair(true, true) : 0u;

  zero();
  int64_t since_flush = 0;
  qe::Row nw[4];
  uint32_t nfl[4];
  load(begin, nw, nfl);
  for (int64_t r0 = begin; r0 < end; r0 += kStep) {
    qe::Row w[4];
    uint32_t fl[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      w[i] = nw[i];
      fl[i] = nfl[i];
    }
    load(r0 + kStep, nw, nfl);
    uint32_t b[2][2];
    float f[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      f[i] = qe::byte_as_float(high_word ? w[i].hi : w[i].lo, byte_sel);
    b[0][0] = qe::pack_bf16(f[0], f[1]);
    b[0][1] = qe::pack_bf16(f[2], f[3]);
    if (WITH_FLAGS) {
      bool c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        c[i] = grp == 0 || (grp <= 3 && ((fl[i] >> (grp - 1)) & 1u));
      b[1][0] = qe::onehot_pair(c[0], c[1]);
      b[1][1] = qe::onehot_pair(c[2], c[3]);
    } else {
      b[1][0] = b[1][1] = count_pair;
    }
    // A: row i is 1 in A row g_base + grp + 8s (s = 2t + half) when its
    // gid is that group: slot bit s of m[i]. Rows 0 and 1 (2 and 3) share a
    // register, in its low and high half, so one shift and mask per
    // register picks both, and the multiply turns each 1 into bf16 1.0.
    // Excluded rows (gid < 0 or >= 1024) set no bit.
    uint32_t m[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      m[i] = qe::slot_bit(w[i].gid - g_base - grp, 2 * kTiles);
    const uint32_t k01 = m[0] | (m[1] << 16), k23 = m[2] | (m[3] << 16);
#pragma unroll
    for (int t = 0; t < kTiles; ++t) {
      uint32_t a[4];
      a[0] = ((k01 >> (2 * t)) & 0x10001u) * qe::kBf16One;
      a[1] = ((k01 >> (2 * t + 1)) & 0x10001u) * qe::kBf16One;
      a[2] = ((k23 >> (2 * t)) & 0x10001u) * qe::kBf16One;
      a[3] = ((k23 >> (2 * t + 1)) & 0x10001u) * qe::kBf16One;
      qe::mma_bf16_16816(acc[t][0], a, b[0]);
      qe::mma_bf16_16816(acc[t][1], a, b[1]);
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

// Returns a cudaError_t: 0 when the launch succeeded. `flags` null runs
// v2 (9 lanes), non-null v1 (12 lanes). Launches on `stream` and does not
// synchronise; the occupancy query is cached (launch_config.cuh).
extern "C" int qe_onehot_bytes(const int32_t* gid, const uint32_t* vlo,
                               const uint32_t* vhi, const uint32_t* flags,
                               int64_t n, int64_t* tot, cudaStream_t stream) {
  static qe::LaunchCache<decltype(&onehot_bytes<true>)> cache_v1;
  static qe::LaunchCache<decltype(&onehot_bytes<false>)> cache_v2;
  if (n <= 0) return (int)cudaSuccess;
  qe::RowGrid grid;
  cudaError_t err;
  if (flags != nullptr) {
    err = qe::plan_rows(cache_v1, &onehot_bytes<true>, kThreads, n, kStep,
                        &grid);
    if (err != cudaSuccess) return (int)err;
    onehot_bytes<true><<<grid.blocks, kThreads, 0, stream>>>(
        gid, vlo, vhi, flags, n, grid.rows_per_block, tot);
  } else {
    err = qe::plan_rows(cache_v2, &onehot_bytes<false>, kThreads, n, kStep,
                        &grid);
    if (err != cudaSuccess) return (int)err;
    onehot_bytes<false><<<grid.blocks, kThreads, 0, stream>>>(
        gid, vlo, vhi, flags, n, grid.rows_per_block, tot);
  }
  return (int)cudaGetLastError();
}
