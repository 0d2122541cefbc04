// Grouped SUM/COUNT chunk totals as a one-hot int8 product on the tensor
// cores, over 4-bit chunks: the Hopper kernel of the s8 nibble probe.
//
// Replaces the TPU kernel `_kernel_s8`, launched by `grouped_sum_count_s8`,
// in benchmarks/probe_int8_mxu.py. There the MXU multiplied an s8 one-hot
// [rows x 1024 groups] by the rows' 16 nibbles and a count lane with s32
// accumulation; here wgmma.m64n24k32 (s8 x s8 -> s32) does the same.
//
// Contract (wrapper: query_engine_tpu_torch/ops/agg_variants.py):
//   gid [n] int32; row r belongs to group gid[r] when 0 <= gid < G <= 1024
//   vlo, vhi [n] uint32: the low and high words of the row's 64-bit value
//   tot [G, 17] int64, zero-filled by the caller: nibbles 0..15, count
//
// Layout (onehot_wgmma.cuh): D[group, lane] = A[group, row] x B[row, lane],
// a k-step of 32 rows. A is the s8 one-hot (byte (gid, k) = 1); B's lane n
// < 16 holds the rows' nibble n (of vlo for n < 8, of vhi above), lane 16 is
// the count (1), lanes 17-23 are 0. Four warpgroups of four m64 tiles cover
// 1024 groups; tiles wholly at or past G issue no wgmma.
//
// Exactness: a nibble (0..15) and 1 are exact in s8, and an s32 accumulator
// stays exact while 15 * rows < 2^31. Each block moves its accumulators into
// the int64 total at least every 2^24 rows (15 * 2^24 < 2^31), so the sums
// are exact at any n, not only up to the JAX design's 2^27 rows.
//
// What bounds it on an H100: not bytes (12 B a row) but the dense one-hot
// product, 2 * 1024 * 24 int8 ops a row (0.417 ms for 2^24 rows at the
// published 1,979 TOP/s), and below that rate the issue of 16 narrow
// wgmma a 32-row k-step an SM, each reading a 2 KB A tile from shared
// memory (scripts/wgmma_small_n.py times that pattern alone). The mma.sync
// design before it (16 warps loading the same rows and building the same B
// fragments, the one-hot fragments rebuilt in registers for every m16 tile)
// was held by the integer pipe. Here four producer warps read each row once
// a block, B is built once a block, and the one-hot costs two 1-byte shared
// stores a row (set, later clear); the wgmma warpgroups do nothing else.

#include <cuda_runtime.h>
#include <stdint.h>

#include "onehot_wgmma.cuh"

namespace {

struct S8 {
  static constexpr int kRows = 32;  // k32: one byte a row
  static constexpr int kElem = 1;
  static constexpr int kN = 24;     // 16 nibbles, the count, 7 zero lanes
  static constexpr int kLanes = 17;
  static constexpr int kPlanes = 3;  // gid, vlo, vhi
  static constexpr int64_t kFlushRows = int64_t(1) << 24;
  static constexpr uint32_t one_bits = 1u;
  using Acc = int;
  static constexpr int kAcc = 12;  // m64n24: 3 n8 blocks x 4

  static __device__ __forceinline__ void store(uint32_t addr, uint32_t v) {
    qe::st_shared_u8(addr, v);
  }
  // lane 16 = 1 for all 32 rows
  static __device__ __forceinline__ void constant_lanes(int k, uint8_t* b) {
    if (k < kRows) b[qe::kmajor_offset(16, k)] = 1;
  }
  // From the warp's rows (lane k: row k): lane 4q + i writes nibble lanes
  // 2i, 2i + 1 (of vlo) and 8 + 2i, 9 + 2i (of vhi) of rows 4q .. 4q + 3,
  // byte i of those rows' words gathered by shuffles and byte permutes.
  static __device__ __forceinline__ void build_b(int lane, const qe::LaneRow& w,
                                                 uint8_t* b) {
    const int q = lane >> 2, i = lane & 3;
    const uint32_t sel = (uint32_t)(i | ((i + 4) << 4));  // byte i of x, y
    uint32_t lo[4], hi[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      lo[j] = __shfl_sync(0xFFFFFFFFu, w.lo, 4 * q + j);
      hi[j] = __shfl_sync(0xFFFFFFFFu, w.hi, 4 * q + j);
    }
    const uint32_t blo = __byte_perm(__byte_perm(lo[0], lo[1], sel),
                                     __byte_perm(lo[2], lo[3], sel), 0x5410);
    const uint32_t bhi = __byte_perm(__byte_perm(hi[0], hi[1], sel),
                                     __byte_perm(hi[2], hi[3], sel), 0x5410);
    auto put = [&](int n, uint32_t v) {
      *reinterpret_cast<uint32_t*>(b + qe::kmajor_offset(n, 4 * q)) = v;
    };
    put(2 * i, blo & 0x0F0F0F0Fu);
    put(2 * i + 1, (blo >> 4) & 0x0F0F0F0Fu);
    put(8 + 2 * i, bhi & 0x0F0F0F0Fu);
    put(9 + 2 * i, (bhi >> 4) & 0x0F0F0F0Fu);
  }
  static __device__ __forceinline__ void mma(int (&d)[kAcc], uint64_t da,
                                             uint64_t db) {
    qe::wgmma_s8_m64n24k32(d, da, db);
  }
  static __device__ __forceinline__ unsigned long long to_u64(int v) {
    return (unsigned long long)(uint32_t)v;
  }
};

}  // namespace

// Returns a cudaError_t: 0 when the launch succeeded. Launches on `stream`
// and does not synchronise; the occupancy query is cached (launch_config.cuh).
extern "C" int qe_onehot_s8(const int32_t* gid, const uint32_t* vlo,
                            const uint32_t* vhi, int64_t n, int G,
                            int64_t* tot, cudaStream_t stream) {
  static qe::LaunchCache<decltype(&qe::onehot_wgmma<S8>)> cache;
  if (n <= 0 || G <= 0) return (int)cudaSuccess;
  if (G > qe::kWgGroups) return (int)cudaErrorInvalidValue;
  const qe::Planes in{{reinterpret_cast<const uint32_t*>(gid), vlo, vhi,
                       nullptr}};
  return (int)qe::launch_onehot_wgmma<S8>(cache, in, n, G, tot, stream);
}
