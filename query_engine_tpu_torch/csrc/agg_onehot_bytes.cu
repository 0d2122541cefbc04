// Grouped SUM/COUNT chunk totals as a full one-hot bf16 product on the
// tensor cores: the Hopper kernel of the v1 and v2 aggregate probes.
//
// Replaces the TPU kernels `_kernel_v1` and `_kernel_v2`, both launched by
// `_run_byte_kernel`, in benchmarks/probe_agg_variants.py. There the MXU
// multiplied a bf16 one-hot [rows x 1024 groups] by the rows' byte chunks;
// here wgmma.m64n16k16 (bf16 in, f32 accumulate) does the same product.
//
// Contract (wrapper: query_engine_tpu_torch/ops/agg_variants.py):
//   gid   [n] int32; row r belongs to group gid[r] when 0 <= gid < 1024
//   vlo, vhi [n] uint32: the low and high words of the row's 64-bit value
//   flags [n] uint32 (v1 only; bits 0..2 summed as lanes 9..11)
//   tot   [1024, L] int64, zero-filled by the caller: L = 12 (v1: bytes
//         0..7, count, 3 flag bits) or 9 (v2: bytes 0..7, count)
//
// Layout (onehot_wgmma.cuh): D[group, lane] = A[group, row] x B[row, lane],
// a k-step of 16 rows. A is the bf16 one-hot (element (gid, k) = 1.0); B's
// lane n < 8 holds the rows' byte n as bf16 (a byte permute and a float
// subtract, no conversion instruction), lane 8 the count (1.0), lanes 9-11
// the flag bits (v1) and the rest 0. Four warpgroups of four m64 tiles cover
// the 1024 groups.
//
// Exactness: a byte (0..255) and 1.0 are exact in bf16, and the products are
// exact in f32. An f32 accumulator holds integers exactly below 2^24, and
// 255 * 65,536 < 2^24, so each block moves its accumulators into the int64
// total at least every 65,536 rows (kFlushRows).
//
// What bounds it on an H100: not bytes (12-16 B a row) but the dense
// one-hot product, 2 * 1024 * 16 flops a row (0.556 ms for 2^24 rows at the
// published 989 TFLOP/s), and below that rate the issue of 16 narrow wgmma
// a 16-row k-step an SM, each reading a 2 KB A tile from shared memory:
// twice s8's k-steps for the same rows (scripts/wgmma_small_n.py times that
// pattern alone). The mma.sync design before it (8 warps loading the same
// rows and building the same B fragments, the one-hot fragments rebuilt in
// registers for every m16 tile) was held by the integer pipe. Here four
// producer warps read each row once a block, B is built once a block, and
// the one-hot costs two 2-byte shared stores a row (set, later clear).

#include <cuda_runtime.h>
#include <stdint.h>

#include "onehot_wgmma.cuh"

namespace {

template <bool WITH_FLAGS>
struct Bytes {
  static constexpr int kRows = 16;  // k16: two bytes a row
  static constexpr int kElem = 2;
  static constexpr int kN = 16;     // bytes 0..7, count, flags, zeros
  static constexpr int kLanes = WITH_FLAGS ? 12 : 9;
  static constexpr int kPlanes = WITH_FLAGS ? 4 : 3;  // gid, vlo, vhi, flags
  static constexpr int64_t kFlushRows = 65536;
  static constexpr uint32_t one_bits = qe::kBf16One;
  using Acc = float;
  static constexpr int kAcc = 8;  // m64n16: 2 n8 blocks x 4

  static __device__ __forceinline__ void store(uint32_t addr, uint32_t v) {
    qe::st_shared_u16(addr, v);
  }
  // lane 8 = 1.0 for all 16 rows
  static __device__ __forceinline__ void constant_lanes(int k, uint8_t* b) {
    if (k < kRows)
      *reinterpret_cast<uint16_t*>(b + qe::kmajor_offset(8, 2 * k)) =
          (uint16_t)qe::kBf16One;
  }
  // From the warp's rows (lanes 0..15: rows 0..15): lane 8h + p writes
  // byte lanes h (of vlo) and 4 + h (of vhi) of rows 2p, 2p + 1 and, in
  // v1, flag lane 9 + h (h < 3), from the two rows' words by shuffles.
  static __device__ __forceinline__ void build_b(int lane, const qe::LaneRow& w,
                                                 uint8_t* b) {
    const int p = lane & 7, h = lane >> 3;
    const uint32_t lo0 = __shfl_sync(0xFFFFFFFFu, w.lo, 2 * p);
    const uint32_t lo1 = __shfl_sync(0xFFFFFFFFu, w.lo, 2 * p + 1);
    const uint32_t hi0 = __shfl_sync(0xFFFFFFFFu, w.hi, 2 * p);
    const uint32_t hi1 = __shfl_sync(0xFFFFFFFFu, w.hi, 2 * p + 1);
    auto put = [&](int n, uint32_t v) {
      *reinterpret_cast<uint32_t*>(b + qe::kmajor_offset(n, 4 * p)) = v;
    };
    put(h, qe::pack_bf16(qe::byte_as_float(lo0, h), qe::byte_as_float(lo1, h)));
    put(4 + h,
        qe::pack_bf16(qe::byte_as_float(hi0, h), qe::byte_as_float(hi1, h)));
    if (WITH_FLAGS) {
      const uint32_t f0 = __shfl_sync(0xFFFFFFFFu, w.flags, 2 * p);
      const uint32_t f1 = __shfl_sync(0xFFFFFFFFu, w.flags, 2 * p + 1);
      if (h < 3) put(9 + h, qe::onehot_pair((f0 >> h) & 1u, (f1 >> h) & 1u));
    }
  }
  static __device__ __forceinline__ void mma(float (&d)[kAcc], uint64_t da,
                                             uint64_t db) {
    qe::wgmma_bf16_m64n16k16(d, da, db);
  }
  static __device__ __forceinline__ unsigned long long to_u64(float v) {
    return (unsigned long long)v;
  }
};

}  // namespace

// Returns a cudaError_t: 0 when the launch succeeded. `flags` null runs
// v2 (9 lanes), non-null v1 (12 lanes). Launches on `stream` and does not
// synchronise; the occupancy query is cached (launch_config.cuh).
extern "C" int qe_onehot_bytes(const int32_t* gid, const uint32_t* vlo,
                               const uint32_t* vhi, const uint32_t* flags,
                               int64_t n, int64_t* tot, cudaStream_t stream) {
  static qe::LaunchCache<decltype(&qe::onehot_wgmma<Bytes<true>>)> cache_v1;
  static qe::LaunchCache<decltype(&qe::onehot_wgmma<Bytes<false>>)> cache_v2;
  if (n <= 0) return (int)cudaSuccess;
  const qe::Planes in{{reinterpret_cast<const uint32_t*>(gid), vlo, vhi,
                       flags}};
  const cudaError_t err =
      flags != nullptr
          ? qe::launch_onehot_wgmma<Bytes<true>>(cache_v1, in, n,
                                                 qe::kWgGroups, tot, stream)
          : qe::launch_onehot_wgmma<Bytes<false>>(cache_v2, in, n,
                                                  qe::kWgGroups, tot, stream);
  return (int)err;
}
