// The Hopper (sm_90a) pieces of the one-hot aggregate kernels that run on
// wgmma: the shared-memory operand layout and its descriptors, the wgmma,
// proxy-fence and mbarrier wrappers, and the loop that the full one-hot
// kernels share (agg_onehot_s8.cu, agg_onehot_bytes.cu). The layout,
// descriptor, wgmma and barrier pieces do not depend on that loop: the
// factorized kernels (agg_onehot_factorized.cu) run their own loop on them,
// with the m64n72k16 wrappers (A from shared memory or from registers).
//
// The product. D[group, lane] = A[group, row] x B[row, lane] with M = groups,
// N = lanes, K = rows: A is the one-hot of the rows' groups, B the chunk
// operand (each row's small integer chunks, a count lane, flag lanes). Both
// operands live in shared memory, K-major, without swizzle: one wgmma reads
// 32 bytes of K (32 s8 or 16 bf16 rows) as core matrices of 8 M (or N) rows
// x 16 bytes, stored as 128 contiguous bytes; the two 16-byte halves of K lie
// kLbo bytes apart and consecutive 8-row blocks kSbo bytes apart
// (`kmajor_offset`).
//
// The loop (`onehot_wgmma`), one block an SM on a contiguous range of rows,
// in k-steps of Op::kRows rows. Each k-step has its own A and B tiles, in a
// ring of kStages stages with a "full" and an "empty" mbarrier each.
//   * Four producer warps take the k-steps in turn. Lane k loads row k of
//     its step (a turn ahead) and writes the row's single one-hot nonzero
//     at (gid, k) of the stage's A tile, which is zeroed once at the start;
//     it first clears the nonzero it set there kStages steps before. The
//     warp builds the stage's B tile from its rows by shuffles (the count
//     lane is constant and written once), fences its stores into the async
//     proxy and arrives on "full".
//   * Four wgmma warpgroups cover the 1024 groups, 4 m64 tiles each, with
//     the accumulators in registers. For each k-step a warpgroup waits on
//     "full", issues its tiles' wgmma, and once the previous step's wgmma
//     has retired (wgmma.wait_group 1) arrives on that stage's "empty". So a
//     stage's A and B are rewritten only after every warpgroup's wgmma that
//     read them has retired.
// Tiles wholly at or past G issue no wgmma. Each warpgroup adds its
// accumulators into the int64 total with 64-bit atomics (flush_add) at
// least every Op::kFlushRows rows; integer adds do not depend on order, so
// the total has the same bits on every run.
//
// An Op gives: kRows (rows a k-step), kElem (bytes an element), kN (the
// wgmma's N), kLanes (lanes of the output), kPlanes (row planes read: gid,
// vlo, vhi and, optionally, flags), kFlushRows, Acc and kAcc (accumulator
// type and registers a tile), one_bits (the one-hot's nonzero), and
//   static void store(uint32_t smem_addr, uint32_t v)  // one A element
//   static void constant_lanes(int k, uint8_t* b)      // once a stage
//   static void build_b(int lane, const LaneRow& w, uint8_t* b)
//   static void mma(Acc (&d)[kAcc], uint64_t desc_a, uint64_t desc_b)
//   static unsigned long long to_u64(Acc v)

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "onehot_mma.cuh"

namespace qe {

constexpr int kKBytes = 32;  // K of one wgmma, in bytes
constexpr int kLbo = 128;    // the two 16-byte halves of K
constexpr int kSbo = 256;    // consecutive blocks of 8 rows

// Byte offset of (row, byte k) in a K-major operand of 32 bytes of K.
__host__ __device__ constexpr int kmajor_offset(int row, int kbyte) {
  return (row >> 3) * kSbo + (kbyte >> 4) * kLbo + (row & 7) * 16 +
         (kbyte & 15);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma matrix descriptor of a K-major operand without swizzle at shared
// address `addr` (16-byte aligned): start >> 4 in bits 0-13, LBO >> 4 in
// 16-29, SBO >> 4 in 32-45, layout type 0 (no swizzle) in bits 62-63.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) |
         ((uint64_t)(kLbo >> 4) << 16) | ((uint64_t)(kSbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Generic-proxy writes to shared memory (st.shared) become visible to the
// async proxy (wgmma's operand reads) after this fence and a barrier.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Keeps the compiler from moving accesses of an accumulator register across
// a wgmma wait or fence.
template <typename T>
__device__ __forceinline__ void fence_reg(T& r) {
  asm volatile("" : "+r"(r)::"memory");
}
__device__ __forceinline__ void fence_reg(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

__device__ __forceinline__ void st_shared_u8(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u8 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ void st_shared_u16(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(addr), "h"((uint16_t)v)
               : "memory");
}

// D (64 x 24, s32) += A (64 x 32, s8) x B (32 x 24, s8), both from shared.
__device__ __forceinline__ void wgmma_s8_m64n24k32(int (&d)[12], uint64_t da,
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %14, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, %12, %13, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11])
      : "l"(da), "l"(db), "r"(1));
}

// D (64 x 16, f32) += A (64 x 16, bf16) x B (16 x 16, bf16), both from
// shared, both K-major (no transpose), scales +1.
__device__ __forceinline__ void wgmma_bf16_m64n16k16(float (&d)[8],
                                                     uint64_t da,
                                                     uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1));
}

// The 36 accumulators of an m64n72 f32 tile as asm operands 0..35.
#define QE_D36(d)                                                            \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),    \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),           \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),       \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),       \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),       \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
#define QE_D36_LIST                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31, %32, %33, %34, %35}"

// D (64 x 72, f32) += A (64 x 16, bf16) x B (16 x 72, bf16), both from
// shared, both K-major (no transpose), scales +1.
__device__ __forceinline__ void wgmma_bf16_m64n72k16(float (&d)[36],
                                                     uint64_t da,
                                                     uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %38, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 " QE_D36_LIST
      ", %36, %37, p, 1, 1, 0, 0;\n}\n"
      : QE_D36(d)
      : "l"(da), "l"(db), "r"(1));
}

// The same with A from registers: each warp's 16 rows of A as the m16k16
// fragment (regs {0,1,2,3} = rows {grp, grp+8, grp, grp+8} x k pairs {2tig,
// 2tig, 2tig+8, 2tig+8}, with lane = 4 grp + tig), B from shared, K-major.
__device__ __forceinline__ void wgmma_bf16_m64n72k16_rs(float (&d)[36],
                                                        const uint32_t (&a)[4],
                                                        uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %41, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 " QE_D36_LIST
      ", {%36, %37, %38, %39}, %40, p, 1, 1, 0;\n}\n"
      : QE_D36(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef QE_D36
#undef QE_D36_LIST

// mbarriers in shared memory (addresses from smem_u32).
__device__ __forceinline__ void mbar_init(uint32_t addr, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(addr),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t addr) {
  asm volatile(
      "{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}\n"
      ::"r"(addr)
      : "memory");
}

// Waits until the phase of parity `parity` has completed (a fresh barrier
// counts its phase of parity 1 as completed).
__device__ __forceinline__ void mbar_wait(uint32_t addr, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(addr),
      "r"(parity)
      : "memory");
}

// ---------------------------------------------------------------------------
// The shared loop of the full one-hot kernels.

constexpr int kMmaWgs = 4;         // warpgroups that run wgmma
constexpr int kWgTiles = 4;        // m64 tiles a warpgroup
constexpr int kProducerWarps = 4;
constexpr int kWgThreads = 128 * kMmaWgs + 32 * kProducerWarps;
constexpr int kWgGroups = 1024;  // A's rows: 16 m64 tiles
constexpr int kStages = 6;       // A and B tiles, one a k-step
constexpr int kATileBytes = kWgGroups * kKBytes;  // 32 KB
// A producer warp waits on a stage's "empty" barrier by the parity of the
// phase it needs. That phase's step was released at most two phases ahead
// of the barrier only while the warp's previous step (kProducerWarps
// before) waited for a step no more than kStages before it.
static_assert(kProducerWarps <= kStages, "an mbarrier parity wait aliases");

// The row planes of a launch: gid, vlo, vhi and (v1) flags, 4 bytes a row.
struct Planes {
  const uint32_t* p[4];
};

// One row in a producer lane's registers; rows past the end read as
// excluded (gid -1).
struct LaneRow {
  int32_t gid;
  uint32_t lo, hi, flags;
};

template <class Op>
struct OneHotSmem {
  static constexpr int kBBytes = Op::kN / 8 * kSbo;
  // A and B tiles, full and empty barriers, the one-hot entries set in each
  // stage
  static constexpr size_t kBytes = (size_t)kStages * (kATileBytes + kBBytes) +
                                   2 * kStages * 8 + kStages * 32 * 4;
};

struct WgmmaArgs {
  int64_t* tot;
  int G, g_wg, tid;
  int64_t begin, end;
  uint32_t a_base, b_base, full, empty;  // shared addresses
};

// The k-step loop of a wgmma warpgroup whose first kLive m64 tiles are live:
// wait for the stage, issue the tiles' wgmma, release the stage of the
// k-step before once its wgmma has retired, and add the accumulators into
// `tot` every Op::kFlushRows rows and at the end.
template <class Op, int kLive>
__device__ __forceinline__ void wgmma_loop(const WgmmaArgs& x) {
  using Acc = typename Op::Acc;
  constexpr int kBBytes = OneHotSmem<Op>::kBBytes;
  Acc acc[kWgTiles][Op::kAcc];
  auto fence_acc = [&]() {
#pragma unroll
    for (int t = 0; t < kWgTiles; ++t)
#pragma unroll
      for (int q = 0; q < Op::kAcc; ++q) fence_reg(acc[t][q]);
  };
  auto zero = [&]() {
#pragma unroll
    for (int t = 0; t < kWgTiles; ++t)
#pragma unroll
      for (int q = 0; q < Op::kAcc; ++q) acc[t][q] = Acc(0);
    fence_acc();
  };
  // accumulator q of tile t: group g_wg + 64t + 16 warp + grp + 8 (q/2 % 2),
  // lane 8 (q/4) + 2 tig + q % 2 (the wgmma D fragment)
  auto flush = [&]() {
    const int lane = x.tid & 31, grp = lane >> 2, tig = lane & 3;
    const int g0 = x.g_wg + ((x.tid >> 5) & 3) * 16 + grp;
#pragma unroll
    for (int t = 0; t < kLive; ++t)
#pragma unroll
      for (int q = 0; q < Op::kAcc; ++q) {
        fence_reg(acc[t][q]);
        const int g = g0 + 64 * t + 8 * ((q >> 1) & 1);
        const int l = 8 * (q >> 2) + 2 * tig + (q & 1);
        if (g < x.G && l < Op::kLanes)
          flush_add(x.tot, (int64_t)g * Op::kLanes + l,
                    Op::to_u64(acc[t][q]));
      }
  };
  zero();
  const bool leader = (x.tid & 127) == 0;
  int st = 0;
  uint32_t parity = 0;
  int64_t since_flush = 0, step = 0;
  for (int64_t r0 = x.begin; r0 < x.end; r0 += Op::kRows, ++step) {
    mbar_wait(x.full + 8 * st, parity);
    fence_acc();
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < kLive; ++t)
      Op::mma(acc[t],
              kmajor_desc(x.a_base + st * kATileBytes +
                          (x.g_wg + 64 * t) / 8 * kSbo),
              kmajor_desc(x.b_base + st * kBBytes));
    wgmma_commit();
    fence_acc();
    wgmma_wait<1>();  // the previous k-step's wgmma has retired
    if (leader && step >= 1)
      mbar_arrive(x.empty + 8 * ((st + kStages - 1) % kStages));
    since_flush += Op::kRows;
    if (since_flush == Op::kFlushRows) {
      wgmma_wait<0>();
      flush();
      zero();
      since_flush = 0;
    }
    if (++st == kStages) {
      st = 0;
      parity ^= 1;
    }
  }
  wgmma_wait<0>();
  flush();
}

template <class Op>
__global__ void __launch_bounds__(kWgThreads, 1)
    onehot_wgmma(Planes in, int64_t n, int G, int64_t rows_per_block,
                 int64_t* __restrict__ tot) {
  using S = OneHotSmem<Op>;
  constexpr int kRows = Op::kRows;  // rows a k-step
  constexpr uint32_t kNone = 0xFFFFFFFFu;
  static_assert(kRows * Op::kElem == kKBytes, "one wgmma a k-step");

  extern __shared__ __align__(1024) uint8_t smem[];
  uint8_t* const a_tiles = smem;                           // [kStages][32 KB]
  uint8_t* const b_tiles = smem + kStages * kATileBytes;   // [kStages][kBBytes]
  uint64_t* const bars = reinterpret_cast<uint64_t*>(
      b_tiles + kStages * S::kBBytes);  // full[kStages], empty[kStages]
  uint32_t* const entries =
      reinterpret_cast<uint32_t*>(bars + 2 * kStages);  // [kStages][32]

  const int tid = threadIdx.x;
  // the warpgroup, as a value the compiler knows is warp-uniform: a branch
  // on it around a wgmma is then not divergent (a divergent one makes ptxas
  // serialize every wgmma of the kernel)
  const int wg = __shfl_sync(0xFFFFFFFFu, tid >> 7, 0);
  const int64_t begin = (int64_t)blockIdx.x * rows_per_block;
  const int64_t stop = begin + rows_per_block;
  const int64_t end = stop < n ? stop : n;
  const uint32_t a_base = smem_u32(a_tiles), b_base = smem_u32(b_tiles);
  const uint32_t full = smem_u32(bars), empty = smem_u32(bars + kStages);

  // zeroed tiles, B's constant lanes, no entries set; the barriers
  for (int i = tid; i < kStages * (kATileBytes + S::kBBytes) / 16;
       i += kWgThreads)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
  for (int i = tid; i < kStages * 32; i += kWgThreads) entries[i] = kNone;
  __syncthreads();
  if (tid < kStages * 32)
    Op::constant_lanes(tid & 31, b_tiles + (tid >> 5) * S::kBBytes);
  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full + 8 * st, 32);        // a producer warp's lanes
      mbar_init(empty + 8 * st, kMmaWgs);  // one thread a wgmma warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  fence_proxy_async();
  __syncthreads();

  if (wg >= kMmaWgs) {
    // The producer warps take the k-steps in turn, each on rows it loads
    // itself (lane k: row k of the k-step), one turn ahead. For k-step s
    // (stage s % kStages), once the stage is free, lane k clears the
    // one-hot entry set there kStages k-steps ago (kept in `entries`) and
    // sets row k's, the warp builds B from its rows (Op::build_b), and
    // hands the stage to the wgmma warpgroups.
    const int pw = (tid - 128 * kMmaWgs) >> 5, lane = tid & 31;
    const int64_t steps = (end - begin + kRows - 1) / kRows;
    auto load = [&](int64_t s) {
      const int64_t r = begin + s * kRows + lane;
      LaneRow w{-1, 0u, 0u, 0u};
      if (lane < kRows && r < end) {
        w.gid = __ldg(reinterpret_cast<const int32_t*>(in.p[0]) + r);
        w.lo = __ldg(in.p[1] + r);
        w.hi = __ldg(in.p[2] + r);
        if (Op::kPlanes > 3) w.flags = __ldg(in.p[3] + r);
      }
      return w;
    };
    LaneRow w = load(pw);
    for (int64_t s = pw; s < steps; s += kProducerWarps) {
      const LaneRow next = load(s + kProducerWarps);
      const int st = (int)(s % kStages);
      mbar_wait(empty + 8 * st, (uint32_t)((s / kStages) & 1) ^ 1u);
      if (lane < kRows) {
        uint32_t* const entry = entries + st * 32 + lane;
        if (*entry != kNone) Op::store(*entry, 0u);
        *entry = kNone;
        if ((unsigned)w.gid < (unsigned)G) {
          *entry = a_base + st * kATileBytes +
                   kmajor_offset(w.gid, lane * Op::kElem);
          Op::store(*entry, Op::one_bits);
        }
      }
      Op::build_b(lane, w, b_tiles + st * S::kBBytes);
      fence_proxy_async();
      mbar_arrive(full + 8 * st);
      w = next;
    }
    return;
  }

  // The wgmma warpgroups: kWgTiles m64 tiles each, groups g_wg + 64 t.
  // Tiles wholly at or past G issue no wgmma; their count is a constant of
  // the loop, since a branch around each wgmma would make ptxas fence the
  // warpgroup before every one.
  const int g_wg = wg * 64 * kWgTiles;
  const WgmmaArgs args{tot, G, g_wg, tid, begin, end, a_base, b_base, full,
                       empty};
  switch (min(kWgTiles, max(0, (G - g_wg + 63) / 64))) {
    case 4: wgmma_loop<Op, 4>(args); break;
    case 3: wgmma_loop<Op, 3>(args); break;
    case 2: wgmma_loop<Op, 2>(args); break;
    case 1: wgmma_loop<Op, 1>(args); break;
    default: wgmma_loop<Op, 0>(args); break;
  }
}

// Launches onehot_wgmma<Op> over n rows on `stream`: at most one block an
// SM (its shared memory), each on a contiguous range of whole k-steps.
template <class Op>
cudaError_t launch_onehot_wgmma(LaunchCache<decltype(&onehot_wgmma<Op>)>& cache,
                                const Planes& in, int64_t n, int G,
                                int64_t* tot, cudaStream_t stream) {
  const size_t smem = OneHotSmem<Op>::kBytes;
  RowGrid grid;
  cudaError_t err = plan_rows(cache, &onehot_wgmma<Op>, kWgThreads, n,
                              Op::kRows, &grid, smem);
  if (err != cudaSuccess) return err;
  onehot_wgmma<Op><<<grid.blocks, kWgThreads, smem, stream>>>(
      in, n, G, grid.rows_per_block, tot);
  return cudaGetLastError();
}

}  // namespace qe
