// Grouped SUM/COUNT chunk totals as a factorized one-hot bf16 product on
// Hopper's wgmma: the kernels of the v4 and v5 aggregate probes.
//
// Replaces the TPU kernels `_kernel_v4` (launched by `_run_v4`) and
// `_kernel_v5` (launched by `_run_v5`) in benchmarks/probe_agg_variants.py.
// A group id splits as gid = ghi * 128 + glo (ghi 0..7, 1024 groups). A is
// the one-hot of glo [128 x rows]; B [rows x 72] holds a row's 9 lanes
// (bytes 0..7 and a count of 1) only in the 8 columns of its ghi, at column
// 8 * lane + ghi, zero in the others. D = A x B is [128 x 72] in place of
// [1024 x 9]: n8 block k of D is lane k, and its column ghi is group ghi *
// 128 + glo.
//
// Contract (wrapper: query_engine_tpu_torch/ops/agg_variants.py):
//   gid [n] int32; row r belongs to group gid[r] when 0 <= gid < 1024
//   vlo, vhi [n] uint32: the low and high words of the row's 64-bit value
//   tot [1024, 9] int64, zero-filled by the caller: bytes 0..7, count
//
// The loop: one block an SM on a contiguous range of rows, in steps of 32
// rows (two k16 slices). Each step has its own stage in a ring of kStages:
// its operands in shared memory, K-major as onehot_wgmma.cuh lays them out,
// and a "full" and an "empty" mbarrier.
//   * Eight producer warps take the steps in turn. Lane i loads row i of its
//     step, kAhead steps ahead, so each row is read once a block. Once the
//     stage is free, the row clears the 9 entries of B that the row before
//     it in the same stage and lane set and sets its own (2-byte stores); an
//     excluded row (gid < 0 or >= 1024) sets nothing.
//   * Two wgmma warpgroups take the steps in turn. Each holds all 128 x 72
//     accumulators (two m64 tiles, 72 f32 a thread) and issues four
//     wgmma.m64n72k16 (bf16 in, f32 accumulate) a step, waits for them to
//     retire and hands the stage back, while the other warpgroup's step
//     keeps the tensor cores busy.
// Two instantiations keep the TPU pair's difference:
//   v4 (kStaged): A from shared memory. The producer also sets the row's
//      single one-hot nonzero at (glo, row) of its slice's 128 x 16 A tile
//      (4 KB) and clears the one set before it.
//   v5: A from registers. The producer writes its slice's 16 glo as bf16
//      pairs (32 B); each wgmma thread builds its one-hot fragments from the
//      4 rows of a slice it needs, one bf16x2 compare a register. The
//      one-hot never passes through shared memory (v5's "no relayout").
// kStages is a multiple of both strides, so a stage is always written by one
// producer warp and read by one warpgroup: each barrier's phases complete in
// order and a parity wait cannot alias.
//
// Exactness: bytes and 1.0 are exact in bf16, the products exact in f32,
// and each accumulator moves into the int64 total (64-bit atomics,
// flush_add) at least every 65,536 of its rows (255 * 65,536 < 2^24).
// Integer adds do not depend on order, so the total has the same bits on
// every run.
//
// What bounds it on an H100: not bytes (12 B a row, 0.0651 ms for 2^24
// rows) but the tensor work, 2 * 128 * 72 flops a row (0.3127 ms at the
// published 989 TFLOP/s; scripts/wgmma_small_n.py times the issue pattern
// alone at about 0.32 ms). The mma.sync design before it had 8 warps load
// the same rows and build the same B (v4 re-deriving the ghi mask for every
// element of a dense tile) and was held by the integer pipe. Here a row is
// read once a block and costs a few shared stores, and the wgmma
// warpgroups build at most the one-hot fragments. What is left above the
// floor is each step's handoff (its barrier wait, the retirement of its
// wgmma and its release, which is why a step holds two slices) and the
// producers' shared-memory stores beside the wgmma's operand reads
// (PERF.md, PR 7).

#include <cuda_runtime.h>
#include <stdint.h>

#include "onehot_wgmma.cuh"

namespace {

constexpr int kLanes = 9;        // bytes 0..7, the count
constexpr int kRows = 16;        // rows a wgmma (k16)
constexpr int kSlices = 2;       // k16 slices a stage
constexpr int kStageRows = kSlices * kRows;  // 32: one row a producer lane
constexpr int kTiles = 2;        // m64 tiles: the 128 glo
constexpr int kAcc = 36;         // m64n72 f32: 9 n8 blocks x 4
constexpr int kConsumers = 2;    // wgmma warpgroups, steps in turn
constexpr int kProducers = 8;    // producer warps, steps in turn
constexpr int kAhead = 8;        // steps a producer warp loads ahead
constexpr int kStages = 16;
constexpr int kThreads = 128 * kConsumers + 32 * kProducers;
constexpr int64_t kFlushRows = 65536;
constexpr int kASlice = 128 * qe::kKBytes;  // 4 KB: 128 glo x 16 rows (v4)
constexpr int kBSlice = kLanes * qe::kSbo;  // 2,304 B: 72 columns x 16 rows
constexpr int kGloSlice = 2 * kRows;        // v5: 16 glo as bf16
constexpr int kOwned = kStages / kProducers;  // stages of a producer warp
static_assert(kStages % kProducers == 0 && kStages % kConsumers == 0,
              "a stage needs one producer warp and one warpgroup");
static_assert(kFlushRows % kStageRows == 0, "a flush ends a stage");
static_assert(kAhead % kOwned == 0, "a ring slot keeps its stage");

// Byte offsets in the dynamic shared memory: A (v4), B, glo pairs (v5),
// each [kStages][kSlices][slice], then full[kStages] and empty[kStages].
template <bool kStaged>
struct Smem {
  static constexpr int kB = kStaged ? kStages * kSlices * kASlice : 0;
  static constexpr int kGlo = kB + kStages * kSlices * kBSlice;
  static constexpr int kBars =
      kGlo + (kStaged ? 0 : kStages * kSlices * kGloSlice);
  static constexpr size_t kBytes = kBars + 2 * kStages * 8;
};

// The bf16 bits of byte k of x (exact: bf16 keeps 8 significant bits).
__device__ __forceinline__ uint32_t byte_bf16(uint32_t x, uint32_t k) {
  return __float_as_uint(qe::byte_as_float(x, k)) >> 16;
}

// Per half: 1.0 (bf16) where the halves of a and b are equal, else 0.
__device__ __forceinline__ uint32_t bf16x2_eq(uint32_t a, uint32_t b) {
  uint32_t d;
  asm volatile("set.eq.bf16x2.bf16x2 %0, %1, %2;\n"
               : "=r"(d)
               : "r"(a), "r"(b));
  return d;
}

struct Block {
  int64_t begin, end, steps;        // rows [begin, end), stages of them
  uint32_t a, b, glo, full, empty;  // shared addresses of stage 0
};

// A producer warp: steps pw, pw + kProducers, ... of the block (stage s %
// kStages). Lane i takes row i of the step: slice i / 16, row i % 16.
// Once the stage is free it clears the entries its row of kOwned steps
// before set and sets its row's, fences them into the async proxy and
// arrives on "full".
template <bool kStaged>
__device__ __forceinline__ void produce(const Block& x,
                                        const int32_t* __restrict__ gid,
                                        const uint32_t* __restrict__ vlo,
                                        const uint32_t* __restrict__ vhi) {
  const int lane = threadIdx.x & 31;
  const int pw = (int)(threadIdx.x >> 5) - 4 * kConsumers;
  const int slice = lane >> 4, row = lane & 15;
  auto load = [&](int64_t s) {
    const int64_t r = x.begin + kStageRows * s + lane;
    qe::LaneRow w{-1, 0u, 0u, 0u};
    if (r < x.end) {
      w.gid = __ldg(gid + r);
      w.lo = __ldg(vlo + r);
      w.hi = __ldg(vhi + r);
    }
    return w;
  };
  // Step s on row w; `set` is the gid this lane set in the stage kOwned
  // steps before (-1: nothing), and becomes w's.
  auto step = [&](int64_t s, const qe::LaneRow& w, int32_t& set) {
    const bool in = (uint32_t)w.gid < 1024u;
    const int st = (int)(s % kStages);
    qe::mbar_wait(x.empty + 8 * st, (uint32_t)((s / kStages) & 1) ^ 1u);
    const int at = st * kSlices + slice;
    const uint32_t b = x.b + at * kBSlice, a = x.a + at * kASlice;
    if (set >= 0) {
      const uint32_t e = b + qe::kmajor_offset(set >> 7, 2 * row);
#pragma unroll
      for (int k = 0; k < kLanes; ++k)
        qe::st_shared_u16(e + k * qe::kSbo, 0u);
      if constexpr (kStaged)
        qe::st_shared_u16(a + qe::kmajor_offset(set & 127, 2 * row), 0u);
    }
    if (in) {
      const uint32_t e = b + qe::kmajor_offset(w.gid >> 7, 2 * row);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        qe::st_shared_u16(e + k * qe::kSbo,
                          byte_bf16(k < 4 ? w.lo : w.hi, k & 3));
      qe::st_shared_u16(e + 8 * qe::kSbo, qe::kBf16One);
      if constexpr (kStaged)
        qe::st_shared_u16(a + qe::kmajor_offset(w.gid & 127, 2 * row),
                          qe::kBf16One);
    }
    if constexpr (!kStaged) {
      // rows (2 tig, 2 tig + 1) in word 2 tig, (2 tig + 8, 2 tig + 9) in
      // word 2 tig + 1; an excluded row's 255 matches no glo
      const int pos = 8 * ((row & 7) >> 1) + 4 * (row >> 3) + 2 * (row & 1);
      qe::st_shared_u16(x.glo + at * kGloSlice + pos,
                        byte_bf16(in ? (uint32_t)(w.gid & 127) : 255u, 0));
    }
    qe::fence_proxy_async();
    qe::mbar_arrive(x.full + 8 * st);
    set = in ? w.gid : -1;
  };
  qe::LaneRow ahead[kAhead];
#pragma unroll
  for (int i = 0; i < kAhead; ++i) ahead[i] = load(pw + i * kProducers);
  int32_t set[kOwned];
#pragma unroll
  for (int i = 0; i < kOwned; ++i) set[i] = -1;
  // Unrolled by kAhead, so each slot of the ring keeps its registers: a
  // row's registers are read kAhead steps after its loads were issued (a
  // ring moved down a slot every step waits on each load in flight).
  for (int64_t s0 = pw; s0 < x.steps; s0 += kAhead * kProducers) {
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int64_t s = s0 + u * kProducers;
      if (s >= x.steps) break;
      step(s, ahead[u], set[u % kOwned]);
      ahead[u] = load(s + kAhead * kProducers);
    }
  }
}

// A wgmma warpgroup: steps c, c + kConsumers, ... of the block.
template <bool kStaged>
__device__ __forceinline__ void consume(const Block& x, int c,
                                        int64_t* __restrict__ tot) {
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = (tid >> 5) & 3, grp = lane >> 2, tig = lane & 3;
  float acc[kTiles][kAcc];
  auto fence_acc = [&]() {
#pragma unroll
    for (int t = 0; t < kTiles; ++t)
#pragma unroll
      for (int q = 0; q < kAcc; ++q) qe::fence_reg(acc[t][q]);
  };
  auto zero = [&]() {
#pragma unroll
    for (int t = 0; t < kTiles; ++t)
#pragma unroll
      for (int q = 0; q < kAcc; ++q) acc[t][q] = 0.f;
    fence_acc();
  };
  // accumulator q of tile t (the wgmma D fragment): glo 64 t + 16 warp +
  // grp + 8 (q/2 % 2), column 8 (q/4) + 2 tig + q % 2, so lane q/4 of group
  // (2 tig + q % 2) * 128 + glo
  auto flush = [&]() {
#pragma unroll
    for (int t = 0; t < kTiles; ++t)
#pragma unroll
      for (int q = 0; q < kAcc; ++q) {
        qe::fence_reg(acc[t][q]);
        const int glo = 64 * t + 16 * warp + grp + 8 * ((q >> 1) & 1);
        const int ghi = 2 * tig + (q & 1);
        qe::flush_add(tot, (int64_t)(ghi * 128 + glo) * kLanes + (q >> 2),
                      (unsigned long long)acc[t][q]);
      }
  };
  // v5: the glo of this thread's fragment rows grp and grp + 8 of each
  // tile, as bf16 in both halves
  uint32_t glo_of[kTiles][2];
#pragma unroll
  for (int t = 0; t < kTiles; ++t)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      glo_of[t][h] =
          byte_bf16((uint32_t)(64 * t + 16 * warp + grp + 8 * h), 0) * 0x10001u;
  zero();
  const bool leader = lane == 0;  // of each warp, once its wgmma retired
  int64_t since_flush = 0;
  for (int64_t s = c; s < x.steps; s += kConsumers) {
    const int st = (int)(s % kStages);
    qe::mbar_wait(x.full + 8 * st, (uint32_t)((s / kStages) & 1));
    // v5: the one-hot fragments of both slices, from the glo of this
    // thread's rows 2 tig, 2 tig + 1 (p0) and 2 tig + 8, 2 tig + 9 (p1)
    uint32_t a[kSlices][kTiles][4];
    if constexpr (!kStaged) {
#pragma unroll
      for (int j = 0; j < kSlices; ++j) {
        uint32_t p0, p1;
        asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n"
                     : "=r"(p0), "=r"(p1)
                     : "r"(x.glo + (st * kSlices + j) * kGloSlice + 8 * tig)
                     : "memory");
#pragma unroll
        for (int t = 0; t < kTiles; ++t) {
          a[j][t][0] = bf16x2_eq(p0, glo_of[t][0]);
          a[j][t][1] = bf16x2_eq(p0, glo_of[t][1]);
          a[j][t][2] = bf16x2_eq(p1, glo_of[t][0]);
          a[j][t][3] = bf16x2_eq(p1, glo_of[t][1]);
        }
      }
    }
    fence_acc();
    qe::wgmma_fence();
#pragma unroll
    for (int j = 0; j < kSlices; ++j) {
      const int at = st * kSlices + j;
      const uint64_t db = qe::kmajor_desc(x.b + at * kBSlice);
#pragma unroll
      for (int t = 0; t < kTiles; ++t) {
        if constexpr (kStaged)
          qe::wgmma_bf16_m64n72k16(
              acc[t],
              qe::kmajor_desc(x.a + at * kASlice + t * 8 * qe::kSbo), db);
        else
          qe::wgmma_bf16_m64n72k16_rs(acc[t], a[j][t], db);
      }
    }
    qe::wgmma_commit();
    fence_acc();
    // All of the step's wgmma retire before the stage is handed back and
    // before v5's fragment registers are written again (a write to them
    // while a wgmma that reads them is in flight makes ptxas serialize
    // every wgmma); the other warpgroup's step keeps the tensor cores busy
    // meanwhile.
    qe::wgmma_wait<0>();
    if (leader) qe::mbar_arrive(x.empty + 8 * st);
    since_flush += kStageRows;
    if (since_flush == kFlushRows) {
      flush();
      zero();
      since_flush = 0;
    }
  }
  flush();
}

template <bool kStaged>
__global__ void __launch_bounds__(kThreads, 1) onehot_factorized(
    const int32_t* __restrict__ gid, const uint32_t* __restrict__ vlo,
    const uint32_t* __restrict__ vhi, int64_t n, int64_t rows_per_block,
    int64_t* __restrict__ tot) {
  using S = Smem<kStaged>;
  extern __shared__ __align__(1024) uint8_t smem[];
  const int tid = threadIdx.x;
  // the warpgroup, as a value the compiler knows is warp-uniform: a branch
  // on it around a wgmma is then not divergent
  const int wg = __shfl_sync(0xFFFFFFFFu, tid >> 7, 0);
  Block x;
  x.begin = (int64_t)blockIdx.x * rows_per_block;
  const int64_t stop = x.begin + rows_per_block;
  x.end = stop < n ? stop : n;
  x.steps = (x.end - x.begin + kStageRows - 1) / kStageRows;
  const uint32_t base = qe::smem_u32(smem);
  x.a = base;
  x.b = base + S::kB;
  x.glo = base + S::kGlo;
  x.full = base + S::kBars;
  x.empty = x.full + 8 * kStages;

  // zeroed A and B tiles (every step rewrites its glo pairs); the barriers
  for (int i = tid; i < S::kGlo / 16; i += kThreads)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) {
      qe::mbar_init(x.full + 8 * st, 32);  // a producer warp's lanes
      qe::mbar_init(x.empty + 8 * st, 4);  // lane 0 of a warpgroup's warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  qe::fence_proxy_async();
  __syncthreads();

  if (wg >= kConsumers)
    produce<kStaged>(x, gid, vlo, vhi);
  else
    consume<kStaged>(x, wg, tot);
}

template <bool kStaged>
cudaError_t launch(
    qe::LaunchCache<decltype(&onehot_factorized<kStaged>)>& cache,
    const int32_t* gid, const uint32_t* vlo, const uint32_t* vhi, int64_t n,
    int64_t* tot, cudaStream_t stream) {
  const size_t smem = Smem<kStaged>::kBytes;
  qe::RowGrid grid;
  const cudaError_t err =
      qe::plan_rows(cache, &onehot_factorized<kStaged>, kThreads, n,
                    kStageRows, &grid, smem);
  if (err != cudaSuccess) return err;
  onehot_factorized<kStaged><<<grid.blocks, kThreads, smem, stream>>>(
      gid, vlo, vhi, n, grid.rows_per_block, tot);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t: 0 when the launch succeeded. `staged` 1 runs v4
// (A in shared memory), 0 runs v5 (A in registers). Launches on `stream`
// and does not synchronise; the occupancy query is cached
// (launch_config.cuh).
extern "C" int qe_onehot_factorized(const int32_t* gid, const uint32_t* vlo,
                                    const uint32_t* vhi, int64_t n,
                                    int staged, int64_t* tot,
                                    cudaStream_t stream) {
  static qe::LaunchCache<decltype(&onehot_factorized<true>)> cache_v4;
  static qe::LaunchCache<decltype(&onehot_factorized<false>)> cache_v5;
  if (n <= 0) return (int)cudaSuccess;
  return (int)(staged ? launch<true>(cache_v4, gid, vlo, vhi, n, tot, stream)
                      : launch<false>(cache_v5, gid, vlo, vhi, n, tot, stream));
}
