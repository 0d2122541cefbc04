// Small-table gather of 32-bit words: the Hopper kernel of the FK join's
// lookup route.
//
// Replaces the TPU kernel `_kernel`, launched by `mxu_gather_words`, in
// query_engine_tpu/ops/pallas/small_gather.py. On the TPU a random gather is
// nearly element-serial, so that kernel turned it into a bf16 one-hot matmul
// over the table's byte lanes and recombined the bytes outside. Hopper
// gathers natively; this kernel reads each row's words from a copy of the
// table in shared memory.
//
// One kernel body, two entry points:
//   qe_small_gather_u32     idx int32 [n], table int32 [T, W] row-major,
//                           out int32 [n, W] row-major (the JAX function's
//                           contract; words as int32 bit patterns)
//   qe_small_gather_planes  idx int64 [n] (the join's index plane), planes
//                           int64 [W, T] of words in [0, 2^32), out int64
//                           [W, n]: the word planes the join unpacks. The
//                           table is staged as 32-bit words (a plane value's
//                           low 32 bits) and zero-extended on store.
// Both: out[r, w] = table[idx[r], w] when 0 <= idx[r] < T, else 0 (the -1 of
// an unmatched row, pad rows and any other out-of-range index give zeros).
// W <= 32, the JAX kernel's limit (4 * W byte lanes <= 128).
//
// What bounds it on an H100: device-memory bytes, each index read once,
// each output word written once, and the table read once a block (T <= 4096
// rows in the engine, 16 KB a word).
//
// What the design does about the first port's three costs:
//   * No division, and an index read once a row. A lane takes 4 rows of its
//     warp's 128-row tile: one 16-byte load of four int32 indices, or two of
//     two int64 (rows 2l, 2l+1 and 64+2l, 64+2l+1 of the tile, so each load
//     and each plane store is 512 contiguous bytes a warp). W is a template
//     parameter for 1-4 and a runtime loop above; a row's words are one
//     shared load for W = 2 and 4, a load a word otherwise (a W = 3 table
//     padded to 4 words a row measured no faster), under one unsigned
//     compare that gives the zero.
//   * Whole 16-byte stores, 512 contiguous bytes a warp's store instruction:
//     each plane of the plane-major output takes two stores a lane; the
//     row-major output of W >= 2 words goes through the warp's 128-row tile
//     in shared memory, then out 16 bytes a lane (a lane's own 16 W bytes,
//     stored where they lie, leave each instruction's stores 16 W bytes
//     apart, which the card writes far slower). The stores are evict-first.
//     A store whose address is off a 16-byte boundary (an index view that
//     starts off one, an odd n) is split.
//   * The table staged once a block, by a persistent grid of at most
//     kBlocksPerSm blocks of kThreads an SM, 16 bytes a load where it is a
//     plain copy; each lane loads its first tile's indices before the block
//     waits for the table, and its next tile's before it looks up the
//     current one.
// Rows before idx's first 16-byte boundary and after the last whole tile go
// through a scalar path. A table larger than a block's opt-in shared memory
// is read through __ldg (L1/L2) by the same loop.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "launch_config.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kBlocksPerSm = 1;  // at most: each block stages the table once
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 128;  // rows of a warp's tile, 4 a lane
constexpr int kMaxWords = 32;

enum Form { kRowsU32 = 0, kPlanesU64 = 1 };

struct Args {
  const void* idx;    // kRowsU32: int32 [n]; kPlanesU64: int64 [n]
  const void* table;  // kRowsU32: int32 [T, W]; kPlanesU64: int64 [W, T]
  void* out;          // kRowsU32: int32 [n, W]; kPlanesU64: int64 [W, n]
  int64_t n;
  int64_t head;   // rows before idx's first 16-byte boundary
  int64_t tiles;  // whole 128-row tiles after them
  uint32_t T;
  int W;
};

// Whether the row-major output of kW words goes through a warp's tile in
// shared memory, so that each store instruction writes 512 contiguous bytes.
template <int kForm, int kW>
__host__ __device__ constexpr bool stages_out() {
  return kForm == kRowsU32 && kW >= 2;
}

template <int kForm>
using Index = std::conditional_t<kForm == kRowsU32, int32_t, long long>;

// A lane's 4 indices of one tile, as loaded: nothing reads them before the
// lane looks the tile up, so the loads stay in flight meanwhile.
template <int kForm>
struct Tile;

template <>
struct Tile<kRowsU32> {
  int4 v;  // rows 4l .. 4l+3 of the tile
  __device__ __forceinline__ void load(const Args& a, int64_t base, int l) {
    v = __ldg(reinterpret_cast<const int4*>(
                  static_cast<const int32_t*>(a.idx) + base) + l);
  }
  __device__ __forceinline__ int32_t at(int q) const {
    return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
  }
};

template <>
struct Tile<kPlanesU64> {
  longlong2 lo, hi;  // rows 2l, 2l+1 and 64+2l, 64+2l+1 of the tile
  __device__ __forceinline__ void load(const Args& a, int64_t base, int l) {
    const longlong2* p = reinterpret_cast<const longlong2*>(
        static_cast<const long long*>(a.idx) + base);
    lo = __ldg(p + l);
    hi = __ldg(p + 32 + l);
  }
  __device__ __forceinline__ long long at(int q) const {
    return q == 0 ? lo.x : q == 1 ? lo.y : q == 2 ? hi.x : hi.y;
  }
};

template <int kForm>
__device__ __forceinline__ bool in_table(Index<kForm> i, uint32_t T) {
  using U = std::make_unsigned_t<Index<kForm>>;
  return (U)i < (U)T;  // one unsigned compare covers i < 0 and i >= T
}

// Word w of table row i (i < T).
template <int kForm, bool kShared>
__device__ __forceinline__ uint32_t word_at(const uint32_t* s, const Args& a,
                                            int stride, uint32_t i, int w) {
  if constexpr (kShared) {
    return s[i * stride + w];
  } else if constexpr (kForm == kRowsU32) {
    return (uint32_t)__ldg(static_cast<const int32_t*>(a.table) +
                           (int64_t)i * a.W + w);
  } else {
    return (uint32_t)__ldg(static_cast<const long long*>(a.table) +
                           (int64_t)w * a.T + i);
  }
}

// The kW words of row i, or zeros when i lies outside [0, T).
template <int kForm, int kW, bool kShared>
__device__ __forceinline__ void row_words(const uint32_t* s, const Args& a,
                                          Index<kForm> i, uint32_t (&v)[kW]) {
  const bool ok = in_table<kForm>(i, a.T);
  const uint32_t r = (uint32_t)i;
  if constexpr (kShared && kW == 4) {
    const uint4 x = ok ? *reinterpret_cast<const uint4*>(s + r * 4)
                       : make_uint4(0, 0, 0, 0);
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  } else if constexpr (kShared && kW == 2) {
    const uint2 x = ok ? *reinterpret_cast<const uint2*>(s + r * 2)
                       : make_uint2(0, 0);
    v[0] = x.x;
    v[1] = x.y;
  } else {
#pragma unroll
    for (int w = 0; w < kW; ++w)
      v[w] = ok ? word_at<kForm, kShared>(s, a, kW, r, w) : 0u;
  }
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Output stores are evict-first (st.global.cs): nothing in the kernel reads
// them again, and the join's form measured far faster so than with plain
// stores.
template <typename T>
__device__ __forceinline__ void put(T* p, const T& x) {
  __stcs(p, x);
}

// Two neighbouring rows of one plane, zero-extended.
__device__ __forceinline__ void store_pair(unsigned long long* p, uint32_t x,
                                           uint32_t y) {
  if (aligned16(p)) {
    put(reinterpret_cast<ulonglong2*>(p), make_ulonglong2(x, y));
  } else {
    put(p, (unsigned long long)x);
    put(p + 1, (unsigned long long)y);
  }
}

// Looks up and stores one lane's 4 rows of the tile at `base`.
template <int kForm, int kW, bool kShared>
__device__ __forceinline__ void gather_tile(const uint32_t* s, const Args& a,
                                            const Tile<kForm>& t,
                                            int64_t base, int l,
                                            uint32_t* s_out) {
  if constexpr (kW > 0) {
    uint32_t v[4][kW];
#pragma unroll
    for (int q = 0; q < 4; ++q) row_words<kForm, kW, kShared>(s, a, t.at(q),
                                                              v[q]);
    if constexpr (stages_out<kForm, kW>()) {
      // the lane's 4 rows into the warp's tile (128 rows, row-major), then
      // 16 bytes a lane, 512 contiguous bytes a store instruction
#pragma unroll
      for (int c = 0; c < kW; ++c) {
        uint4 x;
        x.x = v[(4 * c) / kW][(4 * c) % kW];
        x.y = v[(4 * c + 1) / kW][(4 * c + 1) % kW];
        x.z = v[(4 * c + 2) / kW][(4 * c + 2) % kW];
        x.w = v[(4 * c + 3) / kW][(4 * c + 3) % kW];
        reinterpret_cast<uint4*>(s_out)[kW * l + c] = x;
      }
      __syncwarp();
      uint32_t* o = static_cast<uint32_t*>(a.out) + base * kW;
      if (aligned16(o)) {
#pragma unroll
        for (int c = 0; c < kW; ++c)
          put(reinterpret_cast<uint4*>(o) + 32 * c + l,
              reinterpret_cast<const uint4*>(s_out)[32 * c + l]);
      } else {
        for (int k = l; k < kTile * kW; k += 32) put(o + k, s_out[k]);
      }
      __syncwarp();
    } else if constexpr (kForm == kRowsU32) {
      // one word a row: the lane's 4 rows are 16 of the warp's 512
      // contiguous bytes already
      uint32_t* o = static_cast<uint32_t*>(a.out) + base + 4 * l;
      if (aligned16(o)) {
        put(reinterpret_cast<uint4*>(o),
            make_uint4(v[0][0], v[1][0], v[2][0], v[3][0]));
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) put(o + q, v[q][0]);
      }
    } else {
      unsigned long long* o = static_cast<unsigned long long*>(a.out);
#pragma unroll
      for (int w = 0; w < kW; ++w) {
        unsigned long long* plane = o + w * a.n + base + 2 * l;
        store_pair(plane, v[0][w], v[1][w]);
        store_pair(plane + 64, v[2][w], v[3][w]);
      }
    }
  } else {
    // W > 4: a word at a time
    const int W = a.W;
    bool ok[4];
    uint32_t r[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      ok[q] = in_table<kForm>(t.at(q), a.T);
      r[q] = (uint32_t)t.at(q);
    }
    if constexpr (kForm == kRowsU32) {
      uint32_t* o = static_cast<uint32_t*>(a.out) + (base + 4 * l) * W;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        for (int w = 0; w < W; ++w)
          put(o + q * W + w,
              ok[q] ? word_at<kForm, kShared>(s, a, W, r[q], w) : 0u);
    } else {
      unsigned long long* o = static_cast<unsigned long long*>(a.out);
      for (int w = 0; w < W; ++w) {
        uint32_t x[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          x[q] = ok[q] ? word_at<kForm, kShared>(s, a, W, r[q], w) : 0u;
        unsigned long long* plane = o + w * a.n + base + 2 * l;
        store_pair(plane, x[0], x[1]);
        store_pair(plane + 64, x[2], x[3]);
      }
    }
  }
}

// One row by itself: the rows before idx's first 16-byte boundary and after
// the last whole tile.
template <int kForm, int kW, bool kShared>
__device__ __forceinline__ void gather_row(const uint32_t* s, const Args& a,
                                           int64_t row) {
  const int W = kW > 0 ? kW : a.W;
  const Index<kForm> i = static_cast<const Index<kForm>*>(a.idx)[row];
  const bool ok = in_table<kForm>(i, a.T);
  for (int w = 0; w < W; ++w) {
    const uint32_t x =
        ok ? word_at<kForm, kShared>(s, a, W, (uint32_t)i, w) : 0u;
    if constexpr (kForm == kRowsU32)
      static_cast<uint32_t*>(a.out)[row * W + w] = x;
    else
      static_cast<unsigned long long*>(a.out)[w * a.n + row] = x;
  }
}

// The table into shared memory as 32-bit words, row-major at W words a row.
template <int kForm, int kW>
__device__ __forceinline__ void stage_table(const Args& a, uint32_t* s) {
  const int W = kW > 0 ? kW : a.W;
  if constexpr (kForm == kRowsU32) {
    // the same layout: a copy, 16 bytes a load where the table allows
    const int32_t* t = static_cast<const int32_t*>(a.table);
    const int64_t words = (int64_t)a.T * W;
    int64_t done = 0;
    if (aligned16(t)) {
      done = words & ~(int64_t)3;
      for (int64_t k = threadIdx.x; k < words >> 2; k += blockDim.x)
        reinterpret_cast<uint4*>(s)[k] =
            __ldg(reinterpret_cast<const uint4*>(t) + k);
    }
    for (int64_t k = done + threadIdx.x; k < words; k += blockDim.x)
      s[k] = (uint32_t)__ldg(t + k);
  } else {
    // from the planes, a row a thread: each plane's loads coalesced across
    // the warp, one vector store a row where the width allows
    for (uint32_t r = threadIdx.x; r < a.T; r += blockDim.x) {
      if constexpr (kW == 2 || kW == 4) {
        uint32_t v[4] = {0, 0, 0, 0};
#pragma unroll
        for (int w = 0; w < kW; ++w)
          v[w] = word_at<kForm, false>(s, a, kW, r, w);
        if constexpr (kW == 4)
          reinterpret_cast<uint4*>(s)[r] = make_uint4(v[0], v[1], v[2], v[3]);
        else
          reinterpret_cast<uint2*>(s)[r] = make_uint2(v[0], v[1]);
      } else {
        for (int w = 0; w < W; ++w)
          s[r * W + w] = word_at<kForm, false>(s, a, W, r, w);
      }
    }
  }
}

template <int kForm, int kW, bool kShared>
__device__ __forceinline__ void gather_body(const Args& a, uint32_t* s) {
  const int l = threadIdx.x & 31;
  // a warp's output tile lies past the table (past nothing when the table
  // is read from device memory)
  const uint32_t table_words =
      kShared ? (a.T * (kW > 0 ? kW : a.W) + 3) & ~3u : 0u;
  uint32_t* s_out = stages_out<kForm, kW>()
                        ? s + table_words + (threadIdx.x >> 5) * kTile * kW
                        : nullptr;
  const int64_t warps = (int64_t)gridDim.x * kWarps;
  int64_t t = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  Tile<kForm> ta, tb;
  // the first tile's indices are in flight while the table is staged
  if (t < a.tiles) ta.load(a, a.head + t * kTile, l);
  if constexpr (kShared) {
    stage_table<kForm, kW>(a, s);
    __syncthreads();
  }
  // the ragged rows, a thread each
  const int64_t ragged = a.n - a.tiles * kTile;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < ragged;
       j += (int64_t)gridDim.x * blockDim.x)
    gather_row<kForm, kW, kShared>(s, a, j < a.head ? j : j + a.tiles * kTile);
  // two tiles in turn, so that neither's registers move while its loads are
  // in flight
  while (t < a.tiles) {
    const int64_t t1 = t + warps;
    if (t1 < a.tiles) tb.load(a, a.head + t1 * kTile, l);
    gather_tile<kForm, kW, kShared>(s, a, ta, a.head + t * kTile, l, s_out);
    if (t1 >= a.tiles) break;
    const int64_t t2 = t1 + warps;
    if (t2 < a.tiles) ta.load(a, a.head + t2 * kTile, l);
    gather_tile<kForm, kW, kShared>(s, a, tb, a.head + t1 * kTile, l, s_out);
    t = t2;
  }
}

// The table staged in dynamic shared memory by every block.
template <int kForm, int kW>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    gather_words_shared(Args a) {
  extern __shared__ __align__(16) uint32_t s_table[];
  gather_body<kForm, kW, true>(a, s_table);
}

// The table read through L1/L2 when it does not fit a block.
template <int kForm, int kW>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    gather_words_global(Args a) {
  extern __shared__ __align__(16) uint32_t s_tiles[];
  gather_body<kForm, kW, false>(a, s_tiles);
}

template <int kForm, int kW>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  static qe::LaunchCache<decltype(&gather_words_shared<kForm, kW>)>
      shared_cache;
  static qe::LaunchCache<decltype(&gather_words_global<kForm, kW>)>
      global_cache;
  int dev = 0;
  qe::DeviceLimits lim;
  cudaError_t err = qe::device_limits(&dev, &lim);
  if (err != cudaSuccess) return err;
  // one warp a tile, and one block at least for the ragged rows
  const int64_t blocks_needed =
      a.tiles > 0 ? (a.tiles + kWarps - 1) / kWarps : 1;
  // the table at W words a row, rounded up to 16 bytes
  const size_t table_bytes = ((size_t)a.T * a.W + 3) / 4 * 16;
  const size_t tile_bytes =
      stages_out<kForm, kW>() ? (size_t)kWarps * kTile * kW * 4 : 0;
  const bool shared = table_bytes + tile_bytes <= (size_t)lim.smem_optin;
  const size_t smem = (shared ? table_bytes : 0) + tile_bytes;
  int per_sm = 0;
  err = shared ? shared_cache.blocks_per_sm(gather_words_shared<kForm, kW>,
                                            dev, lim, kThreads, smem, &per_sm)
               : global_cache.blocks_per_sm(gather_words_global<kForm, kW>,
                                            dev, lim, kThreads, smem,
                                            &per_sm);
  if (err != cudaSuccess) return err;
  // resident blocks only: each stages the table once, then strides over
  // the tiles
  const int64_t full =
      (int64_t)(per_sm < kBlocksPerSm ? per_sm : kBlocksPerSm) * lim.sms;
  const int grid = (int)(blocks_needed < full ? blocks_needed : full);
  if (shared)
    gather_words_shared<kForm, kW><<<grid, kThreads, smem, stream>>>(a);
  else
    gather_words_global<kForm, kW><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int kForm>
int gather(const void* idx, const void* table, int64_t n, int T, int W,
           void* out, cudaStream_t stream) {
  constexpr int64_t kIdxBytes = sizeof(Index<kForm>);
  const uintptr_t p = reinterpret_cast<uintptr_t>(idx);
  if (n < 0 || T < 0 || W < 1 || W > kMaxWords || p % kIdxBytes != 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  Args a;
  a.idx = idx;
  a.table = table;
  a.out = out;
  a.n = n;
  const int64_t head = (int64_t)((16 - (p & 15)) & 15) / kIdxBytes;
  a.head = head < n ? head : n;
  a.tiles = (n - a.head) / kTile;
  a.T = (uint32_t)T;
  a.W = W;
  switch (W) {
    case 1: return (int)launch<kForm, 1>(a, stream);
    case 2: return (int)launch<kForm, 2>(a, stream);
    case 3: return (int)launch<kForm, 3>(a, stream);
    case 4: return (int)launch<kForm, 4>(a, stream);
    default: return (int)launch<kForm, 0>(a, stream);
  }
}

}  // namespace

// Both return a cudaError_t: 0 when the launch succeeded (or n is 0).
// They launch on `stream` and do not synchronise; `out` is written in full,
// so the caller need not zero it. idx must be aligned to its element.
extern "C" int qe_small_gather_u32(const int32_t* idx, const int32_t* table,
                                   int64_t n, int T, int W, int32_t* out,
                                   cudaStream_t stream) {
  return gather<kRowsU32>(idx, table, n, T, W, out, stream);
}

extern "C" int qe_small_gather_planes(const int64_t* idx,
                                      const int64_t* planes, int64_t n, int T,
                                      int W, int64_t* out,
                                      cudaStream_t stream) {
  return gather<kPlanesU64>(idx, planes, n, T, W, out, stream);
}
