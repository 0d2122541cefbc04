// Grouped SUM/COUNT over dense group ids: the Hopper kernel of the GROUP BY
// aggregate and of every grouped count or sum on the card.
//
// Replaces the TPU kernel `_make_kernel_fact`, launched by
// `_mxu_chunk_totals_fact`, in query_engine_tpu/ops/pallas/group_agg.py.
// That kernel turned the scatter into a bf16 one-hot matmul over 8-bit value
// chunks because the TPU has no 64-bit integer adds; Hopper adds integers in
// shared and device memory, so this kernel adds the words directly.
//
// Contract (the plain version is `accumulate_plain` in ops/group_agg.py):
//   gid    [n] int32 or int64; row r belongs to group gid[r] when
//          0 <= gid < G; any other id excludes the row from every item
//   items  up to kMaxItems descriptors read where they lie, no copies:
//            COUNT  ok only                    -> rows: count
//            I64/I32 values, ok                -> rows: sum, count
//            F64/F32 values, ok                -> rows: sum_lo, sum_hi,
//                                                  count, flags
//          ok [n] uint8 (torch bool); a row counts in an item iff ok != 0
//   out    [R, G] int64, the items' rows in order. Sums wrap mod 2^64.
//          A float item quantizes each ok, finite row to q = rint(x * 2^k)
//          (round half to even) with k = 62 - e, where max|x| < 2^e over
//          the ok, finite rows of the whole plane, so |q| < 2^62 whatever
//          n is. Its sum is kept exactly in two rows: sum_lo adds
//          q & 0xffffffff (each term below 2^32: below 2^63 for n < 2^31)
//          and sum_hi adds q >> 32 (arithmetic; each term below 2^30 in
//          magnitude); sum_hi * 2^32 + sum_lo is the exact sum of q. Its
//          flags row ORs 1 (+inf), 2 (-inf), 4 (NaN) over its ok rows.
//   inv_scale [F] float64: 2^-k per float item, written by block 0.
// Integer addition mod 2^64 does not depend on order, so every output is
// exact and the same bits on every run, whatever the atomic order. A float
// sum's error is the quantization of each x alone (at most max|x| * 2^-62
// a row) and one float64 rounding when `finish_float` rebuilds it: it does
// not grow with the plane's capacity. Nothing is read back to the host:
// the call runs inside a captured CUDA graph.
//
// What bounds it on an H100: device-memory bytes, the gid plane plus each
// item's values and ok plane read once, and the [R, G] output written once.
// The kernel this one replaced ran at 22 % of that bound: every lane issued
// 64-bit shared-memory atomics (a compare-and-swap loop on this card), each
// item's loads waited on the loads before them, and its wrapper copied
// every input into stacked planes before the launch. This design:
//   * reads the items where they lie and quantizes floats in registers; a
//     small pass before it (`float_absmax`) finds max|x| per float item;
//   * gives each lane 4 consecutive rows, read with 16-byte loads, and
//     issues a step's loads one (tile, item) step ahead of its use, so the
//     memory latency overlaps the atomics of the step before;
//   * adds a run of equal ids among a lane's rows once (sorted runs), and a
//     warp whose 128 rows are one group once, by shuffles;
//   * keeps 32-bit counts and each 64-bit sum as two 32-bit words in
//     shared memory (a carry out of the low word is seen from the low add's
//     returned old value: exact mod 2^64), flushed once per block;
//   * compiles a launch without a float item apart (kFloats false), so
//     integer and COUNT items run none of the float items' code;
//   * sends groups past the shared table (the segment route at G = 2^23)
//     to device-memory atomics, so ids below the table's size still share
//     a block's table (Q9's ~175 live groups of 2^23 slots all do).
// A __match_any_sync warp aggregation was measured and lost: on uniform ids
// and on Q1's four groups it cost more than the atomics it saved.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_config.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kRows = 4;  // consecutive rows per lane: 16-byte loads
constexpr int kTile = 32 * kRows;  // rows per warp step
constexpr int kMaxItems = 16;
// shared table budget per block: 3 blocks of 512 threads fit an SM
constexpr size_t kSmemBudget = 72 * 1024;
constexpr unsigned kFull = 0xffffffffu;

enum Kind { kCount = 0, kI64 = 1, kI32 = 2, kF64 = 3, kF32 = 4 };

__host__ __device__ inline int rows_of(int kind) {
  return kind == kCount ? 1 : (kind <= kI32 ? 2 : 4);
}
__host__ __device__ inline int planes_of(int kind) {
  // 32-bit shared planes: an integer item's sum as two words and its
  // count; a float item's sum_lo and sum_hi as two words each, its count
  // and its flags
  return kind == kCount ? 1 : (kind <= kI32 ? 3 : 6);
}
__host__ __device__ inline bool wide(int kind) {  // 8-byte values
  return kind == kI64 || kind == kF64;
}

struct Item {
  const void* vals;
  const uint8_t* ok;
  int kind;
  int row;    // first output row
  int plane;  // first shared plane
  int fslot;  // float slot (max, scale) or -1
};

struct Params {
  const void* gid;
  int64_t n;
  int G;
  int T;  // ids below T use the block's shared table
  int n_items;
  Item items[kMaxItems];
  unsigned long long* out;
  const unsigned long long* fmax;  // max|x| bits per float slot
  double* inv_scale;
};

// The loads of one step: lane's kRows consecutive rows from row r0 of one
// item (and of gid when `with_gid`): 16-byte loads where the chunk is
// whole, element loads on the ragged tail. Rows past n read as excluded.
struct Loads {
  long long gid[kRows];
  unsigned ok;  // byte j: row r0 + j's ok
  unsigned long long bits[kRows];
};

template <typename Gid>
__device__ __forceinline__ void load_step(const Params& p, const Item& it,
                                          int64_t r0, bool with_gid,
                                          Loads* L) {
  if (r0 + kRows <= p.n) {
    if (with_gid) {
      if (sizeof(Gid) == 4) {
        const int4 v = *reinterpret_cast<const int4*>(
            static_cast<const int*>(p.gid) + r0);
        L->gid[0] = v.x; L->gid[1] = v.y; L->gid[2] = v.z; L->gid[3] = v.w;
      } else {
        const longlong2* q = reinterpret_cast<const longlong2*>(
            static_cast<const long long*>(p.gid) + r0);
        const longlong2 a = q[0], b = q[1];
        L->gid[0] = a.x; L->gid[1] = a.y; L->gid[2] = b.x; L->gid[3] = b.y;
      }
    }
    L->ok = *reinterpret_cast<const unsigned*>(it.ok + r0);
    if (wide(it.kind)) {
      const ulonglong2* q = reinterpret_cast<const ulonglong2*>(
          static_cast<const unsigned long long*>(it.vals) + r0);
      const ulonglong2 a = q[0], b = q[1];
      L->bits[0] = a.x; L->bits[1] = a.y; L->bits[2] = b.x; L->bits[3] = b.y;
    } else if (it.kind != kCount) {
      const uint4 v = *reinterpret_cast<const uint4*>(
          static_cast<const unsigned*>(it.vals) + r0);
      L->bits[0] = v.x; L->bits[1] = v.y; L->bits[2] = v.z; L->bits[3] = v.w;
    }
    return;
  }
  L->ok = 0u;
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int64_t r = r0 + j;
    const bool in = r < p.n;
    if (with_gid)
      L->gid[j] = in ? (long long)static_cast<const Gid*>(p.gid)[r] : -1;
    if (in) L->ok |= (unsigned)it.ok[r] << (8 * j);
    unsigned long long b = 0ull;
    if (in && wide(it.kind))
      b = static_cast<const unsigned long long*>(it.vals)[r];
    else if (in && it.kind != kCount)
      b = static_cast<const unsigned*>(it.vals)[r];
    L->bits[j] = b;
  }
}

// max|x| over ok, finite rows of each float item: one atomicMax a block on
// the bits of a non-negative double, whose order is the unsigned order.
template <typename Gid>
__global__ void __launch_bounds__(kThreads) float_absmax(
    const __grid_constant__ Params p, unsigned long long* fmax) {
  __shared__ unsigned long long warp_max[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t n_chunks = (p.n + kRows - 1) / kRows;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int i = 0; i < p.n_items; ++i) {
    const Item& it = p.items[i];
    if (it.fslot < 0) continue;
    unsigned long long m = 0ull;
    for (int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
         c < n_chunks; c += stride) {
      Loads L;
      load_step<Gid>(p, it, c * kRows, false, &L);
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const double x =
            it.kind == kF64 ? __longlong_as_double((long long)L.bits[j])
                            : (double)__int_as_float((int)L.bits[j]);
        if (((L.ok >> (8 * j)) & 0xffu) && isfinite(x)) {
          const unsigned long long b = __double_as_longlong(fabs(x));
          m = b > m ? b : m;
        }
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      const unsigned long long t = __shfl_xor_sync(kFull, m, o);
      m = t > m ? t : m;
    }
    if (lane == 0) warp_max[warp] = m;
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < (int)(blockDim.x >> 5); ++w)
        m = warp_max[w] > m ? warp_max[w] : m;
      if (m != 0ull) atomicMax(&fmax[it.fslot], m);
    }
    __syncthreads();
  }
}

// 2^k as a double from its bits, k in [-1022, 1023].
__device__ __forceinline__ double pow2(int k) {
  return __longlong_as_double((long long)(k + 1023) << 52);
}

// The fixed-point exponent of `quantize()` in ops/group_agg.py:
// k = clamp(62 - e, -1000, 1000), m = mant * 2^e, mant in [0.5, 1).
__device__ __forceinline__ int scale_exponent(unsigned long long mbits) {
  const unsigned long long tiny = 0x0010000000000000ull;  // 2^-1022
  if (mbits < tiny) mbits = tiny;
  const int e = (int)((mbits >> 52) & 0x7ff) - 1022;
  int k = 62 - e;
  return k < -1000 ? -1000 : (k > 1000 ? 1000 : k);
}

// Adds a 64-bit value to the (lo, hi) words of a shared sum, exactly mod
// 2^64: the low add's returned old value shows its carry.
__device__ __forceinline__ void shared_add64(unsigned* lo, unsigned* hi,
                                             unsigned long long v) {
  const unsigned vlo = (unsigned)v;
  unsigned vhi = (unsigned)(v >> 32);
  if (vlo) {
    const unsigned old = atomicAdd(lo, vlo);
    vhi += (old + vlo) < old ? 1u : 0u;
  }
  if (vhi) atomicAdd(hi, vhi);
}

// Adds one group's sum (an integer item's in `s`; a float item's sum_lo
// in `s` and sum_hi in `h`), count and flag bits of an item: to the
// block's table below T, to device memory above. kFloats: the launch has
// a float item (without one, the code is the integer items' alone).
template <bool kFloats>
__device__ __forceinline__ void emit(const Params& p, unsigned* table,
                                     const Item& it, int g,
                                     unsigned long long s,
                                     unsigned long long h, unsigned c,
                                     unsigned f) {
  const int T = p.T;
  const bool fl = kFloats && it.kind >= kF64;
  if (g < T) {
    unsigned* pl = table + (size_t)it.plane * T + g;
    if (it.kind == kCount) {
      if (c) atomicAdd(pl, c);
      return;
    }
    if (s) shared_add64(pl, pl + T, s);
    if (!fl) {
      if (c) atomicAdd(pl + 2 * T, c);
      return;
    }
    if (h) shared_add64(pl + 2 * T, pl + 3 * T, h);
    if (c) atomicAdd(pl + 4 * T, c);
    if (f) atomicOr(pl + 5 * T, f);
    return;
  }
  unsigned long long* o = p.out + (size_t)g;
  const size_t G = (size_t)p.G;
  if (it.kind == kCount) {
    if (c) atomicAdd(o + it.row * G, (unsigned long long)c);
    return;
  }
  if (s) atomicAdd(o + it.row * G, s);
  if (!fl) {
    if (c) atomicAdd(o + (it.row + 1) * G, (unsigned long long)c);
    return;
  }
  if (h) atomicAdd(o + (it.row + 1) * G, h);
  if (c) atomicAdd(o + (it.row + 2) * G, (unsigned long long)c);
  if (f) atomicOr(o + (it.row + 3) * G, (unsigned long long)f);
}

// One step: item `item` of the lane's kRows rows, from the registers `L`;
// `g` holds the rows' group ids (-1 when excluded) and `one` says the
// warp's whole step is one group.
template <bool kFloats>
__device__ __forceinline__ void consume(const Params& p, const double* p2k,
                                        unsigned* table, int item,
                                        const Loads& L, const int* g,
                                        bool one) {
  const Item& it = p.items[item];
  // x: an integer item's value, or a float item's q & 0xffffffff; h: a
  // float item's q >> 32 (0 for the other kinds)
  unsigned long long x[kRows], h[kRows];
  unsigned ok[kRows], f[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    ok[j] = (g[j] >= 0 && ((L.ok >> (8 * j)) & 0xffu)) ? 1u : 0u;
    x[j] = h[j] = 0ull;
    f[j] = 0u;
    if (!ok[j] || it.kind == kCount) continue;
    if (it.kind == kI64) {
      x[j] = L.bits[j];
    } else if (it.kind == kI32) {
      x[j] = (unsigned long long)(long long)(int)L.bits[j];
    } else if (kFloats) {
      const double v =
          it.kind == kF64 ? __longlong_as_double((long long)L.bits[j])
                          : (double)__int_as_float((int)L.bits[j]);
      if (isfinite(v)) {
        const long long q = __double2ll_rn(v * p2k[item]);
        x[j] = (unsigned long long)q & 0xffffffffull;
        h[j] = (unsigned long long)(q >> 32);
      } else {
        f[j] = isnan(v) ? 4u : (v > 0 ? 1u : 2u);
      }
    }
  }
  if (one) {  // warp-uniform: the warp's rows are all one group
    unsigned long long s = x[0] + x[1] + x[2] + x[3];
    unsigned long long hs = h[0] + h[1] + h[2] + h[3];
    unsigned c = ok[0] + ok[1] + ok[2] + ok[3];
    unsigned fl = f[0] | f[1] | f[2] | f[3];
    for (int o = 16; o > 0; o >>= 1) {
      s += __shfl_xor_sync(kFull, s, o);
      if (kFloats) hs += __shfl_xor_sync(kFull, hs, o);
      c += __shfl_xor_sync(kFull, c, o);
      fl |= __shfl_xor_sync(kFull, fl, o);
    }
    if ((threadIdx.x & 31) == 0)
      emit<kFloats>(p, table, it, g[0], s, hs, c, fl);
    return;
  }
  // runs of equal ids among the lane's consecutive rows add once
  int rg = g[0];
  unsigned long long rs = x[0], rh = h[0];
  unsigned rc = ok[0], rf = f[0];
#pragma unroll
  for (int j = 1; j < kRows; ++j) {
    if (g[j] != rg) {
      if (rg >= 0) emit<kFloats>(p, table, it, rg, rs, rh, rc, rf);
      rg = g[j];
      rs = rh = 0ull;
      rc = rf = 0u;
    }
    rs += x[j];
    rh += h[j];
    rc += ok[j];
    rf |= f[j];
  }
  if (rg >= 0) emit<kFloats>(p, table, it, rg, rs, rh, rc, rf);
}

template <typename Gid, bool kFloats>
__global__ void __launch_bounds__(kThreads) sum_count_shared(
    const __grid_constant__ Params p) {
  // 2^k per item, then the table's planes of T words (no static shared
  // memory: the opt-in limit covers the dynamic bytes alone)
  extern __shared__ double dyn[];
  double* p2k = dyn;
  unsigned* table = reinterpret_cast<unsigned*>(dyn + kMaxItems);
  const int T = p.T;
  const int lane = threadIdx.x & 31;
  int n_planes = 0;
  for (int i = 0; i < p.n_items; ++i) n_planes += planes_of(p.items[i].kind);
  for (int i = threadIdx.x; i < n_planes * T; i += blockDim.x) table[i] = 0u;
  if (threadIdx.x < p.n_items && p.items[threadIdx.x].fslot >= 0) {
    const int f = p.items[threadIdx.x].fslot;
    const int k = scale_exponent(p.fmax[f]);
    p2k[threadIdx.x] = pow2(k);
    if (blockIdx.x == 0) p.inv_scale[f] = pow2(-k);
  }
  __syncthreads();

  // Each warp walks its tiles of kTile rows (grid-stride) and, in each, the
  // items: a stream of (tile, item) steps whose loads are issued one step
  // ahead, so they are in flight while the step before is consumed.
  const int64_t n_tiles = (p.n + kTile - 1) / kTile;
  const int64_t warps = (int64_t)gridDim.x * (blockDim.x >> 5);
  int64_t tile = (int64_t)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  int item = 0;
  Loads next;
  if (tile < n_tiles)
    load_step<Gid>(p, p.items[0], tile * kTile + lane * kRows, true, &next);
  int g[kRows];
  bool one = false;
  while (tile < n_tiles) {
    const Loads cur = next;
    int64_t next_tile = tile;
    int next_item = item + 1;
    if (next_item == p.n_items) {
      next_item = 0;
      next_tile += warps;
    }
    if (next_tile < n_tiles)
      load_step<Gid>(p, p.items[next_item],
                     next_tile * kTile + lane * kRows, next_item == 0, &next);
    if (item == 0) {
      bool same = true;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const long long v = cur.gid[j];
        g[j] = (v >= 0 && v < p.G) ? (int)v : -1;
        same = same && g[j] == g[0];
      }
      const int first = __shfl_sync(kFull, g[0], 0);  // every lane
      one = __all_sync(kFull, same && g[0] >= 0 && g[0] == first);
    }
    consume<kFloats>(p, p2k, table, item, cur, g, one);
    tile = next_tile;
    item = next_item;
  }
  __syncthreads();

  // flush the block's table: one device-memory atomic per nonzero word
  for (int i = 0; i < p.n_items; ++i) {
    const Item& it = p.items[i];
    const unsigned* pl = table + (size_t)it.plane * T;
    for (int gg = threadIdx.x; gg < T; gg += blockDim.x) {
      unsigned long long* o = p.out + (size_t)gg;
      if (it.kind == kCount) {
        if (pl[gg]) atomicAdd(o + (size_t)it.row * p.G,
                              (unsigned long long)pl[gg]);
        continue;
      }
      // the item's 64-bit words (one sum for an integer item, sum_lo and
      // sum_hi for a float one), then its count and a float's flags
      const int words = kFloats && it.kind >= kF64 ? 2 : 1;
      for (int w = 0; w < words; ++w) {
        const unsigned long long s =
            (unsigned long long)pl[2 * w * T + gg] |
            ((unsigned long long)pl[(2 * w + 1) * T + gg] << 32);
        if (s) atomicAdd(o + (size_t)(it.row + w) * p.G, s);
      }
      const unsigned c = pl[2 * words * T + gg];
      if (c) atomicAdd(o + (size_t)(it.row + words) * p.G,
                       (unsigned long long)c);
      if (kFloats && it.kind >= kF64 && pl[5 * T + gg])
        atomicOr(o + (size_t)(it.row + 3) * p.G,
                 (unsigned long long)pl[5 * T + gg]);
    }
  }
}

template <typename Gid, bool kFloats>
cudaError_t launch(Params& p, size_t smem, const qe::DeviceLimits& lim,
                   int dev, int n_float, cudaStream_t stream) {
  static qe::LaunchCache<decltype(&sum_count_shared<Gid, kFloats>)> cache;
  const int64_t tiles = (p.n + kTile - 1) / kTile;
  const int64_t blocks_needed = (tiles + kThreads / 32 - 1) / (kThreads / 32);
  int per_sm = 0;
  cudaError_t err = cache.blocks_per_sm(sum_count_shared<Gid, kFloats>, dev,
                                        lim, kThreads, smem, &per_sm);
  if (err != cudaSuccess) return err;
  const int64_t full = (int64_t)per_sm * lim.sms;
  int grid = (int)(blocks_needed < full ? blocks_needed : full);
  if (grid < 1) grid = 1;  // block 0 writes the float scales
  if (n_float > 0) {
    float_absmax<Gid><<<grid, kThreads, 0, stream>>>(
        p, const_cast<unsigned long long*>(p.fmax));
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  sum_count_shared<Gid, kFloats><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t: 0 when every attribute query, memset and launch
// succeeded. Launches on `stream` and does not synchronise. `kinds`,
// `vals` and `oks` are host arrays of `n_items` (<= 16) entries; `vals[i]`
// is NULL for a COUNT item. gid and the values must be 16-byte aligned,
// the ok planes 4-byte aligned. `out` holds R x G int64 (R from the kinds),
// `fmax` and `inv_scale` one entry per float item; all three are written
// here (zero-filled first). The attribute queries are cached
// (launch_config.cuh), so a launch inside a CUDA graph capture, after a
// first eager launch, makes none.
extern "C" int qe_group_agg(const void* gid, int gid_is_64, int64_t n, int G,
                            int n_items, const int* kinds,
                            const void* const* vals, const void* const* oks,
                            int64_t* out,
                            unsigned long long* fmax, double* inv_scale,
                            cudaStream_t stream) {
  if (G <= 0 || n < 0 || n_items <= 0 || n_items > kMaxItems)
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  qe::DeviceLimits lim;
  cudaError_t err = qe::device_limits(&dev, &lim);
  if (err != cudaSuccess) return (int)err;

  Params p;
  p.gid = gid;
  p.n = n;
  p.G = G;
  p.n_items = n_items;
  p.out = reinterpret_cast<unsigned long long*>(out);
  p.fmax = fmax;
  p.inv_scale = inv_scale;
  // the 16-byte loads: gid and values 16-byte aligned, ok planes 4-byte
  auto misaligned = [](const void* q, uintptr_t a) {
    return (reinterpret_cast<uintptr_t>(q) & (a - 1)) != 0;
  };
  if (misaligned(gid, 16)) return (int)cudaErrorMisalignedAddress;
  int rows = 0, planes = 0, n_float = 0;
  for (int i = 0; i < n_items; ++i) {
    const int k = kinds[i];
    if (k < kCount || k > kF32) return (int)cudaErrorInvalidValue;
    if (misaligned(vals[i], 16) || misaligned(oks[i], 4))
      return (int)cudaErrorMisalignedAddress;
    p.items[i] = Item{vals[i], static_cast<const uint8_t*>(oks[i]), k, rows,
                      planes, k >= kF64 ? n_float++ : -1};
    rows += rows_of(k);
    planes += planes_of(k);
  }
  const int64_t fit = (int64_t)(kSmemBudget / (4 * (size_t)planes));
  p.T = (int)(G < fit ? G : fit);
  const size_t smem = kMaxItems * sizeof(double) + (size_t)p.T * planes * 4;

  err = cudaMemsetAsync(out, 0, (size_t)rows * G * sizeof(int64_t), stream);
  if (err == cudaSuccess && n_float > 0)
    err = cudaMemsetAsync(fmax, 0, n_float * sizeof(unsigned long long),
                          stream);
  if (err != cudaSuccess) return (int)err;
  if (n_float > 0)
    err = gid_is_64 ? launch<long long, true>(p, smem, lim, dev, n_float,
                                              stream)
                    : launch<int, true>(p, smem, lim, dev, n_float, stream);
  else
    err = gid_is_64 ? launch<long long, false>(p, smem, lim, dev, 0, stream)
                    : launch<int, false>(p, smem, lim, dev, 0, stream);
  return (int)err;
}
