// Open-addressing hash join, build and probe: the Hopper kernels of the
// port's `ops/hash_join.py`.
//
// Replaces the XLA functions `hash_build` and `hash_probe_unique` of
// query_engine_tpu/ops/hash_join.py (:75, :118). Neither reaches a Pallas
// kernel: on the TPU each is a lax.while_loop of whole-array rounds (two
// full-length gathers and a scatter-min a build round), kept on the device
// by XLA. As torch ops every round would need a host read. Hopper gathers
// natively and has atomics, so each becomes one launch, a thread walking
// its own probe sequence; nothing is read back between build and probe.
//
// The table is one packed tensor, a slot holding its key and its row
// together, so a probe step reads one 32-byte sector, not one in each of
// two planes:
//
//   int64 keys  int64 [T, 2]: the key, then the row in the low word of the
//               second column and 0 in its high word (16 bytes, aligned)
//   int32 keys  int32 [T, 2]: (key, row), one 8-byte word
//
// An empty slot is (0, EMPTY = INT32_MAX).
//
//   qe_hash_build  keys [n] (int32 or int64), ok [n] bool, table as above
//                  (uninitialized), T a power of two, overflow [1] int32
//                  preset to 0. Two launches: the fill writes (0, EMPTY)
//                  into every slot, one 8- or 16-byte store a slot; then a
//                  thread a build row: a live row walks slots (h + step) &
//                  (T - 1)
//                  and claims the first empty one. int32 keys: one 64-bit
//                  atomicCAS of the whole slot, (0, EMPTY) -> (key, row).
//                  int64 keys: atomicCAS on the row word (EMPTY -> row),
//                  then the winner stores its key into the same slot, whose
//                  sector the CAS has just brought into L2. A failed CAS
//                  means the slot is taken for good, so a row that fails T
//                  times has found every slot taken by another row: it sets
//                  *overflow and stops. Which of two rows racing for a slot
//                  wins depends on timing: the layout can differ from the
//                  JAX package's rounds (the smallest row id wins) and from
//                  run to run; every entry still lies on its own sequence
//                  with no empty slot before it, which is all the probe
//                  needs.
//   qe_hash_probe  a separate launch after the build, so every key store is
//                  visible: a thread per probe row walks its sequence until
//                  an empty slot (miss), its key (hit: ri = the slot's row),
//                  or T slots (a full table without the key: miss). A step
//                  is one vector load of the whole slot (16 bytes for int64
//                  keys, 8 for int32), cached in L1, so a step into the
//                  same sector finds it there. A thread walks two rows, 256
//                  apart, and loads each row's next slot before it tests
//                  either. Writes ri [n] int64 (0 where unmatched) and
//                  matched [n] bool.
//
// Cache policy: the fill's stores and the probe's table loads carry an L2
// evict_last policy; the streamed reads (keys, ok) skip L1 and carry
// evict_first, and the outputs are streaming stores, so the probe's stream
// does not push the table (16-32 MiB at the shapes of chip_smoke.py phase
// 17) out of the 50 MB L2.
//
// The hash is the JAX package's: murmur3's finalizer on 32-bit lanes; an
// int64 key mixes its low word, xor its high word xor 0x9E3779B9 mixed.
//
// What bounds it on an H100: the probe's random slot reads, one sector a
// step (about 1.5 steps a hit at load 0.5), served by L2 while the table
// stays there: taking the evict_last policy away costs the probe 12 % on a
// 32 MiB int64 table and 34 % on a 16 MiB int32 one. The build's random
// atomics, which L2 executes: a claim is most of the build, the fill a
// sixth of it. Both stay well above the bytes the function must move (each
// input and output once, the table once): about a third of that bound
// for the probe, a seventh for the build (PERF.md, the hash join's rows).
// Tried and not kept (scripts/hash_variants.py): four probe rows a thread,
// two or four build rows a thread, 128 or 512 threads a block, one 128-bit
// CAS for an int64 claim.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 2;  // probe rows a thread walks together
constexpr int kEmpty = 0x7FFFFFFF;

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t hash_key(int k) {
  return mix32((uint32_t)k);
}

__device__ __forceinline__ uint32_t hash_key(long long k) {
  const unsigned long long u = (unsigned long long)k;
  return mix32((uint32_t)u) ^ mix32((uint32_t)(u >> 32) ^ 0x9E3779B9u);
}

// L2 eviction policies (sm_80+)
__device__ __forceinline__ uint64_t policy_keep() {
  uint64_t p;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(p));
  return p;
}

__device__ __forceinline__ uint64_t policy_stream() {
  uint64_t p;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(p));
  return p;
}

// streamed reads: not kept in L1, first out of L2
__device__ __forceinline__ bool load_ok(const uint8_t* p, uint64_t pol) {
  uint32_t v;
  asm volatile(
      "ld.global.nc.L1::no_allocate.L2::cache_hint.u8 %0, [%1], %2;"
      : "=r"(v) : "l"(p), "l"(pol));
  return v != 0;
}

__device__ __forceinline__ int load_key(const int* p, uint64_t pol) {
  int v;
  asm volatile(
      "ld.global.nc.L1::no_allocate.L2::cache_hint.b32 %0, [%1], %2;"
      : "=r"(v) : "l"(p), "l"(pol));
  return v;
}

__device__ __forceinline__ long long load_key(const long long* p,
                                              uint64_t pol) {
  long long v;
  asm volatile(
      "ld.global.nc.L1::no_allocate.L2::cache_hint.b64 %0, [%1], %2;"
      : "=l"(v) : "l"(p), "l"(pol));
  return v;
}

// one packed slot, one vector load: (key, row)
__device__ __forceinline__ void load_slot(const int* table, uint32_t slot,
                                          uint64_t pol, int& key, int& row) {
  unsigned long long w;
  asm volatile("ld.global.nc.L2::cache_hint.b64 %0, [%1], %2;"
      : "=l"(w) : "l"(table + 2 * (uint64_t)slot), "l"(pol));
  key = (int)(uint32_t)w;
  row = (int)(uint32_t)(w >> 32);
}

__device__ __forceinline__ void load_slot(const long long* table,
                                          uint32_t slot, uint64_t pol,
                                          long long& key, int& row) {
  unsigned long long k, r;
  asm volatile("ld.global.nc.L2::cache_hint.v2.b64 {%0, %1}, [%2], %3;"
      : "=l"(k), "=l"(r) : "l"(table + 2 * (uint64_t)slot), "l"(pol));
  key = (long long)k;
  row = (int)(uint32_t)r;
}

// an empty slot, (0, EMPTY), in one store
__device__ __forceinline__ void store_empty(int* table, int64_t slot,
                                            uint64_t pol) {
  asm volatile("st.global.L2::cache_hint.v2.b32 [%0], {%1, %2}, %3;"
               :: "l"(table + 2 * slot), "r"(0), "r"(kEmpty), "l"(pol)
               : "memory");
}

__device__ __forceinline__ void store_empty(long long* table, int64_t slot,
                                            uint64_t pol) {
  asm volatile("st.global.L2::cache_hint.v4.b32 [%0], {%1, %2, %3, %4}, %5;"
               :: "l"(table + 2 * slot), "r"(0), "r"(0), "r"(kEmpty),
                  "r"(0), "l"(pol)
               : "memory");
}

// Claims `slot` for (key, row) if it is empty: one atomic for int32 keys
// (the whole 8-byte slot), the row word's then a key store for int64.
__device__ __forceinline__ bool claim(int* table, uint32_t slot, int key,
                                      int row) {
  const unsigned long long empty = (unsigned long long)kEmpty << 32;
  const unsigned long long mine =
      ((unsigned long long)(uint32_t)row << 32) | (uint32_t)key;
  return atomicCAS(reinterpret_cast<unsigned long long*>(table) + slot,
                   empty, mine) == empty;
}

__device__ __forceinline__ bool claim(long long* table, uint32_t slot,
                                      long long key, int row) {
  long long* s = table + 2 * (uint64_t)slot;
  if (atomicCAS(reinterpret_cast<int*>(s + 1), kEmpty, row) != kEmpty)
    return false;
  s[0] = key;
  return true;
}

template <typename K>
__global__ void __launch_bounds__(kThreads)
    hash_fill_kernel(K* __restrict__ table, int64_t T) {
  const int64_t slot = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (slot < T) store_empty(table, slot, policy_keep());
}

template <typename K>
__global__ void __launch_bounds__(kThreads)
    hash_build_kernel(const K* __restrict__ keys,
                      const uint8_t* __restrict__ ok, int64_t n,
                      K* __restrict__ table, uint32_t mask,
                      int* __restrict__ overflow) {
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const uint64_t stream = policy_stream();
  if (!load_ok(ok + row, stream)) return;
  const K key = load_key(keys + row, stream);
  const uint32_t h = hash_key(key);
  const uint64_t slots = (uint64_t)mask + 1;
  for (uint64_t step = 0; step < slots; ++step) {
    if (claim(table, (h + (uint32_t)step) & mask, key, (int)row)) return;
  }
  *overflow = 1;
}

template <typename K>
__global__ void __launch_bounds__(kThreads)
    hash_probe_kernel(const K* __restrict__ table, uint32_t mask,
                      const K* __restrict__ keys,
                      const uint8_t* __restrict__ ok, int64_t n,
                      long long* __restrict__ ri,
                      uint8_t* __restrict__ matched) {
  const uint64_t keep = policy_keep();
  const uint64_t stream = policy_stream();
  const int64_t base =
      (int64_t)blockIdx.x * (kThreads * kRowsPerThread) + threadIdx.x;
  K key[kRowsPerThread], tk[kRowsPerThread];
  int tr[kRowsPerThread];
  uint32_t slot[kRowsPerThread];
  bool live[kRowsPerThread];
  long long r[kRowsPerThread];
  bool any = false;
  // every row's first slot is loaded before any is tested
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    const int64_t row = base + (int64_t)j * kThreads;
    r[j] = -1;  // unmatched
    live[j] = row < n && load_ok(ok + row, stream);
    if (live[j]) {
      key[j] = load_key(keys + row, stream);
      slot[j] = hash_key(key[j]) & mask;
      load_slot(table, slot[j], keep, tk[j], tr[j]);
      any = true;
    }
  }
  const uint64_t slots = (uint64_t)mask + 1;
  for (uint64_t step = 1; any; ++step) {
    any = false;
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      if (!live[j]) continue;
      if (tr[j] == kEmpty) {
        live[j] = false;
      } else if (tk[j] == key[j]) {
        r[j] = tr[j];
        live[j] = false;
      } else {
        slot[j] = (slot[j] + 1) & mask;
        any = true;
      }
    }
    if (step == slots) break;  // T slots walked: a full table, a miss
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      if (live[j]) load_slot(table, slot[j], keep, tk[j], tr[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    const int64_t row = base + (int64_t)j * kThreads;
    if (row >= n) continue;
    __stcs(ri + row, r[j] < 0 ? 0LL : r[j]);
    __stcs(matched + row, (unsigned char)(r[j] >= 0));
  }
}

unsigned int blocks_for(int64_t n, int rows_per_block) {
  return (unsigned int)((n + rows_per_block - 1) / rows_per_block);
}

bool bad_table_size(int64_t T) {
  return T <= 0 || T > (1LL << 31) || (T & (T - 1));
}

template <typename K>
int build(const K* keys, const uint8_t* ok, int64_t n, K* table, int64_t T,
          int* overflow, cudaStream_t s) {
  hash_fill_kernel<K><<<blocks_for(T, kThreads), kThreads, 0, s>>>(table, T);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n == 0) return (int)e;
  hash_build_kernel<K><<<blocks_for(n, kThreads), kThreads, 0, s>>>(
      keys, ok, n, table, (uint32_t)(T - 1), overflow);
  return (int)cudaGetLastError();
}

}  // namespace

// keys, ok [n]; key_bytes 4 (int32) or 8 (int64); table [T, 2] of the key
// type (16-byte aligned for int64 keys, 8 for int32), filled here;
// overflow [1] int32 preset to 0. 0 <= n < 2^31 - 1 (n = 0: the fill
// alone), T a power of two <= 2^31. Returns the launches' cudaError_t.
extern "C" int qe_hash_build(const void* keys, const void* ok, int64_t n,
                             int key_bytes, void* table, int64_t T,
                             void* overflow, void* stream) {
  if (n < 0 || n >= kEmpty || bad_table_size(T))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* o = static_cast<const uint8_t*>(ok);
  int* flag = static_cast<int*>(overflow);
  if (key_bytes == 4)
    return build(static_cast<const int*>(keys), o, n,
                 static_cast<int*>(table), T, flag, s);
  if (key_bytes == 8)
    return build(static_cast<const long long*>(keys), o, n,
                 static_cast<long long*>(table), T, flag, s);
  return (int)cudaErrorInvalidValue;
}

// table [T, 2] (a built table, aligned as above); keys, ok [n]; ri [n]
// int64, matched [n] bool (written). Returns the launch's cudaError_t.
extern "C" int qe_hash_probe(const void* table, int64_t T, const void* keys,
                             const void* ok, int64_t n, int key_bytes,
                             void* ri, void* matched, void* stream) {
  if (n <= 0 || bad_table_size(T)) return (int)cudaErrorInvalidValue;
  const uint32_t mask = (uint32_t)(T - 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* o = static_cast<const uint8_t*>(ok);
  long long* r = static_cast<long long*>(ri);
  uint8_t* m = static_cast<uint8_t*>(matched);
  const unsigned int blocks = blocks_for(n, kThreads * kRowsPerThread);
  if (key_bytes == 4) {
    hash_probe_kernel<int><<<blocks, kThreads, 0, s>>>(
        static_cast<const int*>(table), mask, static_cast<const int*>(keys),
        o, n, r, m);
  } else if (key_bytes == 8) {
    hash_probe_kernel<long long><<<blocks, kThreads, 0, s>>>(
        static_cast<const long long*>(table), mask,
        static_cast<const long long*>(keys), o, n, r, m);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
