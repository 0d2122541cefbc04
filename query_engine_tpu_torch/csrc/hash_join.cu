// Open-addressing hash join, build and probe: the Hopper kernels of the
// port's `ops/hash_join.py`.
//
// Replaces the XLA functions `hash_build` and `hash_probe_unique` of
// query_engine_tpu/ops/hash_join.py (:75, :118). Neither reaches a Pallas
// kernel: on the TPU each is a lax.while_loop of whole-array rounds (two
// full-length gathers and a scatter-min a build round), kept on the device
// by XLA. As torch ops every round would need a host read. Hopper gathers
// natively and has atomics, so each becomes one launch, one thread a row,
// each thread walking its own probe sequence; nothing is read back between
// the build and the probe.
//
//   qe_hash_build  keys [n] (int32 or int64), ok [n] bool, t_keys [T] of
//                  the key type preset to 0, t_rows [T] int32 preset to
//                  INT32_MAX (empty), T a power of two, overflow [1] int32
//                  preset to 0. A live row walks slots (h + step) & (T - 1)
//                  and claims the first empty one with atomicCAS on t_rows
//                  (INT32_MAX -> its row id); the winner then stores its
//                  key. A failed CAS means the slot is taken for good, so a
//                  row that fails T times has found every slot taken by
//                  another row: it sets *overflow and stops. Which of two
//                  rows racing for a slot wins depends on timing: the
//                  layout can differ from the JAX package's rounds (the
//                  smallest row id wins) and from run to run; every entry
//                  still lies on its own sequence with no empty slot before
//                  it, which is all the probe needs.
//   qe_hash_probe  a separate launch after the build, so every key store is
//                  visible: a thread per probe row walks its sequence until
//                  an empty slot (miss), its key (hit: ri = the slot's row),
//                  or T slots (a full table without the key: miss). Writes
//                  ri [n] int64 (0 where unmatched) and matched [n] bool.
//
// The hash is the JAX package's: murmur3's finalizer on 32-bit lanes; an
// int64 key mixes its low word, xor its high word xor 0x9E3779B9 mixed.
//
// What bounds it on an H100: device-memory traffic. The inputs and outputs
// stream, coalesced, a thread a row; the walk's reads are random, one
// 32-byte sector of t_rows and one of t_keys a step, so the bytes that the
// function must move (each input and output once, the table once) are a
// floor the random sectors keep it well above. The probe issues a step's two
// loads together, so both are in flight at once; a packed 16-byte slot (one
// sector a step) or a table kept in L2 are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kEmpty = 0x7FFFFFFF;

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t hash_key(int k) { return mix32((uint32_t)k); }

__device__ __forceinline__ uint32_t hash_key(long long k) {
  const unsigned long long u = (unsigned long long)k;
  return mix32((uint32_t)u) ^ mix32((uint32_t)(u >> 32) ^ 0x9E3779B9u);
}

template <typename K>
__global__ void __launch_bounds__(kThreads)
    hash_build_kernel(const K* __restrict__ keys,
                      const uint8_t* __restrict__ ok, int64_t n,
                      K* __restrict__ t_keys, int* __restrict__ t_rows,
                      uint32_t mask, int* __restrict__ overflow) {
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n || !ok[row]) return;
  const K key = keys[row];
  const uint32_t h = hash_key(key);
  const uint64_t slots = (uint64_t)mask + 1;
  for (uint64_t step = 0; step < slots; ++step) {
    const uint32_t slot = (h + (uint32_t)step) & mask;
    if (atomicCAS(t_rows + slot, kEmpty, (int)row) == kEmpty) {
      t_keys[slot] = key;
      return;
    }
  }
  *overflow = 1;
}

template <typename K>
__global__ void __launch_bounds__(kThreads)
    hash_probe_kernel(const K* __restrict__ t_keys,
                      const int* __restrict__ t_rows, uint32_t mask,
                      const K* __restrict__ keys,
                      const uint8_t* __restrict__ ok, int64_t n,
                      long long* __restrict__ ri,
                      uint8_t* __restrict__ matched) {
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  long long r = 0;
  uint8_t m = 0;
  if (ok[row]) {
    const K key = keys[row];
    const uint32_t h = hash_key(key);
    const uint64_t slots = (uint64_t)mask + 1;
    for (uint64_t step = 0; step < slots; ++step) {
      const uint32_t slot = (h + (uint32_t)step) & mask;
      // both loads issued before either is tested
      const int tr = __ldg(t_rows + slot);
      const K tk = __ldg(t_keys + slot);
      if (tr == kEmpty) break;
      if (tk == key) {
        r = tr;
        m = 1;
        break;
      }
    }
  }
  ri[row] = r;
  matched[row] = m;
}

unsigned int blocks_for(int64_t n) {
  return (unsigned int)((n + kThreads - 1) / kThreads);
}

}  // namespace

// keys, ok [n]; key_bytes 4 (int32) or 8 (int64); t_keys, t_rows [T] preset
// as above; overflow [1] int32 preset to 0. 0 < n < 2^31 - 1, T a power of
// two <= 2^31. Returns the launch's cudaError_t.
extern "C" int qe_hash_build(const void* keys, const void* ok, int64_t n,
                             int key_bytes, void* t_keys, void* t_rows,
                             int64_t T, void* overflow, void* stream) {
  if (n <= 0 || n >= kEmpty || T <= 0 || T > (1LL << 31) || (T & (T - 1)))
    return (int)cudaErrorInvalidValue;
  const uint32_t mask = (uint32_t)(T - 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* o = static_cast<const uint8_t*>(ok);
  if (key_bytes == 4) {
    hash_build_kernel<int><<<blocks_for(n), kThreads, 0, s>>>(
        static_cast<const int*>(keys), o, n, static_cast<int*>(t_keys),
        static_cast<int*>(t_rows), mask, static_cast<int*>(overflow));
  } else if (key_bytes == 8) {
    hash_build_kernel<long long><<<blocks_for(n), kThreads, 0, s>>>(
        static_cast<const long long*>(keys), o, n,
        static_cast<long long*>(t_keys), static_cast<int*>(t_rows), mask,
        static_cast<int*>(overflow));
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// t_keys, t_rows [T] (a built table); keys, ok [n]; ri [n] int64, matched
// [n] bool (written). Returns the launch's cudaError_t.
extern "C" int qe_hash_probe(const void* t_keys, const void* t_rows,
                             int64_t T, const void* keys, const void* ok,
                             int64_t n, int key_bytes, void* ri,
                             void* matched, void* stream) {
  if (n <= 0 || T <= 0 || T > (1LL << 31) || (T & (T - 1)))
    return (int)cudaErrorInvalidValue;
  const uint32_t mask = (uint32_t)(T - 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* o = static_cast<const uint8_t*>(ok);
  long long* r = static_cast<long long*>(ri);
  uint8_t* m = static_cast<uint8_t*>(matched);
  if (key_bytes == 4) {
    hash_probe_kernel<int><<<blocks_for(n), kThreads, 0, s>>>(
        static_cast<const int*>(t_keys), static_cast<const int*>(t_rows),
        mask, static_cast<const int*>(keys), o, n, r, m);
  } else if (key_bytes == 8) {
    hash_probe_kernel<long long><<<blocks_for(n), kThreads, 0, s>>>(
        static_cast<const long long*>(t_keys),
        static_cast<const int*>(t_rows), mask,
        static_cast<const long long*>(keys), o, n, r, m);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
