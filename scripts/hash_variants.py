"""The hash join's build and probe kernels beside copies of their source with
other constants or other lines, on the card, in one process.

Each `--set` makes one copy of query_engine_tpu_torch/csrc/hash_join.cu: an
item `NAME=VALUE` of its comma-separated list replaces the value of the
source's one line `constexpr int NAME = ...;` (kThreads, kRowsPerThread: the
probe rows a thread walks together, each row's next slot loaded before any
is tested), an item `OLD=>NEW` replaces that text wherever it occurs (e.g.
`L2::evict_last=>L2::evict_normal` takes the table's cache policy out), an
item `cas128` makes the int64 build claim with one 128-bit CAS, `build2` or
`build4` makes a build thread place 2 or 4 rows (`NAMED`). A copy is built
as scripts/factorized_variants.py builds its copies, with `qe_hash_build`
and `qe_hash_probe` renamed. At `chip_smoke.py` phase 17's cases (a) (2^23
probe rows, 2^20 unique int64 build keys) and (b) (bench.py's 2^24 int32
probe keys), every copy's build must give a table that passes `check_table`,
and its probe on the checkout's table the checkout's (ri, matched). Then, in
turns, twice (a CUDA graph of 10 calls replayed between CUDA events,
`chip_smoke.graph_ms`): for the checkout's kernels ("base") and each copy
the build (its fill and its claims) and the probe on the checkout's table;
and fills alone: the build kernel's (`qe_hash_build` with no rows), one pass
of torch (a broadcast copy of the slot pattern (0, EMPTY) into the packed
table), the two planes' fills of the unpacked layout (torch.full and
torch.zeros) and a fill written here (FILL_SOURCE: one vector store a slot
under the L2 policy evict_normal or evict_last). It prints one JSON line:
per case the ms of each, with the card's name and power limit.

    python scripts/hash_variants.py --set kRowsPerThread=1 \\
        --set "L2::evict_last=>L2::evict_normal" --set build2

Exits non-zero without CUDA.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BUILD, PROBE = "qe_hash_build", "qe_hash_probe"

# A yardstick fill: every slot (0, EMPTY), one store a slot (8 bytes for
# int32 keys, 16 for int64), the lines given the L2 policy evict_last when
# `keep` is set.
FILL_SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

template <int kBytes>
__global__ void fill_kernel(void* table, int64_t T, int keep) {
  uint64_t pol;
  if (keep)
    asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(pol));
  else
    asm("createpolicy.fractional.L2::evict_normal.b64 %0, 1.0;"
        : "=l"(pol));
  const unsigned int empty = 0x7FFFFFFFu;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < T;
       i += (int64_t)gridDim.x * blockDim.x) {
    if (kBytes == 8) {
      asm volatile("st.global.L2::cache_hint.v2.b32 [%0], {%1, %2}, %3;"
                   :: "l"((char*)table + 8 * i), "r"(0u), "r"(empty),
                      "l"(pol) : "memory");
    } else {
      asm volatile(
          "st.global.L2::cache_hint.v4.b32 [%0], {%1, %2, %3, %4}, %5;"
          :: "l"((char*)table + 16 * i), "r"(0u), "r"(0u), "r"(empty),
             "r"(0u), "l"(pol) : "memory");
    }
  }
}

extern "C" int hash_fill(void* table, int64_t T, int key_bytes, int keep,
                         void* stream) {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  const int64_t want = (T + 255) / 256;
  const unsigned int blocks =
      (unsigned int)(want < 8LL * sms ? want : 8LL * sms);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (key_bytes == 4)
    fill_kernel<8><<<blocks, 256, 0, s>>>(table, T, keep);
  else
    fill_kernel<16><<<blocks, 256, 0, s>>>(table, T, keep);
  return (int)cudaGetLastError();
}
"""


def build_fill():
    """FILL_SOURCE built with the package's nvcc flags, loaded."""
    from query_engine_tpu_torch.ops._build import BUILD_DIR, NVCC_FLAGS, _nvcc

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = BUILD_DIR / "hash_fill_yardstick.cu"
    so = cu.with_suffix(".so")
    cu.write_text(FILL_SOURCE)
    r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(so),
                        str(cu)], capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed:\n{r.stdout}{r.stderr}")
    fn = ctypes.CDLL(str(so)).hash_fill
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


# Named replacements of whole functions, for `--set NAME`. "cas128": the
# int64 build claims its slot with one 128-bit CAS of key and row together
# (sm_90, PTX 8.3 `atom.cas.b128`) instead of a CAS on the row word and a
# store of the key.
CLAIM64 = """__device__ __forceinline__ bool claim(long long* table, uint32_t slot,
                                      long long key, int row) {
  long long* s = table + 2 * (uint64_t)slot;
  if (atomicCAS(reinterpret_cast<int*>(s + 1), kEmpty, row) != kEmpty)
    return false;
  s[0] = key;
  return true;
}"""
CLAIM128 = r"""__device__ __forceinline__ bool claim(long long* table, uint32_t slot,
                                      long long key, int row) {
  unsigned long long lo, hi;
  asm volatile(
      "{\n\t.reg .b128 d, cmp, val;\n\t"
      "mov.b128 cmp, {%2, %3};\n\t"
      "mov.b128 val, {%4, %5};\n\t"
      "atom.global.cas.b128 d, [%6], cmp, val;\n\t"
      "mov.b128 {%0, %1}, d;\n\t}"
      : "=l"(lo), "=l"(hi)
      : "l"(0ULL), "l"((unsigned long long)kEmpty),
        "l"((unsigned long long)key),
        "l"((unsigned long long)(uint32_t)row),
        "l"(table + 2 * (uint64_t)slot)
      : "memory");
  return lo == 0 && hi == (unsigned long long)kEmpty;
}"""
# "build2", "build4": the build's claim loop over 2 or 4 rows a thread (256
# apart), every live row's atomic issued before any result is tested.
BUILD1 = """template <typename K>
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
}"""
BUILD_ROWS = """template <typename K>
__global__ void __launch_bounds__(kThreads)
    hash_build_kernel(const K* __restrict__ keys,
                      const uint8_t* __restrict__ ok, int64_t n,
                      K* __restrict__ table, uint32_t mask,
                      int* __restrict__ overflow) {
  constexpr int R = ROWS;
  const uint64_t stream = policy_stream();
  const int64_t base = (int64_t)blockIdx.x * (kThreads * R) + threadIdx.x;
  K key[R];
  uint32_t slot[R];
  bool live[R];
  bool any = false;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int64_t row = base + (int64_t)j * kThreads;
    live[j] = row < n && load_ok(ok + row, stream);
    if (live[j]) {
      key[j] = load_key(keys + row, stream);
      slot[j] = hash_key(key[j]) & mask;
      any = true;
    }
  }
  const uint64_t slots = (uint64_t)mask + 1;
  for (uint64_t step = 0; any; ++step) {
    if (step == slots) {
      *overflow = 1;
      return;
    }
    unsigned long long old[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if (!live[j]) continue;
      const int row = (int)(base + j * kThreads);
      if constexpr (sizeof(K) == 4) {
        old[j] = atomicCAS(
            reinterpret_cast<unsigned long long*>(table) + slot[j],
            (unsigned long long)kEmpty << 32,
            ((unsigned long long)(uint32_t)row << 32) | (uint32_t)key[j]);
      } else {
        old[j] = (unsigned long long)(unsigned)atomicCAS(
            reinterpret_cast<int*>(table + 2 * (uint64_t)slot[j] + 1),
            kEmpty, row);
      }
    }
    any = false;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if (!live[j]) continue;
      const unsigned long long empty =
          sizeof(K) == 4 ? (unsigned long long)kEmpty << 32
                         : (unsigned long long)kEmpty;
      if (old[j] == empty) {
        if constexpr (sizeof(K) == 8) table[2 * (uint64_t)slot[j]] = key[j];
        live[j] = false;
      } else {
        slot[j] = (slot[j] + 1) & mask;
        any = true;
      }
    }
  }
}"""
LAUNCH1 = "  hash_build_kernel<K><<<blocks_for(n, kThreads), kThreads, 0, s>>>("
LAUNCH_ROWS = ("  hash_build_kernel<K><<<blocks_for(n, kThreads * ROWS), kThreads, 0, "
               "s>>>(")
NAMED = {"cas128": [(CLAIM64, CLAIM128)]}
NAMED.update((f"build{r}", [(BUILD1, BUILD_ROWS.replace("ROWS", str(r))),
                            (LAUNCH1, LAUNCH_ROWS.replace("ROWS", str(r)))])
             for r in (2, 4))


def parse(spec: str):
    """`--set`'s list -> (constants "N=V,...", [(old, new), ...])."""
    items = spec.split(",")
    subs = [tuple(i.split("=>", 1)) for i in items if "=>" in i]
    for i in items:
        subs += NAMED.get(i, [])
    return ",".join(i for i in items if "=>" not in i and i not in NAMED), \
        subs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--set", action="append", default=[],
                    metavar="N=V,OLD=>NEW,...",
                    help="one copy of the source with these constants and "
                         "replacements")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "scripts"))
    import torch

    if not torch.cuda.is_available():
        print("hash_variants: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    from chip_smoke import graph_ms, hash_join_cases
    from factorized_variants import build
    from query_engine_tpu_torch.ops import hash_join as HJ
    from query_engine_tpu_torch.ops._build import load_library

    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    argtypes = {BUILD: [p, p, i64, i32, p, i64, p, p],
                PROBE: [p, i64, p, p, i64, i32, p, p, p]}
    lib = load_library().lib
    kernels = {"base": {BUILD: lib.qe_hash_build, PROBE: lib.qe_hash_probe}}
    for spec in args.set:
        consts, subs = parse(spec)
        kernels[spec] = build(consts, "hash_join.cu", (BUILD, PROBE),
                              argtypes, subs)

    fill = build_fill()

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def hand_fill(T, dtype, keep):
        table = torch.empty((T, 2), dtype=dtype, device="cuda")
        rc = fill(table.data_ptr(), T, table.element_size(), keep, stream())
        if rc:
            raise RuntimeError(f"fill launch failed: cudaError {rc}")
        return table

    def run_build(fns, keys, ok, T):
        table = torch.empty((T, 2), dtype=keys.dtype, device=keys.device)
        overflow = torch.zeros(1, dtype=torch.int32, device=keys.device)
        rc = fns[BUILD](keys.data_ptr(), ok.data_ptr(), keys.shape[0],
                        keys.element_size(), table.data_ptr(), T,
                        overflow.data_ptr(), stream())
        if rc:
            raise RuntimeError(f"build launch failed: cudaError {rc}")
        return table, overflow

    def run_probe(fns, table, keys, ok):
        n = keys.shape[0]
        ri = torch.empty(n, dtype=torch.int64, device=keys.device)
        matched = torch.empty(n, dtype=torch.bool, device=keys.device)
        rc = fns[PROBE](table.data_ptr(), table.shape[0], keys.data_ptr(),
                        ok.data_ptr(), n, keys.element_size(), ri.data_ptr(),
                        matched.data_ptr(), stream())
        if rc:
            raise RuntimeError(f"probe launch failed: cudaError {rc}")
        return ri, matched

    cases = {}
    for name, arrays in hash_join_cases().items():
        if name not in ("a", "b"):
            continue
        b, bo, pk, po = (torch.from_numpy(x).cuda() for x in arrays[:4])
        T = arrays[4]
        table, _ = run_build(kernels["base"], b, bo, T)
        plain = HJ.empty_table(T, b.dtype, b.device)
        slot = plain[:1].clone()  # (0, EMPTY), made outside any capture
        cases[name] = (b, bo, pk, po, T, table, slot)
        for fill_kind, got in (("the build's", run_build(
                kernels["base"], b[:0], bo[:0], T)[0]),
                               ("the hand", hand_fill(T, b.dtype, 0)),
                               ("the hand evict_last",
                                hand_fill(T, b.dtype, 1))):
            if not torch.equal(got, plain):
                raise RuntimeError(f"{fill_kind} fill at ({name}) != "
                                   "empty_table")
        want = run_probe(kernels["base"], table, pk, po)
        for label, fns in kernels.items():
            built, overflow = run_build(fns, b, bo, T)
            if int(overflow.item()):
                raise RuntimeError(f"{label} at ({name}): overflow")
            HJ.check_table(*HJ.table_views(built), b, bo)
            got = run_probe(fns, table, pk, po)
            if not (torch.equal(got[0], want[0])
                    and torch.equal(got[1], want[1])):
                raise RuntimeError(f"{label} at ({name}): probe != base")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    out = {"card": smi.stdout.strip().splitlines()[0] if smi.stdout else ""}
    for _ in range(2):
        for name, (b, bo, pk, po, T, table, slot) in cases.items():
            fills = out.setdefault(f"fill ({name})",
                                   {"build kernel": [], "one pass": [],
                                    "two planes": [], "hand": [],
                                    "hand evict_last": []})
            fills["build kernel"].append(graph_ms(
                lambda: run_build(kernels["base"], b[:0], bo[:0], T),
                iters=10))
            fills["one pass"].append(graph_ms(
                lambda: torch.empty_like(table).copy_(slot.expand(T, 2)),
                iters=10))
            for keep, label in ((0, "hand"), (1, "hand evict_last")):
                fills[label].append(graph_ms(
                    lambda: hand_fill(T, b.dtype, keep), iters=10))
            fills["two planes"].append(graph_ms(
                lambda: (torch.full((T,), HJ.EMPTY, dtype=torch.int32,
                                    device=b.device),
                         torch.zeros(T, dtype=b.dtype, device=b.device)),
                iters=10))
            for part in ("build", "probe"):
                row = out.setdefault(f"{part} ({name})",
                                     {k: [] for k in kernels})
                for label, fns in kernels.items():
                    fn = (lambda: run_build(fns, b, bo, T)) \
                        if part == "build" \
                        else (lambda: run_probe(fns, table, pk, po))
                    row[label].append(graph_ms(fn, iters=10))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
