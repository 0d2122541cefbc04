"""How fast the card issues the one-hot kernels' wgmma shapes, alone.

The full one-hot kernels (csrc/agg_onehot_s8.cu, agg_onehot_bytes.cu) issue,
per k-step and SM, 16 wgmma of a narrow N: m64n24k32 s8 (32 rows a k-step)
or m64n16k16 bf16 (16 rows), from 4 warpgroups of 4 wgmma each. The
factorized kernels (csrc/agg_onehot_factorized.cu) issue 2 wgmma
m64n72k16 bf16 a 16-row k-step, from 2 warpgroups that take the k-steps in
turn. This script times each issue pattern with nothing else in the
kernel: one block an SM of the kernel's warpgroups, each issuing its
wgmma a step on its own zeroed A tiles and one shared B tile, then commit
and `wgmma.wait_group 1`, as the kernels do, through the descriptor, fence
and wgmma wrappers of csrc/onehot_wgmma.cuh. It runs each shape with A
read from shared memory ("ss") and from registers ("rs"), and the full
one-hot pattern at N = 128 for the card's dense rate. It prints per case
the ns a wgmma takes an SM, the TOP/s that gives, and the time a 2^24-row,
1024-group product would take at that rate with the case's wgmma a k-step;
the last line is one JSON object with the same numbers and the card's name
and power limit.

    python scripts/wgmma_small_n.py

Builds with nvcc (sm_90a) into query_engine_tpu_torch/_build/. Exits
non-zero without CUDA.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

# name -> (type, N, A from registers, warpgroups, wgmma a warpgroup a step,
# wgmma a k-step of the kernel)
CASES = {
    "s8_ss_n24": ("s8", 24, False, 4, 4, 16),
    "s8_rs_n24": ("s8", 24, True, 4, 4, 16),
    "s8_ss_n128": ("s8", 128, False, 4, 4, 16),
    "bf16_ss_n16": ("bf16", 16, False, 4, 4, 16),
    "bf16_rs_n16": ("bf16", 16, True, 4, 4, 16),
    "bf16_ss_n128": ("bf16", 128, False, 4, 4, 16),
    "bf16_ss_n72": ("bf16", 72, False, 2, 2, 2),
    "bf16_rs_n72": ("bf16", 72, True, 2, 2, 2),
}
# The kernels' own shapes call their wrappers in csrc/onehot_wgmma.cuh, so
# this times exactly what the kernels issue; the other cases are inline asm.
HEADER_MMA = {("s8", 24, False): "qe::wgmma_s8_m64n24k32",
              ("bf16", 16, False): "qe::wgmma_bf16_m64n16k16",
              ("bf16", 72, False): "qe::wgmma_bf16_m64n72k16",
              ("bf16", 72, True): "qe::wgmma_bf16_m64n72k16_rs"}
ROWS = 1 << 24
ITERS = 20000

# One block of kWgs warpgroups an SM; each warpgroup issues kPerWg wgmma a
# step on its own A tiles (2 KB each, from offset 8 KB x warpgroup) and the
# B tile at 32 KB, with the kernels' descriptor, fence, commit and wait
# pattern.
LOOP = """
#include <cuda_runtime.h>
#include <stdint.h>

#include "onehot_wgmma.cuh"

template <class Mma, int kWgs, int kPerWg>
__global__ void __launch_bounds__(128 * kWgs, 1) issue(float* out,
                                                       int iters) {
  extern __shared__ __align__(1024) uint8_t smem[];
  for (int i = threadIdx.x; i < 65536 / 16; i += 128 * kWgs)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
  qe::fence_proxy_async();
  __syncthreads();
  const int wg = __shfl_sync(0xFFFFFFFFu, threadIdx.x >> 7, 0);
  typename Mma::T d[Mma::kRegs];
#pragma unroll
  for (int i = 0; i < Mma::kRegs; ++i) d[i] = 0;
  const uint32_t base = qe::smem_u32(smem);
  const uint64_t db = qe::kmajor_desc(base + 32768);
  for (int it = 0; it < iters; ++it) {
    qe::wgmma_fence();
#pragma unroll
    for (int u = 0; u < kPerWg; ++u)
      Mma::run(d, qe::kmajor_desc(base + wg * 8192 + u * 2048), db);
    qe::wgmma_commit();
    qe::wgmma_wait<1>();
  }
  qe::wgmma_wait<0>();
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < Mma::kRegs; ++i) s += (float)d[i];
  if (s != 0.f) out[threadIdx.x] = s;
}
"""


def mma_source(name, kind, n, rs, *_):
    """A struct whose run(d, da, db) issues one wgmma of the case."""
    regs = n // 2
    typ = "int" if kind == "s8" else "float"
    head = (f"struct {name} {{\n  using T = {typ};\n"
            f"  static constexpr int kRegs = {regs};\n"
            f"  static __device__ __forceinline__ void run(T (&d)[{regs}], "
            "uint64_t da, uint64_t db) {\n")
    if (kind, n, rs) in HEADER_MMA:
        if rs:  # a zero fragment, as the tiles are zero
            return head + ("    (void)da;\n    const uint32_t a[4] = {0u, 0u, "
                           f"0u, 0u}};\n    {HEADER_MMA[kind, n, rs]}(d, a, "
                           "db);\n  }\n};\n")
        return head + f"    {HEADER_MMA[kind, n, rs]}(d, da, db);\n  }}\n}};\n"
    cons = "r" if kind == "s8" else "f"
    shape = (f"m64n{n}k32.s32.s8.s8" if kind == "s8"
             else f"m64n{n}k16.f32.bf16.bf16")
    dl = ", ".join(f"%{i}" for i in range(regs))
    if rs:  # A from registers: a zero fragment, as the tiles are zero
        a = "{" + ", ".join(f"%{regs + i}" for i in range(4)) + "}"
        ops, pred = f"{a}, %{regs + 4}", regs + 5
        ins = '"r"(0u), "r"(0u), "r"(0u), "r"(0u), "l"(db)'
        tail = ", p" if kind == "s8" else ", p, 1, 1, 0"
    else:
        ops, pred = f"%{regs}, %{regs + 1}", regs + 2
        ins = '"l"(da), "l"(db)'
        tail = ", p" if kind == "s8" else ", p, 1, 1, 0, 0"
    outs = ", ".join(f'"+{cons}"(d[{i}])' for i in range(regs))
    return head + (
        "    (void)da;\n" if rs else "") + f"""    asm volatile(
        "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{pred}, 0;\\n"
        "wgmma.mma_async.sync.aligned.{shape} {{{dl}}}, {ops}{tail};\\n}}\\n"
        : {outs} : {ins}, "r"(1));
  }}
}};
"""


def build(build_dir: Path) -> ctypes.CDLL:
    from query_engine_tpu_torch.ops._build import NVCC_FLAGS, SRC_DIR, _nvcc

    src = LOOP + "".join(mma_source(name, *c) for name, c in CASES.items())
    src += ('extern "C" int qe_wgmma_rate(int which, int blocks, float* out, '
            'int iters, cudaStream_t st) {\n  switch (which) {\n')
    for i, (name, (_, _, _, wgs, per_wg, _)) in enumerate(CASES.items()):
        kern = f"issue<{name}, {wgs}, {per_wg}>"
        src += (f"    case {i}: cudaFuncSetAttribute({kern}, "
                "cudaFuncAttributeMaxDynamicSharedMemorySize, 65536);\n"
                f"      {kern}<<<blocks, {128 * wgs}, 65536, st>>>(out, "
                "iters); break;\n")
    src += "    default: return -1;\n  }\n  return (int)cudaGetLastError();\n}\n"
    build_dir.mkdir(parents=True, exist_ok=True)
    cu, so = build_dir / "wgmma_small_n.cu", build_dir / "wgmma_small_n.so"
    cu.write_text(src)
    r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-I", str(SRC_DIR), "-shared",
                        "-o", str(so), str(cu)], capture_output=True,
                       text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed:\n{r.stdout}{r.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.qe_wgmma_rate.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                  ctypes.c_int, ctypes.c_void_p]
    lib.qe_wgmma_rate.restype = ctypes.c_int
    return lib


def main() -> int:
    root = Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("wgmma_small_n: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    from query_engine_tpu_torch.ops._build import BUILD_DIR

    lib = build(BUILD_DIR)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.zeros(512, device="cuda")
    st = torch.cuda.current_stream().cuda_stream
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    report = {"card": smi.stdout.strip().splitlines()[0] if smi.stdout
              else "", "sms": sms, "cases": {}}
    for i, (name, (kind, n, _, wgs, per_wg, per_step)) in enumerate(
            CASES.items()):
        if lib.qe_wgmma_rate(i, sms, out.data_ptr(), 100, st):
            raise RuntimeError(f"{name}: launch failed")
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        lib.qe_wgmma_rate(i, sms, out.data_ptr(), ITERS, st)
        e1.record()
        e1.synchronize()
        ms = e0.elapsed_time(e1)
        issued = ITERS * wgs * per_wg  # wgmma an SM
        ns = ms * 1e6 / issued
        k = 32 if kind == "s8" else 16
        tops = 2 * 64 * n * k * issued * sms / (ms / 1e3) / 1e12
        rows_ms = ROWS / k * per_step / sms * ns / 1e6
        report["cases"][name] = {"ns_per_wgmma_per_sm": ns, "tops": tops,
                                 "wgmma_per_k_step": per_step,
                                 "ms_for_2^24_rows": rows_ms}
        print(f"{name}: {ns:.3f} ns a wgmma an SM, {tops:.1f} TOP/s; "
              f"2^24 rows at G = 1024 would take {rows_ms:.4f} ms",
              flush=True)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
