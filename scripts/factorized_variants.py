"""The factorized one-hot kernels (v4, v5) beside copies of their source
with other constants, on the card, in one process.

Each `--set` makes one copy of query_engine_tpu_torch/csrc/
agg_onehot_factorized.cu in which each `NAME=VALUE` of its comma-separated
list replaces the value of the source's one line `constexpr int NAME =
...;`. A copy is built with nvcc (sm_90a, the package's flags) into
query_engine_tpu_torch/_build/ with its C entry point renamed, and run on
the probe's data (2^24 rows, 1024 groups, seed 3): its v4 and v5 chunk
totals must equal the plain version's bit for bit. Then every kernel, the
checkout's own ("base") and each copy's, is timed in turns, twice (a CUDA
graph of 10 calls replayed between CUDA events, as
`chip_smoke.graph_ms`). It prints one JSON line with the ms of each and the
card's name and power limit.

    python scripts/factorized_variants.py --set kAhead=4 --set kStages=16

Exits non-zero without CUDA.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
ENTRY = "qe_onehot_factorized"


def variant_source(text: str, assignments: str, entries=(ENTRY,),
                   subs=()) -> str:
    """The kernel source with each NAME=VALUE of `assignments` set, each
    (old, new) of `subs` replaced (each must occur), and each entry point
    renamed to its name + "_variant"."""
    for old, new in subs:
        if old not in text:
            raise SystemExit(f"{old!r} does not occur in the source")
        text = text.replace(old, new)
    for item in filter(None, assignments.split(",")):
        name, value = item.split("=")
        text, found = re.subn(rf"(constexpr int {name} = )[^;]+;",
                              rf"\g<1>{value};", text)
        if found != 1:
            raise SystemExit(f"{name}: {found} definitions in the source")
    for entry in entries:
        text = text.replace(f"int {entry}(", f"int {entry}_variant(")
    return text


def build(assignments: str, source="agg_onehot_factorized.cu",
          entries=(ENTRY,), argtypes=None, subs=()):
    """A copy of csrc/`source` with `assignments` and `subs`, built and
    loaded: its renamed entry points, by their original names. `argtypes`
    (one list for every entry, or {entry: list}) defaults to
    qe_onehot_factorized's."""
    import hashlib

    from query_engine_tpu_torch.ops._build import (BUILD_DIR, NVCC_FLAGS,
                                                   SRC_DIR, _nvcc)

    label = re.sub(r"\W", "_", assignments)
    if subs:
        label += "_" + hashlib.sha256(repr(subs).encode()).hexdigest()[:8]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = BUILD_DIR / f"{Path(source).stem}_{label}.cu"
    so = cu.with_suffix(".so")
    cu.write_text(variant_source((SRC_DIR / source).read_text(), assignments,
                                 entries, subs))
    r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-I", str(SRC_DIR), "-shared",
                        "-o", str(so), str(cu)], capture_output=True,
                       text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed for {assignments}:\n{r.stdout}"
                           f"{r.stderr}")
    lib = ctypes.CDLL(str(so))
    p = ctypes.c_void_p
    fns = {}
    for entry in entries:
        fn = getattr(lib, f"{entry}_variant")
        types = argtypes.get(entry) if isinstance(argtypes, dict) \
            else argtypes
        fn.argtypes = types or [p, p, p, ctypes.c_int64, ctypes.c_int, p, p]
        fn.restype = ctypes.c_int
        fns[entry] = fn
    return fns


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--set", action="append", default=[], metavar="N=V,...",
                    help="one copy of the source with these constants")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("factorized_variants: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    from chip_smoke import graph_ms
    from query_engine_tpu_torch.ops import agg_variants as AV
    from query_engine_tpu_torch.ops._build import load_library
    from query_engine_tpu_torch.probes.probe_agg_variants import probe_data

    kernels = {"base": getattr(load_library().lib, ENTRY)}
    kernels.update((a, build(a)[ENTRY]) for a in args.set)
    vlo, vhi, gid_m = AV.prepare(*probe_data(1 << 24, "cuda"))
    want = AV.chunk_totals_plain("v4", vlo, vhi, gid_m)

    def run(fn, staged):
        tot = torch.zeros_like(want)
        rc = fn(gid_m.data_ptr(), vlo.data_ptr(), vhi.data_ptr(),
                gid_m.shape[0], staged, tot.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"launch failed: cudaError {rc}")
        return tot

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    out = {"card": smi.stdout.strip().splitlines()[0] if smi.stdout else "",
           "v4": {k: [] for k in kernels}, "v5": {k: [] for k in kernels}}
    for name, fn in kernels.items():
        for v, staged in (("v4", 1), ("v5", 0)):
            if not torch.equal(run(fn, staged), want):
                raise RuntimeError(f"{name} {v}: chunk totals != plain")
    for _ in range(2):
        for v, staged in (("v4", 1), ("v5", 0)):
            for name, fn in kernels.items():
                out[v][name].append(graph_ms(lambda: run(fn, staged),
                                             iters=10))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
