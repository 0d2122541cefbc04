"""The small-table gather beside copies of its source with other constants,
on the card, in one process.

Each `--set` makes one copy of query_engine_tpu_torch/csrc/small_gather.cu
in which each `NAME=VALUE` of its comma-separated list replaces the value of
the source's one line `constexpr int NAME = ...;` (kThreads,
kBlocksPerSm), built as scripts/factorized_variants.py builds its copies,
with both entry points renamed. At `chip_smoke.py` phase 3's four shapes and
inputs (2^23 rows; T in {1024, 4096}, W in {1, 3}), every copy's two entry
points must equal the plain versions bit for bit. Then the checkout's
kernel ("base") and each copy are timed in turns, twice (a CUDA graph of
10 calls replayed between CUDA events, `chip_smoke.graph_ms`), beside a
yardstick of the same bytes: one torch broadcast copy that reads the
indices once and writes an output of the form's shape (what the card
gives for that mix of reads and writes with no lookup). It prints one JSON
line: per form and shape the ms of each, with the card's name and power
limit.

    python scripts/gather_variants.py --set kThreads=512 --set kBlocksPerSm=2

Exits non-zero without CUDA.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
ENTRIES = {"u32": "qe_small_gather_u32", "planes": "qe_small_gather_planes"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--set", action="append", default=[], metavar="N=V,...",
                    help="one copy of the source with these constants")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("gather_variants: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    from chip_smoke import GATHER_SHAPES, SEED, gather_inputs, graph_ms
    from factorized_variants import build
    from query_engine_tpu_torch.ops import small_gather as sg
    from query_engine_tpu_torch.ops._build import load_library

    lib = load_library().lib
    kernels = {"base": {e: getattr(lib, e) for e in ENTRIES.values()}}
    kernels.update((a, build(a, "small_gather.cu", tuple(ENTRIES.values())))
                   for a in args.set)

    def run(fns, form, inputs, T, W):
        idx32, table, idx64, planes = inputs
        if form == "u32":
            idx, tab = idx32, table
            out = torch.empty((idx.shape[0], W), dtype=torch.int32,
                              device="cuda")
        else:
            idx, tab = idx64, planes
            out = torch.empty((W, idx.shape[0]), dtype=torch.int64,
                              device="cuda")
        rc = fns[ENTRIES[form]](idx.data_ptr(), tab.data_ptr(), idx.shape[0],
                                T, W, out.data_ptr(),
                                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"{form}: launch failed: cudaError {rc}")
        return out

    rng = np.random.default_rng(SEED)
    shapes = {(T, W): gather_inputs(rng, T, W, torch.device("cuda"))
              for T, W in GATHER_SHAPES}
    for (T, W), inputs in shapes.items():
        idx32, table, idx64, planes = inputs
        want = {"u32": sg.gather_words_plain(idx32, table),
                "planes": sg.gather_word_planes_plain(idx64, planes)}
        for name, fns in kernels.items():
            for form in ENTRIES:
                if not torch.equal(run(fns, form, inputs, T, W), want[form]):
                    raise RuntimeError(f"{name} {form} T={T} W={W}: "
                                       "!= plain")
        del want
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    out = {"card": smi.stdout.strip().splitlines()[0] if smi.stdout else ""}
    for _ in range(2):
        for (T, W), inputs in shapes.items():
            idx32, _, idx64, _ = inputs
            n = idx32.shape[0]
            broadcast = {
                "u32": lambda: torch.empty(
                    (n, W), dtype=torch.int32, device="cuda").copy_(
                        idx32[:, None].expand(-1, W)),
                "planes": lambda: torch.empty(
                    (W, n), dtype=torch.int64, device="cuda").copy_(
                        idx64[None].expand(W, -1))}
            for form in ENTRIES:
                row = out.setdefault(f"{form} T={T} W={W}",
                                     {k: [] for k in [*kernels, "broadcast"]})
                for name, fns in kernels.items():
                    row[name].append(graph_ms(
                        lambda: run(fns, form, inputs, T, W), iters=10))
                row["broadcast"].append(graph_ms(broadcast[form], iters=10))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
