"""Probe: the s8 one-hot nibble aggregate against the port's grouped
SUM/COUNT kernel.

Counterpart of `benchmarks/probe_int8_mxu.py`: 16 nibble lanes and a count
lane, an s8 x s8 -> s32 tensor-core product (csrc/agg_onehot_s8.cu), no
lo/hi split. The port's s32 partials are summed in int64 across blocks, so
it is exact at any n (the JAX design at n <= 2^27).

    python -m query_engine_tpu_torch.probes.probe_int8_mxu [n_rows]
        [--device cuda|cpu]

Checks the s8 aggregate and v0_production (ops.group_agg) against the numpy
reference on the probe's data and, on the card, times both with CUDA
events. `--device cuda` (the default) without CUDA exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Tuple

import numpy as np
import torch

from query_engine_tpu_torch.ops import agg_variants as AV
from query_engine_tpu_torch.ops import group_agg


def grouped_sum_count_s8(values: torch.Tensor, ok: torch.Tensor,
                         gid: torch.Tensor, num_groups: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sums int64 [num_groups], counts int64 [num_groups]) for any
    num_groups <= 1024; the signature of the JAX probe's function."""
    return AV.grouped_sum_count("s8", values, ok, gid, num_groups)


def main(argv=None) -> int:
    from query_engine_tpu_torch.probes.probe_agg_variants import (
        G, cuda_ms, kernel_rates, probe_data, reference)

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_rows", nargs="?", type=int, default=1 << 24)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("probe_int8_mxu: --device cuda, but torch.cuda.is_available() "
              "is False", file=sys.stderr)
        return 1
    n, device = args.n_rows, torch.device(args.device)
    values, ok, gid = probe_data(n, device)
    ref_s, ref_c = reference(values.cpu().numpy(), ok.cpu().numpy(),
                             gid.cpu().numpy())
    fns = {"s8_nibble": lambda: grouped_sum_count_s8(values, ok, gid, G),
           "v0_production": lambda: group_agg.grouped_sum_count(
               values, ok, gid, G)}
    report = {"metric": "s8_probe", "rows": n, "groups": G,
              "device": (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu")}
    for name, f in fns.items():
        s, c = f()
        report[name] = {"correct": np.array_equal(s.cpu().numpy(), ref_s)
                        and np.array_equal(c.cpu().numpy(), ref_c)}
        if device.type == "cuda":
            report[name]["ms"] = cuda_ms(f)
        print(f"{name}: {report[name]}", flush=True)
    if device.type == "cuda":
        vlo, vhi, gid_m = AV.prepare(values, ok, gid)
        k_ms = cuda_ms(lambda: AV.chunk_totals_kernel("s8", vlo, vhi, gid_m))
        report["s8_nibble"].update(kernel_ms=k_ms,
                                   **kernel_rates("s8", n, k_ms))
    print(json.dumps(report), flush=True)
    return 0 if report["s8_nibble"]["correct"] and \
        report["v0_production"]["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
