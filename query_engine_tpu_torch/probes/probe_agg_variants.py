"""Probe: the one-hot tensor-core grouped aggregate variants against the
port's grouped SUM/COUNT kernel.

Counterpart of `benchmarks/probe_agg_variants.py`, with the same variants
and the same data (seed 3, values in [0, 2^40), 97 % ok, 1024 groups):

  v0_production      ops.group_agg.grouped_sum_count (csrc/group_agg.cu:
                     shared-memory int64 atomics)
  v1_two_acc         full bf16 one-hot, 12 lanes with the flag plane
  v2_no_flags        full bf16 one-hot, 9 lanes
  v3_s8_nibble       s8 one-hot over 16 nibble lanes (probe_int8_mxu)
  v4_factorized      factorized one-hot (glo x ghi-masked lanes), fragments
                     staged in shared memory and loaded with ldmatrix
  v5_sublane_inputs  factorized one-hot, fragments built in registers

Each is checked against an independent numpy reference (np.add.at on the
uint64 view). On the card each is timed with CUDA events, as is each
kernel's chunk-totals step against its plain version; the report gives
rows/s, the tensor-core rate (the product's flops over kernel time) and the
input GB/s.

    python -m query_engine_tpu_torch.probes.probe_agg_variants [n_rows]
        [--device cuda|cpu]

`--device cuda` (the default) on a machine without CUDA exits non-zero;
`--device cpu` checks the plain versions and times nothing. The last line
is one JSON report whose `device` names the card.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from query_engine_tpu_torch.ops import agg_variants as AV
from query_engine_tpu_torch.ops import group_agg

G = AV.NUM_GROUPS
SEED = 3

# name in the report -> variant of ops.agg_variants
VARIANT_NAMES = {
    "v1_two_acc": "v1",
    "v2_no_flags": "v2",
    "v3_s8_nibble": "s8",
    "v4_factorized": "v4",
    "v5_sublane_inputs": "v5",
}
# The product each kernel runs per row, [M x K=rows] x [rows x N], in flops
# (2 M N a row): full one-hot M = 1024 groups, N = 16 lanes (two n8 tiles);
# factorized M = 128 glo, N = 72 (9 lanes x 8 ghi); s8 N = 24 (three n8
# tiles), counted as int8 operations.
FLOPS_PER_ROW = {"v1": 2 * 1024 * 16, "v2": 2 * 1024 * 16,
                 "v4": 2 * 128 * 72, "v5": 2 * 128 * 72, "s8": 2 * 1024 * 24}
# Bytes a kernel reads per row: gid, vlo, vhi and, for v1, the flag plane.
BYTES_PER_ROW = {"v1": 16, "v2": 12, "v4": 12, "v5": 12, "s8": 12}


def run_variant(values: torch.Tensor, ok: torch.Tensor, gid: torch.Tensor,
                variant: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sums int64 [1024], counts int64 [1024]) through "v1", "v2", "v4" or
    "v5"; the signature of the JAX probe's `run_variant`."""
    if variant not in ("v1", "v2", "v4", "v5"):
        raise ValueError(f"unknown variant {variant!r}")
    return AV.grouped_sum_count(variant, values, ok, gid, G)


def probe_data(n: int, device, seed: int = SEED):
    """The JAX probe's data: values in [0, 2^40), 97 % ok, gid in [0, G)."""
    rng = np.random.default_rng(seed)
    values = rng.integers(0, 1 << 40, n)
    ok = rng.random(n) < 0.97
    gid = rng.integers(0, G, n).astype(np.int32)
    return tuple(torch.from_numpy(a).to(device) for a in (values, ok, gid))


def reference(values: np.ndarray, ok: np.ndarray, gid: np.ndarray,
              num_groups: int = G) -> Tuple[np.ndarray, np.ndarray]:
    """numpy: sums mod 2^64 (np.add.at on the uint64 view) and counts of
    the rows with ok and 0 <= gid < num_groups."""
    m = ok & (gid >= 0) & (gid < num_groups)
    sums = np.zeros(num_groups, dtype=np.uint64)
    np.add.at(sums, gid[m], values[m].astype(np.int64).view(np.uint64))
    counts = np.bincount(gid[m], minlength=num_groups).astype(np.int64)
    return sums.view(np.int64), counts


def cases(ok: torch.Tensor, gid: torch.Tensor
          ) -> Dict[str, Callable[[torch.Tensor], tuple]]:
    """The probe's entry points, each a function of the values."""
    from query_engine_tpu_torch.probes.probe_int8_mxu import \
        grouped_sum_count_s8

    out = {"v0_production":
           lambda v: group_agg.grouped_sum_count(v, ok, gid, G)}
    for name, variant in VARIANT_NAMES.items():
        if variant == "s8":
            out[name] = lambda v: grouped_sum_count_s8(v, ok, gid, G)
        else:
            out[name] = lambda v, variant=variant: run_variant(v, ok, gid,
                                                               variant)
    return out


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of fn() in ms: CUDA events around `iters`
    back-to-back calls after `warmup` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def kernel_rates(variant: str, n: int, ms: float) -> Dict[str, float]:
    """rows/s, tensor-core TFLOP/s and input GB/s of a chunk-totals kernel
    that took `ms` for n rows."""
    s = ms / 1e3
    return {"rows_per_sec": n / s,
            "tc_tflops": FLOPS_PER_ROW[variant] * n / s / 1e12,
            "gb_per_sec": BYTES_PER_ROW[variant] * n / s / 1e9}


def measure(n: int, device: torch.device) -> dict:
    """Check every case against the reference and, on CUDA, time it."""
    values, ok, gid = probe_data(n, device)
    ref_s, ref_c = reference(values.cpu().numpy(), ok.cpu().numpy(),
                             gid.cpu().numpy())
    on_card = device.type == "cuda"
    report = {"metric": "agg_variant_probe", "rows": n, "groups": G,
              "device": (torch.cuda.get_device_name(device) if on_card
                         else "cpu"), "variants": {}}
    for name, f in cases(ok, gid).items():
        s, c = f(values)
        correct = (np.array_equal(s.cpu().numpy(), ref_s)
                   and np.array_equal(c.cpu().numpy(), ref_c))
        entry = {"correct": correct}
        print(f"{name}: correct={correct}", flush=True)
        if on_card:
            entry["ms"] = cuda_ms(lambda: f(values))
            entry["rows_per_sec"] = n / (entry["ms"] / 1e3)
        report["variants"][name] = entry
    if on_card:
        vlo, vhi, gid_m = AV.prepare(values, ok, gid)
        for name, variant in VARIANT_NAMES.items():
            entry = report["variants"][name]
            entry["kernel_ms"] = cuda_ms(lambda: AV.chunk_totals_kernel(
                variant, vlo, vhi, gid_m))
            entry["plain_ms"] = cuda_ms(lambda: AV.chunk_totals_plain(
                variant, vlo, vhi, gid_m))
            entry.update(kernel_rates(variant, n, entry["kernel_ms"]))
        for name, e in report["variants"].items():
            line = f"{name}: {e['ms']:.4f} ms ({e['rows_per_sec']:.4g} rows/s)"
            if "kernel_ms" in e:
                line += (f"; chunk totals kernel {e['kernel_ms']:.4f} ms "
                         f"({e['tc_tflops']:.2f} TFLOP/s, "
                         f"{e['gb_per_sec']:.1f} GB/s) vs plain "
                         f"{e['plain_ms']:.4f} ms")
            print(line, flush=True)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_rows", nargs="?", type=int, default=1 << 24)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("probe_agg_variants: --device cuda, but torch.cuda.is_available()"
              " is False", file=sys.stderr)
        return 1
    report = measure(args.n_rows, torch.device(args.device))
    print(json.dumps(report), flush=True)
    return 0 if all(v["correct"] for v in report["variants"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
