"""The hand kernels' shapes, on the card, for one checkout.

`--kernels group_agg` (the default) times the grouped SUM/COUNT entry point
(`grouped_sums_counts_multi`) and the segment route (`segment_aggregate`)
as the engine calls them:

  A             Query A's aggregate: 2^23 rows, 2048 slots (1025 used),
                one int64 SUM and COUNT(*)
  Q1            TPC-H Q1's: 2^23 rows, 4 of 128 slots, one int64 and three
                float64 items and COUNT(*)
  Q1_two_words  Q1's items with each float item as two (`two_words`: hi
                and lo, each summed in fixed point), where the checkout
                has `two_words`: one word per item made as precise as two
  G32768        2^23 rows over 32768 groups, one int64 and one float64
                item (chip_smoke.py phase 1's "32768 groups")
  seg_*         the segment route at 2^23 slots (Q3, Q9, Q10: keys with no
                static bound): SUM(float64) and COUNT(*), ids in sorted
                runs of 1-7 rows (Q3's lineitem rows by l_orderkey) and
                uniform over 175 live groups (Q9's nation x year)

`--kernels onehot` times the aggregate probes' chunk-totals kernels
(`ops.agg_variants.chunk_totals_kernel`: s8, v1, v2, v4, v5) on the probe's
data (`probes.probe_agg_variants.probe_data`: 2^24 rows, 1024 groups, seed
3).

`--kernels gather` times the small-table gather (`ops.small_gather`) at
`chip_smoke.py` phase 3's four shapes (2^23 rows; T in {1024, 4096}, W in
{1, 3}) and inputs: `gather_words` (int32 indices and table) and, in a
checkout that has it, `gather_word_planes` (the join's int64 form).

It prints one JSON line: per case the device time in ms (a CUDA graph of
10 calls replayed between CUDA events, so the host's launch overhead is
not in it) and a digest of the result's bits, with the card's name and
power limit. The data comes from a fixed seed, so two checkouts' digests
are equal exactly when their results are bit for bit equal.

    python scripts/group_agg_shapes.py
    python scripts/group_agg_shapes.py --kernels onehot --root DIR
    python scripts/group_agg_shapes.py --kernels gather --root DIR

`--root` imports `query_engine_tpu_torch` from another checkout, e.g. an
earlier commit unpacked with `git archive`, which builds its kernels into
its own `_build/`; one whose group_agg takes no count-only items is driven as its engine drove it (COUNT(*) as a plane of
ones, int32 ids). The timing is `chip_smoke.graph_ms` of the checkout that
holds this script. Compare two checkouts on one card, in turns: parent,
change, change, parent. Exits non-zero without CUDA.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys


def digest(result):
    import torch

    h = hashlib.sha256()
    for pair in result:
        for t in (pair if isinstance(pair, tuple) else (pair,)):
            t = t.view(torch.int64) if t.is_floating_point() else t
            h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def group_agg_cases(dev):
    """(module, {case: fn}) of group_agg at the main path's shapes."""
    import numpy as np
    import torch

    from query_engine_tpu_torch.ops import group_agg as ga
    from query_engine_tpu_torch.ops import kernels as K

    counts_only = hasattr(ga, "fixed_point")  # takes (None, ok) items
    n = 1 << 23
    rng = np.random.default_rng(5)

    def ok_plane(p=0.85):
        return torch.from_numpy(rng.random(n) < p).to(dev)

    ones = torch.ones(n, dtype=torch.int64, device=dev)

    def as_engine(items, star, gid, G):
        if counts_only:
            return ga.grouped_sums_counts_multi(items + [(None, star)], gid, G)
        return ga.grouped_sums_counts_multi(items + [(ones, star)],
                                            gid.to(torch.int32), G)

    gid_a = torch.from_numpy(rng.integers(0, 1025, n)).to(dev)
    items_a = [(torch.from_numpy(rng.integers(50_000, 151_000, n)).to(dev),
                ok_plane())]
    star_a = ok_plane()
    gid_q1 = torch.from_numpy(rng.integers(0, 4, n)).to(dev)
    items_q1 = [(torch.from_numpy(rng.integers(1, 51, n)).to(dev),
                 ok_plane(0.98))] + [
        (torch.from_numpy(rng.random(n) * 1e5).to(dev), ok_plane(0.98))
        for _ in range(3)]
    star_q1 = ok_plane(0.98)
    runs = torch.from_numpy(
        np.repeat(np.arange(n), rng.integers(1, 8, n))[:n]).to(dev)
    live175 = torch.from_numpy(rng.integers(0, 175, n)).to(dev)
    x, x_ok = torch.from_numpy(rng.random(n) * 1e5).to(dev), ok_plane(0.5)
    gid_g = torch.from_numpy(rng.integers(0, 32768, n).astype(np.int32)).to(
        dev)
    items_g = [(torch.from_numpy(rng.integers(50_000, 151_000, n)).to(dev),
                ok_plane()),
               (torch.from_numpy(rng.normal(0.0, 1e7, n)).to(dev),
                ok_plane())]

    def two_words_q1():
        split = [items_q1[0]]
        for v, ok in items_q1[1:]:
            hi, lo = ga.two_words(v, ok)
            split += [(hi, ok), (lo, ok)]
        return as_engine(split, star_q1, gid_q1, 128)

    cases = {
        "A": lambda: as_engine(items_a, star_a, gid_a, 2048),
        "Q1": lambda: as_engine(items_q1, star_q1, gid_q1, 128),
        "seg_runs_sum": lambda: K.segment_aggregate("sum", x, x_ok, runs, n,
                                                    n),
        "seg_175_sum": lambda: K.segment_aggregate("sum", x, x_ok, live175,
                                                   n, n),
        "seg_runs_count_star": lambda: K.segment_aggregate(
            "count_star", x, x_ok, runs, n, n),
        "seg_175_count_star": lambda: K.segment_aggregate(
            "count_star", x, x_ok, live175, n, n),
        "G32768": lambda: ga.grouped_sums_counts_multi(items_g, gid_g,
                                                       32768),
    }
    if hasattr(ga, "two_words"):
        cases["Q1_two_words"] = two_words_q1
    return ga, cases


def onehot_cases(dev):
    """(module, {variant: fn}) of the probes' chunk-totals kernels."""
    from query_engine_tpu_torch.ops import agg_variants as AV
    from query_engine_tpu_torch.probes.probe_agg_variants import probe_data

    vlo, vhi, gid_m = AV.prepare(*probe_data(1 << 24, dev))
    return AV, {v: (lambda v=v: [AV.chunk_totals_kernel(
        v, vlo, vhi, gid_m, AV.NUM_GROUPS)])
        for v in ("s8", "v1", "v2", "v4", "v5")}


def gather_cases(dev):
    """(module, {case: fn}) of the small gather at chip_smoke phase 3's
    four shapes and inputs: the int32 form (`gather_words`, in every
    checkout since the kernel's port) and, where the checkout has it, the
    join's form (`gather_word_planes`)."""
    import numpy as np

    from chip_smoke import GATHER_SHAPES, SEED, gather_inputs
    from query_engine_tpu_torch.ops import small_gather as sg

    rng = np.random.default_rng(SEED)
    cases = {}
    for T, W in GATHER_SHAPES:
        idx32, table, idx64, planes = gather_inputs(rng, T, W, dev)
        cases[f"u32 T={T} W={W}"] = (
            lambda i=idx32, t=table: [sg.gather_words(i, t)])
        if hasattr(sg, "gather_word_planes"):
            cases[f"planes T={T} W={W}"] = (
                lambda i=idx64, p=planes: [sg.gather_word_planes(i, p)])
    return sg, cases


CASES = {"group_agg": group_agg_cases, "onehot": onehot_cases,
         "gather": gather_cases}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels", choices=sorted(CASES), default="group_agg",
                    help="which kernels' cases to time (default: group_agg)")
    ap.add_argument("--root", default=None,
                    help="checkout whose query_engine_tpu_torch to import "
                         "(default: the one that holds this file)")
    args = ap.parse_args(argv)
    here = os.path.abspath(os.path.join(os.path.dirname(
        os.path.abspath(__file__)), ".."))  # the checkout that holds this file
    sys.path.insert(0, here)
    from chip_smoke import graph_ms

    sys.path.insert(0, os.path.abspath(args.root or here))
    import torch

    if not torch.cuda.is_available():
        print("group_agg_shapes: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    module, cases = CASES[args.kernels](torch.device("cuda"))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    out = {"root": args.root or ".", "kernels": args.kernels,
           "module": module.__file__,
           "card": smi.stdout.strip().splitlines()[0] if smi.stdout else ""}
    for name, fn in cases.items():
        result = fn()
        torch.cuda.synchronize()
        out[name] = {"ms": graph_ms(fn, iters=10),
                     "digest": digest(result)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
