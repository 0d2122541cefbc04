"""The device time of each operation of a counted join on the card, at
`chip_smoke.py` phase 15's J2 and J4c shapes, in one process.

The left side is lineitem's key plane at SF1 (capacity 2^23, 6,001,215
live rows, keys uniform over 15,003 suppliers), the right side
partsupp's (capacity 2^20, 4,002 live rows with ps_partkey <= 2000, 40
rows a supplier); "J4c" keeps the left rows with a key below 300 (a
filtered side, 99 % of its rows not selected). Keys are int64 with a
static range, so the joins take direct ranks (`rank = key - lo`), as the
pipeline does for one bounded integer key; the sorted path's functions
take the same keys as (key, key % 7) pairs.

Each operation is timed on the same tensors (seed 17) as a CUDA graph of
10 calls replayed between CUDA events (`chip_smoke.graph_ms`): the rank
counts (`_segment_count`, one group_agg launch at G = cap_l + cap_r),
`join_counts`, `join_count_total` and `join_ranks_counts` (the sorted
path, with and without the count's sorted space), `join_emit_inner` at
the counted bucket, its owner scan (`_cummax`) alone, and `torch.sort` of
the left key plane for scale. Prints one JSON line with the card's name
and power limit and each operation's ms.

    python scripts/join_count_ops.py
    python scripts/join_count_ops.py --root DIR

`--root` imports `query_engine_tpu_torch` from another checkout, e.g. an
earlier commit unpacked with `git archive`; an operation that checkout
does not have is left out. Compare two checkouts on one card, in turns:
parent, change, change, parent. Exits non-zero without CUDA.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None,
                    help="checkout whose query_engine_tpu_torch to import "
                         "(default: the one that holds this file)")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from chip_smoke import graph_ms

    sys.path.insert(0, str(Path(args.root).resolve()) if args.root
                    else str(ROOT))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("join_count_ops: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    from query_engine_tpu_torch.columnar.batch import padded_capacity
    from query_engine_tpu_torch.ops import kernels as K

    dev = torch.device("cuda")
    rng = np.random.default_rng(17)
    cap_l, n_l, cap_r, n_r, n_supp = 1 << 23, 6_001_215, 1 << 20, 4002, 15003
    lkey = np.zeros(cap_l, dtype=np.int64)
    lkey[:n_l] = rng.integers(0, n_supp, n_l)
    rkey = np.zeros(cap_r, dtype=np.int64)
    rkey[:n_r] = (np.arange(n_r) // 2 * 7 + np.tile([0, 3], n_r // 2)) \
        % n_supp
    ld, rd = torch.from_numpy(lkey).to(dev), torch.from_numpy(rkey).to(dev)
    ones_l = torch.ones(cap_l, dtype=torch.bool, device=dev)
    ones_r = torch.ones(cap_r, dtype=torch.bool, device=dev)
    lsel_all = K.live_mask(cap_l, n_l, dev)
    rsel = K.live_mask(cap_r, n_r, dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    out = {"card": smi, "root": args.root or ".", "module": K.__file__}
    fused = hasattr(K, "join_count_total")
    for shape, lsel in (("J2", lsel_all), ("J4c", lsel_all & (ld < 300))):
        lr = torch.where(lsel, ld, -(torch.arange(cap_l, device=dev) + 2))
        rr = torch.where(rsel, rd, -(torch.arange(cap_r, device=dev)
                                     + cap_l + 2))
        n_ranks = cap_l + cap_r
        l_ok = lsel & (lr >= 0)
        lr_c = torch.where(l_ok, lr, n_ranks - 1)
        total, counts, _, rank_start, right_by_rank, _, _ = K.join_counts(
            lr, rr, lsel, rsel)
        bucket = padded_capacity(int(total))
        pairs_l = [(ld, ones_l), (ld % 7, ones_l)]
        pairs_r = [(rd, ones_r), (rd % 7, ones_r)]
        mark = torch.arange(bucket, device=dev)
        ops = {
            "segment_count_G=cap_l+cap_r": lambda: K._segment_count(
                l_ok, lr_c, n_ranks),
            "join_counts": lambda: K.join_counts(lr, rr, lsel, rsel),
            f"join_emit_inner_{bucket}": lambda: K.join_emit_inner(
                counts, rank_start, right_by_rank, lr, total, bucket),
            f"cummax_{bucket}": lambda: K._cummax(mark),
            "torch_sort_left_keys": lambda: torch.sort(ld, stable=True),
        }
        if not hasattr(K, "_cummax"):
            del ops[f"cummax_{bucket}"]
        if fused:
            space = K.join_count_total(pairs_l, pairs_r, lsel, rsel,
                                       return_space=True)[3]
            ops.update({
                "join_count_total_2keys": lambda: K.join_count_total(
                    pairs_l, pairs_r, lsel, rsel, return_space=True),
                "join_ranks_counts_2keys": lambda: K.join_ranks_counts(
                    pairs_l, pairs_r, lsel, rsel),
                "join_ranks_counts_2keys_reused_sort":
                    lambda: K.join_ranks_counts(pairs_l, pairs_r, lsel, rsel,
                                                space=space),
            })
        out[shape] = {"pairs": int(total), "bucket": bucket}
        for name, fn in ops.items():
            out[shape][name] = round(graph_ms(fn, iters=10), 4)
            print(f"join_count_ops: {shape} {name}: "
                  f"{out[shape][name]} ms", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
