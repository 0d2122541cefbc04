"""The ordered-set aggregates' device work, on the card, at phase 10's
shapes (`chip_smoke.py`; 2^23 rows, the capacity of SF1's lineitem):

  sort_f64     `K.sort_by_group_value` of float64 values in 128 group
               slots, 6 live (O1's MEDIAN/P90 plane: two stable sorts of
               an int64 key and the searchsorted group bounds)
  sort_i64     the same over int64 values in 8 slots, 7 live, 50 values
               (O2's MODE plane)
  cont, disc   the CONT lerp and the DISC gather after the sort
  mode         `K.group_mode_sorted` over sort_i64's planes
  mode_ref     the JAX package's form of the same step (run starts by a
               row-wise cummax, run ends by `_seg_end_pos`, one scatter-max
               of every row's key, the rows outside a group into one shared
               slot), which the port's replaced; it must give the same
               values

It prints one JSON line: per case the device time in ms (CUDA events
around 20 back-to-back calls after 3 warm-up calls, `chip_smoke.cuda_ms`)
with the card's name and power limit. Run from the root of a checkout:

    python scripts/ordered_set_shapes.py

Exits non-zero without CUDA or when mode and mode_ref differ.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

N = 1 << 23
LIVE = 6_001_215


def mode_reference_form(skey, sval, num_groups, desc):
    """MODE's winner as the JAX executor computes it
    (`QueryExecutor._grouped_percentile`), in torch ops."""
    import torch

    from query_engine_tpu_torch.ops import kernels as K

    cap = skey.shape[0]
    idx = torch.arange(cap, device=skey.device)
    rc = (idx == 0) | (skey != torch.roll(skey, 1)) \
        | (sval != torch.roll(sval, 1))
    run_start = K._cummax(torch.where(rc, idx, 0))
    run_len = K._seg_end_pos(rc) - run_start + 1
    big = cap + 1
    tie = run_start if desc else cap - run_start
    best = K._scatter_drop(num_groups, skey, run_len * big + tie,
                           K._I64_MIN, torch.int64, reduce="amax")
    pos = (best % big) if desc else (cap - best % big)
    return sval[pos.clamp(0, cap - 1)]


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("ordered_set_shapes: CUDA is not available", file=sys.stderr)
        return 1
    from chip_smoke import cuda_ms
    from query_engine_tpu_torch.ops import kernels as K

    dev = torch.device("cuda")
    rng = np.random.default_rng(19920521)
    live = torch.arange(N, device=dev) < LIVE
    price = torch.from_numpy(np.round(rng.uniform(900, 105000, N), 2)).to(dev)
    g6 = torch.from_numpy(rng.integers(0, 6, N)).to(dev)
    qty = torch.from_numpy(rng.integers(1, 51, N)).to(dev)
    g7 = torch.from_numpy(rng.integers(0, 7, N)).to(dev)

    out = {}
    out["sort_f64"] = cuda_ms(lambda: K.sort_by_group_value(price, live, g6,
                                                            128))
    out["sort_i64"] = cuda_ms(lambda: K.sort_by_group_value(qty, live, g7, 8))
    skey, sval, cnt, start = K.sort_by_group_value(price, live, g6, 128)

    def cont():
        pos = 0.9 * (cnt - 1).clamp(min=0).to(torch.float64)
        lo = torch.floor(pos).to(torch.int64)
        hi = torch.ceil(pos).to(torch.int64)
        w = pos - lo.to(torch.float64)
        return sval[(start + lo).clamp(0, N - 1)] * (1.0 - w) \
            + sval[(start + hi).clamp(0, N - 1)] * w

    def disc():
        k = torch.ceil(0.5 * cnt.to(torch.float64)).to(torch.int64)
        k = torch.minimum(k.clamp(min=1), cnt.clamp(min=1))
        return sval[(start + cnt - k).clamp(0, N - 1)]

    out["cont"] = cuda_ms(cont)
    out["disc"] = cuda_ms(disc)
    skey, sval, cnt, _ = K.sort_by_group_value(qty, live, g7, 8)
    for desc in (False, True):
        got = K.group_mode_sorted(skey, sval, 8, desc)
        want = mode_reference_form(skey, sval, 8, desc)
        ok = cnt > 0
        if not torch.equal(got[ok], want[ok]):
            print(f"ordered_set_shapes: MODE (desc={desc}) differs from the "
                  "reference form", file=sys.stderr)
            return 1
    out["mode"] = cuda_ms(lambda: K.group_mode_sorted(skey, sval, 8, False))
    out["mode_ref"] = cuda_ms(lambda: mode_reference_form(skey, sval, 8,
                                                          False))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip()
    print(json.dumps({"card": card, "rows": N, "live": LIVE,
                      "ms": {k: round(v, 4) for k, v in out.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
