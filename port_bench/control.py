"""The control of `correct`: the reference in the program's place, computed
one precision lower, must come out not correct.

The configuration states exact answers over BIGINT (SSB's cents). The
control takes the reference, casts the columns it sums (`MEASURES` of
`reference/<family>.py`) to float32 and rounds the result values `ROUND32`
names to float32: what a program that carried its sums in float32 would
return. `compare.py` then holds its rows against
the float64 reference's, exactly as a run holds the program's, and the
readings are the numbers a run compares (`wrong`, `float_gap`).

    python3 -m port_bench.control --workload ssb-sf10.star --seeds 11 12 13

makes each seed's tables on the card (as a run does, at the cell's size)
and prints one line of readings a seed, then one JSON line with all of
them. The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace

import numpy as np

from port_bench.reference.compare import compare

THREADS = 4     # statements side by side, as a run's reference runs them


def lower(host: dict, reference) -> dict:
    """The host tables with the reference's measure columns in float32."""
    out = {}
    for name, t in host.items():
        cols = dict(t.columns)
        for c in reference.MEASURES.get(name, ()):
            if c in cols:
                cols[c] = cols[c].astype(np.float32)
        out[name] = replace(t, columns=cols)
    return out


def round32(rows: list, kinds: tuple) -> list:
    """Each value of a kind in `kinds` rounded to float32 and back."""
    def r(v):
        if isinstance(v, bool) or not isinstance(v, kinds):
            return v
        return type(v)(np.float32(v))
    return [tuple(r(v) for v in row) for row in rows]


def control_rows(reference, host32: dict, query: str) -> list:
    return round32(reference.run(query, host32), reference.ROUND32)


def readings(reference, host: dict, statements) -> dict:
    """The numbers a run compares, for the control against the reference,
    with each statement's own."""
    host32 = lower(host, reference)

    def one(q):
        return compare(control_rows(reference, host32, q),
                       reference.run(q, host), reference.ORDER[q])

    with ThreadPoolExecutor(THREADS) as pool:
        per = {q: {"wrong": w, "float_gap": g}
               for q, (w, g) in zip(statements, pool.map(one, statements))}
    return {"wrong": sum(v["wrong"] for v in per.values()),
            "float_gap": max((v["float_gap"] for v in per.values()),
                             default=0.0),
            "by_statement": per}


def main(argv=None) -> int:
    from port_bench import run

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    _, cell, config, mix = run.cell_files(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    generator = importlib.import_module(config["generator"])
    reference = importlib.import_module(config["reference"])
    statements = list(dict.fromkeys(mix["statements"]))
    out = {}
    for seed in args.seeds:
        t = time.perf_counter()
        tables = generator.generate(config, seed, "cuda")
        host = {k: tables[k].host() for k in mix.get("tables", tables)}
        del tables
        torch.cuda.empty_cache()
        r = readings(reference, host, statements)
        out[seed] = r
        print(f"{args.workload} seed {seed}: control wrong {r['wrong']} of "
              f"{len(statements)}, float_gap {r['float_gap']!r}; "
              + "; ".join(f"{q} {v['wrong']} {v['float_gap']:.3e}"
                          for q, v in r["by_statement"].items())
              + f" ({time.perf_counter() - t:.1f} s)", flush=True)
    print(json.dumps({"workload": args.workload, "control": {
        str(s): {"wrong": r["wrong"], "float_gap": r["float_gap"]}
        for s, r in out.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
