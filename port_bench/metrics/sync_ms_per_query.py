"""Eager walk (`engine/executor.py`): host ms a statement blocked in the
executor's counted reads from the device outside eager leaves (the
`qe:sync` span), from the change of `pipeline.stats["sync_ms"]`; None where
the program has no such counter."""


def read(ctx):
    n, ms = ctx["statements"], ctx["counts"].get("pipeline.sync_ms")
    return ms / n if n and ms is not None else None
