"""Compiled pipeline (`engine/pipeline.py`): host ms a statement spent
making room for a graph outside eager leaves (LRU releases of other graphs,
the allocator's cache returned to the card: the `qe:room` span), from the
change of `pipeline.stats["room_ms"]`; None where the program has no such
counter."""


def read(ctx):
    n, ms = ctx["statements"], ctx["counts"].get("pipeline.room_ms")
    return ms / n if n and ms is not None else None
