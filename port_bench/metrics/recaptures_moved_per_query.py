"""Compiled pipeline (`engine/pipeline.py`): captures a statement of cached
programs whose input planes had moved (an eager leaf's or a subquery's new
batch, a table registered anew), from the change of
`pipeline.stats["recaptures_moved"]`; None where the program has no such
counter."""


def read(ctx):
    n, c = ctx["statements"], ctx["counts"].get("pipeline.recaptures_moved")
    return c / n if n and c is not None else None
