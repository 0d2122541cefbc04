"""Eager walk (`engine/expr_eval.py`): host ms a statement matching LIKE
and the regex operators against a dictionary, value by value, from the
change of `pipeline.stats["like_ms"]` (the `qe:like` span, taken out of
`leaf_ms`); None where the program has no such counter."""


def read(ctx):
    n, c = ctx["statements"], ctx["counts"].get("pipeline.like_ms")
    return c / n if n and c is not None else None
