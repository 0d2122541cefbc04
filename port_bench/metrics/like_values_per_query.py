"""Eager walk (`engine/expr_eval.py`): dictionary values matched on the host
a statement by LIKE and the regex operators, from the change of
`pipeline.stats["like_values"]`; None where the program has no such
counter."""


def read(ctx):
    n, c = ctx["statements"], ctx["counts"].get("pipeline.like_values")
    return c / n if n and c is not None else None
