"""Compiled pipeline (`engine/pipeline.py`): host ms a statement in eager
leaves, from the change of `pipeline.stats["leaf_ms"]` over the window."""


def read(ctx):
    n = ctx["statements"]
    return ctx["counts"]["pipeline.leaf_ms"] / n if n else None
