"""Eager walk (`engine/executor.py`, `engine/expr_eval.py`): reads from the
device a statement, from the change of `executor.host_syncs`."""


def read(ctx):
    n = ctx["statements"]
    return ctx["counts"]["executor.host_syncs"] / n if n else None
