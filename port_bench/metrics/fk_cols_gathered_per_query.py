"""Compiled pipeline (`engine/pipeline.py`): build columns the FK joins
gathered to their probe rows a statement, from the change of
`pipeline.stats["fk_cols_gathered"]`, which every run of a program adds its
entry's count to (first run, recapture, replay); None where the program has
no such counter."""


def read(ctx):
    n, c = ctx["statements"], ctx["counts"].get("pipeline.fk_cols_gathered")
    return c / n if n and c is not None else None
