"""Front end (`plan/optimizer.py`): CROSS joins run a statement, from the
change of `pipeline.stats["cross_joins"]`, which the executor adds to at
each one (a program never holds one); None where the program has no such
counter."""


def read(ctx):
    n, c = ctx["statements"], ctx["counts"].get("pipeline.cross_joins")
    return c / n if n and c is not None else None
