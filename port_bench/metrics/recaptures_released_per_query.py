"""Compiled pipeline (`engine/pipeline.py`): captures a statement of cached
programs whose graph had been released (for room, or after running out of
memory), from the change of `pipeline.stats["recaptures_released"]`; None
where the program has no such counter."""


def read(ctx):
    n, c = ctx["statements"], ctx["counts"].get("pipeline.recaptures_released")
    return c / n if n and c is not None else None
