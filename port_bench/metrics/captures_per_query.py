"""Compiled pipeline (`engine/pipeline.py`): CUDA graph captures a statement
in the window, from the change of `pipeline.stats["captures"]`. A warm
statement that captures again pays the capture on the host."""


def read(ctx):
    n = ctx["statements"]
    return ctx["counts"]["pipeline.captures"] / n if n else None
