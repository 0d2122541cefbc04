"""Compiled pipeline (`engine/pipeline.py`): host ms a statement in CUDA
graph captures outside eager leaves (the `torch.cuda.graph` block, the
`qe:capture` span), from the change of `pipeline.stats["capture_ms"]`."""


def read(ctx):
    n, ms = ctx["statements"], ctx["counts"].get("pipeline.capture_ms")
    return ms / n if n and ms is not None else None
