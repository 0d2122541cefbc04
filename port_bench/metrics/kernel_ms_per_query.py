"""Kernels (`ops/`, `csrc/`): CUDA kernel ms a statement, the durations of
every kernel in the profiler's trace of the window summed (copies and
fills left out), over the window's statements."""


def read(ctx):
    tr, n = ctx["trace"], ctx["statements"]
    if not tr or not tr["kernel_count"] or not n:
        return None
    return 1e3 * tr["kernel_s"] / n
