"""The traced window: `torch.profiler` over the statements, reduced to what
the per-layer metrics read.

`start` opens the profiler (CPU and CUDA activity) before the window, so its
start-up is not in the window; `span` marks each statement with a
`port_bench:<statement>` range; `stop` closes it and reduces the raw events:

- `busy_s`: the union of all device events' intervals (kernels, copies
  and fills) inside the window, `window_s`: first statement's start to the
  last one's end, both on the profiler's clock;
- `kernel_s`, `kernel_count`: the durations summed and the number of the
  device events that are not a memory copy or fill (the CUDA kernels, graph
  replays' included), `device_events` the number of all;
- `by_statement`: per statement name, its count, host ms and the kernel ms
  of the kernels that ran inside its ranges (each statement ends with a
  read of its rows, so its kernels finish inside its range);
- `breakdown`: the ten device operations with the most time, and the ten
  longest idle gaps, each named by its statement and the innermost host
  event open at the gap's middle.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np

PREFIX = "port_bench:"
NAME_CHARS = 160    # a kernel's name in the breakdown, cut to this length
COPY_WORDS = ("Memcpy", "Memset", "memcpy", "memset")


def start(cuda: bool):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    prof = profile(activities=acts)
    prof.start()
    return prof


def span(prof, name: str):
    if prof is None:
        return contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function(PREFIX + name)


def _union(starts: np.ndarray, ends: np.ndarray) -> float:
    """Total length of the union of [start, end) intervals."""
    if not len(starts):
        return 0.0
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    run_end = np.maximum.accumulate(e)
    # a new run starts where an interval begins after every earlier end
    new = np.ones(len(s), dtype=bool)
    new[1:] = s[1:] > run_end[:-1]
    idx = np.nonzero(new)[0]
    run_start = s[idx]
    last = np.append(idx[1:] - 1, len(s) - 1)
    return float((run_end[last] - run_start).sum())


def _gaps(starts, ends, lo, hi):
    """(gap start, gap length) of the idle stretches in [lo, hi)."""
    if not len(starts):
        return [(lo, hi - lo)]
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], np.maximum.accumulate(ends[order])
    out = []
    prev = lo
    for a, b in zip(s, e):
        if a > prev:
            out.append((prev, a - prev))
        prev = max(prev, b)
    if hi > prev:
        out.append((prev, hi - prev))
    return out


def stop(prof) -> Optional[dict]:
    from torch.autograd import DeviceType

    prof.stop()
    events = prof.profiler.kineto_results.events()
    dev_name, dev_s, dev_e = [], [], []
    cpu_name, cpu_s, cpu_e = [], [], []
    ranges = []
    for ev in events:
        s = ev.start_ns()
        e = s + ev.duration_ns()
        name = ev.name()
        if ev.device_type() == DeviceType.CUDA:
            if name.startswith(PREFIX) or ev.is_user_annotation():
                continue    # a range's shadow on the device's timeline
            dev_name.append(name)
            dev_s.append(s)
            dev_e.append(e)
        elif name.startswith(PREFIX):
            ranges.append((name[len(PREFIX):], s, e))
        else:
            cpu_name.append(name)
            cpu_s.append(s)
            cpu_e.append(e)
    if not ranges:
        return None
    ranges.sort(key=lambda r: r[1])
    lo, hi = ranges[0][1], max(r[2] for r in ranges)
    dev_s, dev_e = np.asarray(dev_s, np.int64), np.asarray(dev_e, np.int64)
    inside = (dev_e > lo) & (dev_s < hi)
    is_kernel = np.asarray([not any(w in n for w in COPY_WORDS)
                            for n in dev_name], dtype=bool)
    k_sel = inside & is_kernel if len(dev_name) else inside
    ks, ke = dev_s[k_sel], dev_e[k_sel]
    busy = _union(np.clip(dev_s[inside], lo, hi), np.clip(dev_e[inside], lo,
                                                          hi))
    by_name = {}
    for n, s, e in zip(np.asarray(dev_name, dtype=object)[inside],
                       dev_s[inside], dev_e[inside]):
        by_name[n] = by_name.get(n, 0) + int(e - s)
    by_stmt = {}
    mid = (ks + ke) // 2
    for q, s, e in ranges:
        b = by_stmt.setdefault(q, {"count": 0, "host_ms": 0.0,
                                   "kernel_ms": 0.0})
        b["count"] += 1
        b["host_ms"] += (e - s) / 1e6
        sel = (mid >= s) & (mid < e)
        b["kernel_ms"] += float((ke[sel] - ks[sel]).sum()) / 1e6
    cs, ce = np.asarray(cpu_s, np.int64), np.asarray(cpu_e, np.int64)
    starts_r = np.asarray([r[1] for r in ranges], np.int64)
    gaps = sorted(_gaps(dev_s[inside], dev_e[inside], lo, hi),
                  key=lambda g: -g[1])[:10]
    idle = []
    for g0, glen in gaps:
        m = g0 + glen // 2
        q = ranges[max(int(np.searchsorted(starts_r, m, "right")) - 1, 0)][0]
        open_ = np.nonzero((cs <= m) & (ce >= m))[0] if len(cs) else []
        host = cpu_name[open_[np.argmax(cs[open_])]] if len(open_) else "-"
        idle.append([f"{q}: {host}", glen / 1e9])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "window_s": (hi - lo) / 1e9,
        "busy_s": busy / 1e9,
        "kernel_s": float((ke - ks).sum()) / 1e9,
        "kernel_count": int(k_sel.sum()),
        "device_events": len(dev_name),
        "by_statement": by_stmt,
        "breakdown": {"device_ops": [[n[:NAME_CHARS], t / 1e9]
                                     for n, t in top],
                      "idle_gaps": idle},
    }
