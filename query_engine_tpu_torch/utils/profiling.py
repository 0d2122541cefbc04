"""Per-operator counters and the per-statement timing breakdown.

Parity surface: the reference logs with the `tracing` crate and ad-hoc
Instant::now timing (repl.rs:303,347, worker.rs:96-108). The profiler keeps
structured per-operator self time, rows and bytes for EXPLAIN ANALYZE.

The executor records a plan segment that the compiled pipeline ran as one
op, `compiled_pipeline`, so EXPLAIN ANALYZE shows the segment and the
nodes that ran eagerly beside it.

Host wall clock: CUDA launches are asynchronous, so a node is charged the
host time until something it runs waits for the device (a `.item()` or a
device-to-host copy; for a compiled segment, the read of its row count).
Device time per kernel comes from `torch.profiler` or CUDA events, not
from here.

`span` marks a phase of a statement (parse, plan, an eager leaf, making
room for a graph, a capture, a read from the device, ...): while a torch
profiler records, a `qe:<name>` range in its trace, on the clock of the
kernels it launched; always, the phase's host ms, added to a counter where
one is given. Spans on one thread nest by time.
"""

from __future__ import annotations

import contextlib
import logging
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, Optional

import torch

logger = logging.getLogger("query_engine_tpu_torch")


@dataclass
class OpStats:
    calls: int = 0
    total_secs: float = 0.0   # self time: children's time is subtracted
    total_rows: int = 0
    total_bytes: int = 0

    @property
    def rows_per_sec(self) -> float:
        return self.total_rows / self.total_secs if self.total_secs else 0.0

    @property
    def bytes_per_sec(self) -> float:
        return self.total_bytes / self.total_secs if self.total_secs else 0.0


@dataclass
class _OpRecord:
    """Mutable handle yielded by Profiler.op — callers may set rows/bytes
    once the output size is known (data-dependent row counts)."""

    rows: int = 0
    bytes: int = 0


class Profiler:
    """Collects per-operator SELF timings (child operator time subtracted
    via an activation stack, so a recursive executor walk attributes each
    node only its own work)."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.ops: Dict[str, OpStats] = defaultdict(OpStats)
        self._child_secs: list = []  # per-active-frame accumulated child time

    @contextlib.contextmanager
    def op(self, name: str, rows: int = 0, bytes_: int = 0):
        if not self.enabled:
            yield _OpRecord(rows, bytes_)
            return
        rec = _OpRecord(rows, bytes_)
        self._child_secs.append(0.0)
        t0 = time.perf_counter()
        try:
            yield rec
        finally:
            dt = time.perf_counter() - t0
            child = self._child_secs.pop()
            if self._child_secs:
                self._child_secs[-1] += dt
            s = self.ops[name]
            s.calls += 1
            s.total_secs += max(dt - child, 0.0)
            s.total_rows += rec.rows
            s.total_bytes += rec.bytes

    def report(self) -> str:
        lines = ["operator             calls     total_ms       rows/s      bytes/s"]
        for name in sorted(self.ops):
            s = self.ops[name]
            lines.append(
                f"{name:<20} {s.calls:>5} {s.total_secs * 1e3:>12.2f} "
                f"{s.rows_per_sec:>12,.0f} {s.bytes_per_sec:>12,.0f}"
            )
        return "\n".join(lines)

    def reset(self) -> None:
        self.ops.clear()


GLOBAL_PROFILER = Profiler(enabled=False)

SPAN_PREFIX = "qe:"
_NO_RANGE = contextlib.nullcontext()


def profiler_range(name: str):
    """`torch.profiler.record_function(name)` while a torch profiler
    records, else a no-op: an unrecorded range still costs its entry (about
    10 us on an H100 machine's host), the check under 0.1 us."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_RANGE


class span:
    """One phase of a statement: a `qe:<name>` profiler range while a
    profiler records, and its host ms, `ms` once it has closed, added to
    `totals[key]` when `totals` is given (also when the phase raised)."""

    __slots__ = ("name", "totals", "key", "ms", "_range", "_t0")

    def __init__(self, name: str, totals: Optional[dict] = None,
                 key: Optional[str] = None):
        self.name, self.totals, self.key = name, totals, key
        self.ms = 0.0

    def __enter__(self) -> "span":
        self._range = profiler_range(SPAN_PREFIX + self.name)
        self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.ms = (time.perf_counter() - self._t0) * 1e3
        if self.totals is not None:
            self.totals[self.key] = self.totals.get(self.key, 0.0) + self.ms
        self._range.__exit__(*exc)
        return False


@dataclass
class QueryTiming:
    """Plan/execute/total breakdown (doc example CLI_REFERENCE.md:290-292)."""

    parse_ms: float = 0.0
    plan_ms: float = 0.0
    execute_ms: float = 0.0

    @property
    def total_ms(self) -> float:
        return self.parse_ms + self.plan_ms + self.execute_ms

    def __str__(self) -> str:
        return (
            f"Planning: {self.plan_ms:.2f} ms | "
            f"Execution: {self.execute_ms:.2f} ms | "
            f"Total: {self.total_ms:.2f} ms"
        )
