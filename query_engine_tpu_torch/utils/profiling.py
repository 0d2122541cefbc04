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
"""

from __future__ import annotations

import contextlib
import logging
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict

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
