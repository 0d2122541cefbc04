"""Event-time watermarks + late-event policies.

Parity surface: reference crates/query-streaming/src/watermark.rs:10-108 —
monotonic AtomicI64 event-time watermark (advance/is_late) and
LateEventPolicy Drop / SideOutput / Allow{max_lateness}.
"""

from __future__ import annotations

import enum
import threading
from dataclasses import dataclass


class Watermark:
    """Monotonically advancing event-time watermark (ms)."""

    def __init__(self, initial_ms: int = -(2**63)):
        self._value = initial_ms
        self._lock = threading.Lock()

    def advance(self, timestamp_ms: int) -> bool:
        """Advance if newer; returns True if the watermark moved."""
        with self._lock:
            if timestamp_ms > self._value:
                self._value = timestamp_ms
                return True
            return False

    @property
    def current(self) -> int:
        return self._value

    def is_late(self, timestamp_ms: int) -> bool:
        return timestamp_ms < self._value


class LateEventAction(enum.Enum):
    DROP = "Drop"
    SIDE_OUTPUT = "SideOutput"
    ALLOW = "Allow"


@dataclass
class LateEventPolicy:
    action: LateEventAction = LateEventAction.DROP
    max_lateness_ms: int = 0

    @staticmethod
    def drop() -> "LateEventPolicy":
        return LateEventPolicy(LateEventAction.DROP)

    @staticmethod
    def side_output() -> "LateEventPolicy":
        return LateEventPolicy(LateEventAction.SIDE_OUTPUT)

    @staticmethod
    def allow(max_lateness_ms: int) -> "LateEventPolicy":
        return LateEventPolicy(LateEventAction.ALLOW, max_lateness_ms)

    def should_allow_late(self, timestamp_ms: int, watermark: Watermark) -> bool:
        if not watermark.is_late(timestamp_ms):
            return True
        if self.action is LateEventAction.ALLOW:
            return timestamp_ms >= watermark.current - self.max_lateness_ms
        return False
