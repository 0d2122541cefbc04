"""Stream windows: tumbling, sliding, session.

Parity surface: reference crates/query-streaming/src/window.rs:8-203 —
processing-time windows driven by elapsed time (Instant::elapsed).
A `clock` injection point replaces wall-clock reads so tests are
deterministic.
"""

from __future__ import annotations

import enum
import time
from dataclasses import dataclass
from typing import Callable, Optional


class Window:
    def should_trigger(self) -> bool:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError

    def keeps_rows_after_trigger(self) -> bool:
        return False


class TumblingWindow(Window):
    """Fixed-size non-overlapping windows."""

    def __init__(self, size_secs: float, clock: Callable[[], float] = time.monotonic):
        self.size = size_secs
        self.clock = clock
        self._start = clock()

    def should_trigger(self) -> bool:
        return self.clock() - self._start >= self.size

    def reset(self) -> None:
        self._start = self.clock()


class SlidingWindow(Window):
    """Overlapping windows: emits every `slide`, covering the last `size`."""

    def __init__(self, size_secs: float, slide_secs: float,
                 clock: Callable[[], float] = time.monotonic):
        self.size = size_secs
        self.slide = slide_secs
        self.clock = clock
        self._last_emit = clock()

    def should_trigger(self) -> bool:
        return self.clock() - self._last_emit >= self.slide

    def reset(self) -> None:
        self._last_emit = self.clock()

    def keeps_rows_after_trigger(self) -> bool:
        return True

    @property
    def retention_secs(self) -> float:
        return self.size


class SessionWindow(Window):
    """Closes after a gap with no events."""

    def __init__(self, gap_secs: float, clock: Callable[[], float] = time.monotonic):
        self.gap = gap_secs
        self.clock = clock
        self._last_event: Optional[float] = None

    def on_event(self) -> None:
        self._last_event = self.clock()

    def should_trigger(self) -> bool:
        if self._last_event is None:
            return False
        return self.clock() - self._last_event >= self.gap

    def reset(self) -> None:
        self._last_event = None


class WindowType(enum.Enum):
    TUMBLING = "tumbling"
    SLIDING = "sliding"
    SESSION = "session"


@dataclass
class WindowSpec:
    kind: WindowType
    size_secs: float = 10.0
    slide_secs: float = 5.0
    gap_secs: float = 30.0

    def create_window(self, clock: Callable[[], float] = time.monotonic) -> Window:
        if self.kind is WindowType.TUMBLING:
            return TumblingWindow(self.size_secs, clock)
        if self.kind is WindowType.SLIDING:
            return SlidingWindow(self.size_secs, self.slide_secs, clock)
        return SessionWindow(self.gap_secs, clock)
