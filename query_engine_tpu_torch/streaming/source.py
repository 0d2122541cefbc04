"""Stream sources.

Parity surface: reference crates/query-streaming/src/source.rs:12-131 —
async pull `StreamSource` trait (next_batch/is_exhausted/name),
ChannelStreamSource (tokio mpsc -> queue.Queue here) and MemoryStreamSource
(test vector).
"""

from __future__ import annotations

import queue
import threading
from typing import List, Optional

from query_engine_tpu_torch.columnar.batch import ColumnBatch


class StreamSource:
    def next_batch(self, timeout: Optional[float] = None) -> Optional[ColumnBatch]:
        raise NotImplementedError

    def is_exhausted(self) -> bool:
        raise NotImplementedError

    def name(self) -> str:
        raise NotImplementedError


class ChannelStreamSource(StreamSource):
    """Producer/consumer channel source (source.rs:25-78)."""

    def __init__(self, name: str = "channel", maxsize: int = 0):
        self._name = name
        self._queue: "queue.Queue" = queue.Queue(maxsize=maxsize)
        self._closed = threading.Event()

    def send(self, batch: ColumnBatch) -> None:
        if self._closed.is_set():
            raise RuntimeError("channel closed")
        self._queue.put(batch)

    def close(self) -> None:
        self._closed.set()

    def next_batch(self, timeout: Optional[float] = None) -> Optional[ColumnBatch]:
        try:
            return self._queue.get(
                timeout=timeout if timeout is not None else 0.05
            )
        except queue.Empty:
            return None

    def is_exhausted(self) -> bool:
        return self._closed.is_set() and self._queue.empty()

    def name(self) -> str:
        return self._name


class MemoryStreamSource(StreamSource):
    """Canned batches for tests (source.rs:81-131)."""

    def __init__(self, batches: List[ColumnBatch], name: str = "memory"):
        self._batches = list(batches)
        self._pos = 0
        self._name = name

    def next_batch(self, timeout: Optional[float] = None) -> Optional[ColumnBatch]:
        if self._pos >= len(self._batches):
            return None
        b = self._batches[self._pos]
        self._pos += 1
        return b

    def is_exhausted(self) -> bool:
        return self._pos >= len(self._batches)

    def name(self) -> str:
        return self._name
