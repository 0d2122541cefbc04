"""Task scheduler.

Parity surface: reference crates/query-distributed/src/scheduler.rs:10-130 —
pending deque + running/completed maps, FIFO get_next_task, least-loaded
choose_worker (scheduler.rs:116-123), reschedule_failed bumps retry_count.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Dict, List, Optional

from query_engine_tpu_torch.parallel.types import QueryTask, TaskResult, WorkerInfo


class TaskScheduler:
    def __init__(self):
        self._pending: deque = deque()
        self._running: Dict[str, QueryTask] = {}
        self._completed: Dict[str, TaskResult] = {}
        self._lock = threading.RLock()

    def submit(self, task: QueryTask) -> None:
        with self._lock:
            self._pending.append(task)

    def get_next_task(self) -> Optional[QueryTask]:
        with self._lock:
            if not self._pending:
                return None
            task = self._pending.popleft()
            self._running[task.task_id] = task
            return task

    def choose_worker(self, workers: List[WorkerInfo]) -> Optional[WorkerInfo]:
        """Least-loaded worker with capacity (scheduler.rs:116-123)."""
        candidates = [w for w in workers if w.has_capacity()]
        if not candidates:
            return None
        return min(candidates, key=lambda w: w.active_tasks)

    def complete_task(self, result: TaskResult) -> None:
        with self._lock:
            self._running.pop(result.task_id, None)
            self._completed[result.task_id] = result

    def reschedule_failed(self, task_id: str) -> Optional[QueryTask]:
        with self._lock:
            task = self._running.pop(task_id, None)
            if task is None:
                return None
            task.retry_count += 1
            self._pending.append(task)
            return task

    @property
    def pending_count(self) -> int:
        return len(self._pending)

    @property
    def running_count(self) -> int:
        return len(self._running)

    @property
    def completed_count(self) -> int:
        return len(self._completed)

    def result(self, task_id: str) -> Optional[TaskResult]:
        return self._completed.get(task_id)

    def clear(self) -> None:
        with self._lock:
            self._pending.clear()
            self._running.clear()
            self._completed.clear()
