"""Fault manager: task retry, worker health, stage checkpoints.

Parity surface: reference crates/query-distributed/src/fault.rs:12-327 —
task failure -> Retry{delay} (<= max retries) or Fail (:111-153); worker
consecutive-failure threshold -> MarkUnhealthy/Remove (:156-170); success
resets the counter; per-query checkpoints of completed stages + intermediate
results with recover_from_checkpoint -> RecoveryPlan{resume_from_stage}
(:209-249); stats + aged cleanup.

Checkpoints hold the partitioned intermediate ColumnBatches at stage
boundaries as they are (on the executor's device), or spill them to disk
as Arrow IPC when `checkpoint_dir` is set, keyed by (query_id, stage_id);
on failure the executor re-runs from the first un-checkpointed stage.
"""

from __future__ import annotations

import enum
import time
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class FaultConfig:
    """reference fault.rs:40-50 defaults."""

    max_task_retries: int = 3
    retry_delay_secs: float = 1.0
    worker_failure_threshold: int = 3
    remove_unhealthy_workers: bool = False
    checkpoint_ttl_secs: float = 3600.0
    # spill checkpointed intermediates to disk (Arrow IPC) instead of RAM —
    # the reference keeps blobs in a DashMap only (fault.rs:209-249);
    # SURVEY §5 calls for host-RAM/disk at stage boundaries
    checkpoint_dir: Optional[str] = None


class TaskRecoveryAction(enum.Enum):
    RETRY = "Retry"
    FAIL = "Fail"


class WorkerRecoveryAction(enum.Enum):
    NONE = "None"
    MARK_UNHEALTHY = "MarkUnhealthy"
    REMOVE = "Remove"


@dataclass
class QueryCheckpoint:
    query_id: str
    completed_stages: List[int] = field(default_factory=list)
    intermediate: Dict[int, object] = field(default_factory=dict)
    created_at: float = field(default_factory=time.time)


@dataclass
class RecoveryPlan:
    query_id: str
    resume_from_stage: int


@dataclass
class FaultStats:
    task_failures: int = 0
    task_retries: int = 0
    permanent_failures: int = 0
    worker_failures: int = 0
    workers_removed: int = 0


class FaultManager:
    def __init__(self, config: Optional[FaultConfig] = None):
        self.config = config or FaultConfig()
        self._task_retries: Dict[str, int] = {}
        self._worker_failures: Dict[str, int] = {}
        self._checkpoints: Dict[str, QueryCheckpoint] = {}
        self.stats = FaultStats()
        self._lock = threading.RLock()

    # ---- task failures (fault.rs:111-153) -------------------------------
    def handle_task_failure(self, task_id: str, error: str = "") -> tuple:
        with self._lock:
            self.stats.task_failures += 1
            n = self._task_retries.get(task_id, 0)
            if n < self.config.max_task_retries:
                self._task_retries[task_id] = n + 1
                self.stats.task_retries += 1
                return (TaskRecoveryAction.RETRY, self.config.retry_delay_secs)
            self.stats.permanent_failures += 1
            return (TaskRecoveryAction.FAIL, 0.0)

    def handle_task_success(self, task_id: str) -> None:
        with self._lock:
            self._task_retries.pop(task_id, None)

    # ---- worker failures (fault.rs:156-196) -----------------------------
    def handle_worker_failure(self, worker_id: str) -> WorkerRecoveryAction:
        with self._lock:
            self.stats.worker_failures += 1
            n = self._worker_failures.get(worker_id, 0) + 1
            self._worker_failures[worker_id] = n
            if n >= self.config.worker_failure_threshold:
                if self.config.remove_unhealthy_workers:
                    self.stats.workers_removed += 1
                    return WorkerRecoveryAction.REMOVE
                return WorkerRecoveryAction.MARK_UNHEALTHY
            return WorkerRecoveryAction.NONE

    def handle_worker_success(self, worker_id: str) -> None:
        with self._lock:
            self._worker_failures.pop(worker_id, None)

    # ---- checkpoints (fault.rs:209-249) ---------------------------------
    def checkpoint_stage(self, query_id: str, stage_id: int,
                         intermediate=None) -> None:
        with self._lock:
            cp = self._checkpoints.setdefault(query_id, QueryCheckpoint(query_id))
            if stage_id not in cp.completed_stages:
                cp.completed_stages.append(stage_id)
            if intermediate is not None:
                if self.config.checkpoint_dir is not None:
                    cp.intermediate[stage_id] = self._spill(
                        query_id, stage_id, intermediate
                    )
                else:
                    cp.intermediate[stage_id] = intermediate

    def _spill(self, query_id: str, stage_id: int, batches) -> List[str]:
        """Write per-partition ColumnBatches as Arrow IPC files; returns the
        paths (so recovery can reload them even in a fresh process)."""
        import os

        from query_engine_tpu_torch.parallel.network import SerializedBatch

        d = os.path.join(self.config.checkpoint_dir, query_id)
        os.makedirs(d, exist_ok=True)
        if not isinstance(batches, list):
            batches = [batches]
        paths = []
        for p, b in enumerate(batches):
            path = os.path.join(d, f"stage{stage_id}_part{p}.arrow")
            with open(path, "wb") as f:
                f.write(SerializedBatch.serialize(b).data)
            paths.append(path)
        return paths

    def load_checkpoint_data(self, query_id: str, stage_id: int):
        """Reload checkpointed intermediates (list of ColumnBatch)."""
        cp = self._checkpoints.get(query_id)
        if cp is None or stage_id not in cp.intermediate:
            return None
        stored = cp.intermediate[stage_id]
        if isinstance(stored, list) and stored and isinstance(stored[0], str):
            from query_engine_tpu_torch.parallel.network import SerializedBatch

            out = []
            for path in stored:
                with open(path, "rb") as f:
                    data = f.read()
                # num_rows recovered from the IPC payload itself
                out.append(SerializedBatch(data, -1).deserialize())
            return out
        return stored

    def get_checkpoint(self, query_id: str) -> Optional[QueryCheckpoint]:
        return self._checkpoints.get(query_id)

    def recover_from_checkpoint(self, query_id: str) -> Optional[RecoveryPlan]:
        cp = self._checkpoints.get(query_id)
        if cp is None or not cp.completed_stages:
            return None
        return RecoveryPlan(query_id, max(cp.completed_stages) + 1)

    def clear_checkpoint(self, query_id: str) -> None:
        with self._lock:
            self._checkpoints.pop(query_id, None)

    def cleanup_aged(self, now: Optional[float] = None) -> int:
        now = now if now is not None else time.time()
        with self._lock:
            stale = [
                q for q, cp in self._checkpoints.items()
                if now - cp.created_at > self.config.checkpoint_ttl_secs
            ]
            for q in stale:
                del self._checkpoints[q]
            return len(stale)
