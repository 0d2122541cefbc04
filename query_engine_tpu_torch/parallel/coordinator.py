"""Coordinator + Worker: the host control plane.

Parity surface:
* Coordinator — reference crates/query-distributed/src/coordinator.rs:13-194:
  worker registry, register/unregister with duplicate-address check (:45-62),
  heartbeat + staleness health sweep (:109-131), execute().
* Worker — reference crates/query-distributed/src/worker.rs:11-176:
  task-slot accounting (max 4), execute_task with timing/status wrap,
  graceful drain on shutdown (:153-164).

Two honest differences from the reference: execute() actually executes (the
reference returns Ok(vec![]) — coordinator.rs:134-155), and Worker's
execute_plan_fragment is real (the reference's is a TODO returning empty —
worker.rs:132-137). In-process workers model per-host runners: each holds
its own QueryExecutor on the coordinator's device, the card ("cuda") by
default. Without CUDA a Coordinator on the card raises, as a Session does;
nothing falls back to the CPU.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from query_engine_tpu_torch.core.errors import DistributedError
from query_engine_tpu_torch.columnar.batch import ColumnBatch
from query_engine_tpu_torch.parallel.types import (
    ClusterConfig, ClusterStatus, QueryTask, TaskResult, TaskStatus,
    WorkerInfo, WorkerStatus, new_id,
)


class Worker:
    """A per-host task runner holding a QueryExecutor."""

    def __init__(self, worker_id: Optional[str] = None, max_tasks: int = 4,
                 address: str = "local", device="cuda"):
        from query_engine_tpu_torch.engine.executor import QueryExecutor
        from query_engine_tpu_torch.engine.session import require_device

        self.device = require_device(device, "Worker")
        self.worker_id = worker_id or new_id()
        self.address = address
        self.max_tasks = max_tasks
        self._active = 0
        self._draining = False
        self._lock = threading.RLock()
        # one fragment at a time on the executor: its compiled programs
        # replay into fixed input and output planes, so two tasks at once
        # would overwrite each other's
        self._exec_lock = threading.Lock()
        self.executor = QueryExecutor(self.device)

    @property
    def active_tasks(self) -> int:
        return self._active

    def has_capacity(self) -> bool:
        with self._lock:
            return not self._draining and self._active < self.max_tasks

    def execute_task(self, task: QueryTask) -> TaskResult:
        """Timing/status wrapper (worker.rs:83-129) around a REAL fragment
        execution."""
        with self._lock:
            if self._draining:
                return TaskResult(task.task_id, TaskStatus.CANCELLED,
                                  error="worker draining")
            if self._active >= self.max_tasks:
                return TaskResult(task.task_id, TaskStatus.FAILED,
                                  error="no task slots")
            self._active += 1
        t0 = time.perf_counter()
        try:
            result = self.execute_plan_fragment(task)
            ms = (time.perf_counter() - t0) * 1000
            rows = result.num_rows if isinstance(result, ColumnBatch) else 0
            return TaskResult(task.task_id, TaskStatus.COMPLETED, result,
                              execution_time_ms=ms, rows_produced=rows)
        except Exception as e:  # noqa: BLE001 - task isolation boundary
            ms = (time.perf_counter() - t0) * 1000
            return TaskResult(task.task_id, TaskStatus.FAILED,
                              error=str(e), execution_time_ms=ms)
        finally:
            with self._lock:
                self._active -= 1

    def execute_plan_fragment(self, task: QueryTask):
        """Real fragment execution (replaces worker.rs:132-137 TODO)."""
        frag = task.plan_fragment
        if frag is None:
            raise DistributedError("task has no plan fragment")
        if callable(frag):
            return frag()
        with self._exec_lock:
            return self.executor.execute(frag)

    def drain(self, timeout_s: float = 10.0) -> None:
        """Graceful shutdown (worker.rs:153-164)."""
        with self._lock:
            self._draining = True
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            with self._lock:
                if self._active == 0:
                    return
            time.sleep(0.01)


class Coordinator:
    def __init__(self, config: Optional[ClusterConfig] = None,
                 device="cuda"):
        """device: where the workers' executors and the stage walk run,
        the card by default; "cpu" runs them on the CPU."""
        from query_engine_tpu_torch.engine.session import require_device

        self.device = require_device(device, "Coordinator")
        self.config = config or ClusterConfig()
        self._workers: Dict[str, WorkerInfo] = {}
        self._runners: Dict[str, Worker] = {}
        self._lock = threading.RLock()

    # ---- registry (coordinator.rs:45-107) -------------------------------
    def register_worker(self, address: str, max_tasks: int = 4,
                        runner: Optional[Worker] = None) -> str:
        with self._lock:
            for w in self._workers.values():
                if w.address == address and w.status is not WorkerStatus.REMOVED:
                    raise DistributedError(
                        f"worker address '{address}' already registered"
                    )
            worker = runner or Worker(address=address, max_tasks=max_tasks,
                                      device=self.device)
            info = WorkerInfo(worker.worker_id, address, max_tasks=max_tasks)
            self._workers[worker.worker_id] = info
            self._runners[worker.worker_id] = worker
            return worker.worker_id

    def unregister_worker(self, worker_id: str) -> None:
        with self._lock:
            info = self._workers.get(worker_id)
            if info is None:
                raise DistributedError(f"unknown worker {worker_id}")
            info.status = WorkerStatus.REMOVED
            self._runners.pop(worker_id, None)

    def heartbeat(self, worker_id: str) -> None:
        with self._lock:
            info = self._workers.get(worker_id)
            if info is not None:
                info.last_heartbeat_ms = time.time() * 1000
                if info.status is WorkerStatus.UNHEALTHY:
                    info.status = WorkerStatus.ACTIVE

    def check_worker_health(self) -> List[str]:
        """Staleness sweep (coordinator.rs:109-131). Returns newly-unhealthy."""
        timeout_ms = self.config.worker_timeout_secs * 1000
        newly = []
        with self._lock:
            for info in self._workers.values():
                if info.status in (WorkerStatus.ACTIVE, WorkerStatus.BUSY):
                    if info.is_stale(timeout_ms):
                        info.status = WorkerStatus.UNHEALTHY
                        newly.append(info.worker_id)
        return newly

    def mark_unhealthy(self, worker_id: str) -> None:
        with self._lock:
            info = self._workers.get(worker_id)
            if info is not None:
                info.status = WorkerStatus.UNHEALTHY

    def active_workers(self) -> List[WorkerInfo]:
        return [
            w for w in self._workers.values()
            if w.status in (WorkerStatus.ACTIVE, WorkerStatus.BUSY)
        ]

    def active_worker_count(self) -> int:
        return len(self.active_workers())

    def runner(self, worker_id: str) -> Optional[Worker]:
        return self._runners.get(worker_id)

    def cluster_status(self) -> ClusterStatus:
        with self._lock:
            active = self.active_workers()
            return ClusterStatus(
                total_workers=len(self._workers),
                active_workers=len(active),
                total_capacity=sum(w.max_tasks for w in active),
                active_tasks=sum(w.active_tasks for w in active),
            )

    # ---- execution ------------------------------------------------------
    def execute(self, logical_plan, sources) -> ColumnBatch:
        """Plan + distribute + run (REAL — replaces the placeholder at
        coordinator.rs:134-155)."""
        from query_engine_tpu_torch.parallel.dexecutor import DistributedExecutor

        dex = DistributedExecutor(self)
        return dex.execute(logical_plan, sources)
