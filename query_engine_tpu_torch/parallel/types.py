"""Distributed cluster types.

Parity surface: reference crates/query-distributed/src/types.rs:8-287 —
WorkerId/QueryId/TaskId (UUID), WorkerStatus, WorkerInfo (+is_stale),
ClusterStatus (+utilization), ClusterConfig, QueryTask, TaskStatus,
TaskResult.

In the port a "worker" is an in-process runner holding its own
QueryExecutor on the coordinator's device, and a task is one partition of
a stage's plan fragment. The control-plane bookkeeping serves membership
and fault handling.
"""

from __future__ import annotations

import enum
import time
import uuid
from dataclasses import dataclass, field
from typing import Optional


def new_id() -> str:
    return str(uuid.uuid4())


class WorkerStatus(enum.Enum):
    ACTIVE = "Active"
    BUSY = "Busy"
    UNHEALTHY = "Unhealthy"
    DRAINING = "Draining"
    REMOVED = "Removed"


@dataclass
class WorkerInfo:
    worker_id: str
    address: str
    status: WorkerStatus = WorkerStatus.ACTIVE
    max_tasks: int = 4
    active_tasks: int = 0
    last_heartbeat_ms: float = field(default_factory=lambda: time.time() * 1000)
    process_index: int = 0  # the host process that runs the worker

    def is_stale(self, timeout_ms: float) -> bool:
        """reference types.rs:156-160."""
        return (time.time() * 1000 - self.last_heartbeat_ms) > timeout_ms

    def has_capacity(self) -> bool:
        return self.active_tasks < self.max_tasks and self.status in (
            WorkerStatus.ACTIVE, WorkerStatus.BUSY
        )


@dataclass
class ClusterConfig:
    """reference types.rs:216-225 defaults."""

    heartbeat_interval_secs: float = 5.0
    worker_timeout_secs: float = 15.0
    max_task_retries: int = 3
    default_partitions: int = 4


@dataclass
class ClusterStatus:
    total_workers: int
    active_workers: int
    total_capacity: int
    active_tasks: int

    @property
    def utilization(self) -> float:
        """reference types.rs:193-200."""
        if self.total_capacity == 0:
            return 0.0
        return self.active_tasks / self.total_capacity


class TaskStatus(enum.Enum):
    PENDING = "Pending"
    RUNNING = "Running"
    COMPLETED = "Completed"
    FAILED = "Failed"
    CANCELLED = "Cancelled"


@dataclass
class QueryTask:
    task_id: str
    query_id: str
    stage_id: int
    partition: int
    plan_fragment: object = None  # physical plan fragment (no serialization
    # needed in-process; Arrow IPC only at the ingress edges)
    retry_count: int = 0

    @staticmethod
    def new(query_id: str, stage_id: int, partition: int, fragment=None):
        return QueryTask(new_id(), query_id, stage_id, partition, fragment)


@dataclass
class TaskResult:
    task_id: str
    status: TaskStatus
    result: object = None
    error: Optional[str] = None
    execution_time_ms: float = 0.0
    rows_produced: int = 0
