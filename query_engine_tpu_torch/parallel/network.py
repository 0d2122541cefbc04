"""Control-plane messages + batch serialization.

Parity surface: reference crates/query-distributed/src/network.rs:14-190 —
CoordinatorMessage (ExecuteTask/CancelTask/GetStatus/Shutdown/Ping) and
WorkerMessage (Register/TaskComplete/TaskProgress/Heartbeat/Pong) enums,
`SerializedBatch` = Arrow IPC stream round-trip (:54-101),
TaskExecutionRequest/Response, NetworkConfig (64MB max message).

In the port the stage walk's workers share one process, so batches move
between stages as device tensors with no serialization; Arrow IPC serves
the control plane and disk checkpoints (parallel/fault.py). A batch is
written through `ColumnBatch.to_arrow` (its live rows, read to the host
once) and read back onto the caller's device.
"""

from __future__ import annotations

import enum
import io
from dataclasses import dataclass, field
from typing import List, Optional

import pyarrow as pa

from query_engine_tpu_torch.core.errors import DistributedError
from query_engine_tpu_torch.columnar.batch import ColumnBatch


@dataclass
class NetworkConfig:
    """network.rs:181-190 defaults."""

    max_message_bytes: int = 64 * 1024 * 1024
    connect_timeout_secs: float = 10.0
    request_timeout_secs: float = 60.0


class CoordinatorMessageType(enum.Enum):
    EXECUTE_TASK = "ExecuteTask"
    CANCEL_TASK = "CancelTask"
    GET_STATUS = "GetStatus"
    SHUTDOWN = "Shutdown"
    PING = "Ping"


class WorkerMessageType(enum.Enum):
    REGISTER = "Register"
    TASK_COMPLETE = "TaskComplete"
    TASK_PROGRESS = "TaskProgress"
    HEARTBEAT = "Heartbeat"
    PONG = "Pong"


@dataclass
class CoordinatorMessage:
    type: CoordinatorMessageType
    task_id: Optional[str] = None
    payload: Optional[bytes] = None


@dataclass
class WorkerMessage:
    type: WorkerMessageType
    worker_id: str = ""
    task_id: Optional[str] = None
    payload: Optional[bytes] = None
    progress: float = 0.0


class SerializedBatch:
    """Arrow IPC stream round-trip (network.rs:54-101)."""

    def __init__(self, data: bytes, num_rows: int):
        self.data = data
        self.num_rows = num_rows

    @staticmethod
    def serialize(batch: ColumnBatch,
                  config: Optional[NetworkConfig] = None) -> "SerializedBatch":
        rb = batch.to_arrow()
        sink = io.BytesIO()
        with pa.ipc.new_stream(sink, rb.schema) as writer:
            writer.write_batch(rb)
        data = sink.getvalue()
        cfg = config or NetworkConfig()
        if len(data) > cfg.max_message_bytes:
            raise DistributedError(
                f"serialized batch ({len(data)} bytes) exceeds max message "
                f"size ({cfg.max_message_bytes})"
            )
        return SerializedBatch(data, batch.num_rows)

    def deserialize(self, device="cpu") -> ColumnBatch:
        with pa.ipc.open_stream(io.BytesIO(self.data)) as reader:
            table = reader.read_all()
        return ColumnBatch.from_arrow(table, device=device)

    @property
    def size_bytes(self) -> int:
        return len(self.data)


@dataclass
class TaskExecutionRequest:
    task_id: str
    query_id: str
    stage_id: int
    partition: int
    input_batches: List[SerializedBatch] = field(default_factory=list)


@dataclass
class TaskExecutionResponse:
    task_id: str
    success: bool
    result_batches: List[SerializedBatch] = field(default_factory=list)
    error: Optional[str] = None
    execution_time_ms: float = 0.0
