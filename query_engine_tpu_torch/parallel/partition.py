"""Partitioner: hash / range / round-robin / single.

Parity surface: reference crates/query-distributed/src/partition.rs:12-359 —
row-level Hash partitioning (per-row hash over key columns % num_partitions,
gather rows per partition via take, :151-212,292-316), Range (boundary scan
:232-289), RoundRobin (batch-level modulo :215-229), Single (gather), and
`route(key)` for key->partition routing.

Partition ids are computed on the batch's device (splitmix64 of the
orderable key, parallel/spmd.py) and stay there: one stable sort of the
live rows by partition id orders every partition's rows ascending, one host
read gives the partition sizes, and each partition is a device gather of
its run of that order (the JAX package picks the rows on the host). Row
order within a partition is the reference's.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import List, Optional

import torch

from query_engine_tpu_torch.core.errors import DistributedError
from query_engine_tpu_torch.columnar.batch import ColumnBatch
from query_engine_tpu_torch.ops import kernels as K
from query_engine_tpu_torch.parallel.spmd import key_hash, splitmix64, umod


class PartitionStrategy(enum.Enum):
    HASH = "hash"
    RANGE = "range"
    ROUND_ROBIN = "round_robin"
    SINGLE = "single"


@dataclass
class RangeBoundary:
    """Upper bound (exclusive) of a range partition (partition.rs:319-340)."""

    upper: float


def _device(batch: ColumnBatch) -> torch.device:
    return batch.columns[0].data.device if batch.columns \
        else torch.device("cpu")


class Partitioner:
    def __init__(
        self,
        strategy: PartitionStrategy,
        num_partitions: int,
        key_columns: Optional[List[str]] = None,
        boundaries: Optional[List[RangeBoundary]] = None,
    ):
        if num_partitions <= 0:
            raise DistributedError("num_partitions must be positive")
        self.strategy = strategy
        self.num_partitions = num_partitions
        self.key_columns = key_columns or []
        self.boundaries = boundaries

    # ---- constructors (reference Exchange::hash/round_robin/gather) ----
    @staticmethod
    def hash(num_partitions: int, key_columns: List[str]) -> "Partitioner":
        return Partitioner(PartitionStrategy.HASH, num_partitions, key_columns)

    @staticmethod
    def round_robin(num_partitions: int) -> "Partitioner":
        return Partitioner(PartitionStrategy.ROUND_ROBIN, num_partitions)

    @staticmethod
    def range(num_partitions: int, key_columns: List[str],
              boundaries: List[RangeBoundary]) -> "Partitioner":
        return Partitioner(
            PartitionStrategy.RANGE, num_partitions, key_columns, boundaries
        )

    @staticmethod
    def single() -> "Partitioner":
        return Partitioner(PartitionStrategy.SINGLE, 1)

    # ---- partitioning ---------------------------------------------------
    def partition(self, batch: ColumnBatch) -> List[ColumnBatch]:
        """Split a batch into num_partitions batches (row conservation
        guaranteed — reference partition tests partition.rs:361-441)."""
        if self.strategy is PartitionStrategy.SINGLE:
            return [batch]
        if self.strategy is PartitionStrategy.ROUND_ROBIN:
            pid = torch.arange(batch.capacity, device=_device(batch)) \
                % self.num_partitions
        elif self.strategy is PartitionStrategy.HASH:
            pid = self._hash_pids(batch)
        elif self.strategy is PartitionStrategy.RANGE:
            pid = self._range_pids(batch)
        else:
            raise DistributedError(f"unknown strategy {self.strategy}")
        return self._split(batch, pid)

    def _split(self, batch: ColumnBatch, pid: torch.Tensor
               ) -> List[ColumnBatch]:
        """Each partition's live rows, ascending: one stable sort of the
        partition ids (pad rows sort last), one host read of the sizes,
        one gather per partition."""
        p = self.num_partitions
        live = K.live_mask(batch.capacity, batch.num_rows, pid.device)
        key = torch.where(live, pid.to(torch.int64),
                          torch.full_like(pid, p, dtype=torch.int64))
        order = torch.sort(key, stable=True).indices
        sizes = torch.bincount(key, minlength=p + 1)[:p].tolist()
        out, lo = [], 0
        for size in sizes:
            out.append(batch.take(order[lo: lo + size], size))
            lo += size
        return out

    def _hash_pids(self, batch: ColumnBatch) -> torch.Tensor:
        if not self.key_columns:
            raise DistributedError("hash partitioning requires key columns")
        acc = None
        valid_all = None
        for col in self.key_columns:
            c = batch.column(col)
            h = torch.where(c.validity, key_hash(c.data),
                            torch.zeros((), dtype=torch.int64,
                                        device=c.data.device))
            acc = h if acc is None else splitmix64(acc ^ h)
            valid_all = c.validity if valid_all is None \
                else (valid_all & c.validity)
        pid = umod(acc, self.num_partitions).to(torch.int32)
        return torch.where(valid_all, pid, torch.zeros_like(pid))

    def _range_pids(self, batch: ColumnBatch) -> torch.Tensor:
        if not self.boundaries:
            raise DistributedError("range partitioning requires boundaries")
        vals = batch.column(self.key_columns[0]).data.to(torch.float64)
        uppers = torch.tensor([b.upper for b in self.boundaries],
                              dtype=torch.float64, device=vals.device)
        pid = torch.searchsorted(uppers, vals, right=True)
        return pid.clamp(0, self.num_partitions - 1)

    def route(self, key) -> int:
        """Single-key routing (reference partition.rs route). Python's
        `hash` of a string differs between processes."""
        if self.strategy is PartitionStrategy.SINGLE:
            return 0
        if self.strategy is PartitionStrategy.HASH:
            h = splitmix64(torch.tensor([hash(key)], dtype=torch.int64))
            return (int(h[0]) & ((1 << 64) - 1)) % self.num_partitions
        if self.strategy is PartitionStrategy.RANGE:
            uppers = torch.tensor([b.upper for b in self.boundaries],
                                  dtype=torch.float64)
            pid = int(torch.searchsorted(
                uppers, torch.tensor([float(key)], dtype=torch.float64),
                right=True)[0])
            return min(max(pid, 0), self.num_partitions - 1)
        raise DistributedError("route() not defined for round-robin")
