"""Exchange and merge operators for stage boundaries.

Parity surface: reference crates/query-distributed/src/operators.rs:17-294 —
Exchange (Partitioner wrapper with hash/round_robin/gather constructors),
Merge strategies Concat / SortedMerge (real: concat + lexsort + take,
operators.rs:141-194) / UnionDistinct (a TODO in the reference — real here),
and ResultCollector. Every merge runs on the batches' device.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from query_engine_tpu_torch.core.errors import DistributedError
from query_engine_tpu_torch.columnar.batch import ColumnBatch, padded_capacity
from query_engine_tpu_torch.ops import kernels as K
from query_engine_tpu_torch.parallel.partition import Partitioner


class Exchange:
    """Repartitions batches between stages (operators.rs:17-73)."""

    def __init__(self, partitioner: Partitioner):
        self.partitioner = partitioner

    @staticmethod
    def hash(num_partitions: int, key_columns: List[str]) -> "Exchange":
        return Exchange(Partitioner.hash(num_partitions, key_columns))

    @staticmethod
    def round_robin(num_partitions: int) -> "Exchange":
        return Exchange(Partitioner.round_robin(num_partitions))

    @staticmethod
    def gather() -> "Exchange":
        return Exchange(Partitioner.single())

    def execute(self, batches: List[ColumnBatch]) -> List[List[ColumnBatch]]:
        """Partition each input batch; result[p] = batches for partition p."""
        n = self.partitioner.num_partitions
        out: List[List[ColumnBatch]] = [[] for _ in range(n)]
        for b in batches:
            for p, pb in enumerate(self.partitioner.partition(b)):
                if pb.num_rows > 0:
                    out[p].append(pb)
        return out


class MergeStrategy(enum.Enum):
    CONCAT = "concat"
    SORTED = "sorted"
    UNION_DISTINCT = "union_distinct"


class Merge:
    """Merges per-partition results (operators.rs:77-225)."""

    def __init__(self, strategy: MergeStrategy,
                 sort_keys: Optional[List[tuple]] = None):
        # sort_keys: list of (column_name, ascending)
        self.strategy = strategy
        self.sort_keys = sort_keys or []

    @staticmethod
    def concat() -> "Merge":
        return Merge(MergeStrategy.CONCAT)

    @staticmethod
    def sorted(sort_keys: List[tuple]) -> "Merge":
        return Merge(MergeStrategy.SORTED, sort_keys)

    @staticmethod
    def union_distinct() -> "Merge":
        return Merge(MergeStrategy.UNION_DISTINCT)

    def execute(self, batches: List[ColumnBatch]) -> ColumnBatch:
        batches = [b for b in batches if b is not None]
        if not batches:
            raise DistributedError("merge of zero batches")
        merged = ColumnBatch.concat(batches) if len(batches) > 1 else batches[0]
        n = merged.num_rows
        if self.strategy is MergeStrategy.CONCAT:
            return merged
        if self.strategy is MergeStrategy.SORTED:
            cols = [merged.column(name) for name, _ in self.sort_keys]
            ascs = [asc for _, asc in self.sort_keys]
            perm = K.sort_permutation(
                [c.data for c in cols], [c.validity for c in cols], ascs,
                [not a for a in ascs], n)
            return merged.take(perm, n)
        if self.strategy is MergeStrategy.UNION_DISTINCT:
            # the first occurrence of each row, in row order
            dev = merged.columns[0].data.device
            first = K.distinct_first_flags(
                [c.data for c in merged.columns],
                [c.validity for c in merged.columns],
                torch.zeros(merged.capacity, dtype=torch.int64, device=dev),
                n)
            count = int(K.filter_count(first, n))
            idx = K.compaction_indices(first, n, padded_capacity(count))
            return merged.take(idx, count)
        raise DistributedError(f"unknown merge strategy {self.strategy}")


@dataclass
class ResultCollector:
    """Gathers per-partition results and finalizes (operators.rs:228-294)."""

    expected_partitions: int
    merge: Merge = field(default_factory=Merge.concat)
    _parts: Dict[int, List[ColumnBatch]] = field(default_factory=dict)

    def add_partition_result(self, partition: int, batches: List[ColumnBatch]):
        if partition >= self.expected_partitions:
            raise DistributedError(
                f"partition {partition} out of range "
                f"(expected {self.expected_partitions})"
            )
        self._parts.setdefault(partition, []).extend(batches)

    @property
    def is_complete(self) -> bool:
        return len(self._parts) >= self.expected_partitions

    def finalize(self) -> ColumnBatch:
        if not self.is_complete:
            raise DistributedError(
                f"only {len(self._parts)}/{self.expected_partitions} "
                "partitions reported"
            )
        all_batches: List[ColumnBatch] = []
        for p in sorted(self._parts):
            all_batches.extend(self._parts[p])
        return self.merge.execute(all_batches)
