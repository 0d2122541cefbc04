"""Distributed planner: logical plan -> stage DAG.

Parity surface: reference crates/query-distributed/src/planner.rs:9-328 —
DistributedPlan::{Local,Distributed{stages}}, should_distribute heuristic
(scan/aggregate/join distribute; bare sort/limit do not, planner.rs:145-163),
stage creation (scan -> round-robin stage, filter -> same-partition stage,
aggregate -> partial + final single-partition shuffle stage planner.rs:200-226,
join -> left stages + right stages + shuffle join stage :228-249), and
identify_exchanges marking shuffle points with reasons (:272-327).

Unlike the reference, plan fragments are real plan objects (no Debug-string
"serialization" placeholder, planner.rs:265-269) and the executor actually
runs them.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional

from query_engine_tpu_torch.plan import logical as lp
from query_engine_tpu_torch.parallel.partition import PartitionStrategy


class ExchangeReason(enum.Enum):
    AGGREGATION = "Aggregation"
    JOIN = "Join"
    SORT = "Sort"


@dataclass
class ExchangePoint:
    after_stage: int
    reason: ExchangeReason


@dataclass
class QueryStage:
    """One stage of a distributed plan (reference planner.rs:95-118)."""

    stage_id: int
    fragment: object  # logical plan fragment or op descriptor
    partition_strategy: PartitionStrategy
    num_partitions: int
    dependencies: List[int] = field(default_factory=list)
    requires_shuffle: bool = False
    shuffle_keys: List[str] = field(default_factory=list)
    kind: str = "map"  # map | partial_agg | final_agg | join | merge


@dataclass
class DistributedPlan:
    stages: List[QueryStage] = field(default_factory=list)
    local_plan: Optional[lp.LogicalPlan] = None

    @property
    def is_local(self) -> bool:
        return self.local_plan is not None


class DistributedPlanner:
    def __init__(self, default_partitions: int = 4):
        self.default_partitions = default_partitions

    # ---- heuristics (planner.rs:145-163) --------------------------------
    def should_distribute(self, plan: lp.LogicalPlan) -> bool:
        if isinstance(plan, (lp.Aggregate, lp.Join)):
            return True
        if isinstance(plan, lp.TableScan):
            return True
        if isinstance(plan, (lp.Sort, lp.Limit)):
            # sort/limit alone don't justify a shuffle; recurse
            return any(self.should_distribute(c) for c in plan.children())
        if isinstance(plan, (lp.Filter, lp.Projection)):
            return any(self.should_distribute(c) for c in plan.children())
        return False

    # ---- stage creation (planner.rs:166-263) ----------------------------
    def plan(self, plan: lp.LogicalPlan) -> DistributedPlan:
        if not self.should_distribute(plan):
            return DistributedPlan(local_plan=plan)
        stages: List[QueryStage] = []
        try:
            self._create_stages(plan, stages)
        except _FallbackLocal:
            return DistributedPlan(local_plan=plan)
        return DistributedPlan(stages=stages)

    def _create_stages(self, plan: lp.LogicalPlan, stages: List[QueryStage]) -> int:
        """Returns the stage id producing `plan`'s output."""
        n = self.default_partitions
        if isinstance(plan, lp.TableScan):
            stages.append(QueryStage(
                len(stages), plan, PartitionStrategy.ROUND_ROBIN, n,
            ))
            return len(stages) - 1
        if isinstance(plan, (lp.Filter, lp.Projection, lp.Limit)):
            dep = self._create_stages(plan.input, stages)
            stages.append(QueryStage(
                len(stages), plan, PartitionStrategy.SINGLE, n,
                dependencies=[dep], kind="map",
            ))
            return len(stages) - 1
        if isinstance(plan, lp.Aggregate):
            dep = self._create_stages(plan.input, stages)
            from query_engine_tpu_torch.engine.partial_agg import DECOMPOSABLE

            if any(a.distinct or a.func not in DECOMPOSABLE
                   for a in plan.agg_exprs):
                # DISTINCT / statistical aggregates have no per-partition
                # partial: gather raw rows to one task and aggregate whole
                # (a partial COUNT(DISTINCT) summed across partitions
                # over-counts values present in several partitions)
                stages.append(QueryStage(
                    len(stages), plan, PartitionStrategy.SINGLE, 1,
                    dependencies=[dep], requires_shuffle=True,
                    kind="single_agg",
                ))
                return len(stages) - 1
            # partial per-partition
            stages.append(QueryStage(
                len(stages), plan, PartitionStrategy.SINGLE, n,
                dependencies=[dep], kind="partial_agg",
            ))
            partial = len(stages) - 1
            # final: shuffle partials by group key (single partition when
            # no group keys — the reference always uses 1, planner.rs:200-226)
            keys = [e.name() for e in plan.group_exprs]
            stages.append(QueryStage(
                len(stages), plan,
                PartitionStrategy.HASH if keys else PartitionStrategy.SINGLE,
                n if keys else 1,
                dependencies=[partial], requires_shuffle=True,
                shuffle_keys=keys, kind="final_agg",
            ))
            return len(stages) - 1
        if isinstance(plan, lp.Join):
            left = self._create_stages(plan.left, stages)
            right = self._create_stages(plan.right, stages)
            stages.append(QueryStage(
                len(stages), plan, PartitionStrategy.HASH, n,
                dependencies=[left, right], requires_shuffle=True,
                kind="join",
            ))
            return len(stages) - 1
        if isinstance(plan, lp.Sort):
            dep = self._create_stages(plan.input, stages)
            stages.append(QueryStage(
                len(stages), plan, PartitionStrategy.SINGLE, 1,
                dependencies=[dep], requires_shuffle=True, kind="merge",
            ))
            return len(stages) - 1
        raise _FallbackLocal()

    # ---- exchange identification (planner.rs:272-327) -------------------
    def identify_exchanges(self, stages: List[QueryStage]) -> List[ExchangePoint]:
        out = []
        for s in stages:
            if not s.requires_shuffle:
                continue
            reason = {
                "final_agg": ExchangeReason.AGGREGATION,
                "join": ExchangeReason.JOIN,
                "merge": ExchangeReason.SORT,
            }.get(s.kind, ExchangeReason.AGGREGATION)
            out.append(ExchangePoint(s.stage_id, reason))
        return out


class _FallbackLocal(Exception):
    pass
