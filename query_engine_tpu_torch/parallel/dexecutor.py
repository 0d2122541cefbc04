"""Distributed executor: runs the stage DAG with real data movement.

Parity surface: reference crates/query-distributed/src/executor.rs:18-302 —
per-query QueryExecution tracking, stage walk in dependency order, Exchange
of dependency outputs, task creation + scheduling, merge on shuffle, cancel/
status/cleanup APIs. The reference "simulates" stage execution by echoing
input partitions (executor.rs:242-251); here each task really executes its
fragment on a worker, with FaultManager retry on failure and stage-boundary
checkpoints.

In-process parallelism: a thread pool drives per-partition tasks on the
registered workers, each with its own QueryExecutor on the coordinator's
device (the card by default). The workers' fragments run at once on the
one card; their CUDA graph captures take turns (engine/pipeline.py's
process-wide capture lock, in thread-local mode). With `mesh=` a plan
that lowers runs instead as one SPMD program over the device mesh
(parallel/mesh_pipeline.py), the execution model the stage walk only
coordinates.
"""

from __future__ import annotations

import enum
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from query_engine_tpu_torch.core.errors import DistributedError
from query_engine_tpu_torch.columnar.batch import ColumnBatch
from query_engine_tpu_torch.engine.executor import QueryExecutor, _Materialized
from query_engine_tpu_torch.plan import logical as lp
from query_engine_tpu_torch.plan import physical as pp
from query_engine_tpu_torch.plan.lowering import Lowering
from query_engine_tpu_torch.parallel.coordinator import Coordinator
from query_engine_tpu_torch.parallel.dplanner import DistributedPlanner, QueryStage
from query_engine_tpu_torch.parallel.exchange import Exchange
from query_engine_tpu_torch.parallel.fault import FaultManager, TaskRecoveryAction
from query_engine_tpu_torch.parallel.partition import Partitioner
from query_engine_tpu_torch.parallel.scheduler import TaskScheduler
from query_engine_tpu_torch.parallel.types import (
    QueryTask, TaskStatus, new_id,
)


@dataclass
class ExecutorConfig:
    """reference executor.rs:40-49 defaults."""

    max_concurrent_queries: int = 10
    query_timeout_secs: float = 300.0
    batch_size: int = 8192


class QueryState(enum.Enum):
    RUNNING = "Running"
    COMPLETED = "Completed"
    FAILED = "Failed"
    CANCELLED = "Cancelled"


@dataclass
class QueryExecution:
    query_id: str
    state: QueryState = QueryState.RUNNING
    started_at: float = field(default_factory=time.time)
    completed_stages: List[int] = field(default_factory=list)
    error: Optional[str] = None


@dataclass
class ExecutionStats:
    queries_executed: int = 0
    tasks_executed: int = 0
    task_failures: int = 0
    rows_shuffled: int = 0


class DistributedExecutor:
    def __init__(self, coordinator: Coordinator,
                 config: Optional[ExecutorConfig] = None,
                 fault: Optional[FaultManager] = None,
                 mesh=None):
        """The stage walk over `coordinator`'s workers, on its device.
        mesh: an optional `parallel.mesh.Mesh`; a plan that lowers runs as
        one program over it (`_try_mesh`), others take the stage walk."""
        self.mesh = mesh
        self._mesh_pipeline = None
        self.coordinator = coordinator
        self.device = coordinator.device
        self.config = config or ExecutorConfig()
        self.planner = DistributedPlanner(
            coordinator.config.default_partitions
        )
        self.scheduler = TaskScheduler()
        self.fault = fault or FaultManager()
        self.stats = ExecutionStats()
        # the last query's stages: (stage id, kind, host ms)
        self.last_stages: List[tuple] = []
        # scans and plans the planner keeps local run here
        self._local = QueryExecutor(self.device)
        self._queries: Dict[str, QueryExecution] = {}
        self._cancelled: set = set()
        self._lock = threading.RLock()

    # ---- public ---------------------------------------------------------
    def execute(self, plan: lp.LogicalPlan, sources: Dict[str, object]) -> ColumnBatch:
        query_id = new_id()
        with self._lock:
            running = sum(
                1 for q in self._queries.values()
                if q.state is QueryState.RUNNING
            )
            if running >= self.config.max_concurrent_queries:
                raise DistributedError("too many concurrent queries")
            self._queries[query_id] = QueryExecution(query_id)
        try:
            result = self._execute_inner(query_id, plan, sources)
            self._queries[query_id].state = QueryState.COMPLETED
            self.stats.queries_executed += 1
            return result
        except Exception as e:
            q = self._queries[query_id]
            q.state = (
                QueryState.CANCELLED if query_id in self._cancelled
                else QueryState.FAILED
            )
            q.error = str(e)
            raise
        finally:
            self.fault.clear_checkpoint(query_id)

    def cancel(self, query_id: str) -> None:
        with self._lock:
            self._cancelled.add(query_id)

    def status(self, query_id: str) -> Optional[QueryExecution]:
        return self._queries.get(query_id)

    def cleanup(self, max_age_secs: float = 3600.0) -> int:
        now = time.time()
        with self._lock:
            done = [
                q for q, e in self._queries.items()
                if e.state is not QueryState.RUNNING
                and now - e.started_at > max_age_secs
            ]
            for q in done:
                del self._queries[q]
            return len(done)

    # ---- stage walk -----------------------------------------------------
    def _execute_inner(self, query_id, plan, sources) -> ColumnBatch:
        self.last_stages = []
        if self.mesh is not None:
            out = self._try_mesh(plan, sources)
            if out is not None:
                return out
        dplan = self.planner.plan(plan)
        if dplan.is_local:
            pplan = Lowering(sources).lower(dplan.local_plan)
            return self._local.execute(pplan)

        return self._stage_walk(query_id, dplan, Lowering(sources))

    def _try_mesh(self, plan, sources) -> Optional[ColumnBatch]:
        """Route through the SPMD shard_map path (one program, all_to_all
        exchanges), on an executor of the coordinator's device."""
        from query_engine_tpu_torch.parallel.mesh_pipeline import MeshPipeline

        if self._mesh_pipeline is None:
            self._mesh_pipeline = MeshPipeline(QueryExecutor(self.device),
                                               self.mesh)
        pplan = Lowering(sources).lower(plan)
        # per-query memos (keyed by id()s of this query's plan nodes)
        ex = self._mesh_pipeline.executor
        ex._cte_memo.clear()
        ex.evaluator._corr_match_memo.clear()
        try:
            return self._mesh_pipeline.try_execute(pplan)
        finally:
            ex._cte_memo.clear()
            ex.evaluator._corr_match_memo.clear()

    def _stage_walk(self, query_id, dplan, lowering) -> ColumnBatch:
        outputs: Dict[int, List[ColumnBatch]] = {}
        execution = self._queries[query_id]
        for stage in dplan.stages:
            if query_id in self._cancelled:
                raise DistributedError("query cancelled")
            if time.time() - execution.started_at > self.config.query_timeout_secs:
                raise DistributedError("query timeout")
            t0 = time.perf_counter()
            outputs[stage.stage_id] = self._execute_stage(
                query_id, stage, outputs, lowering
            )
            self.last_stages.append(
                (stage.stage_id, stage.kind,
                 (time.perf_counter() - t0) * 1e3))
            execution.completed_stages.append(stage.stage_id)
            # stage-boundary checkpoint; intermediates spill to disk when
            # FaultConfig.checkpoint_dir is set (SURVEY §5)
            self.fault.checkpoint_stage(
                query_id, stage.stage_id,
                outputs[stage.stage_id]
                if self.fault.config.checkpoint_dir else None,
            )
        final = outputs[dplan.stages[-1].stage_id]
        return ColumnBatch.concat(final) if len(final) > 1 else final[0]

    def _execute_stage(
        self, query_id: str, stage: QueryStage,
        outputs: Dict[int, List[ColumnBatch]], lowering: Lowering,
    ) -> List[ColumnBatch]:
        frag = stage.fragment
        n = stage.num_partitions

        if stage.kind == "map" or isinstance(frag, lp.TableScan):
            if isinstance(frag, lp.TableScan):
                pplan = lowering.lower(frag)
                batch = self._local.execute(pplan)
                parts = Partitioner.round_robin(n).partition(batch)
                return parts
            deps = outputs[stage.dependencies[0]]
            tasks = [
                (p, self._fragment_runner(frag, [b], lowering))
                for p, b in enumerate(deps)
            ]
            return self._run_tasks(query_id, stage, tasks)

        if stage.kind == "single_agg":
            # non-decomposable aggregates (DISTINCT, VARIANCE/STDDEV):
            # gather raw rows and aggregate whole in one task
            from query_engine_tpu_torch.plan.lowering import build_hash_aggregate

            deps = outputs[stage.dependencies[0]]
            agg: lp.Aggregate = frag
            merged = ColumnBatch.concat(deps)
            self.stats.rows_shuffled += merged.num_rows
            sagg = build_hash_aggregate(
                _Materialized(merged),
                [lowering._lower_expr(e) for e in agg.group_exprs],
                [lowering._lower_expr(e) for e in agg.agg_exprs],
            )
            return self._run_tasks(query_id, stage, [(0, sagg)])

        if stage.kind == "partial_agg":
            deps = outputs[stage.dependencies[0]]
            agg: lp.Aggregate = frag
            tasks = []
            for p, b in enumerate(deps):
                pagg = pp.PHashAggregate(
                    _Materialized(b),
                    [lowering._lower_expr(e) for e in agg.group_exprs],
                    [lowering._lower_expr(e) for e in agg.agg_exprs],
                    mode="partial",
                )
                tasks.append((p, pagg))
            return self._run_tasks(query_id, stage, tasks)

        if stage.kind == "final_agg":
            deps = outputs[stage.dependencies[0]]
            agg: lp.Aggregate = frag
            g = len(agg.group_exprs)
            if g:
                key_names = [deps[0].schema.field(i).name for i in range(g)]
                shuffled = Exchange.hash(n, key_names).execute(deps)
                self.stats.rows_shuffled += sum(b.num_rows for b in deps)
            else:
                shuffled = [deps]
            tasks = []
            for p, batches in enumerate(shuffled):
                if not batches:
                    continue
                merged = ColumnBatch.concat(batches)
                schema = merged.schema
                group_refs = [
                    lp.ColumnRef(i, schema.field(i).name,
                                 schema.field(i).data_type,
                                 schema.field(i).nullable)
                    for i in range(g)
                ]
                fagg = pp.PHashAggregate(
                    _Materialized(merged), group_refs,
                    [lowering._lower_expr(e) for e in agg.agg_exprs],
                    mode="final",
                )
                tasks.append((p, fagg))
            return self._run_tasks(query_id, stage, tasks)

        if stage.kind == "join":
            join: lp.Join = frag
            left_parts = outputs[stage.dependencies[0]]
            right_parts = outputs[stage.dependencies[1]]
            # extract equi-key pairs via the lowering helpers
            n_left = len(join.left.schema())
            conjuncts = Lowering._split_and(lowering._lower_expr(join.on)) if join.on is not None else []
            lkeys, rkeys = [], []
            for c in conjuncts:
                pair = Lowering._as_equi_pair(c, n_left)
                if pair is not None:
                    lkeys.append(pair[0])
                    rkeys.append(pair[1])
            if not lkeys or join.join_type is not lp.JoinType.INNER:
                # co-partitioning only correct for inner equi joins here;
                # otherwise gather to one partition
                lmerged = ColumnBatch.concat(left_parts)
                rmerged = ColumnBatch.concat(right_parts)
                shuffled = [(0, lmerged, rmerged)]
            else:
                lnames = [self._key_name(k, left_parts[0]) for k in lkeys]
                rnames = [self._key_name(k, right_parts[0]) for k in rkeys]
                lsh = Exchange.hash(n, lnames).execute(left_parts)
                rsh = Exchange.hash(n, rnames).execute(right_parts)
                self.stats.rows_shuffled += sum(
                    b.num_rows for b in left_parts + right_parts
                )
                shuffled = []
                for p in range(n):
                    lb = (ColumnBatch.concat(lsh[p]) if lsh[p]
                          else ColumnBatch.empty(left_parts[0].schema,
                                                 self.device))
                    rb = (ColumnBatch.concat(rsh[p]) if rsh[p]
                          else ColumnBatch.empty(right_parts[0].schema,
                                                 self.device))
                    shuffled.append((p, lb, rb))
            tasks = []
            for p, lb, rb in shuffled:
                pj = pp.PHashJoin(
                    _Materialized(lb), _Materialized(rb), join.join_type,
                    list(zip(lkeys, rkeys)), None, join.schema(),
                )
                tasks.append((p, pj))
            return self._run_tasks(query_id, stage, tasks)

        if stage.kind == "merge":
            sort: lp.Sort = frag
            deps = outputs[stage.dependencies[0]]
            merged = ColumnBatch.concat(deps)
            psort = pp.PSort(
                _Materialized(merged),
                [
                    lp.SortKey(lowering._lower_expr(k.expr), k.asc, k.nulls_first)
                    for k in sort.keys
                ],
            )
            return self._run_tasks(query_id, stage, [(0, psort)])

        raise DistributedError(f"unknown stage kind {stage.kind}")

    @staticmethod
    def _key_name(expr: lp.LogicalExpr, batch: ColumnBatch) -> str:
        if isinstance(expr, lp.ColumnRef):
            return batch.schema.field(expr.index).name
        raise DistributedError("shuffle keys must be plain columns")

    def _fragment_runner(self, frag, input_batches, lowering):
        """Lower a single-input fragment over a materialized partition."""
        batch = (
            input_batches[0] if len(input_batches) == 1
            else ColumnBatch.concat(input_batches)
        )
        if isinstance(frag, lp.Filter):
            return pp.PFilter(_Materialized(batch),
                              lowering._lower_expr(frag.predicate))
        if isinstance(frag, lp.Projection):
            return pp.PProjection(
                _Materialized(batch),
                [lowering._lower_expr(e) for e in frag.exprs],
            )
        if isinstance(frag, lp.Limit):
            return pp.PLimit(_Materialized(batch), frag.skip, frag.fetch)
        raise DistributedError(f"cannot run fragment {type(frag).__name__}")

    # ---- task running with fault handling -------------------------------
    def _run_tasks(self, query_id: str, stage: QueryStage, tasks) -> List[ColumnBatch]:
        workers = self.coordinator.active_workers()
        if not workers:
            raise DistributedError("no active workers")
        results: Dict[int, ColumnBatch] = {}

        def run_one(partition: int, pplan) -> ColumnBatch:
            task = QueryTask.new(query_id, stage.stage_id, partition, pplan)
            # the scheduler's queue is shared by the pool's threads: each
            # thread takes the task it queued, so partition p's result is
            # partition p's (the reference's threads may swap tasks)
            with self._lock:
                self.scheduler.submit(task)
                t = self.scheduler.get_next_task()
            while True:
                if t is None:
                    raise DistributedError("scheduler lost task")
                with self._lock:  # the least-loaded worker, then claim it
                    info = self.scheduler.choose_worker(
                        self.coordinator.active_workers()
                    )
                    if info is None:
                        raise DistributedError("no worker with capacity")
                    info.active_tasks += 1
                worker = self.coordinator.runner(info.worker_id)
                try:
                    result = worker.execute_task(t)
                finally:
                    with self._lock:
                        info.active_tasks -= 1
                        self.stats.tasks_executed += 1
                if result.status is TaskStatus.COMPLETED:
                    self.scheduler.complete_task(result)
                    self.fault.handle_task_success(t.task_id)
                    self.fault.handle_worker_success(info.worker_id)
                    return result.result
                with self._lock:
                    self.stats.task_failures += 1
                action, delay = self.fault.handle_task_failure(
                    t.task_id, result.error or ""
                )
                wa = self.fault.handle_worker_failure(info.worker_id)
                if wa.name != "NONE":
                    self.coordinator.mark_unhealthy(info.worker_id)
                if action is TaskRecoveryAction.RETRY:
                    time.sleep(min(delay, 0.05))
                    with self._lock:
                        self.scheduler.reschedule_failed(t.task_id)
                        t = self.scheduler.get_next_task()
                    continue
                raise DistributedError(
                    f"task failed permanently: {result.error}"
                )

        max_workers = max(len(workers), 1)
        with ThreadPoolExecutor(max_workers=max_workers) as pool:
            futures = {
                pool.submit(run_one, p, pplan): p for p, pplan in tasks
            }
            for fut, p in futures.items():
                results[p] = fut.result()
        return [results[p] for p in sorted(results)]
