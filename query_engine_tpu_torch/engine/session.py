"""Session: the user-facing engine entry point.

The counterpart of `query_engine_tpu.engine.session.Session` for the main
path: Parse -> Plan -> Optimize -> Lower -> Execute, the same chain as the
reference's only complete path (pgwire backend.rs:159-218
execute_query_sync). It takes SELECT statements (WITH RECURSIVE
included) and EXPLAIN [ANALYZE]; other statement kinds raise
NotImplementedError.

Every table the session registers and every tensor it makes lies on the
device given to `Session(device=...)`: the card ("cuda") unless the caller
asks for the CPU with `device="cpu"`.
"""

from __future__ import annotations

import copy
import time
from typing import Dict, List, Optional

import torch

from query_engine_tpu_torch.core.errors import PlanError, SchemaError
from query_engine_tpu_torch.core.schema import Schema
from query_engine_tpu_torch.core.udf import UdfRegistry
from query_engine_tpu_torch.columnar.batch import ColumnBatch
from query_engine_tpu_torch.engine.executor import QueryExecutor
from query_engine_tpu_torch.plan import logical as lp
from query_engine_tpu_torch.plan.lowering import Lowering, shared_subquery_ids
from query_engine_tpu_torch.plan.optimizer import Optimizer
from query_engine_tpu_torch.plan.planner import Planner
from query_engine_tpu_torch.sql import ast
from query_engine_tpu_torch.sql.parser import parse_sql
from query_engine_tpu_torch.storage.memory import MemoryDataSource
from query_engine_tpu_torch.utils.profiling import QueryTiming

MAX_RECURSION_ITERS = 1000  # parity: backend.rs recursive CTE cap


class Session:
    def __init__(self, device="cuda"):
        """device: the torch device every table and result lives on, the
        card ("cuda") by default; "cpu" runs the engine on the CPU. Nothing
        falls back to another device: without CUDA a Session on the card
        raises here."""
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"Session(device={str(device)!r}): CUDA is not available "
                "(torch.cuda.is_available() is False); pass device='cpu' to "
                "run on the CPU"
            )
        self.udfs = UdfRegistry()
        self.planner = Planner(self.udfs)
        self.optimizer = Optimizer()
        self.executor = QueryExecutor(self.device, self.udfs)
        self.sources: Dict[str, object] = {}
        # rounds and host dedup ms of the last WITH RECURSIVE query
        self.recursion: Dict[str, float] = {}
        # parse/plan/execute breakdown of the last statement
        self.last_timing = QueryTiming()

    # ---- registration --------------------------------------------------
    def register_csv(self, name: str, path: str, schema: Optional[Schema] = None):
        from query_engine_tpu_torch.storage.csv import CsvDataSource

        src = CsvDataSource(path, schema)
        self.sources[name.lower()] = src
        self.planner.register_table(name, src.schema())
        return src

    def register_parquet(self, name: str, path: str):
        from query_engine_tpu_torch.storage.parquet import ParquetDataSource

        src = ParquetDataSource(path)
        self.sources[name.lower()] = src
        self.planner.register_table(name, src.schema())
        return src

    def register_table(self, name: str, data) -> MemoryDataSource:
        """Register an in-memory table from a ColumnBatch or a dict of
        lists. Its planes move to the session's device here, once."""
        if isinstance(data, dict):
            data = ColumnBatch.from_pydict(data, device=self.device)
        data = data.to(self.device)
        src = MemoryDataSource(batch=data, name=name.lower())
        self.sources[name.lower()] = src
        self.planner.register_table(name, data.schema)
        return src

    def register_source(self, name: str, source) -> None:
        self.sources[name.lower()] = source
        self.planner.register_table(name, source.schema())

    def deregister_table(self, name: str) -> None:
        self.sources.pop(name.lower(), None)
        self.planner.deregister_table(name)

    # ---- SQL entry -----------------------------------------------------
    def sql(self, query: str) -> ColumnBatch:
        if query.lstrip().upper().startswith("EXPLAIN"):
            return self._exec_explain(query)
        self.last_timing = QueryTiming()
        t0 = time.perf_counter()
        stmt = parse_sql(query)
        self.last_timing.parse_ms = (time.perf_counter() - t0) * 1e3
        if not isinstance(stmt, (ast.Select, ast.WithSelect)):
            raise NotImplementedError(
                f"query_engine_tpu_torch does not execute "
                f"{type(stmt).__name__} statements yet"
            )
        return self._execute_query(stmt)

    def _exec_explain(self, query: str) -> ColumnBatch:
        """EXPLAIN [ANALYZE] <stmt> -> one text column "QUERY PLAN", like
        PostgreSQL. ANALYZE executes with the per-operator profiler on."""
        rest = query.lstrip()[len("EXPLAIN"):].lstrip()
        analyze = rest.upper().startswith("ANALYZE")
        if analyze:
            rest = rest[len("ANALYZE"):].lstrip()
        if not rest:
            raise PlanError("EXPLAIN requires a statement")
        lines = self.explain(rest).splitlines()
        if analyze:
            from query_engine_tpu_torch.utils.profiling import GLOBAL_PROFILER

            prev = GLOBAL_PROFILER.enabled
            GLOBAL_PROFILER.reset()
            GLOBAL_PROFILER.enabled = True
            try:
                result = self.sql(rest)
            finally:
                GLOBAL_PROFILER.enabled = prev
            lines += [
                "",
                f"rows: {result.num_rows}",
                f"timing: {self.last_timing}",
                "",
            ]
            lines += GLOBAL_PROFILER.report().splitlines()
        return ColumnBatch.from_pydict({"QUERY PLAN": lines},
                                       device=self.device)

    def explain(self, query: str) -> str:
        stmt = parse_sql(query)
        if isinstance(stmt, (ast.Select, ast.WithSelect)):
            return self._plan_query(stmt).pretty()
        return f"-- {type(stmt).__name__}"

    # ---- query path ----------------------------------------------------
    def _plan_query(self, stmt) -> lp.LogicalPlan:
        if isinstance(stmt, ast.WithSelect) and any(
            stmt.recursive and Planner._references_table(c.query, c.name)
            for c in stmt.ctes
        ):
            raise PlanError("recursive CTE must go through _execute_query")
        plan = self.planner.create_logical_plan(stmt)
        return self.optimizer.optimize(plan)

    def _execute_query(self, stmt) -> ColumnBatch:
        if isinstance(stmt, ast.WithSelect) and stmt.recursive:
            rec = [c for c in stmt.ctes
                   if Planner._references_table(c.query, c.name)]
            if rec:
                return self._execute_recursive_cte(stmt)
        t0 = time.perf_counter()
        plan = self._plan_query(stmt)
        pplan = Lowering(
            self.sources, shared_cte_ids=shared_subquery_ids(plan)
        ).lower(plan)
        t1 = time.perf_counter()
        self.last_timing.plan_ms += (t1 - t0) * 1e3
        # shared WITH batches and correlated key matches live for one query
        # (their keys are id()s of this query's plan nodes and batches)
        self._clear_query_memos()
        try:
            out = self.executor.execute(pplan)
        finally:
            self._clear_query_memos()
        self.last_timing.execute_ms += (time.perf_counter() - t1) * 1e3
        return out

    def _clear_query_memos(self) -> None:
        self.executor._cte_memo.clear()
        self.executor.evaluator._corr_match_memo.clear()

    def _execute_recursive_cte(self, stmt: ast.WithSelect) -> ColumnBatch:
        """Fixed-point recursive CTE evaluation (backend.rs:221-369):
        iterate `base UNION [ALL] step`, registering the last round's new
        rows (the frontier) as a temporary table under the CTE's name each
        round, until a round adds no rows (or MAX_RECURSION_ITERS rounds).
        UNION keeps only rows not seen before (a set difference on the
        host); UNION ALL stops on an empty frontier. Every frontier stays on
        the session's device. `recursion` holds the last run's rounds and
        host milliseconds of the UNION's dedup."""
        if len(stmt.ctes) != 1:
            raise PlanError("recursive WITH supports exactly one CTE")
        cte = stmt.ctes[0]
        sel = cte.query
        if sel.union_clause is None:
            raise PlanError("recursive CTE requires base UNION step shape")
        base_sel = _strip_union(sel)
        step_sel = sel.union_clause.select
        dedup = sel.union_clause.set_op is ast.SetOperation.UNION

        tmp_name = cte.name.lower()
        if tmp_name in self.sources:
            raise PlanError(
                f"recursive CTE name '{cte.name}' shadows an existing table"
            )
        self.recursion = {"iterations": 0, "dedup_ms": 0.0}
        try:
            acc = self._execute_query(ast.Select(base_sel))
            if cte.columns:
                acc = _rename_batch(acc, list(cte.columns))
            frontier = acc
            for _ in range(MAX_RECURSION_ITERS):
                if frontier.num_rows == 0:
                    break
                self.recursion["iterations"] += 1
                self.register_table(tmp_name, frontier)
                try:
                    new_rows = self._execute_query(ast.Select(step_sel))
                finally:
                    self.deregister_table(tmp_name)
                if cte.columns:
                    new_rows = _rename_batch(new_rows, list(cte.columns))
                if dedup:
                    t0 = time.perf_counter()
                    seen = set(acc.to_pylist())
                    fresh = [r for r in new_rows.to_pylist() if r not in seen]
                    self.recursion["dedup_ms"] += \
                        (time.perf_counter() - t0) * 1e3
                    if not fresh:
                        break
                    cols = {f.name: [r[i] for r in fresh]
                            for i, f in enumerate(acc.schema)}
                    new_rows = ColumnBatch.from_pydict(cols, acc.schema,
                                                       device=self.device)
                elif new_rows.num_rows == 0:
                    break
                acc = ColumnBatch.concat([acc, new_rows])
                frontier = new_rows
            # the outer SELECT over the final CTE result
            self.register_table(tmp_name, acc)
            try:
                return self._execute_query(ast.Select(stmt.select))
            finally:
                self.deregister_table(tmp_name)
        finally:
            if tmp_name in self.sources:
                self.deregister_table(tmp_name)


def _strip_union(sel: ast.SelectStatement) -> ast.SelectStatement:
    base = copy.copy(sel)
    base.union_clause = None
    return base


def _rename_batch(batch: ColumnBatch, names: List[str]) -> ColumnBatch:
    if len(names) != len(batch.schema):
        raise SchemaError("CTE column list arity mismatch")
    schema = Schema([f.with_name(n) for f, n in zip(batch.schema, names)])
    return ColumnBatch(schema, batch.columns, batch.num_rows)
