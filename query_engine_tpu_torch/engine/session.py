"""Session: the user-facing engine entry point.

The counterpart of `query_engine_tpu.engine.session.Session`: Parse ->
Plan -> Optimize -> Lower -> Execute, the same chain as the reference's
only complete path (pgwire backend.rs:159-218 execute_query_sync), for
every statement the JAX Session takes: SELECT (WITH RECURSIVE included),
EXPLAIN [ANALYZE], CREATE/DROP TABLE (SERIAL columns), TRUNCATE, ALTER
TABLE, CREATE TABLE AS, CREATE [OR REPLACE]/DROP VIEW, INSERT (VALUES or a
query, ON CONFLICT, RETURNING), UPDATE [FROM], DELETE [USING], CREATE/DROP
INDEX, and BEGIN/COMMIT/ROLLBACK/SAVEPOINT/RELEASE; `sql(query, params)`
binds $n parameters, `sql_script` runs a script, and
`Session(enable_cache=True)` keeps a result cache that every DDL and DML
statement clears.

Every table the session registers and every tensor it makes lies on the
device given to `Session(device=...)`: the card ("cuda") unless the caller
asks for the CPU with `device="cpu"`. DML does its row work there
(`engine/dml.py`): the host reads counts, the rows a RETURNING returns and
what ON CONFLICT's key match and an index build need. A stored batch is
replaced, never written in place, so BEGIN's snapshot holds batches by
reference. `Session(mesh=...)` and `QE_MESH_DEVICES=N` run each query
that lowers as one SPMD program over a device mesh
(parallel/mesh_pipeline.py); plans without a distributed lowering fall back
to the single-device engine. With `QE_MESH_DEVICES=N` a Session takes the
first N cards where there are N, else N virtual shards of its own card
(`make_mesh([device] * N)`), and N CPU shards on the CPU: never another
device than its own kind.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from query_engine_tpu_torch.core.errors import (
    ExecutionError, PlanError, SchemaError,
)
from query_engine_tpu_torch.core.schema import Field, Schema
from query_engine_tpu_torch.core.types import DataType
from query_engine_tpu_torch.core.udf import UdfRegistry
from query_engine_tpu_torch.columnar.batch import Column, ColumnBatch
from query_engine_tpu_torch.columnar.dictionary import Dictionary
from query_engine_tpu_torch.engine import dml
from query_engine_tpu_torch.engine.executor import QueryExecutor, ensure_device
from query_engine_tpu_torch.engine.expr_eval import Val, _bcast, _torch_dtype
from query_engine_tpu_torch.plan import logical as lp
from query_engine_tpu_torch.plan.lowering import Lowering, shared_subquery_ids
from query_engine_tpu_torch.plan.optimizer import Optimizer
from query_engine_tpu_torch.plan.planner import Planner, Resolver, prefix_schema
from query_engine_tpu_torch.sql import ast
from query_engine_tpu_torch.sql.parser import parse_many, parse_sql
from query_engine_tpu_torch.storage.memory import MemoryDataSource
from query_engine_tpu_torch.utils.profiling import QueryTiming, span

MAX_RECURSION_ITERS = 1000  # parity: backend.rs recursive CTE cap


def require_device(device, owner: str) -> torch.device:
    """torch.device(device), or RuntimeError for the card where CUDA is not
    available: nothing falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{owner}(device={str(device)!r}): CUDA is not available "
            "(torch.cuda.is_available() is False); pass device='cpu' to "
            "run on the CPU"
        )
    return dev


def env_mesh(device: torch.device):
    """The mesh `QE_MESH_DEVICES=N` (N > 1) asks for, else None: the first
    N cards when there are N, else N virtual shards of `device`'s card; N
    shards of the CPU for a CPU device."""
    import os

    n = int(os.environ.get("QE_MESH_DEVICES", "0") or 0)
    if n <= 1:
        return None
    from query_engine_tpu_torch.parallel.mesh import make_mesh

    if device.type == "cuda" and torch.cuda.device_count() >= n:
        return make_mesh([torch.device("cuda", i) for i in range(n)])
    return make_mesh([device] * n)


class Session:
    def __init__(self, device="cuda", enable_cache: bool = False, mesh=None):
        """device: the torch device every table and result lives on, the
        card ("cuda") by default; "cpu" runs the engine on the CPU. Nothing
        falls back to another device: without CUDA a Session on the card
        raises here. enable_cache: keep SELECT results by SQL text
        (`cache/`), cleared by every DDL and DML statement. mesh: an
        optional `parallel.mesh.Mesh` of shards of the Session's device
        kind — queries then execute SPMD over the mesh as ONE program per
        query (parallel/mesh_pipeline.py); without one, `QE_MESH_DEVICES=N`
        (N > 1) makes it (see the module docstring)."""
        self.device = require_device(device, "Session")
        self.udfs = UdfRegistry()
        self.planner = Planner(self.udfs)
        self.sources: Dict[str, object] = {}
        # the optimizer's join order reads the tables' row counts
        self.optimizer = Optimizer(
            table_rows=functools.partial(_table_rows, self.sources))
        self.executor = QueryExecutor(self.device, self.udfs)
        self.mesh_pipeline = None
        if mesh is None:
            mesh = env_mesh(self.device)
        if mesh is not None:
            from query_engine_tpu_torch.parallel.mesh_pipeline import (
                MeshPipeline,
            )

            if mesh.home.type != self.device.type:
                raise ValueError(
                    f"Session(device={str(self.device)!r}) over a mesh on "
                    f"{mesh.home}: the mesh's shards must be of the "
                    "Session's device kind")
            self.mesh_pipeline = MeshPipeline(self.executor, mesh)
        # rounds and host dedup ms of the last WITH RECURSIVE query
        self.recursion: Dict[str, float] = {}
        # parse/plan/execute breakdown of the last statement
        self.last_timing = QueryTiming()
        self._cache = None
        if enable_cache:
            from query_engine_tpu_torch.cache.cache import QueryCache
            from query_engine_tpu_torch.cache.config import CacheConfig

            self._cache = QueryCache(CacheConfig())
        # transaction state: snapshot taken at BEGIN (None = autocommit),
        # savepoint stack, and PG's aborted-until-ROLLBACK flag
        self._txn = None
        self._txn_failed = False
        self._savepoints: List[tuple] = []
        # A Session serves one thread at a time: every front end over it
        # (the pgwire and Flight servers, a StreamingQuery) holds this lock
        # around its calls and its reads of a result's planes
        self.lock = threading.RLock()

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

    def tables(self) -> List[str]:
        return sorted(self.sources)

    def views(self) -> List[str]:
        return sorted(self.planner.views)

    def table_schema(self, name: str) -> Schema:
        key = name.lower()
        if key not in self.sources and key in self.planner.views:
            return self.planner.views[key].schema()
        return self.sources[key].schema()

    # ---- SQL entry -----------------------------------------------------
    def sql(self, query: str, params: Optional[list] = None) -> ColumnBatch:
        """One statement; `params` binds $1, $2, ... to Python values."""
        if query.lstrip().upper().startswith("EXPLAIN"):
            return self._exec_explain(query)
        with span("sql"):
            self.last_timing = QueryTiming()
            with span("parse") as parsing:
                stmt = parse_sql(query)
            self.last_timing.parse_ms = parsing.ms
            if params:
                stmt = _bind_params(stmt, params)
                # the result cache's key must tell parameter values apart
                return self.execute_statement(
                    stmt, sql_text=query + "\x00" + repr(params))
            return self.execute_statement(stmt, sql_text=query)

    def sql_script(self, script: str) -> List[ColumnBatch]:
        """Execute a semicolon-separated script; returns one result per
        statement."""
        return [self.execute_statement(s) for s in parse_many(script)]

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
            st0 = dict(self.executor.pipeline.stats)
            try:
                result = self.sql(rest)
            finally:
                GLOBAL_PROFILER.enabled = prev
            d = {k: v - st0[k]
                 for k, v in self.executor.pipeline.stats.items()}
            lines += [
                "",
                f"rows: {result.num_rows}",
                f"timing: {self.last_timing}",
                f"pipeline: captures={d['captures']} (released="
                f"{d['recaptures_released']}, moved={d['recaptures_moved']})"
                f" capture_ms={d['capture_ms']:.2f} room_ms="
                f"{d['room_ms']:.2f} sync_ms={d['sync_ms']:.2f} leaf_ms="
                f"{d['leaf_ms']:.2f} like_ms={d['like_ms']:.2f} "
                f"like_values={d['like_values']} "
                f"cross_joins={d['cross_joins']}",
            ]
            if self.mesh_pipeline is not None:
                st = self.mesh_pipeline.stats
                lines.append(
                    f"mesh: devices={self.mesh_pipeline.n} "
                    f"compiles={st['compiles']} hits={st['hits']} "
                    f"fallbacks={st['fallbacks']} "
                    f"exchanges={st['exchanges']} "
                    f"overflow_retries={st['overflow_retries']}"
                )
            lines.append("")
            lines += GLOBAL_PROFILER.report().splitlines()
        return ColumnBatch.from_pydict({"QUERY PLAN": lines},
                                       device=self.device)

    def explain(self, query: str) -> str:
        stmt = parse_sql(query)
        if isinstance(stmt, (ast.Select, ast.WithSelect)):
            return self._plan_query(stmt).pretty()
        return f"-- {type(stmt).__name__}"

    def execute_statement(self, stmt: ast.Statement,
                          sql_text: str = "") -> ColumnBatch:
        if isinstance(stmt, ast.Transaction):
            return self._exec_transaction(stmt)
        if self._txn_failed:
            raise ExecutionError(
                "current transaction is aborted, commands ignored until "
                "end of transaction block")
        if self._txn is None:
            return self._execute_statement_inner(stmt, sql_text)
        try:
            return self._execute_statement_inner(stmt, sql_text)
        except Exception:
            # PG semantics: any error inside an explicit transaction aborts
            # it; only ROLLBACK [TO SAVEPOINT] / COMMIT are accepted after.
            self._txn_failed = True
            raise

    # ---- transactions ----------------------------------------------------
    # Snapshot-based: BEGIN captures the registries plus every memory
    # table's (immutable) batch reference; DML replaces batches rather
    # than writing them, so a snapshot is O(tables), not O(rows), and
    # ROLLBACK is a pointer swap + index rebuild for tables that changed.
    def in_transaction(self) -> bool:
        return self._txn is not None

    def transaction_failed(self) -> bool:
        return self._txn_failed

    def begin(self) -> None:
        if self._txn is not None:
            return  # PG: WARNING + no-op on nested BEGIN
        self._txn = self._snapshot()
        self._txn_failed = False
        self._savepoints = []

    def commit(self) -> str:
        """Returns the PG command tag: COMMIT, or ROLLBACK if the
        transaction had failed (PG commits an aborted txn as a rollback)."""
        if self._txn is None:
            return "COMMIT"
        failed = self._txn_failed
        if failed:
            self._restore(self._txn)
        self._txn = None
        self._txn_failed = False
        self._savepoints = []
        return "ROLLBACK" if failed else "COMMIT"

    def rollback(self) -> None:
        if self._txn is None:
            return  # PG: WARNING + no-op outside a transaction
        self._restore(self._txn)
        self._txn = None
        self._txn_failed = False
        self._savepoints = []

    def savepoint(self, name: str) -> None:
        if self._txn is None:
            raise ExecutionError("SAVEPOINT can only be used in transaction blocks")
        self._savepoints.append((name.lower(), self._snapshot()))

    def rollback_to(self, name: str) -> None:
        if self._txn is None:
            raise ExecutionError("ROLLBACK TO can only be used in transaction blocks")
        i = self._find_savepoint(name)
        _, snap = self._savepoints[i]
        self._restore(snap)
        # PG keeps the savepoint itself alive after ROLLBACK TO
        del self._savepoints[i + 1:]
        self._txn_failed = False

    def release(self, name: str) -> None:
        if self._txn is None:
            raise ExecutionError("RELEASE can only be used in transaction blocks")
        i = self._find_savepoint(name)
        del self._savepoints[i:]

    def _find_savepoint(self, name: str) -> int:
        key = name.lower()
        for i in range(len(self._savepoints) - 1, -1, -1):
            if self._savepoints[i][0] == key:
                return i
        raise ExecutionError(f"savepoint \"{name}\" does not exist")

    def _exec_transaction(self, stmt: ast.Transaction) -> ColumnBatch:
        if self._txn_failed and stmt.kind not in (
                "commit", "rollback", "rollback_to"):
            raise ExecutionError(
                "current transaction is aborted, commands ignored until "
                "end of transaction block")
        if stmt.kind == "begin":
            self.begin()
            return self._status("BEGIN")
        if stmt.kind == "commit":
            return self._status(self.commit())
        if stmt.kind == "rollback":
            self.rollback()
            return self._status("ROLLBACK")
        if stmt.kind == "rollback_to":
            self.rollback_to(stmt.name)
            return self._status("ROLLBACK")
        if stmt.kind == "savepoint":
            self.savepoint(stmt.name)
            return self._status("SAVEPOINT")
        if stmt.kind == "release":
            self.release(stmt.name)
            return self._status("RELEASE")
        raise ExecutionError(f"unknown transaction statement {stmt.kind!r}")

    def _snapshot(self) -> dict:
        mem = {}
        for name, src in self.sources.items():
            if isinstance(src, MemoryDataSource):
                mem[name] = (
                    src, src._batch, dict(src.serials), src.name,
                    dict(src.indexes._meta),
                )
        return {
            "sources": dict(self.sources),
            "tables": dict(self.planner.tables),
            "views": dict(self.planner.views),
            "mem": mem,
        }

    def _restore(self, snap: dict) -> None:
        gone = [s for k, s in self.sources.items()
                if snap["sources"].get(k) is not s]
        self.sources = dict(snap["sources"])
        self.planner.tables = dict(snap["tables"])
        self.planner.views = dict(snap["views"])
        changed = []
        for _key, (src, batch, serials, name, idx_meta) in snap["mem"].items():
            if src._batch is not batch:
                changed.append(src)
            src._batch = batch
            src.serials = dict(serials)
            src.name = name
            for idx in list(src.indexes._indexes):
                if idx not in idx_meta:
                    src.indexes.drop_index(idx)  # created inside the txn
            for idx, meta in idx_meta.items():
                if not src.indexes.has_index(idx):  # dropped inside the txn
                    src.create_index(idx, meta.columns, meta.index_type,
                                     meta.unique)
            if src in changed:
                src.rebuild_indexes()
        self._tables_changed(*(changed + gone))

    def _execute_statement_inner(self, stmt: ast.Statement,
                                 sql_text: str = "") -> ColumnBatch:
        if isinstance(stmt, (ast.Select, ast.WithSelect)):
            if self._cache is not None and sql_text:
                hit = self._cache.get_sql(sql_text)
                if hit is not None:
                    return hit
            result = self._execute_query(stmt)
            if self._cache is not None and sql_text:
                self._cache.put_sql(sql_text, result)
            return result
        if isinstance(stmt, ast.CreateTable):
            return self._exec_create_table(stmt)
        if isinstance(stmt, ast.CreateTableAs):
            return self._exec_create_table_as(stmt)
        if isinstance(stmt, ast.CreateView):
            return self._exec_create_view(stmt)
        if isinstance(stmt, ast.DropView):
            return self._exec_drop_view(stmt)
        if isinstance(stmt, ast.DropTable):
            return self._exec_drop_table(stmt)
        if isinstance(stmt, ast.Truncate):
            src = self._require_memory_table(stmt.name)
            src.replace(ColumnBatch.empty(src.schema(), device=self.device))
            self._tables_changed(src)
            return self._status("TRUNCATE TABLE")
        if isinstance(stmt, ast.AlterTable):
            return self._exec_alter_table(stmt)
        if isinstance(stmt, ast.Insert):
            return self._exec_insert(stmt)
        if isinstance(stmt, ast.Update):
            return self._exec_update(stmt)
        if isinstance(stmt, ast.Delete):
            return self._exec_delete(stmt)
        if isinstance(stmt, ast.CreateIndex):
            return self._exec_create_index(stmt)
        if isinstance(stmt, ast.DropIndex):
            return self._exec_drop_index(stmt)
        raise ExecutionError(f"unsupported statement {type(stmt).__name__}")

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
        with span("plan") as planning:
            plan = self._plan_query(stmt)
            pplan = Lowering(
                self.sources, shared_cte_ids=shared_subquery_ids(plan)
            ).lower(plan)
        self.last_timing.plan_ms += planning.ms
        # shared WITH batches and correlated key matches live for one query
        # (their keys are id()s of this query's plan nodes and batches)
        self._clear_query_memos()
        try:
            with span("execute") as executing:
                out = None
                if self.mesh_pipeline is not None:
                    out = self.mesh_pipeline.try_execute(pplan)
                if out is None:
                    out = self.executor.execute(pplan)
        finally:
            self._clear_query_memos()
        self.last_timing.execute_ms += executing.ms
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

    # ---- DDL -----------------------------------------------------------
    def _exec_create_table(self, stmt: ast.CreateTable) -> ColumnBatch:
        name = stmt.name.lower()
        if name in self.sources:
            if stmt.if_not_exists:
                return self._status("CREATE TABLE")
            raise ExecutionError(f"table '{stmt.name}' already exists")
        schema = Schema(
            [Field(c.name, c.data_type, c.nullable) for c in stmt.columns]
        )
        src = MemoryDataSource(schema=schema, name=name, device=self.device)
        src.serials = {c.name: 1 for c in stmt.columns if c.serial}
        self.sources[name] = src
        self.planner.register_table(name, schema)
        self._invalidate_cache()
        return self._status("CREATE TABLE")

    def _exec_alter_table(self, stmt: ast.AlterTable) -> ColumnBatch:
        """ALTER TABLE: ADD COLUMN (an all-NULL plane on the device at the
        table's capacity), DROP COLUMN (dependent indexes dropped), RENAME
        COLUMN, RENAME TO. The other columns' planes are shared."""
        src = self._require_memory_table(stmt.table)
        batch = src.scan()
        schema = batch.schema
        table_key = stmt.table.lower()
        if stmt.action == "add":
            cd = stmt.column
            if schema.try_index_of(cd.name) is not None:
                raise ExecutionError(f"column '{cd.name}' already exists")
            if not cd.nullable and batch.num_rows:
                raise ExecutionError(
                    "ADD COLUMN NOT NULL on a non-empty table needs a "
                    "default (unsupported)"
                )
            dt = cd.data_type
            col = Column(
                torch.zeros(batch.capacity, dtype=_torch_dtype(dt),
                            device=self.device),
                torch.zeros(batch.capacity, dtype=torch.bool,
                            device=self.device),
                dt,
                Dictionary.empty() if dt.is_dictionary else None,
            )
            src.replace(ColumnBatch(
                Schema(list(schema.fields) + [Field(cd.name, dt, True)]),
                list(batch.columns) + [col], batch.num_rows,
            ))
        elif stmt.action == "drop":
            i = schema.index_of(stmt.name)
            if len(schema.fields) == 1:
                raise ExecutionError("cannot drop the only column")
            for idx in list(src.indexes.table_indexes(src.name)):
                if stmt.name in src.indexes.metadata(idx).columns:
                    src.indexes.drop_index(idx)
            src.replace(ColumnBatch(
                Schema([f for j, f in enumerate(schema) if j != i]),
                [c for j, c in enumerate(batch.columns) if j != i],
                batch.num_rows,
            ))
        elif stmt.action == "rename_column":
            i = schema.index_of(stmt.name)
            if schema.try_index_of(stmt.new_name) is not None:
                raise ExecutionError(
                    f"column '{stmt.new_name}' already exists"
                )
            fields = list(schema.fields)
            f = fields[i]
            fields[i] = Field(stmt.new_name, f.data_type, f.nullable)
            src.replace(ColumnBatch(
                Schema(fields), list(batch.columns), batch.num_rows
            ))
        elif stmt.action == "rename_table":
            new = stmt.name.lower()
            if new in self.sources or new in self.planner.views:
                raise ExecutionError(f"'{stmt.name}' already exists")
            del self.sources[table_key]
            self.planner.deregister_table(table_key)
            src.name = new
            self.sources[new] = src
            table_key = new
        else:
            raise ExecutionError(f"unknown ALTER action {stmt.action}")
        self.planner.register_table(table_key, src.schema())
        self._tables_changed(src)
        return self._status("ALTER TABLE")

    def _exec_create_table_as(self, stmt: ast.CreateTableAs) -> ColumnBatch:
        """CREATE TABLE t AS select — materialize the result as a new
        memory table (unqualified column names, PG CTAS)."""
        name = stmt.name.lower()
        if name in self.sources or name in self.planner.views:
            if stmt.if_not_exists:
                return self._status("CREATE TABLE AS")
            raise ExecutionError(f"'{stmt.name}' already exists")
        result = self._execute_query(stmt.query)
        schema = Schema([
            Field(f.name.rsplit(".", 1)[-1], f.data_type, f.nullable)
            for f in result.schema
        ])
        batch = ColumnBatch(schema, result.columns, result.num_rows)
        src = MemoryDataSource(schema=schema, name=name, device=self.device)
        src.append(batch)
        self.sources[name] = src
        self.planner.register_table(name, schema)
        self._invalidate_cache()
        return self._status(f"SELECT {result.num_rows}")

    def _exec_create_view(self, stmt: ast.CreateView) -> ColumnBatch:
        """CREATE [OR REPLACE] VIEW v [(cols)] AS select — bound at
        creation (PG semantics): the body plans NOW against the current
        schemas and every later reference shares the plan object, so a
        view used twice in one query materializes once (shared-CTE
        machinery)."""
        name = stmt.name.lower()
        if name in self.sources:
            raise ExecutionError(f"'{stmt.name}' is a table")
        if name in self.planner.views and not stmt.or_replace:
            raise ExecutionError(f"view '{stmt.name}' already exists")
        plan = self.optimizer.optimize(
            self.planner.create_logical_plan(stmt.query)
        )
        if stmt.columns:
            sch = plan.schema()
            if len(stmt.columns) != len(sch):
                raise ExecutionError(
                    f"view '{stmt.name}' column list has {len(stmt.columns)} "
                    f"names for {len(sch)} columns"
                )
            plan = lp.Projection(plan, [
                lp.AliasExpr(
                    lp.ColumnRef(i, f.name, f.data_type, f.nullable), c
                )
                for i, (f, c) in enumerate(zip(plan.schema(), stmt.columns))
            ])
        self.planner.register_view(name, plan)
        self._invalidate_cache()
        return self._status("CREATE VIEW")

    def _exec_drop_view(self, stmt: ast.DropView) -> ColumnBatch:
        name = stmt.name.lower()
        if name not in self.planner.views:
            if stmt.if_exists:
                return self._status("DROP VIEW")
            raise ExecutionError(f"view '{stmt.name}' does not exist")
        self.planner.deregister_view(name)
        self._invalidate_cache()
        return self._status("DROP VIEW")

    def _exec_drop_table(self, stmt: ast.DropTable) -> ColumnBatch:
        name = stmt.name.lower()
        if name not in self.sources:
            if stmt.if_exists:
                return self._status("DROP TABLE")
            raise ExecutionError(f"table '{stmt.name}' does not exist")
        src = self.sources.pop(name)
        self.planner.deregister_table(name)
        self._tables_changed(src)
        return self._status("DROP TABLE")

    def _require_memory_table(self, name: str) -> MemoryDataSource:
        src = self.sources.get(name.lower())
        if src is None:
            raise ExecutionError(f"table '{name}' not found")
        if not isinstance(src, MemoryDataSource):
            # snapshot file-backed tables into memory for DML
            mem = MemoryDataSource(
                batch=ensure_device(src.scan(), self.device),
                name=name.lower())
            self.sources[name.lower()] = mem
            return mem
        return src

    # ---- DML -----------------------------------------------------------
    def _host(self, t: torch.Tensor) -> list:
        return self.executor._host_list(t)

    def _exec_insert(self, stmt: ast.Insert) -> ColumnBatch:
        src = self._require_memory_table(stmt.table)
        schema = src.schema()
        col_names = stmt.columns or [f.name for f in schema]
        for c in col_names:
            schema.index_of(c)  # validate
        parts = []
        if stmt.query is not None:
            # INSERT INTO t [(cols)] SELECT ... — the query through the
            # ordinary engine, its columns aligned positionally and cast
            # to the target's types on the device
            result = self._execute_query(stmt.query)
            if len(result.schema) != len(col_names):
                raise ExecutionError(
                    f"INSERT SELECT returns {len(result.schema)} columns "
                    f"for {len(col_names)} target columns"
                )
            pos = {c: i for i, c in enumerate(col_names)}
            parts.append(dml.cast_columns(
                result, [pos.get(f.name) for f in schema], schema,
                descale=True, host=self._host))
        if stmt.values:
            rows: Dict[str, list] = {f.name: [] for f in schema}
            for vrow in stmt.values:
                if len(vrow) != len(col_names):
                    raise ExecutionError(
                        f"INSERT row has {len(vrow)} values for "
                        f"{len(col_names)} columns"
                    )
                given = dict(zip(col_names, [_literal_value(e) for e in vrow]))
                for f in schema:
                    rows[f.name].append(given.get(f.name))
            parts.append(ColumnBatch.from_pydict(rows, schema,
                                                 device=self.device))
        batch = ColumnBatch.concat(parts)
        for col, nxt in getattr(src, "serials", {}).items():
            i = schema.index_of(col)
            filled, src.serials[col] = dml.fill_serial(
                batch.columns[i], batch.num_rows, nxt, self._host)
            batch.columns[i] = filled
        batch = dml.encode_rows(batch, self._host)

        inserted = batch
        if stmt.on_conflict is not None:
            inserted = self._apply_on_conflict(src, batch, stmt.on_conflict)
        else:
            src.append(batch)
        self._tables_changed(src)
        if stmt.returning is not None:
            return self._returning(inserted, schema, stmt.returning)
        return self._status(f"INSERT 0 {inserted.num_rows}")

    def _apply_on_conflict(
        self, src: MemoryDataSource, batch: ColumnBatch,
        clause: ast.OnConflictClause,
    ) -> ColumnBatch:
        """UPSERT semantics (backend.rs:1092-1479): match on the conflict
        columns (NULL matches NULL, the last existing row of a key wins);
        DO NOTHING skips, DO UPDATE SET rewrites matched rows. The key
        match runs on the host over the key planes; the rewrite on the
        device."""
        existing = src.scan()
        key_cols = list(clause.columns)
        match = _conflict_match(existing, batch, key_cols,
                                self.executor._host_np)
        fresh = np.nonzero(match < 0)[0]
        hits = match[match >= 0]
        dev = self.device
        out = []
        if len(hits) and isinstance(clause.action, ast.DoUpdate):
            mask = torch.zeros(existing.capacity, dtype=torch.bool,
                               device=dev)
            mask[torch.from_numpy(hits).to(dev)] = True
            assigns = {}
            for a in clause.action.assignments:
                value = _literal_value(a.value)
                assigns[existing.schema.index_of(a.column)] = (
                    mask, _literal_val(value, existing.capacity, dev), False)
            updated = dml.rebuild(existing, assigns, self._host)
            src.replace(updated)
            out.append(updated.take(torch.from_numpy(hits).to(dev),
                                    len(hits)))
        if len(fresh):
            fresh_batch = dml.encode_rows(
                batch.take(torch.from_numpy(fresh).to(dev), len(fresh)),
                self._host)
            src.append(fresh_batch)
            out.append(fresh_batch)
        if not out:
            return ColumnBatch.empty(batch.schema, device=dev)
        return ColumnBatch.concat(out)

    def _dml_from_rows(self, table: str, from_ref, selection, value_exprs):
        """FROM/USING join for multi-table DML: run `SELECT __rid, values
        FROM target-with-rowids AS <table>, <from_ref> [WHERE ...]` through
        the ordinary engine and keep the FIRST match per target row (PG:
        which match wins is unspecified when several join). Returns the
        source, its batch, the query's result, the target rows that
        matched (a device mask) and, per target row, the result row of its
        first match."""
        src = self._require_memory_table(table)
        batch = src.scan()
        cap, dev = batch.capacity, self.device
        aug_schema = Schema(
            [Field("__rid", DataType.int64(), False)]
            + list(batch.schema.fields)
        )
        rid_col = Column(torch.arange(cap, dtype=torch.int64, device=dev),
                         torch.ones(cap, dtype=torch.bool, device=dev),
                         DataType.int64(), None)
        tmp = "__dml_target"
        tmp_src = MemoryDataSource(
            batch=ColumnBatch(aug_schema, [rid_col] + list(batch.columns),
                              batch.num_rows),
            name=tmp,
        )
        self.sources[tmp] = tmp_src
        self.planner.register_table(tmp, aug_schema)
        try:
            sel = ast.SelectStatement()
            sel.projection = [ast.ExprItem(ast.Column("__rid"), "__rid")] + [
                ast.ExprItem(e, f"__v{i}")
                for i, e in enumerate(value_exprs)
            ]
            sel.from_ = ast.TableName(tmp, table)
            sel.joins = [ast.Join(ast.JoinType.CROSS, from_ref)]
            sel.selection = selection
            out = self._execute_query(ast.Select(sel))
        finally:
            del self.sources[tmp]
            self.planner.deregister_table(tmp)
            self.executor.pipeline.drop_entries_reading([tmp_src])
        # the first result row of each target row: a scatter-min of the
        # result's row positions by row id
        live = torch.arange(out.capacity, device=dev) < out.num_rows
        rid = torch.where(live, out.columns[0].data, cap)
        first = torch.full((cap + 1,), out.capacity, dtype=torch.int64,
                           device=dev)
        first.scatter_reduce_(0, rid, torch.arange(out.capacity, device=dev),
                              reduce="amin")
        first = first[:cap]
        matched = first < out.capacity
        return src, batch, out, matched, first.clamp(max=out.capacity - 1)

    def _exec_update(self, stmt: ast.Update) -> ColumnBatch:
        if stmt.from_table is not None:
            return self._exec_update_from(stmt)
        src = self._require_memory_table(stmt.table)
        batch = src.scan()
        mask = self._dml_mask(stmt.table, stmt.selection, batch)
        # every assignment evaluated over the old batch, then applied
        assigns = {}
        for a in stmt.assignments:
            i = batch.schema.try_index_of(a.column)
            if i is None:  # the JAX Session's row dict has no such key
                raise KeyError(a.column)
            assigns[i] = (mask, self._eval_assignment(stmt.table, a.value,
                                                      batch), False)
        count = int(self._host(mask.sum().reshape(1))[0])
        updated = dml.rebuild(batch, assigns, self._host)
        src.replace(updated)
        self._tables_changed(src)
        if stmt.returning is not None:
            upd, _ = dml.select_rows(
                updated, dml.fit(mask, updated.capacity), self._host)
            return self._returning(upd, batch.schema, stmt.returning)
        return self._status(f"UPDATE {count}")

    def _exec_update_from(self, stmt: ast.Update) -> ColumnBatch:
        src, batch, out, matched, first = self._dml_from_rows(
            stmt.table, stmt.from_table, stmt.selection,
            [a.value for a in stmt.assignments],
        )
        cols = [a.column for a in stmt.assignments]
        for c in cols:
            batch.schema.index_of(c)  # validate target columns
        assigns = {}
        for j, c in enumerate(cols):
            v = out.columns[1 + j]
            assigns[batch.schema.index_of(c)] = (
                matched,
                Val(v.data[first], v.validity[first],
                    out.schema.field(1 + j).data_type, v.dictionary),
                True)
        count = int(self._host(matched.sum().reshape(1))[0])
        updated = dml.rebuild(batch, assigns, self._host)
        src.replace(updated)
        self._tables_changed(src)
        if stmt.returning is not None:
            upd, _ = dml.select_rows(
                updated, dml.fit(matched, updated.capacity), self._host)
            return self._returning(upd, batch.schema, stmt.returning)
        return self._status(f"UPDATE {count}")

    def _exec_delete_using(self, stmt: ast.Delete) -> ColumnBatch:
        src, batch, _, matched, _ = self._dml_from_rows(
            stmt.table, stmt.using, stmt.selection, []
        )
        return self._delete_rows(src, batch, matched, stmt.returning)

    def _exec_delete(self, stmt: ast.Delete) -> ColumnBatch:
        if stmt.using is not None:
            return self._exec_delete_using(stmt)
        src = self._require_memory_table(stmt.table)
        batch = src.scan()
        mask = self._dml_mask(stmt.table, stmt.selection, batch)
        return self._delete_rows(src, batch, mask, stmt.returning)

    def _delete_rows(self, src, batch, mask, returning) -> ColumnBatch:
        """Keep the live rows where `mask` is false, in order, at
        padded_capacity(kept); two host reads (the counts)."""
        kept, _ = dml.select_rows(batch, ~mask, self._host)
        deleted = batch.num_rows - kept.num_rows
        src.replace(kept)
        self._tables_changed(src)
        if returning is not None:
            gone, _ = dml.select_rows(batch, mask, self._host)
            return self._returning(gone, batch.schema, returning)
        return self._status(f"DELETE {deleted}")

    def _dml_mask(self, table: str, selection, batch: ColumnBatch
                  ) -> torch.Tensor:
        """The rows a WHERE selects, as a device mask over the batch's
        live rows (every live row without a WHERE)."""
        live = torch.arange(batch.capacity, device=self.device) \
            < batch.num_rows
        if selection is None:
            return live
        scope = Resolver(prefix_schema(batch.schema, table))
        pred = self.planner.plan_expr(selection, scope, {})
        return self.executor.evaluator.eval_predicate_mask(pred, batch) & live

    def _eval_assignment(self, table: str, expr, batch: ColumnBatch) -> Val:
        scope = Resolver(prefix_schema(batch.schema, table))
        le = self.planner.plan_expr(expr, scope, {})
        return self.executor.evaluator.eval(le, batch)

    def _returning(self, rows: ColumnBatch, schema: Schema, items
                   ) -> ColumnBatch:
        """The rows a RETURNING returns, read to the host and encoded as the
        JAX Session does it (types inferred from the values)."""
        names = [f.name for f in schema]
        out_cols: Dict[str, list] = {}
        for item in items:
            if isinstance(item, ast.WildcardItem):
                d = rows.to_pydict()
                for n in names:
                    out_cols[n] = d[n]
            elif isinstance(item, ast.ExprItem) and isinstance(item.expr, ast.Column):
                out_cols[item.alias or item.expr.name] = rows.column(
                    item.expr.name
                ).to_pylist(rows.num_rows)
            else:
                raise ExecutionError("RETURNING supports columns and *")
        return ColumnBatch.from_pydict(out_cols, device=self.device)

    # ---- indexes -------------------------------------------------------
    def _exec_create_index(self, stmt: ast.CreateIndex) -> ColumnBatch:
        src = self._require_memory_table(stmt.table)
        src.create_index(
            stmt.name, stmt.columns,
            "hash" if stmt.index_type is ast.IndexType.HASH else "btree",
            stmt.unique,
        )
        return self._status("CREATE INDEX")

    def _exec_drop_index(self, stmt: ast.DropIndex) -> ColumnBatch:
        for src in self.sources.values():
            if isinstance(src, MemoryDataSource) and src.indexes.has_index(stmt.name):
                src.drop_index(stmt.name)
                return self._status("DROP INDEX")
        if stmt.if_exists:
            return self._status("DROP INDEX")
        raise ExecutionError(f"index '{stmt.name}' not found")

    def _tables_changed(self, *sources) -> None:
        """After a statement replaced, appended to or dropped these tables:
        clear the result cache, and drop the compiled programs that read
        them (they hold the old planes)."""
        self.executor.pipeline.drop_entries_reading(sources)
        self._invalidate_cache()

    def _invalidate_cache(self):
        if self._cache is not None:
            self._cache.clear()

    def _status(self, tag: str) -> ColumnBatch:
        return ColumnBatch.from_pydict({"status": [tag]}, device=self.device)


def _conflict_match(existing: ColumnBatch, batch: ColumnBatch,
                    key_cols: List[str], host_np) -> np.ndarray:
    """For each row of `batch`, the last row of `existing` whose key
    columns equal it as Python values do (NULL equals NULL), or -1. One
    host read of each key plane; the match runs in numpy."""
    ne, nb = existing.num_rows, batch.num_rows
    parts = []
    for c in key_cols:
        e, b = existing.column(c), batch.column(c)
        ed, bd = host_np(e.data[:ne]), host_np(b.data[:nb])
        ev = host_np(e.validity[:ne]).astype(bool)
        bv = host_np(b.validity[:nb]).astype(bool)
        if e.dictionary is not None or b.dictionary is not None:
            # both sides' codes on their merged dictionary
            _, ra, rb = (e.dictionary or Dictionary.empty()).merge(
                b.dictionary or Dictionary.empty())
            ed = np.asarray(ra, dtype=np.int64)[ed] if len(ra) else ed
            bd = np.asarray(rb, dtype=np.int64)[bd] if len(rb) else bd
        elif ed.dtype.kind == "f":
            # 0.0 == -0.0, as Python floats compare
            ed = np.where(ed == 0, 0.0, ed).astype(np.float64).view(np.int64)
            bd = np.where(bd == 0, 0.0, bd).astype(np.float64).view(np.int64)
        parts.append(np.concatenate([np.where(ev, ed, 0),
                                     np.where(bv, bd, 0)]).astype(np.int64))
        parts.append(np.concatenate([ev, bv]).astype(np.int64))
    if nb == 0:
        return np.zeros(0, dtype=np.int64)
    _, gid = np.unique(np.stack(parts, axis=1), axis=0, return_inverse=True)
    gid = gid.reshape(-1)
    last = np.full(int(gid.max()) + 1, -1, dtype=np.int64)
    np.maximum.at(last, gid[:ne], np.arange(ne, dtype=np.int64))
    return last[gid[ne:]]


def _strip_union(sel: ast.SelectStatement) -> ast.SelectStatement:
    base = copy.copy(sel)
    base.union_clause = None
    return base


def _rename_batch(batch: ColumnBatch, names: List[str]) -> ColumnBatch:
    if len(names) != len(batch.schema):
        raise SchemaError("CTE column list arity mismatch")
    return batch.rename(names)


def _literal_value(e: ast.Expr):
    """The Python value of an INSERT literal. `DATE '...'` and
    `TIMESTAMP '...'` give their text, which the column's encoder parses;
    the JAX Session takes neither."""
    if isinstance(e, ast.NumberLit):
        return float(e.value) if any(c in e.value for c in ".eE") else int(e.value)
    if isinstance(e, ast.StringLit):
        return e.value
    if isinstance(e, ast.BoolLit):
        return e.value
    if isinstance(e, ast.NullLit):
        return None
    if isinstance(e, ast.UnaryOp) and e.op is ast.UnaryOperator.MINUS:
        v = _literal_value(e.expr)
        return -v
    if isinstance(e, ast.Cast) and isinstance(e.expr, ast.StringLit) \
            and e.data_type in (DataType.date32(), DataType.timestamp()):
        return e.expr.value
    raise ExecutionError("INSERT values must be literals")


def _literal_val(value, capacity: int, device) -> Val:
    """A Python literal broadcast to `capacity` rows."""
    if value is None:
        dt = DataType.null()
    elif isinstance(value, float):
        dt = DataType.float64()
    elif isinstance(value, str):
        dt = DataType.utf8()
    elif isinstance(value, bool):
        dt = DataType.boolean()
    else:
        dt = DataType.int64()
    return _bcast(value, dt, capacity, device)


def _table_rows(sources: dict, name: str):
    """A registered table's row count, None for any other name."""
    n = getattr(sources.get(name.lower()), "num_rows", None)
    return n() if callable(n) else n


def _bind_params(stmt: ast.Statement, params: list) -> ast.Statement:
    """Substitute $n parameters with literal AST nodes (extended protocol,
    reference extended.rs:141-230 does SQL-text substitution; this does it
    on the AST, which is safer)."""

    def sub(obj):
        if isinstance(obj, ast.Param):
            v = params[obj.index - 1]
            if v is None:
                return ast.NullLit()
            if isinstance(v, bool):
                return ast.BoolLit(v)
            if isinstance(v, (int, float)):
                return ast.NumberLit(repr(v), bound=True)
            return ast.StringLit(str(v))
        if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
            changes = {}
            for f in dataclasses.fields(obj):
                val = getattr(obj, f.name)
                new = sub_value(val)
                if new is not val:
                    changes[f.name] = new
            if changes:
                try:
                    return dataclasses.replace(obj, **changes)
                except TypeError:
                    for k, v in changes.items():
                        object.__setattr__(obj, k, v)
                    return obj
        return obj

    def sub_value(val):
        if isinstance(val, (list, tuple)):
            newv = [sub_value(x) for x in val]
            if isinstance(val, tuple):
                newv = tuple(newv)
            return newv
        if dataclasses.is_dataclass(val) and not isinstance(val, type):
            return sub(val)
        return val

    return sub(stmt)
