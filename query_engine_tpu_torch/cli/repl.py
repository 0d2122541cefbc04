"""Interactive REPL.

Parity surface: reference crates/query-cli/src/repl.rs — rustyline REPL with
dot-commands (.load/.tables/.describe/.schema/.drop/.timing/.plan/.format/
.indexes/.cache/.help/.exit). One deliberate difference: SQL *executes*
(the reference's REPL only parses + plans and prints "Query parsed and
planned successfully!", repl.rs:302-363).

The port's counterpart of `query_engine_tpu.cli.repl`: `Repl()` builds its
Session on `device`, the card ("cuda") unless the caller asks for the CPU.
"""

from __future__ import annotations

import time
from typing import Optional

from query_engine_tpu_torch.cli.config import CliConfig
from query_engine_tpu_torch.cli.format import render
from query_engine_tpu_torch.core.errors import QueryError
from query_engine_tpu_torch.engine.session import Session
from query_engine_tpu_torch.storage.memory import MemoryDataSource

BANNER = """query-engine-tpu REPL — type SQL, or .help for commands"""

HELP = """\
Commands:
  .load <name> <path>     register a CSV/Parquet file as a table
  .tables                 list tables
  .describe <table>       show a table's schema
  .schema <table>         alias for .describe
  .drop <table>           deregister a table
  .indexes [table]        list indexes
  .cache [stats|clear]    result-cache control
  .timing [on|off]        toggle query timing (parse/plan/execute breakdown)
  .profile [on|off|reset] per-operator counters (rows/s, HBM roofline frac)
  .plan [on|off]          show logical plans before execution
  .format <table|csv|json>  output format
  .help                   this help
  .exit / .quit           leave
Anything else is executed as SQL (multi-statement with ';' supported)."""


class Repl:
    def __init__(self, session: Optional[Session] = None,
                 config: Optional[CliConfig] = None, device="cuda"):
        self.session = (session if session is not None
                        else Session(device=device, enable_cache=True))
        self.config = config or CliConfig()
        self.show_timing = self.config.show_timing
        self.show_plan = self.config.show_plan
        self.fmt = self.config.output_format

    # one input line/statement -> output text (testable without a tty)
    def handle(self, line: str) -> str:
        line = line.strip()
        if not line:
            return ""
        if line.startswith("."):
            return self._dot_command(line)
        return self._sql(line)

    def _dot_command(self, line: str) -> str:
        parts = line.split()
        cmd = parts[0].lower()
        args = parts[1:]
        if cmd in (".exit", ".quit"):
            raise EOFError
        if cmd == ".help":
            return HELP
        if cmd == ".load":
            if len(args) != 2:
                return "usage: .load <name> <path>"
            name, path = args
            if path.endswith(".parquet"):
                self.session.register_parquet(name, path)
            else:
                self.session.register_csv(name, path)
            schema = self.session.table_schema(name)
            return f"Loaded '{name}' ({len(schema)} columns)"
        if cmd == ".tables":
            names = self.session.tables() + [
                f"{v} (view)" for v in self.session.views()
            ]
            return "\n".join(names) if names else "(no tables)"
        if cmd in (".describe", ".schema"):
            if not args:
                return "usage: .describe <table>"
            try:
                schema = self.session.table_schema(args[0])
            except KeyError:
                return f"table '{args[0]}' not found"
            return "\n".join(
                f"{f.name.rsplit('.', 1)[-1]}\t{f.data_type}"
                f"\t{'NULL' if f.nullable else 'NOT NULL'}"
                for f in schema
            )
        if cmd == ".drop":
            if not args:
                return "usage: .drop <table>"
            self.session.deregister_table(args[0])
            return f"Dropped '{args[0]}'"
        if cmd == ".indexes":
            lines = []
            for name, src in sorted(self.session.sources.items()):
                if isinstance(src, MemoryDataSource):
                    for meta in src.indexes.list_indexes():
                        lines.append(
                            f"{meta.name}\t{meta.table}"
                            f"\t({', '.join(meta.columns)})\t{meta.index_type}"
                            + ("\tUNIQUE" if meta.unique else "")
                        )
            return "\n".join(lines) if lines else "(no indexes)"
        if cmd == ".cache":
            cache = self.session._cache
            if cache is None:
                return "cache disabled"
            if args and args[0] == "clear":
                cache.clear()
                return "cache cleared"
            snap = cache.stats.snapshot()
            return "\n".join(f"{k}: {v}" for k, v in snap.items())
        if cmd == ".timing":
            self.show_timing = not args or args[0] == "on"
            return f"timing {'on' if self.show_timing else 'off'}"
        if cmd == ".profile":
            from query_engine_tpu_torch.utils.profiling import GLOBAL_PROFILER

            if args and args[0] == "off":
                GLOBAL_PROFILER.enabled = False
                return "profiling off"
            if args and args[0] == "reset":
                GLOBAL_PROFILER.reset()
                return "profiler reset"
            if args and args[0] == "on":
                GLOBAL_PROFILER.enabled = True
                return "profiling on (per-operator counters; .profile to view)"
            if not GLOBAL_PROFILER.enabled:
                GLOBAL_PROFILER.enabled = True
                return "profiling on (run queries, then .profile to view)"
            return GLOBAL_PROFILER.report()
        if cmd == ".plan":
            self.show_plan = not args or args[0] == "on"
            return f"plan {'on' if self.show_plan else 'off'}"
        if cmd == ".format":
            if args and args[0] in ("table", "csv", "json"):
                self.fmt = args[0]
                return f"format {self.fmt}"
            return "usage: .format <table|csv|json>"
        return f"unknown command {cmd}; try .help"

    def _sql(self, sql: str) -> str:
        out = []
        t0 = time.perf_counter()
        try:
            if self.show_plan:
                try:
                    out.append(self.session.explain(sql))
                except QueryError:
                    pass
            result = self.session.sql(sql)
            out.append(render(result, self.fmt, self.config.max_rows))
        except QueryError as e:
            return f"Error: {e}"
        if self.show_timing:
            t = self.session.last_timing
            out.append(
                f"Time: {(time.perf_counter() - t0) * 1000:.2f} ms ({t})"
            )
        return "\n".join(out)

    def run(self):
        try:
            import readline  # noqa: F401 enables history/editing
        except ImportError:
            pass
        print(BANNER)
        buf = ""
        while True:
            prompt = "qe> " if not buf else "  -> "
            try:
                line = input(prompt)
            except (EOFError, KeyboardInterrupt):
                print()
                break
            if line.strip().startswith(".") and not buf:
                try:
                    print(self.handle(line))
                except EOFError:
                    break
                continue
            buf += line + "\n"
            if ";" in line or not line.strip():
                text = buf.strip()
                buf = ""
                if text:
                    print(self.handle(text))
