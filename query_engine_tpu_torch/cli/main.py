"""`qe` command-line interface.

Parity surface: reference crates/query-cli/src/main.rs:31-177 — subcommands
repl / query / register / tables / describe / bench / export /
flight-server / flight-query / pg-server.

The port's counterpart of `query_engine_tpu.cli.main`
(`python -m query_engine_tpu_torch.cli`): each subcommand that builds a
Session takes `--device {cuda,cpu}`, the card by default, where the JAX
CLI picks its platform through JAX.
"""

from __future__ import annotations

import argparse
import sys

from query_engine_tpu_torch.cli.config import CliConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="qe",
        description="query-engine-tpu: a TPU-native vectorized SQL engine",
    )
    sub = p.add_subparsers(dest="command")
    # the device of every Session a subcommand builds
    dev = argparse.ArgumentParser(add_help=False)
    dev.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                     help="where the Session's tables and work live")

    sp = sub.add_parser("repl", help="interactive SQL REPL (executes!)",
                        parents=[dev])

    sp = sub.add_parser("query", help="execute a SQL query", parents=[dev])
    sp.add_argument("-s", "--sql", required=True)
    sp.add_argument("-t", "--table", action="append",
                    help="name=path CSV/Parquet registration", default=[])
    sp.add_argument("--plan", action="store_true", help="print the plan only")
    sp.add_argument("--timing", action="store_true")
    sp.add_argument("--format", choices=["table", "csv", "json"])

    sp = sub.add_parser("register", help="persist a table registration",
                        parents=[dev])
    sp.add_argument("name")
    sp.add_argument("path")

    sp = sub.add_parser("tables", help="list registered tables")

    sp = sub.add_parser("describe", help="show a table schema",
                        parents=[dev])
    sp.add_argument("name")

    sp = sub.add_parser("bench", help="benchmark a query (real execution)",
                        parents=[dev])
    sp.add_argument("-s", "--sql", required=True)
    sp.add_argument("-t", "--table", action="append", default=[])
    sp.add_argument("-n", "--iterations", type=int, default=100)

    sp = sub.add_parser("export", help="run a query and write the result",
                        parents=[dev])
    sp.add_argument("-s", "--sql", required=True)
    sp.add_argument("-i", "--input", help="input file to register")
    sp.add_argument("--input-name", default="input")
    sp.add_argument("-t", "--table", action="append", default=[])
    sp.add_argument("-o", "--output", required=True,
                    help="output path (.csv/.parquet/.json)")

    sp = sub.add_parser("flight-server", help="start the Arrow Flight server",
                        parents=[dev])
    sp.add_argument("--host", default="0.0.0.0")
    sp.add_argument("--port", type=int, default=50051)
    sp.add_argument("-t", "--table", action="append", default=[])

    sp = sub.add_parser("flight-query", help="query a remote Flight server")
    sp.add_argument("--connect", required=True)
    sp.add_argument("-s", "--sql", required=True)
    sp.add_argument("--format", choices=["table", "csv", "json"])

    sp = sub.add_parser("pg-server",
                        help="start the PostgreSQL-protocol server",
                        parents=[dev])
    sp.add_argument("--host", default="127.0.0.1")
    sp.add_argument("--port", type=int, default=5432)
    sp.add_argument("-t", "--table", action="append", default=[])
    sp.add_argument("--user")
    sp.add_argument("--password")
    sp.add_argument("--tls-cert")
    sp.add_argument("--tls-key")

    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    config = CliConfig.load()
    from query_engine_tpu_torch.cli import commands as C

    if args.command == "repl" or args.command is None:
        from query_engine_tpu_torch.cli.repl import Repl

        Repl(config=config, device=getattr(args, "device", "cuda")).run()
        return 0
    if args.command == "query":
        return C.cmd_query(args, config)
    if args.command == "register":
        return C.cmd_register(args, config)
    if args.command == "tables":
        return C.cmd_tables(args, config)
    if args.command == "describe":
        return C.cmd_describe(args, config)
    if args.command == "bench":
        return C.cmd_bench(args, config)
    if args.command == "export":
        return C.cmd_export(args, config)
    if args.command == "flight-server":
        return C.cmd_flight_server(args, config)
    if args.command == "flight-query":
        return C.cmd_flight_query(args, config)
    if args.command == "pg-server":
        return C.cmd_pg_server(args, config)
    return 1


if __name__ == "__main__":
    sys.exit(main())
