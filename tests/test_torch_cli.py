"""The port's CLI and REPL against the JAX package's.

The cases of tests/test_cli.py run through both CLIs (`main(argv)`, the
port's with `--device cpu`) and both REPLs (`Repl.handle`, the port's
`Repl(device="cpu")`), with the reference's assertions, and the printed
text must be equal: `query` in table, csv and json form, `--plan`,
`export` (the written files too) and every REPL reply. `bench`'s timing
lines are excepted (the stat block's labels are compared), and so is the
REPL's `Time:` line.
"""

import json
import os

import pytest

from query_engine_tpu.cli.main import main as jmain
from query_engine_tpu.cli.repl import Repl as JRepl
from query_engine_tpu_torch.cli.main import main as tmain
from query_engine_tpu_torch.cli.repl import Repl as TRepl

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "data")
EMP = os.path.join(DATA, "employees.csv")


@pytest.fixture(autouse=True)
def home(tmp_path, monkeypatch):
    """Both CLIs read their table registry from ~/.qe_tpu.json: an empty
    home for each test."""
    monkeypatch.setenv("HOME", str(tmp_path))
    for mod in ("query_engine_tpu.cli.config",
                "query_engine_tpu_torch.cli.config"):
        monkeypatch.setattr(f"{mod}.DEFAULT_PATH",
                            str(tmp_path / ".qe_tpu.json"))


def both(capsys, argv):
    """(jax output, port output, port exit code) of one command line."""
    rc_j = jmain(argv)
    out_j = capsys.readouterr().out
    rc_t = tmain(argv[:1] + ["--device", "cpu"] + argv[1:])
    out_t = capsys.readouterr().out
    assert rc_t == rc_j
    return out_j, out_t, rc_t


def test_query_executes(capsys):
    out_j, out, rc = both(capsys, [
        "query", "-s", "SELECT name FROM e WHERE age > 30 ORDER BY name",
        "-t", f"e={EMP}"])
    assert rc == 0
    assert "Charlie" in out and "Eve" in out and "Alice" not in out
    assert out == out_j


def test_query_formats(capsys):
    out_j, out, _ = both(capsys, [
        "query", "-s", "SELECT id, name FROM e ORDER BY id LIMIT 2",
        "-t", f"e={EMP}", "--format", "json"])
    assert json.loads(out) == [{"id": 1, "name": "Alice"},
                               {"id": 2, "name": "Bob"}]
    assert out == out_j
    out_j, out, _ = both(capsys, [
        "query", "-s", "SELECT id FROM e ORDER BY id LIMIT 1",
        "-t", f"e={EMP}", "--format", "csv"])
    assert out.strip().splitlines() == ["id", "1"]
    assert out == out_j
    out_j, out, _ = both(capsys, [
        "query", "-s", "SELECT dept_id, AVG(salary) AS a, COUNT(*) AS n "
        "FROM e GROUP BY dept_id ORDER BY dept_id", "-t", f"e={EMP}",
        "--format", "table"])
    assert "NULL" in out and "row(s)" in out
    assert out == out_j


def test_query_plan_only(capsys):
    out_j, out, _ = both(capsys, [
        "query", "-s", "SELECT name FROM e WHERE age > 25", "-t", f"e={EMP}",
        "--plan"])
    assert "Filter" in out and "TableScan" in out
    assert out == out_j


def test_bench_executes(capsys):
    out_j, out, rc = both(capsys, [
        "bench", "-s", "SELECT COUNT(*) FROM e", "-t", f"e={EMP}", "-n", "5"])
    assert rc == 0
    assert "Average" in out and "QPS" in out and "P99" in out

    def labels(text):
        return [line.split(":")[0] for line in text.splitlines()]

    assert labels(out) == labels(out_j)


def test_export_roundtrip(tmp_path, capsys):
    files = {}
    for pkg, main, extra in (("jax", jmain, []),
                             ("torch", tmain, ["--device", "cpu"])):
        out_path = str(tmp_path / f"{pkg}.csv")
        main(["export"] + extra + [
            "-s", "SELECT name, age FROM e WHERE age > 30",
            "-t", f"e={EMP}", "-o", out_path])
        text = open(out_path).read().strip().splitlines()
        assert text[0] == "name,age"
        assert set(text[1:]) == {"Charlie,35", "Eve,32"}
        json_path = str(tmp_path / f"{pkg}.json")
        main(["export"] + extra + [
            "-s", "SELECT id, name, salary / 7.0 AS r FROM e ORDER BY id",
            "-t", f"e={EMP}", "-o", json_path])
        pq_path = str(tmp_path / f"{pkg}.parquet")
        main(["export"] + extra + ["-s", "SELECT id FROM e", "-t",
                                   f"e={EMP}", "-o", pq_path])
        import pyarrow.parquet as pq

        assert pq.read_table(pq_path).num_rows == 6
        printed = capsys.readouterr().out.replace(pkg, "PKG")
        files[pkg] = (open(out_path).read(), open(json_path).read(),
                      pq.read_table(pq_path).to_pylist(), printed)
    assert files["torch"] == files["jax"]


def test_repl_flow():
    outs = {}
    for pkg, r in (("jax", JRepl()), ("torch", TRepl(device="cpu"))):
        got = []
        got.append(r.handle(f".load emp {EMP}"))
        assert "Loaded 'emp'" in got[-1]
        got.append(r.handle(".tables"))
        assert "emp" in got[-1]
        got.append(r.handle(".describe emp"))
        assert "salary" in got[-1]
        got.append(r.handle("SELECT name FROM emp WHERE age > 30 "
                            "ORDER BY name"))
        assert "Charlie" in got[-1] and "Eve" in got[-1]
        got.append(r.handle("SELECT nope FROM emp"))
        assert "Error" in got[-1]
        got.append(r.handle(".format json"))
        got.append(r.handle("SELECT id FROM emp ORDER BY id LIMIT 1"))
        assert json.loads(got[-1]) == [{"id": 1}]
        got.append(r.handle(".timing on"))
        assert got[-1] == "timing on"
        out = r.handle("SELECT 1")
        assert "Time:" in out
        got.append(out)
        got.append(r.handle("CREATE INDEX ix ON emp (id)"))
        got.append(r.handle(".indexes"))
        assert "ix" in got[-1]
        stats = r.handle(".cache")
        assert "hit_rate" in stats
        got.append(stats)
        got.append(r.handle(".format table"))
        got.append(r.handle("SELECT dept_id, COUNT(*) FROM emp "
                            "GROUP BY dept_id ORDER BY dept_id"))
        got.append(r.handle(".help"))
        with pytest.raises(EOFError):
            r.handle(".exit")
        outs[pkg] = [o.split("\nTime:")[0] for o in got]
    assert outs["torch"] == outs["jax"]


def test_cli_defaults_to_the_card(capsys):
    """Without --device the CLI's Session lies on the card: without CUDA it
    raises, as Session() does."""
    import torch

    argv = ["query", "-s", "SELECT 1"]
    if torch.cuda.is_available():
        assert tmain(argv) == 0
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmain(argv)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TRepl()
