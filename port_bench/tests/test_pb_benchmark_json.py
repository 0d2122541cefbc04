"""BENCHMARK.json keeps to the benchmark's contract: names and units of the
allowed characters, every file it names present, and each per-layer
metric's reader agreeing with its entry."""

import importlib
import json
import re

import pytest

from port_bench.tests.conftest import ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def one_line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    assert isinstance(SPEC["run_seconds"], int)
    assert len(json.dumps(SPEC)) <= 64 * 1024
    assert SPEC["paths"] == ["port_bench"]
    assert all(one_line(w) for w in SPEC["command"])
    assert len(SPEC["command"]) <= 32


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries(section):
    names = [e["name"] for e in SPEC[section]]
    assert len(names) == len(set(names))
    for e in SPEC[section]:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
            assert e["source"] in SOURCES
        for key in ("why", "layer", "source"):
            if key in e:
                assert one_line(e[key]), (e["name"], key)


def test_bounds():
    names = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in names
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m
        assert m["source"] in ("host_clock", "device_trace")


def test_configs_files():
    for c in SPEC["configs"]:
        assert c["file"].startswith("port_bench/")
        config = json.loads((ROOT / c["file"]).read_text())
        assert config["name"] == c["name"]
        assert config["reduced"] == c["reduced"]
        for key in c["reduced"]:
            assert NAME.match(key)
        importlib.import_module(config["generator"])
        ref = importlib.import_module(config["reference"])
        assert set(config["limits"]) <= {"wrong", "float_gap"}
        used = [w for w in SPEC["workloads"] if w["config"] == c["name"]]
        assert used, c["name"]
        for w in used:
            mix = json.loads((ROOT / "port_bench" / "mixes"
                              / f"{w['traffic']}.json").read_text())
            assert mix["family"] == config["family"]
            for q in mix["statements"]:
                assert (ROOT / "port_bench" / "queries" / config["family"]
                        / f"{q}.sql").exists(), q
                assert q in ref.ORDER and q in ref.ORACLES, q


def test_cells():
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in SPEC["workloads"]:
        assert w["chips"] in (1, 4)
        assert w["name"] == f"{w['config']}.{w['traffic']}"
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_metric_reader_and_cells(metric):
    entry = next(m for m in SPEC["per_layer"] if m["name"] == metric)
    # the reader is found by the part of the metric's name before its
    # first dot, and holds only `read`: its
    # unit, source, layer, `moves` and cells are the entry's alone
    mod = importlib.import_module(
        f"port_bench.metrics.{metric.split('.')[0]}")
    assert callable(mod.read)
    assert not {"UNIT", "BETTER", "SOURCE", "LAYER", "MOVES",
                "WORKLOADS"} & set(vars(mod))
    # every cell it is read in reports the end-to-end metric it moves
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert entry["moves"] in e2e
    cells = entry.get("workloads", [w["name"] for w in SPEC["workloads"]])
    for cell in cells:
        assert cell in {w["name"] for w in SPEC["workloads"]}
        assert cell in e2e[entry["moves"]].get("workloads", [cell])


def test_per_layer_units_come_from_the_entry():
    from port_bench import run

    for w in SPEC["workloads"]:
        got = run.per_layer_metrics(SPEC, w["name"])
        want = {m["name"]: m["unit"] for m in SPEC["per_layer"]
                if w["name"] in m.get("workloads", [w["name"]])}
        assert {k: u for k, (u, _) in got.items()} == want


def test_every_cell_has_a_per_layer_metric():
    for w in SPEC["workloads"]:
        assert any(w["name"] in m.get("workloads", [w["name"]])
                   for m in SPEC["per_layer"])


def test_layers_named_alike():
    layers = {m["layer"] for m in SPEC["per_layer"]}
    assert layers == {"front end", "compiled pipeline", "eager walk",
                      "kernels", "device"}
