"""A run on the CPU (the look for a card skipped, the rest of a run as the
card's) comes out correct, and comes out not correct when the timed path
is broken underneath it: half of each table left out, or an answer altered
where the program produces it; the control, the reference computed in
float32 in the program's place, is not correct either."""

import importlib
import time

import pytest

from port_bench import control, run
from port_bench.tests.conftest import SEED, tiny

CELLS = ["ssb-sf10.star", "ssb-sf10.flight1"]


def drive(workload, trace=False):
    spec, cell, config, mix = run.cell_files(workload)
    result, lines = run.run_cell(spec, cell, tiny(config), mix, SEED, 0.5,
                                 trace, "cpu", t0=time.perf_counter())
    assert result["attempted"] > 0
    assert list(result)[-1] == "checks"
    return result, lines


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    result, lines = drive(workload)
    assert result["correct"], lines
    assert result["failed"] == 0
    spec = run.cell_files(workload)[0]
    assert set(result["metrics"]) == {
        m["name"] for m in spec["end_to_end"]
        if workload in m.get("workloads", [workload])}
    assert {"setup_s", "peak_alloc_gib"} < set(result["metrics"])


@pytest.mark.parametrize("workload", CELLS)
def test_traced_run_reports_per_layer_metrics(workload):
    result, lines = drive(workload, trace=True)
    assert result["correct"], lines
    spec = run.cell_files(workload)[0]
    entries = [m for m in spec["per_layer"] if run.reports(m, workload)]
    # no device on the CPU: the device trace's metrics are left out, and
    # the program's counters and spans are all there, each unit its entry's
    assert {k: v["unit"] for k, v in result["metrics"].items()} == {
        m["name"]: m["unit"] for m in entries
        if m["source"] != "device_trace"}
    assert result["device"]["window_s"] > 0


@pytest.mark.parametrize("workload", CELLS)
def test_half_the_rows_left_out(workload, monkeypatch):
    real = run.register

    def half(session, tables, device):
        import torch

        for t in tables.values():
            keep = torch.arange(t.num_rows) % 2 == 0
            if t.num_rows > 100:
                t.num_rows = int(keep.sum())
                for c in t.columns:
                    c.data = c.data[keep]
        real(session, tables, device)

    monkeypatch.setattr(run, "register", half)
    result, _ = drive(workload)
    assert not result["correct"]
    assert result["failed"] > 0


@pytest.mark.parametrize("workload", CELLS)
def test_an_answer_altered(workload, monkeypatch):
    from query_engine_tpu_torch.columnar.batch import ColumnBatch

    real = ColumnBatch.to_pylist

    def altered(self):
        rows = real(self)
        if rows:
            row = list(rows[0])
            for i, v in enumerate(row):
                if isinstance(v, (int, float)) and not isinstance(v, bool) \
                        and v is not None:
                    row[i] = v + 1 if isinstance(v, int) else v * (1 + 1e-6)
                    break
            rows[0] = tuple(row)
        return rows

    monkeypatch.setattr(ColumnBatch, "to_pylist", altered)
    result, _ = drive(workload)
    assert not result["correct"]


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload):
    spec, cell, config, mix = run.cell_files(workload)
    config = tiny(config)
    generator = importlib.import_module(config["generator"])
    reference = importlib.import_module(config["reference"])
    tables = generator.generate(config, SEED, "cpu")
    host = {k: tables[k].host() for k in mix.get("tables", tables)}
    r = control.readings(reference, host,
                         list(dict.fromkeys(mix["statements"])))
    limits = config["limits"]
    assert any(r[k] > limits[k] for k in limits), r
