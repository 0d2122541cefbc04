"""On the card: a tiny run of each cell through the whole harness, the
profiler's trace included, comes out correct. Each run is a process of its
own, as the benchmark's runs are. Skips without a card."""

import json
import subprocess
import sys

import pytest

from port_bench.tests.conftest import ROOT

CODE = """
import json, sys, time
from port_bench import run
from port_bench.tests.conftest import SEED, tiny
spec, cell, config, mix = run.cell_files(sys.argv[1])
result, lines = run.run_cell(spec, cell, tiny(config), mix, SEED, 1.0,
                             sys.argv[2] == "1", "cuda",
                             t0=time.perf_counter())
print(json.dumps(result))
"""


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["ssb-sf10.star", "ssb-sf10.flight1"])
@pytest.mark.parametrize("trace", [False, True])
def test_tiny_run_on_the_card(workload, trace, cuda_device):
    out = subprocess.run([sys.executable, "-c", CODE, workload,
                          str(int(trace))], cwd=ROOT, capture_output=True,
                         text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], out.stderr[-4000:]
    assert result["device"]["platform"] == "gpu"
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    section = "per_layer" if trace else "end_to_end"
    # every metric the cell reports, the device trace's among them
    assert set(result["metrics"]) == {
        m["name"] for m in spec[section]
        if workload in m.get("workloads", [workload])}
    if trace:
        assert result["device"]["busy_s"] > 0
