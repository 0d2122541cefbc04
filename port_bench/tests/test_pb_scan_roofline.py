"""The scan's roofline share: its least bytes come from the configuration's
`scan`, and a statement without widths there leaves the metric out."""

import json

from port_bench.metrics import scan_roofline
from port_bench.tests.conftest import ROOT

CONFIG = json.loads((ROOT / "port_bench" / "configs"
                     / "ssb-sf10.json").read_text())


def test_least_bytes_of_flight1():
    rows = CONFIG["sizes"]["lineorder"]
    # four BIGINT columns of lineorder a statement, each read once
    assert scan_roofline.least_bytes(CONFIG, ["Q1.1", "Q1.2", "Q1.3"]) \
        == 3 * 32 * rows


def test_statement_without_widths_reads_nothing():
    assert scan_roofline.least_bytes(CONFIG, ["Q1.1", "Q2.1"]) is None
    ctx = {"trace": {"kernel_count": 5, "busy_s": 1.0},
           "bench": ROOT / "port_bench", "config": CONFIG,
           "device_name": "NVIDIA H100 80GB HBM3",
           "records": [("Q2.1", 1.0, [], 0.1)]}
    assert scan_roofline.read(ctx) is None


def test_share_of_the_peak():
    ctx = {"trace": {"kernel_count": 5, "busy_s": 2.0},
           "bench": ROOT / "port_bench", "config": CONFIG,
           "device_name": "NVIDIA H100 80GB HBM3",
           "records": [("Q1.1", 1.0, [], 0.1)]}
    least = 32 * CONFIG["sizes"]["lineorder"]
    assert scan_roofline.read(ctx) == 100.0 * least / 3.35e12 / 2.0
