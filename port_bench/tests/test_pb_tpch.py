"""The TPC-H configuration at a tiny scale on the CPU: the generator keeps
section 4.2.3's rules, the reference imports nothing of the program, every
one of the 22 texts through the port gives the reference's rows, and the
cell's run through the harness comes out correct, with its per-layer
metrics when traced, and its float32 control comes out not correct."""

import importlib
import json
import subprocess
import sys
import time

import numpy as np
import pytest

from port_bench import control, run
from port_bench.data import tpch
from port_bench.reference.compare import compare
from port_bench.tests.conftest import ROOT, SEED

CELL = "tpch-sf10.power"
# section 4.2's ratios at SF 0.01, lineitem about four lines an order
TINY = {"sizes": {"region": 5, "nation": 25, "supplier": 100, "part": 2000,
                  "partsupp": 8000, "customer": 1500, "orders": 15000,
                  "lineitem": 60000},
        "text_pool_bytes": 1 << 20}


def tiny(config: dict) -> dict:
    return dict(config, **TINY)


@pytest.fixture(scope="module")
def config():
    return tiny(run.cell_files(CELL)[2])


@pytest.fixture(scope="module")
def host(config):
    return {k: v.host() for k, v in tpch.generate(config, SEED,
                                                  "cpu").items()}


def test_sizes_and_sparse_order_keys(host):
    sizes = TINY["sizes"]
    for name, rows in sizes.items():
        assert host[name].num_rows == rows, name
    key = host["orders"].columns["o_orderkey"]
    assert np.all(np.diff(key) > 0)
    assert np.all((key - 1) % 32 < 8)          # the first 8 of every 32
    assert key.max() == (sizes["orders"] - 1) // 8 * 32 \
        + (sizes["orders"] - 1) % 8 + 1


def test_lines_an_order_and_customers(host):
    li, o = host["lineitem"].columns, host["orders"].columns
    lines = np.unique(li["l_orderkey"], return_counts=True)[1]
    assert len(lines) == TINY["sizes"]["orders"]
    assert lines.min() == 1 and lines.max() == 7
    assert not np.any(o["o_custkey"] % 3 == 0)
    assert o["o_custkey"].max() <= TINY["sizes"]["customer"]
    nums = np.sort(li["l_linenumber"][li["l_orderkey"] == key_of(o, 0)])
    assert list(nums) == list(range(1, len(nums) + 1))


def key_of(o, i):
    return o["o_orderkey"][i]


def test_partsupp_and_lineitem_suppliers(host):
    ps, li = host["partsupp"].columns, host["lineitem"].columns
    s = TINY["sizes"]["supplier"]
    pk = ps["ps_partkey"]
    i = np.tile(np.arange(4), TINY["sizes"]["part"])
    assert np.array_equal(ps["ps_suppkey"],
                          (pk + i * (s // 4 + (pk - 1) // s)) % s + 1)
    assert len(np.unique(pk * (s + 1) + ps["ps_suppkey"])) == len(pk)
    pairs = set((pk * (s + 1) + ps["ps_suppkey"]).tolist())
    assert set((li["l_partkey"] * (s + 1) + li["l_suppkey"]).tolist()) \
        <= pairs


def test_prices(host):
    p, li = host["part"].columns, host["lineitem"].columns
    pk = p["p_partkey"]
    cents = 90000 + (pk // 10) % 20001 + 100 * (pk % 1000)
    assert np.array_equal(np.rint(p["p_retailprice"] * 100), cents)
    retail = cents[li["l_partkey"] - 1]
    assert np.array_equal(np.rint(li["l_extendedprice"] * 100),
                          li["l_quantity"].astype(np.int64) * retail)


def test_dates_and_flags(host):
    t = host["lineitem"]
    li = t.columns
    current = (np.datetime64("1995-06-17") - np.datetime64("1970-01-01")
               ).astype(int)
    flag = t.dicts["l_returnflag"][li["l_returnflag"]]
    assert set(flag[li["l_receiptdate"] > current]) == {"N"}
    assert set(flag[li["l_receiptdate"] <= current]) == {"A", "R"}
    status = t.dicts["l_linestatus"][li["l_linestatus"]]
    assert np.array_equal(status == "O", li["l_shipdate"] > current)
    assert np.all(li["l_receiptdate"] > li["l_shipdate"])
    o = host["orders"]
    st = o.dicts["o_orderstatus"][o.columns["o_orderstatus"]]
    assert set(st) == {"F", "O", "P"}


def test_strings(host):
    s = host["supplier"]
    comments = s.dicts["s_comment"][s.columns["s_comment"]]
    marked = [c for c in comments if "Customer" in c and (
        "Complaints" in c or "Recommends" in c)]
    assert len(marked) >= 2
    assert all(25 <= len(c) <= 100 for c in comments)
    p = host["part"]
    for name in p.dicts["p_name"][:50]:
        words = name.split(" ")
        assert len(words) == 5 and len(set(words)) == 5
    assert len(p.dicts["p_type"]) <= 150 and len(p.dicts["p_container"]) \
        <= 40
    c = host["customer"]
    phones = c.dicts["c_phone"][c.columns["c_phone"]]
    assert all(int(ph[:2]) == n + 10
               for ph, n in zip(phones[:200], c.columns["c_nationkey"]))
    li = host["lineitem"]
    assert all(10 <= len(v) <= 43 for v in li.dicts["l_comment"][:1000])


def test_dictionary_sorts_and_codes():
    rng = np.random.default_rng(3)
    import torch

    lens = torch.as_tensor(rng.integers(0, 20, 500))
    mat = torch.as_tensor(rng.integers(97, 100, (500, 19)), dtype=torch.uint8)
    mat[torch.arange(19)[None, :] >= lens[:, None]] = 0
    codes, values = tpch.dictionary(mat, lens)
    rows = ["".join(chr(b) for b in r[:n]) for r, n in
            zip(mat.tolist(), lens.tolist())]
    assert list(values) == sorted(set(rows))
    assert [values[c] for c in codes.tolist()] == rows


def test_reference_imports_nothing_of_the_program():
    code = ("import sys, port_bench.reference.tpch\n"
            "print(','.join(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'query_engine_tpu_torch', 'query_engine_tpu', 'jax', "
            "'jaxlib', 'flax', 'torch'})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def test_every_text_agrees(config, host):
    from query_engine_tpu_torch.engine.session import Session

    from port_bench.reference import tpch as reference

    spec, cell, _, mix = run.cell_files(CELL)
    texts = run.queries(config, mix)
    assert sorted(texts) == sorted(f"Q{i}" for i in range(1, 23))
    session = Session(device="cpu")
    run.register(session, tpch.generate(config, SEED, "cpu"), "cpu")
    nonempty = 0
    for q, text in texts.items():
        got = session.sql(text).to_pylist()
        want = reference.run(q, host)
        wrong, gap = compare(got, want, reference.ORDER[q])
        assert not wrong, (q, got[:3], want[:3])
        assert gap <= 1e-10, (q, gap)
        nonempty += bool(want) and want != [(None,)]
    assert nonempty >= 18
    assert session.executor.pipeline.stats["cross_joins"] == 0


@pytest.mark.parametrize("trace", [False, True], ids=["timed", "traced"])
def test_run_on_the_cpu_is_correct(config, trace):
    spec, cell, _, mix = run.cell_files(CELL)
    result, lines = run.run_cell(spec, cell, config, mix, SEED, 0.5, trace,
                                 "cpu", t0=time.perf_counter())
    assert result["correct"], lines
    assert result["attempted"] >= 22 and result["failed"] == 0
    section = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in spec[section] if run.reports(m, CELL)
            and m["source"] != "device_trace"}
    assert set(result["metrics"]) == want
    if trace:
        assert result["metrics"]["cross_joins_per_query.star"]["value"] == 0
        assert result["metrics"]["like_values_per_query.star"]["value"] > 0


def test_control_is_not_correct(config, host):
    reference = importlib.import_module(config["reference"])
    mix = run.cell_files(CELL)[3]
    r = control.readings(reference, host,
                         list(dict.fromkeys(mix["statements"])))
    limits = config["limits"]
    assert any(r[k] > limits[k] for k in limits), r


CODE = """
import json, sys, time
from port_bench import run
from port_bench.tests.test_pb_tpch import CELL, tiny
from port_bench.tests.conftest import SEED
spec, cell, config, mix = run.cell_files(CELL)
result, lines = run.run_cell(spec, cell, tiny(config), mix, SEED, 1.0,
                             sys.argv[1] == "1", "cuda",
                             t0=time.perf_counter())
print(json.dumps(result))
"""


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [False, True], ids=["timed", "traced"])
def test_tiny_run_on_the_card(trace, cuda_device):
    out = subprocess.run([sys.executable, "-c", CODE, str(int(trace))],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], out.stderr[-4000:]
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    section = "per_layer" if trace else "end_to_end"
    assert set(result["metrics"]) == {
        m["name"] for m in spec[section] if CELL in m.get("workloads", [CELL])}
