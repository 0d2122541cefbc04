"""The generators repeat exactly from a seed and differ across seeds."""

import numpy as np
import pytest

from port_bench.data import ssb
from port_bench.tests.conftest import SEED, SSB_TINY

GENERATORS = [(ssb, SSB_TINY)]


def host(gen, config, seed):
    return {k: v.host() for k, v in gen.generate(config, seed, "cpu").items()}


@pytest.mark.parametrize("gen,config", GENERATORS, ids=["ssb"])
def test_same_seed_same_tables(gen, config):
    a, b = host(gen, config, SEED), host(gen, config, SEED)
    assert a.keys() == b.keys()
    for name in a:
        assert a[name].num_rows == b[name].num_rows
        for col, values in a[name].columns.items():
            assert np.array_equal(values, b[name].columns[col]), (name, col)
        for col, d in a[name].dicts.items():
            assert list(d) == list(b[name].dicts[col]), (name, col)


@pytest.mark.parametrize("gen,config", GENERATORS, ids=["ssb"])
def test_other_seed_other_tables_same_sizes(gen, config):
    a, b = host(gen, config, SEED), host(gen, config, SEED + 1)
    differ = 0
    for name in a:
        assert a[name].num_rows == b[name].num_rows, name
        for col, values in a[name].columns.items():
            differ += not np.array_equal(values, b[name].columns[col])
    assert differ > 10


@pytest.mark.parametrize("gen,config", GENERATORS, ids=["ssb"])
def test_dictionaries_sorted_and_codes_in_range(gen, config):
    for t in host(gen, config, SEED).values():
        for col, d in t.dicts.items():
            assert list(d) == sorted(d), (t.name, col)
            codes = t.columns[col]
            assert codes.min() >= 0 and codes.max() < len(d), (t.name, col)


def test_ssb_sizes_and_keys():
    t = host(ssb, SSB_TINY, SEED)
    sizes = SSB_TINY["sizes"]
    lo = t["lineorder"]
    assert lo.num_rows == sizes["lineorder"]
    assert len(np.unique(lo.columns["lo_orderkey"])) == sizes["orders"]
    lines = np.bincount(lo.columns["lo_orderkey"])[1:]
    assert lines.min() >= 1 and lines.max() <= 7
    assert lo.columns["lo_partkey"].max() <= sizes["part"]
    assert set(np.unique(lo.columns["lo_orderdate"])) <= set(
        t["date"].columns["d_datekey"])
    revenue = lo.columns["lo_extendedprice"] * (
        100 - lo.columns["lo_discount"]) // 100
    assert np.array_equal(revenue, lo.columns["lo_revenue"])
    assert t["date"].num_rows == 2556

