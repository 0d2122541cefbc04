"""The port's columnar layer against the JAX package's: from_pydict /
to_pylist round trips, pad-row validity, select/take/slice/concat, and
from_numpy_batch from a JAX batch."""

import numpy as np
import pytest
import torch

import query_engine_tpu  # noqa: F401
from query_engine_tpu.columnar.batch import ColumnBatch as JBatch
from query_engine_tpu_torch.columnar.batch import (
    ColumnBatch, padded_capacity,
)
from query_engine_tpu_torch.columnar.convert import from_numpy_batch
from query_engine_tpu_torch.core.errors import SchemaError

DATA = {
    "id": [1, 2, 3, None, 5],
    "name": ["b", None, "a", "c", "a"],
    "score": [1.5, None, -2.25, 0.0, 7.0],
    "flag": [True, False, None, True, False],
}
BIG = {"x": list(range(300)), "s": [f"v{i % 7}" for i in range(300)]}


def _planes(b):
    """numpy (data, validity, dictionary values) of a JAX batch."""
    return [
        (np.asarray(c.data), np.asarray(c.validity),
         None if c.dictionary is None else c.dictionary.values)
        for c in b.columns
    ]


@pytest.mark.parametrize("data", [DATA, BIG, {"e": []}])
def test_from_pydict_round_trip_matches_jax(data):
    ref = JBatch.from_pydict(data)
    got = ColumnBatch.from_pydict(data)
    assert [str(f.data_type) for f in got.schema] == \
        [str(f.data_type) for f in ref.schema]
    assert got.num_rows == ref.num_rows
    assert got.capacity == ref.capacity == padded_capacity(ref.num_rows)
    assert got.to_pylist() == ref.to_pylist()
    assert got.to_pydict() == ref.to_pydict()
    for c, rc in zip(got.columns, ref.columns):
        assert isinstance(c.data, torch.Tensor)
        np.testing.assert_array_equal(c.np_validity(), rc.np_validity())
        np.testing.assert_array_equal(c.np_data(), rc.np_data())
        # pad rows are invalid
        assert not c.validity[got.num_rows:].any()


def test_select_take_slice_concat_match_jax():
    ref = JBatch.from_pydict(BIG)
    got = ColumnBatch.from_pydict(BIG)
    assert got.select([1]).to_pylist() == ref.select([1]).to_pylist()
    idx = np.array([5, 0, 299, 7, 7])
    t = got.take_host(idx)
    assert t.to_pylist() == ref.take_host(idx).to_pylist()
    assert t.capacity == 128 and not t.columns[0].validity[5:].any()
    assert got.slice(290, 20).to_pylist() == ref.slice(290, 20).to_pylist()
    other = {"x": [1000, None], "s": ["zz", "v3"]}
    cat = ColumnBatch.concat([got, ColumnBatch.from_pydict(other)])
    rcat = JBatch.concat([ref, JBatch.from_pydict(other)])
    assert cat.to_pylist() == rcat.to_pylist()
    assert list(cat.columns[1].dictionary.values) == \
        list(rcat.columns[1].dictionary.values)


def test_to_moves_planes_and_keeps_dictionaries():
    b = ColumnBatch.from_pydict(DATA)
    moved = b.to("cpu")
    assert moved.to_pylist() == b.to_pylist()
    assert moved.columns[1].dictionary is b.columns[1].dictionary


@pytest.mark.parametrize("data", [DATA, BIG])
def test_from_numpy_batch_from_jax_batch(data):
    ref = JBatch.from_pydict(data)
    got = from_numpy_batch(list(ref.schema), _planes(ref), ref.num_rows,
                           "cpu")
    assert got.to_pylist() == ref.to_pylist()
    assert got.schema.names() == ref.schema.names()
    assert [str(f.data_type) for f in got.schema] == \
        [str(f.data_type) for f in ref.schema]
    for c, (d, v, _) in zip(got.columns, _planes(ref)):
        assert c.data.device.type == "cpu"
        np.testing.assert_array_equal(c.np_data(), d)
        np.testing.assert_array_equal(c.np_validity(), v)


def test_from_numpy_batch_rejects_bad_planes():
    ref = JBatch.from_pydict(DATA)
    planes = _planes(ref)
    with pytest.raises(SchemaError):
        from_numpy_batch(list(ref.schema), planes[:2], ref.num_rows, "cpu")
    d, v, dv = planes[0]
    with pytest.raises(SchemaError):
        from_numpy_batch(list(ref.schema)[:1], [(d[:100], v[:100], dv)],
                         ref.num_rows, "cpu")
