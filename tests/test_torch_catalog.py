"""The port's catalog against the JAX package's: ``register_columns`` must
produce exactly the splits ``register_arrow`` produces from the same data
(capacities, dictionaries, stats, ordering facts, lane dtypes, values)."""

import numpy as np
import pytest
import torch

from torch_tpch_data import CONFIGS, lineitem_in_both
from velox_tpu.io.catalog import get_table as jax_get_table
from velox_tpu_torch.io.catalog import get_table as torch_get_table
from velox_tpu_torch.io.catalog import register_columns


@pytest.mark.parametrize("narrow,money", CONFIGS)
def test_register_columns_matches_register_arrow(narrow, money):
    with lineitem_in_both(narrow, money):
        jt, tt = jax_get_table("lineitem"), torch_get_table("lineitem")
        assert tt.sorted_cols == jt.sorted_cols
        assert tt.unique_cols == jt.unique_cols
        assert list(tt.schema.names) == list(jt.schema.names)
        assert [str(t) for t in tt.schema.children] == \
            [str(t) for t in jt.schema.children]
        assert len(tt.batches) == len(jt.batches) > 1
        for tb, jb in zip(tt.batches, jt.batches):
            assert tb.capacity == jb.capacity
            assert tb.num_rows == jb.num_rows
            np.testing.assert_array_equal(tb.sel.numpy(), np.asarray(jb.sel))
            for name, jc in jb.columns.items():
                tc = tb.columns[name]
                assert str(tc.dtype) == str(jc.dtype), name
                assert tc.stats == jc.stats, name
                jv = np.asarray(jc.values)
                assert tc.values.numpy().dtype == jv.dtype, name
                np.testing.assert_array_equal(tc.values.numpy(), jv)
                assert (tc.valid is None) == (jc.valid is None), name
                if jc.dictionary is None:
                    assert tc.dictionary is None, name
                else:
                    assert list(tc.dictionary.values) == \
                        list(jc.dictionary.values), name


def test_ragged_tail_and_unsorted_dictionary():
    codes = np.array([2, 0, -1, 1, 2], dtype=np.int32)
    t = register_columns(
        "t_tail", {"s": codes, "k": np.arange(5, dtype=np.int64)},
        {"s": ["zeta", "alpha", "mid", "unused"]}, batch_rows=3,
        device="cpu")
    try:
        assert [b.capacity for b in t.batches] == [128, 128]
        assert [b.num_rows for b in t.batches] == [3, 2]
        d = t.batches[0].columns["s"].dictionary
        assert list(d.values) == ["alpha", "mid", "zeta"]
        got = torch.cat([b.columns["s"].values[:b.num_rows]
                         for b in t.batches]).tolist()
        assert [d.values[c] if c >= 0 else None for c in got] == \
            ["mid", "zeta", None, "alpha", "mid"]
        assert t.batches[1].columns["k"].values[2:].eq(4).all()
        assert t.sorted_cols == t.unique_cols == frozenset({"k"})
    finally:
        from velox_tpu_torch.io.catalog import drop_table

        drop_table("t_tail")
