"""The port's TPC-H generator: all eight tables register identically in
both packages' catalogs (capacities, lane dtypes, values, sorted
dictionaries, stats, ordering facts), and the lineitem, orders and
customer columns Q1, Q3, Q6 and Q18 read are bit-identical to those the
generator made before the other tables and columns existed (pinned
SHA-256 prefixes at SF 0.01, seed 20240601), so adding columns moved no
existing one."""

import hashlib

import numpy as np
import pytest

from torch_tpch_data import SEED, SF, tables_in_both
from velox_tpu.io.catalog import get_table as jax_get_table
from velox_tpu_torch.io.catalog import get_table as torch_get_table
from velox_tpu_torch.io.tpch import TABLES, tpch_columns

#: sha256(column bytes)[:16] of the columns as the three-table generator
#: made them
PINNED = {
    "c_custkey": "fb7b257e03ce330e", "c_mktsegment": "6fd91ba3e553da37",
    "c_name": "f8b22e13dd6b9629", "l_discount": "1d63a4cac93ee62c",
    "l_extendedprice": "f053a2bd0af8dc97", "l_linestatus": "70199ac1f48a4dca",
    "l_orderkey": "24c229eaa94cf512", "l_quantity": "72284d625d85dff7",
    "l_returnflag": "2e0a5913f6b9a3f9", "l_shipdate": "901a5da3548cc07e",
    "l_tax": "3029f3c4d6de8d50", "o_custkey": "9f2f36e6ea49b6d7",
    "o_orderdate": "0149d5a932289d93", "o_orderkey": "211762750ba2a2cc",
    "o_shippriority": "9a413b131ecf0ccf", "o_totalprice": "48892d51cedd420f",
}


@pytest.fixture(scope="module")
def generated():
    return tpch_columns(SF, SEED)


def test_existing_columns_are_unchanged(generated):
    tables, _ = generated
    for column, digest in PINNED.items():
        table = {"c": "customer", "l": "lineitem", "o": "orders"}[column[0]]
        data = np.ascontiguousarray(tables[table][column])
        assert hashlib.sha256(data.tobytes()).hexdigest()[:16] == digest, \
            column


def test_tables_subset_leaves_columns_unchanged(generated):
    tables, dicts = generated
    sub, sub_dicts = tpch_columns(SF, SEED, ["orders", "part"])
    assert list(sub) == ["orders", "part"]
    for name in sub:
        for c, v in sub[name].items():
            np.testing.assert_array_equal(v, tables[name][c], err_msg=c)
            if c in dicts:
                assert sub_dicts[c] == dicts[c], c


def test_generated_relations(generated):
    """The structural rules the queries depend on."""
    t, d = generated
    li, o, ps = t["lineitem"], t["orders"], t["partsupp"]
    # l_suppkey is one of the part's four partsupp suppliers
    pairs = set(zip(ps["ps_partkey"].tolist(), ps["ps_suppkey"].tolist()))
    assert len(pairs) == len(ps["ps_partkey"])
    assert all(p in pairs for p in zip(li["l_partkey"].tolist(),
                                       li["l_suppkey"].tolist()))
    # o_orderstatus: F when every line is F, O when every line is O
    starts = np.flatnonzero(np.diff(li["l_orderkey"], prepend=0))
    open_lines = np.add.reduceat(li["l_linestatus"].astype(np.int64),
                                 starts)
    lines = np.diff(np.append(starts, len(li["l_orderkey"])))
    status = np.asarray(d["o_orderstatus"])[o["o_orderstatus"]]
    assert ((status == "F") == (open_lines == 0)).all()
    assert ((status == "O") == (open_lines == lines)).all()
    assert (li["l_receiptdate"] > li["l_shipdate"]).all()
    comments = np.asarray(d["s_comment"], dtype=object)[
        t["supplier"]["s_comment"]]
    assert sum("Customer Complaints" in c for c in comments) >= 1
    # strings are codes into sorted value lists where the lists are made
    for c in ("o_comment", "c_comment", "c_phone", "p_name", "s_address"):
        assert d[c] == sorted(d[c]), c
        assert len(set(d[c])) == len(d[c]), c


@pytest.mark.parametrize("narrow,money", [(True, "cents"), (True, "double")])
def test_registration_matches_jax(narrow, money):
    with tables_in_both(narrow, money):
        for name in TABLES:
            jt, tt = jax_get_table(name), torch_get_table(name)
            assert tt.sorted_cols == jt.sorted_cols, name
            assert tt.unique_cols == jt.unique_cols, name
            assert list(tt.schema.names) == list(jt.schema.names), name
            assert [str(x) for x in tt.schema.children] == \
                [str(x) for x in jt.schema.children], name
            assert len(tt.batches) == len(jt.batches), name
            for tb, jb in zip(tt.batches, jt.batches):
                assert tb.capacity == jb.capacity, name
                assert tb.num_rows == jb.num_rows, name
                for col, jc in jb.columns.items():
                    tc = tb.columns[col]
                    assert tc.stats == jc.stats, col
                    jv = np.asarray(jc.values)
                    assert tc.values.numpy().dtype == jv.dtype, col
                    np.testing.assert_array_equal(tc.values.numpy(), jv,
                                                  err_msg=col)
                    if jc.dictionary is None:
                        assert tc.dictionary is None, col
                    else:
                        assert list(tc.dictionary.values) == \
                            list(jc.dictionary.values), col
