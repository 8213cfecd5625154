"""The port's TPC-DS generator and the first half of the 15 spec-subset
queries against the JAX package on the CPU.

The generator must equal ``velox_tpu.io.tpcds.generate_tpcds`` column for
column at two scale factors, and the tables both catalogs register from
them must hold equal splits (strings as equal dictionary codes, dates as
DATE days). Then q3, q7, q13, q19, q27, q28 and q42 run at SF 0.01, where
each returns rows, through both packages' ``run_plan``: the JAX package
once, the port with ``optimize_plans`` on and off, and the numpy oracle
(``velox_tpu_torch/tpcds/oracle.py``) that ``chip_smoke.py`` holds the
card against, each equal to the JAX rows (integers, strings and row
order exactly, DOUBLE to rtol=1e-9). ``test_torch_tpcds_b.py`` holds the
other eight."""

import numpy as np
import pytest

from torch_tpch_data import TPCDS_SEED, assert_same, tpcds_in_both
from velox_tpu.exec import run_plan as jax_run_plan
from velox_tpu.io.catalog import get_table as jax_get_table
from velox_tpu.io.tpcds import generate_tpcds as jax_generate
from velox_tpu.tpcds import tpcds_plan as jax_tpcds_plan
from velox_tpu_torch.exec import run_plan as torch_run_plan
from velox_tpu_torch.io.catalog import get_table as torch_get_table
from velox_tpu_torch.io.tpcds import TABLES, generate_tpcds, tpcds_columns
from velox_tpu_torch.tpcds import tpcds_plan as torch_tpcds_plan
from velox_tpu_torch.tpcds.oracle import answer
from velox_tpu_torch.utils.config import config as torch_config

QUERIES = [3, 7, 13, 19, 27, 28, 42]


@pytest.mark.parametrize("sf", [0.005, 0.02])
def test_generator_matches_jax(sf):
    exp = jax_generate(sf, TPCDS_SEED)
    got = generate_tpcds(sf, TPCDS_SEED)
    assert list(got) == list(exp) == list(TABLES)
    for name, table in exp.items():
        assert list(got[name]) == table.column_names, name
        for c in table.column_names:
            want = table.column(c).to_numpy(zero_copy_only=False)
            have = got[name][c]
            if isinstance(have, list):      # a string column
                have = np.asarray(have, dtype=object)
            if want.dtype.kind == "M":
                want = want.astype("datetime64[D]")
            assert have.dtype == want.dtype, (name, c)
            np.testing.assert_array_equal(have, want, err_msg=f"{name}.{c}")
    tables, dicts = tpcds_columns(sf, TPCDS_SEED)
    for name in TABLES:
        for c, v in tables[name].items():
            if c in dicts:
                v = np.asarray(dicts[c], dtype=object)[v]
            np.testing.assert_array_equal(
                v, np.asarray(got[name][c], dtype=v.dtype))
    with tpcds_in_both(sf, batch_rows=1 << 12, prefix="gen_"):
        for name in TABLES:
            jt, tt = jax_get_table("gen_" + name), torch_get_table(
                "gen_" + name)
            assert jt.sorted_cols == tt.sorted_cols, name
            assert len(jt.batches) == len(tt.batches), name
            for jb, tb in zip(jt.batches, tt.batches):
                assert jb.names == tb.names
                for c in jb.names:
                    j, t = jb.column(c), tb.column(c)
                    assert str(j.dtype) == str(t.dtype), (name, c)
                    np.testing.assert_array_equal(
                        t.values.numpy(), np.asarray(j.values),
                        err_msg=f"{name}.{c}")
                    if j.dictionary is not None:
                        assert list(t.dictionary.values) == list(
                            j.dictionary.values), (name, c)


@pytest.fixture(scope="module")
def tpcds():
    """The tables in both catalogs, and the JAX package's rows, each
    query's computed once when first asked for."""
    with tpcds_in_both() as (tables, dicts):
        rows = {}

        def expected(q):
            if q not in rows:
                rows[q] = jax_run_plan(jax_tpcds_plan(q).build()).to_pydict()
            return rows[q]

        yield tables, dicts, expected


@pytest.mark.parametrize("q", QUERIES)
def test_query_matches_jax(tpcds, q, monkeypatch):
    tables, dicts, expected = tpcds
    exp = expected(q)
    assert len(next(iter(exp.values()))) > 0, f"q{q} selects nothing"
    for optimize in (True, False):
        monkeypatch.setattr(torch_config, "optimize_plans", optimize)
        assert_same(torch_run_plan(torch_tpcds_plan(q)), exp,
                    f"q{q} optimize_plans={optimize}")
    assert_same(answer(q, tables, dicts), exp, f"q{q} oracle")
