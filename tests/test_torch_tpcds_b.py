"""The second half of the 15 TPC-DS spec-subset queries (q43, q48, q52,
q53, q55, q63, q65, q96) against the JAX package on the CPU at SF 0.01,
as ``test_torch_tpcds.py`` runs the first: the JAX package once per
query, the port with ``optimize_plans`` on and off, and the numpy oracle,
each equal to the JAX rows (integers, strings and row order exactly,
DOUBLE to rtol=1e-9). q53 and q63 run the window operator and ``abs``."""

import pytest

from torch_tpch_data import assert_same, tpcds_in_both
from velox_tpu.exec import run_plan as jax_run_plan
from velox_tpu.tpcds import tpcds_plan as jax_tpcds_plan
from velox_tpu_torch.exec import run_plan as torch_run_plan
from velox_tpu_torch.tpcds import tpcds_plan as torch_tpcds_plan
from velox_tpu_torch.tpcds.oracle import answer
from velox_tpu_torch.utils.config import config as torch_config

QUERIES = [43, 48, 52, 53, 55, 63, 65, 96]


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
