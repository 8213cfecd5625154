"""TPC-H Q2, Q11, Q13, Q15, Q16, Q17, Q20, Q21 and Q22 (the queries with
join filters, min/max, count distinct, left outer, anti and cross joins
and scalar subqueries) through both packages' ``run_plan`` on the CPU at
SF 0.01, on seeded copies of all eight tables, in the benchmark mode:
narrow lanes over decimal cents. Every column of these results is an
integer, decimal or string and must be equal, row order included.

The JAX package runs each query once, through its default plans. The
port runs it with ``optimize_plans`` on (merge joins and streaming
aggregation where the orderings allow) and off (hash joins, generic
aggregation), and the numpy oracle that ``chip_smoke.py`` holds the card
against (``velox_tpu_torch/tpch/oracle.py``) must give the same rows."""

import pytest

from torch_tpch_data import SF, assert_same, tables_in_both
from velox_tpu.exec import run_plan as jax_run_plan
from velox_tpu.tpch import tpch_plan as jax_tpch_plan
from velox_tpu_torch.exec import run_plan as torch_run_plan
from velox_tpu_torch.tpch import tpch_plan as torch_tpch_plan
from velox_tpu_torch.tpch.oracle import answer
from velox_tpu_torch.utils.config import config as torch_config

QUERIES = [2, 11, 13, 15, 16, 17, 20, 21, 22]


@pytest.fixture(scope="module")
def tpch():
    """The tables in both catalogs, narrow lanes over cents, and the JAX
    package's rows, each query's computed once when first asked for."""
    with tables_in_both(True, "cents") as (data, dicts):
        rows = {}

        def expected(q):
            if q not in rows:
                rows[q] = jax_run_plan(
                    jax_tpch_plan(q, SF).build()).to_pydict()
            return rows[q]

        yield data, dicts, expected


@pytest.mark.parametrize("q", QUERIES)
def test_query_matches_jax(tpch, q, monkeypatch):
    """Both plan shapes of the port, and the oracle, against one JAX
    run."""
    data, dicts, expected = tpch
    exp = expected(q)
    for optimize in (True, False):
        monkeypatch.setattr(torch_config, "optimize_plans", optimize)
        assert_same(torch_run_plan(torch_tpch_plan(q, SF)), exp,
                    f"Q{q} optimize_plans={optimize}")
    assert_same(answer(q, data, dicts, SF), exp, f"Q{q} oracle")
