"""chip_smoke's phase-10 plans (``velox_tpu_torch/tpch/string_plans.py``)
at SF 0.01 through both packages and against their host oracles: each
string family's rows equal the JAX package's and its oracle's, and the
aggregation grouped by two transformed keys equals both with
``optimize_plans`` on and off, through the kArray path and one call of
the grouped-sum kernel B2's wrapper a split. The JAX rows are computed
once per module."""

import pytest

from torch_tpch_data import assert_same, tables_in_both
from velox_tpu.exec import run_plan as jax_run_plan
from velox_tpu.plan import PlanBuilder as JaxPlanBuilder
from velox_tpu_torch.exec import run_plan as torch_run_plan
from velox_tpu_torch.plan import PlanBuilder as TorchPlanBuilder
from velox_tpu_torch.tpcds.window_plans import result_columns
from velox_tpu_torch.tpch import string_plans as sp
from velox_tpu_torch.utils.config import config as torch_config

TABLES = ["lineitem", "orders", "customer", "part"]


@pytest.fixture(scope="module")
def tpch():
    with tables_in_both(True, "cents", tables=TABLES) as (data, dicts):
        yield data, dicts, {}


def _jax_rows(jax_rows, key, make):
    if key not in jax_rows:
        jax_rows[key] = jax_run_plan(make(JaxPlanBuilder).build()).to_pydict()
    return jax_rows[key]


@pytest.mark.parametrize("family", list(sp.FAMILIES))
def test_string_family_matches_jax_and_oracle(tpch, family):
    data, dicts, jax_rows = tpch
    make, table, oracle = sp.FAMILIES[family]
    got = torch_run_plan(make(TorchPlanBuilder).build())
    exp = _jax_rows(jax_rows, family, make)
    assert len(next(iter(exp.values()))) > 0, family
    assert_same(got, exp, family)
    want = oracle(data[table], dicts)
    cols = result_columns(make(TorchPlanBuilder).build(), list(want))
    assert sp.check(cols, want) is None, family


@pytest.mark.parametrize("optimize", [True, False])
def test_aggregate_by_transformed_keys(tpch, optimize, monkeypatch):
    from velox_tpu_torch.io.catalog import get_table
    from velox_tpu_torch.ops import grouped_sum

    data, dicts, jax_rows = tpch
    calls = []
    real = grouped_sum.grouped_multi_sum_i32

    def counted(*args):
        calls.append(1)
        return real(*args)

    monkeypatch.setattr(grouped_sum, "grouped_multi_sum_i32", counted)
    monkeypatch.setattr(torch_config, "optimize_plans", optimize)
    got = torch_run_plan(sp.plan_aggregate(TorchPlanBuilder).build())
    want = sp.oracle_aggregate(data["lineitem"], dicts)
    assert got == want
    assert_same(got, _jax_rows(jax_rows, "aggregate", sp.plan_aggregate),
                "aggregate")
    assert len(calls) == len(get_table("lineitem").batches)
