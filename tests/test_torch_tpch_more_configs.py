"""TPC-H Q8, Q11, Q14, Q17 and Q22 (decimal division, decimal times a
DOUBLE literal, the CASE that turns a decimal DOUBLE, decimal averages)
through both packages' ``run_plan`` on the CPU at SF 0.01 in the two
configurations besides the benchmark mode: wide lanes over decimal cents
(exact, row order included) and narrow lanes over DOUBLE money (DOUBLE
columns to rtol=1e-9, the rest exactly). The JAX package runs each query
once per configuration, through its default plans."""

import pytest

from torch_tpch_data import SF, assert_same, tables_in_both
from velox_tpu.exec import run_plan as jax_run_plan
from velox_tpu.tpch import tpch_plan as jax_tpch_plan
from velox_tpu_torch.exec import run_plan as torch_run_plan
from velox_tpu_torch.tpch import tpch_plan as torch_tpch_plan

QUERIES = [8, 11, 14, 17, 22]
CONFIGS = [(False, "cents"), (True, "double")]


@pytest.fixture(scope="module", params=CONFIGS,
                ids=["wide-cents", "narrow-double"])
def config_tables(request):
    with tables_in_both(*request.param):
        yield request.param


@pytest.mark.parametrize("q", QUERIES)
def test_query_matches_jax(config_tables, q):
    exp = jax_run_plan(jax_tpch_plan(q, SF).build()).to_pydict()
    assert_same(torch_run_plan(torch_tpch_plan(q, SF)), exp,
                f"Q{q} {config_tables}")
