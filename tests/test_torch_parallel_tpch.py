"""TPC-H Q1, Q3, Q4 and Q6 at SF 0.01 through the port's
``run_plan_distributed`` and the JAX package's, on 8 shards: between them
they take all four strategies (serial fallback, distributed pipeline,
broadcast semi join, fused scan aggregation). Each result must equal the
JAX package's row for row (DOUBLE to rtol=1e-9) and the port's serial
result, with the same strategy in both packages
(``test_torch_parallel_plans.py`` holds the helpers and the other plan
shapes)."""

import pytest

from test_torch_parallel_plans import _check, meshes  # noqa: F401
from torch_tpch_data import assert_same, tables_in_both
from velox_tpu.tpch import tpch_plan as jax_tpch_plan
from velox_tpu_torch.exec import run_plan
from velox_tpu_torch.tpch import tpch_plan as torch_tpch_plan


@pytest.fixture(scope="module")
def tpch():
    with tables_in_both(True, "cents"):
        yield


@pytest.mark.parametrize("q,strategy", [
    (1, "serial_fallback"), (3, "distributed_pipeline"),
    (4, "broadcast_semi_join"), (6, "fused_scan_agg")])
def test_tpch_query_strategies(meshes, tpch, q, strategy):
    def make(pb, side):
        return (jax_tpch_plan, torch_tpch_plan)[side](q)

    got = _check(meshes, make, strategy)
    assert_same(got, run_plan(torch_tpch_plan(q)), f"Q{q} serial")
