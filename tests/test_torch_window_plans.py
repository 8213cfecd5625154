"""The window-family plans ``chip_smoke.py`` runs over the full TPC-DS
``store_sales`` on the card (``velox_tpu_torch/tpcds/window_plans.py``:
W1 the blocking window with every function and frame, W2 the streaming
window, W3 TopNRowNumber, RowNumber, MarkDistinct, GroupId and UnionAll),
here at SF 0.01 on the CPU: the same plan text through both packages'
``run_plan``, equal row for row, and the port's result arrays equal to
the numpy oracle the card is held against (integers exactly, DOUBLE to
rtol=1e-9)."""

import pytest

from torch_tpch_data import assert_same, tpcds_in_both
from velox_tpu.exec import run_plan as jax_run_plan
from velox_tpu.plan import PlanBuilder as JaxPlanBuilder
from velox_tpu_torch.exec import run_plan as torch_run_plan
from velox_tpu_torch.plan import PlanBuilder as TorchPlanBuilder
from velox_tpu_torch.plan.nodes import StreamingWindowNode
from velox_tpu_torch.plan.optimizer import optimize_plan
from velox_tpu_torch.tpcds.window_plans import (
    ORACLES, PLANS, compare, result_arrays,
)


@pytest.fixture(scope="module")
def store_sales():
    with tpcds_in_both(batch_rows=1 << 13) as (tables, _):
        yield tables["store_sales"]


@pytest.mark.parametrize("name", list(PLANS))
def test_window_plan(store_sales, name):
    make, columns = PLANS[name]
    exp = jax_run_plan(make(JaxPlanBuilder).build()).to_pydict()
    assert_same(torch_run_plan(make(TorchPlanBuilder)), exp, name)
    err = compare(result_arrays(make(TorchPlanBuilder), columns),
                  ORACLES[name](store_sales))
    assert err is None, f"{name} against its oracle: {err}"
    if name == "W2":
        assert type(optimize_plan(make(TorchPlanBuilder).build())) \
            is StreamingWindowNode
