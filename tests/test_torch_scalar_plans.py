"""The scalar-function phase of ``chip_smoke.py`` at SF 0.01 on the CPU:
each family of ``velox_tpu_torch/tpch/scalar_plans.py`` through the port
against its oracle (the one the card's run uses: numpy, scipy for the
probability family), and through the JAX package against the port; the
seeded timestamp table; and the aggregation by Q1's kArray keys.
Integers, dates, timestamps, booleans and NULL masks must be equal;
DOUBLE results to rtol=1e-12 against the oracles, the probability family
to its stated tolerance (rtol=1e-9, atol=1e-9), and the JAX package to
rtol=1e-9.

Against the JAX package: the date and timestamp families and the
aggregation. The math and bits families read decimals cast to DOUBLE,
which XLA computes as a multiplication by 0.01 fused into what follows
(``CAST(l_discount AS DOUBLE) - 0.05`` is -1.7e-18 at 5 cents), so
``floor``, ``round``, ``sign`` and the hash of the double differ at
some rows; the port's casts divide, and equal numpy's. Those functions
are held against the JAX package on DOUBLE inputs in
``test_torch_scalar_math.py`` and ``_bits.py``, the probability family
in ``_prob.py``, and ``rand`` draws differently in each package."""

import numpy as np
import pytest

import chip_smoke
from torch_tpch_data import SEED, assert_same, tables_in_both
from velox_tpu.exec import run_plan as jax_run_plan
from velox_tpu.plan import PlanBuilder as JaxPlanBuilder
from velox_tpu_torch.io.catalog import drop_table, register_columns
from velox_tpu_torch.exec import run_plan as torch_run_plan
from velox_tpu_torch.plan import PlanBuilder as TorchPlanBuilder
from velox_tpu_torch.tpcds.window_plans import compare, result_arrays
from velox_tpu_torch.tpch import scalar_plans as sp


@pytest.fixture(scope="module")
def tables():
    with tables_in_both(True, "cents", tables=["lineitem", "part"]) as t:
        yield t


@pytest.mark.parametrize("family", list(sp.FAMILIES))
def test_family_against_oracle_and_jax(tables, family):
    data, _ = tables
    make, columns = sp.FAMILIES[family]
    got = result_arrays(make(TorchPlanBuilder), columns)
    if family == "probability":
        want, tol = chip_smoke.probability_oracle(data["part"]), \
            chip_smoke.PROB_TOL
    else:
        want, tol = sp.ORACLES[family](data["lineitem"]), \
            {"rtol": chip_smoke.SCALAR_RTOL}
    assert compare({c: got[c] for c in want}, want, **tol) is None
    if family == "nulls":
        assert sp.check_random(got) is None
        assert (~got["nd"][1]).sum() > 0
    if family not in ("dates", "timestamps"):
        return
    exp = jax_run_plan(make(JaxPlanBuilder).build()).to_pydict()
    assert_same(torch_run_plan(make(TorchPlanBuilder)), exp, family)


def test_timestamp_table_against_oracle():
    cols = sp.timestamp_table_columns(1 << 12, SEED)
    register_columns(sp.TIMESTAMP_TABLE, cols, None, 1 << 10, None,
                     device="cpu")
    try:
        got = result_arrays(sp.plan_timestamp_table(TorchPlanBuilder),
                            list(sp.TIMESTAMP_TABLE_EXPRS))
    finally:
        drop_table(sp.TIMESTAMP_TABLE)
    assert compare(got, sp.oracle_timestamp_table(cols)) is None
    assert (cols["t"] < np.datetime64("1970-01-01")).sum() > 1000


def test_aggregate_against_oracle_and_jax(tables):
    data, dicts = tables
    got = torch_run_plan(sp.plan_aggregate(TorchPlanBuilder))
    assert got == sp.oracle_aggregate(data["lineitem"], dicts)
    exp = jax_run_plan(sp.plan_aggregate(JaxPlanBuilder).build()).to_pydict()
    assert_same(got, exp, "aggregate")
