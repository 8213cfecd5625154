"""``chip_smoke.py``'s phase-11 plans (``velox_tpu_torch/tpch/
join_agg_plans.py``) at SF 0.01 on the CPU, through both packages and
against their oracles: the full, right and right-semi joins with and
without their filters, with ``optimize_plans`` on and off; TPC-H Q13
with its predicate in the left join's filter, equal to Q13; and the 14
aggregates grouped by Q1's keys (kArray), ``l_suppkey`` (generic) and
``l_orderkey`` (streaming).

Where the JAX package is not the reference for an aggregate: it raises
on ``arbitrary`` over a VARCHAR, and XLA computes ``CAST(decimal AS
DOUBLE)`` as a multiplication by 0.01, which moves ``checksum``'s
``trunc(x * 1e6)`` by one in some rows; those two are held against the
oracles only (``checksum`` against a numpy splitmix64 written here). The
JAX package's other DOUBLE results agree to 1e-9 relative plus the
rounding the raw-moment formulas amplify in small groups (the oracle's
stated bound)."""

import numpy as np
import pytest

from torch_tpch_data import assert_same, tables_in_both
from velox_tpu.exec import run_plan as jax_run_plan
from velox_tpu.plan import PlanBuilder as JaxPlanBuilder
from velox_tpu_torch.exec import run_plan as torch_run_plan
from velox_tpu_torch.exec.task import Task
from velox_tpu_torch.plan import PlanBuilder as TorchPlanBuilder
from velox_tpu_torch.tpch import join_agg_plans as ja
from velox_tpu_torch.tpch.oracle import answer
from velox_tpu_torch.tpcds.window_plans import result_columns
from velox_tpu_torch.utils.config import config as torch_config

SPLIT_ROWS = 1 << 12
#: the aggregates the JAX package cannot be held to (see above)
NOT_JAX = ("arb_mode", "ck_price")


@pytest.fixture(scope="module")
def tpch():
    """The eight tables at SF 0.01 in both catalogs (cents, narrow lanes,
    4096-row splits: lineitem spans 15)."""
    with tables_in_both(True, "cents", batch_rows=SPLIT_ROWS) as tabs:
        yield tabs


@pytest.mark.parametrize("name", list(ja.JOINS))
def test_join_family_matches_jax_and_oracle(tpch, name, monkeypatch):
    tables, dicts = tpch
    make, oracle, kinds = ja.JOINS[name]
    for filtered in (False, True):
        want, seen = oracle(tables, dicts, filtered, SPLIT_ROWS)
        claimed = kinds + (ja.FILTERED_KINDS[name] if filtered else ())
        assert all(seen[k] > 0 for k in claimed), seen
        exp = jax_run_plan(make(JaxPlanBuilder, filtered).build()).to_pydict()
        assert_same(exp, want, f"{name} JAX against the oracle")
        for optimize in (True, False):
            monkeypatch.setattr(torch_config, "optimize_plans", optimize)
            task = Task(make(TorchPlanBuilder, filtered).build())
            got = ja.run_rows(task)
            what = f"{name} filtered={filtered} optimize={optimize}"
            assert_same(got, exp, what)
            pushed = ja.pushed_filters(task)
            assert len(pushed) == 1 and pushed[0].endswith(": none") == (
                name == "full"), (what, pushed)
            assert pushed[0].startswith(
                "MergeJoinProbeOp" if optimize else "HashProbeOp"), pushed


def test_q13_join_filter_equals_q13(tpch):
    tables, dicts = tpch
    want = answer(13, tables, dicts, 0.01)
    got = torch_run_plan(ja.plan_q13_join_filter(TorchPlanBuilder))
    assert_same(got, want, "port")
    assert_same(jax_run_plan(
        ja.plan_q13_join_filter(JaxPlanBuilder).build()).to_pydict(),
        want, "JAX")
    seen = ja.q13_kinds(tables, dicts)
    assert seen["probe_only"] > 0 and seen["filtered_out"] > 0


def _splitmix64(x: np.ndarray) -> np.ndarray:
    z = x.astype(np.int64).view(np.uint64)
    with np.errstate(over="ignore"):
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


@pytest.mark.parametrize("grouping", list(ja.GROUPINGS))
def test_aggregates_match_oracle(tpch, grouping):
    tables, dicts = tpch
    li = tables["lineitem"]
    keys = ja.GROUPINGS[grouping]
    args = ja.agg_arguments(li)
    want, (perm, starts) = ja.oracle_aggregates(li, grouping, args)
    mode = {"q1_keys": "kArray", "suppkey": "generic",
            "orderkey": "streaming"}[grouping]
    for part in ja.AGG_PARTS:
        plan = ja.plan_aggregates(TorchPlanBuilder, grouping, part).build()
        task = Task(plan)
        cols = result_columns(task, list(plan.output_type.names))
        assert ja.aggregation_mode(task) == mode, part
        got = {n: (v, m) for n, (v, m, _) in cols.items()}
        err, _ = ja.check_aggregates(got, want, keys)
        assert err is None, (part, err)
        order = np.lexsort([got[k][0] for k in reversed(keys)])
        for name, fn, a in ja.AGG_PARTS[part]:
            if fn == "checksum":
                v = args[a]
                if v.dtype.kind == "f":
                    v = (v * 1e6).astype(np.int64)
                h = np.add.reduceat(_splitmix64(v)[perm], starts)
                assert np.array_equal(got[name][0][order], h.view(np.int64))
        if "arb_mode" in cols:
            assert list(cols["arb_mode"][2].values) == dicts["l_shipmode"]


def _sorted_rows(rows: dict, keys) -> dict:
    order = sorted(range(len(rows[keys[0]])),
                   key=lambda r: tuple(rows[k][r] for k in keys))
    return {c: [v[r] for r in order] for c, v in rows.items()}


@pytest.mark.parametrize("grouping", list(ja.GROUPINGS))
def test_aggregates_match_jax(tpch, grouping):
    tables, _ = tpch
    keys = ja.GROUPINGS[grouping]
    want, _ = ja.oracle_aggregates(tables["lineitem"], grouping)
    for part in ja.AGG_PARTS:
        exp = _sorted_rows(jax_run_plan(ja.plan_aggregates(
            JaxPlanBuilder, grouping, part, NOT_JAX).build()).to_pydict(),
            keys)
        got = _sorted_rows(torch_run_plan(ja.plan_aggregates(
            TorchPlanBuilder, grouping, part, NOT_JAX)), keys)
        assert list(got) == list(exp)
        for c in exp:
            err = want[c][2] if c in want else None
            if err is None:
                assert got[c] == exp[c], (part, c)
                continue
            g = np.array([np.nan if v is None else v for v in got[c]])
            e = np.array([np.nan if v is None else v for v in exp[c]])
            assert np.array_equal(np.isnan(g), np.isnan(e)), (part, c)
            live = ~np.isnan(e)
            assert np.all(np.abs(g - e)[live] <= 1e-9 * np.abs(e[live])
                          + 2 * err[live]), (part, c)


def test_extract_formulas_against_scipy(tpch):
    """The variance family's and the moments' extract formulas equal
    numpy's var/std and scipy's sample skewness and kurtosis
    (bias=False) on groups by l_suppkey, to 1e-9."""
    tables, _ = tpch
    li = tables["lineitem"]
    perm, starts, _ = ja.group_rows(li, "suppkey")
    assert ja.scipy_agreement(ja.agg_arguments(li), perm, starts) <= 1e-9
