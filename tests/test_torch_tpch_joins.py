"""TPC-H Q3 and Q18 through both packages' ``run_plan`` on the CPU, on
seeded lineitem, orders and customer tables: row for row, decimal, date,
string and integer columns equal, DOUBLE to ``rtol=1e-9``.

Plan shapes: with ``optimize_plans`` on, every join is a merge join and
every aggregation a streaming one; with it off, hash joins and the generic
sort-based aggregation. At SF 0.01 no order passes Q18's ``> 300``, so a
Q18-shaped plan at ``> 250`` feeds real rows to the HAVING, the joins and
the top-N; 4096-row splits make streaming groups and merge runs cross
batch boundaries, and a zero kArray span sends the joins through the
binary-search and flipped-merge probes instead of the direct table. The
JAX package runs each query once per config, through its default plans;
every plan shape and split size of the port is held against those rows."""

import contextlib

import numpy as np
import pytest

from torch_tpch_data import CONFIGS, tables_in_both
from velox_tpu.exec import run_plan as jax_run_plan
from velox_tpu.plan import PlanBuilder as JaxPlanBuilder
from velox_tpu.tpch import tpch_plan as jax_tpch_plan
from velox_tpu.utils.config import config as jax_config
from velox_tpu_torch.exec import run_plan as torch_run_plan
from velox_tpu_torch.exec.task import Task
from velox_tpu_torch.plan import PlanBuilder as TorchPlanBuilder
from velox_tpu_torch.tpch import tpch_plan as torch_tpch_plan
from velox_tpu_torch.utils.config import config as torch_config

NARROW_CENTS = (True, "cents")

def q18_shaped(builder, min_quantity: float):
    """Q18 (``velox_tpu/tpch/queries.py``) with its HAVING threshold as a
    parameter, in either package's PlanBuilder."""
    big_orders = (
        builder()
        .table_scan("lineitem", columns=["l_orderkey", "l_quantity"])
        .aggregate(["l_orderkey"], ["sum(l_quantity) AS total_qty"])
        .filter(f"total_qty > {min_quantity}")
        .project(["l_orderkey AS big_okey"]))
    orders = (
        builder()
        .table_scan("orders",
                    columns=["o_orderkey", "o_custkey", "o_orderdate",
                             "o_totalprice"])
        .hash_join(big_orders, ["o_orderkey"], ["big_okey"], "left_semi")
        .hash_join(
            builder().table_scan(
                "customer", columns=["c_custkey", "c_name"]),
            ["o_custkey"], ["c_custkey"], "inner",
            output=["o_orderkey", "o_orderdate", "o_totalprice",
                    "c_custkey", "c_name"]))
    return (
        builder()
        .table_scan("lineitem", columns=["l_orderkey", "l_quantity"])
        .hash_join(orders, ["l_orderkey"], ["o_orderkey"], "inner",
                   output=["l_quantity", "o_orderkey", "o_orderdate",
                           "o_totalprice", "c_custkey", "c_name"])
        .aggregate(
            ["c_name", "c_custkey", "o_orderkey", "o_orderdate",
             "o_totalprice"],
            ["sum(l_quantity) AS sum_qty"])
        .top_n(["o_totalprice DESC", "o_orderdate"], 100)
        .project(["c_name", "c_custkey", "o_orderkey", "o_orderdate",
                  "o_totalprice", "sum_qty"])
    )


@contextlib.contextmanager
def both_configs(**settings):
    old = {k: (getattr(jax_config, k), getattr(torch_config, k))
           for k in settings}
    for k, v in settings.items():
        setattr(jax_config, k, v)
        setattr(torch_config, k, v)
    try:
        yield
    finally:
        for k, (j, t) in old.items():
            setattr(jax_config, k, j)
            setattr(torch_config, k, t)


def _assert_same(got: dict, exp: dict, floats: bool):
    assert list(got) == list(exp)
    for c in exp:
        assert len(got[c]) == len(exp[c]), c
        if floats and exp[c] and isinstance(exp[c][0], float):
            np.testing.assert_allclose(got[c], exp[c], rtol=1e-9,
                                       err_msg=c)
        else:
            assert got[c] == exp[c], c


@pytest.fixture(scope="module")
def expected():
    """The JAX package's rows, keyed by query and config, each computed
    once through its default (merge, streaming) plans and shared by the
    cases that must give the same rows: the plan shape, the split size
    and the join probe form do not change a query's answer. Where ties
    could order rows differently in another plan shape, a difference
    fails the case; it cannot pass unseen."""
    return {}


def _jax_rows(expected, key, jax_plan) -> dict:
    """``jax_plan()``'s rows, run once per key while the tables are
    registered at the default split size."""
    if key not in expected:
        expected[key] = jax_run_plan(jax_plan().build()).to_pydict()
    return expected[key]


def _rows(result: dict) -> int:
    return len(next(iter(result.values())))


def _operators(plan) -> set:
    return {type(op).__name__ for p in Task(plan.build()).planner.pipelines
            for op in p.operators}


@pytest.fixture(scope="module", params=CONFIGS,
                ids=[f"{'narrow' if n else 'wide'}-{m}" for n, m in CONFIGS])
def config_tables(request):
    with tables_in_both(*request.param):
        yield request.param


def test_q3_q18_match_jax(config_tables, expected):
    floats = config_tables[1] == "double"
    for q in (3, 18):
        exp = _jax_rows(expected, (q, config_tables),
                        lambda: jax_tpch_plan(q))
        _assert_same(torch_run_plan(torch_tpch_plan(q)), exp, floats)
        assert _rows(exp) == (10 if q == 3 else 0)
    ops = _operators(torch_tpch_plan(18)) | _operators(torch_tpch_plan(3))
    assert {"MergeJoinBuildOp", "MergeJoinProbeOp",
            "StreamingAggregationOp"} <= ops
    assert not {"HashBuildOp", "HashProbeOp", "HashAggregationOp"} & ops


def test_q3_q18_hash_plans_match_jax(expected):
    with tables_in_both(*NARROW_CENTS):
        exps = {q: _jax_rows(expected, (q, NARROW_CENTS),
                             lambda: jax_tpch_plan(q)) for q in (3, 18)}
        with both_configs(optimize_plans=False):
            for q, exp in exps.items():
                _assert_same(torch_run_plan(torch_tpch_plan(q)), exp, False)
            ops = _operators(torch_tpch_plan(18)) | _operators(
                torch_tpch_plan(3))
    assert {"HashBuildOp", "HashProbeOp", "HashAggregationOp"} <= ops
    assert not {"MergeJoinBuildOp", "StreamingAggregationOp"} & ops


def _q18_250(expected) -> dict:
    return _jax_rows(expected, ("q18_250", NARROW_CENTS),
                     lambda: q18_shaped(JaxPlanBuilder, 250.0))


@pytest.mark.parametrize("optimize", [True, False])
def test_q18_shaped_matches_jax(expected, optimize):
    with tables_in_both(*NARROW_CENTS):
        exp = _q18_250(expected)
        with both_configs(optimize_plans=optimize):
            got = torch_run_plan(q18_shaped(TorchPlanBuilder, 250.0))
    _assert_same(got, exp, False)
    assert 50 < _rows(exp) <= 100


@pytest.mark.parametrize("span", [1 << 26, 0], ids=["table", "search"])
def test_small_splits_match_jax(expected, span):
    with tables_in_both(*NARROW_CENTS):
        exps = {3: _jax_rows(expected, (3, NARROW_CENTS),
                             lambda: jax_tpch_plan(3)),
                18: _q18_250(expected)}
    with tables_in_both(*NARROW_CENTS, batch_rows=1 << 12), \
            both_configs(karray_join_span=span):
        _assert_same(torch_run_plan(torch_tpch_plan(3)), exps[3], False)
        _assert_same(torch_run_plan(q18_shaped(TorchPlanBuilder, 250.0)),
                     exps[18], False)


def test_bloom_pushdown_matches_jax(expected, monkeypatch):
    """Builds over 16 keys push a min/max range and a bloom filter into
    the probe's scan instead of an exact IN-table (the path SF10 builds
    take); the rows stay the JAX package's."""
    from velox_tpu_torch.exec.operators import HashProbeOp

    monkeypatch.setattr(HashProbeOp, "_SET_PUSH_MAX", 16)
    with tables_in_both(*NARROW_CENTS):
        for optimize in (True, False):
            with both_configs(optimize_plans=optimize):
                _assert_same(torch_run_plan(torch_tpch_plan(3)),
                             _jax_rows(expected, (3, NARROW_CENTS),
                                       lambda: jax_tpch_plan(3)), False)
                _assert_same(
                    torch_run_plan(q18_shaped(TorchPlanBuilder, 250.0)),
                    _q18_250(expected), False)


def test_limit_matches_jax():
    """An offset and a limit that cross 4096-row splits, over a filtered
    scan (selections with holes)."""
    def plan(builder):
        return (builder()
                .table_scan("lineitem",
                            columns=["l_orderkey", "l_quantity",
                                     "l_shipdate"],
                            subfilter="l_shipdate > DATE '1995-03-15'")
                .limit(5000, offset=3000))

    with tables_in_both(*NARROW_CENTS, batch_rows=1 << 12):
        exp = jax_run_plan(plan(JaxPlanBuilder).build()).to_pydict()
        got = torch_run_plan(plan(TorchPlanBuilder))
    _assert_same(got, exp, False)
    assert _rows(exp) == 5000
