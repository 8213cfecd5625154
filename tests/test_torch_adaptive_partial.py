"""Adaptive partial aggregation in the port, against the JAX package: a
PARTIAL step that does not reduce (groups / rows at least
``abandon_partial_agg_min_pct`` once ``abandon_partial_agg_min_rows``
rows went by) stops grouping and forwards every row as its own group,
and the FINAL step's rows stay right. The counterparts of
``tests/test_adaptive_partial.py``'s two tests, with the abandoned flag
and the rows equal to the JAX package's (DOUBLE to rtol 1e-9), with
``narrow_lanes`` on and off.

Where the port departs from the reference: the JAX package's fused
scan -> PARTIAL operator (``exec/fused.py``: a PARTIAL step that ends
its pipeline) never checks, so it never abandons there; the port's fused
operator runs the same per-batch step as the unfused one, and abandons.

The last test runs the chip check's phase-12 plans at SF 0.01 against
their numpy oracles.
"""

import numpy as np
import pytest

from torch_tpch_data import assert_same, table_in_both, values_in_both
from velox_tpu.exec import run_plan as jax_run_plan
from velox_tpu.exec.task import Task as JaxTask
from velox_tpu.plan import PlanBuilder as JaxPlanBuilder
from velox_tpu.utils.config import config as jax_config
from velox_tpu_torch.exec.task import Task as TorchTask
from velox_tpu_torch.plan import PlanBuilder as TorchPlanBuilder
from velox_tpu_torch.tpch.agg_step_plans import partial_ops
from velox_tpu_torch.utils.config import config as torch_config

AGGS = ["sum(v) as s", "count(v) as c", "min_by(k, v) as mb"]


@pytest.fixture
def small_threshold(monkeypatch):
    for cfg in (jax_config, torch_config):
        monkeypatch.setattr(cfg, "abandon_partial_agg_min_rows", 256)
        monkeypatch.setattr(cfg, "abandon_partial_agg_min_pct", 0.8)


def _rows(task):
    out = {n: [] for n in task.plan.output_type.names}
    for b in task.run():
        for n, vals in b.to_pydict().items():
            out[n].extend(vals)
    return out


def _run_both(ks, vs, narrow, monkeypatch, n_batches=4):
    """The same PARTIAL -> FINAL plan over the same four value batches
    in both packages: each one's rows and whether its PARTIAL step
    abandoned."""
    monkeypatch.setattr(jax_config, "narrow_lanes", narrow)
    monkeypatch.setattr(torch_config, "narrow_lanes", narrow)
    jb, tb = values_in_both({"k": ks, "v": vs},
                            batch_rows=len(ks) // n_batches)
    jtask = JaxTask(JaxPlanBuilder().values(jb).partial_aggregation(
        ["k"], AGGS).final_aggregation().build())
    exp = _rows(jtask)
    jops = [op for p in jtask.planner.pipelines for op in p.operators
            if type(op).__name__ == "HashAggregationOp"
            and op.step.value == "partial"]
    ttask = TorchTask(TorchPlanBuilder().values(tb).partial_aggregation(
        ["k"], AGGS).final_aggregation().build())
    got = _rows(ttask)
    (top,) = partial_ops(ttask)
    return got, exp, top, jops[0]


@pytest.mark.parametrize("narrow", [True, False])
def test_high_cardinality_abandons(small_threshold, narrow, monkeypatch):
    n = 2048
    rng = np.random.default_rng(5)
    ks = rng.permutation(n).astype(np.int64)       # all-distinct keys
    vs = rng.normal(size=n)
    got, exp, top, jop = _run_both(ks, vs, narrow, monkeypatch)
    assert top.abandoned and jop.abandoned
    assert top.runtime == {"abandoned_partial_agg": 1.0}
    assert jop.stats.runtime["abandoned_partial_agg"] == 1.0
    assert_same(got, exp, "abandoned")
    order = np.argsort(ks)
    assert got["k"] == ks[order].tolist()
    np.testing.assert_allclose(got["s"], vs[order], rtol=1e-9)
    assert got["c"] == [1] * n and got["mb"] == got["k"]


@pytest.mark.parametrize("narrow", [True, False])
def test_low_cardinality_keeps_aggregating(small_threshold, narrow,
                                          monkeypatch):
    n = 2048
    rng = np.random.default_rng(6)
    ks = rng.integers(0, 8, n).astype(np.int64)
    vs = rng.normal(size=n)
    got, exp, top, jop = _run_both(ks, vs, narrow, monkeypatch)
    assert not top.abandoned and not jop.abandoned
    assert top.runtime == {}
    assert_same(got, exp, "kept")
    assert got["c"] == np.bincount(ks).tolist()


def test_the_check_is_one_sync_after_min_rows(small_threshold,
                                              monkeypatch):
    """The step checks once, after the first batch that brings it to
    ``abandon_partial_agg_min_rows``, and reads rows and groups in one
    host sync; a low threshold ratio abandons a reducing step too."""
    from velox_tpu_torch.utils import syncs

    rng = np.random.default_rng(7)
    ks = rng.integers(0, 100, 2048).astype(np.int64)
    vs = rng.normal(size=2048)
    _, tb = values_in_both({"k": ks, "v": vs}, batch_rows=128)
    counts = {}
    for pct in (0.8, 0.5):
        monkeypatch.setattr(torch_config, "abandon_partial_agg_min_pct",
                            pct)
        task = TorchTask(TorchPlanBuilder().values(tb).partial_aggregation(
            ["k"], ["sum(v) AS s"]).build())
        syncs.reset()
        batches = list(task.run())
        counts[pct] = syncs.count
        (op,) = partial_ops(task)
        # 128-row batches: the check comes with the second batch, where
        # about 70 of 128 rows are distinct groups
        assert op.abandoned == (pct == 0.5) and op._abandon_checked
        assert len(batches) == 16
    assert counts[0.8] == counts[0.5] == 1


def test_fused_partial_abandons_as_unfused(small_threshold, monkeypatch):
    """A PARTIAL step that ends its pipeline runs fused with its scan.
    The port's fused step abandons as the unfused one does, batch for
    batch (the JAX package's fused step never checks); in a two-step
    plan the PARTIAL step runs unfused in both packages, both abandon,
    and their rows equal the single step's."""
    n = 2048
    rng = np.random.default_rng(8)
    cols = {"k": rng.permutation(n).astype(np.int64),
            "v": rng.normal(size=n)}
    with table_in_both("ap", cols, batch_rows=512):
        outs = []
        for fused in (True, False):
            monkeypatch.setattr(torch_config, "fused_pipelines", fused)
            task = TorchTask(TorchPlanBuilder().table_scan("ap")
                             .partial_aggregation(["k"], AGGS).build())
            outs.append([b.to_pydict() for b in task.run()])
            (op,) = partial_ops(task)
            assert op.abandoned
            assert (type(task.planner.operators[-1]).__name__
                    == ("FusedScanAggOp" if fused else "HashAggregationOp"))
        assert len(outs[0]) == len(outs[1]) == 4
        for a, b in zip(*outs):
            assert_same(a, b, "fused")
        jtask = JaxTask(JaxPlanBuilder().table_scan("ap").partial_aggregation(
            ["k"], AGGS).build())
        list(jtask.run())
        (jfused,) = jtask.planner.pipelines[-1].operators
        assert type(jfused).__name__ == "FusedScanAggOp"
        assert not jfused.agg.abandoned
        single = jax_run_plan(JaxPlanBuilder().table_scan("ap").aggregate(
            ["k"], AGGS).build()).to_pydict()
        got, exp, top, jop = _run_both(cols["k"], cols["v"], False,
                                       monkeypatch)
    assert top.abandoned and jop.abandoned
    assert_same(got, single, "two-step abandoned")
    assert_same(exp, single, "reference two-step")


def test_chip_check_plans_match_their_oracles(monkeypatch):
    """The chip check's phase-12 plans (``tpch/agg_step_plans.py``) at SF
    0.01 in 16384-row splits (the abandon threshold cut to one split),
    against their numpy oracles: two-step Q18's inner aggregation keeps
    aggregating, the unique key abandons, and every family by every
    grouping, in one step and two, runs in its mode and equals its
    oracle."""
    from velox_tpu_torch.exec.task import Task
    from velox_tpu_torch.io import catalog
    from velox_tpu_torch.io.tpch import (
        as_money_schema, table_dictionaries, tpch_columns,
    )
    from velox_tpu_torch.tpcds.window_plans import result_columns
    from velox_tpu_torch.tpch import agg_step_plans as asp
    from velox_tpu_torch.tpch import join_agg_plans as ja

    split = 1 << 14
    monkeypatch.setattr(torch_config, "narrow_lanes", True)
    monkeypatch.setattr(torch_config, "abandon_partial_agg_min_rows", split)
    tables, dicts = tpch_columns(0.01, 20240601, ["lineitem"])
    li = tables["lineitem"]
    cols, overrides = as_money_schema(li, "cents")
    catalog.register_columns("lineitem", cols, table_dictionaries(
        li, dicts), split, overrides, device="cpu")
    try:
        for make, abandons in ((asp.plan_q18_inner, False),
                               (asp.plan_unique, True)):
            plan = make(TorchPlanBuilder).build()
            task = Task(plan)
            got = result_columns(task, list(plan.output_type.names))
            single = result_columns(make(TorchPlanBuilder, False).build(),
                                    list(plan.output_type.names))
            assert all(np.array_equal(got[n][0], single[n][0])
                       for n in got)
            (op,) = partial_ops(task)
            assert op.abandoned == abandons
        assert len(got["sq"][0]) == len(li["l_orderkey"])
        rows, hashes = {}, {}
        modes = {"q1_keys": "kArray", "suppkey": "generic",
                 "orderkey": "streaming", "keyless": "generic"}
        for grouping, keys in asp.M_GROUPINGS.items():
            oracle = asp.GroupOracle(grouping, asp.m_rows(li, grouping, rows),
                                     asp.m_arguments(li), dicts, split,
                                     hashes)
            for family in asp.FAMILIES:
                for two_step in (False, True) if (
                        grouping == "suppkey"
                        and family in asp.TWO_STEP_FAMILIES) else (False,):
                    plan = asp.plan_family(TorchPlanBuilder, grouping,
                                           family, two_step).build()
                    task = Task(plan)
                    got = {n: (v, m) for n, (v, m, _) in result_columns(
                        task, list(plan.output_type.names)).items()}
                    err, _ = ja.check_aggregates(
                        got, oracle.family(family, two_step), keys)
                    assert err is None, (grouping, family, two_step, err)
                    assert ja.aggregation_mode(task) == modes[grouping]
    finally:
        catalog.drop_table("lineitem")
