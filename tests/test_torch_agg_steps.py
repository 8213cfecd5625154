"""Two-step aggregation in the port: ``partial_aggregation(keys, aggs)
.final_aggregation()`` in the kArray, generic and keyless modes and
with a streaming FINAL step, held against the JAX package's single step
on the CPU, with ``narrow_lanes`` on and off, over 24-row splits with
NULLs (integers and decimals exactly, DOUBLE to rtol 1e-9).

Where the port departs from the reference: a kArray PARTIAL step in the
JAX package never emits its groups (``_add_array`` pushes no output and
``get_output`` returns None for a PARTIAL step), so its two-step result
is empty; the port's PARTIAL step emits the G groups' lanes once its
input ends, and its two-step rows equal the single step's.
"""

import numpy as np
import pytest

from torch_tpch_data import assert_same, table_in_both
from velox_tpu.exec import run_plan as jax_run_plan
from velox_tpu.plan import PlanBuilder as JaxPlanBuilder
from velox_tpu.utils.config import config as jax_config
from velox_tpu_torch.exec import run_plan as torch_run_plan
from velox_tpu_torch.exec.task import Task
from velox_tpu_torch.plan import PlanBuilder as TorchPlanBuilder
from velox_tpu_torch.plan.nodes import StreamingAggregationNode
from velox_tpu_torch.utils.config import config as torch_config

WORDS = ["kiwi", "apple", "pear", "fig"]

#: NULL where f = 1; d is DECIMAL(12, 2) cents
PROJECT = ["k", "s", "m",
           "CASE WHEN f = 1 THEN NULL ELSE x END AS x",
           "CASE WHEN f = 1 THEN NULL ELSE i END AS i",
           "CASE WHEN f = 2 THEN NULL ELSE d END AS d",
           "CASE WHEN f = 3 THEN NULL ELSE i > 0 END AS b"]

AGGS = ["sum(d) AS sd", "sum(i) AS si", "count(*) AS n", "count(x) AS nx",
        "avg(d) AS ad", "avg(x) AS ax", "min(i) AS mi", "max(d) AS xd",
        "count_if(b) AS cb", "var_samp(x) AS vx", "bool_and(b) AS ba",
        "checksum(i) AS ck", "geometric_mean(x) AS gm", "kurtosis(x) AS ku"]

#: all-additive integer aggregates: B2's layout in a kArray step
ADDITIVE = ["sum(d) AS sd", "count(*) AS n", "avg(i) AS ai",
            "count(i) AS ni"]

MODES = {"karray": ["s"], "generic": ["k"], "keyless": []}


def _table():
    rng = np.random.default_rng(20261017)
    sizes = np.resize([1, 2, 3, 5, 8], 30)
    k = np.repeat(np.arange(30), sizes).astype(np.int64)
    n = len(k)
    return {
        "k": k,
        "s": rng.integers(-1, len(WORDS), n).astype(np.int32),
        "m": rng.integers(0, 2, n).astype(bool),
        "f": rng.integers(0, 6, n).astype(np.int64),
        "x": np.round(rng.standard_normal(n) * 10 + 40, 2),
        "i": rng.integers(-500, 500, n).astype(np.int64),
        "d": rng.integers(-99999, 99999, n).astype(np.int64),
    }


def _scan(pb):
    return pb().table_scan("st").project(PROJECT)


@pytest.fixture(scope="module")
def st_table():
    """The table in both catalogs (24-row splits) and the JAX package's
    single-step rows per (keys, aggregates, narrow), computed once."""
    rows = {}
    old = jax_config.narrow_lanes, torch_config.narrow_lanes
    with table_in_both("st", _table(), {"s": sorted(WORDS)},
                       overrides={"d": (12, 2)}, batch_rows=24):

        def single(keys, aggs, narrow, masks=None):
            key = (tuple(keys), tuple(aggs), narrow, str(masks))
            if key not in rows:
                jax_config.narrow_lanes = narrow
                jax_config.optimize_plans = False
                try:
                    rows[key] = jax_run_plan(_scan(JaxPlanBuilder).aggregate(
                        keys, aggs, masks=masks).build()).to_pydict()
                finally:
                    jax_config.optimize_plans = True
            return rows[key]

        yield single
    jax_config.narrow_lanes, torch_config.narrow_lanes = old


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("narrow", [True, False])
def test_two_step_equals_jax_single_step(st_table, mode, narrow,
                                         monkeypatch):
    keys = MODES[mode]
    monkeypatch.setattr(torch_config, "narrow_lanes", narrow)
    got = torch_run_plan(_scan(TorchPlanBuilder).partial_aggregation(
        keys, AGGS).final_aggregation())
    assert_same(got, st_table(keys, AGGS, narrow), f"{mode} {narrow}")
    if mode == "karray":
        # the reference's own two-step kArray result is empty
        jax_config.narrow_lanes = narrow
        two = jax_run_plan(_scan(JaxPlanBuilder).partial_aggregation(
            keys, AGGS).final_aggregation().build()).to_pydict()
        assert all(v == [] for v in two.values()) and len(got["n"]) == 5


def test_final_step_never_takes_b2(st_table, monkeypatch):
    """All-additive integer aggregates in a kArray PARTIAL step under
    narrow lanes launch B2 once a split; the FINAL step combines its
    lanes without it (the launches of the whole plan are the PARTIAL
    step's)."""
    from velox_tpu_torch.ops import grouped_sum

    calls = []
    real = grouped_sum.grouped_multi_sum_i32
    monkeypatch.setattr(grouped_sum, "grouped_multi_sum_i32",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    monkeypatch.setattr(torch_config, "narrow_lanes", True)
    partial = _scan(TorchPlanBuilder).partial_aggregation(["s"], ADDITIVE)
    torch_run_plan(partial)
    splits = (len(_table()["k"]) + 23) // 24
    assert len(calls) == splits
    calls.clear()
    got = torch_run_plan(partial.final_aggregation())
    assert len(calls) == splits
    assert_same(got, st_table(["s"], ADDITIVE, True), "B2 two-step")


def test_streaming_final_matches_jax(st_table, monkeypatch):
    """A FINAL step as a streaming aggregation over PARTIAL batches that
    arrive in key order (the table ascends on k; groups cross splits),
    scan lanes and scattered ones alike."""
    from velox_tpu_torch.exec.operators import StreamingAggregationOp

    for narrow in (True, False):
        monkeypatch.setattr(torch_config, "narrow_lanes", narrow)
        b = _scan(TorchPlanBuilder).partial_aggregation(
            ["k"], AGGS).final_aggregation()
        n = b.node
        b.node = StreamingAggregationNode(
            n.id, n.output_type, n.source, n.step, n.keys, n.agg_names,
            n.aggregates)
        task = Task(b.build())
        out = {c: [] for c in task.plan.output_type.names}
        for batch in task.run():
            for c, v in batch.to_pydict().items():
                out[c].extend(v)
        assert any(isinstance(op, StreamingAggregationOp)
                   for op in task.planner.operators)
        assert_same(out, st_table(["k"], AGGS, narrow), f"stream {narrow}")


def test_masks_apply_to_raw_input_only(st_table, monkeypatch):
    """A PARTIAL step applies each aggregate's mask; the FINAL step
    combines every lane row (the reference drops FINAL masks)."""
    aggs = ["sum(i) AS si", "count(*) AS n", "max(x) AS xx",
            "min_by(i, x) AS mb"]
    masks = {"si": "m", "n": "m", "mb": "m"}
    monkeypatch.setattr(torch_config, "narrow_lanes", True)
    for keys in (["k"], ["s"], []):
        plan = _scan(TorchPlanBuilder).partial_aggregation(
            keys, aggs, masks).final_aggregation()
        assert all(s.mask is None for s in Task(plan.build()).planner
                   .operators[-1].specs)
        assert_same(torch_run_plan(plan),
                    st_table(keys, aggs, True, masks), f"masks {keys}")


def test_partial_schema_matches_jax_builder():
    """The PARTIAL step's columns (``name$lane``, a matrix lane as
    ``name$lane@slot``) and the FINAL step's types are those of the JAX
    package's ``PlanBuilder``, with the FINAL step's keys and aggregates
    inferred or given."""
    aggs = ["sum(d) AS sd", "avg(x) AS ax", "min_by(i, x) AS mb",
            "bitwise_or_agg(i) AS bo", "corr(x, i) AS co",
            "noisy_sum_gaussian(x, 2.0, 3) AS ns", "var_pop(x) AS vp"]
    with table_in_both("sc", _table(), {"s": sorted(WORDS)},
                       overrides={"d": (12, 2)}):
        for keys in (["s", "k"], []):
            jp = JaxPlanBuilder().table_scan("sc").project(
                PROJECT).partial_aggregation(keys, aggs)
            tp = TorchPlanBuilder().table_scan("sc").project(
                PROJECT).partial_aggregation(keys, aggs)
            given = tuple(
                pb().table_scan("sc").project(PROJECT)
                .partial_aggregation(keys, aggs)
                .final_aggregation(keys, aggs).node
                for pb in (JaxPlanBuilder, TorchPlanBuilder))
            for j, t in ((jp.node, tp.node),
                         (jp.final_aggregation().node,
                          tp.final_aggregation().node), given):
                assert list(t.output_type.names) == list(
                    j.output_type.names)
                assert [str(c) for c in t.output_type.children] == [
                    str(c) for c in j.output_type.children]
            assert "bo$0@63" in tp.node.source.output_type.names


def test_unported_forms_raise_as_in_the_reference(st_table):
    """DISTINCT outside a single step, ``approx_distinct``'s 1024-wide
    registers outside a single step and DISTINCT over a multi-argument
    aggregate raise ``NotImplementedError`` in both packages; a VARCHAR
    lane (min of a string) outside a single step raises in the port."""
    forms = [
        lambda pb: _scan(pb).partial_aggregation(
            ["k"], ["count(distinct i) AS c"]),
        lambda pb: _scan(pb).partial_aggregation(
            ["k"], ["approx_distinct(i) AS a"]),
        lambda pb: _scan(pb).aggregate(["k"], ["min_by(distinct i, x) AS c"]),
    ]
    for make in forms:
        for pb, run in ((JaxPlanBuilder, lambda p: jax_run_plan(p.build())),
                        (TorchPlanBuilder, torch_run_plan)):
            with pytest.raises(NotImplementedError):
                run(make(pb))
    with pytest.raises(NotImplementedError, match="VARCHAR"):
        torch_run_plan(_scan(TorchPlanBuilder).partial_aggregation(
            ["k"], ["min(s) AS m"]).final_aggregation())


def test_fused_partial_emits_what_unfused_does(monkeypatch):
    """A PARTIAL step fused with its scan (``exec/fused.py``) emits the
    batches the unfused operator emits, in the kArray and generic
    modes."""
    aggs = ["sum(d) AS sd", "count(*) AS n", "min_by(i, x) AS mb",
            "bitwise_and_agg(i) AS ba"]
    with table_in_both("fu", _table(), {"s": sorted(WORDS)},
                       overrides={"d": (12, 2)}, batch_rows=24):
        for keys in (["s"], ["k"]):
            outs = []
            for fused in (True, False):
                monkeypatch.setattr(torch_config, "fused_pipelines", fused)
                task = Task(TorchPlanBuilder().table_scan("fu")
                            .project(PROJECT).partial_aggregation(keys, aggs)
                            .build())
                outs.append([b.to_pydict() for b in task.run()])
                assert (type(task.planner.operators[-1]).__name__
                        == ("FusedScanAggOp" if fused
                            else "HashAggregationOp"))
            assert len(outs[0]) == len(outs[1]) > 0
            for a, b in zip(*outs):
                assert_same(a, b, f"fused {keys}")
