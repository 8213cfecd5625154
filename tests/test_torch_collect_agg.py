"""Collect-mode aggregation in the port (``exec/collect_agg.py``) against
the JAX package on the CPU: the exact ``approx_percentile`` and
``approx_winsorized_mean`` beside scatter, distinct and masked
aggregates, keyed (dictionary and integer keys) and keyless, over
128-row splits with NULLs; the float32 quantile position the reference
takes; keyless empty input; the ARRAY/MAP kinds; and the refusals
(streaming and two-step collect aggregation).
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
from velox_tpu_torch.utils.config import config as torch_config

WORDS = ["kiwi", "apple", "pear", "fig"]

#: NULL where f = 1 (x, i) or f = 2 (d)
PROJECT = ["k", "s", "m", "v",
           "CASE WHEN f = 1 THEN NULL ELSE x END AS x",
           "CASE WHEN f = 1 THEN NULL ELSE i END AS i",
           "CASE WHEN f = 2 THEN NULL ELSE d END AS d"]

AGGS = ["approx_percentile(x, 0.5) AS px", "approx_percentile(i, 0.9) AS pi",
        "approx_percentile(d, 0.25) AS pd",
        "approx_winsorized_mean(x, 0.05, 0.95) AS wx",
        "approx_winsorized_mean(i, 0.1, 0.8) AS wi",
        "sum(i) AS si", "count(*) AS n", "avg(x) AS ax",
        "count(distinct i) AS di", "sum(d) AS sd", "max(d) AS xd"]
MASKS = {"sd": "m", "xd": "m", "pi": "m"}

GROUPINGS = {"integer": ["k"], "dictionary": ["s"], "keyless": []}

#: group sizes: 91 rows puts q = 0.7 on the float32 position (63, not 62)
SIZES = [1, 2, 3, 5, 8, 13, 40, 91, 200]


def _table():
    rng = np.random.default_rng(20261018)
    sizes = np.resize(SIZES, 27)
    # shuffled: groups cross splits, and no plan streams on a sorted key
    k = rng.permutation(np.repeat(np.arange(len(sizes)), sizes)).astype(
        np.int64)
    n = len(k)
    return {
        "k": k,
        "s": rng.integers(-1, len(WORDS), n).astype(np.int32),
        "m": rng.integers(0, 2, n).astype(bool),
        "f": rng.integers(0, 7, n).astype(np.int64),
        "x": np.round(rng.standard_normal(n) * 10 + 40, 2),
        "i": rng.integers(-500, 500, n).astype(np.int64),
        "d": rng.integers(-99999, 99999, n).astype(np.int64),
        # distinct values, so a position picks one row
        "v": rng.permutation(n).astype(np.float64) / 8,
    }


def _scan(pb):
    return pb().table_scan("ca").project(PROJECT)


@pytest.fixture(scope="module")
def ca_table():
    """The table in both catalogs (128-row splits) and the JAX package's
    rows per (keys, aggregates, masks, filter), computed once."""
    rows = {}
    with table_in_both("ca", _table(), {"s": sorted(WORDS)},
                       overrides={"d": (12, 2)}, batch_rows=128):

        def jax_rows(keys, aggs, masks=None, where=None):
            key = (tuple(keys), tuple(aggs), str(masks), where)
            if key not in rows:
                pb = _scan(JaxPlanBuilder)
                if where is not None:
                    pb = pb.filter(where)
                rows[key] = jax_run_plan(pb.aggregate(
                    keys, aggs, masks=masks).build()).to_pydict()
            return rows[key]

        yield jax_rows


def _plan(keys, aggs, masks=None, where=None):
    pb = _scan(TorchPlanBuilder)
    if where is not None:
        pb = pb.filter(where)
    return pb.aggregate(keys, aggs, masks=masks).build()


@pytest.mark.parametrize("grouping", list(GROUPINGS))
def test_collect_aggregates_equal_jax(ca_table, grouping):
    """Exact percentiles (DOUBLE, BIGINT, DECIMAL) and winsorized means
    beside scatter, distinct and masked aggregates, in one collect node
    over several splits."""
    from velox_tpu_torch.exec.operators import HashAggregationOp

    keys = GROUPINGS[grouping]
    plan = _plan(keys, AGGS, MASKS)
    task = Task(plan)
    ops = [op for op in task.planner.operators
           if isinstance(op, HashAggregationOp)]
    out = {c: [] for c in plan.output_type.names}
    for b in task.run():
        for c, v in b.to_pydict().items():
            out[c].extend(v)
    assert [op._mode for op in ops] == ["collect"]
    assert len(ops[0]._raw_batches) == 0
    assert_same(out, ca_table(keys, AGGS, MASKS), grouping)


def test_float32_position_is_the_reference(ca_table):
    """``floor(float32(0.7) * float32(90))`` is 63 where a float64
    position gives 62: in the 91-row groups the port picks the 64th
    smallest value, as the JAX package does."""
    aggs = ["approx_percentile(v, 0.7) AS p", "count(v) AS n"]
    got = torch_run_plan(_plan(["k"], aggs))
    assert_same(got, ca_table(["k"], aggs), "float32 position")
    table = _table()
    checked = 0
    for g, p, n in zip(got["k"], got["p"], got["n"]):
        if n == 91:
            vals = np.sort(table["v"][table["k"] == g])
            assert p == vals[63] != vals[int(np.floor(0.7 * 90))]
            checked += 1
    assert checked == 3


def test_keyless_empty_input_is_one_row(ca_table):
    aggs = ["approx_percentile(x, 0.5) AS px", "count(*) AS n",
            "approx_winsorized_mean(x, 0.05, 0.95) AS wx", "sum(i) AS si"]
    got = torch_run_plan(_plan([], aggs, where="k < 0"))
    assert got == {"px": [None], "n": [0], "wx": [None], "si": [None]}
    assert_same(got, ca_table([], aggs, where="k < 0"), "empty")


def test_narrow_lanes_give_the_single_step(ca_table, monkeypatch):
    """Under narrow lanes the scatter aggregates of a collect node run
    once against the final group ids, one slot a group: a 32-bit sum or
    count into 2-128 groups calls the grouped-sum kernel B1 once (not
    once a split: the input is one concatenated batch), B2 never, and
    the rows are the JAX package's."""
    from velox_tpu_torch.ops import grouped_sum

    calls = []
    for fn in ("grouped_sum_i32", "grouped_multi_sum_i32"):
        real = getattr(grouped_sum, fn)
        monkeypatch.setattr(grouped_sum, fn, lambda *a, _r=real, _n=fn,
                            **kw: calls.append(_n) or _r(*a, **kw))
    aggs = ["approx_percentile(i, 0.5) AS p", "sum(i) AS si",
            "count(*) AS n", "avg(d) AS ad", "count(m) AS nm"]
    old = jax_config.narrow_lanes
    monkeypatch.setattr(torch_config, "narrow_lanes", True)
    jax_config.narrow_lanes = True
    try:
        want = ca_table(["s"], aggs)
    finally:
        jax_config.narrow_lanes = old
    assert_same(torch_run_plan(_plan(["s"], aggs)), want, "narrow")
    assert calls and set(calls) == {"grouped_sum_i32"}
    assert len(calls) <= len(aggs)


@pytest.mark.parametrize("agg", [
    "array_agg(x) AS r", "map_agg(k, x) AS r", "histogram(i) AS r",
    "approx_most_frequent(3, i) AS r"])
def test_array_and_map_kinds_wait_for_complex_types(ca_table, agg):
    """The complex types are ported: array_agg, map_agg, histogram and
    approx_most_frequent equal the JAX package beside a scatter
    aggregate."""
    aggs = [agg, "count(*) AS n"]
    assert_same(torch_run_plan(_plan(["k"], aggs)), ca_table(["k"], aggs),
                agg)


def test_streaming_collect_raises_as_the_reference(ca_table):
    aggs = ["approx_percentile(x, 0.5) AS px"]
    for pb in (JaxPlanBuilder, TorchPlanBuilder):
        plan = _scan(pb).streaming_aggregate(["k"], aggs).build()
        run = jax_run_plan if pb is JaxPlanBuilder else torch_run_plan
        with pytest.raises(NotImplementedError,
                           match="collect aggregates need the hash"):
            run(plan)


def test_two_step_blob_kind_raises_as_the_reference(ca_table):
    aggs = ["tdigest_agg(x) AS td", "count(*) AS n"]
    for pb, run in ((JaxPlanBuilder, jax_run_plan),
                    (TorchPlanBuilder, torch_run_plan)):
        plan = _scan(pb).partial_aggregation(["k"], aggs).build()
        with pytest.raises(NotImplementedError,
                           match="other collect aggregates .* single-step"):
            run(plan)
