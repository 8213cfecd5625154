"""C10 and CrossBuild's C9 (ROADMAP queue C).

C10: an aggregation grouped by a string key over batches whose
dictionaries differ grouped by code, not by string (both packages gave
30 groups where there are 40). The port now brings the codes onto one
dictionary, the merged sorted union, in every mode: kArray (which goes
on generically once a batch brings a value its dictionary lacks),
generic, two-step, streaming, spilled, and a string aggregate argument.
Each result is held against Python; where the batches share one
dictionary the port still equals the JAX package row for row.

C9: a spilled cross join restored its whole build to the device. Now
each probe batch meets the build one chunk (at most half the budget) at
a time (a build batch larger than that cut into row slices), and a
stable sort on the probe row puts the chunks' pairs back in (probe row,
build row) order: equal to the unspilled run row for row,
with the pool tree's peak at most the budget plus one chunk.
"""

from collections import Counter

import numpy as np
import pytest

from torch_tpch_data import assert_same, table_in_both, values_in_both
from velox_tpu.exec import run_plan as jax_run_plan
from velox_tpu.plan import PlanBuilder as JaxPlanBuilder
from velox_tpu_torch.exec import memory, run_plan, spill
from velox_tpu_torch.plan import PlanBuilder
from velox_tpu_torch.types import BIGINT, VARCHAR
from velox_tpu_torch.utils.config import config
from velox_tpu_torch.utils.metrics import reporter
from velox_tpu_torch.vector.batch import Batch

A = [f"w{i}" for i in range(30)]
B = [f"w{i}" for i in range(10, 40)]


def _batches(*columns):
    """One literal batch a list of words, each its own dictionary; ``k``
    counts the rows of the batch."""
    return [Batch.from_pydict({"s": list(w), "k": list(range(len(w)))},
                              {"s": VARCHAR, "k": BIGINT}, device="cpu")
            for w in columns]


@pytest.fixture(params=[True, False], ids=["optimized", "plain"])
def optimized(request):
    old = config.optimize_plans
    config.optimize_plans = request.param
    yield request.param
    config.optimize_plans = old


def test_the_roadmap_case_gives_40_groups(optimized):
    bs = _batches(A, B)
    assert bs[0].column("s").dictionary is not bs[1].column("s").dictionary
    got = run_plan(PlanBuilder().values(bs).aggregate(["s"],
                                                      ["count(*) AS c"]))
    assert len(got["s"]) == 40
    assert dict(zip(got["s"], got["c"])) == Counter(A + B)


def test_every_mode_groups_strings_by_value(optimized):
    """Generic (two keys), two-step, a string argument (min/max, count
    distinct) and a streaming aggregation, each against Python."""
    bs = _batches(A, B, A[::-1])
    rows = [(s, k) for w in (A, B, A[::-1]) for k, s in enumerate(w)]
    got = run_plan(PlanBuilder().values(bs).aggregate(["s", "k"],
                                                      ["count(*) AS c"]))
    assert Counter(dict(zip(zip(got["s"], got["k"]), got["c"]))) == \
        Counter(rows)
    got = run_plan(PlanBuilder().values(bs).partial_aggregation(
        ["s"], ["count(*) AS c"]).final_aggregation())
    assert dict(zip(got["s"], got["c"])) == Counter(s for s, _ in rows)
    got = run_plan(PlanBuilder().values(bs).aggregate(
        ["k"], ["min(s) AS lo", "max(s) AS hi", "count(distinct s) AS d"]))
    by_k = {}
    for s, k in rows:
        by_k.setdefault(k, []).append(s)
    want = {k: (min(v), max(v), len(set(v))) for k, v in by_k.items()}
    assert dict(zip(got["k"], zip(got["lo"], got["hi"], got["d"]))) == want
    # a group continues across batches whatever their dictionaries
    sa, sb = _batches(["x", "y", "z"], ["z", "z", "zz"])
    got = run_plan(PlanBuilder().values([sa, sb]).streaming_aggregate(
        ["s"], ["count(*) AS c", "max(s) AS m"]))
    assert got == {"s": ["x", "y", "z", "zz"], "c": [1, 1, 3, 1],
                   "m": ["x", "y", "z", "zz"]}


def test_a_spilled_aggregation_groups_strings_by_value():
    """Partials spilled to host RAM route a string by its value, so each
    string's partials meet in one part."""
    rng = np.random.default_rng(2)
    words = [[f"v{i:03d}" for i in rng.integers(lo, lo + 80, 300)]
             for lo in (0, 40, 20, 60)]
    bs = _batches(*words)
    before = reporter.counters[spill.METRIC_SPILL_EVENTS]
    old = config.spill_memory_budget_bytes
    config.spill_memory_budget_bytes = 1 << 12
    try:
        got = run_plan(PlanBuilder().values(bs).aggregate(
            ["s"], ["count(*) AS c", "sum(k) AS sk"]))
    finally:
        config.spill_memory_budget_bytes = old
    assert reporter.counters[spill.METRIC_SPILL_EVENTS] > before
    rows = [(s, k) for w in words for k, s in enumerate(w)]
    assert len(got["s"]) == len(set(got["s"]))
    assert dict(zip(got["s"], got["c"])) == Counter(s for s, _ in rows)
    sums = Counter()
    for s, k in rows:
        sums[s] += k
    assert dict(zip(got["s"], got["sk"])) == dict(sums)


def test_one_shared_dictionary_still_equals_jax():
    rng = np.random.default_rng(6)
    n = 900
    words = [f"w{i:02d}" for i in range(40)]
    jb, tb = values_in_both({"s": rng.integers(0, 40, n).astype(np.int32),
                             "v": rng.integers(0, 100, n).astype(np.int64)},
                            dictionaries={"s": words}, batch_rows=200)
    assert len({id(b.column("s").dictionary) for b in tb}) == 1

    def make(pb, b):
        return pb().values(b).aggregate(
            ["s"], ["count(*) AS c", "sum(v) AS sv"])

    want = jax_run_plan(make(JaxPlanBuilder, jb).build()).to_pydict()
    assert_same(run_plan(make(PlanBuilder, tb)), want)


@pytest.fixture(scope="module")
def cross_tables():
    rng = np.random.default_rng(3)
    with table_in_both("cx_p", {"a": rng.integers(0, 50, 300).astype(
                           np.int64), "x": rng.normal(size=300)},
                       batch_rows=128), \
            table_in_both("cx_b", {"b": rng.integers(0, 50, 5000).astype(
                              np.int64), "y": rng.normal(size=5000)},
                          batch_rows=512):
        yield


def _cross(pb):
    return pb().table_scan("cx_p").cross_join(
        pb().table_scan("cx_b"), filter="a = b AND x < y")


def test_a_spilled_cross_join_restores_one_chunk_at_a_time(cross_tables):
    budget = 8 << 10
    want = jax_run_plan(_cross(JaxPlanBuilder).build()).to_pydict()
    unspilled = run_plan(_cross(PlanBuilder))
    assert_same(unspilled, want)
    seen = {"chunk": 0, "restores": 0}
    restore = spill.restore_fragments

    def counted(frags, device):
        big = restore(frags, device)
        seen["chunk"] = max(seen["chunk"], spill.batch_device_bytes(big))
        seen["restores"] += 1
        return big

    before = reporter.counters[spill.METRIC_SPILL_CHUNKS]
    old = config.spill_memory_budget_bytes
    config.spill_memory_budget_bytes = budget
    spill.restore_fragments = counted
    memory.root_pool.peak = 0
    try:
        got = run_plan(_cross(PlanBuilder))
        peak = memory.root_pool.peak
    finally:
        spill.restore_fragments = restore
        config.spill_memory_budget_bytes = old
    assert_same(got, unspilled, "spilled")
    chunks = reporter.counters[spill.METRIC_SPILL_CHUNKS] - before
    # three probe batches, each against every chunk of a build of 80 KB
    assert chunks >= 3 * 2 and chunks == seen["restores"], seen
    assert 0 < seen["chunk"] <= budget // 2, seen
    assert peak <= budget + seen["chunk"], (peak, seen)
