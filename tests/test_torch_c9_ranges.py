"""C9 (ROADMAP queue C): a spilled OrderBy, LocalMerge, Window, RowNumber,
TopNRowNumber or MarkDistinct comes back one key range at a time.

Each plan runs through the JAX package, through the port unspilled, and
through the port under a device budget far below its buffered bytes.
The spilled run must equal the unspilled one and the JAX package's row
for row (DOUBLE to rtol=1e-9), restore more than one range, restore no
range larger than the budget, and keep the pool tree's peak during the
restore at or below the budget plus one range. Before the repair a
spilled buffer came back whole: one restore of every batch, so the
range count below was 0.
"""

import contextlib

import numpy as np
import pytest

from torch_tpch_data import assert_same, table_in_both
from velox_tpu.exec import run_plan as jax_run_plan
from velox_tpu.plan import PlanBuilder as JaxPlanBuilder
from velox_tpu_torch.exec import memory, spill
from velox_tpu_torch.exec import run_plan as torch_run_plan
from velox_tpu_torch.plan import PlanBuilder as TorchPlanBuilder
from velox_tpu_torch.utils.config import config as torch_config
from velox_tpu_torch.utils.metrics import reporter
from velox_tpu_torch.utils.testvalue import TestValue

ROWS = 3000
BUDGET = 12 << 10
RANGES = "velox_tpu.spill_ranges"
OVER = "velox_tpu.spill_ranges_over_budget"
WORDS = ["pear", "apple", "fig", "kiwi", "plum", "date", "lime"]


@pytest.fixture(scope="module")
def table():
    rng = np.random.default_rng(13)
    nulls = rng.random(ROWS) < 0.05
    cols = {
        "k": rng.integers(0, 120, ROWS).astype(np.int64),
        "o": rng.permutation(ROWS).astype(np.int64),
        "v": np.round(rng.normal(size=ROWS), 6),
        "w": rng.integers(0, len(WORDS), ROWS).astype(np.int32),
    }
    # a nullable first sort key: -1 marks NULL in a string column
    cols["s"] = np.where(nulls, -1, rng.integers(0, len(WORDS), ROWS)
                         ).astype(np.int32)
    with table_in_both("c9", cols, {"w": WORDS, "s": WORDS},
                       batch_rows=256):
        yield


def _order(pb):
    return pb().table_scan("c9").order_by(["o", "k"])


def _order_desc(pb):
    return pb().table_scan("c9").order_by(["o DESC", "k"])


def _order_words(pb):
    return pb().table_scan("c9").order_by(["s DESC NULLS FIRST", "o"])


def _merge(pb):
    left = pb().table_scan("c9").filter("k < 60").order_by(["v", "o"])
    right = pb().table_scan("c9").filter("k >= 60").order_by(["v", "o"])
    return left.local_merge([right], ["v", "o"])


def _window(pb):
    return pb().table_scan("c9").window(["k"], ["o"], [
        "row_number() AS rn", "sum(v) AS sv", "first_value(v) AS fv",
        "rank() AS r"])


def _row_number(pb):
    return pb().table_scan("c9").row_number(["k"], "rn", 3)


def _top_n_row_number(pb):
    return pb().table_scan("c9").top_n_row_number(["k"], ["v DESC"], 2,
                                                  "rn")


def _mark_distinct(pb):
    return pb().table_scan("c9").mark_distinct("first_kw", ["k", "w"])


PLANS = {"orderby": _order, "orderby_desc": _order_desc,
         "local_merge": _merge, "window": _window,
         "row_number": _row_number, "top_n_row_number": _top_n_row_number,
         "mark_distinct": _mark_distinct}


@contextlib.contextmanager
def spilled(budget: int = BUDGET):
    """The port under ``budget``; yields the counters moved, the largest
    range restored and the root pool's peak from the first restore on."""
    seen = {"range": 0, "peak": 0}
    ranges = spill.RangeRestore.ranges

    def counted(self):
        for big, pos in ranges(self):
            seen["range"] = max(seen["range"],
                                spill.batch_device_bytes(big))
            yield big, pos
        seen["peak"] = max(seen["peak"], memory.root_pool.peak)

    before = dict(reporter.counters)
    old = torch_config.spill_memory_budget_bytes
    torch_config.spill_memory_budget_bytes = budget
    spill.RangeRestore.ranges = counted
    try:
        with TestValue.scoped(
                "velox_tpu.spill.partitions",
                lambda _: setattr(memory.root_pool, "peak", 0)):
            yield seen
    finally:
        spill.RangeRestore.ranges = ranges
        torch_config.spill_memory_budget_bytes = old
        for n in (RANGES, OVER, spill.METRIC_SPILL_EVENTS):
            seen[n] = reporter.counters[n] - before.get(n, 0)


@pytest.mark.parametrize("name", list(PLANS))
def test_spilled_operator_restores_one_range_at_a_time(table, name):
    make = PLANS[name]
    want = jax_run_plan(make(JaxPlanBuilder).build()).to_pydict()
    unspilled = torch_run_plan(make(TorchPlanBuilder).build())
    assert_same(unspilled, want, name)
    with spilled() as seen:
        got = torch_run_plan(make(TorchPlanBuilder).build())
    assert_same(got, unspilled, f"{name} spilled")
    assert seen[spill.METRIC_SPILL_EVENTS] > 0, name
    assert seen[RANGES] >= 2, seen
    assert seen[OVER] == 0, seen
    assert 0 < seen["range"] <= BUDGET, seen
    assert seen["peak"] <= BUDGET + seen["range"], seen


def test_a_key_over_the_budget_is_restored_alone_and_counted(table):
    """Seven words and NULL over 3,000 rows, descending, NULLs first:
    each first-key value holds more than the budget, so its range goes
    back alone and is counted."""
    want = jax_run_plan(_order_words(JaxPlanBuilder).build()).to_pydict()
    assert_same(torch_run_plan(_order_words(TorchPlanBuilder).build()),
                want)
    with spilled() as seen:
        got = torch_run_plan(_order_words(TorchPlanBuilder).build())
    assert_same(got, want)
    assert seen[OVER] > 0 and seen[RANGES] >= seen[OVER], seen


def test_string_ranges_follow_the_strings_over_two_dictionaries():
    """Batches whose string columns carry different dictionaries (a code
    means another word in each): the ranges follow the strings, so the
    spilled sort and window equal the unspilled ones and Python's
    sort."""
    from velox_tpu_torch.types import BIGINT, VARCHAR
    from velox_tpu_torch.vector.batch import Batch

    rng = np.random.default_rng(4)
    words = [f"w{i:03d}" for i in range(300)]
    batches, rows = [], []
    for lo in (0, 100, 150):
        s = [words[i] for i in rng.integers(lo, lo + 150, 400)]
        x = [int(i) for i in rng.permutation(400)]
        batches.append(Batch.from_pydict({"s": s, "x": x},
                                         {"s": VARCHAR, "x": BIGINT},
                                         device="cpu"))
        rows.extend(zip(s, x))
    assert len({id(b.column("s").dictionary) for b in batches}) == 3
    for make in (lambda: TorchPlanBuilder().values(batches)
                 .order_by(["s", "x"]),
                 lambda: TorchPlanBuilder().values(batches)
                 .window(["s"], ["x"], ["row_number() AS rn",
                                         "last_value(s) AS ls"])):
        want = torch_run_plan(make().build())
        with spilled(4 << 10) as seen:
            got = torch_run_plan(make().build())
        assert_same(got, want)
        assert seen[RANGES] >= 2, seen
    ordered = torch_run_plan(TorchPlanBuilder().values(batches)
                             .order_by(["s", "x"]).build())
    assert list(zip(ordered["s"], ordered["x"])) == sorted(rows)


def test_spilled_window_goes_through_page_files(table, tmp_path):
    """Under a host budget too, the buffered batches reach page files
    first; the ranges come back from them, equal to the unspilled run."""
    make = PLANS["window"]
    want = torch_run_plan(make(TorchPlanBuilder).build())
    old = (torch_config.spill_host_budget_bytes, torch_config.spill_dir)
    before = reporter.counters[spill.METRIC_SPILL_FILE_BYTES]
    torch_config.spill_host_budget_bytes = 8 << 10
    torch_config.spill_dir = str(tmp_path)
    try:
        with spilled() as seen:
            got = torch_run_plan(make(TorchPlanBuilder).build())
    finally:
        (torch_config.spill_host_budget_bytes,
         torch_config.spill_dir) = old
    assert_same(got, want)
    assert reporter.counters[spill.METRIC_SPILL_FILE_BYTES] > before
    assert seen[RANGES] >= 2, seen
