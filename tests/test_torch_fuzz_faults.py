"""Faults the port's fuzzers catch, and the two the fuzzers found.

A wrong result planted in an expression function, in the join's NULL
handling and in a window frame each makes the matching port fuzzer
raise. C11 (ROADMAP queue C): an operator that saw no batch made its
empty result on the card even when the plan's literal batches lie on
the CPU. C12: the FINAL step of a two-step ``array_agg``/``set_agg``/
``map_agg`` dropped a group whose rows all failed the PARTIAL step's
mask, where one step gives the group a NULL. C13: the exchange
fuzzer required a retried fetch to return the same pages as the first,
which fails at random when the producer enqueues a page in between.
C14: a buffer's batch was visible to other threads' arbitration before
the buffer's own, so one query's thread could spill another's buffer.
"""

import dataclasses

import pytest
import torch

from velox_tpu_torch.exec import (
    LocalExchangeSource, StreamingBufferManager, run_plan,
)
from velox_tpu_torch.exec.window_ops import WindowOp
from velox_tpu_torch.functions.registry import registry as scalar_fns
from velox_tpu_torch.fuzzer import (
    VectorFuzzer, run_aggregation_fuzz, run_expression_fuzz, run_join_fuzz,
    run_plan_fuzz, run_window_fuzz,
)
from velox_tpu_torch.fuzzer.exchange_fuzzer import same_retry
from velox_tpu_torch.ops import join as join_ops
from velox_tpu_torch.plan import PlanBuilder
from velox_tpu_torch.types import BIGINT, BOOLEAN, DOUBLE
from velox_tpu_torch.vector.batch import Batch


def _plant_plus(monkeypatch):
    plus = scalar_fns["plus"]
    monkeypatch.setitem(scalar_fns, "plus", dataclasses.replace(
        plus, impl=lambda a, b: plus.impl(a, b) + 1))


def _plant_null_keys(monkeypatch):
    # a NULL probe key takes part in the match search
    monkeypatch.setattr(join_ops, "_probe_ok", lambda sel, valid: sel)


def _plant_short_frame(monkeypatch):
    bounds = WindowOp._frame_bounds

    def short(self, spec, cols, ctx):
        start, end, max_len = bounds(self, spec, cols, ctx)
        return start, torch.maximum(end - 1, start), max_len

    monkeypatch.setattr(WindowOp, "_frame_bounds", short)


@pytest.mark.parametrize("plant,run", [
    (_plant_plus, lambda: run_expression_fuzz(40, seed=41, device="cpu")),
    (_plant_null_keys, lambda: run_join_fuzz(20, seed=42, device="cpu")),
    (_plant_short_frame, lambda: run_window_fuzz(30, seed=43,
                                                 device="cpu")),
], ids=["expression", "join_nulls", "window_frame"])
def test_a_planted_fault_makes_the_fuzzer_raise(plant, run, monkeypatch):
    run()                                  # the port as it is passes
    plant(monkeypatch)
    with pytest.raises(AssertionError):
        run()


def test_c11_an_empty_result_stays_on_the_plans_device():
    """An inner join that matches nothing, aggregated with and without a
    key, over literal batches on the CPU (the plan fuzzer, seed 8,
    iteration 5)."""
    types = {"k": BIGINT, "v": DOUBLE, "g": BIGINT}
    left = Batch.from_pydict({"k": [1, 2], "v": [0.5, None], "g": [0, 1]},
                             types, device="cpu")
    right = Batch.from_pydict({"k": [3], "v": [1.0], "g": [0]}, types,
                              device="cpu")

    def plan(keys):
        rb = PlanBuilder().values([right]).project(["k as rk", "v as rv"])
        return (PlanBuilder().values([left])
                .hash_join(rb, ["k"], ["rk"], "inner")
                .aggregate(keys, ["max(v) as a", "count(*) as c"]).build())

    assert run_plan(plan(["g"])) == {"g": [], "a": [], "c": []}
    assert run_plan(plan([])) == {"a": [None], "c": [0]}


@pytest.mark.parametrize("agg,want", [
    ("array_agg(i)", [[1, 2], None, [None], None]),
    ("set_agg(i)", [[1, 2], None, [None], None]),
    ("map_agg(i, i)", [[(1, 1), (2, 2)], None, None, None]),
])
def test_c12_a_two_step_collect_keeps_a_group_its_mask_empties(agg, want):
    """Groups 2 and 4 have no row that passes the mask, so no element
    reaches their PARTIAL page; group 3's one element is NULL. Two
    splits, so the FINAL step merges two pages."""
    data = {"g": [1, 1, 2, 3, 4], "i": [1, 2, 3, None, 5],
            "m": [True, True, False, True, False]}
    types = {"g": BIGINT, "i": BIGINT, "m": BOOLEAN}

    def batches():
        return [Batch.from_pydict({c: v[:2] for c, v in data.items()},
                                  types, device="cpu"),
                Batch.from_pydict({c: v[2:] for c, v in data.items()},
                                  types, device="cpu")]

    masks = {"a": "m"}
    two = run_plan(PlanBuilder().values(batches())
                   .partial_aggregation(["g"], [f"{agg} as a"], masks=masks)
                   .final_aggregation().build())
    one = run_plan(PlanBuilder().values(batches())
                   .aggregate(["g"], [f"{agg} as a"], masks=masks).build())
    assert two == one == {"g": [1, 2, 3, 4], "a": want}


def test_the_fuzzers_run_on_the_card_unless_asked(monkeypatch):
    """Without a card, and without ``device="cpu"``, every new fuzzer
    entry point raises rather than run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for run in (lambda: VectorFuzzer(0).batch({"a": "bigint"}, 4),
                lambda: run_expression_fuzz(1),
                lambda: run_window_fuzz(1), lambda: run_join_fuzz(1),
                lambda: run_plan_fuzz(1), lambda: run_aggregation_fuzz(1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run()


def test_c13_a_retried_fetch_may_see_pages_that_arrived_since():
    mgr = StreamingBufferManager()
    src = LocalExchangeSource(mgr, "f", 0)
    mgr.enqueue("f", 0, b"a")
    first = src.fetch(0)
    mgr.enqueue("f", 0, b"b")          # the producer runs on
    retry = src.fetch(0)
    assert first[:2] == ([b"a"], 1) and retry[:2] == ([b"a", b"b"], 2)
    assert same_retry(first[:2], retry[:2])
    assert not same_retry(([b"a"], 1), ([b"b"], 1))
    assert not same_retry(([b"a", b"b"], 2), ([b"a"], 1))
    assert not same_retry(([b"a"], 1), ([b"a", b"b"], 1))


def test_c14_each_buffer_is_arbitrated_before_another_thread_sees_it():
    """Four threads, each under its own query pool, append small batches
    to their own buffer under a 1 KiB budget with a short switch
    interval: every spill a thread makes is of its own query's buffer."""
    import sys
    import threading

    from velox_tpu_torch.exec import memory
    from velox_tpu_torch.exec.spill import SpillableBuffer
    from velox_tpu_torch.utils.config import config
    from velox_tpu_torch.utils.testvalue import TestValue

    batch = Batch.from_pydict({"v": [0.5] * 200}, {"v": DOUBLE},
                              device="cpu")
    spills = []

    def seen(buf):
        spills.append((threading.current_thread().name,
                       buf.pool.query_pool().name))

    def task(name):
        pool = memory.MemoryPool(name, memory.root_pool, kind="query")
        try:
            with memory.scoped_pool(pool):
                buf = SpillableBuffer("c14")
            for _ in range(300):
                buf.append(batch)
            buf.close()
        finally:
            pool.close()

    old, interval = config.spill_memory_budget_bytes, sys.getswitchinterval()
    config.spill_memory_budget_bytes = 1 << 10
    sys.setswitchinterval(1e-6)
    try:
        with TestValue.scoped("velox_tpu.spill.spill_all", seen):
            threads = [threading.Thread(target=task, args=(f"c14-{i}",),
                                        name=f"c14-{i}") for i in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
        config.spill_memory_budget_bytes = old
    assert len(spills) >= 4 * 300
    assert [s for s in spills if s[0] != s[1]] == []
