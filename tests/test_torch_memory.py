"""Memory pools, arbitration and the page wire format of the port
(``exec/memory.py``, ``exec/spill.py``, ``serial/page.py``).

The pool tree as ``tests/test_memory_pools.py`` holds the JAX package's:
usage bubbling to the root, a per-query cap spilling only its own
buffers, cross-query arbitration choosing the fattest other query, peak,
manual reservations and the task's query pool. Two queries under one
root budget run in two threads, five times each, and every result must
equal its own unspilled run (the port takes one lock around every
buffer's lists, so no batch is read half-moved). Pages and CompactRow
pages round-trip both ways with the JAX package's ``serial/page.py``:
what one package writes, the other reads back to the same rows.
"""

import sys
import threading

import numpy as np
import pytest

from torch_tpch_data import values_in_both
from velox_tpu_torch.exec import memory as mem
from velox_tpu_torch.exec import run_plan
from velox_tpu_torch.exec.spill import SpillableBuffer
from velox_tpu_torch.plan import PlanBuilder
from velox_tpu_torch.utils.config import config
from velox_tpu_torch.utils.metrics import METRIC_TASK_EXECUTIONS, reporter


def _batch(n=1000, seed=0):
    rng = np.random.default_rng(seed)
    return values_in_both({"g": rng.integers(0, 50, n).astype(np.int64),
                           "v": rng.integers(0, 1000, n).astype(np.int64)},
                          batch_rows=n)[1][0]


@pytest.fixture(autouse=True)
def _clean_root():
    yield
    for name in list(mem.root_pool.children):
        mem.root_pool.children.pop(name, None)
    config.spill_memory_budget_bytes = None
    config.query_memory_cap_bytes = None


def test_usage_bubbles_to_the_root_with_peak():
    q = mem.MemoryPool("q1", mem.root_pool, kind="query")
    with mem.scoped_pool(q):
        buf = SpillableBuffer("op1")
    buf.append(_batch())
    used = buf.device_bytes()
    assert used > 0 and q.used() == used
    assert mem.root_pool.used() >= used
    assert q.children["op1"].used() == used
    txt = mem.root_pool.tree_usage()
    assert "q1 [query]" in txt and "op1 [operator]" in txt
    buf.spill_all()
    assert q.used() == 0 and q.peak >= used
    assert buf.drain()[0].num_rows == 1000
    assert "op1" not in q.children


def test_per_query_cap_spills_only_its_own_buffers():
    other = mem.MemoryPool("q0", mem.root_pool, kind="query")
    with mem.scoped_pool(other):
        keep = SpillableBuffer("keep")
    keep.append(_batch(500, 4))
    q = mem.MemoryPool("q3", mem.root_pool, kind="query", capacity=1)
    with mem.scoped_pool(q):
        buf = SpillableBuffer("agg")
    buf.append(_batch())
    assert buf.device_bytes() == 0 and buf.has_spilled()
    assert keep.device_bytes() > 0 and not keep.has_spilled()
    assert len(buf) == 1 and buf.drain()[0].num_rows == 1000
    keep.close()


def test_cross_query_arbitration_picks_the_fattest_other_query():
    q1 = mem.MemoryPool("qa", mem.root_pool, kind="query")
    q2 = mem.MemoryPool("qb", mem.root_pool, kind="query")
    with mem.scoped_pool(q1):
        big = SpillableBuffer("big")
    big.append(_batch(4000, 1))
    config.spill_memory_budget_bytes = big.device_bytes() + 100
    with mem.scoped_pool(q2):
        small = SpillableBuffer("small")
    small.append(_batch(100, 2))
    assert big.device_bytes() == 0 and big.has_spilled()
    assert small.device_bytes() > 0 and not small.has_spilled()
    big.close()
    small.close()


def test_query_cap_counts_a_generic_aggregations_partials():
    """The pool tree is the one arbiter of device memory: a generic
    aggregation's partials hang off its query's pool like every other
    buffer, so a per-query cap spills them (the plan has no other
    buffer), and the result equals the unspilled run."""
    rng = np.random.default_rng(11)
    n = 2000
    bs = values_in_both({
        "g": rng.integers(0, 300, n).astype(np.int64) * 10**9 + 7,
        "v": rng.integers(0, 1000, n).astype(np.int64)},
        batch_rows=500)[1]

    def plan():
        return PlanBuilder().values(bs).aggregate(
            ["g"], ["sum(v) AS s", "count(*) AS c"])

    want = run_plan(plan())
    before = reporter.counters["velox_tpu.spill_events"]
    config.query_memory_cap_bytes = 1
    got = run_plan(plan())
    assert reporter.counters["velox_tpu.spill_events"] > before
    assert sorted(zip(*got.values())) == sorted(zip(*want.values()))
    assert len(want["g"]) == 300 and mem.root_pool.used() == 0


def test_manual_reservations():
    q = mem.MemoryPool("q5", mem.root_pool, kind="query")
    op = mem.MemoryPool("exchange", q)
    op.reserve(1 << 20)
    assert q.used() == 1 << 20 and q.stats()["reserved"] == 0
    op.release(1 << 20)
    assert q.used() == 0
    assert mem.query_pool("q5") is q


def test_query_pool_lifecycle():
    b = _batch()
    before = set(mem.root_pool.children)
    runs = reporter.counters[METRIC_TASK_EXECUTIONS]
    out = run_plan(PlanBuilder().values([b]).aggregate(
        ["g"], ["sum(v) AS s"]).order_by(["g"]))
    assert len(out["g"]) == 50
    assert set(mem.root_pool.children) == before
    assert reporter.counters[METRIC_TASK_EXECUTIONS] == runs + 1
    config.query_memory_cap_bytes = 1
    got = run_plan(PlanBuilder().values([b]).order_by(["v", "g"]).limit(10))
    config.query_memory_cap_bytes = None
    assert got == run_plan(
        PlanBuilder().values([b]).order_by(["v", "g"]).limit(10))
    assert mem.root_pool.used() == 0


def test_concurrent_queries_under_arbitration():
    """Two queries in two threads under one root budget, five runs each:
    arbitration may spill either side at any point; each result equals
    its unspilled run, neither thread deadlocks, and the root settles to
    zero."""
    batches = [[_batch(4000, s + i) for i in range(4)] for s in (7, 8)]

    def q(bs):
        return (PlanBuilder().values(bs).aggregate(["g"], ["sum(v) AS s"])
                .order_by(["g"]))

    want = [run_plan(q(bs)) for bs in batches]
    before = reporter.counters["velox_tpu.spill_events"]
    config.spill_memory_budget_bytes = 100_000
    results, errors = {}, []

    def run(idx):
        try:
            for r in range(5):
                results[(idx, r)] = run_plan(q(batches[idx]))
        except Exception as e:  # noqa: BLE001 - surfaced below
            errors.append((idx, e))

    threads = [threading.Thread(target=run, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    config.spill_memory_budget_bytes = None
    assert not any(t.is_alive() for t in threads), "arbitration deadlock"
    assert not errors, errors
    for (idx, _), got in results.items():
        assert got == want[idx]
    assert len(results) == 10
    assert reporter.counters["velox_tpu.spill_events"] > before
    assert mem.root_pool.used() == 0


@pytest.fixture(scope="module")
def both_batches():
    rng = np.random.default_rng(3)
    n = 300
    return values_in_both({
        "i": rng.integers(-50, 50, n).astype(np.int64),
        "d": np.round(rng.normal(size=n), 3),
        "s": rng.integers(0, 4, n).astype(np.int32),
        "c": rng.integers(100, 999, n).astype(np.int64)},
        nulls={"d": rng.random(n) < 0.2, "c": rng.random(n) < 0.1},
        dictionaries={"s": ["ash", "birch", "cedar", "elm"]}, batch_rows=n)


@pytest.mark.parametrize("compress", [False, "zlib"])
def test_pages_round_trip_both_ways(both_batches, compress):
    from velox_tpu.serial import page as jax_page
    from velox_tpu_torch.serial import page

    jb, tb = both_batches[0][0], both_batches[1][0]
    want = jb.to_pydict()
    assert tb.to_pydict() == want
    assert jax_page.deserialize_page(
        page.serialize_page(tb, compress)).to_pydict() == want
    assert page.deserialize_page(
        jax_page.serialize_page(jb, compress), "cpu").to_pydict() == want
    assert jax_page.deserialize_compact_rows(
        page.serialize_compact_rows(tb, compress)).to_pydict() == want
    assert page.deserialize_compact_rows(
        jax_page.serialize_compact_rows(jb, compress),
        "cpu").to_pydict() == want


def test_a_zstd_page_needs_zstandard(both_batches, monkeypatch):
    from velox_tpu_torch.serial import page

    monkeypatch.setitem(sys.modules, "zstandard", None)
    tb = both_batches[1][0]
    with pytest.raises(RuntimeError, match="zstandard"):
        page.serialize_page(tb, "zstd")
    frame = bytearray(page.serialize_page(tb))
    frame[5] = 2    # the zstd flag
    with pytest.raises(RuntimeError, match="zstandard"):
        page.deserialize_page(bytes(frame), "cpu")
