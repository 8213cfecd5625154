"""Spill under a memory budget: the port against the JAX package.

The port's counterparts of ``tests/test_spill_partitioned.py``. Both
packages run each plan under the same tiny device budget (4 KiB, so every
buffered batch moves to host RAM), over the same seeded batches
(``values_in_both``), and the port's rows must equal the JAX package's
row for row: a spilled aggregation comes out part by part (the last part
first) in both, a spilled join joins one hash part at a time. DOUBLE to
rtol=1e-9. Both split spilled state into two parts. Each test asserts
that the spill counters moved, and restores the budgets whatever
happens, so no later test runs spilled.
"""

import numpy as np
import pytest
import torch

from test_torch_complex_project import same
from torch_tpch_data import values_in_both
from velox_tpu.exec import run_plan as jax_run_plan
from velox_tpu.plan import PlanBuilder as JaxPlanBuilder
from velox_tpu.utils.config import config as jax_config
from velox_tpu_torch.exec import run_plan as torch_run_plan
from velox_tpu_torch.exec.spill import PartitionedEntryStore
from velox_tpu_torch.plan import PlanBuilder as TorchPlanBuilder
from velox_tpu_torch.utils.config import config as torch_config
from velox_tpu_torch.utils.metrics import reporter

SPILLED = "velox_tpu.spilled_bytes"
EVENTS = "velox_tpu.spill_events"
FILES = "velox_tpu.spill_file_bytes"
FIELDS = ("spill_memory_budget_bytes", "spill_host_budget_bytes",
          "spill_dir", "spill_agg_partitions", "spill_join_partitions")


class budget:
    """Both packages' spill settings for the block, restored after it."""

    def __init__(self, **settings):
        # two parts, not eight: each part is a shape the JAX package
        # compiles anew
        self.settings = {"spill_agg_partitions": 2,
                         "spill_join_partitions": 2, **settings}

    def __enter__(self):
        self.old = [{f: getattr(c, f) for f in FIELDS}
                    for c in (jax_config, torch_config)]
        for c in (jax_config, torch_config):
            for f, v in self.settings.items():
                setattr(c, f, v)
        self.before = dict(reporter.counters)
        return self

    def moved(self, name) -> float:
        return reporter.counters[name] - self.before.get(name, 0)

    def __exit__(self, *exc):
        for c, old in zip((jax_config, torch_config), self.old):
            for f, v in old.items():
                setattr(c, f, v)
        return False


TINY = 1 << 12


def run_both(build, batches, jax_batches=None):
    jb, tb = batches
    want = jax_run_plan(build(JaxPlanBuilder(), jb).build()).to_pydict()
    got = torch_run_plan(build(TorchPlanBuilder(), tb))
    assert sorted(got) == sorted(want)
    for c in want:
        same(got[c], want[c], c)
    return got


@pytest.fixture(scope="module")
def groups():
    rng = np.random.default_rng(5)
    n = 1000
    return values_in_both({
        "g": rng.integers(0, 200, n).astype(np.int64),
        "v": np.round(rng.normal(size=n), 4),
        "i": rng.integers(0, 20, n).astype(np.int64),
        "keep": rng.integers(0, 2, n).astype(bool)},
        nulls={"g": rng.random(n) < 0.03}, batch_rows=500)


def test_group_by_spills_and_equals_jax(groups):
    """No ORDER BY: the parts' order is part of the result. Scatter,
    distinct and masked aggregates in one node; as a multiset, equal to
    the port's unspilled run."""
    def build(pb, b):
        return pb.values(b).aggregate(
            ["g"], ["sum(v) AS s", "count(*) AS c", "min(v) AS lo",
                    "avg(i) AS a", "count(distinct i) AS d",
                    "sum(i) AS si"], masks={"si": "keep"})

    want = torch_run_plan(build(TorchPlanBuilder(), groups[1]))
    with budget(spill_memory_budget_bytes=TINY) as b:
        got = run_both(build, groups)
        assert b.moved(SPILLED) > 0 and b.moved(EVENTS) > 0
    key = sorted(range(len(got["g"])), key=lambda i: (
        got["g"][i] is None, got["g"][i]))
    for c in want:
        same([got[c][i] for i in key], want[c], c)


def test_store_partitions_are_disjoint():
    store = PartitionedEntryStore("t", num_parts=4)
    for seed in range(3):
        rng = np.random.default_rng(seed)
        store.append({
            "keys": [(torch.from_numpy(rng.integers(0, 50, 128)), None)],
            "lanes": [(torch.from_numpy(rng.normal(size=128)),)],
            "sel": torch.ones(128, dtype=torch.bool), "distinct": [None]})
    before = reporter.counters[EVENTS]
    store.spill_all()
    assert reporter.counters[EVENTS] > before
    parts = store.partitions()
    seen = {}
    for pi, entries in enumerate(parts):
        for e in entries:
            for k in e["keys"][0][0][e["sel"]].tolist():
                assert seen.setdefault(k, pi) == pi, f"key {k} in two parts"
    assert len(parts) > 1 and len(seen) == 50


@pytest.fixture(scope="module")
def join_sides():
    rng = np.random.default_rng(7)
    n, nb = 1200, 300
    probe = values_in_both({
        "k": rng.integers(0, 400, n).astype(np.int64),
        "v": np.round(rng.normal(size=n), 4)},
        nulls={"k": rng.random(n) < 0.02}, batch_rows=600)
    build = values_in_both({
        "bk": rng.integers(0, 400, nb).astype(np.int64),
        "w": np.round(rng.normal(size=nb), 4)},
        nulls={"bk": rng.random(nb) < 0.02}, batch_rows=150)
    return probe, build


@pytest.mark.parametrize("jt", ["inner", "left", "right", "full",
                                "left_semi", "anti"])
def test_join_build_spill_equals_jax(join_sides, jt):
    """Row for row as the JAX package under the same budget (NULL keys
    on both sides: a NULL probe row goes out once, and the anti join sees
    the build's NULL key in whichever part holds it)."""
    probe, build_side = join_sides
    out = (["k", "v"] if jt in ("left_semi", "anti")
           else ["k", "v", "bk", "w"])

    def build(pb, batches):
        side = build_side[0] if pb is jax_pb else build_side[1]
        return type(pb)().values(batches).hash_join(
            type(pb)().values(side), ["k"], ["bk"], jt, output=out)

    jax_pb = JaxPlanBuilder()
    unspilled = torch_run_plan(build(TorchPlanBuilder(), probe[1]))
    with budget(spill_memory_budget_bytes=TINY) as b:
        want = jax_run_plan(build(jax_pb, probe[0]).build()).to_pydict()
        got = torch_run_plan(build(TorchPlanBuilder(), probe[1]))
        assert b.moved(SPILLED) > 0
    assert list(got) == out
    for c in out:
        same(got[c], want[c], c)

    def rows(d):
        return sorted(zip(*[d[c] for c in out]),
                      key=lambda r: tuple((x is None, x) for x in r))
    assert rows(got) == rows(unspilled)


def test_string_keyed_join_over_two_dictionaries(join_sides):
    """Build and probe keys are strings of different dictionaries: the
    spilled join routes them by value, and equals the unspilled one."""
    from velox_tpu_torch.io import catalog

    rng = np.random.default_rng(9)
    words = [f"w{i:03d}" for i in range(60)]
    probe = {"s": rng.integers(0, 60, 700).astype(np.int32),
             "v": rng.integers(0, 9, 700).astype(np.int64)}
    sub = words[::2] + ["zz"]
    build = {"bs": rng.integers(0, len(sub), 200).astype(np.int32),
             "w": rng.integers(0, 9, 200).astype(np.int64)}
    catalog.register_columns("sp_probe", probe, {"s": words}, 128,
                             device="cpu")
    catalog.register_columns("sp_build", build, {"bs": sub}, 64,
                             device="cpu")
    try:
        def plan():
            return TorchPlanBuilder().table_scan("sp_probe").hash_join(
                TorchPlanBuilder().table_scan("sp_build"), ["s"], ["bs"],
                "full", output=["s", "v", "bs", "w"])

        old = torch_config.optimize_plans
        torch_config.optimize_plans = False
        try:
            want = torch_run_plan(plan())
            with budget(spill_memory_budget_bytes=1 << 10) as b:
                got = torch_run_plan(plan())
                assert b.moved(SPILLED) > 0
        finally:
            torch_config.optimize_plans = old
    finally:
        catalog.drop_table("sp_probe")
        catalog.drop_table("sp_build")

    def rows(d):
        return sorted(zip(*d.values()),
                      key=lambda r: tuple((x is None, x) for x in r))
    assert rows(got) == rows(want)
    assert any(s is not None and s == bs for s, bs in zip(got["s"],
                                                          got["bs"]))


def test_orderby_and_window_under_budget(groups):
    def order(pb, b):
        return pb.values(b).order_by(["v", "g"])

    def window(pb, b):
        return pb.values(b).window(
            ["g"], ["v"], ["row_number() AS rn", "sum(i) AS si"]) \
            .order_by(["g", "v"])

    with budget(spill_memory_budget_bytes=TINY) as b:
        run_both(order, groups)
        run_both(window, groups)
        assert b.moved(SPILLED) > 0 and b.moved(EVENTS) >= 2


def test_file_rung_under_a_host_budget(join_sides, tmp_path):
    """Device -> host RAM -> page files: both budgets tiny, the files go
    under ``tmp_path`` and are gone after the run."""
    probe, build_side = join_sides

    def build(pb, b):
        side = build_side[0] if isinstance(pb, JaxPlanBuilder) \
            else build_side[1]
        return (pb.values(b).hash_join(
            type(pb)().values(side), ["k"], ["bk"], "inner",
            output=["k", "v", "w"]).order_by(["k", "v", "w"]))

    with budget(spill_memory_budget_bytes=1 << 11,
                spill_host_budget_bytes=1 << 12,
                spill_dir=str(tmp_path)) as b:
        run_both(build, probe)
        assert b.moved(FILES) > 0
    assert not list(tmp_path.iterdir())


def test_complex_columns_spill_to_host_and_files(tmp_path):
    """ARRAY and MAP columns move with their offsets and elements
    through both rungs (the JAX package's rungs read flat lanes only):
    equal to the port's unspilled run."""
    from test_torch_complex_project import batches_of, make_rows

    _, tb = batches_of(make_rows(n=240), split=40)

    def plan():
        return (TorchPlanBuilder().values(tb)
                .order_by(["k", "id"]))

    want = torch_run_plan(plan())
    for settings in ({"spill_memory_budget_bytes": TINY},
                     {"spill_memory_budget_bytes": TINY,
                      "spill_host_budget_bytes": TINY,
                      "spill_dir": str(tmp_path)}):
        with budget(**settings) as b:
            got = torch_run_plan(plan())
            assert b.moved(SPILLED) > 0
            if "spill_dir" in settings:
                assert b.moved(FILES) > 0
        assert list(got) == list(want)
        for c in want:
            same(got[c], want[c], c)
