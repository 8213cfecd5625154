"""Fault injection through TestValue: the port's six points, under the
JAX package's names, so one test body drives both packages.

Each point fires, can fail the query with the injected error, and
leaves the engine working: the next run gives the right rows, and no
query pool, spill buffer or restore is left behind (a failure inside a
build pipeline and inside a partitioned or range restore included).
"""

import numpy as np
import pytest

import velox_tpu.exec as jax_exec
import velox_tpu_torch.exec as torch_exec
from velox_tpu.plan import PlanBuilder as JaxPlanBuilder
from velox_tpu.types import BIGINT as JB, DOUBLE as JD
from velox_tpu.utils.config import config as jax_config
from velox_tpu.utils.testvalue import TestValue as JaxTestValue
from velox_tpu.vector.batch import Batch as JaxBatch
from velox_tpu_torch.exec import memory, spill
from velox_tpu_torch.plan import PlanBuilder as TorchPlanBuilder
from velox_tpu_torch.types import BIGINT as TB, DOUBLE as TD
from velox_tpu_torch.utils.config import config as torch_config
from velox_tpu_torch.utils.testvalue import TestValue as TorchTestValue
from velox_tpu_torch.vector.batch import Batch as TorchBatch


class Pkg:
    def __init__(self, name, pb, run, config, tv, batch, bigint, double):
        self.name, self.pb, self._run, self.config = name, pb, run, config
        self.tv, self._batch, self.bigint, self.double = (
            tv, batch, bigint, double)

    def run(self, plan):
        out = self._run(plan.build() if hasattr(plan, "build") else plan)
        return out if isinstance(out, dict) else out.to_pydict()

    def batch(self, data, types):
        if self.name == "torch":
            return self._batch.from_pydict(data, types, device="cpu")
        return self._batch.from_pydict(data, types)


PKGS = {
    "jax": Pkg("jax", JaxPlanBuilder, jax_exec.run_plan, jax_config,
               JaxTestValue, JaxBatch, JB, JD),
    "torch": Pkg("torch", TorchPlanBuilder, torch_exec.run_plan,
                 torch_config, TorchTestValue, TorchBatch, TB, TD),
}


class Boom(RuntimeError):
    pass


def fail(_payload):
    raise Boom("injected failure")


def teardown_function(_fn):
    JaxTestValue.disable()
    TorchTestValue.disable()


class settings:
    """Config fields of one package for the block."""

    def __init__(self, config, **kw):
        self.config, self.kw = config, kw

    def __enter__(self):
        self.old = {k: getattr(self.config, k) for k in self.kw}
        for k, v in self.kw.items():
            setattr(self.config, k, v)

    def __exit__(self, *exc):
        for k, v in self.old.items():
            setattr(self.config, k, v)


def _values(pkg, n=600, seed=1):
    rng = np.random.default_rng(seed)
    return pkg.batch({"g": [int(x) for x in rng.integers(0, 40, n)],
                      "v": [float(x) for x in rng.normal(size=n)]},
                     {"g": pkg.bigint, "v": pkg.double})


def _agg_plan(pkg):
    return (pkg.pb().values([_values(pkg, seed=s) for s in range(3)])
            .aggregate(["g"], ["sum(v) AS s", "count(*) AS c"])
            .order_by(["g"]))


def _left_behind():
    """The port's query pools and registered spill buffers alive now (a
    test compares them with its start)."""
    return (list(memory.root_pool.children),
            list(spill.memory_manager._buffers))


@pytest.mark.parametrize("name", list(PKGS))
def test_spill_point_fires_fails_and_recovers(name):
    pkg = PKGS[name]
    before = _left_behind()
    want = pkg.run(_agg_plan(pkg))
    hits = []
    with settings(pkg.config, spill_memory_budget_bytes=1 << 10):
        with pkg.tv.scoped("velox_tpu.spill.spill_all",
                           lambda buf: hits.append(buf.label)):
            assert pkg.run(_agg_plan(pkg)) == want
        assert hits, "spill injection point never fired"
        with pkg.tv.scoped("velox_tpu.spill.spill_all", fail):
            with pytest.raises(Boom):
                pkg.run(_agg_plan(pkg))
        assert pkg.run(_agg_plan(pkg)) == want
    assert _left_behind() == before


@pytest.mark.parametrize("plan", ["agg", "orderby", "window"])
def test_a_failed_partitioned_or_range_restore_releases_everything(plan):
    """``spill.partitions`` fails when a spilled aggregation's parts, or
    a spilled OrderBy's or window's ranges, start to come back."""
    pkg = PKGS["torch"]

    def make():
        base = pkg.pb().values([_values(pkg, seed=s) for s in range(3)])
        if plan == "agg":
            return base.aggregate(["g"], ["sum(v) AS s"]).order_by(["g"])
        if plan == "orderby":
            return base.order_by(["v"])
        return base.window(["g"], ["v"], ["row_number() AS rn"])

    before = _left_behind()
    want = pkg.run(make())
    fired = []
    with settings(pkg.config, spill_memory_budget_bytes=2 << 10):
        with pkg.tv.scoped("velox_tpu.spill.partitions", fired.append):
            assert pkg.run(make()) == want
        assert fired
        with pkg.tv.scoped("velox_tpu.spill.partitions", fail):
            with pytest.raises(Boom):
                pkg.run(make())
        assert _left_behind() == before
        assert pkg.run(make()) == want
    assert _left_behind() == before


def test_a_failure_inside_a_build_pipeline_releases_everything():
    """A spill of the hash build's buffer fails while the build pipeline
    runs: the task closes every operator and its pool."""
    pkg = PKGS["torch"]
    right = pkg.pb().values([pkg.batch(
        {"rk": list(range(40)), "w": [float(i) for i in range(40)]},
        {"rk": pkg.bigint, "w": pkg.double})] * 4)
    plan = (pkg.pb().values([_values(pkg)])
            .hash_join(right, ["g"], ["rk"], "inner",
                       output=["g", "v", "w"])
            .aggregate(["g"], ["count(*) AS c"]).order_by(["g"]))
    before = _left_behind()
    want = pkg.run(plan)
    with settings(pkg.config, spill_memory_budget_bytes=1 << 10,
                  optimize_plans=False):
        with pkg.tv.scoped("velox_tpu.spill.spill_all", fail):
            with pytest.raises(Boom):
                pkg.run(plan)
        assert _left_behind() == before
        assert pkg.run(plan) == want


@pytest.mark.parametrize("name", list(PKGS))
def test_abandon_check_point(name):
    pkg = PKGS[name]
    rng = np.random.default_rng(3)
    b = pkg.batch({"u": [int(x) for x in rng.permutation(3000)],
                   "v": [1.0] * 3000}, {"u": pkg.bigint, "v": pkg.double})
    plan = (pkg.pb().values([b]).partial_aggregation(["u"], ["sum(v) AS s"])
            .final_aggregation().order_by(["u"]))
    want = pkg.run(plan)
    seen = []
    with settings(pkg.config, abandon_partial_agg_min_rows=16):
        with pkg.tv.scoped("velox_tpu.agg.abandon_check", seen.append):
            assert pkg.run(plan) == want
        assert seen and type(seen[0]).__name__ == "HashAggregationOp"
        with pkg.tv.scoped("velox_tpu.agg.abandon_check", fail):
            with pytest.raises(Boom):
                pkg.run(plan)
        assert pkg.run(plan) == want


def test_scan_read_failure_surfaces_and_recovers():
    from torch_tpch_data import table_in_both

    with table_in_both("faulty_t", {"x": np.arange(100, dtype=np.int64)},
                       batch_rows=32):
        for pkg in PKGS.values():
            calls = {"n": 0}

            def flaky(_table):
                calls["n"] += 1
                if calls["n"] == 1:
                    raise IOError("injected read failure")

            plan = (pkg.pb().table_scan("faulty_t", ["x"])
                    .aggregate([], ["sum(x) AS s"]))
            with pkg.tv.scoped("velox_tpu.scan.read_split", flaky):
                with pytest.raises(IOError, match="injected"):
                    pkg.run(plan)
                assert pkg.run(plan)["s"] == [sum(range(100))]
            assert calls["n"] == 2, pkg.name


@pytest.mark.parametrize("name", list(PKGS))
def test_exchange_points(name):
    """``exchange.enqueue`` sees each page; a failed fetch is retried
    from the same sequence, since pages stay until acked."""
    if name == "jax":
        from velox_tpu.exec.exchange_net import (
            LocalExchangeSource, StreamingBufferManager, consume_source)
        from velox_tpu.serial import serialize_page
        kw = {}
    else:
        from velox_tpu_torch.exec.exchange_net import (
            LocalExchangeSource, StreamingBufferManager, consume_source)
        from velox_tpu_torch.serial import serialize_page
        kw = {"device": "cpu"}
    pkg = PKGS[name]
    b = pkg.batch({"x": [1, 2, 3]}, {"x": pkg.bigint})
    mgr = StreamingBufferManager()
    seen = []
    with pkg.tv.scoped("velox_tpu.exchange.enqueue",
                       lambda t: seen.append(t[:2])):
        mgr.enqueue("f", 0, serialize_page(b))
        mgr.no_more_data("f", [0])
    assert seen == [("f", 0)]
    hit = []

    def drop_first(t):
        if t[2] == 0 and not hit:
            hit.append(t)
            raise ConnectionError("injected fetch failure")

    with pkg.tv.scoped("velox_tpu.exchange.get_data", drop_first):
        src = LocalExchangeSource(mgr, "f", 0)
        with pytest.raises(ConnectionError):
            list(consume_source(src, **kw))
        got = list(consume_source(src, **kw))
    assert [g.to_pydict() for g in got] == [b.to_pydict()]


def test_points_cost_nothing_when_off():
    """Off by default: ``adjust`` returns None without a callback, and a
    disabled TestValue ignores a set callback's point."""
    assert TorchTestValue.adjust("velox_tpu.scan.read_split", 1) is None
    TorchTestValue.set("velox_tpu.scan.read_split", fail)
    TorchTestValue.disable()
    assert TorchTestValue.adjust("velox_tpu.scan.read_split", 1) is None
