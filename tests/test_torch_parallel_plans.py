"""The port's ``run_plan_distributed`` against the JAX package's, on an
8-shard mesh.

The plan shapes of ``tests/test_parallel.py``: broadcast semi and anti
joins, inner joins with and without an aggregation, right and full joins,
ORDER BY, ORDER BY + LIMIT, PARTIAL/FINAL aggregation and a window
(``test_torch_parallel_tpch.py`` holds TPC-H Q1, Q3, Q4 and Q6). The
same numpy arrays feed both packages; the JAX package runs on its 8
virtual CPU devices (``tests/conftest.py``), the port on a
mesh of 8 shards on the CPU (``make_mesh(8, device="cpu")``). Each
result must equal the JAX package's distributed result row for row
(DOUBLE to rtol=1e-9: sums run in another order on each shard) and the
port's serial result, and both packages must take the same strategy.
"""

import numpy as np
import pytest

from torch_tpch_data import assert_same, table_in_both
from velox_tpu.parallel import make_mesh as jax_make_mesh
from velox_tpu.parallel import runner as jax_runner
from velox_tpu.plan import PlanBuilder as JaxPlanBuilder
from velox_tpu.types import BIGINT as JBIGINT, DOUBLE as JDOUBLE
from velox_tpu.vector.batch import Batch as JaxBatch
from velox_tpu_torch.exec import run_plan
from velox_tpu_torch.parallel import make_mesh, runner
from velox_tpu_torch.plan import PlanBuilder as TorchPlanBuilder
from velox_tpu_torch.types import BIGINT as TBIGINT, DOUBLE as TDOUBLE
from velox_tpu_torch.vector.batch import Batch as TorchBatch

N = 8


@pytest.fixture(scope="module")
def meshes():
    return jax_make_mesh(N), make_mesh(N, device="cpu")


def _probe_table(seed):
    rng = np.random.default_rng(seed)
    n = 4000
    return table_in_both("dp_probe", {
        "k": rng.integers(0, 200, n).astype(np.int64),
        "k2": rng.integers(0, 50, n).astype(np.int64),
        "v": rng.normal(size=n)}, batch_rows=512)


def _values(data, types):
    """One literal batch in each package: (jax, torch)."""
    jt = {c: {"B": JBIGINT, "D": JDOUBLE}[t] for c, t in types.items()}
    tt = {c: {"B": TBIGINT, "D": TDOUBLE}[t] for c, t in types.items()}
    return (JaxBatch.from_pydict(data, jt),
            TorchBatch.from_pydict(data, tt, device="cpu"))


def _check(meshes, make, strategy=None):
    """``make(PlanBuilder, side)`` (side 0: JAX, 1: port) through both
    distributed runners and the port's serial one."""
    jmesh, tmesh = meshes
    want = jax_runner.run_plan_distributed(
        make(JaxPlanBuilder, 0).build(), jmesh).to_pydict()
    jstrategy = jax_runner.last_strategy
    got = runner.run_plan_distributed(make(TorchPlanBuilder, 1).build(),
                                      tmesh)
    assert runner.last_strategy == jstrategy
    if strategy is not None:
        assert runner.last_strategy == strategy
    assert_same(got, want, "distributed")
    return got


def test_broadcast_semi_and_anti_joins(meshes):
    rng = np.random.default_rng(15)
    n = 5000
    rk = np.asarray(sorted(set(rng.integers(0, 400, 120).tolist())))
    with table_in_both("bj_left", {"k": rng.integers(0, 400, n),
                                   "v": rng.normal(size=n)},
                       batch_rows=700), \
            table_in_both("bj_right", {"rk": rk}):
        for jt in ("left_semi", "anti_simple"):
            def make(pb, side, jt=jt):
                return pb().table_scan("bj_left").hash_join(
                    pb().table_scan("bj_right"), ["k"], ["rk"], jt)
            got = _check(meshes, make, "broadcast_semi_join")
            assert_same(got, run_plan(make(TorchPlanBuilder, 1)), jt)


def test_inner_join_with_aggregation(meshes):
    build = _values({"bk": list(range(0, 200, 2)),
                     "w": [float(i) / 7 for i in range(100)]},
                    {"bk": "B", "w": "D"})
    semi = _values({"sk": list(range(0, 50, 3))}, {"sk": "B"})

    def make(pb, side):
        return (pb().table_scan("dp_probe", columns=["k", "k2", "v"])
                .hash_join(pb().values([semi[side]]), ["k2"], ["sk"],
                           "left_semi")
                .hash_join(pb().values([build[side]]), ["k"], ["bk"],
                           "inner", output=["k", "v", "w"])
                .project(["k", "v * 2.0 + w AS x"])
                .aggregate(["k"], ["sum(x) AS s", "count(*) AS c",
                                   "min(x) AS lo"])
                .order_by(["k"]))

    with _probe_table(3):
        got = _check(meshes, make, "distributed_pipeline")
        assert_same(got, run_plan(make(TorchPlanBuilder, 1)), "serial")


def test_inner_join_without_aggregation(meshes):
    build = _values({"bk": [0, 1, 2, 3, 4, 5],
                     "w": [0.5, 1.5, 2.5, 3.5, 4.5, 5.5]},
                    {"bk": "B", "w": "D"})

    def make(pb, side):
        return (pb().table_scan("dp_probe", columns=["k2", "v"])
                .hash_join(pb().values([build[side]]), ["k2"], ["bk"],
                           "inner", output=["k2", "v", "w"])
                .top_n(["v DESC"], 17))

    with _probe_table(4):
        got = _check(meshes, make, "distributed_pipeline")
        assert_same(got, run_plan(make(TorchPlanBuilder, 1)), "serial")


def test_right_and_full_joins(meshes):
    """Build keys 0..59, probe keys 0..49: the unmatched build rows come
    once, from the OR of every shard's flags."""
    build = _values({"bk": list(range(60)),
                     "w": [float(i) / 3 for i in range(60)]},
                    {"bk": "B", "w": "D"})
    with _probe_table(11):
        for jt in ("right", "full"):
            def make(pb, side, jt=jt):
                return (pb().table_scan("dp_probe", columns=["k2", "v"])
                        .hash_join(pb().values([build[side]]), ["k2"],
                                   ["bk"], jt,
                                   output=["k2", "v", "bk", "w"]))
            got = _check(meshes, make, "distributed_pipeline")
            assert_same(got, run_plan(make(TorchPlanBuilder, 1)), jt)


def test_order_by_is_range_partitioned(meshes):
    """An ORDER BY over the join: ranges of the first key by sampled
    splitters, each shard sorted; the exact global order, both ways."""
    from velox_tpu_torch.parallel import pipeline

    build = _values({"bk": list(range(50)),
                     "w": [float(i) * 1.25 for i in range(50)]},
                    {"bk": "B", "w": "D"})
    calls = []
    orig = pipeline.ranged_sort

    def spy(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    pipeline.ranged_sort = spy
    try:
        with _probe_table(12):
            for desc in (False, True):
                def make(pb, side, desc=desc):
                    return (pb().table_scan("dp_probe",
                                            columns=["k", "k2", "v"])
                            .hash_join(pb().values([build[side]]), ["k2"],
                                       ["bk"], "inner",
                                       output=["k", "v", "w"])
                            .order_by([f"v{' DESC' if desc else ''}", "k"]))
                got = _check(meshes, make, "distributed_pipeline")
                assert_same(got, run_plan(make(TorchPlanBuilder, 1)),
                            f"desc={desc}")
    finally:
        pipeline.ranged_sort = orig
    assert calls == [1, 1]


def test_order_by_limit(meshes):
    build = _values({"bk": list(range(50)),
                     "w": [float(i) for i in range(50)]},
                    {"bk": "B", "w": "D"})

    def make(pb, side):
        return (pb().table_scan("dp_probe", columns=["k2", "v"])
                .hash_join(pb().values([build[side]]), ["k2"], ["bk"],
                           "inner", output=["k2", "v"])
                .order_by(["v DESC", "k2"])
                .limit(23))

    with _probe_table(13):
        got = _check(meshes, make, "distributed_pipeline")
        assert_same(got, run_plan(make(TorchPlanBuilder, 1)), "serial")


def test_partial_final_aggregation(meshes):
    build = _values({"bk": list(range(0, 200, 2)),
                     "w": [float(i) / 7 for i in range(100)]},
                    {"bk": "B", "w": "D"})

    def make(pb, side):
        return (pb().table_scan("dp_probe", columns=["k", "v"])
                .hash_join(pb().values([build[side]]), ["k"], ["bk"],
                           "inner", output=["k", "v", "w"])
                .partial_aggregation(["k"], ["sum(v) AS s", "count(*) AS c",
                                             "max(w) AS hi"])
                .final_aggregation()
                .order_by(["k"]))

    with _probe_table(14):
        got = _check(meshes, make, "distributed_pipeline")
        assert_same(got, run_plan(make(TorchPlanBuilder, 1)), "serial")


def test_window_is_shuffled_by_partition_keys(meshes):
    from velox_tpu_torch.parallel import pipeline

    build = _values({"bk": list(range(50)),
                     "w": [float(i) * 0.5 for i in range(50)]},
                    {"bk": "B", "w": "D"})

    def make(pb, side):
        return (pb().table_scan("dp_probe", columns=["k", "k2", "v"])
                .hash_join(pb().values([build[side]]), ["k2"], ["bk"],
                           "inner", output=["k", "k2", "v", "w"])
                .window(["k2"], ["v", "k"],
                        ["row_number() AS rn", "rank() AS r",
                         "sum(v) AS sv", "lag(v) AS pv"])
                .order_by(["k2", "v", "k"]))

    calls = []
    orig = pipeline.window_flush

    def spy(*a, **kw):
        out = orig(*a, **kw)
        calls.append(out is not None)
        return out

    pipeline.window_flush = spy
    try:
        with _probe_table(21):
            got = _check(meshes, make, "distributed_pipeline")
            assert_same(got, run_plan(make(TorchPlanBuilder, 1)), "serial")
    finally:
        pipeline.window_flush = orig
    assert calls == [True]

