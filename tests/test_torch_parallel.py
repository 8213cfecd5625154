"""The port's shard mesh, hash shuffle and distributed aggregation
against the JAX package's on its 8-virtual-device CPU mesh.

The same numpy arrays go through ``jax.shard_map`` over the JAX
package's functions and through the port's functions over 8 shards on
the CPU, and each shard's result must be the same: the rows it received
(values and valid masks, in order; the JAX package's padding left out),
the groups it holds. Integer keys only: the port routes a string key by
its value's crc32 where the reference hashes its dictionary code.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from velox_tpu.parallel import make_mesh as jax_make_mesh
from velox_tpu.parallel.aggregate import (
    make_distributed_aggregate as jax_make_aggregate,
)
from velox_tpu.parallel.shuffle import (
    bucket_by_destination as jax_bucket, hash_repartition as jax_repartition,
)
from velox_tpu.types import DOUBLE as JDOUBLE
from velox_tpu_torch.parallel import make_mesh, make_distributed_aggregate
from velox_tpu_torch.parallel.collectives import (
    all_gather, all_to_all, any_reduce,
)
from velox_tpu_torch.parallel.shuffle import (
    bucket_by_destination, hash_repartition,
)
from velox_tpu_torch.types import DOUBLE as TDOUBLE

N = 8
ROWS = 256


@pytest.fixture(scope="module")
def meshes():
    return jax_make_mesh(N), make_mesh(N, device="cpu")


def _shards(a):
    return [torch.from_numpy(np.ascontiguousarray(x))
            for x in np.split(a, N)]


@pytest.fixture(scope="module")
def rows():
    rng = np.random.default_rng(0)
    n = N * ROWS
    sel = np.ones(n, dtype=bool)
    sel[::13] = False
    kvalid = rng.random(n) > 0.1
    return {"k": rng.integers(0, 40, n).astype(np.int64),
            "v": rng.normal(size=n), "sel": sel, "kvalid": kvalid}


def test_make_mesh_needs_a_card_or_the_cpu():
    mesh = make_mesh(8, device="cpu")
    assert mesh.size == 8 and mesh.axis == "d"
    assert all(d == torch.device("cpu") for d in mesh.devices)
    assert make_mesh(device="cpu").size == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh(8)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()
    with pytest.raises(ValueError):
        make_mesh(0, device="cpu")


def test_collectives_move_what_each_shard_sends():
    devs = make_mesh(3, device="cpu").devices
    send = [[torch.full((s + r,), 10 * s + r) for r in range(3)]
            for s in range(3)]
    recv = all_to_all(send, devs)
    for r in range(3):
        want = torch.cat([torch.full((s + r,), 10 * s + r)
                          for s in range(3)])
        assert torch.equal(recv[r], want)
    g = all_gather([torch.tensor([s, s]) for s in range(3)], devs)
    assert all(torch.equal(x, torch.tensor([[0, 0], [1, 1], [2, 2]]))
               for x in g)
    flags = [torch.tensor([True, False, False]),
             torch.tensor([False, False, True])]
    assert any_reduce(flags, devs[0]).tolist() == [True, False, True]


def test_bucket_by_destination_is_the_references(rows):
    """One shard's fixed send layout, overflow counted, both ways."""
    k, sel = rows["k"][:ROWS], rows["sel"][:ROWS]
    dest = (k % N).astype(np.int32)
    for cap in (ROWS, 9):   # 9 a destination overflows
        jb, jv, jo = jax_bucket([jnp.asarray(k)], jnp.asarray(dest),
                                jnp.asarray(sel), N, cap)
        tb, tv, to = bucket_by_destination(
            [torch.from_numpy(k)], torch.from_numpy(dest),
            torch.from_numpy(sel), N, cap)
        assert np.array_equal(np.asarray(jb[0]), tb[0].numpy())
        assert np.array_equal(np.asarray(jv), tv.numpy())
        assert int(jo) == int(to)
    assert int(to) > 0


def test_hash_repartition_places_rows_as_the_reference(meshes, rows):
    """Every row on the JAX package's shard, in its order there; overflow
    0; a nullable key's valid lane travels with the rows."""
    jmesh, tmesh = meshes
    k, v, sel, kv = rows["k"], rows["v"], rows["sel"], rows["kvalid"]

    def step(k, v, kv, s):
        recv, rsel, overflow = jax_repartition(
            [k, v, kv], [(k, kv)], s, "d", N)
        return recv[0], recv[1], recv[2], rsel, overflow[None]

    f = shard_map(step, mesh=jmesh, in_specs=(P("d"),) * 4,
                  out_specs=(P("d"),) * 5)
    jk, jv, jkv, jsel, jo = map(np.asarray, jax.jit(f)(
        jnp.asarray(k), jnp.asarray(v), jnp.asarray(kv), jnp.asarray(sel)))
    assert int(jo.sum()) == 0
    ks, vs, kvs, ss = (_shards(a) for a in (k, v, kv, sel))
    recv, valid, overflow = hash_repartition(
        [[a, b, c] for a, b, c in zip(ks, vs, kvs)],
        [[(a, c)] for a, c in zip(ks, kvs)], ss, tmesh.devices)
    assert overflow == 0
    per = jsel.shape[0] // N
    for r in range(N):
        m = jsel[r * per:(r + 1) * per]
        assert valid[r].all() and valid[r].shape[0] == int(m.sum())
        for got, want in zip(recv[r], (jk, jv, jkv)):
            assert np.array_equal(got.numpy(), want[r * per:(r + 1) * per][m])
    assert sum(int(x.shape[0]) for x in valid) == int(sel.sum())


def test_distributed_group_by_is_the_references(meshes, rows):
    """Keyed: each shard's groups (in key order, NULL key included) and
    their sum/count/min, shard for shard."""
    jmesh, tmesh = meshes
    k, v, sel, kv = rows["k"], rows["v"], rows["sel"], rows["kvalid"]
    jstep = jax_make_aggregate("d", N, 1, [("sum", JDOUBLE), ("count", None),
                                            ("min", JDOUBLE)])

    def run(k, kv, v, s):
        return jstep([k], [kv], [v, None, v], s)

    f = shard_map(run, mesh=jmesh, in_specs=(P("d"),) * 4,
                  out_specs=([P("d")], [P("d")], [P("d")] * 3,
                             [P("d")] * 3, P("d")))
    jk, jkv, jres, jval, jsel = jax.jit(f)(
        jnp.asarray(k), jnp.asarray(kv), jnp.asarray(v), jnp.asarray(sel))
    jsel = np.asarray(jsel)
    tstep = make_distributed_aggregate(tmesh, 1, [("sum", TDOUBLE),
                                                  ("count", None),
                                                  ("min", TDOUBLE)])
    ks, kvs, vs, ss = (_shards(a) for a in (k, kv, v, sel))
    out = tstep([[a] for a in ks], [[a] for a in kvs],
                [[a, None, a] for a in vs], ss)
    per = jsel.shape[0] // N
    total = 0
    for r, (gk, gkv, res, val, gsel) in enumerate(out):
        m = jsel[r * per:(r + 1) * per]
        g = gsel.numpy()
        total += int(g.sum())
        assert int(g.sum()) == int(m.sum())
        sl = slice(r * per, (r + 1) * per)
        assert np.array_equal(gkv[0].numpy()[g], np.asarray(jkv[0])[sl][m])
        live = gkv[0].numpy()[g]
        assert np.array_equal(gk[0].numpy()[g][live],
                              np.asarray(jk[0])[sl][m][live])
        np.testing.assert_allclose(res[0].numpy()[g],
                                   np.asarray(jres[0])[sl][m], rtol=1e-12)
        assert np.array_equal(res[1].numpy()[g], np.asarray(jres[1])[sl][m])
        np.testing.assert_allclose(res[2].numpy()[g],
                                   np.asarray(jres[2])[sl][m], rtol=1e-12)
    # 40 keys and the NULL key
    assert total == len(set(k[sel & kv].tolist())) + int((sel & ~kv).any())


def test_distributed_keyless_aggregate_is_the_references(meshes, rows):
    jmesh, tmesh = meshes
    v, sel = rows["v"], rows["sel"].copy()
    sel[: N * ROWS // 4] = False
    jstep = jax_make_aggregate("d", N, 0, [("sum", JDOUBLE), ("count", None),
                                            ("max", JDOUBLE)])
    f = shard_map(lambda v, s: jstep([], [], [v, None, v], s), mesh=jmesh,
                  in_specs=(P("d"), P("d")),
                  out_specs=([], [], [P(None)] * 3, [P(None)] * 3, P(None)),
                  check_vma=False)
    _, _, jres, _, _ = jax.jit(f)(jnp.asarray(v), jnp.asarray(sel))
    tstep = make_distributed_aggregate(tmesh, 0, [("sum", TDOUBLE),
                                                  ("count", None),
                                                  ("max", TDOUBLE)])
    out = tstep([[]] * N, [[]] * N, [[a, None, a] for a in _shards(v)],
                _shards(sel))
    for _, _, res, val, gsel in out:   # every shard holds the result
        assert gsel.tolist()[:2] == [True, False]
        assert res[0][0].item() == pytest.approx(float(jres[0][0]),
                                                 rel=1e-12)
        assert res[0][0].item() == pytest.approx(v[sel].sum(), rel=1e-12)
        assert int(res[1][0]) == int(jres[1][0]) == int(sel.sum())
        assert res[2][0].item() == float(jres[2][0]) == v[sel].max()


def _tensors(obj, seen):
    """Every tensor reachable from ``obj`` through containers, dataclasses
    and the port's objects (a plan node and callbacks aside, which a
    replica shares with its original)."""
    import dataclasses

    if id(obj) in seen:
        return
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v, seen)
    elif isinstance(obj, (list, tuple, set)):
        for v in obj:
            yield from _tensors(v, seen)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from _tensors(getattr(obj, f.name), seen)
    elif (hasattr(obj, "__dict__")
          and type(obj).__module__.startswith("velox_tpu_torch")):
        for k, v in vars(obj).items():
            if k not in ("node", "on_ready"):
                yield from _tensors(v, seen)


def test_a_replicated_build_lives_wholly_on_its_device():
    """``move`` makes a probe's replica of a join bridge for another
    device: every tensor reachable from the copy (the build batch, the
    sorted keys, the kArray tables, the key codec and its probe-dictionary
    remap, the matched flags) is on that device, and the original is
    untouched. The meta device stands in for a second card."""
    from velox_tpu_torch.exec.task import LocalPlanner
    from velox_tpu_torch.io.catalog import drop_table, register_columns
    from velox_tpu_torch.parallel.pipeline import _Replicas, _run_builds
    from velox_tpu_torch.plan import PlanBuilder
    from velox_tpu_torch.types import BIGINT, VARCHAR
    from velox_tpu_torch.vector.batch import Batch

    rng = np.random.default_rng(5)
    words = ["ash", "birch", "cedar", "dune", "elm", "fir"]
    register_columns("mv_probe", {"s": rng.integers(0, 6, 900),
                                  "k": rng.integers(0, 30, 900)},
                     {"s": words}, 256, device="cpu")
    build = Batch.from_pydict(
        {"bs": ["elm", "ash", "fir", "oak"], "bk": [1, 2, 3, 4],
         "w": [0.5, 1.5, 2.5, 3.5]},
        {"bs": VARCHAR, "bk": BIGINT, "w": TDOUBLE}, device="cpu")
    try:
        for keys in (["s"], ["s", "k"]):
            plan = (PlanBuilder().table_scan("mv_probe")
                    .hash_join(PlanBuilder().values([build]), keys,
                               ["bs", "bk"][:len(keys)], "right",
                               output=["s", "k", "bk", "w"]).build())
            planner = LocalPlanner(plan)
            _run_builds(planner.pipelines)
            scan, probe = planner.operators[:2]
            br = probe.bridge
            # a probe batch over another dictionary fills the codec's remap
            probe.runs(scan.get_output(), br)
            assert br.codec._remaps and br.matched is not None
            before = [(t, t.device) for t in _tensors(br, set())]
            assert before and all(d.type == "cpu" for _, d in before)
            meta = torch.device("meta")
            copy = _Replicas(br).on(meta)
            assert copy is not br and copy.node is br.node
            got = list(_tensors(copy, set()))
            assert len(got) == len(before)
            assert all(t.device == meta for t in got), [
                t.device for t in got]
            assert [(t, t.device) for t in _tensors(br, set())] == before
    finally:
        drop_table("mv_probe")


def test_a_ranged_sort_orders_strings_across_dictionaries(meshes):
    """ORDER BY a string first key over shard batches whose dictionaries
    differ (each batch's own values): the splitters and destinations
    compare values, so the shards in order hold the serial order."""
    from velox_tpu_torch.exec import run_plan
    from velox_tpu_torch.parallel.pipeline import ranged_sort
    from velox_tpu_torch.plan import PlanBuilder
    from velox_tpu_torch.types import BIGINT, VARCHAR
    from velox_tpu_torch.vector.batch import Batch

    _, mesh = meshes
    rng = np.random.default_rng(9)
    words = [f"w{i:02d}" for i in range(60)]
    batches = []
    for i in range(N):
        # shard i draws from its own window of words: its dictionary
        pick = rng.integers(0, 20, 40) + 5 * i
        batches.append(Batch.from_pydict(
            {"s": [words[j] for j in pick],
             "n": [int(x) for x in rng.integers(0, 1000, 40)]},
            {"s": VARCHAR, "n": BIGINT}, device="cpu"))
    dicts = {id(b.column("s").dictionary) for b in batches}
    assert len(dicts) == N
    plan = PlanBuilder().values(batches).order_by(["s DESC", "n"]).build()
    want = run_plan(plan)
    out = ranged_sort(plan, [[b] for b in batches], mesh)
    got = {"s": [], "n": []}
    for bs in out:
        for b in bs:
            for c, vals in b.to_pydict().items():
                got[c].extend(vals)
    assert sum(bool(b.num_rows) for bs in out for b in bs) > N // 2
    assert got == want


def test_an_empty_result_keeps_its_strategy(meshes, monkeypatch):
    """A filter after a join that selects nothing: a covered shape
    returns its empty result and never reruns the plan serially. With an
    aggregation after it both packages report ``distributed_pipeline``.
    A LIMIT after it emits no batch at all; the JAX package's runner
    takes that for a shape it does not cover and reruns the plan
    serially (``serial_fallback``), the port keeps its strategy (ROADMAP,
    differences)."""
    from torch_tpch_data import assert_same, table_in_both
    from velox_tpu.parallel import runner as jax_runner
    from velox_tpu.plan import PlanBuilder as JaxPlanBuilder
    from velox_tpu.types import BIGINT as JBIGINT
    from velox_tpu.vector.batch import Batch as JaxBatch
    from velox_tpu_torch.exec import run_plan
    from velox_tpu_torch.exec.task import Task
    from velox_tpu_torch.parallel import runner
    from velox_tpu_torch.plan import PlanBuilder as TorchPlanBuilder
    from velox_tpu_torch.types import BIGINT as TBIGINT
    from velox_tpu_torch.vector.batch import Batch as TorchBatch

    jmesh, tmesh = meshes
    data = {"bk": list(range(0, 200, 2)),
            "w": [float(i) / 7 for i in range(100)]}
    build = (JaxBatch.from_pydict(data, {"bk": JBIGINT, "w": JDOUBLE}),
             TorchBatch.from_pydict(data, {"bk": TBIGINT, "w": TDOUBLE},
                                    device="cpu"))

    def joined(pb, side):
        return (pb().table_scan("empty_probe", columns=["k", "v"])
                .hash_join(pb().values([build[side]]), ["k"], ["bk"],
                           "inner", output=["k", "v", "w"])
                .filter("v > 100.0"))

    tails = {
        "agg": (lambda pb, side: joined(pb, side).aggregate(
            ["k"], ["sum(v) AS s", "count(*) AS c"]),
            "distributed_pipeline"),
        "limit": (lambda pb, side: joined(pb, side).limit(10),
                  "serial_fallback"),
    }
    serial_runs = []
    run = Task.run

    def counted(self):
        serial_runs.append(1)
        return run(self)

    rng = np.random.default_rng(16)
    with table_in_both("empty_probe", {"k": rng.integers(0, 200, 4000),
                                       "v": rng.normal(size=4000)},
                       batch_rows=512):
        for name, (make, jax_strategy) in tails.items():
            want = jax_runner.run_plan_distributed(
                make(JaxPlanBuilder, 0).build(), jmesh).to_pydict()
            assert jax_runner.last_strategy == jax_strategy, name
            monkeypatch.setattr(Task, "run", counted)
            got = runner.run_plan_distributed(
                make(TorchPlanBuilder, 1).build(), tmesh)
            monkeypatch.setattr(Task, "run", run)
            assert runner.last_strategy == "distributed_pipeline", name
            assert serial_runs == [], name
            assert all(len(v) == 0 for v in got.values()), name
            assert_same(got, want, name)
            assert_same(got, run_plan(make(TorchPlanBuilder, 1)), name)
