"""The multi-fragment exchange: the port against the JAX package.

The JAX package's ``tests/test_fragments.py`` cases and
``test_serial.py::test_serialized_exchange_matches_in_memory`` run
through both packages over the same rows, and the port's result must
equal the JAX package's row for row (DOUBLE to rtol=1e-9): in memory,
as pages, zlib pages, and streamed. Partition ids equal the reference's
bit for bit for integer, DOUBLE and decimal keys; a producer's pages
written by one package feed the other's ``ExchangeOp``. The port sends
each partition its rows compacted, and routes a string key by its value
(ROADMAP queue C: the reference routes by dictionary code).
"""

import numpy as np
import pytest

from torch_tpch_data import assert_same, table_in_both, values_in_both
from velox_tpu.exec import fragments as jf
from velox_tpu.plan import PlanBuilder as JaxPlanBuilder
from velox_tpu_torch.exec import fragments as tf
from velox_tpu_torch.exec.task import Task as TorchTask
from velox_tpu_torch.plan import PlanBuilder as TorchPlanBuilder


@pytest.fixture(scope="module")
def frag_table():
    rng = np.random.default_rng(9)
    n = 5000
    cols = {"k": rng.integers(0, 37, n).astype(np.int64),
            "v": rng.normal(size=n),
            "d": rng.integers(-10**6, 10**6, n).astype(np.int64)}
    with table_in_both("frag_t", cols, overrides={"d": (12, 2)},
                       batch_rows=512):
        yield cols


def _two_step(pb, mod, parts=4):
    a = (pb().table_scan("frag_t")
         .partial_aggregation(["k"], ["sum(v) AS s", "count(*) AS c",
                                      "sum(d) AS sd"]))
    a = mod.partitioned_output(a, ["k"], num_partitions=parts).build()
    b = (pb().exchange(a.source.output_type)
         .final_aggregation(["k"], ["sum(s) AS s", "count(c) AS c",
                                    "sum(sd) AS sd"]).build())
    return [mod.Fragment("A", a, num_tasks=1),
            mod.Fragment("B", b, num_tasks=parts,
                         exchange_sources={b.source.id: "A"})]


@pytest.mark.parametrize("serialize", [False, True])
def test_two_fragment_aggregation_matches_jax(frag_table, serialize):
    want = jf.run_fragments(_two_step(JaxPlanBuilder, jf),
                            serialize_pages=serialize).to_pydict()
    got = tf.run_fragments(_two_step(TorchPlanBuilder, tf),
                           serialize_pages=serialize, device="cpu")
    assert_same(got, want)
    assert len(got["k"]) == 37
    if serialize:
        zlib = tf.run_fragments(_two_step(TorchPlanBuilder, tf),
                                serialize_pages=True, compress="zlib",
                                device="cpu")
        assert_same(zlib, want)
        with pytest.raises(ValueError, match="zlib"):
            tf.run_fragments(_two_step(TorchPlanBuilder, tf),
                             serialize_pages=True, compress="zstd",
                             device="cpu")


def test_broadcast_output_matches_jax(frag_table):
    def frags(pb, mod):
        a = mod.partitioned_output(pb().table_scan("frag_t"), [], 3,
                                   broadcast=True).build()
        b = (pb().exchange(a.source.output_type)
             .aggregate([], ["count(*) AS c", "sum(k) AS sk"]).build())
        return [mod.Fragment("A", a),
                mod.Fragment("B", b, num_tasks=3,
                             exchange_sources={b.source.id: "A"})]

    want = jf.run_fragments(frags(JaxPlanBuilder, jf)).to_pydict()
    got = tf.run_fragments(frags(TorchPlanBuilder, tf), device="cpu")
    assert_same(got, want)
    assert got["c"] == [5000] * 3


def _partition_rows(mgr, n, reader):
    return [[v for b in mgr.drain("f", p) for v in reader(b)]
            for p in range(n)]


@pytest.mark.parametrize("kind,keys", [
    ("hash", ("k",)), ("hash", ("k", "v", "d")), ("round_robin", ()),
    ("hive_bucket", ("k", "d"))])
def test_partition_ids_are_the_references(frag_table, kind, keys):
    """The rows each partition gets, in order, over three batches (the
    round-robin cursor carries across them): the reference's, so its ids
    are the same, bit for bit."""
    from velox_tpu.exec.task import Task as JaxTask
    from velox_tpu.plan.nodes import new_id as jax_new_id
    from velox_tpu_torch.plan.nodes import new_id as torch_new_id

    n = 5
    jbatches = [b for b in JaxTask(JaxPlanBuilder().table_scan(
        "frag_t").build()).run()][:3]
    tbatches = [b for b in TorchTask(TorchPlanBuilder().table_scan(
        "frag_t").build()).run()][:3]
    jnode = jf.PartitionedOutputNode(jax_new_id(), jbatches[0].schema, None,
                                     keys, n, False, kind)
    tnode = tf.PartitionedOutputNode(torch_new_id(), tbatches[0].schema,
                                     None, keys, n, False, kind)
    jmgr, tmgr = jf.OutputBufferManager(), tf.OutputBufferManager()
    jop = jf.PartitionedOutputOp(jnode, jmgr, "f")
    top = tf.PartitionedOutputOp(tnode, tmgr, "f")
    for jb, tb in zip(jbatches, tbatches):
        jop.add_input(jb)
        top.add_input(tb)
    want = _partition_rows(jmgr, n, lambda b: b.to_pydict()["d"])
    parts = [tmgr.drain("f", p) for p in range(n)]
    got = [[v for b in ps for v in b.column("d").values[
        b.sel].tolist()] for ps in parts]
    assert got == want
    assert sum(map(len, got)) == 3 * 512
    # compacted: each batch holds its partition's rows only, densely
    for ps in parts:
        for b in ps:
            assert int(b.sel.sum()) == b.num_rows
            assert b.sel[:b.num_rows].all()


def test_serialized_exchange_matches_in_memory():
    """``test_serial.py``'s case through both packages."""
    from velox_tpu.types import BIGINT as JB
    from velox_tpu.vector.batch import Batch as JaxBatch
    from velox_tpu_torch.types import BIGINT as TB
    from velox_tpu_torch.vector.batch import Batch as TorchBatch

    def plans(pb, mod, batch):
        producer = mod.partitioned_output(
            pb().values([batch]), keys=["k"], num_partitions=4)
        consumer = (pb().exchange(producer.node.output_type)
                    .aggregate([], ["sum(v) as s", "count(k) as c"]))
        return [mod.Fragment("producer", producer.build()),
                mod.Fragment("consumer", consumer.build(), num_tasks=4,
                             exchange_sources={
                                 consumer.node.source.id: "producer"})]

    data = {"k": list(range(100)), "v": [i * 3 for i in range(100)]}
    jbatch = JaxBatch.from_pydict(data, {"k": JB, "v": JB})
    tbatch = TorchBatch.from_pydict(data, {"k": TB, "v": TB}, device="cpu")
    for serialize in (False, True):
        want = jf.run_fragments(plans(JaxPlanBuilder, jf, jbatch),
                                serialize_pages=serialize).to_pydict()
        got = tf.run_fragments(plans(TorchPlanBuilder, tf, tbatch),
                               serialize_pages=serialize, device="cpu")
        assert_same(got, want)
        assert (sum(got["s"]), sum(got["c"])) == (3 * sum(range(100)), 100)


def test_pages_of_either_package_feed_the_others_exchange(frag_table):
    """The JAX package's producer pages, read by the port's ExchangeOp,
    give the rows of the port's own pages, and the port's pages, read by
    the JAX package's ExchangeOp, the rows of the JAX package's own."""
    jfr = _two_step(JaxPlanBuilder, jf)
    tfr = _two_step(TorchPlanBuilder, tf)
    jmgr = jf.OutputBufferManager(serialize_pages=True)
    list(jf._make_task(jfr[0].plan, (jmgr, jfr[0], 0, {})).run())
    tmgr = tf.OutputBufferManager(serialize_pages=True, device="cpu")
    list(TorchTask(tfr[0].plan,
                   factories=tf._factories(tmgr, tfr[0], 0)).run())
    jpages, tpages = dict(jmgr._buffers), dict(tmgr._buffers)
    assert set(jpages) == set(tpages) == {("A", p) for p in range(4)}
    names = ["k", "s", "c", "sd"]

    def rows(dicts):
        return sorted(r for d in dicts for r in zip(*[d[n] for n in names]))

    def in_port(pages):
        mgr = tf.OutputBufferManager(serialize_pages=True, device="cpu")
        mgr._buffers.update(pages)
        return rows(b.to_pydict() for t in range(4) for b in TorchTask(
            tfr[1].plan, factories=tf._factories(mgr, tfr[1], t)).run())

    def in_jax(pages):
        mgr = jf.OutputBufferManager(serialize_pages=True)
        mgr._buffers.update(pages)
        return rows(b.to_pydict() for t in range(4) for b in jf._make_task(
            jfr[1].plan, (mgr, jfr[1], t, jfr[1].exchange_sources)).run())

    for got, want in ((in_port(jpages), in_port(tpages)),
                      (in_jax(tpages), in_jax(jpages))):
        assert len(got) == len(want) == 37
        for g, w in zip(got, want):
            assert (g[0], g[2], g[3]) == (w[0], w[2], w[3])
            np.testing.assert_allclose(g[1], w[1], rtol=1e-9)


def test_string_keys_route_by_value_over_two_dictionaries():
    """Two batches whose string column carries different dictionaries:
    the reference hashes the code, so some word goes to two partitions;
    the port hashes the word, so each word goes to one (ROADMAP queue
    C)."""
    from velox_tpu.plan.nodes import new_id as jax_new_id
    from velox_tpu.types import BIGINT as JB, VARCHAR as JV
    from velox_tpu.vector.batch import Batch as JaxBatch
    from velox_tpu_torch.plan.nodes import new_id as torch_new_id
    from velox_tpu_torch.types import BIGINT as TB, VARCHAR as TV
    from velox_tpu_torch.vector.batch import Batch as TorchBatch

    words = [f"w{i}" for i in range(40)]
    halves = [{"s": words[:30], "x": list(range(30))},
              {"s": words[10:], "x": list(range(30))}]
    jb = [JaxBatch.from_pydict(h, {"s": JV, "x": JB}) for h in halves]
    tb = [TorchBatch.from_pydict(h, {"s": TV, "x": TB}, device="cpu")
          for h in halves]

    def partitions_of_each_word(mod, new_id, batches):
        node = mod.PartitionedOutputNode(new_id(), batches[0].schema, None,
                                         ("s",), 4)
        mgr = mod.OutputBufferManager()
        op = mod.PartitionedOutputOp(node, mgr, "f")
        for b in batches:
            op.add_input(b)
        where = {}
        for p in range(4):
            for b in mgr.drain("f", p):
                for w in b.to_pydict()["s"]:
                    where.setdefault(w, set()).add(p)
        return where

    got = partitions_of_each_word(tf, torch_new_id, tb)
    assert sorted(got) == sorted(words)
    assert all(len(ps) == 1 for ps in got.values())
    want = partitions_of_each_word(jf, jax_new_id, jb)
    assert any(len(ps) > 1 for ps in want.values())


def test_streaming_fragments_match_jax(frag_table):
    """One producer, four consumers, streamed through a 16 KiB buffer:
    the rows of the JAX package's batch-mode run, in its task order, and
    the JAX package's streamed rows as a multiset."""
    want = jf.run_fragments(_two_step(JaxPlanBuilder, jf)).to_pydict()
    got = tf.run_fragments_streaming(_two_step(TorchPlanBuilder, tf),
                                     max_buffered_bytes=16 << 10,
                                     device="cpu")
    assert_same(got, want)
    streamed = jf.run_fragments_streaming(
        _two_step(JaxPlanBuilder, jf), max_buffered_bytes=16 << 10
    ).to_pydict()
    order = np.argsort(streamed["k"])
    assert_same({n: [v[i] for i in order] for n, v in streamed.items()},
                {n: [v[i] for i in np.argsort(got["k"])]
                 for n, v in got.items()})


def test_two_producer_tasks_finish_a_stream_together():
    """Three producer tasks and three consumers at once, the interpreter
    switching threads every 10 us: each consumer reads until every
    producer has published its end (the reference's consumers end at
    the first), so every row arrives, each exactly once."""
    import sys

    _, tb = values_in_both({"k": np.arange(3000, dtype=np.int64) % 50},
                           batch_rows=250)
    a = tf.partitioned_output(TorchPlanBuilder().values(tb), ["k"],
                              3).build()
    b = (TorchPlanBuilder().exchange(a.source.output_type)
         .aggregate(["k"], ["count(*) AS c"]).build())
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        got = tf.run_fragments_streaming(
            [tf.Fragment("A", a, num_tasks=3),
             tf.Fragment("B", b, num_tasks=3,
                         exchange_sources={b.source.id: "A"})],
            max_buffered_bytes=4 << 10, device="cpu")
    finally:
        sys.setswitchinterval(old)
    assert sorted(got["k"]) == list(range(50))
    assert got["c"] == [180] * 50
