"""The streaming exchange of the port: backpressure, ack windows, TCP.

The port's counterparts of ``tests/test_exchange_net.py``, with the JAX
package as the other side where the wire is shared: a producer process
running the port serves pages that both packages' socket clients read,
and a streamed two-fragment plan equals the JAX package's rows. Every
wait in the port has a deadline: a dead producer, a producer that never
finishes and a failed task raise within seconds instead of hanging.
"""

import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from velox_tpu_torch.exec.exchange_net import (
    ExchangeServer, LocalExchangeSource, RemoteExchangeSource,
    StreamingBufferManager, consume_source,
)
from velox_tpu_torch.serial import serialize_page
from velox_tpu_torch.types import BIGINT, DOUBLE
from velox_tpu_torch.vector.batch import Batch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _page(i, rows=64):
    rng = np.random.default_rng(i)
    b = Batch.from_pydict(
        {"k": [int(x) for x in rng.integers(0, 100, rows)],
         "v": [float(x) for x in rng.normal(size=rows)]},
        {"k": BIGINT, "v": DOUBLE}, device="cpu")
    return serialize_page(b), b


def test_streaming_backpressure_and_order():
    pages = [_page(i) for i in range(30)]
    one = len(pages[0][0])
    mgr = StreamingBufferManager(max_buffered_bytes=3 * one + 10)

    def produce():
        for p, _ in pages:
            mgr.enqueue("f", 0, p)
        mgr.no_more_data("f", [0])

    t = threading.Thread(target=produce)
    t.start()
    time.sleep(0.2)
    assert mgr.buffered_bytes("f", 0) <= 3 * one + 10
    got = list(consume_source(LocalExchangeSource(mgr, "f", 0),
                              max_bytes=one, device="cpu"))
    t.join(timeout=10)
    assert not t.is_alive()
    assert mgr.blocked_count > 0, "backpressure never engaged"
    assert [g.to_pydict() for g in got] == [b.to_pydict() for _, b in pages]


def test_unacked_pages_can_be_refetched():
    (p0, _), (p1, _) = _page(0), _page(1)
    mgr = StreamingBufferManager()
    mgr.enqueue("f", 0, p0)
    mgr.enqueue("f", 0, p1)
    mgr.no_more_data("f", [0])
    pages, nxt, end = mgr.get_data("f", 0, 0, max_bytes=1 << 30)
    assert len(pages) == 2 and nxt == 2 and end
    assert mgr.get_data("f", 0, 0, max_bytes=1 << 30)[0] == pages
    mgr.ack("f", 0, 2)
    with pytest.raises(ValueError, match="already acked"):
        mgr.get_data("f", 0, 0)


_PRODUCER = r"""
import sys, time
sys.path.insert(0, {repo!r})
import numpy as np
from velox_tpu_torch.exec.exchange_net import (
    ExchangeServer, StreamingBufferManager)
from velox_tpu_torch.serial import serialize_page
from velox_tpu_torch.types import BIGINT, DOUBLE
from velox_tpu_torch.vector.batch import Batch

mgr = StreamingBufferManager(max_buffered_bytes=1 << 16)
srv = ExchangeServer(mgr, port=0)
print(srv.port, flush=True)

def page(i):
    rng = np.random.default_rng(i)
    return serialize_page(Batch.from_pydict(
        {{"k": [int(x) for x in rng.integers(0, 100, 64)],
          "v": [float(x) for x in rng.normal(size=64)]}},
        {{"k": BIGINT, "v": DOUBLE}}, device="cpu"))

for part in range({parts}):
    for i in range(12):
        mgr.enqueue("stage1", part, page(part * 100 + i))
    if {finish}:
        mgr.no_more_data("stage1", [part])
time.sleep(60)
"""


def _producer(parts=2, finish=True):
    proc = subprocess.Popen(
        [sys.executable, "-c", _PRODUCER.format(repo=REPO, parts=parts,
                                                finish=finish)],
        stdout=subprocess.PIPE, text=True)
    return proc, int(proc.stdout.readline().strip())


def test_two_process_socket_exchange_read_by_both_packages():
    """The child process is the port; the port's client and the JAX
    package's read its pages with fetch windows, byte-exact."""
    from velox_tpu.exec import exchange_net as jax_net

    proc, port = _producer()
    try:
        for part, (client, consume) in enumerate((
                (RemoteExchangeSource,
                 lambda s: consume_source(s, 2048, device="cpu")),
                (jax_net.RemoteExchangeSource,
                 lambda s: jax_net.consume_source(s, 2048)))):
            src = client("127.0.0.1", port, "stage1", part)
            got = list(consume(src))
            src.close()
            assert len(got) == 12
            assert src.roundtrips > 3, "no fetch windowing happened"
            for i, b in enumerate(got):
                rng = np.random.default_rng(part * 100 + i)
                assert b.to_pydict()["k"] == [
                    int(x) for x in rng.integers(0, 100, 64)]
    finally:
        proc.kill()
        proc.wait()


def test_a_dead_producer_raises_instead_of_hanging():
    """The producer process dies while the consumer waits for the end of
    a stream it never finishes: the consumer raises within seconds."""
    proc, port = _producer(parts=1, finish=False)
    src = RemoteExchangeSource("127.0.0.1", port, "stage1", 0, timeout=20)
    try:
        gen = consume_source(src, 1 << 20, device="cpu")
        assert len([next(gen) for _ in range(12)]) == 12
        threading.Timer(0.5, proc.kill).start()
        t0 = time.monotonic()
        with pytest.raises((ConnectionError, OSError, RuntimeError)):
            next(gen)
        assert time.monotonic() - t0 < 15
    finally:
        src.close()
        proc.kill()
        proc.wait()


def test_waits_time_out_and_abort():
    """A producer that never finishes, and a buffer no consumer drains,
    raise TimeoutError at their deadline; ``abort`` wakes every waiter
    with the failure."""
    (p0, _), (p1, _) = _page(0), _page(1)
    mgr = StreamingBufferManager(max_buffered_bytes=len(p0), timeout=0.3)
    mgr.enqueue("f", 0, p0)
    with pytest.raises(TimeoutError):
        mgr.enqueue("f", 0, p1)
    with pytest.raises(TimeoutError):
        mgr.get_data("f", 0, 1)
    errors = []

    def wait():
        try:
            mgr.get_data("f", 1, 0, timeout=30)
        except RuntimeError as e:
            errors.append(e)

    t = threading.Thread(target=wait)
    t.start()
    mgr.abort(ValueError("a task failed"))
    t.join(timeout=5)
    assert not t.is_alive() and "a task failed" in str(errors[0])


def _fragments(pb, mod, batches, parts=3):
    prod = mod.partitioned_output(pb().values(batches), ["k"], parts)
    cons = (pb().exchange(prod.node.output_type)
            .aggregate(["k"], ["sum(v) AS s", "count(*) AS c"]))
    return [mod.Fragment("p", prod.build()),
            mod.Fragment("c", cons.build(), num_tasks=parts,
                         exchange_sources={cons.node.source.id: "p"})]


@pytest.fixture(scope="module")
def streamed():
    from torch_tpch_data import values_in_both

    rng = np.random.default_rng(5)
    n = 4000
    return values_in_both({"k": rng.integers(0, 50, n).astype(np.int64),
                           "v": rng.normal(size=n)}, batch_rows=500)


def test_streaming_overlap_over_tcp_and_locally(streamed):
    """Producer and consumers at once through a 16 KiB buffer (producers
    first would deadlock there), locally and over TCP: the rows of the
    JAX package's run, and over TCP each consumer fetched in windows."""
    from torch_tpch_data import assert_same
    from velox_tpu.exec import fragments as jf
    from velox_tpu.plan import PlanBuilder as JaxPlanBuilder
    from velox_tpu_torch.exec import fragments as tf
    from velox_tpu_torch.exec.exchange_net import METRIC_EXCHANGE_FETCHES
    from velox_tpu_torch.plan import PlanBuilder as TorchPlanBuilder
    from velox_tpu_torch.utils.metrics import reporter

    jb, tb = streamed
    want = jf.run_fragments(_fragments(JaxPlanBuilder, jf, jb)).to_pydict()
    for transport in ("local", "tcp"):
        before = reporter.counters[METRIC_EXCHANGE_FETCHES]
        got = tf.run_fragments_streaming(
            _fragments(TorchPlanBuilder, tf, tb), max_buffered_bytes=16 << 10,
            device="cpu", transport=transport)
        assert_same(got, want, transport)
        assert reporter.counters[METRIC_EXCHANGE_FETCHES] - before > 3


def test_a_failed_task_fails_the_stream(streamed):
    """A consumer's fetch fails: ``run_fragments_streaming`` raises that
    error and stops the producer blocked on a full buffer, and the next
    run works."""
    from velox_tpu_torch.exec import fragments as tf
    from velox_tpu_torch.plan import PlanBuilder as TorchPlanBuilder
    from velox_tpu_torch.utils.testvalue import TestValue

    class FetchBoom(ConnectionError):
        pass

    def fail(payload):
        raise FetchBoom(f"injected fetch failure at {payload}")

    _, tb = streamed
    t0 = time.monotonic()
    with TestValue.scoped("velox_tpu.exchange.get_data", fail):
        with pytest.raises(FetchBoom):
            tf.run_fragments_streaming(
                _fragments(TorchPlanBuilder, tf, tb),
                max_buffered_bytes=4 << 10, device="cpu")
    assert time.monotonic() - t0 < 30
    got = tf.run_fragments_streaming(_fragments(TorchPlanBuilder, tf, tb),
                                     device="cpu")
    assert sum(got["c"]) == 4000


def test_server_closes_and_refuses_new_connections():
    mgr = StreamingBufferManager()
    with ExchangeServer(mgr) as srv:
        port = srv.port
        mgr.enqueue("f", 0, _page(3)[0])
        mgr.no_more_data("f", [0])
        src = RemoteExchangeSource("127.0.0.1", port, "f", 0, timeout=5)
        assert len(list(consume_source(src, device="cpu"))) == 1
        src.close()
    with pytest.raises(OSError):
        RemoteExchangeSource("127.0.0.1", port, "f", 0, timeout=2)


def test_streamed_tasks_spill_into_their_own_query_pools(streamed):
    """Three consumer tasks on three threads, each with an OrderBy that
    spills under a 1 KiB budget: every spilled buffer hangs off its own
    task's query pool, and the rows are those of the unspilled run."""
    from velox_tpu_torch.exec import fragments as tf
    from velox_tpu_torch.plan import PlanBuilder as TorchPlanBuilder
    from velox_tpu_torch.utils.config import config
    from velox_tpu_torch.utils.testvalue import TestValue

    _, tb = streamed

    def fragments():
        prod = tf.partitioned_output(TorchPlanBuilder().values(tb), ["k"], 3)
        cons = (TorchPlanBuilder().exchange(prod.node.output_type)
                .order_by(["v"]))
        return [tf.Fragment("p", prod.build()),
                tf.Fragment("c", cons.build(), num_tasks=3,
                            exchange_sources={cons.node.source.id: "p"})]

    want = tf.run_fragments_streaming(fragments(), device="cpu")
    pools = {}

    def seen(buf):
        pools.setdefault(threading.current_thread().name, set()).add(
            id(buf.pool.query_pool()))

    old = config.spill_memory_budget_bytes
    config.spill_memory_budget_bytes = 1 << 10
    try:
        with TestValue.scoped("velox_tpu.spill.spill_all", seen):
            got = tf.run_fragments_streaming(fragments(), device="cpu")
    finally:
        config.spill_memory_budget_bytes = old
    assert got == want
    consumers = {n: p for n, p in pools.items() if "-c-" in n}
    assert len(consumers) == 3, pools
    assert all(len(p) == 1 for p in consumers.values())
    assert len(set.union(*consumers.values())) == 3
