"""Multi-fragment execution: the exchange's control plane (the port of the
JAX package's ``exec/fragments.py``).

velox's distributed-query contract in one process:
``PartitionedOutput`` ends a producer fragment and routes each row to a
consumer partition (velox/exec/PartitionedOutput.cpp:426); consumer
fragments start from ``Exchange`` operators that read their partition
(velox/exec/Exchange.cpp). ``run_fragments`` runs the fragments in
order, producers first, each as one Task a partition, through an
in-process ``OutputBufferManager`` (velox/exec/OutputBufferManager.h:41)
that holds live batches or, with ``serialize_pages``, ``serial/page.py``
pages (the cross-host form); ``run_fragments_streaming`` runs every task
at once on threads against the bounded ``StreamingBufferManager`` of
``exec/exchange_net.py``, locally or over TCP. Results come back as
``{column: [values]}`` of the last fragment, its tasks in order.

Where the JAX package enqueues every batch once a partition, full width
under a partition's mask, the port sends each partition its own rows,
compacted: one stable sort of the rows by partition id and one host read
of the partition counts a batch. A partition keeps its rows' order, so
each consumer sees the rows the reference's sees, in the same order; a
partition that got no row from a producer task gets one empty batch at
its end, so its consumer still learns the schema, dictionaries and
device. Partition ids are the
reference's bit for bit (``ops/hash.py``), but for a string key, which
routes by its value's crc32 where the reference hashes the dictionary
code: two producers whose dictionaries differ would send one string to
two consumers there. Each task's operators for the exchange node types
are given to its Task (``factories``), so no task touches another's
registry, and streaming tasks are built in order before any starts.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from velox_tpu_torch.exec.operator import Operator
from velox_tpu_torch.exec.task import Task, collect_result
from velox_tpu_torch.ops.hash import (
    hash_columns, hive_bucket_ids, partition_ids,
)
from velox_tpu_torch.plan.nodes import ExchangeNode, PlanNode, SourceNode
from velox_tpu_torch.plan.serde import register_node_type
from velox_tpu_torch.utils import syncs
from velox_tpu_torch.utils.metrics import reporter
from velox_tpu_torch.vector.batch import Batch, round_capacity

#: pages and page bytes a producer wrote, and its serialize seconds
METRIC_EXCHANGE_PAGES = "velox_tpu.exchange_pages"
METRIC_EXCHANGE_BYTES = "velox_tpu.exchange_bytes"
METRIC_EXCHANGE_SERIALIZE_S = "velox_tpu.exchange_serialize_s"

#: seconds ``run_fragments_streaming`` waits for its tasks
STREAMING_TIMEOUT_S = 300.0


@dataclass(frozen=True)
class PartitionedOutputNode(SourceNode):
    """A fragment's end: rows to consumer partitions by key, or every row
    to every partition (velox/core/PlanNode.h:2712)."""

    keys: Tuple[str, ...] = ()
    num_partitions: int = 1
    broadcast: bool = False
    #: "hash" | "round_robin" | "hive_bucket" (velox's PartitionFunction
    #: family: exec/HashPartitionFunction.h, RoundRobinPartitionFunction,
    #: connectors/hive/HivePartitionFunction.h)
    partition_kind: str = "hash"


register_node_type(PartitionedOutputNode)


def _serialize(batch: Batch, compress) -> bytes:
    from velox_tpu_torch.serial import serialize_page

    t0 = time.perf_counter()
    page = serialize_page(batch, compress=compress)
    reporter.add_counter(METRIC_EXCHANGE_SERIALIZE_S,
                         time.perf_counter() - t0)
    reporter.add_counter(METRIC_EXCHANGE_PAGES)
    reporter.add_counter(METRIC_EXCHANGE_BYTES, len(page))
    return page


def _deserialize(page: bytes, device) -> Batch:
    from velox_tpu_torch.exec.exchange_net import (
        METRIC_EXCHANGE_DESERIALIZE_S,
    )
    from velox_tpu_torch.serial import deserialize_page

    t0 = time.perf_counter()
    b = deserialize_page(page, device)
    reporter.add_counter(METRIC_EXCHANGE_DESERIALIZE_S,
                         time.perf_counter() - t0)
    return b


def _compression(compress):
    """False, or "zlib" (True means zlib): the card's machine has no
    ``zstandard``."""
    if compress in (False, None):
        return False
    if compress in (True, "zlib"):
        return "zlib"
    raise ValueError(f"exchange compression {compress!r}: use False or "
                     "'zlib'")


class OutputBufferManager:
    """In-process buffers keyed by (fragment, partition): live batches,
    or with ``serialize_pages`` pages (zlib with ``compress``), which
    ``drain`` reads back onto ``device`` (``None``: the card)."""

    def __init__(self, serialize_pages: bool = False, compress=False,
                 device=None):
        self._buffers: Dict[tuple, list] = defaultdict(list)
        self._serialize = serialize_pages
        self._compress = _compression(compress)
        self._device = device

    def enqueue(self, fragment: str, partition: int, batch) -> None:
        """A batch, or a page serialized once for several partitions."""
        if self._serialize and not isinstance(batch, bytes):
            batch = _serialize(batch, self._compress)
        self._buffers[(fragment, partition)].append(batch)

    def page_of(self, batch: Batch):
        """What ``enqueue`` would store for ``batch``, made once (a
        broadcast sends it to every partition)."""
        return _serialize(batch, self._compress) if self._serialize else batch

    def drain(self, fragment: str, partition: int) -> List[Batch]:
        items = self._buffers.pop((fragment, partition), [])
        if self._serialize:
            return [_deserialize(p, self._device) for p in items]
        return items


def _key_lane(col) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """A key column as the partition hash reads it: a string by its
    value's crc32 (so equal strings of two dictionaries meet), any other
    lane as it is."""
    if col.dictionary is None:
        return col.values, col.valid
    from velox_tpu_torch.exec.spill import _string_hashes

    dev = col.values.device
    table = col.dictionary.derived(
        ("crc32_lane", str(dev)),
        lambda d: torch.from_numpy(_string_hashes(d)).to(dev))
    idx = (col.values.to(torch.int64) + 1).clamp(0, table.shape[0] - 1)
    return table.index_select(0, idx), col.valid


class PartitionedOutputOp(Operator):
    """velox/exec/PartitionedOutput.cpp:426: route each input batch's rows
    to the partitions and enqueue each partition's rows, compacted."""

    blocking = True

    def __init__(self, node: PartitionedOutputNode, manager, fragment: str):
        super().__init__(node)
        self.manager = manager
        self.fragment = fragment
        self._rr_next = 0
        self._last: Optional[Batch] = None
        self._fed = [False] * node.num_partitions

    def _broadcasts(self) -> bool:
        node = self.node
        return node.broadcast or (not node.keys
                                  and node.partition_kind != "round_robin")

    def _partition_ids(self, batch: Batch) -> torch.Tensor:
        """Each row's partition (int32), as the reference computes it."""
        node = self.node
        n = node.num_partitions
        if node.partition_kind == "round_robin":
            ranks = torch.cumsum(batch.sel.to(torch.int64), 0) - 1
            return ((ranks + self._rr_next) % n).to(torch.int32)
        cols = [_key_lane(batch.column(k)) for k in node.keys]
        if node.partition_kind == "hive_bucket":
            return hive_bucket_ids(cols, n).to(torch.int32)
        return partition_ids(hash_columns(cols), n)

    def split(self, batch: Batch) -> List[Optional[Batch]]:
        """Each partition's live rows of ``batch`` in their order, as a
        dense batch (None for a partition without rows): one stable sort
        by partition id and one host read of the counts."""
        n = self.node.num_partitions
        pid = torch.where(batch.sel, self._partition_ids(batch).to(
            torch.int64), torch.full_like(batch.sel, n, dtype=torch.int64))
        order = torch.sort(pid, stable=True).indices
        counts = syncs.to_numpy(torch.bincount(pid, minlength=n + 1)[:n])
        if self.node.partition_kind == "round_robin":
            self._rr_next = int((self._rr_next + counts.sum()) % n)
        out: List[Optional[Batch]] = []
        start = 0
        for c in counts.tolist():
            if not c:
                out.append(None)
                continue
            cap = round_capacity(c)
            idx = order[start:start + c]
            if cap > c:
                idx = torch.cat([idx, idx.new_zeros(cap - c)])
            sel = torch.arange(cap, device=batch.device) < c
            out.append(batch.gather(idx, sel, c))
            start += c
        return out

    def add_input(self, batch: Batch) -> None:
        self._last = batch
        n = self.node.num_partitions
        if self._broadcasts():
            item = self.manager.page_of(batch)
            for p in range(n):
                self._send(p, item)
            return
        for p, part in enumerate(self.split(batch)):
            if part is not None:
                self._send(p, part)

    def _send(self, p: int, item) -> None:
        self._fed[p] = True
        self.manager.enqueue(self.fragment, p, item)

    def _empty(self) -> Optional[Batch]:
        """No row of the last input batch: its schema, dictionaries and
        device."""
        if self._last is None:
            return None
        b = self._last
        cap = round_capacity(1)
        return b.gather(torch.zeros(cap, dtype=torch.int64, device=b.device),
                        torch.zeros(cap, dtype=torch.bool, device=b.device),
                        0)

    def no_more_input(self) -> None:
        if self.no_more_input_seen:
            return
        super().no_more_input()
        empty = self._empty()
        for p, fed in enumerate(self._fed):
            if not fed and empty is not None:
                self._send(p, self.manager.page_of(empty))

    def get_output(self) -> Optional[Batch]:
        return None

    def is_finished(self) -> bool:
        return self.no_more_input_seen


class ExchangeOp(Operator):
    """velox/exec/Exchange.cpp: the producer's batches of one partition,
    read when the consumer first asks."""

    def __init__(self, node: ExchangeNode, manager, producer: str,
                 partition: int):
        super().__init__(node)
        self._manager = manager
        self._key = (producer, partition)
        self._queue: Optional[List[Batch]] = None

    def get_output(self) -> Optional[Batch]:
        if self._queue is None:
            self._queue = self._manager.drain(*self._key)
            self._queue.reverse()
        return self._queue.pop() if self._queue else None

    def is_finished(self) -> bool:
        return self._queue is not None and not self._queue


@dataclass
class Fragment:
    """One plan fragment (velox/core/PlanFragment.h)."""

    name: str
    plan: PlanNode
    num_tasks: int = 1
    #: exchange node id -> producer fragment name
    exchange_sources: Optional[Dict[str, str]] = None


def _factories(manager, frag: Fragment, task_idx: int) -> dict:
    srcs = frag.exchange_sources or {}
    return {
        ExchangeNode: lambda node: ExchangeOp(node, manager, srcs[node.id],
                                              task_idx),
        PartitionedOutputNode: lambda node: PartitionedOutputOp(
            node, manager, frag.name),
    }


def fragment_batches(fragments: Sequence[Fragment],
                     serialize_pages: bool = False, compress=False,
                     device=None, tracer=None) -> List[Batch]:
    """Run ``fragments`` in order (producers first), each as
    ``num_tasks`` Tasks, task ``i`` of a consumer reading partition
    ``i``; the last fragment's batches, its tasks in order. Pages load
    on ``device`` (``None``: the card); a ``tracer`` records the nodes it
    wants in every task."""
    manager = OutputBufferManager(serialize_pages, compress, device)
    last: List[Batch] = []
    for frag in fragments:
        last = []
        for t in range(frag.num_tasks):
            last.extend(Task(frag.plan, tracer,
                             _factories(manager, frag, t)).run())
    return last


def run_fragments(fragments: Sequence[Fragment],
                  serialize_pages: bool = False, compress=False,
                  device=None, tracer=None) -> Dict[str, list]:
    """``fragment_batches`` as ``{column: [values]}``."""
    return collect_result(
        fragment_batches(fragments, serialize_pages, compress, device,
                         tracer),
        fragments[-1].plan.output_type.names)


def partitioned_output(builder, keys: Sequence[str], num_partitions: int,
                       broadcast: bool = False,
                       partition_kind: str = "hash"):
    """PlanBuilder extension: end a fragment with a shuffle write
    (``partition_kind``: hash, round_robin or hive_bucket)."""
    from velox_tpu_torch.plan.nodes import new_id

    builder.node = PartitionedOutputNode(
        new_id(), builder.node.output_type, builder.node, tuple(keys),
        num_partitions, broadcast, partition_kind)
    return builder


# ------------------------------------------------- streaming fragments

class StreamingPartitionedOutputOp(PartitionedOutputOp):
    """PartitionedOutput against a ``StreamingBufferManager``: each
    partition's rows go out as a page at once, ``enqueue`` blocks under
    backpressure, and the end publishes ``no_more_data``."""

    def add_input(self, batch: Batch) -> None:
        self._last = batch
        n = self.node.num_partitions
        if self._broadcasts():
            page = _serialize(batch, False)
            for p in range(n):
                self._send(p, page)
            return
        for p, part in enumerate(self.split(batch)):
            if part is not None:
                self._send(p, _serialize(part, False))

    def no_more_input(self) -> None:
        if self.no_more_input_seen:
            return
        Operator.no_more_input(self)
        empty = self._empty()
        if empty is not None and not all(self._fed):
            page = _serialize(empty, False)
            for p, fed in enumerate(self._fed):
                if not fed:
                    self._send(p, page)
        self.manager.no_more_data(
            self.fragment, list(range(self.node.num_partitions)))


class StreamingExchangeOp(Operator):
    """Exchange pulling from an exchange source (local or remote) with a
    fetch -> ack window; waits until the producers publish pages."""

    def __init__(self, node: ExchangeNode, source, device=None):
        super().__init__(node)
        from velox_tpu_torch.exec.exchange_net import consume_source

        self._source = source
        self._gen = consume_source(source, device=device)
        self._done = False

    def get_output(self) -> Optional[Batch]:
        if self._done:
            return None
        b = next(self._gen, None)
        if b is None:
            self._done = True
        return b

    def is_finished(self) -> bool:
        return self._done

    def close(self) -> None:
        self._gen.close()
        self._source.close()


def streaming_fragment_batches(fragments: Sequence[Fragment],
                               max_buffered_bytes: int = 8 << 20,
                               device=None, transport: str = "local"
                               ) -> List[Batch]:
    """Run every task of every fragment at once, one thread a task,
    against one bounded ``StreamingBufferManager``: producers and
    consumers overlap and hold each other back. With ``transport="tcp"``
    the consumers read an ``ExchangeServer`` on 127.0.0.1 through
    ``RemoteExchangeSource``. The last fragment's batches, its tasks in
    order. Raises the first task's error, or ``TimeoutError`` when a
    task is still running after ``STREAMING_TIMEOUT_S``."""
    from velox_tpu_torch.exec.exchange_net import (
        ExchangeServer, LocalExchangeSource, RemoteExchangeSource,
        StreamingBufferManager,
    )

    if transport not in ("local", "tcp"):
        raise ValueError(f"transport {transport!r}: local or tcp")
    manager = StreamingBufferManager(max_buffered_bytes)
    for frag in fragments:
        manager.expect_producers(frag.name, frag.num_tasks)
    server = ExchangeServer(manager) if transport == "tcp" else None

    def source(producer: str, part: int):
        if server is None:
            return LocalExchangeSource(manager, producer, part)
        return RemoteExchangeSource("127.0.0.1", server.port, producer,
                                    part)

    def factories(frag: Fragment, task_idx: int) -> dict:
        srcs = frag.exchange_sources or {}
        return {
            ExchangeNode: lambda node: StreamingExchangeOp(
                node, source(srcs[node.id], task_idx), device),
            PartitionedOutputNode: lambda node: StreamingPartitionedOutputOp(
                node, manager, frag.name),
        }

    results: Dict[tuple, List[Batch]] = {}
    errors: List[BaseException] = []

    def run_one(key, task):
        try:
            results[key] = list(task.run())
        except BaseException as e:     # raised after the join
            errors.append(e)
            manager.abort(e)

    threads = []
    try:
        # built in order in this thread; run at once
        for frag in fragments:
            for t in range(frag.num_tasks):
                task = Task(frag.plan, factories=factories(frag, t))
                threads.append(threading.Thread(
                    target=run_one, args=((frag.name, t), task),
                    daemon=True, name=f"velox-task-{frag.name}-{t}"))
        for th in threads:
            th.start()
        deadline = time.monotonic() + STREAMING_TIMEOUT_S
        for th in threads:
            th.join(timeout=max(0.0, deadline - time.monotonic()))
        alive = [th.name for th in threads if th.is_alive()]
        if alive:
            err = TimeoutError(f"exchange tasks still running after "
                               f"{STREAMING_TIMEOUT_S} s: {alive}")
            manager.abort(err)
            raise err
        if errors:
            raise errors[0]
    finally:
        if server is not None:
            server.close()
    last = fragments[-1]
    return [b for t in range(last.num_tasks)
            for b in results.get((last.name, t), [])]


def run_fragments_streaming(fragments: Sequence[Fragment],
                            max_buffered_bytes: int = 8 << 20,
                            device=None, transport: str = "local"
                            ) -> Dict[str, list]:
    """``streaming_fragment_batches`` as ``{column: [values]}``."""
    return collect_result(
        streaming_fragment_batches(fragments, max_buffered_bytes, device,
                                   transport),
        fragments[-1].plan.output_type.names)
