"""Memory management and spill (the port of the JAX package's
``exec/spill.py``).

Device memory is the scarce pool. Each buffer of a blocking operator is
a leaf of the memory pool tree (``exec/memory.py``), under its query's
pool, or under the root when it is made outside a query; the tree holds
their device bytes to ``config.spill_memory_budget_bytes`` and
``config.query_memory_cap_bytes`` by moving the largest holder's batches
to host RAM (velox/common/memory SharedArbitrator's victim policy and
velox/exec/Spiller.h). The process-wide ``MemoryManager`` holds the host
rung: when the spilled bytes in host RAM pass
``config.spill_host_budget_bytes``, the largest host holder writes its
batches as ``serial/page.py`` pages to files (velox/exec/SpillFile.h):
device -> host RAM -> files.

The host rung copies a batch's tensors into pinned host memory with one
synchronize a batch, so a restore runs with ``non_blocking=True``; a
restore goes back to the device the batch came from. A column keeps its
dictionary and stats, and an ARRAY, MAP or ROW column moves with its
offsets and element columns. Page files are written uncompressed: zlib
level 1 runs near 100 MB/s, far below the host link, and the files are
read back once by the process that wrote them.

``PartitionedEntryStore`` holds a generic aggregation's partials: a
spill splits them by a host hash of the group keys (``_np_key_hash``)
into ``config.spill_agg_partitions`` parts, and the output merges one
part at a time. A spilled join build is split the same way by its keys
(``partition_batches``), and the probe joins one part at a time.

OrderBy, LocalMerge and the window family restore a spilled buffer one
key range at a time (``SpillableBuffer.drain_ranges``, ``RangeRestore``):
every buffered row goes to a range by the order-preserving encoding of
the operator's first key (``ops/sortkey.py``) between splitters drawn
from a sample, string codes first brought onto one sorted dictionary,
so one key value never spans two ranges and the ranges concatenate in
key order. The operator computes each range, emits it and frees it
before the next range comes back; an operator whose output keeps
arrival order reads each range's new columns back to the host and emits
the buffered batches again in arrival order
(``RangeRestore.in_arrival_order``).

With no budget (the default) nothing here moves, copies or syncs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from velox_tpu_torch.exec import memory as _mem
from velox_tpu_torch.utils import syncs
from velox_tpu_torch.utils.config import config
from velox_tpu_torch.utils.metrics import reporter
from velox_tpu_torch.utils.testvalue import TestValue
from velox_tpu_torch.vector.batch import (
    Batch, concat_batches, harmonize_dictionaries, round_capacity,
)
from velox_tpu_torch.vector.column import Column, MapColumn, RowColumn

METRIC_SPILLED_BYTES = "velox_tpu.spilled_bytes"
METRIC_SPILL_EVENTS = "velox_tpu.spill_events"
METRIC_SPILL_FILE_BYTES = "velox_tpu.spill_file_bytes"
#: key ranges a range restore brought back, and those larger than the
#: device budget (one first-key value, or the NULLs, held more than it)
METRIC_SPILL_RANGES = "velox_tpu.spill_ranges"
METRIC_SPILL_RANGES_OVER_BUDGET = "velox_tpu.spill_ranges_over_budget"

#: at most this many key ranges a restore
_MAX_RANGES = 4096
#: at most this many first-key values a restore samples for splitters
_RANGE_SAMPLE = 1 << 16

#: the one lock of the accounting tree and of every buffer's lists
_LOCK = _mem.MemoryPool._lock


# ------------------------------------------------------------- tensors

def _map_column(col, fn):
    """``col`` with ``fn`` applied to each of its tensors (the offsets and
    element columns of an ARRAY, MAP or ROW column included)."""
    valid = None if col.valid is None else fn(col.valid)
    if isinstance(col, Column):
        return dataclasses.replace(col, values=fn(col.values), valid=valid)
    if isinstance(col, RowColumn):
        return dataclasses.replace(col, valid=valid, children=tuple(
            _map_column(c, fn) for c in col.children))
    common = dict(starts=fn(col.starts), lengths=fn(col.lengths),
                  valid=valid)
    if isinstance(col, MapColumn):
        return dataclasses.replace(col, keys=_map_column(col.keys, fn),
                                   values=_map_column(col.values, fn),
                                   **common)
    return dataclasses.replace(col, elements=_map_column(col.elements, fn),
                               **common)


def _column_tensors(col) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    _map_column(col, lambda t: out.append(t) or t)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def batch_device_bytes(b: Batch) -> int:
    """Bytes of the batch's selection and every column tensor."""
    return _nbytes(b.sel) + sum(_nbytes(t) for c in b.columns.values()
                                for t in _column_tensors(c))


def _map_batch(b: Batch, fn) -> Batch:
    return Batch({n: _map_column(c, fn) for n, c in b.columns.items()},
                 fn(b.sel), b.num_rows)


#: timed host-device copies not yet read: (direction, start, end, bytes)
_TRANSFERS: List[tuple] = []


def _timed(direction: str, nbytes: int, work):
    """``work()``, timed by CUDA events; a copy to the host waits for
    its end (the one synchronize of a spilled batch)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = work()
    end.record()
    if direction == "d2h":
        end.synchronize()
    _TRANSFERS.append((direction, start, end, nbytes))
    return out


def _to_pinned(t: torch.Tensor) -> torch.Tensor:
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return h.copy_(t, non_blocking=True)


def _to(device):
    return lambda t: t.to(device, non_blocking=t.is_pinned())


def _copy_batch(b: Batch, device, direction: str) -> Batch:
    """``b`` copied to ``device``: into pinned host memory (d2h), or from
    the host without a synchronize where its memory is pinned (h2d)."""
    if b.device.type != "cuda" and torch.device(device).type != "cuda":
        return _map_batch(b, lambda t: t.to(device, copy=True))
    move = _to_pinned if direction == "d2h" else _to(device)
    return _timed(direction, batch_device_bytes(b),
                  lambda: _map_batch(b, move))


def transfer_stats() -> Dict[str, Tuple[int, float]]:
    """{"d2h"/"h2d": (bytes, seconds)} of the spill copies between the
    card and the host since the last call (one synchronize)."""
    if _TRANSFERS:
        torch.cuda.synchronize()
    out: Dict[str, Tuple[int, float]] = {}
    for d, start, end, n in _TRANSFERS:
        b, sec = out.get(d, (0, 0.0))
        out[d] = (b + n, sec + start.elapsed_time(end) / 1e3)
    _TRANSFERS.clear()
    return out


# ----------------------------------------------------------- the rungs

class _FileBatch:
    """The disk rung: a batch as one uncompressed page file. The flat
    columns' dictionaries stay in memory, not in the page: the process
    that wrote the file reads it, and a restored column keeps its
    dictionary object (a table's dictionary can hold millions of
    strings, which a page header would write out each time)."""

    __slots__ = ("path", "device", "dictionaries")

    def __init__(self, batch: Batch, device, spill_dir=None):
        import os
        import tempfile

        from velox_tpu_torch.serial import serialize_page

        self.dictionaries = {n: c.dictionary
                             for n, c in batch.columns.items()
                             if isinstance(c, Column)
                             and c.dictionary is not None}
        page = serialize_page(Batch(
            {n: (dataclasses.replace(c, dictionary=None)
                 if n in self.dictionaries else c)
             for n, c in batch.columns.items()}, batch.sel, batch.num_rows),
            compress=False)
        fd, self.path = tempfile.mkstemp(suffix=".spill", dir=spill_dir)
        with os.fdopen(fd, "wb") as f:
            f.write(page)
        self.device = device
        reporter.add_counter(METRIC_SPILL_FILE_BYTES, len(page))

    def restore(self, device=None) -> Batch:
        from velox_tpu_torch.serial import deserialize_page

        with open(self.path, "rb") as f:
            b = deserialize_page(f.read(), device or self.device)
        self.close()
        for n, d in self.dictionaries.items():
            b.columns[n] = dataclasses.replace(b.columns[n], dictionary=d)
        return b

    def close(self) -> None:
        import os

        try:
            os.unlink(self.path)
        except OSError:
            pass


class _PendingFileBatch:
    """A page file the background writer has not finished: a read or a
    close waits for the write first."""

    __slots__ = ("_future",)

    def __init__(self, future):
        self._future = future

    def restore(self, device=None) -> Batch:
        return self._future.result().restore(device)

    def close(self) -> None:
        self._future.result().close()


_SPILL_POOL = None


def _spill_executor():
    """The process-wide page writer threads (``config.spill_io_threads``;
    0 writes in the caller)."""
    global _SPILL_POOL
    n = config.spill_io_threads
    if not n:
        return None
    if _SPILL_POOL is None:
        from concurrent.futures import ThreadPoolExecutor

        _SPILL_POOL = ThreadPoolExecutor(
            max_workers=n, thread_name_prefix="velox-spill-io")
    return _SPILL_POOL


class _HostBatch:
    """The host-RAM rung: a batch's tensors in (pinned) host memory, with
    the device it came from."""

    __slots__ = ("batch", "device", "nbytes")

    def __init__(self, b: Batch):
        self.device = b.device
        self.nbytes = batch_device_bytes(b)
        self.batch = (_copy_batch(b, "cpu", "d2h") if b.device.type == "cuda"
                      else _map_batch(b, torch.clone))

    def restore(self) -> Batch:
        return _copy_batch(self.batch, self.device, "h2d")

    def to_file(self, spill_dir=None) -> _FileBatch:
        return _FileBatch(self.batch, self.device, spill_dir)


class MemoryManager:
    """The registered buffers' host rung: when the bytes they hold in
    host RAM pass ``config.spill_host_budget_bytes``, the largest host
    holder writes its batches to page files. (The device budget is the
    pool tree's, ``exec/memory.py``.)"""

    def __init__(self):
        self._buffers: List[object] = []

    def register(self, buf) -> None:
        with _LOCK:
            self._buffers.append(buf)

    def unregister(self, buf) -> None:
        with _LOCK:
            if buf in self._buffers:
                self._buffers.remove(buf)

    def maybe_reclaim(self) -> None:
        hbudget = config.spill_host_budget_bytes
        if hbudget is None:
            return

        def hb(b):
            return b.host_bytes() if hasattr(b, "host_bytes") else 0

        with _LOCK:
            while sum(hb(b) for b in self._buffers) > hbudget:
                victim = max(self._buffers, key=hb, default=None)
                if victim is None or hb(victim) == 0:
                    return
                victim.spill_to_disk()


#: the process-wide manager (velox MemoryManager::getInstance)
memory_manager = MemoryManager()


def _leaf_pool(buf, label: str, pool=None) -> _mem.MemoryPool:
    """An operator leaf holding ``buf``, under ``pool``, the ambient
    query pool, or the root: the pool tree that holds the device budget
    counts every buffer."""
    leaf = _mem.MemoryPool(label or "buffer", pool or _mem.current_pool()
                           or _mem.root_pool)
    leaf.attach_buffer(buf)
    return leaf


class SpillableBuffer:
    """The batches a blocking operator buffers, movable to host RAM and
    on to page files under pressure (OrderBy, HashBuild, CrossBuild, the
    window family, a spilled join's probe side)."""

    def __init__(self, label: str = "", mm: Optional[MemoryManager] = None,
                 pool=None):
        self.label = label
        self.mm = mm or memory_manager
        self._device: List[Batch] = []
        self._host: List[_HostBatch] = []
        self._files: List[object] = []
        #: the device the batches came from, which a restore goes back to
        self.home: Optional[torch.device] = None
        self.mm.register(self)
        self.pool = _leaf_pool(self, label, pool)

    def append(self, b: Batch) -> None:
        with _LOCK:
            self.home = b.device
            self._device.append(b)
        self.pool.maybe_arbitrate()
        self.mm.maybe_reclaim()

    def _detach_pool(self) -> None:
        if self.pool is not None:
            self.pool.detach_buffer(self)
            self.pool.close()
            self.pool = None

    def device_bytes(self) -> int:
        with _LOCK:
            return sum(batch_device_bytes(b) for b in self._device)

    def spill_all(self) -> None:
        """Move every device batch to host RAM."""
        TestValue.adjust("velox_tpu.spill.spill_all", self)
        with _LOCK:
            for b in self._device:
                hb = _HostBatch(b)
                self._host.append(hb)
                reporter.add_counter(METRIC_SPILLED_BYTES, hb.nbytes)
            if self._device:
                reporter.add_counter(METRIC_SPILL_EVENTS)
            self._device = []

    def __len__(self) -> int:
        return len(self._device) + len(self._host) + len(self._files)

    def has_spilled(self) -> bool:
        return bool(self._host) or bool(self._files)

    def host_bytes(self) -> int:
        with _LOCK:
            return sum(hb.nbytes for hb in self._host)

    def spill_to_disk(self) -> None:
        """Host RAM -> page files, written by the background writer
        (``spill_io_threads``); a file is waited for at its first read."""
        pool = _spill_executor()
        with _LOCK:
            for hb in self._host:
                if pool is None:
                    self._files.append(hb.to_file(config.spill_dir))
                else:
                    self._files.append(_PendingFileBatch(
                        pool.submit(hb.to_file, config.spill_dir)))
            self._host = []

    def _take(self):
        with _LOCK:
            files, host, device = self._files, self._host, self._device
            self._files, self._host, self._device = [], [], []
        self.mm.unregister(self)
        self._detach_pool()
        return files, host, device

    def drain(self) -> List[Batch]:
        """Every buffered batch, the spilled ones restored to their
        device, in arrival order."""
        files, host, device = self._take()
        return ([fb.restore() for fb in files]
                + [hb.restore() for hb in host] + device)

    def drain_host(self) -> List[Batch]:
        """Every buffered batch on the host, without restoring any to the
        device: a partitioned consumer splits them by key hash and
        restores one part at a time."""
        files, host, device = self._take()
        return ([fb.restore("cpu") for fb in files]
                + [hb.batch for hb in host]
                + [_HostBatch(b).batch for b in device])

    def drain_ranges(self, key: Optional["RangeKey"]) -> "RangeRestore":
        """Every buffered batch on the host, split by ranges of ``key``
        (``RangeRestore``), for a restore one range at a time."""
        TestValue.adjust("velox_tpu.spill.partitions", self)
        return RangeRestore(self.drain_host(), key, self.home, self.label)

    def close(self) -> None:
        files, _, _ = self._take()
        for fb in files:
            fb.close()


# ---------------------------------------------------- partitioned spill

def _np_key_hash(keys: Sequence[Tuple[np.ndarray, Optional[np.ndarray]]],
                 n: Optional[int] = None) -> np.ndarray:
    """Deterministic host hash of key rows (the JAX package's, bit for
    bit). A NULL key hashes to a marker of its own, so NULL groups meet.
    Only routing matters (one key, one partition). ``n`` sizes the
    keyless case: every row hashes to 0."""
    if n is None:
        n = keys[0][0].shape[0] if keys else 0
    h = np.zeros(n, dtype=np.uint64)
    for (v, va) in keys:
        v = np.asarray(v)
        x = (v.astype(np.int64, copy=False).view(np.uint64)
             if v.dtype != np.bool_ else v.astype(np.uint64))
        x = x * np.uint64(0x9E3779B97F4A7C15)
        x ^= x >> np.uint64(29)
        if va is not None:
            x = np.where(np.asarray(va), x, np.uint64(0x5851F42D4C957F2D))
        h = (h * np.uint64(0xBF58476D1CE4E5B9)) ^ x
    return h


def _host(t: Optional[torch.Tensor]) -> Optional[np.ndarray]:
    return None if t is None else t.cpu().numpy()


def _part_order(sel: np.ndarray, pid: np.ndarray, num_parts: int):
    """The live rows grouped by part, each part's rows in their order
    (one stable sort), and each part's [lo, hi) in that order."""
    live = np.nonzero(sel)[0]
    p = pid[live].astype(np.int16)
    order = live[np.argsort(p, kind="stable")]
    ends = np.cumsum(np.bincount(p, minlength=num_parts))
    return torch.from_numpy(order), list(zip(
        [0] + ends[:-1].tolist(), ends.tolist()))


def _string_hashes(d) -> np.ndarray:
    """crc32 of each value of a dictionary (at index code + 1; NULL 0)."""
    import zlib

    return np.asarray([0] + [zlib.crc32(str(v).encode())
                             for v in d.values], np.int64)


def _routing_key(col) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """A join key's lane as the partition hash reads it: a string by its
    value's crc32, so that two sides over different dictionaries route
    equal strings alike; any other lane as it is."""
    v = _host(col.values)
    if col.dictionary is not None:
        v = col.dictionary.derived(("crc32",), _string_hashes)[
            np.clip(v.astype(np.int64) + 1, 0, len(col.dictionary))]
    return v, _host(col.valid)


def _take_rows(t: torch.Tensor, idx: torch.Tensor, pin: bool):
    """``t``'s rows ``idx`` (host tensors), into pinned memory if
    ``pin``, so that they go to the card without a staging copy."""
    if not pin:
        return t.index_select(0, idx)
    out = torch.empty((idx.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype,
                      pin_memory=True)
    return torch.index_select(t, 0, idx, out=out)


def partition_batches(batches: Sequence[Batch], keys: Sequence[str],
                      num_parts: int, pin: bool = False
                      ) -> List[List[Batch]]:
    """Host batches split by ``_np_key_hash`` of ``keys`` (strings by
    value, ``_routing_key``): per part, the live rows of each batch that
    hash to it, as dense host batches. A flat column is gathered once in
    part order (into pinned memory if ``pin``) and each part takes a
    slice of it."""
    TestValue.adjust("velox_tpu.spill.partitions", batches)
    parts: List[List[Batch]] = [[] for _ in range(num_parts)]
    for hb in batches:
        sel = _host(hb.sel)
        pid = _np_key_hash([_routing_key(hb.column(k)) for k in keys],
                           sel.shape[0]) % num_parts
        order, bounds = _part_order(sel, pid, num_parts)
        flat = {n: _map_column(c, lambda t: _take_rows(t, order, pin))
                for n, c in hb.columns.items() if isinstance(c, Column)}
        for p, (lo, hi) in enumerate(bounds):
            if hi > lo:
                cols = {n: (_map_column(flat[n], lambda t: t[lo:hi])
                            if n in flat else c.gather(order[lo:hi]))
                        for n, c in hb.columns.items()}
                parts[p].append(Batch(
                    cols, torch.ones(hi - lo, dtype=torch.bool), hi - lo))
    return parts


def restore_fragments(frags: Sequence[Batch], device) -> Optional[Batch]:
    """One part's host fragments as one batch on ``device`` (rows a dense
    prefix of a power-of-two capacity)."""
    if not frags:
        return None
    total = sum(f.capacity for f in frags)
    return concat_batches([_copy_batch(f, device, "h2d") for f in frags],
                          round_capacity(max(total, 1)))


#: (column, descending, nulls_first): the key a range restore routes by
RangeKey = Tuple[str, bool, bool]


def _range_budget() -> Optional[int]:
    """The device budget a range restore sizes its ranges by."""
    caps = [c for c in (config.spill_memory_budget_bytes,
                        config.query_memory_cap_bytes) if c]
    return min(caps) if caps else None


def _key_values(col, key: RangeKey) -> Tuple[torch.Tensor,
                                             Optional[torch.Tensor]]:
    """The ``encode_sort_key`` value of a key column (int64) and its NULL
    mask (None without NULLs)."""
    from velox_tpu_torch.ops.sortkey import encode_sort_key

    _, desc, nulls_first = key
    ops = encode_sort_key(col.values, col.valid, descending=desc,
                          nulls_first=nulls_first)
    return ops[-1].to(torch.int64), None if col.valid is None else ~col.valid


class RangeRestore:
    """A spilled buffer's batches on the host, split by ranges of one key,
    restored to the device one range at a time (the fix of C9 in ROADMAP
    queue C: a spilled OrderBy or window no longer brings every batch
    back at once).

    String columns are first brought onto one sorted dictionary, so a
    code's order is its string's order. Each live row goes to a range by
    the ``encode_sort_key`` value of the key column (its direction and
    NULL order as the operator sorts): splitters are quantiles of a
    strided sample of the non-NULL values, so the ranges hold about the
    budget's half each; every NULL goes to one range at its end of the
    order. A row's range depends on the key value alone, so equal keys
    meet, and rows keep their arrival order within a range. A range
    larger than the budget (one value, or the NULLs, hold more) is
    restored alone and counted (``METRIC_SPILL_RANGES_OVER_BUDGET``).

    Each batch goes to the device once, alone (its bytes reserved in the
    pool meanwhile), where its live rows are sorted stably by range and
    copied back to host memory (pinned for a card) in that order, with
    one host read of the range counts: a range is then one slice of each
    batch, copied to the device without staging. While a range is on
    the device its bytes are reserved in a leaf pool of the query, so
    the pool tree sees it."""

    def __init__(self, batches: Sequence[Batch], key: Optional[RangeKey],
                 device, label: str = "range"):
        batches = harmonize_dictionaries(
            [b for b in batches if b.capacity])
        self.device = device
        self.pin = torch.device(device).type == "cuda"
        self.budget = _range_budget()
        self.pool = _mem.MemoryPool(f"{label}.restore",
                                    _mem.current_pool() or _mem.root_pool)
        total = sum(batch_device_bytes(b) for b in batches)
        target = (self.budget // 2 if self.budget
                  else -(-total // config.spill_agg_partitions))
        wanted = min(_MAX_RANGES, max(1, -(-total // max(target, 1))))
        splitters, self.num_ranges, null_range = None, 1, None
        if key is not None and wanted > 1:
            step = max(1, sum(b.capacity for b in batches) // _RANGE_SAMPLE)
            sample, any_null = [], False
            for b in batches:
                c = b.column(key[0])
                v, m = _key_values(
                    dataclasses.replace(c, values=c.values[::step], valid=(
                        None if c.valid is None else c.valid[::step])), key)
                live = b.sel[::step] if m is None else b.sel[::step] & ~m
                sample.append(v[live].numpy())
                any_null |= m is not None and bool(
                    (~c.valid & b.sel).any())
            sample = np.sort(np.concatenate(sample))
            spl = (np.unique(sample[(np.arange(1, wanted) * len(sample))
                                    // wanted]) if len(sample) else sample)
            k = len(spl) + 1
            nulls_first = key[2]
            splitters = (torch.from_numpy(spl).to(device),
                         int(any_null and nulls_first))
            self.num_ranges = k + int(any_null)
            null_range = (0 if nulls_first else k) if any_null else None
        #: per batch: its live rows in range order (host), each range's
        #: [lo, hi) there, and the range-order row of each live row in
        #: arrival order (``inv``, host)
        self.parts = []
        for b in batches:
            held = batch_device_bytes(b)
            self.pool.reserve(held)
            try:
                self.parts.append(self._split(b, key, splitters,
                                              null_range))
            finally:
                self.pool.release(held)
        self.offsets = np.cumsum([0] + [len(p[2]) for p in self.parts])

    def _split(self, b: Batch, key, splitters, null_range):
        nr = self.num_ranges
        dev = _copy_batch(b, self.device, "h2d") if self.pin else b
        sel = dev.sel
        if splitters is None:
            rid = torch.zeros(sel.shape[0], dtype=torch.int64,
                              device=sel.device)
        else:
            spl, shift = splitters
            v, m = _key_values(dev.column(key[0]), key)
            rid = torch.searchsorted(spl, v, right=True) + shift
            if m is not None and null_range is not None:
                rid = torch.where(m, torch.full_like(rid, null_range), rid)
        rid = torch.where(sel, rid, torch.full_like(rid, nr))
        order = torch.sort(rid, stable=True).indices
        counts = syncs.to_numpy(torch.bincount(rid, minlength=nr + 1)[:nr])
        live = int(counts.sum())
        order = order[:live]
        rank = torch.cumsum(sel.to(torch.int64), 0) - 1
        inv = torch.empty(live, dtype=torch.int64, device=sel.device)
        inv[rank.index_select(0, order)] = torch.arange(
            live, device=sel.device)
        ordered = Batch({n: c.gather(order) for n, c in dev.columns.items()},
                        torch.ones(live, dtype=torch.bool,
                                   device=sel.device), live)
        if self.pin:
            ordered = _copy_batch(ordered, "cpu", "d2h")
            inv = inv.cpu()
        ends = np.cumsum(counts)
        return (ordered.columns, list(zip([0] + ends[:-1].tolist(),
                                          ends.tolist())), inv)

    def _slice(self, j: int, lo: int, hi: int) -> Batch:
        cols, _, _ = self.parts[j]
        return Batch({n: _map_column(c, lambda t: t[lo:hi])
                      if isinstance(c, Column) else c.gather(
                          torch.arange(lo, hi))
                      for n, c in cols.items()},
                     torch.ones(hi - lo, dtype=torch.bool), hi - lo)

    def ranges(self):
        """Each non-empty range on the device, in key order: a batch of
        its rows (dense, in arrival order) and where they come from, a
        list of (batch, lo, hi) of the batches' range-order rows; held
        in the pool until the next range."""
        for r in range(self.num_ranges):
            segs = [(j, lo, hi) for j, (_, bounds, _) in
                    enumerate(self.parts) for lo, hi in [bounds[r]]
                    if hi > lo]
            if not segs:
                continue
            frags = [self._slice(j, lo, hi) for j, lo, hi in segs]
            reporter.add_counter(METRIC_SPILL_RANGES)
            if self.budget and sum(
                    batch_device_bytes(f) for f in frags) > self.budget:
                reporter.add_counter(METRIC_SPILL_RANGES_OVER_BUDGET)
            big = restore_fragments(frags, self.device)
            del frags
            held = batch_device_bytes(big)
            self.pool.reserve(held)
            try:
                yield big, segs
            finally:
                self.pool.release(held)
                del big

    def in_arrival_order(self, compute):
        """``compute`` (a batch -> the same rows with new columns and a
        narrowed selection) over every range, its new columns and
        selection copied to host memory beside each row's batch; then
        every buffered batch again, in arrival order, with them: the
        rows, order and columns of ``compute`` over all the batches at
        once (the window family's output)."""
        total = int(self.offsets[-1])
        new: Dict[str, list] = {}
        keep = torch.ones(total, dtype=torch.bool, pin_memory=self.pin)

        def host(like: torch.Tensor, fill=None) -> torch.Tensor:
            t = torch.empty(total, dtype=like.dtype, pin_memory=self.pin)
            return t if fill is None else t.fill_(fill)

        for big, segs in self.ranges():
            out = compute(big)
            a = 0
            for j, lo, hi in segs:
                at = slice(int(self.offsets[j]) + lo,
                           int(self.offsets[j]) + hi)
                n = hi - lo
                for name, col in out.columns.items():
                    if big.columns.get(name) is col:
                        continue
                    ent = new.get(name)
                    if ent is None:
                        ent = new[name] = [col.dtype, host(col.values), None,
                                           col.dictionary]
                    ent[1][at].copy_(col.values[a:a + n],
                                     non_blocking=self.pin)
                    if col.valid is not None:
                        if ent[2] is None:
                            ent[2] = host(col.valid, True)
                        ent[2][at].copy_(col.valid[a:a + n],
                                         non_blocking=self.pin)
                keep[at].copy_(out.sel[a:a + n], non_blocking=self.pin)
                a += n
            del out
        for j, (_, bounds, inv) in enumerate(self.parts):
            g, n = int(self.offsets[j]), len(inv)
            b = self._slice(j, 0, n)
            cols = dict(b.columns)
            for name, (dt, vals, valid, d) in new.items():
                cols[name] = Column(dt, vals[g:g + n], None if valid is None
                                    else valid[g:g + n], d)
            dev = _copy_batch(Batch(cols, keep[g:g + n], None), self.device,
                              "h2d")
            # back to arrival order, padded to a power-of-two capacity
            cap = round_capacity(n)
            idx = torch.zeros(cap, dtype=torch.int64)
            idx[:n] = inv
            idx = idx.to(self.device)
            sel = dev.sel.index_select(0, idx)
            sel[n:] = False
            yield dev.gather(idx, sel)

    def close(self) -> None:
        self.parts = []
        self.pool.close()


def _entry_tensors(entry: dict) -> List[torch.Tensor]:
    out = [a for kv in entry["keys"] for a in kv if a is not None]
    out += [a for lane in entry["lanes"] if lane is not None for a in lane]
    out.append(entry["sel"])
    for d in entry["distinct"]:
        if d is not None:
            out += [a for kv in d["keys"] for a in kv if a is not None]
            out += [d["arg"], d["sel"]]
    return out


def _map_entry(entry: dict, fn) -> dict:
    def pairs(ps):
        return [(fn(v), None if va is None else fn(va)) for v, va in ps]

    return {
        "keys": pairs(entry["keys"]),
        "lanes": [None if lane is None else tuple(fn(a) for a in lane)
                  for lane in entry["lanes"]],
        "sel": fn(entry["sel"]),
        "distinct": [None if d is None else {
            "keys": pairs(d["keys"]), "arg": fn(d["arg"]),
            "sel": fn(d["sel"])} for d in entry["distinct"]],
    }


def _entry_bytes(entry: dict) -> int:
    return sum(_nbytes(t) for t in _entry_tensors(entry))


def _split_entry(he: dict, pids: np.ndarray, num_parts: int,
                 pin: bool) -> List[dict]:
    """A host entry split into per-part compacted sub-entries. A distinct
    aggregate's representatives carry their own key rows and go by the
    same hash, so each part sees its groups' lanes and representatives."""
    sel = _host(he["sel"])
    d_pids = [None if d is None else _np_key_hash(
        [(_host(v), _host(va)) for v, va in d["keys"]],
        d["sel"].shape[0]) % num_parts for d in he["distinct"]]
    order, bounds = _part_order(sel, pids, num_parts)
    grouped = _map_entry({**he, "distinct": [None] * len(he["distinct"])},
                         lambda a: _take_rows(a, order, pin))
    d_split = [None if d is None else _part_order(
        _host(d["sel"]), dp, num_parts)
        for d, dp in zip(he["distinct"], d_pids)]
    out = []
    for p, (lo, hi) in enumerate(bounds):
        sub = _map_entry(grouped, lambda a: a[lo:hi])
        sub["sel"] = torch.ones(hi - lo, dtype=torch.bool)
        for i, (d, ds) in enumerate(zip(he["distinct"], d_split)):
            if d is None:
                continue
            dorder, dbounds = ds
            didx = dorder[dbounds[p][0]:dbounds[p][1]]
            sub["distinct"][i] = {
                "keys": [(v.index_select(0, didx),
                          None if va is None else va.index_select(0, didx))
                         for v, va in d["keys"]],
                "arg": d["arg"].index_select(0, didx),
                "sel": torch.ones(didx.shape[0], dtype=torch.bool)}
        out.append(sub)
    return out


class PartitionedEntryStore:
    """A generic aggregation's partial entries, spilled to host RAM split
    by a hash of the group keys, restored one part at a time (velox
    GroupingSet spill and mergeRestore). Unspilled, the entries stay on
    the device as one part; spilled, every part's key set is disjoint from
    the others', and device memory at the output holds one part."""

    def __init__(self, label: str = "agg", num_parts: Optional[int] = None,
                 pool=None):
        self.num_parts = num_parts or config.spill_agg_partitions
        self.label = label
        self._device: List[dict] = []
        self._parts: List[List[dict]] = [[] for _ in range(self.num_parts)]
        self.spilled = False
        #: the device the entries came from, which a part goes back to
        self.home: Optional[torch.device] = None
        self.pool = _leaf_pool(self, label, pool)

    def append(self, entry: dict) -> None:
        with _LOCK:
            self.home = entry["sel"].device
            self._device.append(entry)
        self.pool.maybe_arbitrate()
        memory_manager.maybe_reclaim()

    def device_bytes(self) -> int:
        with _LOCK:
            return sum(_entry_bytes(e) for e in self._device)

    def spill_all(self) -> None:
        TestValue.adjust("velox_tpu.spill.spill_all", self)
        with _LOCK:
            for e in self._device:
                he = self._to_host(e)
                nbytes = _entry_bytes(he)
                pids = _np_key_hash(
                    [(_host(v), _host(va)) for v, va in he["keys"]],
                    he["sel"].shape[0]) % self.num_parts
                for p, sub in enumerate(_split_entry(
                        he, pids, self.num_parts, self.home.type == "cuda")):
                    if sub["sel"].shape[0]:
                        self._parts[p].append(sub)
                reporter.add_counter(METRIC_SPILLED_BYTES, nbytes)
            if self._device:
                self.spilled = True
                reporter.add_counter(METRIC_SPILL_EVENTS)
            self._device = []

    @staticmethod
    def _to_host(e: dict) -> dict:
        if e["sel"].device.type != "cuda":
            return _map_entry(e, torch.clone)
        return _timed("d2h", _entry_bytes(e),
                      lambda: _map_entry(e, _to_pinned))

    def to_device(self, entry: dict) -> dict:
        """A part's entry on the device the entries came from (a device
        entry as it is)."""
        if entry["sel"].device == self.home:
            return entry
        if self.home.type != "cuda":
            return _map_entry(entry, _to(self.home))
        return _timed("h2d", _entry_bytes(entry),
                      lambda: _map_entry(entry, _to(self.home)))

    def __len__(self) -> int:
        return len(self._device) + sum(len(p) for p in self._parts)

    def partitions(self) -> List[List[dict]]:
        """Entry groups whose key sets are disjoint: unspilled, one group
        of the device entries; spilled, the remaining device entries are
        split too, and each non-empty part is a group."""
        TestValue.adjust("velox_tpu.spill.partitions", self)
        with _LOCK:
            if not self.spilled:
                out = [list(self._device)]
            else:
                self.spill_all()
                out = [list(p) for p in self._parts if p]
            self.close()
        return out

    def close(self) -> None:
        with _LOCK:
            self._device = []
            self._parts = [[] for _ in range(self.num_parts)]
            if self.pool is not None:
                self.pool.detach_buffer(self)
                self.pool.close()
                self.pool = None
