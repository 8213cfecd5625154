"""Window-family operators: Window, StreamingWindow, RowNumber,
TopNRowNumber, MarkDistinct, Expand, GroupId, Unnest, and the union
operators.

The port of ``velox_tpu/exec/window_ops.py``. Window (velox/exec/Window.h)
keeps the sort-once design (``ops/window.py``): one stable sort by
(partition, order) keys, boundary masks, scans and gathers, then a
scatter back to arrival order. Blocking operators (Window, RowNumber,
TopNRowNumber, MarkDistinct, LocalMerge) buffer their input in a
``SpillableBuffer`` (``exec/spill.py``), which moves to host RAM and on
to page files under a memory budget; a spilled buffer comes back one
range of the first partition (or sort, or distinct) key at a time
(``operators.blocking_output``).
``UnnestOp`` explodes ARRAY columns. LocalPartition and TableWrite are
not ported.
"""

from __future__ import annotations

import collections
import math
from typing import List, Optional

import torch

from velox_tpu_torch.types import BIGINT, BOOLEAN
from velox_tpu_torch.vector.batch import (
    Batch, concat_batches, harmonize_dictionaries, round_capacity,
)
from velox_tpu_torch.vector.column import Column
from velox_tpu_torch.exec.spill import SpillableBuffer
from velox_tpu_torch.exec.operator import ExprEvaluator, Operator
from velox_tpu_torch.exec.operators import (
    _cols_of, blocking_output, next_blocking_output,
)
from velox_tpu_torch.ops.groupby import group_ids_sorted
from velox_tpu_torch.ops.sort import pack_indices, sort_indices
from velox_tpu_torch.ops.sortkey import encode_sort_key
from velox_tpu_torch.ops.window import (
    range_minmax, range_sum, ranks, row_numbers, run_owners, segment_ends,
    segment_starts, segmented_cumsum, segmented_scan,
)
from velox_tpu_torch.utils import syncs

#: functions an explicit ROWS or RANGE frame applies to
_FRAMED = ("sum", "count", "avg", "min", "max", "first_value",
           "last_value", "nth_value")


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` with ``idx`` clamped into range (``jnp.take`` with
    ``mode="clip"``)."""
    return x.index_select(0, idx.clamp(0, x.shape[0] - 1))


def _part_bsearch(sv, lo0, hi0, target, side: str) -> torch.Tensor:
    """Vectorized binary search of ``target`` within each row's partition
    slice [lo0, hi0) of the (partition-contiguous, in-partition
    ascending) sorted order column: a fixed number of steps, no host
    read."""
    lo, hi = lo0, hi0
    for _ in range(max(1, math.ceil(math.log2(max(sv.shape[0], 2)))) + 1):
        cont = lo < hi
        mid = (lo + hi) >> 1
        mv = _take(sv, mid)
        p = mv < target if side == "left" else mv <= target
        lo = torch.where(cont & p, mid + 1, lo)
        hi = torch.where(cont & ~p, mid, hi)
    return lo


def _changes(sorted_cols, cap: int, device) -> torch.Tensor:
    """Boundary mask: row differs from the previous on any column; row 0
    always opens."""
    out = torch.zeros(cap, dtype=torch.bool, device=device)
    out[0] = True
    for k in sorted_cols:
        out[1:] |= k[1:] != k[:-1]
    return out


def _sorted_key_ops(cols, names_spec, perm) -> List[torch.Tensor]:
    ops = []
    for item in names_spec:
        if isinstance(item, str):
            v, va = cols[item]
            keys = encode_sort_key(v, va)
        else:
            v, va = cols[item.name]
            keys = encode_sort_key(v, va, descending=item.descending,
                                   nulls_first=item.nulls_first)
        ops.extend(_take(k, perm) for k in keys)
    return ops


def _sort_spec(cols, partition_keys, sort_keys):
    return [(cols[k][0], cols[k][1], False, False)
            for k in partition_keys] + [
        (cols[k.name][0], cols[k.name][1], k.descending, k.nulls_first)
        for k in sort_keys]


def _extremes(dtype: torch.dtype):
    if dtype.is_floating_point:
        big = torch.finfo(dtype).max
        return big, -big
    info = torch.iinfo(dtype)
    return info.max, info.min


def _prefix(x: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sums with a leading zero (length n + 1)."""
    return torch.cat([x.new_zeros(1), torch.cumsum(x, 0, dtype=x.dtype)])


def _first_key(names) -> Optional[tuple]:
    """The range key of a spilled window-family buffer: its first
    partition (or distinct) key, ascending, NULLs last, so that one
    partition never spans two ranges."""
    return (names[0], False, False) if names else None


class WindowOp(Operator):
    """velox/exec/Window.h:38 — sorted window evaluation."""

    blocking = True

    def __init__(self, node):
        super().__init__(node)
        self._buffer = SpillableBuffer("window")
        self._out = None
        self._emitted = False

    def add_input(self, batch: Batch) -> None:
        self._buffer.append(batch)

    def get_output(self) -> Optional[Batch]:
        return next_blocking_output(self, lambda: blocking_output(
            self._buffer, _first_key(self.node.partition_keys),
            self.evaluate, arrival_order=True))

    def needed_columns(self) -> list:
        node = self.node
        return list(dict.fromkeys(
            list(node.partition_keys)
            + [k.name for k in node.sort_keys]
            + [f.arg for f in node.functions if f.arg is not None]))

    def evaluate(self, big: Batch) -> Batch:
        """One batch's rows with the window columns added, in arrival
        order: the serial operator calls it on its buffered rows (one key
        range at a time when spilled), a mesh shard on the rows of the
        partitions it holds."""
        node = self.node
        cols = _cols_of(big, self.needed_columns())
        results = self.run_fn(cols, big.sel)
        out = Batch(dict(big.columns), big.sel, big.num_rows)
        for spec, (vals, valid) in zip(node.functions, results):
            dt = self.output_type.find_child(spec.name)
            # a value function of a string argument keeps its dictionary
            d = (big.column(spec.arg).dictionary
                 if spec.arg is not None and dt.is_string else None)
            out = out.with_column(spec.name, Column(dt, vals, valid, d))
        return out

    def run_fn(self, cols, sel):
        """(cols, sel) -> [(vals, valid)] in arrival order."""
        node = self.node
        cap = sel.shape[0]
        device = sel.device
        perm = sort_indices(
            _sort_spec(cols, node.partition_keys, node.sort_keys), sel)
        n_valid = sel.sum()
        part_ops = _sorted_key_ops(cols, list(node.partition_keys), perm)
        order_ops = _sorted_key_ops(cols, list(node.sort_keys), perm)
        part_change = _changes(part_ops, cap, device)
        # no ORDER BY -> every partition row is a peer (SQL frame
        # semantics): default frames cover the whole partition
        peer_change = (_changes(order_ops, cap, device) if order_ops
                       else part_change)
        ctx = {
            "perm": perm, "n_valid": n_valid,
            "idx": torch.arange(cap, dtype=torch.int64, device=device),
            "part_change": part_change, "peer_change": peer_change,
            "part_start": segment_starts(part_change),
            "part_end": segment_ends(part_change, n_valid),
            "peer_end": segment_ends(part_change | peer_change, n_valid),
        }
        out = []
        for spec in node.functions:
            vals, valid = self._eval_fn(spec, cols, ctx)
            # scatter back to arrival order
            ov = torch.empty_like(vals).index_copy_(0, perm, vals)
            ova = (None if valid is None else torch.empty_like(valid)
                   .index_copy_(0, perm, valid))
            out.append((ov, ova))
        return out

    def _frame_bounds(self, spec, cols, ctx):
        """[start, end) of each row's explicit frame, sorted layout."""
        lo, hi = spec.frame
        idx, perm = ctx["idx"], ctx["perm"]
        part_start, part_end = ctx["part_start"], ctx["part_end"]
        if spec.frame_type == "range":
            # value bounds come from the FIRST sort key; trailing keys
            # only break ties, which the value-range search spans
            sk = self.node.sort_keys[0]
            ov = _take(cols[sk.name][0], perm)
            if sk.descending:
                ov = -ov
            start = (part_start if lo is None else _part_bsearch(
                ov, part_start, part_end,
                ov - torch.tensor(lo, dtype=ov.dtype, device=ov.device),
                "left"))
            end = (part_end if hi is None else _part_bsearch(
                ov, part_start, part_end,
                ov + torch.tensor(hi, dtype=ov.dtype, device=ov.device),
                "right"))
            max_len = idx.shape[0]
        else:
            start = (part_start if lo is None
                     else torch.maximum(idx - int(lo), part_start))
            end = (part_end if hi is None
                   else torch.minimum(idx + int(hi) + 1, part_end))
            max_len = (int(lo) + int(hi) + 1
                       if lo is not None and hi is not None
                       else idx.shape[0])
        return start, torch.maximum(end, start), max(max_len, 1)

    def _framed(self, spec, cols, ctx, sv, sva):
        fn = spec.fn
        cap = ctx["idx"].shape[0]
        start, end, max_len = self._frame_bounds(spec, cols, ctx)
        if fn in ("first_value", "last_value", "nth_value"):
            nonempty = end > start
            if fn == "first_value":
                pos = start
            elif fn == "last_value":
                pos = (end - 1).clamp(min=0)
            else:
                pos = start + int(spec.arg_literal) - 1
                nonempty = nonempty & (pos < end)
            valid = nonempty
            if sva is not None:
                valid = valid & _take(sva, pos)
            return _take(sv, pos), valid
        m = (torch.ones(cap, dtype=torch.bool, device=ctx["idx"].device)
             if sv is None or sva is None else sva)
        cnt = _prefix(m.to(torch.int64))
        c_at = _take(cnt, end) - _take(cnt, start)
        if fn == "count":
            return c_at, None
        if fn in ("min", "max"):
            big, small = _extremes(sv.dtype)
            ident = big if fn == "min" else small
            v = torch.where(m, sv, torch.full_like(sv, ident))
            return range_minmax(v, start, end, fn, ident, max_len), c_at > 0
        if sv.dtype.is_floating_point:
            s_at = range_sum(
                torch.where(m, sv, torch.zeros_like(sv)).to(torch.float64),
                start, end, max_len)
        else:
            ps = _prefix(torch.where(m, sv, torch.zeros_like(sv))
                         .to(torch.int64))
            s_at = _take(ps, end) - _take(ps, start)
        if fn == "sum":
            return s_at, c_at > 0
        return (s_at.to(torch.float64)
                / c_at.clamp(min=1).to(torch.float64), c_at > 0)

    def _eval_fn(self, spec, cols, ctx):
        fn = spec.fn
        idx = ctx["idx"]
        cap = idx.shape[0]
        part_change, peer_change = ctx["part_change"], ctx["peer_change"]
        part_start, part_end = ctx["part_start"], ctx["part_end"]
        peer_end = ctx["peer_end"]
        if fn == "row_number":
            return row_numbers(part_change), None
        if fn in ("rank", "dense_rank"):
            r, d = ranks(part_change, peer_change)
            return (r if fn == "rank" else d), None
        if fn == "percent_rank":
            r, _ = ranks(part_change, peer_change)
            n = (part_end - part_start).to(torch.float64)
            return torch.where(
                n > 1, (r - 1).to(torch.float64) / (n - 1).clamp(min=1),
                torch.zeros_like(n)), None
        if fn == "cume_dist":
            n = (part_end - part_start).to(torch.float64)
            return ((peer_end - part_start).to(torch.float64)
                    / n.clamp(min=1)), None
        if fn == "ntile":
            k = int(spec.arg_literal)
            rn = row_numbers(part_change) - 1
            n = part_end - part_start
            size = n // k
            rem = n % k
            cut = rem * (size + 1)
            bucket = torch.where(
                rn < cut, rn // (size + 1).clamp(min=1),
                rem + (rn - cut) // size.clamp(min=1))
            return bucket + 1, None

        # value functions need the sorted argument column
        if spec.arg is not None:
            av, ava = cols[spec.arg]
            sv = _take(av, ctx["perm"])
            sva = None if ava is None else _take(ava, ctx["perm"])
        else:
            sv = sva = None

        if spec.frame is not None:
            if fn not in _FRAMED:
                raise NotImplementedError(f"frame for window function {fn}")
            return self._framed(spec, cols, ctx, sv, sva)

        if fn in ("lead", "lag"):
            off = int(spec.arg_literal or 1)
            tgt = idx + off if fn == "lead" else idx - off
            valid = (tgt >= part_start) & (tgt < part_end)
            if sva is not None:
                valid = valid & _take(sva, tgt)
            return _take(sv, tgt), valid
        if fn == "first_value":
            return (_take(sv, part_start),
                    None if sva is None else _take(sva, part_start))
        if fn == "last_value":
            # the default frame ends at the current peer group
            pos = (peer_end - 1).clamp(min=0)
            return _take(sv, pos), None if sva is None else _take(sva, pos)
        if fn == "nth_value":
            pos = part_start + int(spec.arg_literal) - 1
            valid = pos < peer_end
            if sva is not None:
                valid = valid & _take(sva, pos)
            return _take(sv, pos), valid

        # aggregate-as-window, default frame (running to the current
        # peers): a segmented inclusive scan read at the peer group's end
        pos = (peer_end - 1).clamp(min=0)
        m = (torch.ones(cap, dtype=torch.bool, device=idx.device)
             if sva is None else sva)
        c = segmented_cumsum(m.to(torch.int64), part_change)
        if fn == "count":
            return _take(c, pos), None
        c_at = _take(c, pos)
        if fn in ("sum", "avg"):
            dt = torch.float64 if sv.dtype.is_floating_point else torch.int64
            s = segmented_cumsum(
                torch.where(m, sv, torch.zeros_like(sv)).to(dt), part_change)
            s_at = _take(s, pos)
            if fn == "sum":
                return s_at, c_at > 0
            return (s_at.to(torch.float64)
                    / c_at.clamp(min=1).to(torch.float64), c_at > 0)
        if fn in ("min", "max"):
            big, small = _extremes(sv.dtype)
            ident = big if fn == "min" else small
            v = torch.where(m, sv, torch.full_like(sv, ident))
            s = segmented_scan(v, part_change, fn)
            return _take(s, pos), c_at > 0
        raise NotImplementedError(f"window function {fn}")

    def is_finished(self) -> bool:
        return self.no_more_input_seen and self._emitted


class StreamingWindowOp(WindowOp):
    """velox/exec/window/RowsStreamingWindowBuild.h analog: the input is
    clustered by the partition keys (the optimizer checked), so complete
    partitions evaluate and emit per input batch; only the trailing,
    possibly incomplete, partition carries across batches. One counted
    host read per batch: where the last partition starts, and the row
    count."""

    blocking = False

    def __init__(self, node):
        super().__init__(node)
        self._carry: Optional[Batch] = None
        self._queue: collections.deque = collections.deque()

    def _split(self, big: Batch):
        sel = big.sel
        cap = sel.shape[0]
        pk = pack_indices(sel)
        n = sel.sum()
        change = torch.zeros(cap, dtype=torch.bool, device=sel.device)
        for k in self.node.partition_keys:
            c = big.column(k)
            for o in encode_sort_key(c.values, c.valid):
                o = _take(o, pk)
                change[1:] |= o[1:] != o[:-1]
        r = torch.arange(cap, device=sel.device)
        change &= r < n
        # start of the LAST partition among the packed rows
        last_start = torch.where(change, r, torch.zeros_like(r)).max()
        return pk, torch.stack([last_start, n])

    def add_input(self, batch: Batch) -> None:
        big = (concat_batches([self._carry, batch])
               if self._carry is not None else batch)
        pk, meta = self._split(big)
        complete, total = (int(x) for x in syncs.to_numpy(meta))
        if complete > 0:
            cap_c = min(round_capacity(complete), big.capacity)
            selc = torch.arange(cap_c, device=big.device) < complete
            self._queue.append(self.evaluate(
                big.gather(pk[:cap_c], selc, complete)))
        tail = total - complete
        if tail > 0:
            cap_t = round_capacity(tail)
            tidx = torch.cat([pk, pk.new_full((cap_t,), big.capacity)]
                             ).narrow(0, complete, cap_t)
            selt = torch.arange(cap_t, device=big.device) < tail
            self._carry = big.gather(tidx, selt, tail)
        else:
            self._carry = None

    def get_output(self) -> Optional[Batch]:
        if self._queue:
            return self._queue.popleft()
        if self.no_more_input_seen and not self._emitted:
            self._emitted = True
            if self._carry is not None:
                out = self.evaluate(self._carry)
                self._carry = None
                return out
        return None

    def is_finished(self) -> bool:
        return (self.no_more_input_seen and not self._queue
                and self._emitted)


class RowNumberOp(Operator):
    """velox/exec/RowNumber.h:27 — partition row numbering; arrival order
    within a partition is kept by the stable sort."""

    blocking = True

    def __init__(self, node):
        super().__init__(node)
        self._buffer = SpillableBuffer("row_number")
        self._out = None
        self._emitted = False

    def add_input(self, batch: Batch) -> None:
        self._buffer.append(batch)

    def _rn(self, big: Batch, partition_keys, sort_keys) -> torch.Tensor:
        cols = _cols_of(big, list(dict.fromkeys(
            list(partition_keys) + [k.name for k in sort_keys])))
        sel = big.sel
        perm = sort_indices(_sort_spec(cols, partition_keys, sort_keys), sel)
        part_ops = _sorted_key_ops(cols, list(partition_keys), perm)
        rn_sorted = row_numbers(_changes(part_ops, sel.shape[0], sel.device))
        return torch.empty_like(rn_sorted).index_copy_(0, perm, rn_sorted)

    def _limited(self, sort_keys, limit) -> Optional[Batch]:
        return next_blocking_output(self, lambda: blocking_output(
            self._buffer, _first_key(self.node.partition_keys),
            lambda big: self._numbered(big, sort_keys, limit),
            arrival_order=True))

    def _numbered(self, big: Batch, sort_keys, limit) -> Batch:
        node = self.node
        rn = self._rn(big, node.partition_keys, sort_keys)
        sel = big.sel if limit is None else big.sel & (rn <= limit)
        out = big.with_sel(sel)
        if node.row_number_name is not None:
            out = out.with_column(node.row_number_name, Column(BIGINT, rn))
        return out

    def get_output(self) -> Optional[Batch]:
        return self._limited((), self.node.limit)

    def is_finished(self) -> bool:
        return self.no_more_input_seen and self._emitted


class TopNRowNumberOp(RowNumberOp):
    """velox/exec/TopNRowNumber.h:79 — the top N rows of each partition."""

    def get_output(self) -> Optional[Batch]:
        return self._limited(self.node.sort_keys, self.node.limit)


class MarkDistinctOp(Operator):
    """velox/core/PlanNode.h:5638 — a boolean marker on the first
    occurrence of each key."""

    blocking = True

    def __init__(self, node):
        super().__init__(node)
        self._buffer = SpillableBuffer("mark_distinct")
        self._out = None
        self._emitted = False

    def add_input(self, batch: Batch) -> None:
        self._buffer.append(batch)

    def get_output(self) -> Optional[Batch]:
        return next_blocking_output(self, lambda: blocking_output(
            self._buffer, _first_key(self.node.keys), self._mark,
            arrival_order=True))

    def _mark(self, big: Batch) -> Batch:
        node = self.node
        cap = big.capacity
        cols = _cols_of(big, list(node.keys))
        _, group_rows, group_sel, _ = group_ids_sorted(
            [cols[k] for k in node.keys], big.sel)
        marker = torch.zeros(cap + 1, dtype=torch.bool, device=big.device)
        marker[torch.where(group_sel, group_rows,
                           torch.full_like(group_rows, cap))] = True
        return big.with_column(node.marker, Column(BOOLEAN, marker[:cap]))

    def is_finished(self) -> bool:
        return self.no_more_input_seen and self._emitted


class ExpandOp(Operator):
    """velox/core/PlanNode.h:1913 — each row -> N projected rows (one
    output batch per projection list)."""

    def __init__(self, node):
        super().__init__(node)
        self._evals = [ExprEvaluator(list(projs), node.source.output_type)
                       for projs in node.projections]
        self._queue: collections.deque = collections.deque()

    def add_input(self, batch: Batch) -> None:
        for ev in self._evals:
            pairs, dicts = ev.project_pairs(batch)
            cols = {name: Column(dtype, vals, valid, d)
                    for name, dtype, (vals, valid), d in zip(
                        self.node.names, self.output_type.children, pairs,
                        dicts)}
            self._queue.append(Batch(cols, batch.sel))

    def get_output(self) -> Optional[Batch]:
        return self._queue.popleft() if self._queue else None

    def is_finished(self) -> bool:
        return self.no_more_input_seen and not self._queue


class GroupIdOp(Operator):
    """velox/core/PlanNode.h:2018 — GROUPING SETS expansion: one output
    batch per grouping set, the keys it lacks nulled, plus a group_id
    column."""

    def __init__(self, node):
        super().__init__(node)
        self._queue: collections.deque = collections.deque()

    def add_input(self, batch: Batch) -> None:
        all_keys = set()
        for gs in self.node.grouping_sets:
            all_keys.update(gs)
        cap = batch.capacity
        for set_id, gs in enumerate(self.node.grouping_sets):
            cols = {}
            for n in self.output_type.names:
                if n == self.node.group_id_name:
                    cols[n] = Column(BIGINT, torch.full(
                        (cap,), set_id, dtype=torch.int64,
                        device=batch.device))
                elif n in all_keys and n not in gs:
                    src = batch.column(n)
                    cols[n] = Column(src.dtype, src.values, torch.zeros(
                        cap, dtype=torch.bool, device=batch.device),
                        src.dictionary)
                else:
                    cols[n] = batch.column(n)
            self._queue.append(Batch(cols, batch.sel))

    def get_output(self) -> Optional[Batch]:
        return self._queue.popleft() if self._queue else None

    def is_finished(self) -> bool:
        return self.no_more_input_seen and not self._queue


class UnionBridge:
    """Buffered batches from the non-first union/merge sources (the
    JoinBridge pattern applied to MixedUnion, velox/exec/JoinBridge.h)."""

    def __init__(self):
        self.batches: List[Batch] = []


class UnionSinkOp(Operator):
    """Sink pipeline terminal for sources[1:] of a union/merge."""

    blocking = True

    def __init__(self, node, bridge: UnionBridge):
        super().__init__(node)
        self.bridge = bridge

    def add_input(self, batch: Batch) -> None:
        self.bridge.batches.append(batch)

    def get_output(self) -> Optional[Batch]:
        return None

    def is_finished(self) -> bool:
        return self.no_more_input_seen


class UnionAllOp(Operator):
    """velox MixedUnion: the first source streams into a queue; at drain
    it joins the sibling pipelines' bridged batches (they ran to
    completion first). String columns whose branches carry different
    dictionaries are re-encoded onto one merged sorted dictionary
    (``harmonize_dictionaries``), so consumers downstream see one
    dictionary per column."""

    def __init__(self, node, bridge: UnionBridge):
        super().__init__(node)
        self.bridge = bridge
        self._drained = False
        self._queue: collections.deque = collections.deque()
        self._names = list(node.output_type.names)

    def add_input(self, batch: Batch) -> None:
        self._queue.append(batch.project(self._names))

    def get_output(self) -> Optional[Batch]:
        if self.no_more_input_seen and not self._drained:
            self._drained = True
            batches = list(self._queue) + [
                b.project(self._names) for b in self.bridge.batches]
            self._queue = collections.deque(harmonize_dictionaries(batches))
        if not self._drained:
            return None
        return self._queue.popleft() if self._queue else None

    def is_finished(self) -> bool:
        return (self.no_more_input_seen and self._drained
                and not self._queue)


class LocalMergeOp(Operator):
    """velox/exec/Merge.h:33 k-way ordered merge: the union of the
    (already sorted) streams goes through one stable sort."""

    blocking = True

    def __init__(self, node, bridge: UnionBridge):
        super().__init__(node)
        self.bridge = bridge
        self._buffer = SpillableBuffer("local_merge")
        self._out = None
        self._emitted = False
        self._names = list(node.output_type.names)

    def add_input(self, batch: Batch) -> None:
        self._buffer.append(batch.project(self._names))

    def get_output(self) -> Optional[Batch]:
        return next_blocking_output(self, self._merged_output)

    def _merged_output(self):
        # the other sources' batches after this one's, as unspilled
        for b in self.bridge.batches:
            self._buffer.append(b.project(self._names))
        self.bridge.batches = []
        k = self.node.keys[0]
        return blocking_output(self._buffer,
                               (k.name, k.descending, k.nulls_first),
                               self._sort, arrival_order=False)

    def _sort(self, big: Batch) -> Batch:
        keys = [(big.column(k.name).values, big.column(k.name).valid,
                 k.descending, k.nulls_first) for k in self.node.keys]
        perm = sort_indices(keys, big.sel)
        return big.gather(perm, big.sel.index_select(0, perm), big.num_rows)

    def is_finished(self) -> bool:
        return self.no_more_input_seen and self._emitted


class UnnestOp(Operator):
    """velox/exec/Unnest.h:25: one row per element of the ARRAY columns,
    the other columns replicated.

    No loop over rows: each input row marks its first output slot (the
    exclusive running sum of the lengths), and a prefix sum of the marks
    numbers each output slot's row (``ops/window.py`` ``run_owners``). With several columns a row gives as many rows as its
    longest array and the shorter ones pad with NULLs
    (velox/exec/Unnest.cpp:119); a NULL or empty array gives none. The
    output capacity is the elements' capacities summed, so no host read
    is needed."""

    def __init__(self, node):
        super().__init__(node)
        self._queue: collections.deque = collections.deque()

    def add_input(self, batch: Batch) -> None:
        from velox_tpu_torch.vector.column import ArrayColumn

        node = self.node
        acols = [batch.column(n) for n in node.unnest]
        for n, a in zip(node.unnest, acols):
            if not isinstance(a, ArrayColumn) or not isinstance(
                    a.elements, Column):
                raise NotImplementedError(
                    f"unnest of {n}: only ARRAY columns of flat elements")
        outcap = round_capacity(sum(a.elements.capacity for a in acols))
        dev = batch.device
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        lens = None
        for a in acols:
            ln = torch.where(batch.sel & a.validity(),
                             a.lengths.to(torch.int64), zero)
            lens = ln if lens is None else torch.maximum(lens, ln)
        out_pos = torch.cumsum(lens, 0) - lens
        total = out_pos[-1] + lens[-1]
        row_of = run_owners(out_pos, lens > 0, outcap).clamp(min=0)
        slot = torch.arange(outcap, dtype=torch.int64, device=dev)
        out_sel = slot < total
        rank = slot - _take(out_pos, row_of)
        types = dict(zip(self.output_type.names, self.output_type.children))
        cols = {}
        for n in node.replicated:
            src = batch.column(n)
            g = src.gather(row_of)
            cols[n] = (Column(types[n], g.values, g.valid, src.dictionary,
                              src.stats) if isinstance(src, Column) else g)
        for n, a in zip(node.unnest, acols):
            el = a.elements
            eidx = _take(a.starts, row_of).to(torch.int64) + rank
            valid = rank < _take(a.lengths, row_of).to(torch.int64)
            if el.valid is not None:
                valid = valid & _take(el.valid, eidx)
            # one column of non-NULL elements: every selected row is in
            # range, so the mask adds nothing to the selection
            if len(acols) == 1 and el.valid is None:
                valid = None
            cols[n] = Column(types[n], _take(el.values, eidx), valid,
                             el.dictionary)
        if node.ordinality is not None:
            cols[node.ordinality] = Column(BIGINT, rank + 1)
        self._queue.append(Batch(cols, out_sel))

    def get_output(self) -> Optional[Batch]:
        return self._queue.popleft() if self._queue else None

    def is_finished(self) -> bool:
        return self.no_more_input_seen and not self._queue
