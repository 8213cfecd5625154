"""Relational operators of the ported slice.

The port of ``TableScanOp``, ``FilterOp``, the scalar part of
``ProjectOp``, ``HashAggregationOp`` (kArray mode and the keyless generic
path) and ``OrderByOp`` from the JAX package's ``exec/operators.py``.
Each runs eagerly on the device its batches live on. Blocking operators
buffer in plain lists; spill stores wait for a later slice.
"""

from __future__ import annotations

import collections
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from velox_tpu_torch import resolve_device
from velox_tpu_torch.types.types import TypeKind, row_type
from velox_tpu_torch.vector.batch import Batch, concat_batches, round_capacity
from velox_tpu_torch.vector.column import Column, Dictionary
from velox_tpu_torch.exec.operator import ExprEvaluator, Operator
from velox_tpu_torch.functions.aggregates import init_lane, lookup_aggregate
from velox_tpu_torch.ops.groupby import group_ids_array
from velox_tpu_torch.ops.sort import sort_indices
from velox_tpu_torch.plan.nodes import AggregationNode, AggStep

#: string group keys that never saw input keep a (shared, empty)
#: dictionary so downstream bind-time string work keeps working
_EMPTY_DICT = Dictionary([])


def _key_dict_for(key_dicts, dtype, k):
    d = key_dicts.get(k)
    if d is None and dtype.is_string:
        return _EMPTY_DICT
    return d


def _cols_of(batch: Batch, names) -> Dict[str, Tuple]:
    return {n: (batch.column(n).values, batch.column(n).valid)
            for n in names}


# --------------------------------------------------------------- leaf ops

class TableScanOp(Operator):
    """velox/exec/TableScan.cpp: drains catalog splits and applies the
    pushed-down subfilter on the device (ScanSpec analog)."""

    def __init__(self, node):
        super().__init__(node)
        self._allc = node.all_columns
        self._splits_cache: Optional[collections.deque] = None
        fschema = node.output_type
        if node.filter_columns:
            from velox_tpu_torch.io.catalog import get_table

            tschema = get_table(node.table).schema
            fschema = row_type(list(self._allc),
                               [tschema.find_child(n) for n in self._allc])
        self._filter = (ExprEvaluator([node.subfilter], fschema)
                        if node.subfilter is not None else None)

    @property
    def _splits(self) -> collections.deque:
        if self._splits_cache is None:
            from velox_tpu_torch.io.catalog import get_table

            # in-memory splits: the subfilter runs on the device
            self._splits_cache = collections.deque(
                get_table(self.node.table).batches)
        return self._splits_cache

    def get_output(self) -> Optional[Batch]:
        if not self._splits:
            return None
        b = self._splits.popleft().project(self._allc)
        if self._filter is not None:
            b = b.with_sel(self._filter.filter_sel(b))
        return b.project(self.node.columns)   # drop filter-only columns

    def is_finished(self) -> bool:
        return not self._splits


# --------------------------------------------------------- filter/project

class FilterOp(Operator):
    """velox/exec/FilterProject.cpp, filter half."""

    def __init__(self, node):
        super().__init__(node)
        self._eval = ExprEvaluator([node.predicate], node.source.output_type)
        self._queue: collections.deque = collections.deque()

    def add_input(self, batch: Batch) -> None:
        self._queue.append(batch.with_sel(self._eval.filter_sel(batch)))

    def get_output(self) -> Optional[Batch]:
        return self._queue.popleft() if self._queue else None

    def is_finished(self) -> bool:
        return self.no_more_input_seen and not self._queue


class ProjectOp(Operator):
    """velox/exec/FilterProject.cpp, project half (scalar expressions)."""

    def __init__(self, node):
        super().__init__(node)
        for t in node.output_type.children:
            if t.kind in (TypeKind.ARRAY, TypeKind.MAP, TypeKind.ROW):
                raise NotImplementedError(
                    f"projection of {t} columns is not ported yet")
        self._eval = ExprEvaluator(list(node.exprs), node.source.output_type)
        self._queue: collections.deque = collections.deque()

    def add_input(self, batch: Batch) -> None:
        pairs, dicts = self._eval.project_pairs(batch)
        cols = {}
        for name, t, (vals, valid), d in zip(
                self.node.names, self.output_type.children, pairs, dicts):
            cols[name] = Column(t, vals, valid, d)
        self._queue.append(Batch(cols, batch.sel, batch.num_rows))

    def get_output(self) -> Optional[Batch]:
        return self._queue.popleft() if self._queue else None

    def is_finished(self) -> bool:
        return self.no_more_input_seen and not self._queue


# ------------------------------------------------------------ aggregation

#: kArray mode cap: direct-addressed accumulators
#: (velox/exec/HashTable.h kArrayHashMaxSize analog)
_MAX_ARRAY_GROUPS = 1 << 20


class HashAggregationOp(Operator):
    """velox/exec/HashAggregation.cpp + GroupingSet.cpp, two modes:

    * kArray (all keys dictionary-coded, small product): persistent
      direct-addressed accumulators, one scatter per batch, or one launch
      of the grouped-sum kernel B2 for all-additive integer aggregates;
    * keyless generic: one-slot partial accumulators per batch, merged
      once at output.
    """

    blocking = True

    def __init__(self, node: AggregationNode):
        super().__init__(node)
        if node.step != AggStep.SINGLE:
            raise NotImplementedError(
                f"{node.step} aggregation steps are not ported yet")
        self.step = node.step
        self.keys = list(node.keys)
        self.specs = list(node.aggregates)
        self.agg_names = list(node.agg_names)
        self.fns = [lookup_aggregate(s.fn) for s in self.specs]
        if any(s.distinct for s in self.specs):
            raise NotImplementedError("distinct aggregates are not ported")
        if any(isinstance(s.arg, tuple) for s in self.specs):
            raise NotImplementedError(
                "multi-argument aggregates are not ported")
        in_schema = node.source.output_type
        self.arg_types = [None if s.arg is None
                          else in_schema.find_child(s.arg)
                          for s in self.specs]
        self._needed = list(dict.fromkeys(
            self.keys
            + [s.arg for s in self.specs if s.arg is not None]
            + [s.mask for s in self.specs if s.mask is not None]))
        self._entries: List[dict] = []  # keyless partials (generic mode)
        self._array_state: Optional[dict] = None
        self._mode: Optional[str] = None
        self._key_dicts: Dict[str, Dictionary] = {}
        self._emitted = False
        self._device: Optional[torch.device] = None

    # ----------------------------------------------------------- helpers
    def _agg_inputs(self, cols, sel):
        """Per-aggregate (values, mask) for accumulate."""
        out = []
        for spec in self.specs:
            mask = sel
            if spec.mask is not None:
                mvals, mvalid = cols[spec.mask]
                mask = torch.logical_and(mask, mvals)
                if mvalid is not None:
                    mask = torch.logical_and(mask, mvalid)
            if spec.arg is None:
                out.append((None, mask))
            else:
                avals, avalid = cols[spec.arg]
                if avalid is not None:
                    mask = torch.logical_and(mask, avalid)
                out.append((avals, mask))
        return out

    def _init_accs(self, cap: int, device: torch.device):
        return [tuple(init_lane(lane, at, cap, device) for lane in fn.lanes)
                for fn, at in zip(self.fns, self.arg_types)]

    def decide_mode_dicts(self, key_dicts) -> str:
        if self._mode is not None:
            return self._mode
        if self.keys:
            dicts = [key_dicts.get(k) for k in self.keys]
            if all(d is not None for d in dicts):
                prod = 1
                for d in dicts:
                    prod *= len(d) + 1  # +1 null slot
                if prod <= _MAX_ARRAY_GROUPS:
                    self._mode = "array"
                    self._radices = [len(d) + 1 for d in dicts]
                    self._num_groups = prod
                    self._key_dicts = dict(zip(self.keys, dicts))
                    return self._mode
            raise NotImplementedError(
                "grouping on keys that are not all dictionary-coded "
                "(sort-based generic aggregation) is not ported yet")
        self._mode = "generic"
        return self._mode

    # ------------------------------------------------------------- input
    def add_input(self, batch: Batch) -> None:
        self._device = batch.device
        mode = self.decide_mode_dicts({
            k: batch.column(k).dictionary for k in self.keys})
        cols = _cols_of(batch, self._needed)
        if mode == "array":
            st = self.ensure_array_state(batch.device)
            st["accs"], st["seen"] = self.make_array_fn()(
                cols, batch.sel, st["accs"], st["seen"])
        else:
            self.push_generic_entry(*self.make_generic_fn()(cols, batch.sel))

    def ensure_array_state(self, device: torch.device) -> dict:
        if self._array_state is None:
            G = self._num_groups
            self._device = device
            self._array_state = {
                "accs": self._init_accs(G, device),
                "seen": torch.zeros((G,), dtype=torch.bool, device=device),
            }
        return self._array_state

    def make_array_fn(self):
        """Per-batch kArray step: (cols, sel, accs, seen) -> (accs, seen)."""
        radices = self._radices
        keys = self.keys
        G = self._num_groups

        def fn(cols, sel, accs_in, seen):
            vids = []
            for k, radix in zip(keys, radices):
                values, valid = cols[k]
                code = values.to(torch.int32)
                null_id = torch.full_like(code, radix - 1)
                vid = torch.where(code < 0, null_id, code)
                if valid is not None:
                    vid = torch.where(valid, vid, null_id)
                vids.append(vid)
            gids = group_ids_array(vids, radices, sel, G)
            inputs = self._agg_inputs(cols, sel)

            multi = self._try_multi_sum(gids, sel, inputs, accs_in, seen, G)
            if multi is not None:
                return multi

            seen_ext = torch.cat([seen, seen.new_zeros(1)])
            seen_ext.index_fill_(0, gids.long(), True)
            seen = seen_ext[:G]
            accs_out = [f.accumulate(accs, gids, vals, mask)
                        for f, accs, (vals, mask)
                        in zip(self.fns, accs_in, inputs)]
            return accs_out, seen

        return fn

    def _try_multi_sum(self, gids, sel, inputs, accs_in, seen, G):
        """All-additive kArray aggregation in ONE launch of kernel B2
        (every lane an exact grouped int64 sum). None if ineligible.

        The contribution layout is the JAX package's: each value masked;
        an int64 value split into a signed low-28-bit half and a high
        half; a count lane per value; the ``seen`` lane last."""
        from velox_tpu_torch.utils.config import config

        if not config.narrow_lanes or not (2 <= G <= 128):
            return None
        for spec, (vals, mask) in zip(self.specs, inputs):
            if spec.fn not in ("sum", "count", "avg"):
                return None
            if vals is not None and (vals.dtype.is_floating_point
                                     or vals.dtype == torch.bool):
                return None
        from velox_tpu_torch.ops.grouped_sum import grouped_multi_sum_i32

        zero32 = torch.zeros((), dtype=torch.int32, device=sel.device)
        contribs = []
        layout = []  # (agg index, lane index, left shift) per row
        for ai, (vals, mask) in enumerate(inputs):
            if vals is not None:
                if vals.element_size() <= 4:
                    contribs.append(torch.where(mask, vals.to(torch.int32),
                                                zero32))
                    layout.append((ai, 0, 0))
                else:
                    # wide value: two signed i32 halves (lo 28 bits, hi)
                    v = torch.where(mask, vals, torch.zeros_like(vals))
                    neg = v < 0
                    a = torch.where(neg, -v, v)
                    lo = (a & 0x0FFFFFFF).to(torch.int32)
                    hi = (a >> 28).to(torch.int32)
                    contribs.append(torch.where(neg, -lo, lo))
                    layout.append((ai, 0, 0))
                    contribs.append(torch.where(neg, -hi, hi))
                    layout.append((ai, 0, 28))
                contribs.append(mask.to(torch.int32))
                layout.append((ai, 1, 0))
            else:  # count(*): a single count lane
                contribs.append(mask.to(torch.int32))
                layout.append((ai, 0, 0))
        contribs.append(sel.to(torch.int32))  # "seen" groups
        sums = grouped_multi_sum_i32(
            gids.contiguous(), torch.stack(contribs), G)
        accs_out = [list(a) for a in accs_in]
        for row, (ai, li, shift) in enumerate(layout):
            delta = sums[row] << shift if shift else sums[row]
            accs_out[ai][li] = (accs_out[ai][li]
                                + delta.to(accs_in[ai][li].dtype))
        seen = torch.logical_or(seen, sums[-1] > 0)
        return [tuple(a) for a in accs_out], seen

    def make_generic_fn(self):
        """Per-batch keyless step: (cols, sel) -> one-slot partials."""
        if self.keys:
            raise NotImplementedError(
                "sort-based generic aggregation is not ported yet")

        def fn(cols, sel):
            inputs = self._agg_inputs(cols, sel)
            gids = torch.where(sel, torch.zeros((), dtype=torch.int32,
                                                device=sel.device),
                               torch.ones((), dtype=torch.int32,
                                          device=sel.device))
            group_sel = torch.any(sel)[None]
            lanes_out = [f.accumulate(accs, gids, vals, mask)
                         for f, accs, (vals, mask) in zip(
                             self.fns, self._init_accs(1, sel.device),
                             inputs)]
            return [], lanes_out, group_sel, [None] * len(self.specs)

        return fn

    def push_generic_entry(self, gkeys, lanes_out, group_sel, dreps) -> None:
        self._entries.append({"keys": gkeys, "lanes": lanes_out,
                              "sel": group_sel, "distinct": dreps})

    # ------------------------------------------------------------ output
    def get_output(self) -> Optional[Batch]:
        if not self.no_more_input_seen or self._emitted:
            return None
        self._emitted = True
        if self._mode == "array":
            return self._finish_array()
        if not self._entries:
            return self._empty_result()
        entries, self._entries = self._entries, []
        return self._merge_entries(entries)

    def _finish_array(self) -> Batch:
        st = self._array_state
        if st is None:
            raise RuntimeError("no input reached array-mode aggregation")
        G = self._num_groups
        cap = max(round_capacity(G), G)
        pad = cap - G
        device = st["seen"].device

        def padded(a, fill=0):
            if pad == 0:
                return a
            return torch.cat([a, torch.full((pad,), fill, dtype=a.dtype,
                                            device=device)])

        seen = padded(st["seen"], False)
        cols = {}
        stride = 1
        gid_idx = np.arange(G)
        for k, radix in zip(self.keys, self._radices):
            codes = ((gid_idx // stride) % radix).astype(np.int32)
            valid_np = codes != radix - 1
            codes = np.where(valid_np, codes, -1).astype(np.int32)
            stride *= radix
            v = padded(torch.from_numpy(codes).to(device), -1)
            va = padded(torch.from_numpy(valid_np).to(device), False)
            kt = self.output_type.find_child(k)
            cols[k] = Column(kt, v, va, _key_dict_for(self._key_dicts, kt, k))
        for name, fn, accs in zip(self.agg_names, self.fns, st["accs"]):
            vals, valid = fn.extract(tuple(padded(a) for a in accs), seen)
            cols[name] = Column(self.output_type.find_child(name), vals,
                                valid)
        return Batch(cols, seen)

    def _merge_entries(self, entries: List[dict]) -> Batch:
        """Combine the keyless one-slot partials into the single output
        row (slot 0 of a lane-sized batch)."""
        n_reg = sum(e["sel"].shape[0] for e in entries)
        cap = round_capacity(n_reg)
        pad = cap - n_reg
        device = entries[0]["sel"].device

        def cat(parts, fill=0):
            if pad:
                parts = parts + [torch.full((pad,), fill,
                                            dtype=parts[0].dtype,
                                            device=device)]
            return torch.cat(parts)

        sel = cat([e["sel"] for e in entries], False)
        gids = torch.where(sel, torch.zeros((), dtype=torch.int32,
                                            device=device),
                           torch.full((), cap, dtype=torch.int32,
                                      device=device))
        # a global aggregation emits one row even on empty input
        group_sel = torch.zeros((cap,), dtype=torch.bool, device=device)
        group_sel[0] = True
        cols = {}
        for ai, (name, fn, accs) in enumerate(zip(
                self.agg_names, self.fns, self._init_accs(cap, device))):
            lanes = tuple(cat([e["lanes"][ai][li] for e in entries])
                          for li in range(len(fn.lanes)))
            accs = fn.combine(tuple(accs), gids, lanes, sel)
            vals, valid = fn.extract(accs, group_sel)
            cols[name] = Column(self.output_type.find_child(name), vals,
                                valid)
        return Batch(cols, group_sel)

    def _empty_result(self) -> Batch:
        cap = round_capacity(1)
        device = self._device or resolve_device(None)
        if self.keys:
            return Batch.empty_like(self.output_type, cap, device)
        sel = torch.zeros((cap,), dtype=torch.bool, device=device)
        sel[0] = True
        cols = {}
        for name, fn, accs in zip(self.agg_names, self.fns,
                                  self._init_accs(cap, device)):
            vals, valid = fn.extract(accs, sel)
            cols[name] = Column(self.output_type.find_child(name), vals,
                                valid)
        return Batch(cols, sel)

    def is_finished(self) -> bool:
        return self.no_more_input_seen and self._emitted


# ------------------------------------------------------------------ order

class OrderByOp(Operator):
    """velox/exec/OrderBy.h: buffer everything, one stable sort at the
    end."""

    blocking = True

    def __init__(self, node):
        super().__init__(node)
        self._buffer: List[Batch] = []
        self._emitted = False

    def add_input(self, batch: Batch) -> None:
        self._buffer.append(batch)

    def get_output(self) -> Optional[Batch]:
        if not self.no_more_input_seen or self._emitted:
            return None
        self._emitted = True
        batches, self._buffer = self._buffer, []
        if not batches:
            return None
        big = concat_batches(batches)
        keys = [(big.column(k.name).values, big.column(k.name).valid,
                 k.descending, k.nulls_first) for k in self.node.keys]
        perm = sort_indices(keys, big.sel)
        return big.gather(perm, big.sel.index_select(0, perm), big.num_rows)

    def is_finished(self) -> bool:
        return self.no_more_input_seen and self._emitted
