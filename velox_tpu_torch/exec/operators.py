"""Relational operators of the ported slices.

The port of the JAX package's ``exec/operators.py`` for the 22 TPC-H
queries: ``TableScanOp`` (with pushed dynamic filters), ``FilterOp``,
``ProjectOp`` (scalar expressions, and the forms that make or read
ARRAY, MAP and ROW columns), ``HashAggregationOp`` (kArray and the
generic sort-based mode; SINGLE, PARTIAL and FINAL steps, adaptive
partial aggregation, multi-argument aggregates and matrix lanes,
single-step ``count(distinct)``), ``StreamingAggregationOp`` (SINGLE and
FINAL, with a fused HAVING), ``OrderByOp``,
``TopNOp``, ``LimitOp``, the hash and merge joins (``JoinKeyCodec``,
``JoinBridge``, ``HashBuildOp``, ``HashProbeOp`` for all eight join
types with residual filters, ``MergeJoinBuildOp``,
``MergeJoinProbeOp``), the cross join
(``CrossBuildOp``, ``CrossProbeOp``), ``EnforceSingleRowOp``, the
``ValuesOp`` leaf and ``AssignUniqueIdOp``. ``HashAggregationOp`` also
has a collect mode (``exec/collect_agg.py``) for the aggregates that need
every value at finish. Each runs
eagerly on the device its batches live on. Blocking operators buffer in
the spill stores of ``exec/spill.py`` (``SpillableBuffer``,
``PartitionedEntryStore``), which move to host RAM and on to page files
under a memory budget; a spilled hash build is split by key hash and the
probe joins one part at a time, a spilled OrderBy sorts one range of its
first key at a time (``blocking_output``). ``EnforceSingleRowOp`` keeps a
plain list. Where a size depends on the data (a join's match total, a
batch's group count) the operator reads it on the host once, through
``utils/syncs.py``, which counts every such read.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from velox_tpu_torch import resolve_device, torch_dtype
from velox_tpu_torch.types import BIGINT, BOOLEAN
from velox_tpu_torch.types.types import TypeKind, row_type
from velox_tpu_torch.vector.batch import Batch, concat_batches, round_capacity
from velox_tpu_torch.vector.column import (
    ArrayColumn, Column, Dictionary, MapColumn, RowColumn,
)
from velox_tpu_torch.exec.complex_fns import (
    and_valid, count_by, eval_lambda, evaluate_args, expand, gather_elem,
    null_rows, offsets, pack_column, pack_rows, run_heads, sort_within_rows,
    take, take_valid, union_codes,
)
from velox_tpu_torch.exec.operator import ExprEvaluator, Operator
from velox_tpu_torch.exec.spill import (
    PartitionedEntryStore, SpillableBuffer, partition_batches,
    restore_fragments,
)
from velox_tpu_torch.functions.aggregates import (
    _masked, init_lane, lookup_aggregate,
)
from velox_tpu_torch.ops.groupby import (
    SCAN_COMBINE, group_ids_array, group_ids_sorted, segment_scan,
)
from velox_tpu_torch.ops.join import (
    build_join_index, build_join_index_presorted, build_join_table,
    build_matched_flags, expand_matches, output_counts, probe_join_index,
    probe_join_index_merge, probe_join_index_merge_repair, probe_join_table,
    valid_ascending_code,
)
from velox_tpu_torch.ops.sort import (
    lex_sort, pack_indices, sort_indices, top_n_indices,
)
from velox_tpu_torch.ops.sortkey import encode_sort_key
from velox_tpu_torch.expr.ir import Call, FieldRef, Literal
from velox_tpu_torch.plan.nodes import AggregationNode, AggStep, JoinType
from velox_tpu_torch.utils import syncs
from velox_tpu_torch.utils.testvalue import TestValue

#: string group keys that never saw input keep a (shared, empty)
#: dictionary so downstream bind-time string work keeps working
_EMPTY_DICT = Dictionary([])


def _key_dict_for(key_dicts, dtype, k):
    d = key_dicts.get(k)
    if d is None and dtype.is_string:
        return _EMPTY_DICT
    return d


def plan_device(node) -> torch.device:
    """The device of the first table the plan below ``node`` scans: where
    an operator that saw no batch makes its empty result."""
    from velox_tpu_torch.io.catalog import get_table
    from velox_tpu_torch.plan.nodes import TableScanNode

    stack = [node]
    while stack:
        n = stack.pop()
        if isinstance(n, TableScanNode):
            return get_table(n.table).batches[0].device
        stack.extend(reversed(n.sources))
    return resolve_device(None)


def _cols_of(batch: Batch, names) -> Dict[str, Tuple]:
    return {n: (batch.column(n).values, batch.column(n).valid)
            for n in names}


# --------------------------------------------------------------- leaf ops

class ValuesOp(Operator):
    """velox/core/PlanNode.h ValuesNode executor: the node's batches, in
    order, on the device they were made on."""

    def __init__(self, node):
        super().__init__(node)
        self._queue = collections.deque(node.batches)

    def get_output(self) -> Optional[Batch]:
        return self._queue.popleft() if self._queue else None

    def is_finished(self) -> bool:
        return not self._queue


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
        #: filters a join pushes in when its build side publishes, before
        #: this scan's first split (velox/exec/HashProbe.cpp:419-444)
        self.dynamic_filters: List[ExprEvaluator] = []
        self.fschema = fschema

    @property
    def _splits(self) -> collections.deque:
        if self._splits_cache is None:
            from velox_tpu_torch.io.catalog import get_table

            # in-memory splits: the subfilter runs on the device
            self._splits_cache = collections.deque(
                get_table(self.node.table).make_splits())
        return self._splits_cache

    def get_output(self) -> Optional[Batch]:
        if not self._splits:
            return None
        b = self._splits.popleft().project(self._allc)
        if self._filter is not None:
            b = b.with_sel(self._filter.filter_sel(b))
        for df in self.dynamic_filters:
            b = b.with_sel(df.filter_sel(b))
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


def _extract_row_path(batch: Batch, dotted: str):
    """A column, or a dotted path into ROW columns ("r.tags"), with each
    parent row's NULL mask ANDed into the child (velox RowVector childAt
    and its null propagation)."""
    if dotted in batch:
        return batch.column(dotted)
    parts = dotted.split(".")
    for k in range(len(parts) - 1, 0, -1):
        head = ".".join(parts[:k])
        if head not in batch:
            continue
        col, acc = batch.column(head), None
        for nm in parts[k:]:
            if not isinstance(col, RowColumn):
                break
            acc = and_valid(acc, col.valid)
            col = col.child(nm)
        else:
            if acc is not None:
                col = dataclasses.replace(col, valid=and_valid(col.valid,
                                                               acc))
            return col
    raise KeyError(f"no column or row subfield {dotted!r} in batch")


#: call names ProjectOp runs itself, each by its ``_apply_*`` form
_PROJECT_FORMS = {
    "transform": "transform", "sequence": "sequence", "repeat": "sequence",
    "slice": "slice", "array_sort": "reorder", "array_distinct": "reorder",
    "transform_values": "map_lambda", "map_filter": "map_lambda",
    "transform_keys": "map_lambda", "zip_with": "array_combo",
    "array_concat": "array_combo", "array_reverse": "array_combo",
    "filter": "array_filter", "map_concat": "map_concat",
    "split": "split", "regexp_split": "split",
    "regexp_extract_all": "split", "array_intersect": "setop",
    "array_except": "setop", "array_union": "setop",
    "arrays_overlap": "setop", "map_keys": "map_proj",
    "map_values": "map_proj", "row_constructor": "row",
    "map_entries": "map_entries", "zip": "zip",
}

_COMPLEX_KINDS = (TypeKind.ARRAY, TypeKind.MAP, TypeKind.ROW)


class ProjectOp(Operator):
    """velox/exec/FilterProject.cpp, project half. Scalar expressions run
    through one ``ExprEvaluator``; a projection that makes or passes an
    ARRAY, MAP or ROW column runs its own form: a pass-through (offsets
    and shared elements move as they are), a lambda over the flat
    element lanes (``transform``, ``filter``, the map lambdas,
    ``zip_with``), an expansion with one host read of the element total
    and flat sorts and packs (``array_sort``, the set operations,
    ``map_concat``, ``sequence``, ``split``), or an applier of
    ``exec/complex_fns.py``."""

    def __init__(self, node):
        from velox_tpu_torch.exec.complex_fns import EXT_APPLIERS

        super().__init__(node)
        types = dict(zip(node.names, node.output_type.children))
        self._types = types
        #: output name -> (form, expression) for every non-scalar form
        self._forms: Dict[str, tuple] = {}
        scalar = []
        for name, e in zip(node.names, node.exprs):
            t = types[name]
            form = None
            if isinstance(e, FieldRef) and t.kind in _COMPLEX_KINDS:
                form = "pass"          # a column or a ROW subfield path
            elif isinstance(e, Call) and e.name in _PROJECT_FORMS:
                form = _PROJECT_FORMS[e.name]
            elif isinstance(e, Call) and e.name in EXT_APPLIERS:
                form = "ext"
            if form is None:
                scalar.append((name, e))
                continue
            self._forms[name] = (form, e)
            if form == "row":
                # scalar fields evaluate with the rest as "name#fi"
                for i, (ct, a) in enumerate(zip(t.children, e.args)):
                    if ct.kind not in _COMPLEX_KINDS:
                        scalar.append((f"{name}#f{i}", a))
        self._scalar_names = [n for n, _ in scalar]
        self._eval = ExprEvaluator([e for _, e in scalar],
                                   node.source.output_type)
        self._queue: collections.deque = collections.deque()

    def add_input(self, batch: Batch) -> None:
        from velox_tpu_torch.exec.complex_fns import EXT_APPLIERS

        by_name = {}
        if self._scalar_names:
            pairs, dicts = self._eval.project_pairs(batch)
            by_name = dict(zip(self._scalar_names, zip(pairs, dicts)))
        cols = {}
        for name in self.node.names:
            t = self._types[name]
            if name not in self._forms:
                (vals, valid), d = by_name[name]
                cols[name] = Column(t, vals, valid, d)
                continue
            form, e = self._forms[name]
            if form == "pass":
                cols[name] = _extract_row_path(batch, e.name)
            elif form == "ext":
                cols[name] = EXT_APPLIERS[e.name](self, batch, e, t)
            elif form == "row":
                cols[name] = self._make_row(batch, e, t, name, by_name)
            else:
                cols[name] = getattr(self, f"_apply_{form}")(batch, e, t)
        self._queue.append(Batch(cols, batch.sel, batch.num_rows))

    # ------------------------------------------------------------ forms
    def _apply_transform(self, batch, e, out_t):
        """transform(a, x -> body): the body over the flat element lane,
        offsets shared (ArrayFunctions transform)."""
        src = batch.column(e.args[0].name)
        lam = e.args[1]
        (vals, valid), d = eval_lambda(batch, lam,
                                       [(lam.params[0], src.elements)], src)
        return ArrayColumn(out_t, src.starts, src.lengths,
                           Column(out_t.element, vals, valid, d), src.valid)

    #: at most this many entries a row (Presto caps sequence)
    _MAX_SEQ = 10_000

    def _apply_sequence(self, batch, e, out_t):
        """sequence(lo, hi) and repeat(value, n): generated arrays, one
        host read of the element total (Sequence.h)."""
        (lo, lov), (hi, hiv) = evaluate_args(batch, e.args)
        is_repeat = e.name == "repeat"
        valid = and_valid(batch.sel, hiv)
        if not is_repeat:
            valid = and_valid(valid, lov)
        n = hi if is_repeat else hi - lo + 1
        lens = torch.where(valid, n.to(torch.int64).clamp(0, self._MAX_SEQ),
                           torch.zeros((), dtype=torch.int64,
                                       device=batch.device))
        ex = expand(torch.zeros_like(lens), lens, batch.sel)
        base = take(lo, ex.row_of)
        if is_repeat:
            elem = Column(e.args[0].dtype, base, take_valid(lov, ex.row_of))
        else:
            elem = Column(BIGINT, base.to(torch.int64) + ex.ordinal)
        row_valid = (valid if (lov is not None and not is_repeat)
                     or hiv is not None else None)
        return ArrayColumn(out_t, ex.nst, lens, elem, row_valid)

    def _apply_slice(self, batch, e, out_t):
        """slice(a, start, length): 1-based start, negative from the end;
        offsets only."""
        src = batch.column(e.args[0].name)
        (sv, _), (lv, _) = evaluate_args(batch, e.args[1:])
        ln = src.lengths.to(torch.int64)
        sv = sv.to(torch.int64)
        off = torch.where(sv < 0, ln + sv, sv - 1)
        off = torch.minimum(off.clamp(min=0), ln)
        new_len = torch.minimum(lv.to(torch.int64).clamp(min=0), ln - off)
        return ArrayColumn(out_t, src.starts + off, new_len, src.elements,
                           src.valid)

    def _apply_reorder(self, batch, e, out_t):
        """array_sort / array_distinct (ArraySort.cpp, ArrayDistinct.cpp):
        the elements sorted within each row; distinct keeps the first of
        each equal run, back in arrival order."""
        src = batch.column(e.args[0].name)
        ex = expand(src.starts, src.lengths, batch.sel)
        ev, evd = gather_elem(src.elements, ex.src_idx)
        vops = encode_sort_key(ev, evd)
        perm, srow = sort_within_rows(ex, vops)
        dic = src.elements.dictionary
        if e.name == "array_sort":
            return ArrayColumn(out_t, ex.nst, ex.lens, Column(
                out_t.element, take(ev, perm), take_valid(evd, perm), dic),
                src.valid)
        keep_sorted = run_heads([srow] + [take(k, perm) for k in vops]) \
            & (srow < ex.ecap)
        keep = torch.zeros_like(keep_sorted)
        keep[perm] = keep_sorted
        # slots are already in (row, arrival) order: pack the kept ones
        pperm, nst, kcnt = pack_rows(ex, keep, batch.capacity)
        return ArrayColumn(out_t, nst, kcnt, Column(
            out_t.element, take(ev, pperm), take_valid(evd, pperm), dic),
            src.valid)

    def _apply_map_lambda(self, batch, e, out_t):
        """transform_values / transform_keys / map_filter (MapFunctions.h):
        the lambda over the flat entry lanes; map_filter packs the kept
        entries. transform_keys does not check the new keys for
        duplicates (the JAX package's form)."""
        from velox_tpu_torch.exec.collect_agg import element_owners

        src = batch.column(e.args[0].name)
        lam = e.args[1]
        kp, vp = lam.params
        (vals, valid), d = eval_lambda(
            batch, lam, [(kp, src.keys), (vp, src.values)], src)
        if e.name == "transform_values":
            return MapColumn(out_t, src.starts, src.lengths, src.keys,
                             Column(out_t.value, vals, valid, d), src.valid)
        if e.name == "transform_keys":
            return MapColumn(out_t, src.starts, src.lengths,
                             Column(out_t.key, vals, valid, d), src.values,
                             src.valid)
        owner, within = element_owners(src.starts, src.lengths,
                                       src.keys.capacity)
        keep = and_valid(within & vals, valid)     # a NULL drops
        kcnt = count_by(owner, keep, batch.capacity)
        perm = pack_indices(keep, src.keys.capacity)
        return MapColumn(out_t, offsets(kcnt), kcnt,
                         pack_column(src.keys, perm),
                         pack_column(src.values, perm), src.valid)

    def _apply_array_combo(self, batch, e, out_t):
        """zip_with(a, b, (x, y) -> body), array_concat(a, b),
        array_reverse(a) (ZipWith.h, ArrayConcat, reverse)."""
        srcs = [batch.column(a.name) for a in e.args
                if isinstance(a, FieldRef)]
        if e.name == "array_reverse":
            from velox_tpu_torch.exec.collect_agg import element_owners

            src = srcs[0]
            ecap = src.elements.capacity
            owner, within = element_owners(src.starts, src.lengths, ecap)
            st = take(src.starts, owner).to(torch.int64)
            ln = take(src.lengths, owner).to(torch.int64)
            p = torch.arange(ecap, device=st.device)
            idx = torch.where(within, 2 * st + ln - 1 - p, p)
            return ArrayColumn(out_t, src.starts, src.lengths,
                               pack_column(src.elements, idx), src.valid)
        ca, cb = srcs
        if (ca.elements.dictionary is not None
                and ca.elements.dictionary is not cb.elements.dictionary
                and e.name == "array_concat"):
            raise NotImplementedError(
                f"{e.name}: string arrays must share a dictionary")
        nv = null_rows([ca, cb])
        live = and_valid(batch.sel, nv)
        zero = torch.zeros((), dtype=torch.int64, device=batch.device)
        la = torch.where(live, ca.lengths.to(torch.int64), zero)
        lb = torch.where(live, cb.lengths.to(torch.int64), zero)
        lens = la + lb if e.name == "array_concat" else torch.maximum(la, lb)
        ex = expand(torch.zeros_like(lens), lens, live)
        ra, rb = take(la, ex.row_of), take(lb, ex.row_of)

        def gather(col, ord_, in_b):
            v, vd = gather_elem(col.elements,
                                take(col.starts, ex.row_of) + ord_)
            return v, and_valid(in_b, vd)

        if e.name == "array_concat":
            from_a = ex.ordinal < ra
            av, avd = gather(ca, ex.ordinal, from_a)
            bv, bvd = gather(cb, ex.ordinal - ra, ~from_a)
            valid = (None if ca.elements.valid is None
                     and cb.elements.valid is None
                     else torch.where(from_a, avd, bvd))
            return ArrayColumn(out_t, ex.nst, lens, Column(
                out_t.element, torch.where(from_a, av, bv), valid,
                ca.elements.dictionary), nv)
        av, avd = gather(ca, ex.ordinal, ex.ordinal < ra)
        bv, bvd = gather(cb, ex.ordinal, ex.ordinal < rb)
        lam = e.args[2]
        xp, yp = lam.params
        (vals, valid), d = eval_lambda(batch, lam, [
            (xp, Column(ca.dtype.element, av, avd, ca.elements.dictionary)),
            (yp, Column(cb.dtype.element, bv, bvd, cb.elements.dictionary))],
            ex.row_of, ex.in_run)
        return ArrayColumn(out_t, ex.nst, lens,
                           Column(out_t.element, vals, valid, d), nv)

    def _apply_array_filter(self, batch, e, out_t):
        """filter(a, x -> pred): the kept elements packed, offsets
        rebuilt; a NULL predicate drops."""
        from velox_tpu_torch.exec.collect_agg import element_owners

        src = batch.column(e.args[0].name)
        lam = e.args[1]
        ecap = src.elements.capacity
        owner, within = element_owners(src.starts, src.lengths, ecap)
        (pred, pvalid), _ = eval_lambda(
            batch, lam, [(lam.params[0], src.elements)], owner, within)
        keep = and_valid(within & pred, pvalid)
        kcnt = count_by(owner, keep, batch.capacity)
        perm = pack_indices(keep, ecap)
        return ArrayColumn(out_t, offsets(kcnt), kcnt,
                           pack_column(src.elements, perm), src.valid)

    def _apply_map_concat(self, batch, e, out_t):
        """map_concat(m1, m2) (MapConcat.cpp): both entry runs sorted by
        (row, key, side); the last entry of each (row, key) run wins, so
        the later map overrides."""
        ca = batch.column(e.args[0].name)
        cb = batch.column(e.args[1].name)
        kdic, ka_codes, kb_codes = union_codes(ca.keys, cb.keys)
        vdic, va_codes, vb_codes = union_codes(ca.values, cb.values)
        cap = batch.capacity
        nv = null_rows([ca, cb])
        live = and_valid(batch.sel, nv)
        parts = []
        for col, kc, vc in ((ca, ka_codes, va_codes),
                            (cb, kb_codes, vb_codes)):
            ex = expand(col.starts, col.lengths, live)
            vd = take_valid(col.values.valid, ex.src_idx)
            parts.append((ex, take(kc, ex.src_idx), take(vc, ex.src_idx),
                          vd))
        (ea, ka, va, vda), (eb, kb, vb, vdb) = parts
        row_of = torch.cat([ea.row_of, eb.row_of])
        in_run = torch.cat([ea.in_run, eb.in_run])
        kv = torch.cat([ka, kb])
        vv = torch.cat([va, vb])
        vvd = (None if vda is None and vdb is None else torch.cat([
            vda if vda is not None else torch.ones_like(ea.in_run),
            vdb if vdb is not None else torch.ones_like(eb.in_run)]))
        tag = torch.cat([torch.zeros_like(ea.row_of),
                         torch.ones_like(eb.row_of)])
        row_key = torch.where(in_run, row_of, torch.full_like(row_of, cap))
        kops = encode_sort_key(kv, None)
        sperm = lex_sort([row_key, *kops, tag])
        srow = take(row_key, sperm)
        diff = run_heads([srow] + [take(k, sperm) for k in kops])
        nxt = torch.cat([diff[1:], diff[:1] | True])    # a run's last wins
        keep_sorted = nxt & (srow < cap)
        perm = take(sperm, pack_indices(keep_sorted, kv.shape[0]))
        kcnt = count_by(srow, keep_sorted, cap)
        return MapColumn(out_t, offsets(kcnt), kcnt,
                         Column(out_t.key, take(kv, perm), None, kdic),
                         Column(out_t.value, take(vv, perm),
                                take_valid(vvd, perm), vdic), nv)

    def _apply_split(self, batch, e, out_t):
        """split(s, delim [, limit]), regexp_split, regexp_extract_all
        (SplitFunctions.cpp): each DISTINCT string is split once on the
        host; the device gathers from the piece tables after one
        expansion."""
        src = batch.column(e.args[0].name)
        d = src.dictionary
        if d is None or not all(isinstance(a, Literal) for a in e.args[1:]):
            raise TypeError(f"{e.name} needs a dictionary column and "
                            "literal arguments")
        delim = e.args[1].value
        if e.name == "split":
            limit = int(e.args[2].value) if len(e.args) > 2 else None
            pieces = [str(v).split(delim) if limit is None
                      else str(v).split(delim, limit - 1) for v in d.values]
        else:
            import re

            from velox_tpu_torch.functions.hostfns import _java_regex

            rx = re.compile(_java_regex(delim))
            if e.name == "regexp_split":
                pieces = [rx.split(str(v)) for v in d.values]
            else:
                grp = int(e.args[2].value) if len(e.args) > 2 else 0
                pieces = [[m.group(grp) or "" for m in rx.finditer(str(v))]
                          for v in d.values]
        nd = Dictionary(sorted({p for ps in pieces for p in ps}))
        lens_t = np.zeros(len(d) + 1, np.int64)
        starts_t = np.zeros(len(d) + 1, np.int64)
        flat: list = []
        for i, ps in enumerate(pieces):
            starts_t[i + 1] = len(flat)
            lens_t[i + 1] = len(ps)
            flat.extend(nd.code_of(x) for x in ps)
        dev = batch.device
        code1 = src.values.to(torch.int64) + 1
        lens = take(torch.from_numpy(lens_t).to(dev), code1)
        ex = expand(torch.zeros_like(lens), lens,
                    and_valid(batch.sel, src.valid))
        src_idx = take(torch.from_numpy(starts_t).to(dev),
                       take(code1, ex.row_of)) + ex.ordinal
        flat_t = torch.tensor(flat or [0], dtype=torch.int32, device=dev)
        return ArrayColumn(out_t, ex.nst, ex.lens, Column(
            out_t.element, take(flat_t, src_idx), None, nd), src.valid)

    def _apply_setop(self, batch, e, out_t):
        """array_intersect / array_except / array_union / arrays_overlap
        (ArrayIntersectExcept.cpp, ArraysOverlapFunction.h): both arrays'
        elements in one tagged table sorted by (row, value, side,
        ordinal); each (row, value) run's head decides membership, and
        the kept elements leave in (side, ordinal) order."""
        ca = batch.column(e.args[0].name)
        cb = batch.column(e.args[1].name)
        if (ca.elements.dictionary is not None
                and ca.elements.dictionary is not cb.elements.dictionary):
            raise NotImplementedError(
                f"{e.name}: string arrays must share a dictionary")
        cap = batch.capacity
        nv = null_rows([ca, cb])
        live = and_valid(batch.sel, nv)
        exs = [expand(c.starts, c.lengths, live) for c in (ca, cb)]
        evs = [gather_elem(c.elements, x.src_idx) for c, x in zip((ca, cb),
                                                                  exs)]
        row_of = torch.cat([x.row_of for x in exs])
        ordinal = torch.cat([x.ordinal for x in exs])
        in_run = torch.cat([x.in_run for x in exs])
        ev = torch.cat([v for v, _ in evs])
        evd = (None if all(vd is None for _, vd in evs) else torch.cat([
            vd if vd is not None else torch.ones_like(x.in_run)
            for (_, vd), x in zip(evs, exs)]))
        tag = torch.cat([torch.zeros_like(exs[0].row_of),
                         torch.ones_like(exs[1].row_of)])
        row_key = torch.where(in_run, row_of, torch.full_like(row_of, cap))
        vops = encode_sort_key(ev, evd)
        sperm = lex_sort([row_key, *vops, tag, ordinal])
        srow = take(row_key, sperm)
        stag = take(tag, sperm)
        n = ev.shape[0]
        diff = run_heads([srow] + [take(k, sperm) for k in vops])
        rid = torch.cumsum(diff.to(torch.int64), 0) - 1
        slive = srow < cap
        spare = torch.full_like(rid, n)

        def run_has(flag):
            out = torch.zeros(n + 1, dtype=torch.int64, device=rid.device)
            out.index_add_(0, torch.where(slive, rid, spare),
                           flag.to(torch.int64))
            return take(out[:n] > 0, rid)

        has_a, has_b = run_has(stag == 0), run_has(stag == 1)
        heads = diff & slive
        if e.name == "arrays_overlap":
            return Column(BOOLEAN, count_by(srow, heads & has_a & has_b,
                                            cap) > 0, nv)
        if e.name == "array_intersect":
            keep_sorted = heads & (stag == 0) & has_b
        elif e.name == "array_except":
            keep_sorted = heads & (stag == 0) & ~has_b
        else:
            keep_sorted = heads
        keep = torch.zeros_like(keep_sorted)
        keep[sperm] = keep_sorted
        kcnt = count_by(row_of, keep, cap)
        row_key2 = torch.where(keep, row_of, torch.full_like(row_of, cap))
        perm2 = lex_sort([row_key2, tag, ordinal])
        return ArrayColumn(out_t, offsets(kcnt), kcnt, Column(
            out_t.element, take(ev, perm2), take_valid(evd, perm2),
            ca.elements.dictionary), nv)

    def _apply_map_proj(self, batch, e, out_t):
        """map_keys / map_values: an ARRAY sharing the map's offsets."""
        src = batch.column(e.args[0].name)
        return ArrayColumn(out_t, src.starts, src.lengths,
                           src.keys if e.name == "map_keys" else src.values,
                           src.valid)

    def _make_row(self, batch, e, rt, name, by_name):
        """row_constructor(...) (velox RowConstructor): scalar fields from
        the shared evaluation's "name#fi" lanes, complex fields passed by
        reference; the row itself is never NULL."""
        kids = []
        for i, (ct, a) in enumerate(zip(rt.children, e.args)):
            if ct.kind in _COMPLEX_KINDS:
                if not isinstance(a, FieldRef):
                    raise TypeError("row_constructor: complex fields must "
                                    "be column references")
                kids.append(_extract_row_path(batch, a.name))
            else:
                (vals, valid), d = by_name[f"{name}#f{i}"]
                kids.append(Column(ct, vals, valid, d))
        return RowColumn(rt, tuple(kids), None)

    def _apply_map_entries(self, batch, e, out_t):
        """map_entries(m) -> ARRAY(ROW(key, value)) sharing the map's
        offsets and lanes (MapEntries.cpp)."""
        src = batch.column(e.args[0].name)
        return ArrayColumn(out_t, src.starts, src.lengths, RowColumn(
            out_t.element, (src.keys, src.values), None), src.valid)

    def _apply_zip(self, batch, e, out_t):
        """zip(a, b, ...) -> ARRAY(ROW(...)) (Zip.cpp:32-41): as long as
        the longest input, shorter inputs give NULL fields."""
        srcs = [batch.column(a.name) for a in e.args]
        nv = null_rows(srcs)
        live = and_valid(batch.sel, nv)
        zero = torch.zeros((), dtype=torch.int64, device=batch.device)
        lens_in = [torch.where(live, c.lengths.to(torch.int64), zero)
                   for c in srcs]
        lens = lens_in[0]
        for ln in lens_in[1:]:
            lens = torch.maximum(lens, ln)
        ex = expand(torch.zeros_like(lens), lens, live)
        kids = []
        for c, li, ct in zip(srcs, lens_in, out_t.element.children):
            v, vd = gather_elem(c.elements,
                                take(c.starts, ex.row_of) + ex.ordinal)
            kids.append(Column(ct, v, and_valid(
                ex.ordinal < take(li, ex.row_of), vd),
                c.elements.dictionary))
        return ArrayColumn(out_t, ex.nst, lens,
                           RowColumn(out_t.element, tuple(kids), None), nv)

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
    * generic: per batch, a sort-based batch-local grouping
      (``group_ids_sorted``) and partial accumulators with one slot per
      row of the batch's capacity (one slot when keyless; one per group,
      at one host sync, when an aggregate has a matrix lane); at output
      the partials of every batch are concatenated, grouped again and
      combined. Groups come out in key order (NULLS LAST). A node with a
      ``count(distinct x)`` always takes this mode.

    Steps (velox AggregationNode::Step): SINGLE; PARTIAL emits the keys
    and each aggregate's lanes as columns ``name$lane`` (a matrix lane as
    ``name$lane@slot``), per batch in the generic mode and once, for all
    G groups, when a kArray input ends (the reference emits nothing
    there); FINAL reads lane columns and combines them (masks applied to
    raw input only, so FINAL drops them). A generic PARTIAL that does not
    reduce is abandoned (``_maybe_abandon``): every later row goes out
    as its own group.

    A SINGLE step with a collect aggregate (``approx_percentile``,
    ``tdigest_agg``, ``approx_set``, ``array_agg``, ``map_agg``, ...)
    takes the collect mode instead: it buffers its input batches and runs
    ``exec/collect_agg.finish_collect`` once over their concatenation. In
    PARTIAL and FINAL steps ``approx_percentile`` runs its digest lanes,
    and a node whose aggregates are all ``array_agg``/``set_agg``/
    ``map_agg`` takes the page form: PARTIAL collects each group's ARRAY
    or MAP page as ``name$0``, and FINAL (one such aggregate) expands the
    pages back into element rows and collects again. The other collect
    aggregates raise there, as the reference's do.

    The generic mode's partials go into a ``PartitionedEntryStore``
    (``exec/spill.py``): under a memory budget they move to host RAM
    split by a hash of the keys, and the output merges one partition a
    call.
    """

    blocking = True

    def __init__(self, node: AggregationNode):
        super().__init__(node)
        self.step = node.step
        self.keys = list(node.keys)
        self.specs = list(node.aggregates)
        if self.step == AggStep.FINAL:
            # masks apply to raw input only (velox addRawInput against
            # addIntermediateResults): the PARTIAL step consumed them
            self.specs = [dataclasses.replace(s, mask=None)
                          for s in self.specs]
        self.agg_names = list(node.agg_names)
        self.fns = [lookup_aggregate(s.fn) for s in self.specs]
        self.has_distinct = any(s.distinct for s in self.specs)
        if self.has_distinct and self.step != AggStep.SINGLE:
            raise NotImplementedError(
                "distinct aggregates only in single-step aggregation")
        if self.step != AggStep.SINGLE and any(
                lane.width > 256 for fn in self.fns for lane in fn.lanes):
            raise NotImplementedError(
                "very wide matrix lanes (approx_distinct HLL registers) "
                "are single-step only")
        if any(s.distinct and isinstance(s.arg, tuple) for s in self.specs):
            raise NotImplementedError(
                "DISTINCT over multi-argument aggregates")
        self._collect = self._collect_specs()
        #: a FINAL step of the page form: its input is the page column
        #: ``name$0``, expanded into element rows ``name@e`` (a map's
        #: ``name@k``/``name@v``)
        self._collect_final = bool(self._collect) and \
            self.step == AggStep.FINAL
        #: a PARTIAL step of the page form names its page ``name$0``
        self._collect_suffix = ("$0" if self._collect
                                and self.step == AggStep.PARTIAL else "")
        in_schema = node.source.output_type
        self.arg_types: list = []
        #: FINAL: each aggregate's lane columns, one list per lane
        self.lane_names: List[List[List[str]]] = []
        for si, (s, name, fn) in enumerate(zip(self.specs, self.agg_names,
                                               self.fns)):
            if self._collect_final:
                page_t = in_schema.find_child(f"{name}$0")
                if fn.collect_kind == "map":
                    arg = (f"{name}@k", f"{name}@v")
                    self.arg_types.append((page_t.key, page_t.value))
                else:
                    arg = f"{name}@e"
                    self.arg_types.append(page_t.element)
                self.specs[si] = dataclasses.replace(s, arg=arg)
                self.lane_names.append([])
                continue
            if self.step == AggStep.FINAL:
                groups = [[f"{name}${i}"] if lane.width == 1
                          else [f"{name}${i}@{j}" for j in range(lane.width)]
                          for i, lane in enumerate(fn.lanes)]
                self.arg_types.append(fn.resolve_input_type(tuple(
                    in_schema.find_child(g[0]) for g in groups)))
                self.lane_names.append(groups)
                continue
            fields = self._arg_fields(s)
            types = [in_schema.find_child(a) for a in fields]
            self.arg_types.append(None if not types else types[0]
                                  if not isinstance(s.arg, tuple)
                                  else tuple(types))
            self.lane_names.append([])
            if self.step == AggStep.PARTIAL and any(
                    lt.is_string for lt in fn.lane_types(
                        self.arg_types[-1])):
                raise NotImplementedError(
                    "two-step aggregation of VARCHAR values: lane "
                    "columns carry no dictionary")
        self._needed = list(dict.fromkeys(
            self.keys + [a for s in self.specs for a in self._arg_fields(s)]
            + [s.mask for s in self.specs if s.mask is not None]
            + [c for groups in self.lane_names for g in groups for c in g]))
        #: generic partials to merge: on the device, or spilled to host
        #: RAM split by key hash and merged one part a call
        self._store = PartitionedEntryStore(f"agg:{node.id}")
        self._pending_parts: Optional[List[list]] = None
        self._raw_batches: List[Batch] = []  # collect mode's input
        self._outputs: collections.deque = collections.deque()  # PARTIAL
        self._array_state: Optional[dict] = None
        self._mode: Optional[str] = None
        #: the dictionary of each string key and string aggregate value:
        #: output keys decode through it, and min/max (min_by's payload)
        #: of a string are codes into it (sorted, so codes are ranks)
        self._key_dicts: Dict[str, Dictionary] = {}
        self._dict_cols = list(dict.fromkeys(self.keys + [
            self._arg_fields(s)[0] for s, t in zip(self.specs, self.arg_types)
            if self.step != AggStep.FINAL and t is not None
            and (t[0] if isinstance(t, tuple) else t).is_string]))
        self._emitted = False
        self._device: Optional[torch.device] = None
        #: whether some aggregate keeps a (groups, width) matrix lane
        self._matrix = any(lane.width > 1 for fn in self.fns
                           for lane in fn.lanes)
        #: adaptive partial aggregation (velox
        #: abandonPartialAggregationEarly)
        self.abandoned = False
        self._abandon_checked = False
        self._rows_seen_cap = 0
        #: runtime statistics (``abandoned_partial_agg``)
        self.runtime: Dict[str, float] = {}

    # ----------------------------------------------------------- helpers
    def _collect_specs(self) -> List[int]:
        """The aggregates that run in collect mode (``exec/collect_agg.py``):
        in a SINGLE step every one with a collect kind. In PARTIAL and FINAL
        steps a collect aggregate with lanes (``approx_percentile``'s
        digest) runs the lane machinery, ``array_agg``/``set_agg``/
        ``map_agg`` alone take the page form, and the others raise as the
        reference's do."""
        if self.step != AggStep.SINGLE:
            pure = [f for f in self.fns
                    if f.collect_kind is not None and not f.lanes]
            if not pure:
                return []
            if len(pure) != len(self.fns) or any(
                    f.collect_kind not in ("array", "set", "map")
                    for f in pure):
                raise NotImplementedError(
                    "partial/final collect planning supports nodes whose "
                    "aggregates are ALL array_agg/set_agg/map_agg; other "
                    "collect aggregates (map_union, histogram, ...) are "
                    "single-step")
            if self.step == AggStep.FINAL and len(self.fns) > 1:
                raise NotImplementedError(
                    "FINAL collect expansion supports one collect "
                    "aggregate per node (element capacities differ per "
                    "aggregate)")
            collect = list(range(len(self.fns)))
        else:
            collect = [i for i, f in enumerate(self.fns)
                       if f.collect_kind is not None]
        if any(self.specs[i].distinct for i in collect):
            raise NotImplementedError("DISTINCT over collect aggregates")
        return collect

    def _arg_fields(self, spec) -> List[str]:
        """The input columns an aggregate reads (none in a FINAL step,
        which reads lane columns)."""
        if spec.arg is None or (self.step == AggStep.FINAL
                                and not self._collect_final):
            return []
        return list(spec.arg) if isinstance(spec.arg, tuple) else [spec.arg]

    def _agg_inputs(self, cols, sel):
        """Per aggregate (values, mask) for accumulate, or (lanes, mask)
        for a FINAL step's combine. A multi-argument aggregate's values
        are a tuple of (values, valid) pairs, and its NULLs are its own
        business."""
        out = []
        for spec, lanes in zip(self.specs, self.lane_names):
            mask = sel
            if spec.mask is not None:
                mvals, mvalid = cols[spec.mask]
                mask = torch.logical_and(mask, mvals)
                if mvalid is not None:
                    mask = torch.logical_and(mask, mvalid)
            if self.step == AggStep.FINAL:
                out.append((_lane_arrays(cols, lanes), mask))
            elif spec.arg is None:
                out.append((None, mask))
            elif isinstance(spec.arg, tuple):
                out.append((tuple(cols[a] for a in spec.arg), mask))
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
        if self._collect:
            # collect aggregates buffer raw rows; one global grouping at
            # finish (exec/collect_agg.py)
            self._mode = "collect"
            return self._mode
        if self.keys and not self.has_distinct:
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
        self._mode = "generic"
        return self._mode

    # ------------------------------------------------------------- input
    def add_input(self, batch: Batch) -> None:
        self.decide_mode_dicts({
            k: batch.column(k).dictionary for k in self.keys})
        self.note_key_dicts(batch)
        if self._mode == "collect":
            self._device = batch.device
            if self._collect_final:
                batch = self._expand_collect_pages(batch)
            self._raw_batches.append(batch.project(self._needed))
            return
        self.add_columns(_cols_of(batch, self._needed), batch.sel)

    def add_columns(self, cols, sel) -> None:
        """One batch's columns (``(values, valid)`` by name) once the mode
        is decided: the per-batch step of either mode and step."""
        self._device = sel.device
        if self._mode == "array":
            st = self.ensure_array_state(sel.device)
            st["accs"], st["seen"] = self.make_array_fn()(
                cols, sel, st["accs"], st["seen"])
        elif self.step == AggStep.FINAL:
            # buffer the partial groups as they are; merge at output
            self.push_generic_entry(
                [cols[k] for k in self.keys],
                [_lane_arrays(cols, lanes) for lanes in self.lane_names],
                sel, [None] * len(self.specs))
        elif self.abandoned:
            self._add_passthrough(cols, sel)
        else:
            gkeys, lanes, group_sel, dreps = self.make_generic_fn()(cols, sel)
            self.push_generic_entry(gkeys, lanes, group_sel, dreps)
            self._maybe_abandon(sel, group_sel)

    def _expand_collect_pages(self, batch: Batch) -> Batch:
        """A FINAL step of the page form: the page column's elements as
        rows, each with its owning row's keys, so that the SINGLE step's
        collect runs unchanged (velox addIntermediateResults)."""
        from velox_tpu_torch.exec.collect_agg import element_owners

        name = self.agg_names[0]
        page = batch.column(f"{name}$0")
        flat = page.keys if isinstance(page, MapColumn) else page.elements
        owner, within = element_owners(page.starts, page.lengths,
                                       flat.capacity)
        sel = within & take(batch.sel, owner)
        cols = {k: batch.column(k).gather(owner) for k in self.keys}
        if isinstance(page, MapColumn):
            cols[f"{name}@k"] = page.keys
            cols[f"{name}@v"] = page.values
        else:
            cols[f"{name}@e"] = page.elements
        return Batch(cols, sel)

    def note_key_dicts(self, batch_or_dicts) -> None:
        """Remember the first dictionary seen for each string key and
        string aggregate argument."""
        if isinstance(batch_or_dicts, Batch):
            batch_or_dicts = {k: batch_or_dicts.column(k).dictionary
                              for k in self._dict_cols}
        for k in self._dict_cols:
            d = batch_or_dicts.get(k)
            if d is not None:
                self._key_dicts.setdefault(k, d)

    def _agg_column(self, name: str, vals, valid) -> Column:
        """An aggregate's output column; a string result (min/max of a
        string, min_by's string payload) keeps its value's dictionary."""
        t = self.output_type.find_child(name)
        if not t.is_string:
            return Column(t, vals, valid)
        spec = self.specs[self.agg_names.index(name)]
        arg = (self._arg_fields(spec) or [None])[0]
        # a group with no value holds the identity: code -1 decodes it
        vals = torch.where(valid, vals, torch.full_like(vals, -1))
        return Column(t, vals, valid, _key_dict_for(self._key_dicts, t, arg))

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
        """Per-batch kArray step: (cols, sel, accs, seen) -> (accs, seen);
        a FINAL step combines lanes and never takes B2."""
        radices = self._radices
        keys = self.keys
        G = self._num_groups
        is_final = self.step == AggStep.FINAL

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

            if not is_final:
                multi = self._try_multi_sum(gids, sel, inputs, accs_in,
                                            seen, G)
                if multi is not None:
                    return multi

            seen_ext = torch.cat([seen, seen.new_zeros(1)])
            seen_ext.index_fill_(0, gids.long(), True)
            seen = seen_ext[:G]
            accs_out = [(f.combine if is_final else f.accumulate)(
                            accs, gids, vals, mask)
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
            # count_if's argument is a bool, so it never gets past the
            # check below, in the reference too
            if spec.fn not in ("sum", "count", "count_if", "avg"):
                return None
            if vals is not None and (vals.dtype.is_floating_point
                                     or vals.dtype == torch.bool):
                return None
        from velox_tpu_torch.ops.grouped_sum import grouped_multi_sum_i32

        zero32 = torch.zeros((), dtype=torch.int32, device=sel.device)
        contribs = []
        layout = []  # (agg index, lane index, left shift) per row
        for ai, (spec, (vals, mask)) in enumerate(zip(self.specs, inputs)):
            if vals is not None and spec.fn != "count":
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
            else:  # count(*) and count(x): a single count lane
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
        """Per-batch generic step: (cols, sel) -> (group keys, partial
        lanes, group selection, distinct representatives). Keyless: one
        slot and no sort; keyed: ``group_ids_sorted`` and one slot per
        row of the batch's capacity, or, when an aggregate keeps a matrix
        lane (``capacity x width`` would be gigabytes), one per group,
        which costs a host sync. A distinct aggregate accumulates nothing
        here: its batch's distinct (keys, arg) rows are kept for the
        merge (velox/exec/DistinctAggregations.h)."""
        keys = self.keys

        def take_pairs(pairs, rows):
            return [(v.index_select(0, rows),
                     None if va is None else va.index_select(0, rows))
                    for v, va in pairs]

        def fn(cols, sel):
            inputs = self._agg_inputs(cols, sel)
            pairs = [cols[k] for k in keys]
            if not keys:
                gids = torch.where(sel, torch.zeros((), dtype=torch.int32,
                                                    device=sel.device),
                                   torch.ones((), dtype=torch.int32,
                                              device=sel.device))
                group_sel = torch.any(sel)[None]
                acc_cap = 1
            else:
                gids, group_rows, group_sel, ng = group_ids_sorted(pairs, sel)
                acc_cap = sel.shape[0]
                if self._matrix:
                    acc_cap = max(syncs.to_int(ng), 1)
                    group_rows = group_rows[:acc_cap]
                    group_sel = group_sel[:acc_cap]
            lanes_out = [None if spec.distinct
                         else f.accumulate(accs, gids, vals, mask)
                         for f, spec, accs, (vals, mask) in zip(
                             self.fns, self.specs,
                             self._init_accs(acc_cap, sel.device), inputs)]
            dreps = []
            for spec, (vals, mask) in zip(self.specs, inputs):
                if not spec.distinct:
                    dreps.append(None)
                    continue
                _, drows, dsel, _ = group_ids_sorted(
                    pairs + [(vals, None)], mask)
                dreps.append({"keys": take_pairs(pairs, drows),
                              "arg": vals.index_select(0, drows),
                              "sel": dsel})
            gkeys = take_pairs(pairs, group_rows) if keys else []
            return gkeys, lanes_out, group_sel, dreps

        return fn

    def push_generic_entry(self, gkeys, lanes_out, group_sel, dreps) -> None:
        entry = {"keys": gkeys, "lanes": lanes_out, "sel": group_sel,
                 "distinct": dreps}
        if self.step == AggStep.PARTIAL:
            self._outputs.append(self._partial_batch(entry))
        else:
            self._store.append(entry)

    # ---------------------------------------- adaptive partial aggregation
    def _maybe_abandon(self, sel, group_sel) -> None:
        """velox abandonPartialAggregationEarly: once the PARTIAL step has
        seen ``abandon_partial_agg_min_rows`` rows (batch capacities),
        ONE host sync reads this batch's rows and groups; at a ratio of
        at least ``abandon_partial_agg_min_pct`` the step stops grouping
        and forwards every row as its own group for the FINAL step."""
        from velox_tpu_torch.utils.config import config

        if (self.step != AggStep.PARTIAL or self.abandoned
                or self._abandon_checked or not self.keys):
            return
        self._rows_seen_cap += sel.shape[0]
        if self._rows_seen_cap < config.abandon_partial_agg_min_rows:
            return
        self._abandon_checked = True
        TestValue.adjust("velox_tpu.agg.abandon_check", self)
        rows, groups = syncs.to_numpy(torch.stack(
            [sel.sum(), group_sel.sum()])).tolist()
        if rows > 0 and groups / rows >= config.abandon_partial_agg_min_pct:
            self.abandoned = True
            self.runtime["abandoned_partial_agg"] = 1.0

    def _add_passthrough(self, cols, sel) -> None:
        """An abandoned PARTIAL step: row i is group i (no sort), its
        lanes one row's accumulation."""
        gids = torch.arange(sel.shape[0], device=sel.device)
        lanes = [f.accumulate(accs, gids, vals, mask)
                 for f, accs, (vals, mask) in zip(
                     self.fns, self._init_accs(sel.shape[0], sel.device),
                     self._agg_inputs(cols, sel))]
        self.push_generic_entry([cols[k] for k in self.keys], lanes, sel,
                                [None] * len(self.specs))

    # ------------------------------------------------------------ output
    def _partial_batch(self, entry) -> Batch:
        """A PARTIAL step's output: the group keys and every lane."""
        cols = {}
        for k, (v, va) in zip(self.keys, entry["keys"]):
            kt = self.output_type.find_child(k)
            cols[k] = Column(kt, v, va, _key_dict_for(self._key_dicts, kt, k))
        for name, fn, at, lanes in zip(self.agg_names, self.fns,
                                       self.arg_types, entry["lanes"]):
            for li, (lane, lt) in enumerate(zip(lanes, fn.lane_types(at))):
                if lane.ndim == 1:
                    cols[f"{name}${li}"] = Column(lt, lane)
                else:
                    for j in range(lane.shape[1]):
                        cols[f"{name}${li}@{j}"] = Column(lt, lane[:, j])
        return Batch(cols, entry["sel"])

    def get_output(self) -> Optional[Batch]:
        if self._outputs:
            return self._outputs.popleft()
        if not self.no_more_input_seen or self._emitted:
            return None
        if self._collect or self._mode == "array" \
                or self.step == AggStep.PARTIAL:
            self._emitted = True
            if self._collect:
                return self._finish_collect()
            if self._mode == "array":
                return self._finish_array()
            return None    # every batch's partials went out with it
        # generic: one part a call (spilled parts come back one at a time,
        # the last first, as the reference's)
        if self._pending_parts is None:
            self._pending_parts = [p for p in self._store.partitions() if p]
            if not self._pending_parts:
                self._emitted = True
                return self._empty_result()
        part = self._pending_parts.pop()
        if not self._pending_parts:
            self._emitted = True
        return self._merge_entries([self._store.to_device(e) for e in part])

    def _finish_collect(self) -> Batch:
        """Collect mode: every buffered batch concatenated, then one
        global grouping (``exec/collect_agg.finish_collect``). With no
        input at all, an empty batch stands in (keyless: one row)."""
        from velox_tpu_torch.exec.collect_agg import finish_collect

        batches, self._raw_batches = self._raw_batches, []
        if not batches:
            src = self.node.source.output_type
            types = {n: src.find_child(n) for n in self._needed
                     if n in src.names}
            for spec, at in zip(self.specs, self.arg_types):
                if self._collect_final:
                    args = spec.arg if isinstance(spec.arg, tuple) \
                        else (spec.arg,)
                    ats = at if isinstance(at, tuple) else (at,)
                    types.update(zip(args, ats))
            batches = [Batch.empty_like(
                row_type(self._needed, [types[n] for n in self._needed]),
                round_capacity(1), self._device or plan_device(self.node))]
        return finish_collect(self, concat_batches(batches))

    def _finish_array(self) -> Batch:
        """kArray output: every group slot, live where a row was seen;
        the extracted results, or a PARTIAL step's lanes."""
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
            return torch.cat([a, torch.full((pad,) + a.shape[1:], fill,
                                            dtype=a.dtype, device=device)])

        seen = padded(st["seen"], False)
        gkeys = []
        stride = 1
        gid_idx = np.arange(G)
        for radix in self._radices:
            codes = ((gid_idx // stride) % radix).astype(np.int32)
            valid_np = codes != radix - 1
            codes = np.where(valid_np, codes, -1).astype(np.int32)
            stride *= radix
            gkeys.append((padded(torch.from_numpy(codes).to(device), -1),
                          padded(torch.from_numpy(valid_np).to(device),
                                 False)))
        accs = [tuple(padded(a) for a in lanes) for lanes in st["accs"]]
        if self.step == AggStep.PARTIAL:
            return self._partial_batch({"keys": gkeys, "lanes": accs,
                                        "sel": seen})
        cols = {}
        for k, (v, va) in zip(self.keys, gkeys):
            kt = self.output_type.find_child(k)
            cols[k] = Column(kt, v, va, _key_dict_for(self._key_dicts, kt, k))
        for name, fn, lanes in zip(self.agg_names, self.fns, accs):
            vals, valid = fn.extract(lanes, seen)
            cols[name] = self._agg_column(name, vals, valid)
        return Batch(cols, seen)

    def _merge_entries(self, entries: List[dict]) -> Batch:
        """Combine every batch's partials: concatenate them (padded to a
        power of two), group the concatenated keys again and combine the
        lanes by the new group ids. Each distinct aggregate's
        representatives follow the partials as a region of their own;
        they are deduplicated again by (group, arg) and accumulated.
        Keyless: the single output row (slot 0), emitted even on empty
        input."""
        n_reg = sum(e["sel"].shape[0] for e in entries)
        d_specs = [i for i, s in enumerate(self.specs) if s.distinct]
        key_regions = [e["keys"] for e in entries]
        sel_regions = [e["sel"] for e in entries]
        d_bounds = {}
        off = n_reg
        for i in d_specs:
            for e in entries:
                key_regions.append(e["distinct"][i]["keys"])
                sel_regions.append(e["distinct"][i]["sel"])
            size = sum(e["distinct"][i]["sel"].shape[0] for e in entries)
            d_bounds[i] = (off, off + size)
            off += size
        total = off
        cap = round_capacity(total)
        pad = cap - total
        device = entries[0]["sel"].device

        def cat(parts, fill=0):
            if pad:
                parts = parts + [torch.full((pad,), fill,
                                            dtype=parts[0].dtype,
                                            device=device)]
            return torch.cat(parts)

        def region(parts, lo, hi):
            """``parts`` placed at [lo, hi) of a cap-long lane."""
            trail = parts[0].shape[1:]
            return torch.cat([parts[0].new_zeros((lo,) + trail)] + list(parts)
                             + [parts[0].new_zeros((cap - hi,) + trail)])

        keys = []
        for ki in range(len(self.keys)):
            parts = [r[ki] for r in key_regions]
            vals = cat([v for v, _ in parts])
            valid = None
            if any(va is not None for _, va in parts):
                valid = cat([va if va is not None
                             else torch.ones_like(v, dtype=torch.bool)
                             for v, va in parts], False)
            keys.append((vals, valid))
        sel = cat(sel_regions, False)
        gids, group_rows, group_sel, _ = group_ids_sorted(keys, sel)
        if not self.keys:
            group_sel = torch.zeros((cap,), dtype=torch.bool, device=device)
            group_sel[0] = True
        cols = {}
        for k, (v, va) in zip(self.keys, keys):
            kt = self.output_type.find_child(k)
            cols[k] = Column(
                kt, v.index_select(0, group_rows),
                None if va is None else va.index_select(0, group_rows),
                _key_dict_for(self._key_dicts, kt, k))
        idx = torch.arange(cap, device=device)
        for ai, (name, fn, accs) in enumerate(zip(
                self.agg_names, self.fns, self._init_accs(cap, device))):
            if ai in d_bounds:
                lo, hi = d_bounds[ai]
                argv = region([e["distinct"][ai]["arg"] for e in entries],
                              lo, hi)
                rsel = sel & (idx >= lo) & (idx < hi)
                _, drows, dsel, _ = group_ids_sorted(
                    [(gids, None), (argv, None)], rsel)
                rep = torch.zeros(cap + 1, dtype=torch.bool, device=device)
                rep[torch.where(dsel, drows, torch.full_like(drows, cap))] \
                    = True
                accs = fn.accumulate(tuple(accs), gids, argv, rep[:cap])
            else:
                lanes = tuple(region([e["lanes"][ai][li] for e in entries],
                                     0, n_reg)
                              for li in range(len(fn.lanes)))
                accs = fn.combine(tuple(accs), gids, lanes,
                                  sel & (idx < n_reg))
            vals, valid = fn.extract(accs, group_sel)
            cols[name] = self._agg_column(name, vals, valid)
        return Batch(cols, group_sel)

    def _empty_result(self) -> Batch:
        cap = round_capacity(1)
        device = self._device or plan_device(self.node)
        if self.keys:
            return Batch.empty_like(self.output_type, cap, device)
        sel = torch.zeros((cap,), dtype=torch.bool, device=device)
        sel[0] = True
        cols = {}
        for name, fn, accs in zip(self.agg_names, self.fns,
                                  self._init_accs(cap, device)):
            vals, valid = fn.extract(accs, sel)
            cols[name] = self._agg_column(name, vals, valid)
        return Batch(cols, sel)

    def is_finished(self) -> bool:
        return (self.no_more_input_seen and self._emitted
                and not self._outputs)


def _lane_arrays(cols, lane_groups) -> tuple:
    """A FINAL step's lanes read back from their columns: one column a
    lane, a matrix lane's ``name$lane@slot`` columns stacked to
    (rows, width)."""
    return tuple(cols[g[0]][0] if len(g) == 1
                 else torch.stack([cols[n][0] for n in g], dim=1)
                 for g in lane_groups)


# ------------------------------------------------------ streaming agg

def _keys_eq(a: Tuple, b: Tuple) -> torch.Tensor:
    """SQL grouping equality of two (values, valid) pairs: equal values
    where both are valid, or both null."""
    (av, avd), (bv, bvd) = a, b
    if avd is None and bvd is None:
        return av == bv
    an = torch.zeros_like(av, dtype=torch.bool) if avd is None else ~avd
    bn = torch.zeros_like(bv, dtype=torch.bool) if bvd is None else ~bvd
    return ((av == bv) & ~an & ~bn) | (an & bn)


class StreamingAggregationOp(HashAggregationOp):
    """velox/exec/StreamingAggregation.h: aggregation over input CLUSTERED
    on the grouping keys, so a group closes as soon as the key changes and
    only the open group is kept between batches.

    Per batch: pack the active rows (one host sync), mark the rows whose
    keys differ from the previous row, find the group heads (one host
    sync), reduce every lane over its group with a segmented scan
    (``ops/groupby.segment_scan``: exact for integers, no prefix
    subtraction for floats) and read each group's total at its last row.
    An aggregate without scan lanes (``bool_and``, ``arbitrary``, the
    moments, ...) scatters into one slot a group instead, as the
    reference's non-scan step does. The carried open group merges into
    the batch's first group when the keys match, else it is emitted on
    its own, first. Every group but the
    batch's last is emitted; the last becomes the new carry, flushed after
    the input ends. The reference splits this into two programs sized by
    a synced count (to give XLA static shapes); eager torch learns the
    count directly, so one step gives the same rows in the same order.

    ``having`` (a HAVING predicate the optimizer folds in) is evaluated on
    the emitted groups, and each batch's output is compacted to the
    groups that pass (one more host sync).
    """

    blocking = False

    def __init__(self, node):
        super().__init__(node)
        if self.step not in (AggStep.SINGLE, AggStep.FINAL):
            raise NotImplementedError(
                "streaming aggregation emits final results (SINGLE/FINAL)")
        if not self.keys:
            raise ValueError("keyless aggregation has no streams to close")
        if self.has_distinct:
            raise NotImplementedError(
                "distinct aggregates stream nowhere: aggregate them")
        if self._collect:
            raise NotImplementedError(
                "collect aggregates need the hash aggregation")
        #: (key pairs of 1-element tensors, lanes per aggregate) or None
        self._carry: Optional[Tuple[list, list]] = None
        having = getattr(node, "having", None)
        self._having_eval = (ExprEvaluator([having], node.output_type)
                             if having is not None else None)
        self._queue: collections.deque = collections.deque()

    def _emit(self, cols: Dict[str, Column], sel: torch.Tensor) -> Batch:
        b = Batch(cols, sel)
        if self._having_eval is not None:
            b = b.with_sel(self._having_eval.filter_sel(b)).compact()
        return b

    def add_input(self, batch: Batch) -> None:
        self._device = batch.device
        self.note_key_dicts(batch)
        cols = _cols_of(batch, self._needed)
        rows = syncs.nonzero(batch.sel)
        n = rows.shape[0]
        if n == 0:
            return   # an empty batch neither extends nor closes a group

        def pack(pair):
            v, va = pair
            return (v.index_select(0, rows),
                    None if va is None else va.index_select(0, rows))

        kp = [pack(cols[k]) for k in self.keys]
        pcols = {name: pack(p) for name, p in cols.items()}
        device = batch.device

        # a head row differs from its predecessor in some key
        head = torch.ones(n, dtype=torch.bool, device=device)
        same_prev = torch.ones(n, dtype=torch.bool, device=device)
        for v, va in kp:
            same_prev[1:] &= _keys_eq(
                (v[1:], None if va is None else va[1:]),
                (v[:-1], None if va is None else va[:-1]))
        head[1:] = ~same_prev[1:]
        starts = syncs.nonzero(head)
        ng = starts.shape[0]
        last_rows = torch.cat([starts[1:] - 1,
                               torch.full((1,), n - 1, device=device,
                                          dtype=torch.int64)])

        carry = self._carry
        if carry is not None:
            ck, cl = carry
            merge = torch.ones((), dtype=torch.bool, device=device)
            for (v, va), (cv, cva) in zip(kp, ck):
                merge = merge & _keys_eq(
                    (v[:1], None if va is None else va[:1]), (cv, cva))[0]
        # group totals: each lane's segmented scan at the group's last row
        inputs = self._agg_inputs(pcols, torch.ones(
            n, dtype=torch.bool, device=device))
        is_final = self.step == AggStep.FINAL
        gids = None
        totals = []
        for ai, (fn, at, (vals, mask)) in enumerate(zip(
                self.fns, self.arg_types, inputs)):
            scan = (all(lane.scan_op for lane in fn.lanes) if is_final
                    else fn.scannable)
            if not scan:
                # no scan lanes: scatter into one slot a group, then
                # combine the carried group into slot 0
                if gids is None:
                    gids = torch.cumsum(head, 0) - 1
                accs = (fn.combine if is_final else fn.accumulate)(
                    tuple(init_lane(lane, at, ng, device)
                          for lane in fn.lanes), gids, vals, mask)
                if carry is not None:
                    accs = fn.combine(accs, gids[:1], carry[1][ai],
                                      merge[None])
                totals.append(list(accs))
                continue
            # a FINAL step's lanes are their own contributions
            contribs = (tuple(_masked(lv.to(torch_dtype(lane.dtype_of(at))),
                                      mask, lane.init_of(at))
                              for lane, lv in zip(fn.lanes, vals))
                        if is_final else fn.lane_contribs(vals, mask, at))
            lanes = []
            for li, (lane, c) in enumerate(zip(fn.lanes, contribs)):
                t = segment_scan(c, head, lane.scan_op).index_select(
                    0, last_rows)
                if carry is not None:
                    # the carried group continues into group 0, under the
                    # lane's own combine
                    prev = cl[ai][li].to(t.dtype)
                    t0 = torch.where(
                        merge, SCAN_COMBINE[lane.scan_op](t[:1], prev), t[:1])
                    t = torch.cat([t0, t[1:]])
                lanes.append(t)
            totals.append(lanes)

        # the reference's output slots: the carry, when it did not merge
        # into group 0 (``alone``), then the batch's closed groups
        # 0 .. ng-2 (the noisy aggregates draw by slot)
        cap = round_capacity(ng)
        pad = cap - ng
        alone = None if carry is None else ~merge

        def place(first, body):
            """``[first, body, 0...]`` if alone else ``[body, 0...]``,
            ``cap`` rows."""
            trail = body.shape[1:]
            shifted = torch.cat([body, body.new_zeros((pad + 1,) + trail)])
            if alone is None:
                return shifted
            return torch.where(alone, torch.cat(
                [first.to(body.dtype), body,
                 body.new_zeros((pad,) + trail)]), shifted)

        r = torch.arange(cap, device=device)
        gsel = (r < ng - 1 if alone is None
                else r < ng - 1 + alone.to(torch.int64))
        key_rows = starts[:ng - 1]
        out: Dict[str, Column] = {}
        for k, (v, va), ci in zip(self.keys, kp, range(len(self.keys))):
            kt = self.output_type.find_child(k)
            ck = carry[0][ci] if carry is not None else (v[:1], None)
            kv = place(ck[0], v.index_select(0, key_rows))
            kva = None
            if va is not None or ck[1] is not None:
                kva = place(
                    ck[1] if ck[1] is not None
                    else torch.ones(1, dtype=torch.bool, device=device),
                    va.index_select(0, key_rows) if va is not None
                    else torch.ones(ng - 1, dtype=torch.bool, device=device))
            out[k] = Column(kt, kv, kva,
                            _key_dict_for(self._key_dicts, kt, k))
        for ai, (name, fn, at) in enumerate(zip(
                self.agg_names, self.fns, self.arg_types)):
            accs = [place(carry[1][ai][li] if carry is not None else t[:1],
                          t[:ng - 1]) for li, t in enumerate(totals[ai])]
            vals, valid = fn.extract(tuple(accs), gsel)
            out[name] = self._agg_column(name, vals, valid)
        emitted = self._emit(out, gsel)
        self._queue.append(emitted)

        # the batch's last group is the new carry
        self._carry = (
            [(v[n - 1:n], None if va is None else va[n - 1:n])
             for v, va in kp],
            [[t[ng - 1:ng] for t in lanes] for lanes in totals])

    def get_output(self) -> Optional[Batch]:
        if self._queue:
            return self._queue.popleft()
        if not self.no_more_input_seen or self._emitted:
            return None
        self._emitted = True
        if self._carry is None:
            return None
        # flush the open group as one final row
        ck, cl = self._carry
        cap = round_capacity(1)
        device = ck[0][0].device
        sel0 = torch.zeros(cap, dtype=torch.bool, device=device)
        sel0[0] = True
        cols: Dict[str, Column] = {}
        for k, (cv, cva) in zip(self.keys, ck):
            kt = self.output_type.find_child(k)
            cols[k] = Column(
                kt, torch.cat([cv, cv.new_zeros(cap - 1)]),
                None if cva is None else torch.cat(
                    [cva, cva.new_zeros(cap - 1)]),
                _key_dict_for(self._key_dicts, kt, k))
        for name, fn, lanes in zip(self.agg_names, self.fns, cl):
            full = tuple(torch.cat([lv, lv.new_zeros((cap - 1,)
                                                     + lv.shape[1:])])
                         for lv in lanes)
            vals, valid = fn.extract(full, sel0)
            cols[name] = self._agg_column(name, vals, valid)
        return self._emit(cols, sel0)

    def is_finished(self) -> bool:
        return (self.no_more_input_seen and not self._queue
                and self._emitted)


# ------------------------------------------------------------------ order

class OrderByOp(Operator):
    """velox/exec/OrderBy.h: buffer everything, one stable sort at the
    end."""

    blocking = True

    def __init__(self, node):
        super().__init__(node)
        self._buffer = SpillableBuffer("orderby")
        self._out = None
        self._emitted = False

    def add_input(self, batch: Batch) -> None:
        self._buffer.append(batch)

    def get_output(self) -> Optional[Batch]:
        k = self.node.keys[0]
        return next_blocking_output(self, lambda: blocking_output(
            self._buffer, (k.name, k.descending, k.nulls_first),
            self._sort, arrival_order=False))

    def _sort(self, big: Batch) -> Batch:
        perm = sort_indices(_sort_keys(big, self.node.keys), big.sel)
        return big.gather(perm, big.sel.index_select(0, perm), big.num_rows)

    def is_finished(self) -> bool:
        return self.no_more_input_seen and self._emitted


def blocking_output(buffer: SpillableBuffer, key, compute,
                    arrival_order: bool):
    """The batches a blocking operator emits from its buffer: unspilled,
    ``compute`` of every batch at once; spilled, ``compute`` of one key
    range of ``key`` at a time (``RangeRestore``), each range's result
    in key order or, with ``arrival_order``, every buffered row again in
    arrival order with the columns ``compute`` added."""
    if not buffer.has_spilled():
        batches = buffer.drain()
        if batches:
            yield compute(concat_batches(batches))
        return
    restore = buffer.drain_ranges(key)
    try:
        if arrival_order:
            yield from restore.in_arrival_order(compute)
        else:
            for big, _ in restore.ranges():
                yield compute(big)
    finally:
        restore.close()


def next_blocking_output(op, make) -> Optional[Batch]:
    """The next batch of a blocking operator's ``blocking_output`` (made
    by ``make`` at the first call after its input ended); None at the
    end, which also marks the operator emitted."""
    if not op.no_more_input_seen or op._emitted:
        return None
    if op._out is None:
        op._out = make()
    b = next(op._out, None)
    if b is None:
        op._emitted = True
    return b


def _sort_keys(batch: Batch, fields) -> list:
    return [(batch.column(k.name).values, batch.column(k.name).valid,
             k.descending, k.nulls_first) for k in fields]


class TopNOp(Operator):
    """velox/exec/TopN.h: carry the running top N across batches. Each
    batch is concatenated after the carry and stably sorted, so rows that
    tie on every key stay in arrival order, as in the reference."""

    blocking = True

    def __init__(self, node):
        super().__init__(node)
        self._carry: Optional[Batch] = None
        self._emitted = False

    def add_input(self, batch: Batch) -> None:
        merged = (batch if self._carry is None
                  else concat_batches([self._carry, batch]))
        idx, osel = top_n_indices(_sort_keys(merged, self.node.keys),
                                  merged.sel, self.node.count)
        self._carry = merged.gather(idx, osel)

    def get_output(self) -> Optional[Batch]:
        if not self.no_more_input_seen or self._emitted:
            return None
        self._emitted = True
        return self._carry

    def is_finished(self) -> bool:
        return self.no_more_input_seen and self._emitted


class LimitOp(Operator):
    """velox/exec/Limit.h: offset and limit by masking selection ranks
    (one host sync per batch for the batch's active count)."""

    def __init__(self, node):
        super().__init__(node)
        self._skip = node.offset
        self._left = node.count
        self._queue: collections.deque = collections.deque()

    def add_input(self, batch: Batch) -> None:
        if self._left <= 0:
            return
        ranks = torch.cumsum(batch.sel, 0)
        keep = batch.sel & (ranks > self._skip) & (
            ranks <= self._skip + self._left)
        n_in = syncs.to_int(ranks[-1])
        n_kept = min(max(n_in - self._skip, 0), self._left)
        self._skip = max(self._skip - n_in, 0)
        self._left -= n_kept
        if n_kept > 0:
            self._queue.append(batch.with_sel(keep, n_kept))

    def needs_input(self) -> bool:
        return super().needs_input() and self._left > 0

    def get_output(self) -> Optional[Batch]:
        return self._queue.popleft() if self._queue else None

    def is_finished(self) -> bool:
        return (not self._queue
                and (self.no_more_input_seen or self._left <= 0))


# ------------------------------------------------------------------ joins

def _canon_int(v: torch.Tensor) -> torch.Tensor:
    """Values -> an equality-preserving integer lane, 32-bit lanes kept
    narrow: floats by their bits (-0.0 as +0.0, one NaN)."""
    if v.dtype.is_floating_point:
        v = torch.where(v == 0, torch.zeros_like(v), v)
        v = torch.where(torch.isnan(v), torch.full_like(v, float("nan")),
                        v)
        return v.view(torch.int32 if v.dtype == torch.float32
                      else torch.int64)
    if v.dtype == torch.bool or v.element_size() <= 4:
        return v.to(torch.int32)
    return v.to(torch.int64)


def _minmax(v: torch.Tensor, act: torch.Tensor) -> torch.Tensor:
    """[min, max] of the active values as one 2-element device tensor
    (both read on the host in one sync)."""
    info = torch.iinfo(v.dtype)
    lo = torch.where(act, v, torch.full_like(v, info.max)).min()
    hi = torch.where(act, v, torch.full_like(v, info.min)).max()
    return torch.stack([lo, hi]).to(torch.int64)


class JoinKeyCodec:
    """Canonicalize join key columns into one integer key.

    One key: its own lane (dictionary codes, or the canonical integer),
    narrowed to int32 when the build's (min, max) fits. Several keys: each
    key's offset from its build minimum packs into a normalized key
    (velox/exec/VectorHasher.h:130), probe rows out of the build range
    marked unmatchable. A probe-side dictionary that is not the build's
    remaps through a host table into the build's codes. The build's
    (min, max) is one host sync."""

    def __init__(self, build_batch: Batch, build_keys: Sequence[str]):
        self.build_keys = list(build_keys)
        self.cols = [build_batch.column(k) for k in build_keys]
        self.multi = len(self.cols) > 1
        self.dicts = [c.dictionary for c in self.cols]
        self.narrow = None  # (lo, hi) when a single wide key fits int32
        self.lohi = None    # host (lo, hi) of the encoded key domain
        sel = build_batch.sel

        def act_of(c):
            return sel if c.valid is None else sel & c.valid

        if not self.multi:
            c = self.cols[0]
            if c.dictionary is not None:
                if len(c.dictionary) > 0:
                    self.lohi = (0, len(c.dictionary) - 1)
            elif c.values.dtype != torch.bool and \
                    not c.values.dtype.is_floating_point:
                v = _canon_int(c.values)
                lo, hi = (int(x) for x in syncs.to_numpy(
                    _minmax(v, act_of(c))))
                if lo <= hi:
                    self.lohi = (lo, hi)
                    if v.dtype == torch.int64 and lo >= -(2 ** 31) \
                            and hi < 2 ** 31:
                        self.narrow = (lo, hi)
        else:
            fetched = syncs.to_numpy(torch.cat([
                _minmax(_canon_int(c.values).to(torch.int64), act_of(c))
                for c in self.cols]))
            self.mins, self.bits = [], []
            for ki in range(len(self.cols)):
                lo, hi = int(fetched[2 * ki]), int(fetched[2 * ki + 1])
                if hi < lo:  # empty build side
                    lo, hi = 0, 0
                self.mins.append(lo)
                self.bits.append(max(int(hi - lo).bit_length(), 1))
            if sum(self.bits) > 63:
                raise ValueError("normalized join key overflow")
            self.lohi = (0, (1 << sum(self.bits)) - 1)
        self._remaps: Dict[int, Tuple[Dictionary, torch.Tensor]] = {}

    def range_hint(self, max_span: int):
        """Host ``(lo, span)`` of the encoded key domain when small enough
        for a direct-address (kArray) join table, else None."""
        if self.lohi is None:
            return None
        lo, hi = self.lohi
        span = hi - lo + 1
        return (lo, span) if span <= max_span else None

    def _remap_table(self, i: int, probe_dict: Dictionary,
                     device: torch.device) -> torch.Tensor:
        hit = self._remaps.get(i)
        if hit is None or hit[0] is not probe_dict:
            d_build = self.dicts[i]
            t = np.full(len(probe_dict) + 1, -1, np.int32)
            for ci, val in enumerate(probe_dict.values):
                t[ci + 1] = d_build.code_of(val)
            hit = (probe_dict, torch.from_numpy(t).to(device))
            self._remaps[i] = hit
        return hit[1]

    def encode(self, cols, dicts, is_probe: bool):
        """``cols`` = [(values, valid)] parallel to the build keys, with
        each side's own dictionaries. Returns ``(key, null_valid,
        match_valid)``: ``null_valid`` is SQL null-ness, ``match_valid``
        marks rows that provably cannot match (a dictionary miss, out of
        the build range): excluded from matching but not null."""
        null_valid = None
        match_valid = None

        def both(a, b):
            return b if a is None else a & b

        vals64 = []
        for i, ((values, cvalid), pdict) in enumerate(zip(cols, dicts)):
            v = _canon_int(values)
            if cvalid is not None:
                null_valid = both(null_valid, cvalid)
            if self.dicts[i] is not None and is_probe \
                    and pdict is not self.dicts[i]:
                if pdict is None:
                    raise ValueError(
                        f"join key {self.build_keys[i]}: probe side not "
                        "dictionary-encoded")
                remap = self._remap_table(i, pdict, values.device)
                idx = values.to(torch.int64).clamp(-1, len(pdict) - 1) + 1
                v = remap.index_select(0, idx)
                match_valid = both(match_valid, v >= 0)
            if self.multi:
                lo, b = self.mins[i], self.bits[i]
                off = v.to(torch.int64) - lo
                in_range = (off >= 0) & (off < (1 << b))
                if is_probe:
                    match_valid = both(match_valid, in_range)
                vals64.append(torch.where(in_range, off,
                                          torch.zeros_like(off)))
            else:
                vals64.append(v)
        if not self.multi:
            v = vals64[0]
            if self.narrow is not None and v.dtype == torch.int64:
                lo, hi = self.narrow
                if is_probe:
                    match_valid = both(match_valid, (v >= lo) & (v <= hi))
                    v = v.clamp(lo, hi)
                v = v.to(torch.int32)
            return v, null_valid, match_valid
        lane = torch.int32 if sum(self.bits) <= 31 else torch.int64
        key = torch.zeros_like(vals64[0], dtype=lane)
        shift = 0
        for off, b in zip(vals64, self.bits):
            key = key | (off.to(lane) << shift)
            shift += b
        return key, null_valid, match_valid


def _distinct(a: np.ndarray) -> np.ndarray:
    """Sorted distinct values of a host array, by one sort. (numpy 2.3's
    ``np.unique`` hashes integers instead: 1.4 s over TPC-H Q3's two
    pushed key sets at SF10, about 1.75M keys, where a sort takes tens of
    milliseconds.)"""
    s = np.sort(a)
    return s[np.concatenate(([True], s[1:] != s[:-1]))]


def _and_valid(a: Optional[torch.Tensor], b: Optional[torch.Tensor]):
    if a is None:
        return b
    return a if b is None else a & b


class JoinBridge:
    """velox/exec/HashJoinBridge.h: the build side's handoff to the
    probe. ``on_ready`` callbacks fire when the build publishes (the
    probe pushes its dynamic filter then, before its scan's first
    split)."""

    def __init__(self, node):
        self.node = node
        self.ready = False
        self.build_batch: Optional[Batch] = None
        self.codec: Optional[JoinKeyCodec] = None
        self.sorted_keys = None
        self.perm = None
        self.n_active = None
        self.tables = ()   # kArray (tfirst, tcount) when the range is small
        self.key_lo = 0
        #: 0-d device bool: some live build row has a null key (read on
        #: the host only by the null-aware anti join)
        self.build_has_null_key: Optional[torch.Tensor] = None
        #: (capacity,) device bool: the build rows some probe row matched
        #: (under the filter), OR-ed over probe batches and expansion
        #: chunks; read at the finish of right, full and right-semi joins
        self.matched: Optional[torch.Tensor] = None
        #: a spilled build: per hash part, its rows as host batches
        #: (``HashBuildOp``); the probe joins one part at a time
        self.spill_parts: Optional[List[List[Batch]]] = None
        self.on_ready: List[Callable] = []

    def mark_ready(self) -> None:
        self.ready = True
        for cb in self.on_ready:
            cb()


class HashBuildOp(Operator):
    """velox/exec/HashBuild.cpp: sink; buffer, concatenate, compact, sort
    by key."""

    blocking = True
    #: how the build index is made (merge joins skip the sort)
    _index_build = staticmethod(build_join_index)

    def __init__(self, node, bridge: JoinBridge):
        super().__init__(node)
        self.bridge = bridge
        self._buffer = SpillableBuffer("hash_build")
        self._device: Optional[torch.device] = None

    def add_input(self, batch: Batch) -> None:
        self._device = batch.device
        self._buffer.append(batch)

    def no_more_input(self) -> None:
        if self.no_more_input_seen:
            return
        super().no_more_input()
        node = self.bridge.node
        if (self._buffer.has_spilled()
                and type(self)._index_build is build_join_index):
            # the build stays in host RAM split by key hash; the probe
            # splits its side alike and joins one part at a time
            # (velox/exec/Spill.h partitioning, one level)
            from velox_tpu_torch.utils.config import config

            self.bridge.spill_parts = partition_batches(
                self._buffer.drain_host(), node.right_keys,
                config.spill_join_partitions,
                pin=self._device.type == "cuda")
            self.bridge.mark_ready()
            return
        batches = self._buffer.drain()
        if batches:
            # a sparse build shrinks before its index is made: every probe
            # batch gathers from it (the count sync is skipped when known)
            big = concat_batches(batches)
            big = big.compact(big.num_rows)
        else:
            big = Batch.empty_like(node.right.output_type, round_capacity(1),
                                   self._device or plan_device(node.right))
        build_bridge_state(self.bridge, node, big, type(self)._index_build)

    def get_output(self) -> Optional[Batch]:
        return None

    def is_finished(self) -> bool:
        return self.no_more_input_seen


def build_bridge_state(bridge: JoinBridge, node, big: Batch,
                       index_build) -> None:
    """Compute the build side's join state and publish it on the bridge.
    A selective build (few live rows in a large capacity) is compacted
    first: the probe's searches and gathers cost by build capacity."""
    from velox_tpu_torch.utils.config import config

    if big.capacity > (1 << 16):
        cnt = (big.num_rows if big.num_rows is not None
               else big.selected_count())
        if cnt * 8 < big.capacity:
            big = big.compact(cnt)   # order-preserving, merge builds too
    codec = JoinKeyCodec(big, node.right_keys)
    rng_hint = codec.range_hint(config.karray_join_span)
    cols = [(big.column(k).values, big.column(k).valid)
            for k in node.right_keys]
    dicts = [big.column(k).dictionary for k in node.right_keys]
    key, null_valid, match_valid = codec.encode(cols, dicts, is_probe=False)
    sorted_keys, perm, n_active = index_build(
        key, _and_valid(null_valid, match_valid), big.sel)
    tables = ()
    if rng_hint is not None:
        tables = build_join_table(sorted_keys, n_active, *rng_hint)
    bridge.build_batch = big
    bridge.codec = codec
    bridge.sorted_keys, bridge.perm, bridge.n_active = (
        sorted_keys, perm, n_active)
    bridge.tables = tables
    bridge.key_lo = rng_hint[0] if rng_hint else 0
    bridge.build_has_null_key = (None if null_valid is None
                                 else (big.sel & ~null_valid).any())
    bridge.matched = torch.zeros(big.capacity, dtype=torch.bool,
                                 device=big.device)
    bridge.mark_ready()


def _join_filter_schema(node):
    lt, rt = node.left.output_type, node.right.output_type
    return row_type(list(lt.names) + list(rt.names),
                    list(lt.children) + list(rt.children))


def _expr_fields(expr) -> set:
    from velox_tpu_torch.expr.ir import FieldRef

    if isinstance(expr, FieldRef):
        return {expr.name}
    out = set()
    for c in expr.children:
        out |= _expr_fields(c)
    return out


class HashProbeOp(Operator):
    """velox/exec/HashProbe.cpp: all eight join types (inner, left, right
    and full outer, left- and right-semi, null-aware anti (NOT IN) and
    anti (NOT EXISTS)), each with an optional residual filter. Per probe
    batch, the (first, count) match runs come from the kArray table when
    the build range is small, else from a binary search (or, in a merge
    join over an ascending probe lane, the flipped merge probe).
    Unfiltered left-semi and anti joins only narrow the batch's
    selection. The other forms read the match total on the host (one
    sync) and expand the runs probe-major: a left or full join emits one
    row with null build columns for a probe row without a match; a
    filter is evaluated on every match pair, then reduced per probe row
    for semi and anti. An expansion of more than ``_EXPAND_CHUNK`` pairs
    runs in chunks of whole probe rows, so a probe batch never holds
    more pairs than that at once.

    Right, full and right-semi joins OR the build rows that matched (and
    passed the filter) into the bridge's ``matched`` flags; after the
    last probe batch they emit the build side: the unmatched build rows
    with null probe columns (right, full) or the matched ones (right
    semi), in build-batch order. A filtered left or full join keeps the
    passing pairs and the unmatched probe rows, then emits the batch's
    probe rows whose every match failed the filter, null-extended, as
    one batch after the batch's joined rows."""

    _SEMI_LIKE = (JoinType.LEFT_SEMI, JoinType.ANTI, JoinType.ANTI_SIMPLE)
    #: joins that keep the probe rows without a (passing) match
    _LEFT_LIKE = (JoinType.LEFT, JoinType.FULL)
    #: joins that emit build rows after the last probe batch
    _TRACK_MATCHED = (JoinType.RIGHT, JoinType.FULL, JoinType.RIGHT_SEMI)

    #: value sets at most this large push as exact sorted IN-tables
    _SET_PUSH_MAX = 4096
    #: string sets at most this large push as IN literal lists
    _STR_SET_MAX = 100
    #: build sides beyond this capacity push nothing (host copy cost)
    _PUSH_CAP_MAX = 1 << 21
    #: most match pairs one expansion holds
    _EXPAND_CHUNK = 1 << 24

    def __init__(self, node, bridge: JoinBridge):
        super().__init__(node)
        self._filter = None
        if node.filter is not None:
            self._filter = ExprEvaluator([node.filter],
                                         _join_filter_schema(node))
        self.bridge = bridge
        self.jt = node.join_type
        self._queue: collections.deque = collections.deque()
        self._final_emitted = False
        #: the probe columns' dictionaries, for the null probe columns of
        #: the build rows a right or full join emits last
        self._probe_dicts: Dict[str, Dictionary] = {}
        #: the probe side's scan, set by LocalPlanner when the pushdown
        #: applies
        self.pushdown_scan: Optional[TableScanOp] = None
        self._pushdown_done = False
        self._build_null: Optional[bool] = None
        bridge.on_ready.append(self._on_build_ready)
        #: over a spilled build: the buffered probe side, the parts left
        #: to join, each part's probe rows, and whether a NULL build key
        #: lies in any part
        self._probe_buf: Optional[SpillableBuffer] = None
        self._spill_pending: Optional[List[int]] = None
        self._probe_parts: Optional[List[List[Batch]]] = None
        self._spill_global_null = False
        self._device: Optional[torch.device] = None

    def _on_build_ready(self) -> None:
        if not self._pushdown_done and self.pushdown_scan is not None:
            self._push_dynamic_filter()

    def _push_dynamic_filter(self) -> None:
        """Push build-side key filters into the probe-side scan: an exact
        IN-table for at most 4096 values, an IN list for dictionary
        strings, else a min/max range and a bloom bitmask
        (velox/exec/HashProbe.cpp:419-444). One host copy of the build's
        selection and keys."""
        from velox_tpu_torch.expr.ir import (
            Call, Literal, and_, field, gte, lit, lte,
        )
        from velox_tpu_torch.functions.scalar import (
            bloom_literal, in_table_literal,
        )
        from velox_tpu_torch.ops.bloom import build_bloom

        self._pushdown_done = True
        scan = self.pushdown_scan
        br = self.bridge
        if scan is None or not br.ready or br.build_batch is None:
            return
        big = br.build_batch
        if big.capacity > self._PUSH_CAP_MAX:
            return
        scan_cols = set(scan.node.all_columns)
        pairs = [(lk, rk) for lk, rk in zip(self.node.left_keys,
                                            self.node.right_keys)
                 if lk in scan_cols]
        sel_host = syncs.to_numpy(big.sel)
        if not sel_host.any():
            scan.dynamic_filters.append(
                ExprEvaluator([lit(False)], scan.fschema))
            return
        conjs = []
        for lk, rk in pairs:
            col = big.column(rk)
            vals = syncs.to_numpy(col.values)
            m = sel_host
            if col.valid is not None:
                m = m & syncs.to_numpy(col.valid)
            live = vals[m]
            if live.size == 0:
                continue
            if col.dictionary is not None:
                # distinct build strings; the IN list binds against the
                # probe side's own dictionary
                codes = _distinct(live)
                codes = codes[codes >= 0]
                if len(codes) > self._STR_SET_MAX:
                    continue
                conjs.append(Call(BOOLEAN, "in", tuple(
                    [field(lk)] + [Literal(None, str(col.dictionary.values[c]))
                                   for c in codes])))
                continue
            u = _distinct(live)
            f = field(lk)
            # each table goes to the card once here, not once a batch
            if len(u) <= self._SET_PUSH_MAX:
                table = in_table_literal(np.ascontiguousarray(u), big.device)
                conjs.append(Call(BOOLEAN, "__in_table",
                                  (f, Literal(BIGINT, table))))
            else:
                conjs.append(and_(gte(f, lit(u[0].item())),
                                  lte(f, lit(u[-1].item()))))
                words = bloom_literal(build_bloom(u), big.device)
                conjs.append(Call(BOOLEAN, "__bloom_contains",
                                  (f, Literal(BIGINT, words))))
        if not conjs:
            return
        expr = conjs[0]
        for c in conjs[1:]:
            expr = Call(BOOLEAN, "and", (expr, c))
        scan.dynamic_filters.append(ExprEvaluator([expr], scan.fschema))

    def _probe_sorted(self, batch: Batch):
        """Hash probes assume nothing about probe order (the merge probe
        overrides this)."""
        return False

    def _runs(self, batch: Batch):
        """(first, count) per probe row, and the probe key's SQL
        null-ness (None when no key can be null)."""
        br = self.bridge
        node = self.node
        key_cols = [(batch.column(k).values, batch.column(k).valid)
                    for k in node.left_keys]
        dicts = [batch.column(k).dictionary for k in node.left_keys]
        key, null_valid, match_valid = br.codec.encode(
            key_cols, dicts, is_probe=True)
        sel = batch.sel
        if len(br.tables) == 2:
            # kArray first: two table gathers beat any search
            return probe_join_table(br.tables[0], br.tables[1], br.key_lo,
                                    key, _and_valid(null_valid, match_valid),
                                    sel), null_valid
        flip = self._probe_sorted(batch)
        if flip == "repair":
            # only rows outside the lane order (padding, null keys) take
            # the fill; match_valid folds in after it
            return probe_join_index_merge_repair(
                br.sorted_keys, br.n_active, key, null_valid, sel,
                match_valid=match_valid), null_valid
        valid = _and_valid(null_valid, match_valid)
        if flip:
            return probe_join_index_merge(br.sorted_keys, br.n_active, key,
                                          valid, sel), null_valid
        return probe_join_index(br.sorted_keys, br.n_active, key, valid,
                                sel), null_valid

    def _build_has_null(self) -> bool:
        """Whether a live build row has a null key (one host read)."""
        if self._build_null is None:
            flag = self.bridge.build_has_null_key
            self._build_null = (flag is not None
                                and bool(syncs.to_int(flag)))
        return self._build_null

    def _semi_sel(self, sel, hits, null_valid):
        """A semi or anti join's new selection from each probe row's
        count of (passing) matches."""
        if self.jt == JoinType.LEFT_SEMI:
            return sel & (hits > 0)
        if self.jt == JoinType.ANTI_SIMPLE:
            return sel & (hits == 0)
        # null-aware NOT IN: a null build key empties the result, a null
        # probe key drops its row, an unmatchable non-null key survives
        if self._build_has_null():
            return torch.zeros_like(sel)
        out = sel & (hits == 0)
        return out if null_valid is None else out & null_valid

    def _expansions(self, first, count, emit):
        """``expand_matches`` over at most ``_EXPAND_CHUNK`` pairs at a
        time: yields ``(probe_rows, build_rows, matched, out_sel, n)``.
        The match total is one host read; a larger expansion cuts the
        probe rows where the running total crosses each multiple of the
        chunk (one more read) and reads each chunk's total."""
        br = self.bridge
        e = output_counts(count, emit).to(torch.int64)
        total = syncs.to_int(e.sum())
        if total == 0:
            return
        if total <= self._EXPAND_CHUNK:
            yield expand_matches(first, count, br.perm,
                                 round_capacity(total), emit) + (total,)
            return
        cum = torch.cumsum(e, 0)
        targets = torch.arange(self._EXPAND_CHUNK, total, self._EXPAND_CHUNK,
                               device=e.device)
        cuts = syncs.to_numpy(torch.searchsorted(cum, targets, right=True))
        rows = torch.arange(e.shape[0], device=e.device)
        lo = 0
        for hi in sorted(set(cuts.tolist()) | {e.shape[0]}):
            hi = max(hi, lo + 1)
            if hi > e.shape[0] or lo >= e.shape[0]:
                break
            inr = (rows >= lo) & (rows < hi)
            count_c = torch.where(inr, count, torch.zeros_like(count))
            emit_c = None if emit is None else emit & inr
            n = syncs.to_int(torch.where(inr, e, torch.zeros_like(e)).sum())
            lo = hi
            if n:
                yield expand_matches(first, count_c, br.perm,
                                     round_capacity(n), emit_c) + (n,)

    def _pairs_batch(self, batch: Batch, names, probe_rows, build_rows,
                     matched, out_sel, n) -> Batch:
        """The expanded pairs' columns ``names``: probe columns gathered
        by probe row, build columns by build row, valid only where a
        match exists."""
        left = set(self.node.left.output_type.names)
        cols = {}
        for name in names:
            if name in left:
                cols[name] = batch.column(name).gather(probe_rows)
            else:
                c = self.bridge.build_batch.column(name).gather(build_rows)
                cols[name] = Column(c.dtype, c.values,
                                    _and_valid(c.valid, matched),
                                    c.dictionary, c.stats)
        return Batch(cols, out_sel, n)

    def add_input(self, batch: Batch) -> None:
        self._device = batch.device
        if self.bridge.spill_parts is not None:
            # a spilled build: buffer the probe side; the join runs one
            # hash part at a time at the finish (velox HashProbe
            # spillInput)
            if self._probe_buf is None:
                self._probe_buf = SpillableBuffer(
                    f"join_probe:{self.node.id}")
            self._probe_buf.append(batch)
            return
        self._probe_batch(batch)

    def _probe_batch(self, batch: Batch) -> None:
        br = self.bridge
        if not br.ready:
            raise RuntimeError("probe before the build finished")
        if not self._pushdown_done:
            self._push_dynamic_filter()
        for name in self.node.left.output_type.names:
            d = batch.column(name).dictionary
            if d is not None:
                self._probe_dicts.setdefault(name, d)
        (first, count), null_valid = self._runs(batch)
        out_names = self.output_type.names
        jt = self.jt
        semi = jt in self._SEMI_LIKE
        if semi and self._filter is None:
            sel = self._semi_sel(batch.sel, count, null_valid)
            self._queue.append(batch.with_sel(sel).project(out_names))
            return
        left_like = jt in self._LEFT_LIKE
        track = jt in self._TRACK_MATCHED
        emit = batch.sel if left_like else None
        # a right-semi join's rows come from the bridge at the finish:
        # its pairs only feed the filter
        names = [] if jt == JoinType.RIGHT_SEMI else list(out_names)
        if self._filter is not None:
            names = list(dict.fromkeys(
                names + sorted(_expr_fields(self.node.filter))))
        hits = None
        if self._filter is not None and (semi or left_like):
            # per probe row: its match pairs that pass the filter
            hits = torch.zeros(batch.capacity + 1, dtype=torch.int32,
                               device=batch.device)
        for probe_rows, build_rows, matched, out_sel, n in self._expansions(
                first, count, emit):
            pairs = self._pairs_batch(batch, names, probe_rows, build_rows,
                                      matched, out_sel, n)
            passing = None
            if self._filter is not None:
                passing = self._filter.filter_sel(pairs) & matched
            if track:
                hit = matched & out_sel
                if passing is not None:
                    hit = hit & passing
                br.matched = br.matched | build_matched_flags(
                    br.matched.shape[0], build_rows, hit,
                    torch.ones_like(out_sel))
            if hits is not None:
                hits.index_add_(0, torch.where(
                    passing, probe_rows,
                    torch.full_like(probe_rows, batch.capacity)),
                    passing.to(torch.int32))
            if semi or jt == JoinType.RIGHT_SEMI:
                continue   # semi: at the batch's end; right semi: finish
            if passing is None:
                self._queue.append(pairs)
            elif left_like:
                # passing pairs and unmatched probe rows; the build
                # columns of a failed pair are null
                keep = passing | (out_sel & ~matched)
                self._queue.append(self._failed_pairs_nulled(
                    pairs, passing).with_sel(keep).project(out_names))
            else:
                self._queue.append(
                    pairs.with_sel(passing).project(out_names))
        if semi:
            sel = self._semi_sel(batch.sel, hits[:batch.capacity],
                                 null_valid)
            self._queue.append(batch.with_sel(sel).project(out_names))
        elif hits is not None:
            # probe rows with matches of which none passed come back
            # null-extended, after the batch's joined rows
            resurrect = batch.sel & (count > 0) & (hits[:batch.capacity] == 0)
            self._queue.append(self._null_extended(batch, resurrect))

    def _failed_pairs_nulled(self, pairs: Batch, passing) -> Batch:
        """``pairs`` with every build column null where ``passing`` is
        false."""
        left = set(self.node.left.output_type.names)
        cols = {}
        for name, c in pairs.columns.items():
            if name not in left:
                c = Column(c.dtype, c.values, _and_valid(c.valid, passing),
                           c.dictionary, c.stats)
            cols[name] = c
        return Batch(cols, pairs.sel, pairs.num_rows)

    def _null_extended(self, batch: Batch, sel) -> Batch:
        """The probe rows ``sel`` with all-null build columns."""
        cap = batch.capacity
        cols = {}
        for name in self.node.left.output_type.names:
            cols[name] = batch.column(name)
        for name, t in zip(self.node.right.output_type.names,
                           self.node.right.output_type.children):
            c = self.bridge.build_batch.column(name)
            cols[name] = Column(
                t, torch.zeros(cap, dtype=c.values.dtype, device=sel.device),
                torch.zeros(cap, dtype=torch.bool, device=sel.device),
                c.dictionary)
        return Batch(cols, sel).project(self.output_type.names)

    def _emit_build_side(self) -> Optional[Batch]:
        """After the last probe batch: a right-semi join's matched build
        rows; a right or full join's unmatched ones with null probe
        columns (None when there are none: one host read)."""
        br = self.bridge
        big = br.build_batch
        if self.jt == JoinType.RIGHT_SEMI:
            return big.with_sel(big.sel & br.matched).project(
                self.output_type.names)
        sel = big.sel & ~br.matched
        if syncs.to_int(sel.sum()) == 0:
            return None
        cap = big.capacity
        cols = {}
        for name, t in zip(self.node.left.output_type.names,
                           self.node.left.output_type.children):
            cols[name] = Column(
                t, torch.zeros(cap, dtype=torch_dtype(t.dtype),
                               device=big.device),
                torch.zeros(cap, dtype=torch.bool, device=big.device),
                _key_dict_for(self._probe_dicts, t, name))
        for name in self.node.right.output_type.names:
            cols[name] = big.column(name)
        return Batch(cols, sel).project(self.output_type.names)

    def get_output(self) -> Optional[Batch]:
        if self._queue:
            return self._queue.popleft()
        if (self.no_more_input_seen and self.bridge.spill_parts is not None
                and not self._final_emitted):
            if self._spill_pending is None:
                self._prepare_spill_probe()
            while self._spill_pending and not self._queue:
                self._process_spill_partition(self._spill_pending.pop())
            if self._queue:
                return self._queue.popleft()
            self._final_emitted = True
            return None
        if (self.no_more_input_seen and not self._final_emitted
                and self.jt in self._TRACK_MATCHED):
            self._final_emitted = True
            return self._emit_build_side()
        return None

    def is_finished(self) -> bool:
        if not self.no_more_input_seen or self._queue:
            return False
        if self.bridge.spill_parts is not None:
            return self._final_emitted
        return (self._final_emitted or self.jt not in self._TRACK_MATCHED)

    # ------------------------------------------ a spilled build, by parts
    def _prepare_spill_probe(self) -> None:
        """Split the buffered probe side by the build's hash of the keys.
        A NULL build key in any part counts for every part (the
        null-aware anti join needs the whole build)."""
        parts = self.bridge.spill_parts
        self._pushdown_done = True
        self._spill_global_null = any(
            f.column(k).valid is not None and not bool(f.column(k).valid.all())
            for part in parts for f in part for k in self.node.right_keys)
        probe = [] if self._probe_buf is None else self._probe_buf.drain_host()
        self._probe_parts = partition_batches(
            probe, self.node.left_keys, len(parts),
            pin=self._device is not None and self._device.type == "cuda")
        self._spill_pending = list(range(len(parts)))

    def _process_spill_partition(self, p: int) -> None:
        """Join part ``p``: its build rows indexed on the device, its probe
        rows probed; a right, full or right-semi join then emits the
        part's build rows (matched flags are per part)."""
        br, node = self.bridge, self.node
        device = self._device or plan_device(node.right)
        build = restore_fragments(br.spill_parts[p], device)
        if build is None:
            build = Batch.empty_like(node.right.output_type,
                                     round_capacity(1), device)
        build_bridge_state(br, node, build, build_join_index)
        self._build_null = self._spill_global_null
        probe = restore_fragments(self._probe_parts[p], device)
        if probe is not None:
            self._probe_batch(probe)
        if self.jt in self._TRACK_MATCHED:
            out = self._emit_build_side()
            if out is not None:
                self._queue.append(out)


class MergeJoinBuildOp(HashBuildOp):
    """velox/exec/MergeJoin.h:47 build half: the plan guarantees the
    build input ascends on the key, so the index is a front-pack of the
    usable rows; nothing is sorted."""

    _index_build = staticmethod(build_join_index_presorted)


class MergeJoinProbeOp(HashProbeOp):
    """velox/exec/MergeJoin.h:47 probe half. Without a kArray table, each
    batch's probe lane is classified on the device (one host sync): if it
    ascends (or its active rows are an ascending prefix), the flipped
    merge probe runs, else a binary search per probe row. With the table
    the classification would decide nothing, so it is skipped."""

    def _probe_sorted(self, batch: Batch):
        node = self.node
        if len(node.left_keys) != 1:
            return False
        col = batch.column(node.left_keys[0])
        if col.dictionary is not None:
            return False
        if col.values.dtype not in (torch.int32, torch.int64):
            return False
        ok = batch.sel if col.valid is None else batch.sel & col.valid
        code = syncs.to_int(valid_ascending_code(col.values, ok))
        return {0: False, 1: "repair", 2: "raw"}[code]


# ------------------------------------------------------------- cross join

def _front_packed(batch: Batch) -> Tuple[Batch, int]:
    """The active rows, in order, at the front of a right-sized batch,
    and their count (one host sync)."""
    from velox_tpu_torch.ops.sort import pack_indices

    count = batch.selected_count()
    cap = min(round_capacity(max(count, 1)), batch.capacity)
    idx = pack_indices(batch.sel)[:cap]
    return batch.gather(idx, torch.arange(cap, device=batch.device) < count,
                        count), count


class CrossBuildOp(Operator):
    """velox/exec/NestedLoopJoinBuild.h:33: sink the (small) build side,
    its active rows packed to the front."""

    blocking = True

    def __init__(self, node, bridge: JoinBridge):
        super().__init__(node)
        self.bridge = bridge
        self._buffer = SpillableBuffer("cross_build")
        self._device: Optional[torch.device] = None

    def add_input(self, batch: Batch) -> None:
        self._device = batch.device
        self._buffer.append(batch)

    def no_more_input(self) -> None:
        if self.no_more_input_seen:
            return
        super().no_more_input()
        node = self.bridge.node
        batches = self._buffer.drain()
        if batches:
            big = concat_batches(batches)
        else:
            big = Batch.empty_like(node.right.output_type, round_capacity(1),
                                   self._device or plan_device(node.right))
        self.bridge.build_batch, self.bridge.n_active = _front_packed(big)
        self.bridge.mark_ready()

    def get_output(self) -> Optional[Batch]:
        return None

    def is_finished(self) -> bool:
        return self.no_more_input_seen


class CrossProbeOp(Operator):
    """velox/exec/NestedLoopJoinProbe.h:68: every active probe row with
    every build row (probe-major), then the join filter."""

    def __init__(self, node, bridge: JoinBridge):
        super().__init__(node)
        if node.join_type != JoinType.INNER:
            raise NotImplementedError(
                f"{node.join_type.value} nested-loop joins are not ported "
                "to velox_tpu_torch yet")
        self.bridge = bridge
        self._filter = (ExprEvaluator([node.filter], _join_filter_schema(node))
                        if node.filter is not None else None)
        self._queue: collections.deque = collections.deque()

    def add_input(self, batch: Batch) -> None:
        br = self.bridge
        if not br.ready:
            raise RuntimeError("probe before the build finished")
        nb = br.n_active
        if nb == 0:
            return
        probe, n_probe = _front_packed(batch)
        if n_probe == 0:
            return
        total = n_probe * nb
        cap = round_capacity(total)
        j = torch.arange(cap, device=batch.device)
        probe_rows = j // nb
        build_rows = j % nb
        cols = {n: probe.column(n).gather(probe_rows)
                for n in self.node.left.output_type.names}
        cols.update({n: br.build_batch.column(n).gather(build_rows)
                     for n in self.node.right.output_type.names})
        joined = Batch(cols, j < total, total)
        if self._filter is not None:
            joined = joined.with_sel(self._filter.filter_sel(joined))
        self._queue.append(joined.project(self.output_type.names))

    def get_output(self) -> Optional[Batch]:
        return self._queue.popleft() if self._queue else None

    def is_finished(self) -> bool:
        return self.no_more_input_seen and not self._queue


# ------------------------------------------------------------------- misc

class EnforceSingleRowOp(Operator):
    """velox/core/PlanNode.h:5069: the scalar-subquery guard. More than
    one input row raises; no input row gives one all-null row."""

    blocking = True

    def __init__(self, node):
        super().__init__(node)
        self._buffer: List[Batch] = []
        self._emitted = False
        self._device: Optional[torch.device] = None

    def add_input(self, batch: Batch) -> None:
        self._device = batch.device
        self._buffer.append(batch)

    def get_output(self) -> Optional[Batch]:
        if not self.no_more_input_seen or self._emitted:
            return None
        self._emitted = True
        total = sum(b.selected_count() for b in self._buffer)
        if total > 1:
            raise RuntimeError(
                f"Expected single row of input. Received {total} rows.")
        if total == 1:
            return concat_batches(self._buffer)
        cap = round_capacity(1)
        device = self._device or plan_device(self.node)
        empty = Batch.empty_like(self.output_type, cap, device)
        cols = {n: Column(c.dtype, c.values,
                          torch.zeros(cap, dtype=torch.bool, device=device),
                          c.dictionary)
                for n, c in empty.columns.items()}
        sel = torch.zeros(cap, dtype=torch.bool, device=device)
        sel[0] = True
        return Batch(cols, sel)

    def is_finished(self) -> bool:
        return self.no_more_input_seen and self._emitted


class AssignUniqueIdOp(Operator):
    """velox/core/PlanNode.h:5153 — a unique int64 per row: the row's
    rank among the selected rows so far, OR the task id shifted left by
    40 bits (0 on unselected rows before the OR). The running count stays
    on the device, so no batch waits on the host."""

    def __init__(self, node):
        super().__init__(node)
        self._next: Optional[torch.Tensor] = None
        self._queue: collections.deque = collections.deque()

    def add_input(self, batch: Batch) -> None:
        sel = batch.sel
        if self._next is None:
            self._next = torch.zeros((), dtype=torch.int64, device=sel.device)
        rank = torch.cumsum(sel, 0) - 1 + self._next
        ids = (torch.where(sel, rank, torch.zeros_like(rank))
               | (int(self.node.task_unique_id) << 40))
        self._next = self._next + sel.sum()
        self._queue.append(batch.with_column(self.node.id_name,
                                             Column(BIGINT, ids)))

    def get_output(self) -> Optional[Batch]:
        return self._queue.popleft() if self._queue else None

    def is_finished(self) -> bool:
        return self.no_more_input_seen and not self._queue
