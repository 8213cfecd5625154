"""Array and map projections beyond ``ProjectOp``'s own forms (the port of
``velox_tpu/exec/complex_fns.py``).

Each function here is a ``ProjectOp`` applier, ``fn(op, batch, e, out_t)``
-> the output column of one top-level projection. They share one
expansion skeleton: a row-segmented lane is laid out in a compact (row,
ordinal) form with ONE host read (the element total), and each row's
semantics become flat sorts, scans and packs over that form, where
velox/functions/prestosql/ArrayFunctions.h and MapFunctions.h loop over
the rows. The long tail whose outputs are new nested values per row
(``ngrams``, ``combinations``, ``array_join``, ...) is built on the host
from the rows' Python lists, with the port's own ``make_*_column``.

``ProjectOp`` dispatches every top-level ``Call`` whose name is in
``EXT_APPLIERS``.
"""

from __future__ import annotations

import itertools
import math
import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from velox_tpu_torch.expr.ir import Call, FieldRef, Literal
from velox_tpu_torch.ops.sort import lex_sort, pack_indices, sort_indices
from velox_tpu_torch.ops.sortkey import encode_sort_key
from velox_tpu_torch.ops.window import run_owners
from velox_tpu_torch.types import BIGINT, BOOLEAN, DOUBLE, VARCHAR
from velox_tpu_torch.types.types import row_type
from velox_tpu_torch.utils import syncs
from velox_tpu_torch.vector.batch import Batch, round_capacity
from velox_tpu_torch.vector.column import (
    ArrayColumn, Column, Dictionary, MapColumn, RowColumn, make_any_column,
)


def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` with ``idx`` clipped into range (``jnp.take`` with
    ``mode="clip"``)."""
    return x.index_select(0, idx.to(torch.int64).clamp(0, x.shape[0] - 1))


def take_valid(valid: Optional[torch.Tensor], idx: torch.Tensor):
    return None if valid is None else take(valid, idx)


def and_valid(a, b):
    if a is None:
        return b
    return a if b is None else a & b


def offsets(counts: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sum: each row's start from the row lengths."""
    return torch.cumsum(counts, 0) - counts


def count_by(owner: torch.Tensor, keep: torch.Tensor, cap: int):
    """How many kept entries each of ``cap`` rows owns."""
    slot = torch.where(keep, owner.to(torch.int64),
                       torch.full((), cap, dtype=torch.int64,
                                  device=keep.device))
    out = torch.zeros(cap + 1, dtype=torch.int64, device=keep.device)
    out.index_add_(0, slot.clamp(0, cap), torch.ones_like(slot))
    return out[:cap]


def pack_column(col: Column, perm: torch.Tensor, dtype=None) -> Column:
    return Column(dtype or col.dtype, take(col.values, perm),
                  take_valid(col.valid, perm), col.dictionary)


def null_rows(cols) -> Optional[torch.Tensor]:
    """The row validity of a call that is NULL where any input is."""
    out = None
    for c in cols:
        out = and_valid(out, c.valid)
    return out


# ------------------------------------------------------------ expansion

class Expanded:
    """The compact (row, ordinal) layout of a segmented lane set."""

    __slots__ = ("nst", "lens", "row_of", "ordinal", "in_run", "src_idx",
                 "ecap", "total")


def expand(starts, lengths, sel) -> Expanded:
    """Lay any (gathered, shared) offsets out compactly, row after row:
    ``row_of``/``ordinal`` of each slot, ``src_idx`` into the source
    elements. One host read (the element total)."""
    dev = lengths.device
    lens = torch.where(sel, lengths.to(torch.int64),
                       torch.zeros((), dtype=torch.int64, device=dev))
    total = syncs.to_int(lens.sum())
    ecap = round_capacity(max(total, 1))
    nst = offsets(lens)
    row_of = run_owners(nst, lens > 0, ecap).clamp(min=0)
    p = torch.arange(ecap, dtype=torch.int64, device=dev)
    out = Expanded()
    out.nst, out.lens, out.row_of = nst, lens, row_of
    out.ordinal = p - take(nst, row_of)
    out.in_run = p < total
    out.src_idx = take(starts, row_of) + out.ordinal
    out.ecap, out.total = ecap, total
    return out


def gather_elem(col: Column, idx) -> tuple:
    return take(col.values, idx), take_valid(col.valid, idx)


def pack_rows(ex: Expanded, keep, cap: int):
    """Pack the kept slots, in their order: ``(perm, starts, counts)``."""
    kcnt = count_by(ex.row_of, keep, cap)
    return pack_indices(keep, ex.ecap), offsets(kcnt), kcnt


def row_sort(first: torch.Tensor, ops: Sequence[torch.Tensor]
             ) -> torch.Tensor:
    """Stable permutation by (``first``, *``ops``): one sort of a packed
    int64 key where the operands fit 63 bits, else chained sorts."""
    from velox_tpu_torch.functions.aggregates_collect import _packed

    key = _packed(first, list(ops))
    if key is not None:
        return torch.sort(key, stable=True)[1]
    return lex_sort([first] + list(ops))


def sort_within_rows(ex: Expanded, key_ops):
    """Stable sort of the slots by (row, *key_ops): the permutation and
    the sorted row key (``ecap`` past the last element)."""
    row_key = torch.where(ex.in_run, ex.row_of,
                          torch.full_like(ex.row_of, ex.ecap))
    perm = row_sort(row_key, key_ops)
    return perm, take(row_key, perm)


def run_heads(sorted_ops: Sequence[torch.Tensor]) -> torch.Tensor:
    """True where a slot differs from the previous on any operand."""
    n = sorted_ops[0].shape[0]
    diff = torch.zeros(n, dtype=torch.bool, device=sorted_ops[0].device)
    diff[0] = True
    for k in sorted_ops:
        diff[1:] |= k[1:] != k[:-1]
    return diff


def _out_elements(cap: int, keep, srow, vals, valid, ecap, dtype, dic):
    """Pack the kept sorted slots: (starts, counts, element column)."""
    kcnt = count_by(srow, keep, cap)
    pperm = pack_indices(keep, ecap)
    return offsets(kcnt), kcnt, Column(dtype, take(vals, pperm),
                                       take_valid(valid, pperm), dic)


def evaluate_args(batch: Batch, exprs) -> List[tuple]:
    """Row-level ``(values, valid)`` of scalar argument expressions, each
    at the batch capacity."""
    from velox_tpu_torch.exec.operator import ExprEvaluator

    out = []
    for v, va in ExprEvaluator(list(exprs), batch.schema).evaluate(batch):
        if v.dim() == 0:
            v = v.expand(batch.capacity)
        if va is not None and va.dim() == 0:
            va = va.expand(batch.capacity)
        out.append((v, va))
    return out


# ------------------------------------------------------------- lambdas

def lambda_capture_names(body, params, batch: Batch) -> List[str]:
    """Outer-row scalar columns a lambda body captures
    (velox/expression/LambdaExpr.cpp)."""
    names: List[str] = []

    def walk(e):
        if isinstance(e, FieldRef):
            if (e.name not in params and "#" not in e.name
                    and e.name in batch and e.name not in names
                    and not isinstance(batch.column(e.name),
                                       (ArrayColumn, MapColumn))):
                names.append(e.name)
        for c in e.children:
            walk(c)

    walk(body)
    return names


def eval_lambda(batch: Batch, lam, lanes, owner=None, within=None):
    """The lambda's body over flat parameter lanes ``[(param, column)]``
    of one capacity, captured outer columns gathered to it by owning row
    (``owner``/``within``, or ``element_owners`` of ``owner`` when it is
    a column). Returns ``((values, valid), dictionary)``."""
    from velox_tpu_torch.exec.operator import ExprEvaluator

    fcols = {p: c for p, c in lanes}
    names = [p for p, _ in lanes]
    types = [c.dtype for _, c in lanes]
    ecap = lanes[0][1].capacity
    caps = lambda_capture_names(lam.body, lam.params, batch)
    if caps:
        if isinstance(owner, (ArrayColumn, MapColumn)):
            from velox_tpu_torch.exec.collect_agg import element_owners

            owner, within = element_owners(owner.starts, owner.lengths,
                                           ecap)
        for n in caps:
            c = batch.column(n).gather(owner)
            fcols[n] = Column(c.dtype, c.values, and_valid(c.valid, within),
                              c.dictionary)
            names.append(n)
            types.append(c.dtype)
    ev = ExprEvaluator([lam.body], row_type(names, types))
    sel = torch.ones(ecap, dtype=torch.bool,
                     device=lanes[0][1].values.device)
    pairs, dicts = ev.project_pairs(Batch(fcols, sel))
    return pairs[0], dicts[0]


# ----------------------------------------------------- array functions

def _array_cum_sum(op, batch, e, out_t):
    """array_cum_sum: a running sum within each row; the elements after a
    NULL are NULL (Presto's rule)."""
    from velox_tpu_torch.exec.collect_agg import element_owners

    src = batch.column(e.args[0].name)
    ev, evd = src.elements.values, src.elements.valid
    wide = torch.float64 if ev.dtype.is_floating_point else torch.int64
    v0 = ev.to(wide)
    if evd is not None:
        v0 = torch.where(evd, v0, torch.zeros_like(v0))
    owner, within = element_owners(src.starts, src.lengths, ev.shape[0])
    st_of = take(src.starts, owner).to(torch.int64)
    p = torch.arange(ev.shape[0], device=ev.device)
    # a running sum restarted at each row's start: exact for integers,
    # and a float row never sees another row's values
    head = p == st_of
    from velox_tpu_torch.ops.groupby import segment_scan

    out = segment_scan(v0, head, "add")
    valid = within
    if evd is not None:
        nulls = segment_scan((~evd).to(torch.int64), head, "add")
        valid = valid & (nulls == 0)
    return ArrayColumn(out_t, src.starts, src.lengths,
                       Column(out_t.element, out, valid), src.valid)


def _array_normalize(op, batch, e, out_t):
    """array_normalize(a, p): x / ||x||_p; a zero norm returns the input
    (ArrayNormalize.h)."""
    from velox_tpu_torch.exec.collect_agg import element_owners

    src = batch.column(e.args[0].name)
    ev, evd = src.elements.values, src.elements.valid
    (pv, _), = evaluate_args(batch, [e.args[1]])
    x = ev.to(torch.float64)
    owner, within = element_owners(src.starts, src.lengths, ev.shape[0])
    contrib = torch.pow(x.abs(), take(pv.to(torch.float64), owner))
    keep = and_valid(within, evd)
    contrib = torch.where(keep, contrib, torch.zeros_like(contrib))
    cap = src.capacity
    sums = torch.zeros(cap + 1, dtype=torch.float64, device=ev.device)
    sums.index_add_(0, torch.where(within, owner, torch.full_like(
        owner, cap)), contrib)
    norm = torch.pow(sums[:cap], 1.0 / pv.to(torch.float64).clamp(
        min=1e-300))
    ne = take(norm, owner)
    out = torch.where(ne > 0, x / ne, x)
    return ArrayColumn(out_t, src.starts, src.lengths,
                       Column(out_t.element, out, evd), src.valid)


def _map_normalize(op, batch, e, out_t):
    """map_normalize(m): each value over the sum of the map's non-NULL
    values (MapNormalize.h)."""
    from velox_tpu_torch.exec.collect_agg import element_owners

    src = batch.column(e.args[0].name)
    vv, vvd = src.values.values, src.values.valid
    owner, within = element_owners(src.starts, src.lengths, vv.shape[0])
    x = vv.to(torch.float64)
    keep = and_valid(within, vvd)
    cap = src.capacity
    sums = torch.zeros(cap + 1, dtype=torch.float64, device=vv.device)
    sums.index_add_(0, torch.where(within, owner, torch.full_like(
        owner, cap)), torch.where(keep, x, torch.zeros_like(x)))
    se = take(sums[:cap], owner)
    out = torch.where(se != 0, x / se, x)
    return MapColumn(out_t, src.starts, src.lengths, src.keys,
                     Column(out_t.value, out, vvd), src.valid)


def _transform_with_index(op, batch, e, out_t):
    """transform_with_index(a, (x, i) -> body): the 1-based ordinal joins
    the element in the lambda's scope."""
    from velox_tpu_torch.exec.collect_agg import element_owners

    src = batch.column(e.args[0].name)
    lam = e.args[1]
    ecap = src.elements.capacity
    owner, within = element_owners(src.starts, src.lengths, ecap)
    p = torch.arange(ecap, dtype=torch.int64, device=owner.device)
    idx = p - take(src.starts, owner).to(torch.int64) + 1
    (vals, valid), d = eval_lambda(
        batch, lam, [(lam.params[0], src.elements),
                     (lam.params[1], Column(BIGINT, idx, None))],
        owner, within)
    return ArrayColumn(out_t, src.starts, src.lengths,
                       Column(out_t.element, vals, valid, d), src.valid)


def _shuffle(op, batch, e, out_t):
    """shuffle(a): a uniform random permutation within each row, from a
    generator seeded by ``os.urandom``."""
    src = batch.column(e.args[0].name)
    ex = expand(src.starts, src.lengths, batch.sel)
    ev, evd = gather_elem(src.elements, ex.src_idx)
    gen = torch.Generator(device=ev.device)
    gen.manual_seed(int.from_bytes(os.urandom(8), "little") >> 1)
    rnd = torch.randint(0, 1 << 62, (ex.ecap,), generator=gen,
                        device=ev.device)
    perm, _ = sort_within_rows(ex, [rnd])
    elem = Column(out_t.element, take(ev, perm), take_valid(evd, perm),
                  src.elements.dictionary)
    return ArrayColumn(out_t, ex.nst, ex.lens, elem, src.valid)


def _remove_nulls(op, batch, e, out_t):
    src = batch.column(e.args[0].name)
    ex = expand(src.starts, src.lengths, batch.sel)
    ev, evd = gather_elem(src.elements, ex.src_idx)
    perm, nst, kcnt = pack_rows(ex, and_valid(ex.in_run, evd),
                                batch.capacity)
    return ArrayColumn(out_t, nst, kcnt, Column(
        out_t.element, take(ev, perm), None, src.elements.dictionary),
        src.valid)


def _trim_array(op, batch, e, out_t):
    """trim_array(a, n): the last n elements dropped (offsets only)."""
    src = batch.column(e.args[0].name)
    (nv, _), = evaluate_args(batch, [e.args[1]])
    ln = src.lengths.to(torch.int64)
    new_len = torch.minimum((ln - nv.to(torch.int64)).clamp(min=0), ln)
    return ArrayColumn(out_t, src.starts, new_len, src.elements, src.valid)


def _sorted_elements(batch, src, descending: bool, nulls_first: bool):
    """Expand an ARRAY column and sort each row's elements."""
    ex = expand(src.starts, src.lengths, batch.sel)
    ev, evd = gather_elem(src.elements, ex.src_idx)
    ops = encode_sort_key(ev, evd, descending=descending,
                          nulls_first=nulls_first)
    perm, srow = sort_within_rows(ex, ops)
    return ex, ev, evd, ops, perm, srow


def _array_sort_desc(op, batch, e, out_t):
    src = batch.column(e.args[0].name)
    ex, ev, evd, _, perm, _ = _sorted_elements(batch, src, True, False)
    elem = Column(out_t.element, take(ev, perm), take_valid(evd, perm),
                  src.elements.dictionary)
    return ArrayColumn(out_t, ex.nst, ex.lens, elem, src.valid)


def _duplicate_runs(batch, src):
    """Sorted elements and, per slot, whether it repeats the previous
    (row, value)."""
    ex, ev, evd, ops, perm, srow = _sorted_elements(batch, src, False,
                                                    True)
    same_prev = ~run_heads([srow] + [take(k, perm) for k in ops])
    return ex, ev, evd, perm, srow, same_prev & (srow < ex.ecap)


def _array_duplicates(op, batch, e, out_t):
    """array_duplicates (ArrayDuplicates.cpp): the distinct values that
    occur more than once, ascending, NULL first."""
    src = batch.column(e.args[0].name)
    ex, ev, evd, perm, srow, same_prev = _duplicate_runs(batch, src)
    prev_same = torch.cat([same_prev[:1] & False, same_prev[:-1]])
    keep = same_prev & ~prev_same            # the 2nd of each run
    nst, kcnt, elem = _out_elements(
        batch.capacity, keep, srow, take(ev, perm), take_valid(evd, perm),
        ex.ecap, out_t.element, src.elements.dictionary)
    return ArrayColumn(out_t, nst, kcnt, elem, src.valid)


def _array_has_duplicates(op, batch, e, out_t):
    src = batch.column(e.args[0].name)
    _ex, _ev, _evd, _perm, srow, same_prev = _duplicate_runs(batch, src)
    return Column(BOOLEAN, count_by(srow, same_prev, batch.capacity) > 0,
                  src.valid)


def _top_n_keep(ex, srow, n_expr, batch):
    """Keep the first n slots of each row's sorted run."""
    (nv, _), = evaluate_args(batch, [n_expr])
    rows = srow.clamp(max=batch.capacity - 1)
    p = torch.arange(ex.ecap, dtype=torch.int64, device=srow.device)
    sord = p - take(ex.nst, rows)
    return (srow < ex.ecap) & (sord < take(nv.to(torch.int64), rows))


def _array_top_n(op, batch, e, out_t):
    """array_top_n(a, n): the n largest elements, descending, NULLs last
    (ArrayTopN)."""
    src = batch.column(e.args[0].name)
    ex, ev, evd, _, perm, srow = _sorted_elements(batch, src, True, False)
    keep = _top_n_keep(ex, srow, e.args[1], batch)
    nst, kcnt, elem = _out_elements(
        batch.capacity, keep, srow, take(ev, perm), take_valid(evd, perm),
        ex.ecap, out_t.element, src.elements.dictionary)
    return ArrayColumn(out_t, nst, kcnt, elem, src.valid)


# ------------------------------------------------------- map functions

def _pack_map(src: MapColumn, out_t, keep, cap: int, owner):
    kcnt = count_by(owner, keep, cap)
    perm = pack_indices(keep, src.keys.capacity)
    return MapColumn(out_t, offsets(kcnt), kcnt, pack_column(src.keys, perm),
                     pack_column(src.values, perm), src.valid)


def _lit_array_values(e) -> list:
    if not (isinstance(e, Call) and e.name == "array_constructor"
            and all(isinstance(a, Literal) for a in e.args)):
        raise TypeError("expected a literal ARRAY[...] argument")
    return [a.value for a in e.args]


def _map_key_pred(op, batch, e, out_t, mode):
    """map_subset / map_intersect keep the keys in the set; map_except
    drops them (MapSubset.h, MapIntersect.h, MapExcept.h)."""
    from velox_tpu_torch.exec.collect_agg import element_owners

    src = batch.column(e.args[0].name)
    lits = _lit_array_values(e.args[1])
    d = src.keys.dictionary
    codes = [d.code_of(v) for v in lits] if d is not None else lits
    kv = src.keys.values
    owner, within = element_owners(src.starts, src.lengths, kv.shape[0])
    hit = torch.zeros(kv.shape, dtype=torch.bool, device=kv.device)
    for c in codes:
        hit |= kv == c
    keep = within & (hit if mode == "keep" else ~hit)
    return _pack_map(src, out_t, keep, batch.capacity, owner)


def _map_values_in_range(op, batch, e, out_t):
    """The entries whose value is in [lo, hi]; a NULL bound is not
    applied and NULL values stay (MapValuesInRange.h)."""
    from velox_tpu_torch.exec.collect_agg import element_owners

    src = batch.column(e.args[0].name)
    (lo, lov), (hi, hiv) = evaluate_args(batch, e.args[1:])
    vv, vvd = src.values.values, src.values.valid
    owner, within = element_owners(src.starts, src.lengths, vv.shape[0])
    loe = take(lo, owner).to(vv.dtype)
    hie = take(hi, owner).to(vv.dtype)
    ok = (vv >= loe) & (vv <= hie)
    if lov is not None:
        ok |= ~take(lov, owner) & (vv <= hie)
    if hiv is not None:
        ok |= ~take(hiv, owner) & (vv >= loe)
    if vvd is not None:
        ok |= ~vvd
    return _pack_map(src, out_t, within & ok, batch.capacity, owner)


def _map_remove_null_values(op, batch, e, out_t):
    from velox_tpu_torch.exec.collect_agg import element_owners

    src = batch.column(e.args[0].name)
    owner, within = element_owners(src.starts, src.lengths,
                                   src.values.capacity)
    return _pack_map(src, out_t, and_valid(within, src.values.valid),
                     batch.capacity, owner)


def _map_top_n_perm(src, batch, n_expr, by):
    """Map entries sorted within each row by value descending (ties by
    key descending, MapTopNImpl.h) or by key descending, and the first n
    of each row kept."""
    ex = expand(src.starts, src.lengths, batch.sel)
    kv, kvd = gather_elem(src.keys, ex.src_idx)
    vv, vvd = gather_elem(src.values, ex.src_idx)
    ops = encode_sort_key(kv, kvd, descending=True)
    if by == "value":
        ops = encode_sort_key(vv, vvd, descending=True) + ops
    perm, srow = sort_within_rows(ex, ops)
    keep = _top_n_keep(ex, srow, n_expr, batch)
    return ex, perm, srow, keep, (kv, kvd), (vv, vvd)


def _map_top_n(op, batch, e, out_t):
    src = batch.column(e.args[0].name)
    ex, perm, srow, keep, (kv, kvd), (vv, vvd) = _map_top_n_perm(
        src, batch, e.args[1], "value")
    cap = batch.capacity
    nst, kcnt, kcol = _out_elements(cap, keep, srow, take(kv, perm),
                                    take_valid(kvd, perm), ex.ecap,
                                    out_t.key, src.keys.dictionary)
    _, _, vcol = _out_elements(cap, keep, srow, take(vv, perm),
                               take_valid(vvd, perm), ex.ecap, out_t.value,
                               src.values.dictionary)
    return MapColumn(out_t, nst, kcnt, kcol, vcol, src.valid)


def _map_top_n_lane(op, batch, e, out_t, by, lane):
    src = batch.column(e.args[0].name)
    ex, perm, srow, keep, kpair, vpair = _map_top_n_perm(
        src, batch, e.args[1], by)
    (v, vd), dic = ((kpair, src.keys.dictionary) if lane == "key"
                    else (vpair, src.values.dictionary))
    nst, kcnt, col = _out_elements(batch.capacity, keep, srow, take(v, perm),
                                   take_valid(vd, perm), ex.ecap,
                                   out_t.element, dic)
    return ArrayColumn(out_t, nst, kcnt, col, src.valid)


def _map_ctor(op, batch, e, out_t):
    """map(keys_array, values_array) (MapFunctions.h map()): entry i of a
    row pairs the i-th elements of both arrays."""
    karr = batch.column(e.args[0].name)
    varr = batch.column(e.args[1].name)
    ex = expand(karr.starts, karr.lengths, batch.sel)
    kv, kvd = gather_elem(karr.elements, ex.src_idx)
    vidx = take(varr.starts, ex.row_of) + ex.ordinal
    in_v = ex.ordinal < take(varr.lengths, ex.row_of)
    vv, vvd = gather_elem(varr.elements, vidx)
    return MapColumn(out_t, ex.nst, ex.lens,
                     Column(out_t.key, kv, kvd, karr.elements.dictionary),
                     Column(out_t.value, vv, and_valid(in_v, vvd),
                            varr.elements.dictionary),
                     null_rows([karr, varr]))


def _map_from_entries(op, batch, e, out_t):
    """map_from_entries(ARRAY(ROW(k, v))): the entries' children become
    the key and value lanes, offsets shared."""
    src = batch.column(e.args[0].name)
    if not isinstance(src.elements, RowColumn):
        raise TypeError("map_from_entries expects ARRAY(ROW(k, v)) elements")
    k, v = src.elements.children[:2]
    return MapColumn(out_t, src.starts, src.lengths,
                     Column(out_t.key, k.values, k.valid, k.dictionary),
                     Column(out_t.value, v.values, v.valid, v.dictionary),
                     src.valid)


def _remap_keys(op, batch, e, out_t):
    """remap_keys(m, ARRAY[from...], ARRAY[to...]) with literal arrays
    (RemapKeys.h): string keys get a renamed dictionary, others a chain
    of selects."""
    src = batch.column(e.args[0].name)
    frm = _lit_array_values(e.args[1])
    to = _lit_array_values(e.args[2])
    kv, dic = src.keys.values, src.keys.dictionary
    if dic is not None:
        ren = dict(zip(frm, to))
        out_vals = [ren.get(str(v), str(v)) for v in dic.values]
        nd = Dictionary(sorted(set(out_vals)))
        table = torch.tensor([nd.code_of(v) for v in out_vals] or [0],
                             dtype=kv.dtype, device=kv.device)
        nk = torch.where(kv < 0, kv, take(table, kv))
        kcol = Column(out_t.key, nk, src.keys.valid, nd)
    else:
        nk = kv
        for f, t in zip(frm, to):
            nk = torch.where(kv == f, torch.full_like(kv, t), nk)
        kcol = Column(out_t.key, nk, src.keys.valid)
    return MapColumn(out_t, src.starts, src.lengths, kcol, src.values,
                     src.valid)


def _split_to_map(op, batch, e, out_t, multi: bool):
    """split_to_map / split_to_multimap(s, entry_delim, kv_delim)
    (SplitToMap.h): each distinct string is split once on the host into
    flat entry tables; the device does one expansion and gathers.
    split_to_map keeps a duplicate key's LAST value; split_to_multimap
    keeps every entry."""
    codes_col = batch.column(e.args[0].name)
    d = codes_col.dictionary
    if d is None:
        raise TypeError("split_to_map requires a dictionary column")
    ed, kd = e.args[1].value, e.args[2].value
    per_code = []
    for v in d.values:
        s = str(v)
        entries, seen = [], {}
        for part in (s.split(ed) if s else []):
            if not part:
                continue
            k, _, val = part.partition(kd)
            if multi:
                entries.append((k, val))
            else:
                seen[k] = val
        per_code.append(entries if multi else list(seen.items()))
    counts = np.asarray([0] + [len(x) for x in per_code], np.int64)
    flat_k = [k for ent in per_code for k, _ in ent]
    flat_v = [v for ent in per_code for _, v in ent]
    kdic = Dictionary(sorted(set(flat_k)))
    vdic = Dictionary(sorted(set(flat_v)))
    dev = codes_col.values.device
    ent_start = torch.from_numpy(np.cumsum(counts)[:-1].copy()).to(dev)
    kv = codes_col.values
    cnt = take(torch.from_numpy(counts).to(dev), kv.to(torch.int64) + 1)
    ex = expand(torch.zeros_like(cnt), cnt,
                and_valid(batch.sel, codes_col.valid))
    base = take(ent_start, take(kv, ex.row_of))
    src_idx = base + ex.ordinal
    fk = torch.tensor([kdic.code_of(k) for k in flat_k] or [0],
                      dtype=torch.int32, device=dev)
    fv = torch.tensor([vdic.code_of(v) for v in flat_v] or [0],
                      dtype=torch.int32, device=dev)
    return MapColumn(out_t, ex.nst, ex.lens,
                     Column(out_t.key, take(fk, src_idx), None, kdic),
                     Column(out_t.value, take(fv, src_idx), None, vdic),
                     codes_col.valid)


def _typeof(op, batch, e, out_t):
    """typeof(x): the argument's type name as a constant string
    (TypeOfFunction.h)."""
    src = e.args[0]
    name = str(src.dtype).lower() if src.dtype is not None else "unknown"
    return Column(VARCHAR, torch.zeros(batch.capacity, dtype=torch.int32,
                                       device=batch.device),
                  None, Dictionary([name]))


def _array_join(op, batch, e, out_t):
    """array_join(a, delim [, null_replacement]) -> VARCHAR
    (ArrayJoin.h): a new string a row, so the rows' elements go to the
    host once."""
    src = batch.column(e.args[0].name)
    delim = str(e.args[1].value)
    null_rep = (str(e.args[2].value)
                if len(e.args) > 2 and e.args[2].value is not None else None)
    starts = syncs.to_numpy(src.starts)
    lens = syncs.to_numpy(src.lengths)
    ev = syncs.to_numpy(src.elements.values)
    evd = (None if src.elements.valid is None
           else syncs.to_numpy(src.elements.valid))
    d = src.elements.dictionary
    sel = syncs.to_numpy(batch.sel)
    outs = []
    for i in range(starts.shape[0]):
        if not sel[i]:
            outs.append("")
            continue
        parts = []
        for j in range(starts[i], starts[i] + lens[i]):
            if evd is not None and not evd[j]:
                if null_rep is not None:
                    parts.append(null_rep)
                continue
            v = ev[j]
            if d is not None:
                parts.append(str(d.values[v]) if v >= 0 else "")
            elif isinstance(v, (float, np.floating)):
                parts.append(repr(float(v)))
            else:
                parts.append(str(v))
        outs.append(delim.join(parts))
    uniq = Dictionary(sorted(set(outs)))
    codes = torch.tensor([uniq.code_of(s) for s in outs], dtype=torch.int32,
                         device=batch.device)
    return Column(VARCHAR, codes, src.valid, uniq)


def _array_constructor(op, batch, e, out_t):
    """ARRAY[e1, ..., ek] over scalar expressions (ArrayConstructor.h):
    k interleaved lanes a row; a NULL entry is a NULL element and the
    array itself is never NULL."""
    from velox_tpu_torch import torch_dtype

    k = len(e.args)
    cap = batch.capacity
    dev = batch.device
    if k == 0:
        zero = torch.zeros(cap, dtype=torch.int32, device=dev)
        return ArrayColumn(out_t, zero, zero, Column(
            out_t.element, torch.zeros(1, dtype=torch.int64, device=dev)))
    from velox_tpu_torch.exec.operator import ExprEvaluator

    pairs, dicts = ExprEvaluator(list(e.args),
                                 batch.schema).project_pairs(batch)
    lane = torch_dtype(out_t.element.dtype)
    vals = torch.stack([v.to(lane) for v, _ in pairs], 1).reshape(-1)
    valid = None
    if any(vd is not None for _, vd in pairs):
        valid = torch.stack([
            vd if vd is not None else torch.ones(cap, dtype=torch.bool,
                                                 device=dev)
            for _, vd in pairs], 1).reshape(-1)
    dic = next((d for d in dicts if d is not None), None)
    starts = torch.arange(cap, dtype=torch.int64, device=dev) * k
    return ArrayColumn(out_t, starts, torch.full((cap,), k, dtype=torch.int64,
                                                 device=dev),
                       Column(out_t.element, vals, valid, dic), None)


def _flatten(op, batch, e, out_t):
    """flatten(ARRAY(ARRAY(T))) -> ARRAY(T): the inner arrays
    concatenated, NULL inner arrays skipped (ArrayFlatten.cpp). Two
    chained expansions: outer rows to inner-array slots, slots to
    elements."""
    src = batch.column(e.args[0].name)
    inner = src.elements
    if not isinstance(inner, ArrayColumn):
        raise TypeError("flatten expects nested arrays")
    cap = batch.capacity
    ex1 = expand(src.starts, src.lengths, and_valid(batch.sel, src.valid))
    in_starts = take(inner.starts, ex1.src_idx)
    in_lens = take(inner.lengths, ex1.src_idx).to(torch.int64)
    live = and_valid(ex1.in_run, take_valid(inner.valid, ex1.src_idx))
    in_lens = torch.where(live, in_lens, torch.zeros_like(in_lens))
    out_lens = torch.zeros(cap + 1, dtype=torch.int64, device=in_lens.device)
    out_lens.index_add_(0, ex1.row_of.clamp(max=cap), in_lens)
    out_lens = out_lens[:cap]
    ex2 = expand(in_starts, in_lens, torch.ones_like(live))
    ev, evd = gather_elem(inner.elements, ex2.src_idx)
    return ArrayColumn(out_t, offsets(out_lens), out_lens, Column(
        out_t.element, ev, evd, inner.elements.dictionary), src.valid)


def union_codes(ka: Column, kb: Column):
    """Two lanes in one code space: for strings, the codes in the sorted
    union of both dictionaries, as (dictionary, codes a, codes b);
    unchanged when no lane is a string or both share one dictionary."""
    if ka.dictionary is None and kb.dictionary is None:
        return None, ka.values, kb.values
    if ka.dictionary is kb.dictionary:
        return ka.dictionary, ka.values, kb.values
    va = np.asarray(ka.dictionary.values).astype(str)
    vb = np.asarray(kb.dictionary.values).astype(str)
    union = np.unique(np.concatenate([va, vb]))
    dev = ka.values.device

    def remap(col, vals):
        t = torch.from_numpy(np.concatenate(
            [[-1], np.searchsorted(union, vals)]).astype(np.int32)).to(dev)
        return take(t, col.values.to(torch.int64) + 1)

    return Dictionary([str(u) for u in union]), remap(ka, va), remap(kb, vb)


def _map_zip_with(op, batch, e, out_t):
    """map_zip_with(m1, m2, (k, v1, v2) -> body) (MapZipWith.h): the two
    maps merged on the union of their keys, the lambda over the flat
    (k, v1, v2) lanes. Both entry runs concatenate, sort by (row, key),
    and adjacent equal keys collapse."""
    ca = batch.column(e.args[0].name)
    cb = batch.column(e.args[1].name)
    lam = e.args[2]
    cap = batch.capacity
    nv = null_rows([ca, cb])
    row_live = and_valid(batch.sel, nv)
    kdic, kav, kbv = union_codes(ca.keys, cb.keys)
    zero = torch.zeros((), dtype=torch.int64, device=batch.device)
    la = torch.where(row_live, ca.lengths.to(torch.int64), zero)
    lb = torch.where(row_live, cb.lengths.to(torch.int64), zero)
    lens = la + lb
    ex = expand(offsets(lens), lens, row_live)
    ra_len = take(la, ex.row_of)
    from_a = ex.ordinal < ra_len

    def side(col, kv, ord_):
        idx = take(col.starts, ex.row_of) + ord_
        return take(kv, idx), take(col.values.values, idx), \
            take_valid(col.values.valid, idx)

    ak, av, avd = side(ca, kav, ex.ordinal)
    bk, bv, bvd = side(cb, kbv, ex.ordinal - ra_len)
    key = torch.where(from_a, ak.to(torch.int64), bk.to(torch.int64))
    perm = sort_indices([(ex.row_of, None, False, False),
                         (key, None, False, False)], ex.in_run)
    srow, skey = take(ex.row_of, perm), take(key, perm)
    sfrom_a = take(from_a, perm)
    sav, sbv = take(av, perm), take(bv, perm)
    savd, sbvd = take_valid(avd, perm), take_valid(bvd, perm)
    ssel = take(ex.in_run, perm)
    prev_same = torch.cat([torch.zeros(1, dtype=torch.bool,
                                       device=srow.device),
                           (srow[1:] == srow[:-1]) & (skey[1:] == skey[:-1])])
    next_same = torch.cat([prev_same[1:], prev_same[:1] & False])
    keep = ssel & ~prev_same
    nxt = (torch.arange(ex.ecap, device=srow.device) + 1).clamp(
        max=ex.ecap - 1)
    v1, v1d = sav, and_valid(sfrom_a, savd)
    both = sfrom_a & next_same
    v2 = torch.where(both, take(sbv, nxt),
                     torch.where(sfrom_a, torch.zeros_like(sbv), sbv))
    ones = torch.ones_like(sfrom_a)
    v2d = torch.where(both, take(sbvd, nxt) if sbvd is not None else ones,
                      and_valid(~sfrom_a, sbvd))
    ecap = ex.ecap
    out_lens = count_by(srow, keep, cap)
    out_lens = torch.where(row_live, out_lens, torch.zeros_like(out_lens))
    kperm = pack_indices(keep, ecap)
    fk = take(skey, kperm).to(ca.keys.values.dtype)
    frow = take(srow, kperm)
    within = torch.arange(ecap, device=srow.device) < out_lens.sum()
    kt = ca.dtype.key
    kp, p1, p2 = lam.params
    (vals, valid), d = eval_lambda(batch, lam, [
        (kp, Column(kt, fk, None, kdic)),
        (p1, Column(ca.dtype.value, take(v1, kperm), take(v1d, kperm),
                    ca.values.dictionary)),
        (p2, Column(cb.dtype.value, take(v2, kperm), take(v2d, kperm),
                    cb.values.dictionary))], frow, within)
    return MapColumn(out_t, offsets(out_lens), out_lens,
                     Column(kt, fk, None, kdic),
                     Column(out_t.value, vals, valid, d), nv)


# ---- the host-built long tail: new nested values per row, as
# array_join's strings are


def _rebuild(batch, out_t, rows):
    return make_any_column(out_t, rows, batch.capacity, batch.device)


def _rows(batch, name):
    return batch.column(name).to_pylist(batch.capacity)


def _ngrams(op, batch, e, out_t):
    """ngrams(ARRAY(T), n) -> ARRAY(ARRAY(T)); fewer than n elements give
    one gram of the whole array (ArrayNgramsFunctions.h)."""
    n = int(e.args[1].value)
    out = [None if r is None else [r] if len(r) <= n
           else [r[i:i + n] for i in range(len(r) - n + 1)]
           for r in _rows(batch, e.args[0].name)]
    return _rebuild(batch, out_t, out)


def _combinations(op, batch, e, out_t):
    """combinations(ARRAY(T), k), k <= 5, in lexicographic index order
    (ArrayCombinationsFunction)."""
    k = int(e.args[1].value)
    if not 0 <= k <= 5:
        raise ValueError("combinations supports k in [0, 5]")
    out = [None if r is None else [list(c) for c in
                                   itertools.combinations(r, k)]
           for r in _rows(batch, e.args[0].name)]
    return _rebuild(batch, out_t, out)


def _array_frequency(op, batch, e, out_t):
    """array_frequency(ARRAY(T)) -> MAP(T, INTEGER): each element's count,
    NULLs skipped, keys in first-seen order."""
    out = []
    for r in _rows(batch, e.args[0].name):
        if r is None:
            out.append(None)
            continue
        cnt = {}
        for v in r:
            if v is not None:
                cnt[v] = cnt.get(v, 0) + 1
        out.append(list(cnt.items()))
    return _rebuild(batch, out_t, out)


def _multimap_from_entries(op, batch, e, out_t):
    """multimap_from_entries(ARRAY(ROW(K, V))) -> MAP(K, ARRAY(V)): every
    value of a key, in order. An entry with a NULL key is dropped (the
    JAX package's form; Presto raises)."""
    out = []
    for r in _rows(batch, e.args[0].name):
        if r is None:
            out.append(None)
            continue
        grouped = {}
        for ent in r:
            if ent is None:
                continue
            k, v = list(ent.values()) if isinstance(ent, dict) else ent
            if k is not None:
                grouped.setdefault(k, []).append(v)
        out.append(list(grouped.items()))
    return _rebuild(batch, out_t, out)


def _cosine_similarity(op, batch, e, out_t):
    """cosine_similarity(MAP(VARCHAR, DOUBLE), MAP(VARCHAR, DOUBLE)): the
    dot product over shared keys over the norms' product; NULL for an
    empty or zero-norm map."""
    ra = _rows(batch, e.args[0].name)
    rb = _rows(batch, e.args[1].name)
    vals = np.zeros(batch.capacity, np.float64)
    valid = np.zeros(batch.capacity, bool)
    for i, (ma, mb) in enumerate(zip(ra, rb)):
        if ma is None or mb is None:
            continue
        da, db = dict(ma), dict(mb)
        na = math.sqrt(sum(v * v for v in da.values() if v is not None))
        nb = math.sqrt(sum(v * v for v in db.values() if v is not None))
        if na == 0.0 or nb == 0.0:
            continue
        dot = sum(va * db[k] for k, va in da.items()
                  if va is not None and db.get(k) is not None)
        vals[i], valid[i] = dot / (na * nb), True
    return Column(DOUBLE, torch.from_numpy(vals).to(batch.device),
                  torch.from_numpy(valid).to(batch.device))


def _array_split_into_chunks(op, batch, e, out_t):
    """array_split_into_chunks(ARRAY(T), n): consecutive chunks of n, the
    last one ragged."""
    n = int(e.args[1].value)
    if n <= 0:
        raise ValueError("chunk size must be positive")
    out = [None if r is None else [r[i:i + n] for i in range(0, len(r), n)]
           for r in _rows(batch, e.args[0].name)]
    return _rebuild(batch, out_t, out)


#: name -> applier; ProjectOp dispatches any top-level Call here
EXT_APPLIERS = {
    "array_cum_sum": _array_cum_sum,
    "array_normalize": _array_normalize,
    "map_normalize": _map_normalize,
    "transform_with_index": _transform_with_index,
    "shuffle": _shuffle,
    "remove_nulls": _remove_nulls,
    "trim_array": _trim_array,
    "array_sort_desc": _array_sort_desc,
    "array_duplicates": _array_duplicates,
    "array_has_duplicates": _array_has_duplicates,
    "array_top_n": _array_top_n,
    "map_subset": lambda op, b, e, t: _map_key_pred(op, b, e, t, "keep"),
    "map_intersect": lambda op, b, e, t: _map_key_pred(op, b, e, t, "keep"),
    "map_except": lambda op, b, e, t: _map_key_pred(op, b, e, t, "drop"),
    "map_values_in_range": _map_values_in_range,
    "map_remove_null_values": _map_remove_null_values,
    "map_top_n": _map_top_n,
    "map_top_n_keys": lambda op, b, e, t: _map_top_n_lane(
        op, b, e, t, "key", "key"),
    "map_top_n_values": lambda op, b, e, t: _map_top_n_lane(
        op, b, e, t, "value", "value"),
    "map_keys_by_top_n_values": lambda op, b, e, t: _map_top_n_lane(
        op, b, e, t, "value", "key"),
    "map": _map_ctor,
    "map_from_entries": _map_from_entries,
    "remap_keys": _remap_keys,
    "split_to_map": lambda op, b, e, t: _split_to_map(op, b, e, t, False),
    "split_to_multimap": lambda op, b, e, t: _split_to_map(op, b, e, t,
                                                           True),
    "typeof": _typeof,
    "array_join": _array_join,
    "array_constructor": _array_constructor,
    "flatten": _flatten,
    "map_zip_with": _map_zip_with,
    "ngrams": _ngrams,
    "combinations": _combinations,
    "array_frequency": _array_frequency,
    "multimap_from_entries": _multimap_from_entries,
    "cosine_similarity": _cosine_similarity,
    "array_split_into_chunks": _array_split_into_chunks,
}
