"""Collect-mode aggregation finish (the port of the JAX package's
``exec/collect_agg.py`` for its scalar- and blob-valued kinds).

``HashAggregationOp`` in mode "collect" buffers its raw input batches and
calls :func:`finish_collect` once: one global grouping of every row
(``group_ids_sorted``), the scatter aggregates run once against the final
group ids (``_scalar_result``: all rows are present, so no partial and
merge round; one slot a group), and each collect aggregate sorts its rows into
group-contiguous runs (``collect_runs``):

* ``percentile``: the exact ``approx_percentile`` (float32 position);
* ``winsorized``: ``approx_winsorized_mean``, the mean after clamping to
  the exact [lo, hi] quantile values;
* ``digest`` / ``digest_merge``: ``tdigest_agg``/``qdigest_agg`` blobs
  built on the host from each group's value-sorted run, and ``merge`` of
  blobs in row order (``_digest_column``);
* ``hll`` / ``khll``: ``approx_set``, ``make_set_digest`` and
  ``khyperloglog_agg`` (``_sketch_column``). The values are hashed once
  each (integers on the device), and what a blob keeps is chosen on the
  device: HyperLogLog registers by one scatter-max, a SetDigest's 2048
  smallest distinct hashes and a KHyperLogLog's 512 smallest x-hashes
  with their 32 smallest uii-hashes by one sort each; the host writes
  the blobs, byte for byte the JAX package's.

* ``array``/``set``/``set_union``/``histogram``/``map``/``multimap``/
  ``map_union``/``map_union_sum``: each group's elements are one run of a
  sorted element column, which is the ARRAY/MAP column's layout. The
  kinds over an ARRAY or MAP input (``set_union``, ``map_union``,
  ``map_union_sum``) give each flat element its row's group id
  (``element_owners``).

Blob columns are VARBINARY over a sorted dictionary of the group blobs.
The output keeps the group slots (a power of two at least the group
count), not the input's capacity.

* ``most_frequent``/``numeric_histogram``/``vector_sum``/``reservoir``/
  ``classification``: one sub-grouping by (group, value, bucket or
  position) whose representatives carry their counts or sums, laid out
  as group runs; ``reduce`` folds each group's run by its lambda with a
  segmented doubling scan (``_segmented_scan``).

A PARTIAL step of ``array_agg``/``set_agg``/``map_agg`` names its page
column ``name$0`` (``op._collect_suffix``).
"""

from __future__ import annotations

import base64
import struct
from typing import Dict, List

import numpy as np
import torch

from velox_tpu_torch.exec.complex_fns import take, take_valid
from velox_tpu_torch.functions import sketch as SK
from velox_tpu_torch.functions.aggregates import init_lane
from velox_tpu_torch.functions.aggregates_collect import (
    collect_runs, f32_positions, first_masked, percentile_values,
)
from velox_tpu_torch.functions.digest import build_group_digests
from velox_tpu_torch.ops.groupby import group_ids_sorted
from velox_tpu_torch.ops.sort import lex_sort
from velox_tpu_torch.ops.sortkey import encode_sort_key
from velox_tpu_torch.types.types import TypeKind
from velox_tpu_torch.utils import syncs
from velox_tpu_torch.vector.batch import Batch, round_capacity
from velox_tpu_torch.vector.column import (
    ArrayColumn, Column, Dictionary, MapColumn, element_capacity,
)

#: the int64 with only the sign bit: XOR maps unsigned order to signed
_SIGN = -(1 << 63)

#: seconds spent building blobs (from the sorted runs to the blob column,
#: the host's formatting and the device work it waits on) since the last
#: ``reset_blob_seconds``
blob_seconds = 0.0


def reset_blob_seconds() -> None:
    global blob_seconds
    blob_seconds = 0.0


def element_owners(starts: torch.Tensor, lengths: torch.Tensor, ecap: int):
    """Flat element index -> owning row, and whether the element lies in
    that row's range. Needs ``starts`` ascending over the rows with
    ``lengths > 0`` (the offsets every constructor and ``concat_batches``
    make; ``ops/window.py`` ``run_owners``)."""
    from velox_tpu_torch.ops.window import run_owners

    cap = starts.shape[0]
    owner = run_owners(starts, lengths > 0, ecap)
    osafe = owner.clamp(min=0)
    e = torch.arange(ecap, dtype=torch.int64, device=starts.device)
    end = (starts.to(torch.int64) + lengths.to(torch.int64)).index_select(
        0, osafe.clamp(max=max(cap - 1, 0)))
    return osafe, (owner >= 0) & (e < end)


def _spec_mask(spec, cols, sel):
    """Row mask of one aggregate: the batch selection AND its mask."""
    m = sel
    if spec.mask is not None:
        mv, mvd = cols[spec.mask]
        m = torch.logical_and(m, mv)
        if mvd is not None:
            m = m & mvd
    return m


def _and_valid(m, valid):
    return m if valid is None else m & valid


def finish_collect(op, big: Batch) -> Batch:
    """Run the whole aggregation (scatter and collect aggregates) over
    ``big``, the concatenation of every input batch."""
    cap = big.capacity
    cols = {n: (big.column(n).values, big.column(n).valid)
            for n in op._needed if isinstance(big.column(n), Column)}
    sel = big.sel
    key_pairs = [cols[k] for k in op.keys]
    gids, group_rows, group_sel, ng = group_ids_sorted(key_pairs, sel)
    if not op.keys:
        # a global aggregation emits one row, even on empty input
        group_sel = torch.zeros_like(group_sel)
        group_sel[0] = True
    n_groups = max(syncs.to_int(ng), 1)
    out_cap = min(round_capacity(n_groups), cap)
    slots = slice(0, out_cap)

    out: Dict[str, Column] = {}
    for k, (v, va) in zip(op.keys, key_pairs):
        rows = group_rows[slots]
        kt = op.output_type.find_child(k)
        out[k] = Column(kt, v.index_select(0, rows),
                        None if va is None else va.index_select(0, rows),
                        big.column(k).dictionary)
    gsel = group_sel[slots]
    for i, (name, spec, fn) in enumerate(zip(op.agg_names, op.specs,
                                             op.fns)):
        m = _spec_mask(spec, cols, sel)
        kind = fn.collect_kind
        name = name + op._collect_suffix   # a PARTIAL page is name$0
        t = op.output_type.find_child(name)
        if kind is None:
            vals, valid = _scalar_result(op, i, fn, spec, cols, gids, m,
                                         group_sel[:n_groups], n_groups)
            out[name] = op._agg_column(name, _pad(vals, out_cap),
                                       _pad(valid, out_cap))
        elif kind == "percentile":
            vf, qf = spec.arg
            vv, vvd = cols[vf]
            mm = _and_valid(m, vvd)
            q = cols[qf][0].index_select(0, first_masked(mm)[None])[0]
            vals, ok = percentile_values(
                gids, vv, encode_sort_key(vv, None), mm, q)
            out[name] = Column(t, vals[slots], (group_sel & ok)[slots])
        elif kind == "reduce":
            vals, valid = _reduce(big, spec, cols, gids, m, group_sel,
                                  out_cap)
            out[name] = Column(t, vals, valid)
        elif kind == "winsorized":
            mean, ok = _winsorized(spec, cols, gids, m, n_groups)
            out[name] = Column(t, _pad(mean, out_cap), _pad(
                group_sel[:n_groups] & ok, out_cap))
        elif kind in ("digest", "digest_merge"):
            out[name] = _digest_column(big, t, spec, fn, cols, gids, m,
                                       n_groups, out_cap)
        elif kind in ("hll", "khll"):
            out[name] = _sketch_column(big, t, spec, fn, cols, gids, m,
                                       n_groups, out_cap)
        elif kind in _COMPLEX_FINISH:
            out[name] = _COMPLEX_FINISH[kind](big, t, spec, cols, gids, m,
                                              group_sel, out_cap)
        else:
            raise NotImplementedError(kind)
    return Batch(out, gsel)


# ---- the ARRAY- and MAP-valued kinds: each group's elements are one run
# of a sorted element column, which IS the ArrayColumn/MapColumn layout
# (velox/functions/prestosql/aggregates/ArrayAggAggregate.cpp,
# MapAggAggregate.cpp, MapUnionAggregate.cpp, HistogramAggregate.cpp)

def _group_valid(group_sel, counts, out_cap):
    """A group with no element is NULL, as Presto's array_agg is."""
    return _pad(group_sel, out_cap) & (_pad(counts, out_cap) > 0)


def _array_out(t, out_cap, group_sel, counts, starts, ev, evd, d):
    return ArrayColumn(t, _pad(starts, out_cap), _pad(counts, out_cap),
                       Column(t.element, ev, evd, d),
                       _group_valid(group_sel, counts, out_cap))


def _map_out(t, out_cap, group_sel, counts, starts, keys: Column,
             values) -> MapColumn:
    return MapColumn(t, _pad(starts, out_cap), _pad(counts, out_cap), keys,
                     values, _group_valid(group_sel, counts, out_cap))


def _pairs(gids, values, mm, cap):
    """Sub-grouping by (group, value): each distinct pair's group id
    (``cap`` where none), its value, and how many rows it holds, at the
    pair slots."""
    g2, rows2, sel2, _ = group_ids_sorted([(gids, None), (values, None)], mm)
    cnt = torch.zeros(cap + 1, dtype=torch.int64, device=gids.device)
    cnt.index_add_(0, g2.clamp(max=cap), mm.to(torch.int64))
    pgid = torch.where(sel2, take(gids, rows2),
                       torch.full_like(gids, cap))
    return pgid, take(values, rows2), cnt[:cap], sel2


def _finish_array(big, t, spec, cols, gids, m, group_sel, out_cap):
    """array_agg / set_agg: each group's values in row order (set_agg:
    the first of each distinct value)."""
    from velox_tpu_torch.functions.aggregates_collect import dedupe_first

    av, avd = cols[spec.arg]
    if spec.fn == "set_agg":
        m = dedupe_first(gids, encode_sort_key(av, avd), m)
    perm, counts, starts = collect_runs(gids, m)
    return _array_out(t, out_cap, group_sel, counts, starts, take(av, perm),
                      take_valid(avd, perm), big.column(spec.arg).dictionary)


def _element_groups(col, gids, m):
    """Each flat element of an ARRAY/MAP input column: its row's group
    id, ``ecap`` where the element is out of range or its row is masked
    or NULL."""
    flat = col.keys if isinstance(col, MapColumn) else col.elements
    ecap = flat.capacity
    owner, within = element_owners(col.starts, col.lengths, ecap)
    arow = m if col.valid is None else m & col.valid
    live = within & take(arow, owner)
    return torch.where(live, take(gids, owner),
                       torch.full_like(owner, ecap))


def _finish_set_union(big, t, spec, cols, gids, m, group_sel, out_cap):
    """set_union(ARRAY): the distinct elements of a group's arrays, each
    at its first appearance."""
    from velox_tpu_torch.functions.aggregates_collect import dedupe_first

    col = big.column(spec.arg)
    el = col.elements
    egid = _element_groups(col, gids, m)
    keep = dedupe_first(egid, encode_sort_key(el.values, el.valid),
                        egid < el.capacity)
    perm, counts, starts = collect_runs(egid, keep)
    return _array_out(t, out_cap, group_sel, counts, starts,
                      take(el.values, perm), take_valid(el.valid, perm),
                      el.dictionary)


def _finish_histogram(big, t, spec, cols, gids, m, group_sel, out_cap):
    """histogram(x): each distinct non-NULL value and its count, values
    ascending."""
    cap = gids.shape[0]
    av, avd = cols[spec.arg]
    pgid, pk, cnt, sel2 = _pairs(gids, av, _and_valid(m, avd), cap)
    perm, counts, starts = collect_runs(pgid, sel2)
    return _map_out(t, out_cap, group_sel, counts, starts,
                    Column(t.key, take(pk, perm), None,
                           big.column(spec.arg).dictionary),
                    Column(t.value, take(cnt, perm), None))


def _finish_map(big, t, spec, cols, gids, m, group_sel, out_cap):
    """map_agg(k, v): the first value of each non-NULL key."""
    from velox_tpu_torch.functions.aggregates_collect import dedupe_first

    kf, vf = spec.arg
    kv, kvd = cols[kf]
    vv, vvd = cols[vf]
    keep = dedupe_first(gids, encode_sort_key(kv, None), _and_valid(m, kvd))
    perm, counts, starts = collect_runs(gids, keep)
    return _map_out(t, out_cap, group_sel, counts, starts,
                    Column(t.key, take(kv, perm), None,
                           big.column(kf).dictionary),
                    Column(t.value, take(vv, perm), take_valid(vvd, perm),
                           big.column(vf).dictionary))


def _finish_multimap(big, t, spec, cols, gids, m, group_sel, out_cap):
    """multimap_agg(k, v): each distinct non-NULL key (ascending) with
    the array of its values in row order."""
    cap = gids.shape[0]
    kf, vf = spec.arg
    kv, kvd = cols[kf]
    vv, vvd = cols[vf]
    mm = _and_valid(m, kvd)
    key_ops = encode_sort_key(kv, None)
    vperm, _c, _s = collect_runs(gids, mm, key_ops)   # (group, key, row)
    pgid, pk, cnt, sel2 = _pairs(gids, kv, mm, cap)
    perm2, kcounts, kstarts = collect_runs(pgid, sel2,
                                           encode_sort_key(pk, None))
    pc = torch.where(take(sel2, perm2), take(cnt, perm2),
                     torch.zeros_like(perm2))
    inner = ArrayColumn(t.value, torch.cumsum(pc, 0) - pc, pc,
                        Column(t.value.element, take(vv, vperm),
                               take_valid(vvd, vperm),
                               big.column(vf).dictionary), None)
    return _map_out(t, out_cap, group_sel, kcounts, kstarts,
                    Column(t.key, take(pk, perm2), None,
                           big.column(kf).dictionary), inner)


def _finish_map_union(big, t, spec, cols, gids, m, group_sel, out_cap):
    """map_union(MAP): the first entry of each key over a group's maps."""
    from velox_tpu_torch.functions.aggregates_collect import dedupe_first

    col = big.column(spec.arg)
    egid = _element_groups(col, gids, m)
    keys, vals = col.keys, col.values
    keep = dedupe_first(egid, encode_sort_key(keys.values, None),
                        egid < keys.capacity)
    perm, counts, starts = collect_runs(egid, keep)
    return _map_out(t, out_cap, group_sel, counts, starts,
                    Column(t.key, take(keys.values, perm),
                           take_valid(keys.valid, perm), keys.dictionary),
                    Column(t.value, take(vals.values, perm),
                           take_valid(vals.valid, perm), vals.dictionary))


def _finish_map_union_sum(big, t, spec, cols, gids, m, group_sel, out_cap):
    """map_union_sum(MAP): each key's non-NULL values summed over a
    group's maps, keys ascending."""
    col = big.column(spec.arg)
    keys, vals = col.keys, col.values
    egid = _element_groups(col, gids, m)
    ecap = keys.capacity
    em = _and_valid(egid < ecap, vals.valid)
    g2, rows2, sel2, _ = group_ids_sorted(
        [(egid, None), (keys.values, keys.valid)], em)
    sdt = (torch.float64 if vals.values.dtype.is_floating_point
           else torch.int64)
    vsum = torch.zeros(ecap + 1, dtype=sdt, device=egid.device)
    vsum.index_add_(0, g2.clamp(max=ecap), torch.where(
        em, vals.values.to(sdt), torch.zeros((), dtype=sdt,
                                             device=egid.device)))
    pgid = torch.where(sel2, take(egid, rows2), torch.full_like(egid, ecap))
    perm, counts, starts = collect_runs(pgid, sel2)
    pk_rows = take(rows2, perm)
    return _map_out(t, out_cap, group_sel, counts, starts,
                    Column(t.key, take(keys.values, pk_rows),
                           take_valid(keys.valid, pk_rows),
                           keys.dictionary),
                    Column(t.value, take(vsum[:ecap], perm), None))


def _finish_most_frequent(big, t, spec, cols, gids, m, group_sel, out_cap):
    """approx_most_frequent(k, v): each group's k most frequent non-NULL
    values with their counts, count descending (ties by value)."""
    cap = gids.shape[0]
    kf, vf = spec.arg
    vv, vvd = cols[vf]
    pgid, pk, cnt, sel2 = _pairs(gids, vv, _and_valid(m, vvd), cap)
    perm, counts, starts = collect_runs(pgid, sel2, [-cnt])
    topk = cols[kf][0].index_select(0, first_masked(m)[None])[0]
    counts = torch.minimum(counts, topk.to(torch.int64))
    return _map_out(t, out_cap, group_sel, counts, starts,
                    Column(t.key, take(pk, perm), None,
                           big.column(vf).dictionary),
                    Column(t.value, take(cnt, perm), None))


def _finish_numeric_histogram(big, t, spec, cols, gids, m, group_sel,
                              out_cap):
    """numeric_histogram(b, x): ``b`` equal-width buckets over each
    group's [min, max]; each occupied bucket's mean value -> its count."""
    cap = gids.shape[0]
    bf, xf = spec.arg
    xv, xvd = cols[xf]
    mm = _and_valid(m, xvd)
    b = cols[bf][0].index_select(0, first_masked(m)[None])[0].to(
        torch.float64)
    x = xv.to(torch.float64)
    gm = torch.where(mm, gids.to(torch.int64),
                     torch.full_like(gids, cap, dtype=torch.int64))
    inf = torch.full((cap + 1,), float("inf"), dtype=torch.float64,
                     device=x.device)
    gmin = inf.scatter_reduce(0, gm, x, "amin")
    gmax = (-inf).scatter_reduce(0, gm, x, "amax")
    gsafe = gids.to(torch.int64).clamp(max=cap - 1)
    lo = gmin.index_select(0, gsafe)
    span = gmax.index_select(0, gsafe) - lo
    pos = span > 0
    rel = torch.where(pos, (x - lo) / torch.where(pos, span,
                                                  torch.ones_like(span)),
                      torch.zeros_like(x))
    bucket = torch.clamp(torch.floor(rel * b), min=0).minimum(
        torch.clamp(b - 1, min=0)).to(torch.int32)
    g2, rows2, sel2, _ = group_ids_sorted([(gids, None), (bucket, None)],
                                          mm)
    g2c = g2.clamp(max=cap)
    pcnt = torch.zeros(cap + 1, dtype=torch.float64, device=x.device)
    pcnt.index_add_(0, g2c, mm.to(torch.float64))
    psum = torch.zeros(cap + 1, dtype=torch.float64, device=x.device)
    psum.index_add_(0, g2c, torch.where(mm, x, torch.zeros_like(x)))
    center = psum[:cap] / torch.clamp(pcnt[:cap], min=1.0)
    pgid = torch.where(sel2, take(gids, rows2), torch.full_like(gids, cap))
    perm, counts, starts = collect_runs(pgid, sel2)
    return _map_out(t, out_cap, group_sel, counts, starts,
                    Column(t.key, take(center, perm), None),
                    Column(t.value, take(pcnt[:cap], perm), None))


def _finish_vector_sum(big, t, spec, cols, gids, m, group_sel, out_cap):
    """vector_sum(ARRAY): the element-wise sums of a group's arrays
    (shorter arrays count as zeros past their end, NULL elements as 0)."""
    col = big.column(spec.arg)
    el = col.elements
    ecap = el.capacity
    egid = _element_groups(col, gids, m)
    em = egid < ecap
    owner, _ = element_owners(col.starts, col.lengths, ecap)
    e = torch.arange(ecap, dtype=torch.int64, device=egid.device)
    ordinal = e - take(col.starts, owner).to(torch.int64)
    g2, rows2, sel2, _ = group_ids_sorted([(egid, None), (ordinal, None)],
                                          em)
    sdt = (torch.float64 if el.values.dtype.is_floating_point
           else torch.int64)
    zero = torch.zeros((), dtype=sdt, device=egid.device)
    contrib = torch.where(_and_valid(em, el.valid), el.values.to(sdt), zero)
    vsum = torch.zeros(ecap + 1, dtype=sdt, device=egid.device)
    vsum.index_add_(0, g2.clamp(max=ecap), contrib)
    pgid = torch.where(sel2, take(egid, rows2), torch.full_like(egid, ecap))
    perm, counts, starts = collect_runs(pgid, sel2, [take(ordinal, rows2)])
    return _array_out(t, out_cap, group_sel, counts, starts,
                      take(vsum[:ecap], perm), None, el.dictionary)


def _finish_reservoir(big, t, spec, cols, gids, m, group_sel, out_cap):
    """reservoir_sample(x, k): a bottom-k sample of each group's
    non-NULL values by the ``hash_i64`` priority of their row (uniform
    without replacement, deterministic)."""
    from velox_tpu_torch.ops.hash import _shr, hash_i64

    cap = gids.shape[0]
    xf, kf = spec.arg
    xv, xvd = cols[xf]
    mm = _and_valid(m, xvd)
    k = cols[kf][0].index_select(0, first_masked(mm)[None])[0]
    pri = _shr(hash_i64(torch.arange(cap, dtype=torch.int64,
                                     device=gids.device)), 33).to(torch.int32)
    perm, counts, starts = collect_runs(gids, mm, [pri])
    lengths = torch.minimum(counts, torch.clamp(k.to(torch.int64), min=0))
    return ArrayColumn(t, _pad(starts, out_cap), _pad(lengths, out_cap),
                       Column(t.element, take(xv, perm), None,
                              big.column(xf).dictionary),
                       _group_valid(group_sel, counts, out_cap))


def _finish_classification(big, t, spec, cols, gids, m, group_sel,
                           out_cap):
    """classification_*(b, outcome, pred): per group, the true and false
    weights of each of ``b`` prediction buckets, and from their suffix
    sums the metric at each threshold i / b (an array of ``b`` values;
    0 where the ratio is undefined)."""
    cap = gids.shape[0]
    bf, of, pf = spec.arg[:3]
    ov, ovd = cols[of]
    pv, pvd = cols[pf]
    mm = _and_valid(_and_valid(m, ovd), pvd)
    bt = cols[bf][0].index_select(0, first_masked(m)[None])[0]
    nb = syncs.to_int(bt)
    b = bt.to(torch.float64)
    bucket = torch.clamp(torch.floor(pv.to(torch.float64) * b), min=0)
    bucket = bucket.minimum(torch.clamp(b - 1, min=0)).to(torch.int64)
    gm = torch.where(mm, gids.to(torch.int64),
                     torch.full_like(gids, cap, dtype=torch.int64))
    nbk = max(nb, 1)
    n_slots = out_cap
    flat = gm.clamp(max=n_slots) * nbk + bucket.clamp(max=nbk - 1)
    size = (n_slots + 1) * nbk
    tw = torch.zeros(size, dtype=torch.float64, device=gids.device)
    fw = torch.zeros(size, dtype=torch.float64, device=gids.device)
    ob = ov.to(torch.bool)
    tw.index_add_(0, flat, (mm & ob).to(torch.float64))
    fw.index_add_(0, flat, (mm & ~ob).to(torch.float64))
    tmat = tw.view(n_slots + 1, nbk)[:n_slots]
    fmat = fw.view(n_slots + 1, nbk)[:n_slots]
    tp = torch.flip(torch.cumsum(torch.flip(tmat, [1]), 1), [1])
    fp = torch.flip(torch.cumsum(torch.flip(fmat, [1]), 1), [1])
    fn_ = tmat.sum(1, keepdim=True) - tp
    tn = fmat.sum(1, keepdim=True) - fp
    metric = spec.fn.split("classification_")[1]
    if metric == "thresholds":
        vals = (torch.arange(nbk, dtype=torch.float64, device=gids.device)
                / nb).expand(n_slots, nbk)
    else:
        num, den = {"precision": (tp, tp + fp), "recall": (tp, tp + fn_),
                    "miss_rate": (fn_, tp + fn_),
                    "fall_out": (fp, fp + tn)}[metric]
        vals = torch.nan_to_num(num / den, nan=0.0)
    live = torch.zeros(cap + 1, dtype=torch.bool, device=gids.device)
    live[gm] = True
    live = _pad(live[:cap] & group_sel, out_cap)
    if nb <= 0:
        live = torch.zeros_like(live)
    g = torch.arange(n_slots, dtype=torch.int64, device=gids.device)
    lengths = torch.where(live, torch.full_like(g, nb), torch.zeros_like(g))
    return ArrayColumn(t, (g * nbk).to(torch.int32),
                       lengths.to(torch.int32),
                       Column(t.element, _pad(vals.reshape(-1),
                                              element_capacity(n_slots * nbk)),
                              None),
                       live)


def _segmented_scan(values: torch.Tensor, head: torch.Tensor, comb):
    """Inclusive scan of ``comb`` within the runs that ``head`` starts:
    log2(n) doubling steps, each one call of ``comb`` on whole tensors
    (associative combines give the sequential fold's result)."""
    n = values.shape[0]
    v, f = values, head
    d = 1
    while d < n:
        cv = comb(v[:-d], v[d:])
        nv = torch.where(f[d:], v[d:], cv)
        f = torch.cat([f[:d], f[d:] | f[:-d]])
        v = torch.cat([v[:d], nv])
        d <<= 1
    return v


def _lambda_comb(lam, dtype):
    """A two-parameter combine lambda as an elementwise function of two
    tensors, through the ordinary expression compiler."""
    from velox_tpu_torch.expr.compiler import ExprSet
    from velox_tpu_torch.types.types import row_type

    a, b = lam.params
    es = ExprSet([lam.body], row_type([a, b], [dtype, dtype]))

    def comb(x, y):
        v, _valid = es.evaluate({a: (x, None), b: (y, None)})[0]
        return torch.broadcast_to(v, x.shape).to(x.dtype)

    return comb


def _reduce(big, spec, cols, gids, m, group_sel, out_cap):
    """reduce_agg(x, init, (a, b) -> c): each group's non-NULL values
    folded by the lambda (a segmented scan over the group runs), then
    combined with ``init`` once; an empty group gives ``init``."""
    av, avd = cols[spec.arg]
    init_v, lam = spec.options
    comb = _lambda_comb(lam, big.column(spec.arg).dtype)
    perm, counts, starts = collect_runs(gids, _and_valid(m, avd))
    sv = take(av, perm)
    n = sv.shape[0]
    head = torch.zeros(n + 1, dtype=torch.bool, device=sv.device)
    head[torch.where(counts > 0, starts, torch.full_like(starts, n))] = True
    scanned = _segmented_scan(sv, head[:n], comb)
    red = take(scanned, (starts + counts - 1).clamp(0, n - 1))
    init = torch.full_like(red, init_v)
    vals = torch.where(counts > 0, comb(init, red), init)
    return _pad(vals, out_cap), _pad(group_sel, out_cap)


_COMPLEX_FINISH = {
    "array": _finish_array,
    "set": _finish_array,
    "set_union": _finish_set_union,
    "histogram": _finish_histogram,
    "map": _finish_map,
    "multimap": _finish_multimap,
    "map_union": _finish_map_union,
    "map_union_sum": _finish_map_union_sum,
    "most_frequent": _finish_most_frequent,
    "numeric_histogram": _finish_numeric_histogram,
    "vector_sum": _finish_vector_sum,
    "reservoir": _finish_reservoir,
    "classification": _finish_classification,
}


def _pad(a: torch.Tensor, n: int) -> torch.Tensor:
    """``a`` zero-padded (False for a mask) to length ``n``."""
    if a.shape[0] >= n:
        return a[:n]
    return torch.cat([a, a.new_zeros((n - a.shape[0],) + a.shape[1:])])


def _winsorized(spec, cols, gids, m, n_groups):
    """approx_winsorized_mean(x, lo, hi): each group's values clamped to
    its exact lo/hi quantile values (float32 positions), averaged: one
    slot a group, so into a few groups the sum is one masked reduction
    each (``scatter_add``), not atomics on a few addresses."""
    from velox_tpu_torch.functions.aggregates import scatter_add

    cap = gids.shape[0]
    xf, lof, hif = spec.arg
    xv, xvd = cols[xf]
    first = first_masked(m)[None]
    lo = cols[lof][0].index_select(0, first)[0]
    hi = cols[hif][0].index_select(0, first)[0]
    mm = _and_valid(m, xvd)
    perm, counts, starts = collect_runs(gids, mm, encode_sort_key(xv, None))
    sv = xv.index_select(0, perm).to(torch.float64)
    sentinel = torch.full((), cap, dtype=torch.int64, device=gids.device)
    og = torch.where(mm, gids.to(torch.int64), sentinel).index_select(0, perm)
    ogs = og.clamp(max=cap - 1)
    n1 = torch.clamp(counts.index_select(0, ogs) - 1, min=0)
    st = starts.index_select(0, ogs)
    lo_pos = (st + f32_positions(lo, n1)).clamp(0, cap - 1)
    hi_pos = (st + f32_positions(hi, n1)).clamp(0, cap - 1)
    cl = torch.minimum(torch.maximum(sv, sv.index_select(0, lo_pos)),
                       sv.index_select(0, hi_pos))
    tot = scatter_add(torch.zeros(n_groups, dtype=torch.float64,
                                  device=gids.device), og, cl)
    counts = counts[:n_groups]
    return tot / torch.clamp(counts, min=1), counts > 0


def _scalar_result(op, i, fn, spec, cols, gids, m, group_sel, n_groups):
    """A scatter aggregate against the final group ids, one slot a group
    (the reference keeps one a row): into few groups its sums take the
    shared few-groups reductions, and under narrow lanes a 32-bit sum
    into 2-128 groups the grouped-sum kernel B1."""
    cap = gids.shape[0]
    at = op.arg_types[i]
    accs = tuple(init_lane(lane, at, n_groups, gids.device)
                 for lane in fn.lanes)
    if spec.arg is None:
        vals = None
    elif isinstance(spec.arg, tuple):
        vals = tuple(cols[a] for a in spec.arg)
    else:
        av, avd = cols[spec.arg]
        m = _and_valid(m, avd)
        vals = av
    if spec.distinct:
        _, drows, dsel, _ = group_ids_sorted([(gids, None), (vals, None)], m)
        rep = torch.zeros(cap + 1, dtype=torch.bool, device=gids.device)
        rep[torch.where(dsel, drows, torch.full_like(drows, cap))] = True
        m = rep[:cap]
    return fn.extract(fn.accumulate(accs, gids, vals, m), group_sel)


# ---------------------------------------------------------- host halves

def _blob_column(t, strs: List, out_cap: int, device) -> Column:
    """A VARBINARY column over a sorted dictionary of the group blobs."""
    live = [s is not None for s in strs]
    blobs = np.asarray([s for s in strs if s is not None], dtype=object)
    uniq, inv = (np.unique(blobs, return_inverse=True) if len(blobs)
                 else (np.zeros(0, object), np.zeros(0, np.int64)))
    codes = np.full(out_cap, -1, np.int32)
    valid = np.zeros(out_cap, bool)
    valid[:len(strs)] = live
    codes[np.nonzero(valid)[0]] = np.asarray(inv).reshape(-1)
    return Column(t, torch.from_numpy(codes).to(device),
                  torch.from_numpy(valid).to(device),
                  Dictionary(list(uniq)))


def _runs_to_host(values, runs, n_groups):
    """(counts, starts, run values) of the first ``n_groups`` slots of
    ``collect_runs``' result ``runs``, on the host."""
    perm, counts, starts = runs
    head = syncs.to_numpy(torch.stack([counts[:n_groups],
                                       starts[:n_groups]]))
    total = int(head[0].sum())
    return head[0], head[1], syncs.to_numpy(
        values.index_select(0, perm[:total]))


def _digest_column(big, t, spec, fn, cols, gids, m, n_groups, out_cap):
    """tdigest_agg / qdigest_agg / merge: serialize each group's sorted
    run into a digest blob, or merge each group's blobs in row order."""
    import time

    global blob_seconds
    av, avd = cols[spec.arg]
    mm = _and_valid(m, avd)
    if fn.collect_kind == "digest":
        src_t = big.column(spec.arg).dtype
        k = "f" if src_t.kind in (TypeKind.REAL, TypeKind.DOUBLE) else "i"
        tag = "QD1" if fn.name == "qdigest_agg" else "TD1"
        perm, counts, starts = collect_runs(
            gids, mm, encode_sort_key(av, None))
        t0 = time.perf_counter()
        strs = (_device_digests(av, perm, counts, starts, n_groups, tag)
                if k == "i" else None)
        if strs is None:
            c, s, ev = _runs_to_host(av, (perm, counts, starts), n_groups)
            strs = build_group_digests(c, s, ev, k, tag)
    else:
        t0 = time.perf_counter()
        counts, starts, codes = _runs_to_host(
            av, collect_runs(gids, mm), n_groups)
        values = big.column(spec.arg).dictionary.values
        strs = [None] * n_groups
        for g in np.nonzero(counts > 0)[0].tolist():
            run = codes[starts[g]:starts[g] + counts[g]]
            strs[g] = SK.merge_blobs(values[run[run >= 0]].tolist())
    col = _blob_column(t, strs, out_cap, gids.device)
    blob_seconds += time.perf_counter() - t0
    return col


def _device_digests(av, perm, counts, starts, n_groups, tag):
    """``build_group_digests`` of an integral source with the bucketing on
    the device: each element's k1 bucket gathered from the host's table
    per group size, centroid weights and sums by one scatter each; the
    host formats the nonzero cells. The sums are of integers below 2^53,
    so exact in any order, as the host's sequential ``bincount`` is.
    None where they might not be (the host path then runs)."""
    from velox_tpu_torch.functions.digest import (
        DEFAULT_COMPRESSION, bucket_table, digest_strings,
    )

    C = DEFAULT_COMPRESSION
    head = syncs.to_numpy(torch.stack([counts[:n_groups],
                                       starts[:n_groups]]))
    lc_all, st_all = head
    total = int(lc_all.sum())
    live = np.nonzero(lc_all > 0)[0]
    sv = av.index_select(0, perm[:total]).to(torch.float64)
    if total:
        bound = syncs.to_numpy(sv.abs().max()).item()
        if bound * float(lc_all.max()) >= 2.0 ** 53:
            return None
    lc = lc_all[live]
    table, sizes, offsets = bucket_table(lc, C)
    dev = av.device
    owner = torch.repeat_interleave(
        torch.arange(len(live), device=dev),
        torch.from_numpy(lc).to(dev), output_size=total)
    first = torch.from_numpy(st_all[live]).to(dev)
    base = torch.from_numpy(offsets[np.searchsorted(sizes, lc)]).to(dev)
    i_in = torch.arange(total, device=dev) - first.index_select(0, owner)
    b = torch.from_numpy(table).to(dev).index_select(
        0, base.index_select(0, owner) + i_in)
    key = owner * C + b
    w = torch.bincount(key, minlength=len(live) * C)
    s = torch.zeros(len(live) * C, dtype=torch.float64, device=dev)
    s.index_add_(0, key, sv)
    nz = syncs.nonzero(w)
    wn = w.index_select(0, nz).to(torch.float64)
    ends = first + torch.from_numpy(lc).to(dev) - 1
    out = syncs.to_numpy(torch.cat([
        s.index_select(0, nz) / wn, wn, sv.index_select(0, first),
        sv.index_select(0, ends)]))
    m = len(nz)
    return digest_strings(n_groups, live, lc, syncs.to_numpy(nz),
                          out[:m], out[m:2 * m], out[2 * m:2 * m + len(live)],
                          out[2 * m + len(live):], "i", tag, C)


def _hashes(big, field: str, values: torch.Tensor, mask: torch.Tensor
            ) -> torch.Tensor:
    """``hash64`` of each row's value as int64 bits (garbage where
    ``mask`` is false): dictionary strings through one hash per
    dictionary value (kept with the dictionary), floats through one per
    distinct value on the host, integers through one per distinct value
    on the device."""
    col = big.column(field)
    if col.dictionary is not None:
        table = col.dictionary.derived(
            ("hash64",), lambda d: SK.hash64_array(
                np.asarray(d.values, dtype=object)).view(np.int64))
        t = torch.from_numpy(table).to(values.device)
        if len(table) == 0:
            return torch.zeros_like(values, dtype=torch.int64)
        return t.index_select(0, values.to(torch.int64).clamp(
            0, len(table) - 1))
    if values.dtype.is_floating_point:
        rows = syncs.nonzero(mask)
        h = SK.hash64_array(syncs.to_numpy(values.index_select(0, rows)))
        out = torch.zeros(values.shape, dtype=torch.int64,
                          device=values.device)
        out[rows] = torch.from_numpy(h.view(np.int64)).to(values.device)
        return out
    # one hash per distinct integer: a sort, then BLAKE2b over the few
    uniq, inv = torch.unique(values.to(torch.int64), return_inverse=True)
    return SK.hash64_ints(uniq).index_select(0, inv.reshape(-1))


def _first_of_runs(*sorted_ops):
    """Where a row of lexicographically sorted operands starts a new
    value of the tuple."""
    n = sorted_ops[0].shape[0]
    new = torch.zeros(n, dtype=torch.bool, device=sorted_ops[0].device)
    new[0] = True
    for o in sorted_ops:
        new[1:] |= o[1:] != o[:-1]
    return new


def _rank_in(new_run, new_elem):
    """For sorted rows: each row's index among the ``new_elem`` rows since
    the last ``new_run`` row (``new_run`` implies ``new_elem``)."""
    idx = torch.cumsum(new_elem.to(torch.int64), 0) - 1
    run = torch.cumsum(new_run.to(torch.int64), 0) - 1
    base = torch.zeros(int(run.shape[0]) + 1, dtype=torch.int64,
                       device=idx.device)
    base.scatter_(0, torch.where(new_run, run, torch.full_like(run,
                                                              run.shape[0])),
                  idx)
    return idx - base.index_select(0, run.clamp(min=0))


def _hll_registers(g, h, n_groups: int) -> np.ndarray:
    """(n_groups, 2^HLL_LOG2M) uint8 registers: a scatter-max of each
    hash's rank into its group's bucket (rows with ``g >= n_groups``
    drop)."""
    log2m = SK.HLL_LOG2M
    m = 1 << log2m
    bucket = h & (m - 1)
    rest = (h >> log2m) & ((1 << (64 - log2m)) - 1)
    width = 64 - log2m
    bl = torch.frexp(rest.to(torch.float64))[1].to(torch.int64)
    rank = torch.where(rest != 0, width - bl + 1,
                       torch.full_like(bl, width + 1))
    slot = torch.where(g < n_groups, g * m + bucket,
                       torch.full_like(g, n_groups * m))
    regs = torch.zeros(n_groups * m + 1, dtype=torch.int32, device=g.device)
    regs.scatter_reduce_(0, slot, rank.to(torch.int32), "amax",
                         include_self=True)
    return syncs.to_numpy(regs[:-1].to(torch.uint8)).reshape(n_groups, m)


def _sketch_column(big, t, spec, fn, cols, gids, m, n_groups, out_cap):
    """approx_set / make_set_digest / khyperloglog_agg blobs of each
    group's values."""
    import time

    global blob_seconds
    t0 = time.perf_counter()
    cap = gids.shape[0]
    sentinel = torch.full((), cap, dtype=torch.int64, device=gids.device)
    strs: List = [None] * n_groups
    if fn.collect_kind == "hll":
        av, avd = cols[spec.arg]
        mm = _and_valid(m, avd)
        g = torch.where(mm, gids.to(torch.int64), sentinel)
        h = _hashes(big, spec.arg, av, mm)
        regs = _hll_registers(g, h, n_groups)
        counts = syncs.to_numpy(torch.bincount(
            g.clamp(max=n_groups), minlength=n_groups + 1)[:n_groups])
        if fn.name == "make_set_digest":
            perm = lex_sort([g, h ^ _SIGN])
            sg, sh = g.index_select(0, perm), h.index_select(0, perm)
            new = _first_of_runs(sg, sh) & (sg < n_groups)
            rank = _rank_in(_first_of_runs(sg) & (sg < n_groups), new)
            keep = syncs.nonzero(new & (rank < SK.SD_K))
            kg = syncs.to_numpy(sg.index_select(0, keep))
            kh = syncs.to_numpy(sh.index_select(0, keep)).view(np.uint64)
        live = np.nonzero(counts > 0)[0]
        if fn.name == "approx_set":
            head = "HL1|%d|" % SK.HLL_LOG2M
            for gi in live.tolist():
                strs[gi] = head + base64.b64encode(
                    regs[gi].tobytes()).decode()
        else:
            ends = np.cumsum(np.bincount(kg, minlength=n_groups))
            head = "SD1|%d|" % SK.HLL_LOG2M
            for gi in live.tolist():
                s = ends[gi - 1] if gi else 0
                strs[gi] = (head + base64.b64encode(regs[gi].tobytes())
                            .decode() + "|" + SK._pack_u64(kh[s:ends[gi]]))
    else:  # khll
        xf, uf = spec.arg
        xv, xvd = cols[xf]
        uv, uvd = cols[uf]
        mm = _and_valid(_and_valid(m, xvd), uvd)
        g = torch.where(mm, gids.to(torch.int64), sentinel)
        xh = _hashes(big, xf, xv, mm)
        uh = _hashes(big, uf, uv, mm)
        perm = lex_sort([g, xh ^ _SIGN, uh ^ _SIGN])
        sg, sx, su = (a.index_select(0, perm) for a in (g, xh, uh))
        ok = sg < n_groups
        new_g = _first_of_runs(sg) & ok
        new_x = _first_of_runs(sg, sx) & ok
        new_t = _first_of_runs(sg, sx, su) & ok
        keep = (new_t & (_rank_in(new_g, new_x) < SK.KHLL_K)
                & (_rank_in(new_x, new_t) < SK.KHLL_UCAP))
        rows = syncs.nonzero(keep)
        kg, kx, ku = (syncs.to_numpy(a.index_select(0, rows))
                      for a in (sg, sx, su))
        kx, ku = kx.view(np.uint64), ku.view(np.uint64)
        newrec = np.ones(len(kg), bool)
        newrec[1:] = (kg[1:] != kg[:-1]) | (kx[1:] != kx[:-1])
        rec = np.nonzero(newrec)[0]
        rec_end = np.append(rec[1:], len(kg))
        head = "KH1|%d|%d|" % (SK.KHLL_K, SK.KHLL_UCAP)
        parts: Dict[int, bytearray] = {}
        for s, e in zip(rec.tolist(), rec_end.tolist()):
            buf = parts.setdefault(int(kg[s]), bytearray())
            buf += struct.pack(">QB", int(kx[s]), e - s)
            buf += ku[s:e].astype(">u8").tobytes()
        for gi, buf in parts.items():
            strs[gi] = head + base64.b64encode(bytes(buf)).decode()
    col = _blob_column(t, strs, out_cap, gids.device)
    blob_seconds += time.perf_counter() - t0
    return col
