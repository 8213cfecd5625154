"""Collect-style aggregates (the port of the JAX package's
``functions/aggregates_collect.py``): the registrations of every collect
kind and the sorted-run helpers the collect mode runs at finish.

These aggregates need every input value at finish. One global sort by
group id makes every group's values a contiguous run; the collect
"accumulator" is the sorted value lane plus per-group (start, length)
offsets. ``HashAggregationOp`` in mode "collect" buffers the raw rows and
``exec/collect_agg.py`` runs the helpers here once at finish.
``approx_percentile`` is exact over those runs.

The kinds whose result is an ARRAY or a MAP (``array_agg``, ``set_agg``,
``set_union``, ``map_agg``, ``multimap_agg``, ``map_union``,
``map_union_sum``, ``histogram``, ``numeric_histogram``,
``approx_most_frequent``, ``vector_sum``, ``reservoir_sample``, the
``classification_*`` family) and ``reduce_agg`` run in a SINGLE step;
``array_agg``, ``set_agg`` and ``map_agg`` also have a PARTIAL/FINAL page
form (``HashAggregationOp``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from velox_tpu_torch.functions.aggregates import (
    AggregateFunction, register_aggregate,
)
from velox_tpu_torch.ops.sort import lex_sort
from velox_tpu_torch.types import BIGINT, DOUBLE, VARBINARY
from velox_tpu_torch.types.types import TypeKind, array, map_

def _register_collect(name: str, kind: str, resolve_type) -> None:
    register_aggregate(AggregateFunction(
        name=name,
        resolve_type=resolve_type,
        lanes=(),
        accumulate=None,
        combine=None,
        extract=None,
        lane_types=lambda t: (),
        collect_kind=kind,
    ))


def _float_or_bigint(t):
    return DOUBLE if t.kind in (TypeKind.REAL, TypeKind.DOUBLE) else BIGINT


_register_collect("array_agg", "array", lambda t: array(t))
_register_collect("map_agg", "map", lambda t: map_(t[0], t[1]))
_register_collect("multimap_agg", "multimap",
                  lambda t: map_(t[0], array(t[1])))
_register_collect("map_union", "map_union", lambda t: t)
# approx_percentile(v, q): scalar result of the value type (exact here)
_register_collect("approx_percentile", "percentile", lambda t: t[0])
_register_collect("set_agg", "set", lambda t: array(t))
_register_collect("set_union", "set_union", lambda t: t)
_register_collect("histogram", "histogram", lambda t: map_(t, BIGINT))
_register_collect("map_union_sum", "map_union_sum",
                  lambda t: map_(t.key, _float_or_bigint(t.value)))
_register_collect("reduce_agg", "reduce", lambda t: t)
for _cname in ("classification_precision", "classification_recall",
               "classification_miss_rate", "classification_fall_out",
               "classification_thresholds"):
    _register_collect(_cname, "classification", lambda t: array(DOUBLE))
_register_collect("vector_sum", "vector_sum",
                  lambda t: array(_float_or_bigint(t.element)))
_register_collect("approx_most_frequent", "most_frequent",
                  lambda t: map_(t[1], BIGINT))
# approx_winsorized_mean(x, lo, hi): mean after clamping to the exact
# [lo, hi] quantile values (ApproxWinsorizedMeanAggregate)
_register_collect("approx_winsorized_mean", "winsorized", lambda t: DOUBLE)
_register_collect("numeric_histogram", "numeric_histogram",
                  lambda t: map_(DOUBLE, DOUBLE))
# tdigest_agg / qdigest_agg: quantile sketches as VARBINARY blobs built
# from the value-sorted runs (functions/digest.py)
_register_collect("tdigest_agg", "digest", lambda t: VARBINARY)
_register_collect("qdigest_agg", "digest", lambda t: VARBINARY)
# merge(sketch): one name over every blob family (functions/sketch.py
# merge_blobs)
_register_collect("merge", "digest_merge", lambda t: t)
_register_collect("merge_set_digest", "digest_merge", lambda t: t)
_register_collect("merge_khll", "digest_merge", lambda t: t)
# approx_set / make_set_digest: distinct-set sketches as blobs
_register_collect("approx_set", "hll", lambda t: VARBINARY)
_register_collect("make_set_digest", "hll", lambda t: VARBINARY)
# khyperloglog_agg(x, uii): join-key uniqueness sketch
_register_collect("khyperloglog_agg", "khll", lambda t: VARBINARY)
_register_collect("reservoir_sample", "reservoir", lambda t: array(t[0]))


# ---------------------------------------------------------------- helpers
# Inputs are at the concatenated capacity ``cap``; ``gids`` are the group
# ids of the one global grouping (``cap`` for inactive rows).

def _packed(first: torch.Tensor, ops: Sequence[torch.Tensor]
            ) -> Optional[torch.Tensor]:
    """One int64 key ordering like ``[first] + ops`` (``first`` in
    [0, cap]), or None when the operands' spans do not fit 63 bits. Reads
    the operands' min and max on the host (one sync)."""
    from velox_tpu_torch.utils import syncs

    if not ops:
        return first.to(torch.int64)
    bounds = syncs.to_numpy(torch.stack(
        [torch.stack([o.min().to(torch.int64), o.max().to(torch.int64)])
         for o in ops])).tolist()
    cap_bits = int(first.shape[0]).bit_length()
    bits, spans = cap_bits, []
    for lo, hi in bounds:
        span = hi - lo
        if span < 0 or span >= 1 << 62:
            return None
        spans.append(max(span, 1).bit_length())
        bits += spans[-1]
    if bits > 63:
        return None
    key = first.to(torch.int64)
    for o, (lo, _hi), b in zip(ops, bounds, spans):
        key = (key << b) | (o.to(torch.int64) - lo)
    return key


def collect_runs(gids: torch.Tensor, mask: torch.Tensor, order_ops=None):
    """Sort contributing rows into group-contiguous runs.

    Returns ``(perm, counts, starts)``: ``perm`` gathers input rows into
    (group-major, then ``order_ops``-ordered, then row) element order;
    ``counts``/``starts`` (int64, ``cap`` long) are per-group-slot element
    extents. One stable sort of a packed key where the operands fit 63
    bits, else chained stable sorts.
    """
    cap = gids.shape[0]
    g2 = torch.where(mask, gids.to(torch.int64),
                     torch.full((), cap, dtype=torch.int64,
                                device=gids.device))
    ops = list(order_ops or [])
    key = _packed(g2, ops)
    if key is not None:
        perm = torch.sort(key, stable=True)[1]
    else:
        perm = lex_sort([g2] + ops)
    # each group's count from where its run starts in the sorted order,
    # one write a group (a scatter-add of every row piles its atomics on
    # the few addresses of few groups); one host sync finds the starts
    from velox_tpu_torch.utils import syncs

    gs = g2.index_select(0, perm)
    head = gs < cap
    head[1:] &= gs[1:] != gs[:-1]
    hp = syncs.nonzero(head)
    ends = torch.cat([hp[1:], (gs < cap).sum().reshape(1)])
    counts = torch.zeros(cap, dtype=torch.int64, device=gids.device)
    counts.index_copy_(0, gs.index_select(0, hp), ends - hp)
    starts = torch.cumsum(counts, 0) - counts
    return perm, counts, starts


def dedupe_first(gids: torch.Tensor, key_ops, mask: torch.Tensor
                 ) -> torch.Tensor:
    """Keep-first mask over (gid, key) duplicates: the winner among
    duplicates is the lowest original row."""
    cap = gids.shape[0]
    perm, _c, _s = collect_runs(gids, mask, key_ops)
    g2 = torch.where(mask, gids.to(torch.int64),
                     torch.full((), cap, dtype=torch.int64,
                                device=gids.device))
    diff = torch.zeros(cap, dtype=torch.bool, device=gids.device)
    diff[0] = True
    for k in [g2] + list(key_ops):
        ks = k.index_select(0, perm)
        diff[1:] |= ks[1:] != ks[:-1]
    keep_sorted = diff & (g2.index_select(0, perm) < cap)
    keep = torch.zeros(cap, dtype=torch.bool, device=gids.device)
    keep[perm] = keep_sorted
    return keep & mask


def first_masked(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first true row (0 if none): ``argmax`` of a bool."""
    cap = mask.shape[0]
    r = torch.arange(cap, device=mask.device)
    first = torch.where(mask, r, torch.full_like(r, cap)).min()
    return torch.where(first < cap, first, torch.zeros_like(first))


def f32_positions(q: torch.Tensor, n1: torch.Tensor) -> torch.Tensor:
    """``floor(float32(q) * float32(n1))`` as int64: the JAX package's
    float32 quantile position (it differs from a float64 position, e.g.
    q = 0.7 at n - 1 = 90 gives 63)."""
    return torch.floor(q.to(torch.float32) * n1.to(torch.float32)).to(
        torch.int64)


def percentile_values(gids: torch.Tensor, values: torch.Tensor, value_ops,
                      mask: torch.Tensor, q: torch.Tensor) -> tuple:
    """Exact per-group percentile: sort (gid, value), index each group's
    run at ``floor(q * (n-1))`` in float32 (Presto's lower-interpolation
    convention, ApproxPercentileAggregate.cpp). Returns per-group-slot
    (values, valid)."""
    cap = gids.shape[0]
    perm, counts, starts = collect_runs(gids, mask, value_ops)
    svals = values.index_select(0, perm)
    qpos = f32_positions(q, torch.clamp(counts - 1, min=0))
    pos = torch.clamp(starts + qpos, 0, cap - 1)
    return svals.index_select(0, pos), counts > 0
