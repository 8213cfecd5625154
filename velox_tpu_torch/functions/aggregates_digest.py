"""Mergeable quantile digest lanes for approx_percentile's PARTIAL and
FINAL steps (the port of the JAX package's
``functions/aggregates_digest.py``).

The SINGLE-step approx_percentile stays EXACT (sorted runs,
``functions/aggregates_collect.py``). Its two-step form keeps a
merging digest per group as three lanes:

* ``dmean``   (groups, K) float64 — centroid means
* ``dweight`` (groups, K) int64   — centroid row counts
* ``q``       (groups,)   float32 — the captured quantile argument

Ingest sorts the batch by (group, value), equal-count-bins each group's
run into <= K centroids (float32 positions, as in the reference), then
merges them with the state by a per-group sort of 2K centroids and a
cumulative-weight rebin (Dunning's MergingDigest with the k0 scale:
uniform quantile error ~ 1/(2K)). While a group holds <= K rows the
digest is exact, so small groups give the exact path's value.

As in the reference: the two-step result type is DOUBLE, K is fixed at
64, and results depend on batch and merge order.
"""

from __future__ import annotations

import numpy as np
import torch

from velox_tpu_torch.functions.aggregates import (
    AccLane, AggregateFunction, register_aggregate, scatter_minmax,
)
from velox_tpu_torch.ops.sort import lex_sort
from velox_tpu_torch.ops.sortkey import encode_sort_key
from velox_tpu_torch.types import BIGINT, DOUBLE, REAL, DataType

#: centroids per group (uniform-bin quantile error ~ 1/(2K))
K = 64


def _sorted_runs(gids, vals, w, mask, num_groups):
    """Sort (gid, value) and return per-element group-local cumulative
    weights and per-group totals (the weighted-rank basis for binning)."""
    g2 = torch.where(mask, gids.to(torch.int64),
                     torch.full((), num_groups, dtype=torch.int64,
                                device=gids.device))
    perm = lex_sort([g2] + encode_sort_key(vals, None))
    sg = g2.index_select(0, perm)
    sv = vals.index_select(0, perm)
    sw = torch.where(mask.index_select(0, perm), w.index_select(0, perm),
                     torch.zeros((), dtype=w.dtype, device=w.device))
    counts = torch.zeros(num_groups + 1, dtype=w.dtype, device=w.device)
    counts.index_add_(0, g2, w * mask.to(w.dtype))
    counts = counts[:num_groups]
    cum_all = torch.cumsum(sw, 0)
    group_start_w = torch.cumsum(counts, 0) - counts
    base = group_start_w.index_select(0, sg.clamp(0, num_groups - 1))
    return sg, sv, sw, cum_all - base, counts


def _bin_elements(sg, sv, sw, cumw, counts, num_groups):
    """Equal-weight bin sorted elements into (groups, K) centroids."""
    totw = counts.index_select(0, sg.clamp(0, num_groups - 1))
    center = cumw.to(torch.float32) - sw.to(torch.float32) * 0.5
    b = torch.floor(K * center / torch.clamp(totw.to(torch.float32),
                                             min=1.0)).to(torch.int64)
    b = b.clamp(0, K - 1)
    live = (sg < num_groups) & (sw > 0)
    slot = torch.where(live, sg * K + b,
                       torch.full_like(b, num_groups * K))
    wsum = torch.zeros(num_groups * K + 1, dtype=torch.int64,
                       device=sg.device)
    wsum.index_add_(0, slot, sw.to(torch.int64))
    msum = torch.zeros(num_groups * K + 1, dtype=torch.float64,
                       device=sg.device)
    msum.index_add_(0, slot, sv.to(torch.float64) * sw.to(torch.float64))
    wsum = wsum[:-1].reshape(num_groups, K)
    msum = msum[:-1].reshape(num_groups, K)
    means = msum / torch.clamp(wsum, min=1).to(torch.float64)
    return means, wsum


def _merge_state(means_a, w_a, means_b, w_b):
    """Merge two (G, K) digests into one: a per-group sort of 2K centroids
    by mean (empty slots to the end), then a cumulative-weight rebin."""
    g = means_a.shape[0]
    m2 = torch.cat([means_a, means_b], dim=1)
    w2 = torch.cat([w_a, w_b], dim=1)
    key = torch.where(w2 > 0, m2, torch.full_like(m2, float("inf")))
    order = torch.argsort(key, dim=1, stable=True)
    m2 = torch.take_along_dim(m2, order, dim=1)
    w2 = torch.take_along_dim(w2, order, dim=1)
    cumw = torch.cumsum(w2, dim=1)
    totw = cumw[:, -1:]
    center = cumw.to(torch.float64) - w2.to(torch.float64) * 0.5
    b = torch.floor(K * center / torch.clamp(totw.to(torch.float64),
                                             min=1.0)).to(torch.int64)
    b = b.clamp(0, K - 1)
    rows = torch.arange(g, device=m2.device)[:, None].expand(g, 2 * K)
    slot = torch.where(w2 > 0, rows * K + b, torch.full_like(b, g * K))
    wsum = torch.zeros(g * K + 1, dtype=torch.int64, device=m2.device)
    wsum.index_add_(0, slot.reshape(-1), w2.to(torch.int64).reshape(-1))
    msum = torch.zeros(g * K + 1, dtype=torch.float64, device=m2.device)
    msum.index_add_(0, slot.reshape(-1),
                    (m2 * w2.to(torch.float64)).reshape(-1))
    wsum = wsum[:-1].reshape(g, K)
    means = msum[:-1].reshape(g, K) / torch.clamp(wsum, min=1).to(
        torch.float64)
    return means, wsum


def _merge_q(qlane, gids, q, mask):
    """The captured quantile argument: the max over the group's rows."""
    g = qlane.shape[0]
    idx = torch.where(mask, gids.to(torch.int64),
                      torch.full((), g, dtype=torch.int64,
                                 device=gids.device))
    return scatter_minmax(qlane, idx, torch.where(
        mask, q.to(torch.float32), torch.full((), -1.0,
                                               dtype=torch.float32,
                                               device=q.device)), False)


def _accumulate(accs, gids, values, mask):
    means, weights, qlane = accs
    (v, vvalid), (q, qvalid) = values
    g = means.shape[0]
    m = mask
    if vvalid is not None:
        m = m & vvalid
    w = torch.ones(v.shape, dtype=torch.int64, device=v.device)
    sg, sv, sw, cumw, counts = _sorted_runs(gids, v, w, m, g)
    bm, bw = _bin_elements(sg, sv, sw, cumw, counts, g)
    means, weights = _merge_state(means, weights, bm, bw)
    if qvalid is not None:
        m = m & qvalid
    return means, weights, _merge_q(qlane, gids, q, m)


def _combine(accs, gids, lanes, mask):
    """Merge partial digests (lanes read from ``name$lane@slot`` columns):
    every partial centroid is a weighted value run through the same
    ingest."""
    means, weights, qlane = accs
    pmeans, pweights, pq = lanes
    g = means.shape[0]
    eg = torch.repeat_interleave(
        torch.where(mask, gids.to(torch.int64),
                    torch.full((), g, dtype=torch.int64,
                               device=gids.device)), K)
    ev = pmeans.reshape(-1)
    ew = torch.where(torch.repeat_interleave(mask, K), pweights.reshape(-1),
                     torch.zeros((), dtype=pweights.dtype,
                                 device=pweights.device)).to(torch.int64)
    sg, sv, sw, cumw, counts = _sorted_runs(eg, ev, ew, ew > 0, g)
    bm, bw = _bin_elements(sg, sv, sw, cumw, counts, g)
    means, weights = _merge_state(means, weights, bm, bw)
    return means, weights, _merge_q(qlane, gids, pq, mask)


def _extract(accs, group_mask):
    means, weights, qlane = accs
    cumw = torch.cumsum(weights, dim=1)
    totw = cumw[:, -1]
    q = torch.clamp(qlane.to(torch.float64), 0.0, 1.0)
    # Presto lower-interpolation target rank: floor(q * (n - 1))
    target = torch.floor(q * torch.clamp(totw - 1, min=0).to(
        torch.float64)).to(torch.int64)
    hit = (cumw > target[:, None]).to(torch.uint8)
    idx = torch.argmax(hit, dim=1)
    out = torch.take_along_dim(means, idx[:, None], dim=1)[:, 0]
    valid = group_mask & (totw > 0) & (qlane >= 0)
    return out, valid


def make_percentile_digest(collect_kind: str = "percentile"
                           ) -> AggregateFunction:
    return AggregateFunction(
        name="approx_percentile",
        resolve_type=lambda t: (
            t[0] if isinstance(t, tuple) and isinstance(t[0], DataType)
            else DOUBLE),
        lanes=(
            AccLane("dmean", lambda at: np.dtype(np.float64),
                    lambda at: 0.0, width=K),
            AccLane("dweight", lambda at: np.dtype(np.int64),
                    lambda at: 0, width=K),
            AccLane("q", lambda at: np.dtype(np.float32),
                    lambda at: -1.0),
        ),
        accumulate=_accumulate,
        combine=_combine,
        extract=_extract,
        lane_types=lambda at: (DOUBLE, BIGINT, REAL),
        final_type=lambda lts: DOUBLE,
        input_type_from_lanes=lambda lts: (DOUBLE, DOUBLE),
        collect_kind=collect_kind,
    )


def register_percentile_digest() -> None:
    register_aggregate(make_percentile_digest())
