"""Multi-argument, bitwise and sketch aggregates, over torch.

The port of the JAX package's ``functions/aggregates_multi.py``:
``min_by``/``max_by`` (velox MinMaxByAggregates.cpp), the covariance
family ``covar_samp``, ``covar_pop``, ``corr``, ``regr_slope``,
``regr_intercept`` (CovarianceAggregates.cpp), ``bitwise_and_agg``,
``bitwise_or_agg``, ``bitwise_xor_agg`` (BitwiseAggregates.cpp),
``approx_distinct`` (HyperLogLogAggregate.h), ``product`` and
``entropy`` (EntropyAggregates.cpp), on the same lane ABI as
``aggregates.py``.

* ``min_by``/``max_by`` elect in two phases, as the reference does:
  scatter the comparison optimum, then the first row of the batch (or
  of the partials) that equals its group's optimum gives the payload.
  A batch whose rows match the running optimum elects again, so where
  the optimum ties across batches the mode decides the row: a kArray
  aggregation (one accumulator for all batches) keeps the first such
  row of the last batch that holds one, a generic or keyless one (a
  partial per batch, combined in batch order) the first row overall.
* the bitwise aggregates count each of the 64 bits per group in one
  ``(groups, 64)`` matrix lane: ``and`` is count == rows, ``or`` count
  > 0, ``xor`` count odd.
* ``approx_distinct`` is a HyperLogLog of 1024 registers in one
  ``(groups, 1024)`` matrix lane over ``ops/hash.py``'s ``hash_i64``;
  the rank is read off the float32 exponent of the hash's upper bits,
  bit for bit as the reference reads it (the sketch's definition).
* ``entropy`` takes its ``log2`` in float64; the reference takes it in
  float32 (a TPU compiler hazard), so the two differ in the last
  float32 digits.
"""

from __future__ import annotations

import numpy as np
import torch

from velox_tpu_torch import torch_dtype
from velox_tpu_torch.types import BIGINT, BOOLEAN, DOUBLE
from velox_tpu_torch.functions.aggregates import (
    AccLane, AggregateFunction, _add_combine, _masked, _minmax_identity_for,
    _saturating_i64, register_aggregate, scatter_add, scatter_minmax,
    scatter_prod,
)


# ------------------------------------------------------------ min_by/max_by

def _cmp_lane_dtype(t) -> np.dtype:
    """The comparison lane's dtype for a (value, comparison) type pair."""
    assert isinstance(t, tuple) and len(t) == 2, \
        "min_by/max_by take (value, comparison)"
    return t[1].dtype


def _make_minmax_by(name: str, is_min: bool) -> None:
    def elect(accs, gids, c, m, vv, vvd):
        """Scatter the comparison optimum, elect the first row equal to
        its group's optimum and take that row's payload."""
        best, pay, pvalid, cnt = accs
        best2 = scatter_minmax(best, gids, c, is_min)
        cap = gids.shape[0]
        ng = best2.shape[0]
        gbest = best2.index_select(0, gids.clamp(0, ng - 1).long())
        is_best = m & (c == gbest)
        rows = torch.arange(cap, dtype=torch.int64, device=gids.device)
        winner = scatter_minmax(
            torch.full((ng,), cap, dtype=torch.int64, device=gids.device),
            torch.where(is_best, gids, torch.full_like(gids, ng)), rows,
            True)
        won = winner < cap
        wsafe = winner.clamp(max=cap - 1)
        new_pay = torch.where(won, vv.to(pay.dtype).index_select(0, wsafe),
                              pay)
        wvalid = (vvd.index_select(0, wsafe) if vvd is not None
                  else torch.ones_like(won))
        new_pvalid = torch.where(won, wvalid, pvalid)
        return best2, new_pay, new_pvalid, scatter_add(cnt, gids, m)

    def accumulate(accs, gids, values, mask):
        (vv, vvd), (cv, cvd) = values
        m = mask
        if cvd is not None:   # a NULL comparison value is ignored
            m = m & cvd
        ident = _minmax_identity_for(accs[0].dtype, is_min)
        return elect(accs, gids, _masked(cv.to(accs[0].dtype), m, ident),
                     m, vv, vvd)

    def combine(accs, gids, lanes, mask):
        pbest, ppay, ppvalid, pcnt = lanes
        m = mask & (pcnt > 0)
        ident = _minmax_identity_for(accs[0].dtype, is_min)
        return elect(accs, gids, _masked(pbest.to(accs[0].dtype), m, ident),
                     m, ppay, ppvalid)

    register_aggregate(AggregateFunction(
        name=name,
        resolve_type=lambda t: t[0],
        lanes=(
            AccLane("best", _cmp_lane_dtype,
                    lambda t: _minmax_identity_for(
                        torch_dtype(_cmp_lane_dtype(t)), is_min)),
            AccLane("payload", lambda t: t[0].dtype, lambda t: 0),
            AccLane("pvalid", lambda t: np.dtype(np.bool_),
                    lambda t: False),
            AccLane("count", lambda t: np.dtype(np.int64), lambda t: 0),
        ),
        accumulate=accumulate,
        combine=combine,
        extract=lambda accs, gm: (accs[1], gm & (accs[3] > 0) & accs[2]),
        lane_types=lambda t: (t[1], t[0], BOOLEAN, BIGINT),
        final_type=lambda lanes: lanes[1],
        input_type_from_lanes=lambda lts: (lts[1], lts[0]),
    ))


_make_minmax_by("min_by", True)
_make_minmax_by("max_by", False)


# ------------------------------------------- covariance / correlation

def _covar_lanes():
    return (AccLane("n", lambda t: np.dtype(np.int64), lambda t: 0),) + tuple(
        AccLane(lane, lambda t: np.dtype(np.float64), lambda t: 0.0)
        for lane in ("sx", "sy", "sxx", "syy", "sxy"))


def _covar_acc(accs, gids, values, mask):
    n, sx, sy, sxx, syy, sxy = accs
    # Presto's argument order: covar(y, x); both arguments non-NULL
    (yv, yvd), (xv, xvd) = values
    m = mask
    if yvd is not None:
        m = m & yvd
    if xvd is not None:
        m = m & xvd
    x = _masked(xv.to(torch.float64), m, 0.0)
    y = _masked(yv.to(torch.float64), m, 0.0)
    return tuple(scatter_add(a, gids, c) for a, c in
                 zip(accs, (m, x, y, x * x, y * y, x * y)))


def _covar_stats(accs):
    n, sx, sy, sxx, syy, sxy = accs
    nf = torch.clamp(n.to(torch.float64), min=1.0)
    cxy = sxy - sx * sy / nf
    cxx = torch.clamp(sxx - sx * sx / nf, min=0.0)
    cyy = torch.clamp(syy - sy * sy / nf, min=0.0)
    return n, nf, cxy, cxx, cyy, sx, sy


def _covar_samp_extract(accs, gm):
    n, nf, cxy, _, _, _, _ = _covar_stats(accs)
    return cxy / torch.clamp(nf - 1.0, min=1.0), gm & (n >= 2)


def _covar_pop_extract(accs, gm):
    n, nf, cxy, _, _, _, _ = _covar_stats(accs)
    return cxy / nf, gm & (n >= 1)


def _corr_extract(accs, gm):
    n, _, cxy, cxx, cyy, _, _ = _covar_stats(accs)
    denom = torch.sqrt(cxx * cyy)
    ok = (n >= 2) & (denom > 0)
    return (torch.where(ok, cxy / torch.clamp(denom, min=1e-300),
                        torch.full_like(cxy, float("nan"))), gm & ok)


def _regr_slope_extract(accs, gm):
    n, _, cxy, cxx, _, _, _ = _covar_stats(accs)
    ok = (n >= 2) & (cxx > 0)
    return (torch.where(ok, cxy / torch.clamp(cxx, min=1e-300),
                        torch.full_like(cxy, float("nan"))), gm & ok)


def _regr_intercept_extract(accs, gm):
    n, nf, cxy, cxx, _, sx, sy = _covar_stats(accs)
    ok = (n >= 2) & (cxx > 0)
    slope = cxy / torch.clamp(cxx, min=1e-300)
    return (torch.where(ok, (sy - slope * sx) / nf,
                        torch.full_like(cxy, float("nan"))), gm & ok)


for _name, _extract in (("covar_samp", _covar_samp_extract),
                        ("covar_pop", _covar_pop_extract),
                        ("corr", _corr_extract),
                        ("regr_slope", _regr_slope_extract),
                        ("regr_intercept", _regr_intercept_extract)):
    register_aggregate(AggregateFunction(
        name=_name,
        resolve_type=lambda t: DOUBLE,
        lanes=_covar_lanes(),
        accumulate=_covar_acc,
        combine=_add_combine,
        extract=_extract,
        lane_types=lambda t: (BIGINT,) + (DOUBLE,) * 5,
        final_type=lambda lanes: DOUBLE,
    ))


# ----------------------------------------------------- bitwise aggregates

_BITS = 64


def _bit_matrix(v64: torch.Tensor) -> torch.Tensor:
    """(rows, 64) int32 0/1 bits of int64 values, built from the two
    32-bit halves (no (rows, 64) int64 temporary)."""
    bits = torch.arange(32, dtype=torch.int32, device=v64.device)
    halves = (v64.to(torch.int32), (v64 >> 32).to(torch.int32))
    return torch.cat([(h[:, None] >> bits[None, :]) & 1 for h in halves],
                     dim=1)


def _make_bitwise(name: str, kind: str) -> None:
    def accumulate(accs, gids, values, mask):
        cnts, n = accs
        v = torch.where(mask, values.to(torch.int64),
                        torch.zeros((), dtype=torch.int64,
                                    device=values.device))
        return (scatter_add(cnts, gids, _bit_matrix(v)),
                scatter_add(n, gids, mask))

    def combine(accs, gids, lanes, mask):
        cnts, n = accs
        pcnts, pn = lanes
        return (scatter_add(cnts, gids, torch.where(
                    mask[:, None], pcnts, torch.zeros_like(pcnts))),
                scatter_add(n, gids, _masked(pn, mask, 0)))

    def extract(accs, gm):
        cnts, n = accs
        if kind == "and":
            bit = (cnts == n[:, None]).to(torch.int64)
        elif kind == "or":
            bit = (cnts > 0).to(torch.int64)
        else:
            bit = (cnts & 1).to(torch.int64)
        bits = torch.arange(_BITS, dtype=torch.int64, device=cnts.device)
        # distinct powers of two: the (wrapping) sum is their OR
        return (bit << bits[None, :]).sum(dim=1), gm & (n > 0)

    register_aggregate(AggregateFunction(
        name=name,
        resolve_type=lambda t: BIGINT,
        lanes=(
            AccLane("bitcnt", lambda t: np.dtype(np.int32), lambda t: 0,
                    width=_BITS),
            AccLane("n", lambda t: np.dtype(np.int64), lambda t: 0),
        ),
        accumulate=accumulate,
        combine=combine,
        extract=extract,
        lane_types=lambda t: (BIGINT, BIGINT),
        final_type=lambda lanes: BIGINT,
    ))


for _name, _kind in (("bitwise_and_agg", "and"), ("bitwise_or_agg", "or"),
                     ("bitwise_xor_agg", "xor")):
    _make_bitwise(_name, _kind)


# -------------------------------------------------------- approx_distinct

_HLL_M = 1024          # registers; standard error 1.04 / sqrt(m) ~ 3.25%
_HLL_LOG2M = 10

#: 2^-k for a register of rank k, and the linear-counting estimate
#: m * ln(m / z) for z zero registers (z = 0 unused)
_POW2_NEG = np.ldexp(1.0, -np.arange(64)).astype(np.float64)
_LC_TABLE = np.concatenate([
    [0.0], _HLL_M * np.log(_HLL_M / np.arange(1, _HLL_M + 1.0))])
#: the estimate's constant alpha_m * m^2, evaluated as the reference does
_HLL_ALPHA_MM = (0.7213 / (1 + 1.079 / float(_HLL_M))) * float(_HLL_M) \
    * float(_HLL_M)
#: groups whose registers the extract reads at once
_EXTRACT_GROUPS = 1 << 16


def hll_bucket_rank(values: torch.Tensor):
    """Each value's register (0..1023) and rank (1..54): a float scaled
    by 2^20 and truncated, then ``hash_i64``; the bucket is the hash's
    low 10 bits, the rank 54 minus floor(log2) of its next 53 bits, read
    off their float32 exponent (round to nearest, as the reference)."""
    from velox_tpu_torch.ops.hash import hash_i64

    if values.dtype.is_floating_point:
        v = _saturating_i64(values.to(torch.float64) * float(1 << 20))
    else:
        v = values.to(torch.int64)
    h = hash_i64(v)
    bucket = h & (_HLL_M - 1)
    rest = (h >> _HLL_LOG2M) & ((1 << 53) - 1)
    restf = torch.clamp(rest, min=1).to(torch.float32)
    e = (restf.view(torch.int32) >> 23) & 0xFF
    rank = torch.clamp(54 - (e - 127), 1, 54).to(torch.int32)
    return bucket, rank


def _hll_acc(accs, gids, values, mask):
    regs, n = accs
    bucket, rank = hll_bucket_rank(values)
    ng = regs.shape[0]
    ok = mask & (gids >= 0) & (gids < ng)
    flat = torch.where(ok, gids.long() * _HLL_M + bucket,
                       torch.full_like(bucket, ng * _HLL_M))
    ext = torch.cat([regs.reshape(-1), regs.new_zeros(1)])
    ext.scatter_reduce_(0, flat, rank, "amax", include_self=True)
    return ext[:-1].view(ng, _HLL_M), scatter_add(n, gids, mask)


def _hll_combine(accs, gids, lanes, mask):
    regs, n = accs
    pregs, pn = lanes
    ng = regs.shape[0]
    ok = mask & (gids >= 0) & (gids < ng)
    slot = torch.where(ok, gids, torch.full_like(gids, ng)).long()
    ext = torch.cat([regs, regs.new_zeros((1, _HLL_M))])
    ext.scatter_reduce_(0, slot[:, None].expand(-1, _HLL_M),
                        pregs.to(regs.dtype), "amax", include_self=True)
    return ext[:ng], scatter_add(n, gids, _masked(pn, mask, 0))


def _hll_extract(accs, gm):
    regs, n = accs
    m = float(_HLL_M)
    pow2 = torch.from_numpy(_POW2_NEG).to(regs.device)
    # 2^-rank summed a block of groups at a time: at once, the float64
    # gather and its int64 index would take 16 KiB a group
    inv_sum = torch.zeros(regs.shape[0], dtype=torch.float64,
                          device=regs.device)
    for lo in range(0, regs.shape[0], _EXTRACT_GROUPS):
        block = regs[lo:lo + _EXTRACT_GROUPS]
        inv_sum[lo:lo + _EXTRACT_GROUPS] = pow2[
            torch.clamp(block, 0, 63).long()].sum(dim=1)
    est = _HLL_ALPHA_MM / inv_sum
    zeros = (regs == 0).sum(dim=1)
    lc = torch.from_numpy(_LC_TABLE).to(regs.device)[zeros]
    est = torch.where((est <= 2.5 * m) & (zeros > 0), lc, est)
    out = torch.round(est).to(torch.int64)
    return torch.minimum(out, torch.clamp(n, min=0)), gm


register_aggregate(AggregateFunction(
    name="approx_distinct",
    resolve_type=lambda t: BIGINT,
    lanes=(
        AccLane("regs", lambda t: np.dtype(np.int32), lambda t: 0,
                width=_HLL_M),
        AccLane("n", lambda t: np.dtype(np.int64), lambda t: 0),
    ),
    accumulate=_hll_acc,
    combine=_hll_combine,
    extract=_hll_extract,
    lane_types=lambda t: (BIGINT, BIGINT),
    final_type=lambda lanes: BIGINT,
))


# ------------------------------------------------------- product, entropy

register_aggregate(AggregateFunction(
    name="product",
    resolve_type=lambda t: DOUBLE,
    lanes=(
        AccLane("p", lambda t: np.dtype(np.float64), lambda t: 1.0),
        AccLane("n", lambda t: np.dtype(np.int64), lambda t: 0),
    ),
    accumulate=lambda accs, gids, values, mask: (
        scatter_prod(accs[0], gids,
                     _masked(values.to(torch.float64), mask, 1.0)),
        scatter_add(accs[1], gids, mask)),
    combine=lambda accs, gids, lanes, mask: (
        scatter_prod(accs[0], gids, _masked(lanes[0], mask, 1.0)),
        scatter_add(accs[1], gids, _masked(lanes[1], mask, 0))),
    extract=lambda accs, gm: (accs[0], gm & (accs[1] > 0)),
    lane_types=lambda t: (DOUBLE, BIGINT),
    final_type=lambda lanes: DOUBLE,
))


def _entropy_acc(accs, gids, values, mask):
    # entropy(c), c a count per row: H = log2(S) - sum(c log2 c) / S
    n, s, slog = accs
    c = _masked(values.to(torch.float64), mask, 0.0)
    lg = torch.log2(torch.clamp(c, min=1e-30))
    return tuple(scatter_add(a, gids, x) for a, x in zip(accs, (
        mask, c, torch.where(c > 0, c * lg, torch.zeros_like(c)))))


def _entropy_extract(accs, gm):
    n, s, slog = accs
    h = (torch.log2(torch.clamp(s, min=1e-30))
         - slog / torch.clamp(s, min=1e-300))
    return torch.where(s > 0, h, torch.zeros_like(h)), gm & (n > 0)


register_aggregate(AggregateFunction(
    name="entropy",
    resolve_type=lambda t: DOUBLE,
    lanes=(
        AccLane("n", lambda t: np.dtype(np.int64), lambda t: 0),
        AccLane("s", lambda t: np.dtype(np.float64), lambda t: 0.0),
        AccLane("slog", lambda t: np.dtype(np.float64), lambda t: 0.0),
    ),
    accumulate=_entropy_acc,
    combine=_add_combine,
    extract=_entropy_extract,
    lane_types=lambda t: (BIGINT, DOUBLE, DOUBLE),
    final_type=lambda lanes: DOUBLE,
))
