"""Aggregate functions as masked segment reductions, over torch.

The port of the JAX package's ``functions/aggregates.py``: its 19
single-argument aggregates (``sum``, ``count``, ``count_if``, ``avg``,
``min``, ``max``, the variance family, ``bool_and``/``bool_or``,
``arbitrary``, ``checksum``, ``geometric_mean``, ``skewness``,
``kurtosis``). An accumulator is a struct of tensors, one
per lane, of shape ``(num_groups,)``; accumulation is a scatter-add of
the whole batch into them. Group ids outside ``[0, num_groups)`` (the
sentinel of inactive rows) are dropped.

Under ``narrow_lanes`` the sums and counts of 32-bit integer lanes go
through ``_narrow_segment_sum``/``_narrow_segment_count``: for
2 <= G <= 128 groups they call the grouped-sum kernel B1
(``ops/grouped_sum.py``), which dispatches on the tensor's device; the
keyless case and G > 128 stay plain torch, as they stay outside any
kernel in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from velox_tpu_torch import torch_dtype
from velox_tpu_torch.types import BIGINT, BOOLEAN, DOUBLE, REAL, DataType
from velox_tpu_torch.types.types import DecimalType, TypeKind


@dataclass(frozen=True)
class AccLane:
    """One accumulator lane: a device tensor with an identity value."""

    name: str
    dtype_of: Callable[[Optional[DataType]], np.dtype]
    init_of: Callable[[Optional[DataType]], object]
    #: the associative reduction this lane is ("add", "min", "max"): the streaming
    #: aggregation's segmented-scan path needs one on every lane
    scan_op: Optional[str] = None


@dataclass(frozen=True)
class AggregateFunction:
    name: str
    #: input type (or None for count(*)) -> result type
    resolve_type: Callable[[Optional[DataType]], DataType]
    lanes: Tuple[AccLane, ...]
    #: accumulate(accs, gids, values, mask) -> new accs; values is None
    #: for count(*); mask already includes input validity
    accumulate: Callable
    #: combine(accs, gids, partial_lane_tensors, mask) -> new accs
    combine: Callable
    #: extract(accs, group_mask) -> (values, valid) of the result type
    extract: Callable
    #: intermediate (partial) output types, parallel to lanes
    lane_types: Callable[[Optional[DataType]], Tuple[DataType, ...]]
    #: per-row lane contributions for the streaming aggregation:
    #: (values, mask, arg_type) -> one tensor per lane, in the lane's
    #: dtype, masked rows at the lane identity
    lane_contribs: Optional[Callable] = None

    @property
    def scannable(self) -> bool:
        return (self.lane_contribs is not None
                and all(lane.scan_op is not None for lane in self.lanes))


aggregate_registry: Dict[str, AggregateFunction] = {}


def register_aggregate(fn: AggregateFunction) -> None:
    aggregate_registry[fn.name] = fn


def lookup_aggregate(name: str) -> AggregateFunction:
    try:
        return aggregate_registry[name]
    except KeyError:
        raise KeyError(
            f"no aggregate {name!r}; registered: {sorted(aggregate_registry)}"
        )


# ------------------------------------------------------------------ helpers

def _masked(values: torch.Tensor, mask: torch.Tensor, identity):
    return torch.where(mask, values,
                       torch.zeros((), dtype=values.dtype,
                                   device=values.device) + identity)


def scatter_add(acc: torch.Tensor, gids: torch.Tensor,
                values: torch.Tensor) -> torch.Tensor:
    """``acc.at[gids].add(values, mode="drop")``: out-of-range gids drop
    into a spare bin."""
    G = acc.shape[0]
    g = torch.where((gids >= 0) & (gids < G), gids,
                    torch.full_like(gids, G)).long()
    ext = torch.cat([acc, acc.new_zeros(1)])
    ext.index_add_(0, g, values.to(acc.dtype))
    return ext[:G]


_CHUNK_BITS = 16  # rows per overflow-safe chunk in the JAX narrow path


def _narrow_sum_applicable(acc: torch.Tensor, values) -> bool:
    """Take the exact 32-bit grouped-sum path? (same gate as the JAX
    package: narrow lanes, an int64 accumulator, <= 32-bit integer
    values, and a bounded groups x chunks cell count)."""
    from velox_tpu_torch.utils.config import config

    if values is None:
        return False
    if not config.narrow_lanes or acc.dtype != torch.int64:
        return False
    if values.dtype.is_floating_point or values.dtype == torch.bool:
        return False
    if values.element_size() > 4:
        return False
    chunks = (values.shape[0] + (1 << _CHUNK_BITS) - 1) >> _CHUNK_BITS
    return acc.shape[0] * chunks <= (1 << 22)


def _narrow_segment_sum(gids: torch.Tensor, contrib_i32: torch.Tensor,
                        n_groups: int) -> torch.Tensor:
    """Exact int64 per-group sums of 32-bit contributions."""
    if n_groups == 1:
        masked = torch.where(gids < 1, contrib_i32.to(torch.int64),
                             torch.zeros((), dtype=torch.int64,
                                         device=gids.device))
        return masked.sum()[None]
    if 2 <= n_groups <= 128:
        from velox_tpu_torch.ops.grouped_sum import grouped_sum_i32

        return grouped_sum_i32(
            gids.to(torch.int32).contiguous(),
            contrib_i32.to(torch.int32).contiguous(), n_groups)
    acc = torch.zeros((n_groups,), dtype=torch.int64, device=gids.device)
    return scatter_add(acc, gids, contrib_i32)


def _narrow_segment_count(gids: torch.Tensor, mask: torch.Tensor,
                          n_groups: int) -> torch.Tensor:
    """Exact int64 per-group counts of ``mask``."""
    return _narrow_segment_sum(gids, mask.to(torch.int32), n_groups)


def _sum_result_type(t: Optional[DataType]) -> DataType:
    if t is None:
        raise TypeError("sum takes an argument")
    if isinstance(t, DecimalType):
        # Presto: sum(decimal(p,s)) -> decimal(38,s); kept on int64 lanes
        return DecimalType(TypeKind.DECIMAL, 18, t.scale)
    if t.is_integer:
        return BIGINT
    if t.kind == TypeKind.REAL:
        return REAL
    return DOUBLE


def _sum_lane_dtype(t: Optional[DataType]) -> np.dtype:
    return _sum_result_type(t).dtype


# ---------------------------------------------------------------------- sum

def _sum_acc(accs, gids, values, mask):
    (s, cnt) = accs
    if _narrow_sum_applicable(s, values):
        vm = torch.where(mask, values, torch.zeros((), dtype=values.dtype,
                                                   device=values.device))
        s = s + _narrow_segment_sum(gids, vm, s.shape[0])
        cnt = cnt + _narrow_segment_count(gids, mask, cnt.shape[0])
        return (s, cnt)
    v = _masked(values.to(s.dtype), mask, 0)
    s = scatter_add(s, gids, v)
    cnt = scatter_add(cnt, gids, mask)
    return (s, cnt)


def _sum_combine(accs, gids, lanes, mask):
    (s, cnt) = accs
    ps, pcnt = lanes
    s = scatter_add(s, gids, _masked(ps, mask, 0))
    cnt = scatter_add(cnt, gids, _masked(pcnt, mask, 0))
    return (s, cnt)


def _sum_extract(accs, group_mask):
    (s, cnt) = accs
    return s, torch.logical_and(group_mask, cnt > 0)


register_aggregate(AggregateFunction(
    name="sum",
    resolve_type=_sum_result_type,
    lanes=(
        AccLane("sum", _sum_lane_dtype, lambda t: 0, scan_op="add"),
        AccLane("count", lambda t: np.dtype(np.int64), lambda t: 0,
                scan_op="add"),
    ),
    accumulate=_sum_acc,
    combine=_sum_combine,
    extract=_sum_extract,
    lane_types=lambda t: (_sum_result_type(t), BIGINT),
    lane_contribs=lambda values, mask, at: (
        _masked(values.to(torch_dtype(_sum_lane_dtype(at))), mask, 0),
        mask.to(torch.int64)),
))


# -------------------------------------------------------------------- count

def _count_acc(accs, gids, values, mask):
    (cnt,) = accs
    from velox_tpu_torch.utils.config import config

    if config.narrow_lanes and cnt.shape[0] * (
            (mask.shape[0] + (1 << _CHUNK_BITS) - 1)
            >> _CHUNK_BITS) <= (1 << 22):
        return (cnt + _narrow_segment_count(gids, mask, cnt.shape[0]),)
    return (scatter_add(cnt, gids, mask),)


def _count_combine(accs, gids, lanes, mask):
    (cnt,) = accs
    (pcnt,) = lanes
    return (scatter_add(cnt, gids, _masked(pcnt, mask, 0)),)


register_aggregate(AggregateFunction(
    name="count",
    resolve_type=lambda t: BIGINT,
    lanes=(AccLane("count", lambda t: np.dtype(np.int64), lambda t: 0,
                   scan_op="add"),),
    accumulate=_count_acc,
    combine=_count_combine,
    extract=lambda accs, gm: (accs[0], gm),
    lane_types=lambda t: (BIGINT,),
    lane_contribs=lambda values, mask, at: (mask.to(torch.int64),),
))


register_aggregate(AggregateFunction(
    name="count_if",
    resolve_type=lambda t: BIGINT,
    lanes=(AccLane("count", lambda t: np.dtype(np.int64), lambda t: 0,
                   scan_op="add"),),
    accumulate=lambda accs, gids, values, mask: (
        scatter_add(accs[0], gids, mask & values),),
    combine=_count_combine,
    extract=lambda accs, gm: (accs[0], gm),
    lane_types=lambda t: (BIGINT,),
    lane_contribs=lambda values, mask, at: ((mask & values).to(torch.int64),),
))


# ------------------------------------------------------------------ min/max

def _minmax_identity_for(dt: torch.dtype, is_min: bool):
    if dt.is_floating_point:
        return float("inf") if is_min else float("-inf")
    if dt == torch.bool:
        return is_min
    info = torch.iinfo(dt)
    return info.max if is_min else info.min


def _minmax_identity(t: DataType, is_min: bool):
    return _minmax_identity_for(torch_dtype(t.dtype), is_min)


def scatter_minmax(acc: torch.Tensor, gids: torch.Tensor,
                   values: torch.Tensor, is_min: bool) -> torch.Tensor:
    """``acc.at[gids].min(values, mode="drop")`` (or max). A bool lane
    reduces as uint8 (CUDA has no bool ``scatter_reduce_``)."""
    if acc.dtype == torch.bool:
        return scatter_minmax(acc.to(torch.uint8), gids,
                              values.to(torch.uint8), is_min).to(torch.bool)
    G = acc.shape[0]
    g = torch.where((gids >= 0) & (gids < G), gids,
                    torch.full_like(gids, G)).long()
    ext = torch.cat([acc, acc.new_full(
        (1,), _minmax_identity_for(acc.dtype, is_min))])
    ext.scatter_reduce_(0, g, values.to(acc.dtype),
                        "amin" if is_min else "amax", include_self=True)
    return ext[:G]


def _make_minmax(name: str, is_min: bool) -> None:
    def acc_fn(accs, gids, values, mask):
        (m, cnt) = accs
        v = _masked(values.to(m.dtype), mask,
                    _minmax_identity_for(m.dtype, is_min))
        return (scatter_minmax(m, gids, v, is_min),
                scatter_add(cnt, gids, mask))

    def combine_fn(accs, gids, lanes, mask):
        (m, cnt) = accs
        pm, pcnt = lanes
        v = _masked(pm.to(m.dtype), mask,
                    _minmax_identity_for(m.dtype, is_min))
        return (scatter_minmax(m, gids, v, is_min),
                scatter_add(cnt, gids, _masked(pcnt, mask, 0)))

    register_aggregate(AggregateFunction(
        name=name,
        resolve_type=lambda t: t,
        lanes=(
            AccLane(name, lambda t: t.dtype,
                    lambda t: _minmax_identity(t, is_min),
                    scan_op="min" if is_min else "max"),
            AccLane("count", lambda t: np.dtype(np.int64), lambda t: 0,
                    scan_op="add"),
        ),
        accumulate=acc_fn,
        combine=combine_fn,
        extract=lambda accs, gm: (accs[0],
                                  torch.logical_and(gm, accs[1] > 0)),
        lane_types=lambda t: (t, BIGINT),
        lane_contribs=lambda values, mask, at: (
            _masked(values.to(torch_dtype(at.dtype)), mask,
                    _minmax_identity(at, is_min)),
            mask.to(torch.int64)),
    ))


_make_minmax("min", True)
_make_minmax("max", False)


# ---------------------------------------------------------------------- avg

def _avg_result_type(t):
    if isinstance(t, DecimalType):
        return t
    if t.kind == TypeKind.REAL:
        return REAL
    return DOUBLE


def _avg_extract(accs, gm):
    (s, cnt) = accs
    safe = torch.clamp(cnt, min=1)
    if not s.dtype.is_floating_point:
        # decimal avg: integer division rounding half away from zero
        q = torch.div(torch.abs(s) + torch.div(safe, 2, rounding_mode="floor"),
                      safe, rounding_mode="floor")
        vals = torch.sign(s) * q
    else:
        vals = s / safe.to(s.dtype)
    return vals, torch.logical_and(gm, cnt > 0)


register_aggregate(AggregateFunction(
    name="avg",
    resolve_type=_avg_result_type,
    lanes=(
        # decimal averages accumulate in a wide int64 lane whatever the
        # (possibly narrow) input lane: sums overflow int32
        AccLane("sum", lambda t: np.dtype(np.int64)
                if isinstance(t, DecimalType) else np.dtype(np.float64),
                lambda t: 0, scan_op="add"),
        AccLane("count", lambda t: np.dtype(np.int64), lambda t: 0,
                scan_op="add"),
    ),
    accumulate=_sum_acc,
    combine=_sum_combine,
    extract=_avg_extract,
    lane_types=lambda t: (
        DOUBLE if not isinstance(t, DecimalType) else t, BIGINT),
    lane_contribs=lambda values, mask, at: (
        _masked(values.to(torch.int64 if isinstance(at, DecimalType)
                          else torch.float64), mask, 0),
        mask.to(torch.int64)),
))


# ---------------------------------------------------------- variance family

def _var_lanes():
    return (
        AccLane("n", lambda t: np.dtype(np.int64), lambda t: 0,
                scan_op="add"),
        AccLane("sum", lambda t: np.dtype(np.float64), lambda t: 0.0,
                scan_op="add"),
        AccLane("sumsq", lambda t: np.dtype(np.float64), lambda t: 0.0,
                scan_op="add"),
    )


def _var_contribs(values, mask, at):
    v = _masked(values.to(torch.float64), mask, 0.0)
    return (mask.to(torch.int64), v, v * v)


def _var_acc(accs, gids, values, mask):
    n, s, ss = accs
    v = _masked(values.to(torch.float64), mask, 0.0)
    return (scatter_add(n, gids, mask), scatter_add(s, gids, v),
            scatter_add(ss, gids, v * v))


def _add_combine(accs, gids, lanes, mask):
    """Combine lane by lane, every lane a sum."""
    return tuple(scatter_add(a, gids, _masked(p.to(a.dtype), mask, 0))
                 for a, p in zip(accs, lanes))


def _make_var(name: str, sample: bool, stddev: bool) -> None:
    # raw power sums and the JAX package's extract, formula for formula
    def extract(accs, gm):
        n, s, ss = accs
        nf = n.to(torch.float64)
        safe_n = torch.clamp(nf, min=1.0)
        m2 = ss - s * s / safe_n
        denom = torch.clamp(nf - 1.0, min=1.0) if sample else safe_n
        var = torch.clamp(m2, min=0.0) / denom
        out = torch.sqrt(var) if stddev else var
        return out, torch.logical_and(gm, n >= (2 if sample else 1))

    register_aggregate(AggregateFunction(
        name=name,
        resolve_type=lambda t: DOUBLE,
        lanes=_var_lanes(),
        accumulate=_var_acc,
        combine=_add_combine,
        extract=extract,
        lane_types=lambda t: (BIGINT, DOUBLE, DOUBLE),
        lane_contribs=_var_contribs,
    ))


_make_var("variance", True, False)
_make_var("var_samp", True, False)
_make_var("var_pop", False, False)
_make_var("stddev", True, True)
_make_var("stddev_samp", True, True)
_make_var("stddev_pop", False, True)


# ------------------------------------------------------------ bool_and/or

def _make_bool(name: str, is_and: bool) -> None:
    # a scatter-min (and) or scatter-max (or) of a bool lane
    def acc_fn(accs, gids, values, mask):
        return (scatter_minmax(accs[0], gids, _masked(values, mask, is_and),
                               is_and),
                scatter_add(accs[1], gids, mask))

    def combine_fn(accs, gids, lanes, mask):
        return (scatter_minmax(accs[0], gids, _masked(lanes[0], mask, is_and),
                               is_and),
                scatter_add(accs[1], gids, _masked(lanes[1], mask, 0)))

    register_aggregate(AggregateFunction(
        name=name,
        resolve_type=lambda t: BOOLEAN,
        lanes=(
            AccLane("all" if is_and else "any", lambda t: np.dtype(np.bool_),
                    lambda t: is_and),
            AccLane("count", lambda t: np.dtype(np.int64), lambda t: 0),
        ),
        accumulate=acc_fn,
        combine=combine_fn,
        extract=lambda accs, gm: (accs[0],
                                  torch.logical_and(gm, accs[1] > 0)),
        lane_types=lambda t: (BOOLEAN, BIGINT),
    ))


_make_bool("bool_and", True)
_make_bool("bool_or", False)


# -------------------------------------------------------- arbitrary / any

def _arb_acc(accs, gids, values, mask):
    """A scatter-max with the min identity, so a masked row never wins:
    deterministic (each group's largest value; over a VARCHAR the code of
    the last string in its sorted dictionary), and a group with no value
    keeps the identity, which its count of 0 nulls at extract."""
    ident = _minmax_identity_for(accs[0].dtype, False)
    return (
        scatter_minmax(accs[0], gids, _masked(values.to(accs[0].dtype),
                                              mask, ident), False),
        scatter_add(accs[1], gids, mask),
    )


def _arb_combine(accs, gids, lanes, mask):
    ident = _minmax_identity_for(accs[0].dtype, False)
    m = mask & (lanes[1] > 0)   # empty partials are inert
    return (
        scatter_minmax(accs[0], gids, _masked(lanes[0].to(accs[0].dtype),
                                              m, ident), False),
        scatter_add(accs[1], gids, _masked(lanes[1], mask, 0)),
    )


register_aggregate(AggregateFunction(
    name="arbitrary",
    resolve_type=lambda t: t,
    lanes=(
        AccLane("val", lambda t: t.dtype,
                lambda t: _minmax_identity(t, False)),
        AccLane("count", lambda t: np.dtype(np.int64), lambda t: 0),
    ),
    accumulate=_arb_acc,
    combine=_arb_combine,
    extract=lambda accs, gm: (accs[0], torch.logical_and(gm, accs[1] > 0)),
    lane_types=lambda t: (t, BIGINT),
))


# ------------------------------------------------ moment/hash aggregates
# (velox/functions/prestosql/aggregates: ChecksumAggregate.h,
#  GeometricMeanAggregate, CentralMomentsAggregates.h)

def _saturating_i64(x: torch.Tensor) -> torch.Tensor:
    """A float to int64 as XLA converts it: toward zero, NaN to 0 and
    out-of-range values (the infinities too) to the nearest int64 bound.
    (torch's own cast gives int64 min for all of these on the CPU.)"""
    big = float(2 ** 63)
    inr = (x > -big) & (x < big)
    t = torch.where(inr, x, torch.zeros_like(x)).to(torch.int64)
    t = torch.where(x >= big, torch.full_like(t, 2 ** 63 - 1), t)
    t = torch.where(x <= -big, torch.full_like(t, -2 ** 63), t)
    return t


def _checksum_acc(accs, gids, values, mask):
    from velox_tpu_torch.ops.hash import hash_i64

    (x,) = accs
    v = (_saturating_i64(values * 1e6) if values.dtype.is_floating_point
         else values.to(torch.int64))
    h = _masked(hash_i64(v), mask, 0)
    return (scatter_add(x, gids, h),)   # an order-independent wrapping sum


register_aggregate(AggregateFunction(
    name="checksum",
    resolve_type=lambda t: BIGINT,
    lanes=(AccLane("x", lambda t: np.dtype(np.int64), lambda t: 0),),
    accumulate=_checksum_acc,
    combine=_add_combine,
    extract=lambda accs, gm: (accs[0], gm),
    lane_types=lambda t: (BIGINT,),
))


def _geomean_acc(accs, gids, values, mask):
    n, sl = accs
    v = values.to(torch.float64)
    ok = mask & (v > 0)
    logs = torch.log(torch.clamp(v, min=1e-300))
    return (scatter_add(n, gids, ok),
            scatter_add(sl, gids, _masked(logs, ok, 0.0)))


register_aggregate(AggregateFunction(
    name="geometric_mean",
    resolve_type=lambda t: DOUBLE,
    lanes=(
        AccLane("n", lambda t: np.dtype(np.int64), lambda t: 0),
        AccLane("sumlog", lambda t: np.dtype(np.float64), lambda t: 0.0),
    ),
    accumulate=_geomean_acc,
    combine=_add_combine,
    extract=lambda accs, gm: (
        torch.exp(accs[1] / torch.clamp(accs[0].to(torch.float64), min=1.0)),
        torch.logical_and(gm, accs[0] > 0)),
    lane_types=lambda t: (BIGINT, DOUBLE),
))


def _moments_lanes():
    return (AccLane("n", lambda t: np.dtype(np.int64), lambda t: 0),) + tuple(
        AccLane(f"s{k}", lambda t: np.dtype(np.float64), lambda t: 0.0)
        for k in range(1, 5))


def _moments_acc(accs, gids, values, mask):
    n, s1, s2, s3, s4 = accs
    v = _masked(values.to(torch.float64), mask, 0.0)
    v2 = v * v
    return (scatter_add(n, gids, mask), scatter_add(s1, gids, v),
            scatter_add(s2, gids, v2), scatter_add(s3, gids, v2 * v),
            scatter_add(s4, gids, v2 * v2))


def _make_moments(name: str, kurt: bool) -> None:
    # raw power sums and the JAX package's extract, formula for formula
    def extract(accs, gm):
        n, s1, s2, s3, s4 = accs
        nf = torch.clamp(n.to(torch.float64), min=1.0)
        m = s1 / nf
        m2 = torch.clamp(s2 / nf - m * m, min=0.0)
        # x ** 3 and x ** 4 multiply as XLA's integer_pow does
        m3 = s3 / nf - 3 * m * s2 / nf + 2 * (m * (m * m))
        m4 = (s4 / nf - 4 * m * s3 / nf + 6 * m * m * s2 / nf
              - 3 * ((m * m) * (m * m)))
        sd = torch.sqrt(torch.clamp(m2, min=1e-300))
        nn = nf
        if kurt:
            # Presto kurtosis: the sample excess kurtosis
            g2 = m4 / torch.clamp(m2 * m2, min=1e-300) - 3.0
            out = ((nn - 1) / torch.clamp((nn - 2) * (nn - 3), min=1.0)
                   * ((nn + 1) * g2 + 6))
            ok = n >= 4
        else:
            # Presto skewness: the sample skewness
            g1 = m3 / torch.clamp(sd * (sd * sd), min=1e-300)
            out = (torch.sqrt(torch.clamp(nn * (nn - 1), min=0.0))
                   / torch.clamp(nn - 2, min=1.0) * g1)
            ok = n >= 3
        return out, torch.logical_and(gm, ok)

    register_aggregate(AggregateFunction(
        name=name,
        resolve_type=lambda t: DOUBLE,
        lanes=_moments_lanes(),
        accumulate=_moments_acc,
        combine=_add_combine,
        extract=extract,
        lane_types=lambda t: (BIGINT, DOUBLE, DOUBLE, DOUBLE, DOUBLE),
    ))


_make_moments("skewness", False)
_make_moments("kurtosis", True)


def init_lane(lane: AccLane, arg_type, cap: int,
              device: torch.device) -> torch.Tensor:
    """A fresh ``(cap,)`` accumulator lane at its identity."""
    return torch.full((cap,), lane.init_of(arg_type),
                      dtype=torch_dtype(lane.dtype_of(arg_type)),
                      device=device)
