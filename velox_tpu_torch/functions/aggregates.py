"""Aggregate functions as masked segment reductions, over torch.

The port of the ``sum``/``count``/``avg`` part of the JAX package's
``functions/aggregates.py``. An accumulator is a struct of tensors, one
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
from velox_tpu_torch.types import BIGINT, DOUBLE, REAL, DataType
from velox_tpu_torch.types.types import DecimalType, TypeKind


@dataclass(frozen=True)
class AccLane:
    """One accumulator lane: a device tensor with an identity value."""

    name: str
    dtype_of: Callable[[Optional[DataType]], np.dtype]
    init_of: Callable[[Optional[DataType]], object]
    #: the associative reduction this lane is ("add"): the streaming
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


def init_lane(lane: AccLane, arg_type, cap: int,
              device: torch.device) -> torch.Tensor:
    """A fresh ``(cap,)`` accumulator lane at its identity."""
    return torch.full((cap,), lane.init_of(arg_type),
                      dtype=torch_dtype(lane.dtype_of(arg_type)),
                      device=device)
