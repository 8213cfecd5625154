"""Noisy (differential-privacy) gaussian aggregates, over torch.

The port of the JAX package's ``functions/aggregates_noisy.py``
(velox NoisyCountGaussianAggregate.cpp, NoisyCountIfGaussianAggregate.cpp,
NoisySumGaussianAggregate.cpp, NoisyAvgGaussianAggregate.cpp): the exact
sum or count rides additive lanes, and at extract each group
slot gets one standard-normal draw ``z`` from a counter-based hash of
(seed, slot): two lowbias32 mixes, two uniforms and Box-Muller, in
float32 as the reference draws it. torch has no uint32 multiply on
every device, so the uint32 arithmetic runs in int64 masked to 32 bits.

As in the reference, a missing ``random_seed`` is seed 0, and the draw
is keyed by the group's output slot (its rank among the sorted keys in
the generic mode, its mixed-radix id in kArray, its place in the batch's
output in the streaming aggregation).
"""

from __future__ import annotations

import numpy as np
import torch

from velox_tpu_torch.types import BIGINT, DOUBLE
from velox_tpu_torch.functions.aggregates import (
    AccLane, AggregateFunction, register_aggregate, scatter_add,
    scatter_minmax,
)

_U32 = 0xFFFFFFFF
_TWO_PI_F32 = float(np.float32(2.0 * np.pi))


def _mix_u32(x: torch.Tensor) -> torch.Tensor:
    """lowbias32 finalizer of uint32 values held in int64."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _U32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & _U32
    return x ^ (x >> 16)


def group_gaussian(seed: torch.Tensor, ng: int) -> torch.Tensor:
    """One standard-normal draw per group slot (float64 of a float32
    draw): slot g hashes (seed * 2654435761) ^ 2g and ^ 2g + 1."""
    g = torch.arange(ng, dtype=torch.int64, device=seed.device)
    s = ((seed.to(torch.int64) & _U32) * 2654435761) & _U32
    h1 = _mix_u32(s ^ ((g * 2) & _U32))
    h2 = _mix_u32(s ^ ((g * 2 + 1) & _U32))
    u1 = (h1.to(torch.float32) + 0.5) * 2.0 ** -32
    u2 = (h2.to(torch.float32) + 0.5) * 2.0 ** -32
    z = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(_TWO_PI_F32 * u2)
    return z.to(torch.float64)


def _noisy_lanes():
    return (
        AccLane("sum", lambda t: np.dtype(np.float64), lambda t: 0.0),
        AccLane("count", lambda t: np.dtype(np.int64), lambda t: 0),
        AccLane("scale", lambda t: np.dtype(np.float64), lambda t: 0.0),
        AccLane("seed", lambda t: np.dtype(np.int64), lambda t: 0),
    )


def _make_noisy(name: str, kind: str, result_type) -> None:
    def accumulate(accs, gids, values, mask):
        s, n, sc, sd = accs
        (xv, xvd), (scv, _) = values[0], values[1]
        m = mask
        if xvd is not None:
            m = m & xvd
        if kind == "count_if":
            m = m & xv
        if kind in ("count", "count_if"):
            contrib = torch.ones(xv.shape, dtype=torch.float64,
                                 device=xv.device)
        else:
            contrib = xv.to(torch.float64)
        zero = torch.zeros((), dtype=torch.float64, device=xv.device)
        s = scatter_add(s, gids, torch.where(m, contrib, zero))
        n = scatter_add(n, gids, m)
        # the scale and seed of every row the mask lets in, NULL x or not
        sc = scatter_minmax(sc, gids, torch.where(
            mask, scv.to(torch.float64), zero), False)
        if len(values) > 2:
            sd = scatter_minmax(sd, gids, torch.where(
                mask, values[2][0].to(torch.int64),
                torch.zeros((), dtype=torch.int64, device=xv.device)),
                False)
        return s, n, sc, sd

    def combine(accs, gids, lanes, mask):
        s, n, sc, sd = accs
        ps, pn, psc, psd = lanes
        return (scatter_add(s, gids, torch.where(mask, ps,
                                                 torch.zeros_like(ps))),
                scatter_add(n, gids, torch.where(mask, pn,
                                                 torch.zeros_like(pn))),
                scatter_minmax(sc, gids, torch.where(
                    mask, psc, torch.zeros_like(psc)), False),
                scatter_minmax(sd, gids, torch.where(
                    mask, psd, torch.zeros_like(psd)), False))

    def extract(accs, gm):
        s, n, sc, sd = accs
        z = group_gaussian(sd, s.shape[0])
        valid = gm & (n > 0)
        if kind in ("count", "count_if"):
            return torch.clamp(torch.round(s + sc * z), min=0.0).to(
                torch.int64), valid
        if kind == "avg":
            return s / torch.clamp(n, min=1).to(torch.float64) + sc * z, \
                valid
        return s + sc * z, valid

    register_aggregate(AggregateFunction(
        name=name,
        resolve_type=lambda t: result_type,
        lanes=_noisy_lanes(),
        accumulate=accumulate,
        combine=combine,
        extract=extract,
        lane_types=lambda t: (DOUBLE, BIGINT, DOUBLE, BIGINT),
        final_type=lambda lanes: result_type,
        input_type_from_lanes=lambda lts: (DOUBLE, DOUBLE, BIGINT),
    ))


_make_noisy("noisy_count_gaussian", "count", BIGINT)
_make_noisy("noisy_count_if_gaussian", "count_if", BIGINT)
_make_noisy("noisy_sum_gaussian", "sum", DOUBLE)
_make_noisy("noisy_avg_gaussian", "avg", DOUBLE)
