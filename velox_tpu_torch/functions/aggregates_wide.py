"""Aggregates over long-decimal digit lanes (``types/widedec.py``): the
port of the JAX package's ``functions/aggregates_wide.py`` (lexicographic
MIN/MAX) and exact SUMs.

A long decimal is three signed-digit int64 lanes (d2, d1, d0) that order
exactly like the int128 values, so MIN/MAX is a lexicographic reduction:
three CHAINED scatter-mins (refine on d2, then d1 among d2-ties, then d0).
``min_wide{2,1,0}``/``max_wide{2,1,0}`` each compute the full winner and
extract one digit lane; the plan builder emits all three per call.

``sum_wide{2,1,0}`` replace the JAX package's three independent int64
sums of the digit lanes, which nothing carries between: a digit is below
2^42, so a lane wraps past about 2^21 rows a group. Here each batch's
digits split into 21-bit halves (six sums that stay exact for 2^31 rows),
and the sums carry into four lanes: three base-2^42 digits in
[0, 2^42) and a signed top digit (the multiple of 2^126), normalized
again after every merge. ``extract`` turns the value back into the
sign-magnitude digits the JAX package's lanes hold; a sum whose magnitude
no int64 top digit holds saturates it, which reassembles past 10^38, so
the result is NULL as an out-of-range DECIMAL(38) is.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from velox_tpu_torch.functions.aggregates import (
    AccLane, AggregateFunction, register_aggregate, scatter_add,
    scatter_minmax,
)
from velox_tpu_torch.types import BIGINT

_SENT = int(np.iinfo(np.int64).max)  # digits are << 2^63
_BITS = 42
_HALF = 21
_HMASK = (1 << _HALF) - 1
#: saturated top digit of a sum too large for DECIMAL(38)
_SAT = 1 << 62


def _drop(gids, mask, num_groups):
    return torch.where(mask, gids.to(torch.int64),
                       torch.full((), num_groups, dtype=torch.int64,
                                  device=gids.device))


def _lex_best(gids, d2, d1, d0, mask, num_groups, is_min):
    """Per-group lexicographic winner triple via 3 chained scatters."""
    sent = _SENT if is_min else -_SENT
    dev = gids.device

    def red(idx, v):
        acc = torch.full((num_groups,), sent, dtype=torch.int64, device=dev)
        return scatter_minmax(acc, idx, v.to(torch.int64), is_min)

    g = _drop(gids, mask, num_groups)
    safe = g.clamp(0, num_groups - 1)
    b2 = red(g, d2)
    tie2 = mask & (d2 == b2.index_select(0, safe))
    b1 = red(_drop(gids, tie2, num_groups), d1)
    tie1 = tie2 & (d1 == b1.index_select(0, safe))
    b0 = red(_drop(gids, tie1, num_groups), d0)
    return b2, b1, b0


def _lex_merge(a2, a1, a0, b2, b1, b0, is_min):
    """Elementwise lexicographic pick between two winner triples."""
    if is_min:
        take_b = (b2 < a2) | ((b2 == a2) & ((b1 < a1) | ((b1 == a1)
                                                         & (b0 < a0))))
    else:
        take_b = (b2 > a2) | ((b2 == a2) & ((b1 > a1) | ((b1 == a1)
                                                         & (b0 > a0))))
    return (torch.where(take_b, b2, a2), torch.where(take_b, b1, a1),
            torch.where(take_b, b0, a0))


#: lane index of each output digit: lanes run (d2, d1, d0)
_LANE_OF = {2: 0, 1: 1, 0: 2}


def _make_minmax(is_min: bool, out_digit: int) -> AggregateFunction:
    word = "min" if is_min else "max"
    sent = _SENT if is_min else -_SENT

    def accumulate(accs, gids, values, mask):
        (v2, va), (v1, _), (v0, _) = values
        G = accs[0].shape[0]

        def make():
            m = mask if va is None else mask & va
            return _lex_best(gids, v2, v1, v0, m, G, is_min)

        b = _memo((word, gids, mask, va, v2, v1, v0, G), make)
        return _lex_merge(*accs, *b, is_min)

    def combine(accs, gids, lanes, mask):
        p2, p1, p0 = lanes
        G = accs[0].shape[0]
        b = _memo((word + "c", gids, mask, p2, p1, p0, G),
                  lambda: _lex_best(gids, p2, p1, p0, mask, G, is_min))
        return _lex_merge(*accs, *b, is_min)

    def extract(accs, group_mask):
        seen = accs[0] != sent
        return accs[_LANE_OF[out_digit]], group_mask & seen

    return AggregateFunction(
        name=f"{word}_wide{out_digit}",
        resolve_type=lambda t: BIGINT,
        lanes=tuple(AccLane(f"d{d}", lambda at: np.dtype(np.int64),
                            lambda at, s=sent: s) for d in (2, 1, 0)),
        accumulate=accumulate,
        combine=combine,
        extract=extract,
        lane_types=lambda at: (BIGINT, BIGINT, BIGINT),
        final_type=lambda lts: BIGINT,
    )


# ------------------------------------------------------------- exact sum

def _normalize(d3, d2, d1, d0):
    """Carry (d3, d2, d1, d0) (value = sum d_i 2^(42 i)) into digits
    d0..d2 in [0, 2^42) and a signed top digit; every input digit is
    below 2^62 in magnitude."""
    mask = (1 << _BITS) - 1
    c = d0 >> _BITS
    d0 = d0 & mask
    d1 = d1 + c
    c = d1 >> _BITS
    d1 = d1 & mask
    d2 = d2 + c
    c = d2 >> _BITS
    d2 = d2 & mask
    return d3 + c, d2, d1, d0


def _from_halves(parts, top):
    """Carry six sums of 21-bit half digits (``parts[k]`` weighs
    2^(21 k), each below 2^53 in magnitude) and a top digit (weighing
    2^126) into the normalized four digits."""
    c = torch.zeros_like(parts[0])
    halves = []
    for p in parts:
        t = p + c
        halves.append(t & _HMASK)       # floor modulo: in [0, 2^21)
        c = t >> _HALF                  # floor division
    d0 = halves[0] | (halves[1] << _HALF)
    d1 = halves[2] | (halves[3] << _HALF)
    d2 = halves[4] | (halves[5] << _HALF)
    return top + c, d2, d1, d0


def _half_sums(g, digits, num_groups):
    """Per-group sums of the two signed 21-bit halves of each digit lane
    (``digits`` low first; rows with ``g`` out of range drop): exact for
    2^31 rows of digits below 2^43."""
    parts = []
    for d in digits:
        d = d.to(torch.int64)
        hi = torch.div(d, 1 << _HALF, rounding_mode="trunc")  # d's sign
        for half in (d - (hi << _HALF), hi):
            acc = torch.zeros(num_groups, dtype=torch.int64, device=g.device)
            parts.append(scatter_add(acc, g, half))
    return parts


#: the last batch's key and result of ``_memo``: the three digit
#: aggregates of one sum (min, max) read the same lanes and compute the
#: same thing
_LAST: list = [None, None]


def _memo(key: tuple, make):
    """``make()``, or the previous call's result when ``key`` (tensors,
    compared by identity through weak references, so a freed tensor
    never matches, and plain values) is the previous call's."""
    ref = tuple(weakref.ref(a) if isinstance(a, torch.Tensor) else a
                for a in key)
    prev = _LAST[0]
    if prev is not None and len(prev) == len(ref) and all(
            (p() is a) if isinstance(p, weakref.ref) else p == a
            for p, a in zip(prev, key)):
        return _LAST[1]
    _LAST[0], _LAST[1] = ref, make()
    return _LAST[1]


def _batch_sums(gids, lanes, mask, num_groups):
    """The four normalized digits of each group's sum of one batch of
    sign-magnitude digit lanes ``(d2, d1, d0)``."""
    g = _drop(gids, mask, num_groups)
    parts = _half_sums(g, tuple(reversed(lanes)), num_groups)
    return _from_halves(parts, torch.zeros_like(parts[0]))


def _add(accs, b):
    s = tuple(a + x for a, x in zip(accs, b))
    return _normalize(*s)


def _sign_magnitude(d3, d2, d1, d0):
    """The sign-magnitude digits (d2, d1, d0) of the value, each carrying
    the value's sign; the magnitude's top folds into d2, saturated where
    it leaves int64."""
    neg = d3 < 0
    n3, n2, n1, n0 = _normalize(-d3, -d2, -d1, -d0)
    m3 = torch.where(neg, n3, d3)
    m2 = torch.where(neg, n2, d2)
    m1 = torch.where(neg, n1, d1)
    m0 = torch.where(neg, n0, d0)
    big = m3 >= (1 << (62 - _BITS))
    top = torch.where(big, torch.full_like(m3, _SAT), (m3 << _BITS) + m2)
    sign = torch.where(neg, torch.full_like(m3, -1), torch.ones_like(m3))
    return sign * top, sign * m1, sign * m0


def _make_sum(out_digit: int) -> AggregateFunction:
    def accumulate(accs, gids, values, mask):
        (v2, va), (v1, _), (v0, _) = values
        G = accs[0].shape[0]

        def make():
            m = mask if va is None else mask & va
            return _batch_sums(gids, (v2, v1, v0), m, G)

        return _add(accs, _memo(("sum", gids, mask, va, v2, v1, v0, G),
                                make))

    def combine(accs, gids, lanes, mask):
        # partial lanes are normalized sums (d3, d2, d1, d0): the three
        # low digits sum in halves, the small top digit directly
        G = accs[0].shape[0]
        d3, d2, d1, d0 = lanes

        def make():
            g = _drop(gids, mask, G)
            parts = _half_sums(g, (d0, d1, d2), G)
            return _from_halves(parts, scatter_add(
                torch.zeros_like(parts[0]), g, d3))

        return _add(accs, _memo(("combine", gids, mask, *lanes, G), make))

    def extract(accs, group_mask):
        return (_sign_magnitude(*accs)[_LANE_OF[out_digit]], group_mask)

    return AggregateFunction(
        name=f"sum_wide{out_digit}",
        resolve_type=lambda t: BIGINT,
        lanes=tuple(AccLane(f"d{d}", lambda at: np.dtype(np.int64),
                            lambda at: 0) for d in (3, 2, 1, 0)),
        accumulate=accumulate,
        combine=combine,
        extract=extract,
        lane_types=lambda at: (BIGINT, BIGINT, BIGINT, BIGINT),
        final_type=lambda lts: BIGINT,
        input_type_from_lanes=lambda lts: (BIGINT, BIGINT, BIGINT),
    )


def register_wide_aggregates() -> None:
    for is_min in (True, False):
        for d in (2, 1, 0):
            register_aggregate(_make_minmax(is_min, d))
    for d in (2, 1, 0):
        register_aggregate(_make_sum(d))
