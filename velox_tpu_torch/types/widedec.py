"""Long-decimal (int128) digit-split lanes (a copy of the JAX package's
``types/widedec.py``).

The reference computes DECIMAL(p>18) on int128 (velox/type/HugeInt.h,
velox/type/DecimalUtil.h). TPUs have no 128-bit lanes and emulate even
64-bit scatters poorly, so a wide decimal column SHREDS at ingest into
THREE int64 digit lanes — sign-magnitude base-2^42 digits, the Q1
sum_charge trick generalized:

    value = sign * (d2 * 2^84 + d1 * 2^42 + d0),   each lane = sign * d_i

* |d0|, |d1| < 2^42; |d2| < 10^38 / 2^84 ~ 5.2e12 — every lane fits
  int64 with ~20 bits of headroom, so per-lane segment sums of up to
  ~2^20 rows cannot overflow.
* signed-digit lanes compare LEXICOGRAPHICALLY in value order (the
  sign lives in every digit), so (d2, d1, d0) is directly a sort /
  min-max / equality key.

Where the JAX package sums each digit lane on its own (and wraps past
about 2^21 rows a group), the port's ``sum_wide`` aggregates
(``functions/aggregates_wide.py``) carry between the lanes.

Lane columns are named ``{col}#w2|#w1|#w0``; the logical column keeps
its DECIMAL(p, s) in its lane names and the table's ``wide_groups``, and
reassembles to ``decimal.Decimal`` values in ``run_plan``'s result.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

BASE_BITS = 42
BASE = 1 << BASE_BITS
MASK = BASE - 1

def lane_names(col: str, scale: int) -> List[str]:
    """Lane columns ``{col}#w{digit}s{scale}`` — the decimal scale rides
    the name so every layer (resolve, aggregation rewrite, arrow
    output) recovers it without side-channel metadata."""
    return [f"{col}#w{d}s{scale}" for d in (2, 1, 0)]


def parse_lane(name: str):
    """(base, digit, scale) for a wide-decimal lane name, else None."""
    i = name.rfind("#w")
    if i < 0:
        return None
    tail = name[i + 2:]
    j = tail.find("s")
    if j < 1:
        return None
    try:
        return name[:i], int(tail[:j]), int(tail[j + 1:])
    except ValueError:
        return None


def split_ints(values) -> Tuple[np.ndarray, ...]:
    """Python ints -> three signed-digit int64 arrays (None -> 0). One
    elementwise pass of Python-int arithmetic over an object array."""
    v = np.asarray(values, dtype=object).reshape(-1)
    n = len(v)
    if n == 0:
        return tuple(np.zeros(0, np.int64) for _ in range(3))
    v = np.where(np.equal(v, None), 0, v)
    neg = (v < 0).astype(bool)
    a = np.abs(v)
    s = np.where(neg, -1, 1).astype(np.int64)
    d0 = (a & MASK).astype(np.int64)
    d1 = ((a >> BASE_BITS) & MASK).astype(np.int64)
    d2 = (a >> (2 * BASE_BITS)).astype(np.int64)
    return s * d2, s * d1, s * d0


def combine_ints(d2: np.ndarray, d1: np.ndarray, d0: np.ndarray
                 ) -> List[int]:
    """Signed-digit int64 arrays -> Python ints (exact; digits may be
    un-normalized after summation — plain weighted addition of Python
    ints carries automatically)."""
    return [int(a) * (1 << (2 * BASE_BITS)) + int(b) * BASE + int(c)
            for a, b, c in zip(d2, d1, d0)]
