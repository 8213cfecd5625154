"""Scalar functions of the main path (Presto semantics), over torch.

The part of the JAX package's ``functions/scalar.py`` that the 22 TPC-H
queries resolve: arithmetic (integer division truncates toward zero, and
a zero divisor gives NULL), comparisons, ``between``, ``in``, Kleene
``and``/``or``, ``not``, ``if``/``switch`` (a NULL condition takes the
next branch), ``year`` (Howard Hinnant's civil-from-days in integer
lanes), and the dynamic-filter forms joins push into scans
(``__in_table``, ``__bloom_contains``), with the same ``resolve_type``
rules. Decimal arithmetic is typed by the expression compiler; the impls
only see integer lanes. ``like`` and ``substr`` are rewritten into
dictionary lookups when the compiler binds strings, so their impls only
raise.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from velox_tpu_torch.types import BIGINT, BOOLEAN, VARCHAR
from velox_tpu_torch.types.types import DecimalType, common_numeric_type
from velox_tpu_torch.functions.registry import ScalarFunction, register_function


def _all_valid(values):
    return torch.ones(values.shape, dtype=torch.bool, device=values.device)


def _arith_type(args):
    if len(args) != 2:
        raise TypeError("binary arithmetic takes 2 args")
    a, b = args
    if isinstance(a, DecimalType) or isinstance(b, DecimalType):
        raise TypeError("decimal arithmetic resolved by compiler")
    return common_numeric_type(a, b)


def _compare_type(args):
    return BOOLEAN


# -------------------------------------------------------------- arithmetic

register_function(ScalarFunction("plus", _arith_type, lambda a, b: a + b))
register_function(ScalarFunction("minus", _arith_type, lambda a, b: a - b))
register_function(ScalarFunction("multiply", _arith_type, lambda a, b: a * b))


def _both_valid(a, va, b, vb):
    return torch.logical_and(va if va is not None else _all_valid(a),
                             vb if vb is not None else _all_valid(b))


def _div_impl(pair0, pair1):
    """Integers truncate toward zero and a zero divisor gives NULL;
    floats divide as IEEE does."""
    (a, va), (b, vb) = pair0, pair1
    if not b.dtype.is_floating_point:
        zero = b == 0
        safe_b = torch.where(zero, torch.ones_like(b), b)
        q = torch.div(torch.abs(a), torch.abs(safe_b), rounding_mode="floor")
        vals = torch.where((a < 0) ^ (safe_b < 0), -q, q)
        return vals, torch.logical_and(_both_valid(a, va, b, vb), ~zero)
    vals = a / b
    if va is None and vb is None:
        return vals, None
    return vals, _both_valid(a, va, b, vb)


register_function(ScalarFunction(
    "divide", _arith_type, _div_impl, default_nulls=False))
register_function(ScalarFunction("abs", lambda a: a[0], torch.abs))

# ------------------------------------------------------------- comparisons

register_function(ScalarFunction(
    "eq", _compare_type, lambda a, b: a == b, dictionary_safe=True))
register_function(ScalarFunction(
    "neq", _compare_type, lambda a, b: a != b, dictionary_safe=True))
register_function(ScalarFunction("lt", _compare_type, lambda a, b: a < b))
register_function(ScalarFunction("lte", _compare_type, lambda a, b: a <= b))
register_function(ScalarFunction("gt", _compare_type, lambda a, b: a > b))
register_function(ScalarFunction("gte", _compare_type, lambda a, b: a >= b))
register_function(ScalarFunction(
    "between", _compare_type,
    lambda x, lo, hi: torch.logical_and(x >= lo, x <= hi)))


# ------------------------------------------------- boolean (special forms)

def _kleene_and(*pairs):
    if all(va is None for _, va in pairs):
        # no input can be null: plain AND. Eager torch does not fuse the
        # validity algebra below away, as XLA does for the reference.
        vals = pairs[0][0]
        for v2, _ in pairs[1:]:
            vals = torch.logical_and(vals, v2)
        return vals, None
    vals, valid = pairs[0]
    if valid is None:
        valid = _all_valid(vals)
    vals = torch.logical_and(vals, valid)  # canonicalize: null lanes -> False
    false = torch.logical_and(valid, torch.logical_not(vals))
    for v2, va2 in pairs[1:]:
        if va2 is None:
            va2 = _all_valid(v2)
        f2 = torch.logical_and(va2, torch.logical_not(v2))
        false = torch.logical_or(false, f2)
        vals = torch.logical_and(vals, torch.logical_and(v2, va2))
        valid = torch.logical_or(false, torch.logical_and(valid, va2))
    return vals, valid


def _kleene_or(*pairs):
    if all(va is None for _, va in pairs):
        vals = pairs[0][0]
        for v2, _ in pairs[1:]:
            vals = torch.logical_or(vals, v2)
        return vals, None
    vals, valid = pairs[0]
    if valid is None:
        valid = _all_valid(vals)
    vals = torch.logical_and(vals, valid)
    true = vals
    for v2, va2 in pairs[1:]:
        if va2 is None:
            va2 = _all_valid(v2)
        t2 = torch.logical_and(va2, v2)
        true = torch.logical_or(true, t2)
        vals = torch.logical_or(vals, t2)
        valid = torch.logical_or(true, torch.logical_and(valid, va2))
    return vals, valid


def _not_impl(pair):
    vals, valid = pair
    return torch.logical_not(vals), valid


def _taken(cond_pair):
    cv, cvalid = cond_pair
    return cv if cvalid is None else torch.logical_and(cv, cvalid)


def _if_impl(cond_pair, then_pair, *else_pair):
    taken = _taken(cond_pair)
    tv, tvalid = then_pair
    if else_pair:
        ev, evalid = else_pair[0]
    else:
        ev = torch.zeros_like(tv)
        evalid = torch.zeros(tv.shape, dtype=torch.bool, device=tv.device)
    vals = torch.where(taken, tv, ev)
    if tvalid is None and evalid is None:
        return vals, None
    tvalid = tvalid if tvalid is not None else _all_valid(tv)
    evalid = evalid if evalid is not None else _all_valid(ev)
    return vals, torch.where(taken, tvalid, evalid)


def _switch_impl(*pairs):
    """switch(c1, v1, c2, v2, ..., [else]): the first true condition
    wins."""
    n = len(pairs)
    v1 = pairs[1][0]
    if n % 2 == 1:
        vals, valid = pairs[-1]
    else:
        vals = torch.zeros_like(v1)
        valid = torch.zeros(v1.shape, dtype=torch.bool, device=v1.device)
    if valid is None:
        valid = _all_valid(vals)
    # fold back to front so the first condition has priority
    for i in reversed(range(n // 2)):
        taken = _taken(pairs[2 * i])
        tv, tvalid = pairs[2 * i + 1]
        vals = torch.where(taken, tv, vals)
        valid = torch.where(taken, tvalid if tvalid is not None
                            else _all_valid(tv), valid)
    return vals, valid


register_function(ScalarFunction(
    "and", lambda a: BOOLEAN, _kleene_and, default_nulls=False,
    dictionary_safe=True))
register_function(ScalarFunction(
    "or", lambda a: BOOLEAN, _kleene_or, default_nulls=False,
    dictionary_safe=True))
register_function(ScalarFunction(
    "not", lambda a: BOOLEAN, _not_impl, default_nulls=False))
register_function(ScalarFunction(
    "if", lambda a: a[1], _if_impl, default_nulls=False))
register_function(ScalarFunction(
    "switch", lambda a: a[1], _switch_impl, default_nulls=False))


# ------------------------------------------------------------ date parts

def _civil_year(days):
    """Year of a day number (Howard Hinnant's civil-from-days)."""
    z = days.to(torch.int32) + 719468
    era = torch.div(z, 146097, rounding_mode="floor")
    doe = z - era * 146097
    yoe = torch.div(doe - torch.div(doe, 1460, rounding_mode="floor")
                    + torch.div(doe, 36524, rounding_mode="floor")
                    - torch.div(doe, 146096, rounding_mode="floor"), 365,
                    rounding_mode="floor")
    doy = doe - (365 * yoe + torch.div(yoe, 4, rounding_mode="floor")
                 - torch.div(yoe, 100, rounding_mode="floor"))
    mp = torch.div(5 * doy + 2, 153, rounding_mode="floor")
    return yoe + era * 400 + (mp >= 10)   # months 1-2 belong to y + 1


register_function(ScalarFunction(
    "year", lambda a: BIGINT, lambda a: _civil_year(a).to(torch.int64)))


# ------------------------------------------------------ bound at bind time

def _unbound(name):
    def impl(*args):
        raise RuntimeError(
            f"{name} must be bound against a dictionary column "
            "(expr/compiler.py bind_strings) before device evaluation")
    return impl


register_function(ScalarFunction("like", _compare_type, _unbound("like")))
register_function(ScalarFunction(
    "substr", lambda a: VARCHAR, _unbound("substr")))


# ------------------------------------------------------------------ in

def _in_impl(x, *consts):
    m = x == consts[0]
    for c in consts[1:]:
        m = torch.logical_or(m, x == c)
    return m


register_function(ScalarFunction(
    "in", _compare_type, _in_impl, dictionary_safe=True))


# ------------------------------------------- dynamic-filter internals
# velox/exec/HashProbe.cpp:419-444 value-set and bloom pushdown forms. A
# table argument keeps its host values, so the impl picks its form from
# them without reading the device. The pushed filter that makes a table
# uploads the form once (``in_table_literal``, ``bloom_literal``), not
# every batch.

class DeviceTable:
    """A table argument: its host values and the device tensor that its
    function reads (None where it reads none)."""

    __slots__ = ("host", "tensor")

    def __init__(self, host: np.ndarray, tensor: Optional[torch.Tensor]):
        self.host, self.tensor = host, tensor

    def __repr__(self):
        return f"DeviceTable<#{id(self)} n={self.host.shape}>"


def _in_table_form(tb: np.ndarray) -> Optional[np.ndarray]:
    """What ``__in_table`` reads on the device for a sorted value table: a
    dense bitmask over the span when the span is at most 2^26, nothing for
    an OR-chain of at most 512 compares, else the int64 values for a
    binary search."""
    lo, hi = int(tb[0]), int(tb[-1])
    if hi - lo + 1 <= (1 << 26):
        mask = np.zeros((hi - lo + 1,), np.bool_)
        mask[tb.astype(np.int64) - lo] = True
        return mask
    return None if tb.size <= 512 else tb.astype(np.int64)


def _bloom_form(words: np.ndarray) -> np.ndarray:
    return np.asarray(words).view(np.int64)


def _table_literal(host: np.ndarray, form, device) -> DeviceTable:
    f = form(host)
    return DeviceTable(host, None if f is None
                       else torch.from_numpy(f).to(device))


def in_table_literal(values: np.ndarray, device) -> DeviceTable:
    return _table_literal(np.asarray(values), _in_table_form, device)


def bloom_literal(words: np.ndarray, device) -> DeviceTable:
    return _table_literal(np.asarray(words), _bloom_form, device)


def _in_table_impl(v, table: DeviceTable):
    """Membership of ``v`` in a sorted value table, in the form
    ``_in_table_form`` chose."""
    tb, dev = table.host, table.tensor
    if dev is None:
        m = v == int(tb[0])
        for c in tb[1:]:
            m = torch.logical_or(m, v == int(c))
        return m
    vv = v.to(torch.int64)
    if dev.dtype == torch.bool:
        span = dev.shape[0]
        vv = vv - int(tb[0])
        inb = (vv >= 0) & (vv < span)
        return inb & dev.index_select(0, vv.clamp(0, span - 1))
    idx = torch.searchsorted(dev, vv)
    inb = idx < dev.shape[0]
    hit = dev.index_select(0, idx.clamp(max=dev.shape[0] - 1)) == vv
    return inb & hit


register_function(ScalarFunction(
    "__in_table", lambda a: BOOLEAN, _in_table_impl))


def _bloom_contains_impl(v, words: DeviceTable):
    from velox_tpu_torch.ops.bloom import bloom_contains_device

    return bloom_contains_device(v, words.tensor)


register_function(ScalarFunction(
    "__bloom_contains", lambda a: BOOLEAN, _bloom_contains_impl))
