"""Scalar functions of the main path (Presto semantics), over torch.

The part of the JAX package's ``functions/scalar.py`` that TPC-H Q1, Q3,
Q6 and Q18 resolve: arithmetic, comparisons, ``between``, ``in``, Kleene
``and``, and the dynamic-filter forms joins push into scans
(``__in_table``, ``__bloom_contains``), with the same ``resolve_type``
rules. Decimal arithmetic is typed by the expression compiler; the impls
only see integer lanes.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from velox_tpu_torch.types import BOOLEAN
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


register_function(ScalarFunction(
    "and", lambda a: BOOLEAN, _kleene_and, default_nulls=False,
    dictionary_safe=True))


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
