"""Scalar functions of the main path (Presto semantics), over torch.

The part of the JAX package's ``functions/scalar.py`` that TPC-H Q1 and Q6
resolve: arithmetic, comparisons, ``between`` and Kleene ``and``, with the
same ``resolve_type`` rules. Decimal arithmetic is typed
by the expression compiler; the impls only see integer lanes.
"""

from __future__ import annotations

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
