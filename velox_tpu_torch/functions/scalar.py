"""Scalar functions (Presto semantics), over torch.

The JAX package's ``functions/scalar.py`` for flat types, in three
modules: this one (arithmetic and ``mod``/``negate``, comparisons,
``between``, ``in``, Kleene ``and``/``or``, ``not``, ``if``/``switch``,
the NULL functions, math, bitwise functions and the device hashes),
``functions/dates.py`` (date parts, ``date_trunc``/``date_add``/
``date_diff`` units, timestamps) and ``functions/probability.py`` (the
CDFs and their inverses). Integer division and modulus truncate toward
zero and a zero divisor gives NULL; a NULL condition takes the next
branch. The same ``resolve_type`` rules hold. Decimal arithmetic is typed
by the expression compiler; the impls only see integer lanes. ``like``
and ``substr`` are rewritten into dictionary lookups when the compiler
binds strings, so their impls only raise; ``rand`` is a special form of
the compiler's evaluation.

Integers stay integers: torch has no unsigned 64-bit arithmetic worth the
name, so the hashes and logical shifts run in int64, where products,
sums and xors wrap as they do in uint64.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from velox_tpu_torch.types import BIGINT, BOOLEAN, DOUBLE, VARCHAR
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


def _mod_impl(pair0, pair1):
    """Integers: the remainder of truncating division (its sign follows
    the dividend) and a zero divisor gives NULL; floats: ``fmod``."""
    (a, va), (b, vb) = pair0, pair1
    if not a.dtype.is_floating_point:
        zero = b == 0
        safe_b = torch.where(zero, torch.ones_like(b), b)
        q = torch.div(torch.abs(a), torch.abs(safe_b), rounding_mode="floor")
        vals = a - torch.where((a < 0) ^ (safe_b < 0), -q, q) * safe_b
        return vals, torch.logical_and(_both_valid(a, va, b, vb), ~zero)
    vals = torch.fmod(a, b)
    if va is None and vb is None:
        return vals, None
    return vals, _both_valid(a, va, b, vb)


register_function(ScalarFunction(
    "mod", _arith_type, _mod_impl, default_nulls=False))
register_function(ScalarFunction("negate", lambda a: a[0], lambda a: -a))

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


# ------------------------------------------------------- NULL functions

def _is_null_impl(pair):
    vals, valid = pair
    if valid is None:
        return torch.zeros(vals.shape, dtype=torch.bool,
                           device=vals.device), None
    return torch.logical_not(valid), None


def _is_not_null_impl(pair):
    vals, valid = pair
    if valid is None:
        return _all_valid(vals), None
    return valid, None


def _coalesce_impl(*pairs):
    """The first non-NULL argument; the compiler has cast every argument
    to the common type."""
    vals, valid = pairs[0]
    if valid is None:
        return vals, None
    for v2, va2 in pairs[1:]:
        vals = torch.where(valid, vals, v2)
        if va2 is None:
            return vals, None
        valid = torch.logical_or(valid, va2)
    return vals, valid


def _nullif_impl(pair_a, pair_b):
    """``a``, NULL where it equals ``b`` (both non-NULL)."""
    (a, va), (b, vb) = pair_a, pair_b
    equal = a == b
    for v in (va, vb):
        if v is not None:
            equal = torch.logical_and(equal, v)
    valid = torch.logical_not(equal)
    if va is not None:
        valid = torch.logical_and(valid, va)
    return a, valid


def _distinct_from_impl(pair_a, pair_b):
    """IS DISTINCT FROM: NULLs equal each other and differ from every
    value; never NULL."""
    (a, va), (b, vb) = pair_a, pair_b
    av = va if va is not None else _all_valid(a)
    bv = vb if vb is not None else _all_valid(b)
    return torch.where(av & bv, a != b, av != bv), None


def _variadic(op):
    def impl(a, *rest):
        for b in rest:
            a = op(a, b)
        return a
    return impl


register_function(ScalarFunction(
    "is_null", lambda a: BOOLEAN, _is_null_impl, default_nulls=False,
    dictionary_safe=True))
register_function(ScalarFunction(
    "is_not_null", lambda a: BOOLEAN, _is_not_null_impl,
    default_nulls=False, dictionary_safe=True))
register_function(ScalarFunction(
    "coalesce", lambda a: a[0], _coalesce_impl, default_nulls=False))
register_function(ScalarFunction(
    "nullif", lambda a: a[0], _nullif_impl, default_nulls=False))
register_function(ScalarFunction(
    "distinct_from", lambda a: BOOLEAN, _distinct_from_impl,
    default_nulls=False))
# torch.maximum/minimum propagate NaN, as jnp.maximum/minimum do
register_function(ScalarFunction(
    "greatest", lambda a: a[0], _variadic(torch.maximum)))
register_function(ScalarFunction(
    "least", lambda a: a[0], _variadic(torch.minimum)))


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


# -------------------------------------------------------------------- math
# velox/functions/prestosql/Arithmetic.h

def _f64(a):
    return a if a.dtype == torch.float64 else a.to(torch.float64)


def _pow10(d):
    return torch.pow(10.0, _f64(d))


def _round_impl(a, d=None):
    """Half away from zero (Presto's RoundFunction), not torch.round's
    half to even; integer and decimal lanes come back unchanged."""
    if not a.dtype.is_floating_point:
        return a
    if d is None:
        return torch.sign(a) * torch.floor(torch.abs(a) + 0.5)
    scale = _pow10(d).to(a.dtype)
    return torch.sign(a) * torch.floor(torch.abs(a) * scale + 0.5) / scale


def _truncate_impl(a, *n):
    if not n:
        return torch.trunc(a) if a.dtype.is_floating_point else a
    scale = _pow10(n[0])
    return torch.trunc(a * scale) / scale


def _floor_like(op):
    def impl(a):
        return op(a) if a.dtype.is_floating_point else a
    return impl


def _sign_impl(a):
    """``jnp.sign``: NaN stays NaN and a signed zero keeps its sign."""
    s = torch.sign(a)
    if a.dtype.is_floating_point:
        s = torch.where((a == 0) | torch.isnan(a), a, s)
    return s


def _cbrt(a):
    return torch.sign(a) * torch.pow(torch.abs(a), 1.0 / 3.0)


def _width_bucket_impl(x, lo, hi, n):
    """velox/functions/prestosql/WidthBucketArray.h, the scalar form."""
    x, lo, hi = _f64(x), _f64(lo), _f64(hi)
    n = n.to(torch.int64)
    below = x < torch.minimum(lo, hi)
    above = x >= torch.maximum(lo, hi)
    frac = (x - lo) / (hi - lo)
    b = torch.floor(frac * n.to(torch.float64)).to(torch.int64) + 1
    b = torch.minimum(torch.maximum(b, torch.ones_like(b)), n)
    zero, top = torch.zeros_like(b), n + 1
    asc = torch.where(below, zero, torch.where(above, top, b))
    desc = torch.where(x > torch.maximum(lo, hi), zero,
                       torch.where(x <= torch.minimum(lo, hi), top, b))
    return torch.where(lo < hi, asc, desc)


def _clamp_impl(v, lo, hi):
    return torch.minimum(torch.maximum(v, lo.to(v.dtype)), hi.to(v.dtype))


def _pmod_impl(a, b):
    """Floor modulus (the divisor's sign), as ``jnp.mod``: the remainder
    of ``fmod`` moved into the divisor's sign; an integer zero divisor
    gives 0."""
    if a.dtype.is_floating_point:
        r = torch.fmod(a, b)
        return torch.where((r != 0) & ((r < 0) != (b < 0)), r + b, r)
    zero = b == 0
    safe_b = torch.where(zero, torch.ones_like(b), b)
    r = torch.fmod(a, safe_b)
    r = torch.where((r != 0) & ((r < 0) != (safe_b < 0)), r + safe_b, r)
    return torch.where(zero, torch.zeros_like(r), r)


def _great_circle_distance(lat1, lon1, lat2, lon2):
    """Kilometres along the sphere (haversine) with Presto's earth radius
    6371.01 (velox/functions/prestosql/GreatCircleDistance.h)."""
    p1, p2 = torch.deg2rad(lat1), torch.deg2rad(lat2)
    dl = torch.deg2rad(lon2 - lon1)
    h = (torch.sin((p2 - p1) / 2.0) ** 2
         + torch.cos(p1) * torch.cos(p2) * torch.sin(dl / 2.0) ** 2)
    return 2.0 * 6371.01 * torch.asin(torch.sqrt(torch.clamp(h, 0.0, 1.0)))


def _double(fn):
    return lambda *args: fn(*[_f64(a) for a in args])


register_function(ScalarFunction(
    "round", lambda a: a[0], _round_impl, promote_args=False))
register_function(ScalarFunction(
    "truncate", lambda a: a[0], _truncate_impl, promote_args=False))
for _name, _fn in [("floor", torch.floor), ("ceil", torch.ceil),
                   ("ceiling", torch.ceil)]:
    register_function(ScalarFunction(
        _name, lambda a: a[0], _floor_like(_fn)))
register_function(ScalarFunction("sign", lambda a: a[0], _sign_impl))
for _name, _fn in [
    ("sqrt", torch.sqrt), ("exp", torch.exp), ("ln", torch.log),
    ("power", torch.pow), ("pow", torch.pow),
    ("sin", torch.sin), ("cos", torch.cos), ("tan", torch.tan),
    ("asin", torch.asin), ("acos", torch.acos), ("atan", torch.atan),
    ("sinh", torch.sinh), ("cosh", torch.cosh), ("tanh", torch.tanh),
    ("cbrt", _cbrt), ("log2", torch.log2), ("log10", torch.log10),
    ("degrees", torch.rad2deg), ("radians", torch.deg2rad),
    ("atan2", torch.atan2),
    ("great_circle_distance", _great_circle_distance),
]:
    register_function(ScalarFunction(_name, lambda a: DOUBLE, _double(_fn)))
register_function(ScalarFunction("is_nan", _compare_type, torch.isnan))
register_function(ScalarFunction("is_finite", _compare_type, torch.isfinite))
register_function(ScalarFunction("is_infinite", _compare_type, torch.isinf))
# constants: the compiler makes the 0-d tensor on the batch's device
for _name, _value in [("pi", np.pi), ("e", np.e), ("nan", np.nan),
                      ("infinity", np.inf)]:
    register_function(ScalarFunction(
        _name, lambda a: DOUBLE, (lambda v: lambda: v)(float(_value))))
register_function(ScalarFunction(
    "width_bucket", lambda a: BIGINT, _width_bucket_impl, promote_args=False))
register_function(ScalarFunction(
    "clamp", lambda a: a[0], _clamp_impl, promote_args=False))
register_function(ScalarFunction("pmod", _arith_type, _pmod_impl))


def _data_size_impl(v):
    """Serialized bytes of a fixed-width row (strings resolve elsewhere)."""
    return torch.full(v.shape, v.element_size(), dtype=torch.int64,
                      device=v.device)


register_function(ScalarFunction(
    "data_size_for_stats", lambda a: BIGINT, _data_size_impl))


# ----------------------------------------------------------------- bitwise
# velox/functions/prestosql/Bitwise.h. Shift amounts outside [0, width)
# give 0 (left and logical right) or the sign (arithmetic right), as XLA's
# shifts do.

def _width(x) -> int:
    return 8 * x.element_size()


def _out_of_range(s, width: int):
    return (s < 0) | (s >= width)


def _lsr_const(x, s: int):
    """Logical right shift of int64 lanes by a constant 1 <= s <= 63."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def _lsr(x, s):
    """Logical right shift of int32 or int64 lanes by tensor amounts."""
    w = _width(x)
    bad = _out_of_range(s, w)
    sc = torch.where(bad, torch.zeros_like(s), s).to(torch.int64)
    if w == 32:
        out = ((x.to(torch.int64) & 0xFFFFFFFF) >> sc).to(x.dtype)
    else:
        mask = torch.where(
            sc == 0, torch.full_like(sc, -1),
            (torch.ones_like(sc) << (64 - sc).clamp(max=63)) - 1)
        out = (x >> sc) & mask
    return torch.where(bad, torch.zeros_like(out), out)


def _shl(x, s):
    bad = _out_of_range(s, _width(x))
    out = x << torch.where(bad, torch.zeros_like(s), s).to(x.dtype)
    return torch.where(bad, torch.zeros_like(out), out)


def _asr(x, s):
    w = _width(x)
    sc = torch.where(_out_of_range(s, w), torch.full_like(s, w - 1), s)
    return x >> sc.to(x.dtype)


def _low_bits_mask(bits):
    """``bits``-wide mask as int64 (all ones from 64 bits up)."""
    bits = bits.to(torch.int64)
    return torch.where(bits >= 64, torch.full_like(bits, -1),
                       (torch.ones_like(bits) << bits.clamp(0, 63)) - 1)


def _logical_shr_bits_impl(x, shift, bits):
    """bitwise_logical_shift_right(x, shift, bits): zero-fill within a
    ``bits``-wide window."""
    return _lsr(x.to(torch.int64) & _low_bits_mask(bits),
                shift.to(torch.int64))


def _shl_bits_impl(x, shift, bits):
    """bitwise_shift_left(x, shift, bits): the shift runs in the wider
    of the two lanes, then keeps the low ``bits`` bits."""
    lane = torch.promote_types(x.dtype, shift.dtype)
    return _shl(x.to(lane), shift.to(lane)).to(torch.int64) \
        & _low_bits_mask(bits)


def _popcount64(x):
    """Set bits of int64 lanes (SWAR: pair, nibble and byte sums)."""
    x = x - (_lsr_const(x, 1) & 0x5555555555555555)
    x = (x & 0x3333333333333333) + (_lsr_const(x, 2) & 0x3333333333333333)
    x = (x + _lsr_const(x, 4)) & 0x0F0F0F0F0F0F0F0F
    return _lsr_const(x * 0x0101010101010101, 56)


register_function(ScalarFunction(
    "bitwise_and", _arith_type, torch.bitwise_and))
register_function(ScalarFunction("bitwise_or", _arith_type, torch.bitwise_or))
register_function(ScalarFunction(
    "bitwise_xor", _arith_type, torch.bitwise_xor))
register_function(ScalarFunction(
    "bitwise_not", lambda a: a[0], torch.bitwise_not))
register_function(ScalarFunction("bitwise_left_shift", _arith_type, _shl))
register_function(ScalarFunction("bitwise_right_shift", _arith_type, _lsr))
register_function(ScalarFunction(
    "bitwise_arithmetic_shift_right", _arith_type, _asr))
register_function(ScalarFunction(
    "bitwise_right_shift_arithmetic", lambda a: a[0], _asr))
register_function(ScalarFunction(
    "bitwise_logical_shift_right", lambda a: BIGINT, _logical_shr_bits_impl,
    promote_args=False))
register_function(ScalarFunction(
    "bitwise_shift_left", lambda a: BIGINT, _shl_bits_impl,
    promote_args=False))
# the width argument is accepted and, as in the JAX package, not read: the
# count is over the value's 64-bit two's complement
register_function(ScalarFunction(
    "bit_count", lambda a: BIGINT,
    lambda a, *width: _popcount64(a.to(torch.int64)), promote_args=False))


# ------------------------------------------------------------ device hashes
# velox/functions/prestosql/IntegerFunctions.h xxhash64_internal /
# combine_hash_internal: XXH64 of the value's 8 little-endian bytes, seed
# 0, in int64 lanes.

def _signed(c: int) -> int:
    return c - (1 << 64) if c >= (1 << 63) else c


_XXP1 = _signed(0x9E3779B185EBCA87)
_XXP2 = _signed(0xC2B2AE3D27D4EB4F)
_XXP3 = _signed(0x165667B19E3779F9)
_XXP4 = _signed(0x85EBCA77C2B2AE63)
_XXP5 = _signed(0x27D4EB2F165667C5)


def _rotl64(x, r: int):
    return (x << r) | _lsr_const(x, 64 - r)


def _xxhash64_i64(x):
    k1 = _rotl64(x * _XXP2, 31) * _XXP1
    h = k1 ^ (_XXP5 + 8)           # the 8-byte input's length folds in
    h = _rotl64(h, 27) * _XXP1 + _XXP4
    h = (h ^ _lsr_const(h, 33)) * _XXP2
    h = (h ^ _lsr_const(h, 29)) * _XXP3
    return h ^ _lsr_const(h, 32)


def _xxhash64_internal_impl(x):
    if x.dtype.is_floating_point:
        # -0.0 hashes as 0.0 (velox canonicalizes doubles)
        x = torch.where(x == 0, torch.zeros_like(x), x)
        bits = _f64(x).contiguous().view(torch.int64)
    else:
        bits = x.to(torch.int64)
    return _xxhash64_i64(bits)


register_function(ScalarFunction(
    "xxhash64_internal", lambda a: BIGINT, _xxhash64_internal_impl))
register_function(ScalarFunction(
    "combine_hash_internal", lambda a: BIGINT,
    lambda a, b: a.to(torch.int64) * 31 + b.to(torch.int64)))


# ------------------------------------------------------------------ random
# velox/functions/prestosql/Rand.h: rand()/random() -> DOUBLE in [0, 1),
# rand(n)/random(n) -> an integer in [0, n). The compiler evaluates them
# (they need the batch's row capacity); they are registered for their
# types and marked non-deterministic, so no two calls share a result.

def _special_form(name):
    def impl(*args):
        raise RuntimeError(f"{name} is evaluated by the expression compiler")
    return impl


for _name in ("rand", "random", "secure_rand", "secure_random"):
    register_function(ScalarFunction(
        _name, lambda a: (a[0] if a else DOUBLE), _special_form(_name),
        deterministic=False))


# the date and probability families register on import
import velox_tpu_torch.functions.dates  # noqa: E402,F401
import velox_tpu_torch.functions.probability  # noqa: E402,F401


# ------------------------------------------------------ array functions
# velox/functions/prestosql/ArrayFunctions.h and MapSubscript. The surface
# names only resolve types: the compiler rewrites each call onto the
# collection's derived lanes (start, len, elements:
# ``expr/compiler.py`` ``bind_array_funcs``) as an internal ``__array_*``
# form, a flat segment reduction that holds for any gathered or shared
# offsets. Integer counts and sums are differences of int64 prefixes;
# float sums add disjoint power-of-two blocks (``ops/window.py``
# ``range_sum``), so a NaN or a large value stays in its own row.


def _array_elem_type(args):
    from velox_tpu_torch.types.types import ArrayType, MapType

    if isinstance(args[0], MapType):
        return args[0].value      # element_at(map, key) -> value type
    if not isinstance(args[0], ArrayType):
        raise TypeError(f"expected ARRAY argument, got {args[0]}")
    return args[0].element


def _array_sum_type(args):
    return DOUBLE if _array_elem_type(args).is_floating else BIGINT


def _unbound_array(*a):  # pragma: no cover
    raise RuntimeError("array function must be bound by the compiler")


for _n, _rt in [
    ("cardinality", lambda a: BIGINT),
    ("array_sum", _array_sum_type),
    ("array_average", lambda a: DOUBLE),
    ("contains", lambda a: BOOLEAN),
    ("element_at", _array_elem_type),
    ("array_position", lambda a: BIGINT),
    ("array_min", _array_elem_type),
    ("array_max", _array_elem_type),
    ("array_sort", lambda a: a[0]),
    ("array_distinct", lambda a: a[0]),
]:
    register_function(ScalarFunction(_n, _rt, _unbound_array))


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return x.index_select(0, idx.to(torch.int64).clamp(0, x.shape[0] - 1))


def _prefix(vals: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.zeros(1, dtype=vals.dtype, device=vals.device),
                      torch.cumsum(vals, 0)])


def _seg_range(ps, st, ln):
    """Per row, the prefix difference over [start, start + len)."""
    return _take(ps, st + ln) - _take(ps, st)


def _and(a, b):
    if a is None:
        return b
    return a if b is None else a & b


def _max_len(ln) -> int:
    from velox_tpu_torch.utils import syncs

    return max(syncs.to_int(ln.max()), 1) if ln.numel() else 1


def _seg_count(st, ln, flag):
    return _seg_range(_prefix(flag.to(torch.int64)), st, ln)


def _seg_sum(st, ln, v):
    """Per-row sum of ``v`` (zeroed where NULL) over its range."""
    if v.dtype.is_floating_point:
        from velox_tpu_torch.ops.window import range_sum

        return range_sum(v.to(torch.float64), st.to(torch.int64),
                         (st + ln).to(torch.int64), _max_len(ln))
    return _seg_range(_prefix(v.to(torch.int64)), st, ln)


def _array_sum_impl(stp, lnp, evp):
    (st, _), (ln, lv), (ev, evalid) = stp, lnp, evp
    if evalid is not None:
        ev = torch.where(evalid, ev, torch.zeros_like(ev))
    return _seg_sum(st, ln, ev), lv


def _array_avg_impl(stp, lnp, evp):
    (st, _), (ln, lv), (ev, evalid) = stp, lnp, evp
    ev = ev.to(torch.float64)
    ones = torch.ones(ev.shape, dtype=torch.bool, device=ev.device)
    if evalid is not None:
        ev = torch.where(evalid, ev, torch.zeros_like(ev))
        ones = evalid
    s = _seg_sum(st, ln, ev)
    c = _seg_count(st, ln, ones)
    return s / c.clamp(min=1).to(torch.float64), _and(c > 0, lv)


def _array_contains_impl(stp, lnp, evp, litp):
    (st, _), (ln, lv), (ev, evalid), (v, _) = stp, lnp, evp, litp
    hits = ev == v.to(ev.dtype)
    if evalid is not None:
        hits = hits & evalid
    found = _seg_count(st, ln, hits) > 0
    valid = lv
    if evalid is not None:
        # Presto: not found in an array holding a NULL is NULL
        sure = found | (_seg_count(st, ln, ~evalid) == 0)
        valid = _and(valid, sure)
    return found, valid


def _array_element_at_impl(stp, lnp, evp, idxp):
    (st, _), (ln, lv), (ev, evalid), (idx, iv) = stp, lnp, evp, idxp
    idx = idx.to(torch.int64)
    ln64 = ln.to(torch.int64)
    # 1-based; a negative index counts from the end
    i0 = torch.where(idx < 0, ln64 + idx, idx - 1)
    inb = (i0 >= 0) & (i0 < ln64)
    pos = st.to(torch.int64) + i0.clamp(min=0)
    pos = pos.expand(inb.shape) if pos.dim() == 0 else pos
    valid = _and(_and(inb, lv), iv)
    if evalid is not None:
        valid = valid & _take(evalid, pos)
    return _take(ev, pos), valid


def _first_hit(st, ln, hit):
    """Per row, the position of the first true ``hit`` in its range (the
    element capacity where none): the k-th hit of the lane, k being the
    hits before the row's start."""
    ecap = hit.shape[0]
    before = _take(_prefix(hit.to(torch.int64)), st)
    from velox_tpu_torch.ops.sort import pack_indices

    first = _take(pack_indices(hit), before)
    return torch.where(first < (st + ln).to(torch.int64), first,
                       torch.full_like(first, ecap))


def _array_position_impl(stp, lnp, evp, litp):
    """First 1-based index of the value, 0 when absent."""
    (st, _), (ln, lv), (ev, evalid), (v, _) = stp, lnp, evp, litp
    hit = ev == v.to(ev.dtype)
    if evalid is not None:
        hit = hit & evalid
    first = _first_hit(st, ln, hit)
    return torch.where(first < hit.shape[0], first - st + 1,
                       torch.zeros_like(first)), lv


def _extremes(dtype):
    if dtype.is_floating_point:
        big = torch.finfo(dtype).max
        return big, -big
    info = torch.iinfo(dtype)
    return info.max, info.min


def _make_array_minmax(is_min):
    def impl(stp, lnp, evp):
        from velox_tpu_torch.ops.window import range_minmax

        (st, _), (ln, lv), (ev, evalid) = stp, lnp, evp
        big, small = _extremes(ev.dtype)
        ident = big if is_min else small
        v = ev if evalid is None else torch.where(
            evalid, ev, torch.full_like(ev, ident))
        ones = (torch.ones(ev.shape, dtype=torch.bool, device=ev.device)
                if evalid is None else evalid)
        out = range_minmax(v, st.to(torch.int64), (st + ln).to(torch.int64),
                           "min" if is_min else "max", ident, _max_len(ln))
        return out, _and(_seg_count(st, ln, ones) > 0, lv)

    return impl


def _match_counts(stp, lnp, predp):
    (st, _), (ln, lv), (pv, pvalid) = stp, lnp, predp
    valid = (torch.ones(pv.shape, dtype=torch.bool, device=pv.device)
             if pvalid is None else pvalid)
    return (_seg_count(st, ln, pv & valid), _seg_count(st, ln, ~pv & valid),
            _seg_count(st, ln, ~valid), lv)


def _any_match_impl(stp, lnp, predp):
    nt, _nf, nn, lv = _match_counts(stp, lnp, predp)
    return nt > 0, _and(lv, (nt > 0) | (nn == 0))


def _all_match_impl(stp, lnp, predp):
    _nt, nf, nn, lv = _match_counts(stp, lnp, predp)
    return nf == 0, _and(lv, (nf > 0) | (nn == 0))


def _none_match_impl(stp, lnp, predp):
    nt, _nf, nn, lv = _match_counts(stp, lnp, predp)
    return nt == 0, _and(lv, (nt > 0) | (nn == 0))


def _capture_impl(stp, lnp, evp, colp):
    """A lambda's capture: an outer-row column gathered to the element
    capacity by owning row (velox/expression/LambdaExpr.cpp); the
    offsets are canonical (``exec/collect_agg.py`` ``element_owners``)."""
    from velox_tpu_torch.exec.collect_agg import element_owners

    (st, _), (ln, _), (ev, _), (cv, cvalid) = stp, lnp, evp, colp
    owner, within = element_owners(st, ln, ev.shape[0])
    if cv.dim() == 0:
        return cv.expand(ev.shape[0]), _and(within, cvalid)
    return _take(cv, owner), _and(within, _take_opt(cvalid, owner))


def _take_opt(valid, idx):
    return None if valid is None else _take(valid, idx)


def _map_element_at_impl(stp, lnp, kvp, vvp, litp):
    """MAP subscript (velox/functions/prestosql/MapSubscript.h): keys are
    unique in a map, so the one hit's position is an int64 prefix
    difference of (position + 1) over the hits."""
    (st, _), (ln, lv), (kv, kvalid), (vv, vvalid), (lit, _) = (
        stp, lnp, kvp, vvp, litp)
    hit = kv == lit.to(kv.dtype)
    if kvalid is not None:
        hit = hit & kvalid
    pos1 = torch.where(hit, torch.arange(1, hit.shape[0] + 1,
                                         device=hit.device),
                       torch.zeros((), dtype=torch.int64, device=hit.device))
    pos = _seg_range(_prefix(pos1), st, ln) - 1
    found = pos >= 0
    valid = _and(found, lv)
    if vvalid is not None:
        valid = valid & _take(vvalid, pos)
    return _take(vv, pos), valid


def _find_first_impl(stp, lnp, predp, evp):
    (st, _), (ln, lv), (pv, pvalid), (ev, evalid) = stp, lnp, predp, evp
    fpos = _first_hit(st, ln, _and(pv, pvalid))
    valid = _and(fpos < pv.shape[0], lv)
    if evalid is not None:
        valid = valid & _take(evalid, fpos)
    return _take(ev, fpos), valid


def _find_first_index_impl(stp, lnp, predp):
    (st, _), (ln, lv), (pv, pvalid) = stp, lnp, predp
    fpos = _first_hit(st, ln, _and(pv, pvalid))
    return fpos - st + 1, _and(fpos < pv.shape[0], lv)


def _make_extremal_by(is_min):
    def impl(stp, lnp, keyp, evp):
        from velox_tpu_torch.exec.collect_agg import element_owners
        from velox_tpu_torch.ops.window import range_minmax

        (st, _), (ln, lv), (kv, kvalid), (ev, evalid) = stp, lnp, keyp, evp
        ident = float("inf") if is_min else float("-inf")
        k = kv.to(torch.float64)
        if kvalid is not None:
            k = torch.where(kvalid, k, torch.full_like(k, ident))
        rowext = range_minmax(k, st.to(torch.int64),
                              (st + ln).to(torch.int64),
                              "min" if is_min else "max", ident,
                              _max_len(ln))
        owner, within = element_owners(st, ln, k.shape[0])
        eq_ext = _and(within & (k == _take(rowext, owner)), kvalid)
        fpos = _first_hit(st, ln, eq_ext)
        valid = _and(fpos < k.shape[0], lv)
        if evalid is not None:
            valid = valid & _take(evalid, fpos)
        return _take(ev, fpos), valid

    return impl


for _n, _rt, _impl in [
    ("__array_sum", lambda a: BIGINT, _array_sum_impl),
    ("__array_avg", lambda a: DOUBLE, _array_avg_impl),
    ("__array_contains", lambda a: BOOLEAN, _array_contains_impl),
    ("__array_element_at", lambda a: a[2], _array_element_at_impl),
    ("__array_position", lambda a: BIGINT, _array_position_impl),
    ("__array_min", lambda a: a[2], _make_array_minmax(True)),
    ("__array_max", lambda a: a[2], _make_array_minmax(False)),
    ("__array_any_match", lambda a: BOOLEAN, _any_match_impl),
    ("__array_all_match", lambda a: BOOLEAN, _all_match_impl),
    ("__array_none_match", lambda a: BOOLEAN, _none_match_impl),
    ("__capture", lambda a: a[3], _capture_impl),
    ("__map_element_at", lambda a: a[3], _map_element_at_impl),
    ("__array_find_first", lambda a: a[3], _find_first_impl),
    ("__array_find_first_index", lambda a: BIGINT, _find_first_index_impl),
    ("__array_min_by", lambda a: a[3], _make_extremal_by(True)),
    ("__array_max_by", lambda a: a[3], _make_extremal_by(False)),
]:
    register_function(ScalarFunction(_n, _rt, _impl, default_nulls=False))
