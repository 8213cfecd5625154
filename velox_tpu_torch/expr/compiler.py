"""Expression compilation: typed IR -> eager torch evaluation.

The JAX package's ``expr/compiler.py`` for flat types, with the same
three phases:

1. ``resolve_types``: bind FieldRefs against an input schema, resolve call
   result types, insert implicit numeric-widening casts and decimal
   rescales (SignatureBinder analog, velox/expression/SignatureBinder.h);
   specialize ``date_trunc``/``date_add``/``date_diff`` on their unit,
   route TIMESTAMP arguments of day parts through ``__ts_days``, and
   type interval arithmetic.
2. ``bind_strings``: string compares and ``in`` lists against literals
   become integer compares on the dictionary codes (the catalog's
   dictionaries are sorted, so codes are ranks); ``like`` becomes a
   lookup of a per-value match table, ``substr`` and a string-valued
   ``if`` a ``DictTransform`` (a gather into the codes of a new sorted
   dictionary), each computed on the host once per distinct value;
   string columns otherwise pass through.
3. ``widen_decimal_arith`` then evaluation over ``(values, valid)`` pairs
   with common-subexpression memoization (``rand`` is drawn anew for
   every call). There is no tracing: every node runs as torch ops on the
   device of the input tensors.

Integer promotion follows the reference, not torch: a 0-d int64 literal
against an int32 column yields int64 (torch alone would keep int32), so
every default-null call promotes its operands to one dtype first.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from velox_tpu_torch import torch_dtype, true_divide
from velox_tpu_torch.types import (
    BIGINT, BOOLEAN, DATE, DOUBLE, DataType, INTEGER, TIMESTAMP, VARCHAR,
)
from velox_tpu_torch.types.types import (
    DecimalType, RowType, TypeKind, common_numeric_type,
)
from velox_tpu_torch.expr.ir import Call, Cast, Expr, FieldRef, Literal, TryExpr
from velox_tpu_torch.functions.registry import lookup_function
from velox_tpu_torch.functions.scalar import DeviceTable



@dataclass(frozen=True, eq=False)
class DictTransform(Expr):
    """A string function applied to a dictionary column at bind time: run
    once per distinct dictionary value on the host, then on the device a
    single int32 gather ``table[code + 1]`` into the codes of the new
    sorted dictionary (velox/expression/Expr.cpp:1280 evalWithMemo
    memoizes per base value; here the memo is precomputed)."""

    codes: Expr = None          # type: ignore[assignment]
    table: object = None        # np.ndarray: old code + 1 -> new code
    dictionary: object = None   # vector.column.Dictionary of the results

    @property
    def children(self):
        return (self.codes,)

    # identity semantics: two same-typed transforms must not collide in
    # the evaluation memo
    def __eq__(self, other):
        return self is other

    def __hash__(self):
        return id(self)


_ARITH = {"plus", "minus", "multiply", "divide", "mod"}
_COMPARE = {"eq", "neq", "lt", "lte", "gt", "gte"}
_RANGE_COMPARE = {"lt", "lte", "gt", "gte"}


# ------------------------------------------------------------------ phase 1

def resolve_types(expr: Expr, schema: RowType) -> Expr:
    """Bind field types, resolve result types, insert implicit casts."""
    if isinstance(expr, FieldRef):
        return FieldRef(schema.find_child(expr.name), expr.name)

    if isinstance(expr, Literal):
        if expr.dtype is not None:
            return expr
        return Literal(_literal_type(expr.value), expr.value)

    if isinstance(expr, Cast):
        child = resolve_types(expr.expr, schema)
        return Cast(expr.dtype, child, expr.null_on_failure)

    if isinstance(expr, TryExpr):
        child = resolve_types(expr.expr, schema)
        return TryExpr(child.dtype, child)

    if isinstance(expr, Call):
        args = tuple(resolve_types(a, schema) for a in expr.args)
        name = expr.name
        if name in ("substr", "substring"):
            # bound to a dictionary transform in phase 2
            return Call(VARCHAR, "substr", args)
        if (name == "data_size_for_stats" and args[0].dtype is not None
                and args[0].dtype.is_string):
            raise NotImplementedError(
                "data_size_for_stats over strings needs octet_length, "
                "which waits for the string functions")
        if name in _DAY_PART_FNS or name in _TIME_PART_FNS:
            a0 = args[0]
            if a0.dtype is not None and a0.dtype.kind == TypeKind.TIMESTAMP:
                if name in _DAY_PART_FNS:
                    # day-granularity parts read DATE lanes: TIMESTAMP
                    # microseconds floor-divide to days first
                    a0 = Call(DATE, "__ts_days", (a0,))
                rt = DATE if name == "last_day_of_month" else BIGINT
                return Call(rt, name, (a0,) + args[1:])
        if name in ("date_trunc", "date_add", "date_diff"):
            return _resolve_unit_call(name, args)

        if name in _ARITH or name in _COMPARE or name == "between":
            args = _unify_numeric(name, args)

        if name in ("if", "switch", "coalesce"):
            dtype = _branch_type(name, args)
            return Call(dtype, name, _cast_branches(name, args, dtype))

        if name in ("plus", "minus", "multiply"):
            iv = _resolve_interval_arith(name, args)
            if iv is not None:
                return iv

        fn = lookup_function(name)
        if name in _ARITH and isinstance(args[0].dtype, DecimalType):
            dtype = _decimal_result(name, args[0].dtype, args[1].dtype)
        elif name in ("plus", "minus") and any(
                a.dtype is not None and a.dtype.kind == TypeKind.DATE
                for a in args):
            # DATE +/- integer days stays DATE (int32 lane)
            dtype = next(a.dtype for a in args
                         if a.dtype.kind == TypeKind.DATE)
            args = tuple(
                a if a.dtype.kind == TypeKind.DATE
                else Cast(INTEGER, a, False) for a in args)
        else:
            dtype = fn.resolve_type([a.dtype for a in args])
        return Call(dtype, name, args)

    raise TypeError(f"cannot resolve {expr!r}")


#: date parts that read DATE (day) lanes
_DAY_PART_FNS = {
    "year", "month", "day", "day_of_month", "day_of_week", "dow",
    "day_of_year", "doy", "quarter", "week", "week_of_year",
    "last_day_of_month",
}
#: parts of the time of day, which read TIMESTAMP lanes
_TIME_PART_FNS = {"hour", "minute", "second", "millisecond"}


def _resolve_unit_call(name: str, args) -> Expr:
    """``date_trunc(unit, x)``, ``date_add(unit, n, x)`` and
    ``date_diff(unit, a, b)`` specialize on their unit string
    (velox/functions/prestosql/DateTimeFunctions.h)."""
    if not (isinstance(args[0], Literal) and isinstance(args[0].value, str)):
        raise TypeError(f"{name} unit must be a string literal")
    impl = f"__{name}_{args[0].value.lower()}"
    lookup_function(impl)      # an unknown unit fails here
    rest = args[1:]
    if name == "date_trunc":
        return Call(rest[0].dtype, impl, rest)
    if name == "date_add":
        return Call(rest[1].dtype, impl, rest)
    return Call(BIGINT, impl, rest)


_IDT = TypeKind.INTERVAL_DAY_TIME
_IYM = TypeKind.INTERVAL_YEAR_MONTH


def _resolve_interval_arith(name: str, args) -> Optional[Expr]:
    """Typed interval arithmetic (velox/functions/prestosql/
    DateTimeFunctions.h DatePlusInterval, TimestampPlusInterval; interval
    +/- interval; interval * n), or None when no operand is an interval.
    A day-time interval is int64 milliseconds, a year-month one int32
    months; the parser has already folded whole-day literals added to a
    value into integer day counts."""
    kinds = [a.dtype.kind if a.dtype is not None else None for a in args]
    if _IDT not in kinds and _IYM not in kinds:
        return None
    if len(args) != 2:
        raise TypeError(f"{name} takes two arguments")
    a, b = args
    ka, kb = kinds

    def neg(e):
        return Call(e.dtype, "negate", (e,))

    if name == "multiply":
        it, other = (a, b) if ka in (_IDT, _IYM) else (b, a)
        if not other.dtype.is_integer:
            raise TypeError("interval * n expects an integer n")
        return Call(it.dtype, "multiply", (it, other))
    # normalize to: temporal-or-interval op interval
    if kb in (TypeKind.DATE, TypeKind.TIMESTAMP):
        if name == "minus":
            raise TypeError("cannot subtract a date from an interval")
        a, b, ka, kb = b, a, kb, ka
    if ka == kb:                                  # interval +/- interval
        return Call(a.dtype, name, (a, b))
    if ka == TypeKind.DATE:
        if kb == _IDT:
            # whole days only (DatePlusInterval's user check), which a
            # literal shows at bind time
            if isinstance(b, Literal) and b.value is not None \
                    and b.value % 86_400_000 != 0:
                raise TypeError("Cannot add hours/minutes/seconds to a date")
            days = (Literal(INTEGER, b.value // 86_400_000)
                    if isinstance(b, Literal) and b.value is not None
                    else Call(b.dtype, "divide",
                              (b, Literal(BIGINT, 86_400_000))))
            return Call(DATE, name, (a, Cast(INTEGER, days, False)))
        months = b if name == "plus" else neg(b)
        return Call(DATE, "__date_add_month",
                    (Cast(INTEGER, months, False), a))
    if ka == TypeKind.TIMESTAMP:
        amount = b if name == "plus" else neg(b)
        if kb == _IDT:
            return Call(TIMESTAMP, "__date_add_millisecond",
                        (Cast(BIGINT, amount, False), a))
        return Call(TIMESTAMP, "__date_add_month",
                    (Cast(INTEGER, amount, False), a))
    if ka in (_IDT, _IYM) and kb in (TypeKind.BIGINT, TypeKind.INTEGER):
        return Call(a.dtype, name, (a, b))
    raise TypeError(f"no interval overload for {name}({ka}, {kb})")


def _literal_type(value) -> DataType:
    if value is None:
        return DataType(TypeKind.UNKNOWN)
    if isinstance(value, bool):
        return BOOLEAN
    if isinstance(value, int):
        return BIGINT
    if isinstance(value, float):
        return DOUBLE
    if isinstance(value, str):
        return VARCHAR
    raise TypeError(f"no literal type for {value!r}")


def _unify_numeric(name: str, args: Tuple[Expr, ...]) -> Tuple[Expr, ...]:
    """Insert widening casts so both sides share a lane dtype."""
    types = [a.dtype for a in args]
    if any(t is None for t in types):
        return args
    if any(t.is_string for t in types):
        return args  # handled at bind time (dictionary codes)
    if any(t.kind in (TypeKind.DATE, TypeKind.TIMESTAMP, TypeKind.BOOLEAN,
                      TypeKind.UNKNOWN) for t in types):
        return args  # same-lane compares; no widening
    decs = [isinstance(t, DecimalType) for t in types]
    if any(decs):
        if any(t.is_floating for t in types):
            # a float LITERAL against a decimal column becomes a decimal
            # literal, keeping the expression on exact integer lanes
            converted = _floats_to_decimal_literals(args)
            if converted is None:
                # decimal op double -> double
                return tuple(
                    Cast(DOUBLE, a, False)
                    if isinstance(a.dtype, DecimalType) else a
                    for a in args)
            args = converted
        # integer operands become scale-0 decimals
        out = []
        for a in args:
            if isinstance(a.dtype, DecimalType):
                out.append(a)
            else:
                out.append(Cast(DecimalType(TypeKind.DECIMAL, 18, 0), a,
                                False))
        args = tuple(out)
        if name in _COMPARE or name in ("plus", "minus") or name == "between":
            # rescale to common scale, widening precision by the shift
            target = max(a.dtype.scale for a in args)
            args = tuple(
                a if a.dtype.scale == target
                else Cast(
                    DecimalType(
                        TypeKind.DECIMAL,
                        min(a.dtype.precision + target - a.dtype.scale,
                            18),
                        target),
                    a, False)
                for a in args)
        return args
    if not all(t.is_numeric for t in types):
        return args
    target = types[0]
    for t in types[1:]:
        target = common_numeric_type(target, t)
    return tuple(
        a if a.dtype == target else Cast(target, a, False) for a in args)


def _floats_to_decimal_literals(args):
    """Convert float literals to exact decimal literals, or None if any
    float operand is not an exactly-representable literal (scale <= 6)."""
    out = []
    for a in args:
        if isinstance(a.dtype, DecimalType) or not a.dtype.is_floating:
            out.append(a)
            continue
        if not isinstance(a, Literal):
            return None
        v = float(a.value)
        scale = None
        for s in range(7):
            scaled = v * (10 ** s)
            if abs(scaled - round(scaled)) < 1e-9:
                scale = s
                break
        if scale is None:
            return None
        digits = len(str(abs(int(round(v * 10 ** scale))))) or 1
        out.append(Literal(
            DecimalType(TypeKind.DECIMAL, max(digits, 1), scale), v))
    return tuple(out)


def _decimal_result(name: str, a: DataType, b: DataType) -> DataType:
    sa = a.scale if isinstance(a, DecimalType) else 0
    sb = b.scale if isinstance(b, DecimalType) else 0
    pa_ = a.precision if isinstance(a, DecimalType) else 18
    pb = b.precision if isinstance(b, DecimalType) else 18
    if name in ("plus", "minus"):
        return DecimalType(
            TypeKind.DECIMAL, min(max(pa_, pb) + 1, 18), max(sa, sb))
    if name == "multiply":
        return DecimalType(TypeKind.DECIMAL, min(pa_ + pb, 18), sa + sb)
    if name in ("divide", "mod"):
        return DecimalType(TypeKind.DECIMAL, 18, max(sa, sb))
    raise TypeError(name)


def _branch_type(name: str, args) -> DataType:
    """Common result type across value branches (Presto coerces all
    branches of IF/CASE/COALESCE to a least common type)."""
    if name == "if":
        branches = list(args[1:])
    elif name == "coalesce":
        branches = list(args)
    else:  # switch: (c1, v1, c2, v2, ..., [else])
        branches = list(args[1::2])
        if len(args) % 2 == 1:
            branches.append(args[-1])
    types = [a.dtype for a in branches
             if a.dtype is not None and a.dtype.kind != TypeKind.UNKNOWN]
    t = types[0]
    for u in types[1:]:
        if u == t or not (t.is_numeric and u.is_numeric):
            continue
        if isinstance(t, DecimalType) or isinstance(u, DecimalType):
            if t.is_floating or u.is_floating:
                t = DOUBLE
            elif isinstance(t, DecimalType) and isinstance(u, DecimalType):
                t = DecimalType(TypeKind.DECIMAL,
                                min(max(t.precision, u.precision) + 1, 18),
                                max(t.scale, u.scale))
            else:
                t = t if isinstance(t, DecimalType) else u
        else:
            t = common_numeric_type(t, u)
    return t


def _cast_branches(name: str, args, dtype) -> Tuple[Expr, ...]:
    """Make all value branches of if/switch/coalesce share the result
    type."""
    def c(a: Expr) -> Expr:
        if a.dtype == dtype or a.dtype is None:
            return a
        if a.dtype.kind == TypeKind.UNKNOWN:  # null literal
            return Literal(dtype, None)
        return Cast(dtype, a, False)

    if name == "if":
        return (args[0],) + tuple(c(a) for a in args[1:])
    if name == "coalesce":
        return tuple(c(a) for a in args)
    out = list(args)
    for i in range(1, len(out), 2):
        out[i] = c(out[i])
    if len(out) % 2 == 1:
        out[-1] = c(out[-1])
    return tuple(out)


# ------------------------------------------------------------------ phase 2

def _like_to_regex(pattern: str) -> str:
    out = []
    for ch in pattern:
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
    return "^" + "".join(out) + "$"


def _like_table(d, pattern: str) -> np.ndarray:
    """Match of every dictionary value, behind False for code -1 (the
    lookup gathers ``table[code + 1]``); kept with the dictionary."""
    def make(d):
        rx = re.compile(_like_to_regex(pattern))
        table = np.zeros(len(d) + 1, dtype=np.bool_)
        table[1:] = [rx.match(v) is not None for v in d.values.tolist()]
        return table

    return d.derived(("like", pattern), make)


def _substr_transform(d, start: int, length: Optional[int]):
    """(old code + 1 -> new code table, sorted result dictionary) of
    ``substr(s, start[, length])`` over a dictionary; SQL is 1-based."""
    from velox_tpu_torch.vector.column import Dictionary

    def make(d):
        lo = start - 1 if start >= 1 else start
        out = [s[lo:] if length is None else s[lo:lo + length]
               for s in d.values.tolist()]
        uniq, inv = np.unique(np.asarray(out, dtype=object),
                              return_inverse=True)
        table = np.full(len(d) + 1, -1, dtype=np.int32)
        table[1:] = inv.reshape(-1)
        return table, Dictionary(list(uniq))

    return d.derived(("substr", start, length), make)


def _bind_substr(args, dictionaries) -> Expr:
    src = _dict_source((args[0],), dictionaries)
    if src is None:
        raise TypeError("substr requires a dictionary-encoded input")
    if not all(isinstance(a, Literal) for a in args[1:]):
        raise TypeError("substr start/length must be literals")
    codes_expr, d = src
    length = int(args[2].value) if len(args) > 2 else None
    table, nd = _substr_transform(d, int(args[1].value), length)
    return DictTransform(VARCHAR, codes_expr, table, nd)


def _bind_string_if(args, dictionaries, dtype) -> Optional[Expr]:
    """if(cond, s1, s2) with string-valued branches stays dictionary
    coded: the branch dictionaries (and any string literal) merge into one
    sorted result dictionary, each branch's codes remap through a table,
    and a NULL branch becomes code -1."""
    from velox_tpu_torch.vector.column import Dictionary

    cond, a, b = args

    def info(x):
        if isinstance(x, Literal):
            if x.value is None:
                return ("null", None, None)
            if isinstance(x.value, str):
                return ("lit", x.value, None)
            return None
        s = _dict_source((x,), dictionaries)
        return None if s is None else ("dict", s[0], s[1])

    ia, ib = info(a), info(b)
    if ia is None or ib is None:
        return None
    values: set = set()
    for kind, v, d in (ia, ib):
        if kind == "lit":
            values.add(v)
        elif kind == "dict":
            values.update(str(x) for x in d.values)
    nd = Dictionary(sorted(values))

    def branch(i):
        kind, v, d = i
        if kind == "null":
            return Literal(INTEGER, -1)
        if kind == "lit":
            return Literal(INTEGER, nd.code_of(v))
        remap = np.asarray([-1] + [nd.code_of(str(x)) for x in d.values],
                           dtype=np.int32)
        return DictTransform(INTEGER, v, remap, None)

    codes = Call(INTEGER, "if", (cond, branch(ia), branch(ib)))
    ident = np.concatenate([[-1], np.arange(len(nd))]).astype(np.int32)
    return DictTransform(dtype, codes, ident, nd)


def bind_strings(expr: Expr, dictionaries: Dict[str, "Dictionary"],
                 ranges: Optional[Dict[str, tuple]] = None) -> Expr:
    """Rewrite string compares over dictionary columns into code compares.

    ``eq``/``neq`` against a literal compare codes; range compares become
    rank compares (dictionaries are sorted, so codes are ranks).
    """
    if isinstance(expr, (FieldRef, Literal, DictTransform)):
        return expr
    if isinstance(expr, Cast):
        return Cast(expr.dtype, bind_strings(expr.expr, dictionaries, ranges),
                    expr.null_on_failure)
    if isinstance(expr, TryExpr):
        return TryExpr(expr.dtype,
                       bind_strings(expr.expr, dictionaries, ranges))
    if not isinstance(expr, Call):
        return expr

    args = tuple(bind_strings(a, dictionaries, ranges) for a in expr.args)
    name = expr.name
    if name == "substr":
        return _bind_substr(args, dictionaries)
    if (name == "if" and len(args) == 3 and expr.dtype is not None
            and expr.dtype.is_string):
        bound = _bind_string_if(args, dictionaries, expr.dtype)
        if bound is not None:
            return bound
    src = _dict_source(args, dictionaries)
    if src is not None and name == "like":
        codes_expr, d = src
        return Call(BOOLEAN, "dict_lookup_bool", (
            codes_expr, Literal(BOOLEAN, _like_table(d, args[1].value))))
    if src is not None and name == "in":
        codes_expr, d = src
        return Call(BOOLEAN, "in", (codes_expr, *[
            Literal(INTEGER, d.code_of(a.value)) for a in args[1:]
            if isinstance(a, Literal)]))
    litv = _other_literal(args)
    if src is not None and litv is not None:
        codes_expr, d = src
        if name in ("eq", "neq"):
            return Call(BOOLEAN, name, (
                codes_expr, Literal(INTEGER, d.code_of(litv))))
        if name in _RANGE_COMPARE:
            field_first = not isinstance(args[0], Literal)
            rank_l = int(np.searchsorted(
                d.values.astype(str), litv, side="left"))
            rank_r = int(np.searchsorted(
                d.values.astype(str), litv, side="right"))
            op, rank = _rank_compare(name, field_first, rank_l, rank_r)
            return Call(BOOLEAN, op, (codes_expr, Literal(INTEGER, rank)))
    return Call(expr.dtype, name, args)


def _rank_compare(name: str, field_first: bool, rank_l: int, rank_r: int):
    """Map a string range compare to a code-rank compare (the literal on
    the left flips the comparison)."""
    if not field_first:
        flip = {"lt": "gt", "lte": "gte", "gt": "lt", "gte": "lte"}
        name = flip[name]
    if name == "lt":
        return "lt", rank_l
    if name == "lte":
        return "lt", rank_r       # code < rank_right
    if name == "gt":
        return "gte", rank_r      # code >= rank_right
    return "gte", rank_l          # gte: code >= rank_left


def _dict_source(args, dictionaries):
    """Find the dictionary-backed string operand: (codes expr, Dictionary)."""
    for a in args:
        if isinstance(a, FieldRef) and a.dtype is not None \
                and a.dtype.is_string:
            d = dictionaries.get(a.name)
            if d is not None:
                return FieldRef(INTEGER, a.name), d
        if isinstance(a, DictTransform):
            return a, a.dictionary
    return None


def _other_literal(args):
    for a in args:
        if isinstance(a, Literal) and isinstance(a.value, str):
            return a.value
    return None


# ----------------------------------------------------------------- phase 2b

_I32_MIN, _I32_MAX = -(2 ** 31), 2 ** 31 - 1


def _interval(e: Expr, ranges: Dict[str, Tuple[int, int]]):
    """Conservative value interval of an integer/decimal expression, from
    table stats (velox VectorHasher range analysis analog). None=unknown."""
    if isinstance(e, Literal):
        if e.value is None or isinstance(e.value, (bool, str, np.ndarray)):
            return None
        if isinstance(e.dtype, DecimalType):
            v = int(round(e.value * 10 ** e.dtype.scale))
            return (v, v)
        if isinstance(e.value, int):
            return (e.value, e.value)
        return None
    if isinstance(e, FieldRef):
        return ranges.get(e.name)
    if isinstance(e, Cast):
        child = _interval(e.expr, ranges)
        if child is None:
            return None
        sdt, ddt = e.expr.dtype, e.dtype
        if isinstance(sdt, DecimalType) and isinstance(ddt, DecimalType):
            ds = ddt.scale - sdt.scale
            if ds >= 0:
                return (child[0] * 10 ** ds, child[1] * 10 ** ds)
            p = 10 ** (-ds)
            return (child[0] // p - 1, child[1] // p + 1)
        if sdt.is_integer and isinstance(ddt, DecimalType):
            return (child[0] * 10 ** ddt.scale, child[1] * 10 ** ddt.scale)
        if sdt.is_integer and ddt.is_integer:
            return child
        return None
    if isinstance(e, Call) and e.name in (
            "plus", "minus", "multiply", "negate"):
        ivs = [_interval(a, ranges) for a in e.args]
        if any(v is None for v in ivs):
            return None
        if e.name == "negate":
            return (-ivs[0][1], -ivs[0][0])
        (a1, b1), (a2, b2) = ivs
        if e.name == "plus":
            return (a1 + a2, b1 + b2)
        if e.name == "minus":
            return (a1 - b2, b1 - a2)
        prods = [a1 * a2, a1 * b2, b1 * a2, b1 * b2]
        return (min(prods), max(prods))
    return None


def widen_decimal_arith(expr: Expr,
                        ranges: Dict[str, Tuple[int, int]]) -> Expr:
    """Insert lane-widening casts on decimal arithmetic whose result may
    exceed the operand lanes. In narrow mode, results PROVEN (by table
    stats interval arithmetic) to fit int32 skip the widening and the
    whole expression stays 32-bit."""
    from velox_tpu_torch.utils.config import config

    if isinstance(expr, Cast):
        return Cast(expr.dtype, widen_decimal_arith(expr.expr, ranges),
                    expr.null_on_failure)
    if isinstance(expr, TryExpr):
        return TryExpr(expr.dtype, widen_decimal_arith(expr.expr, ranges))
    if not isinstance(expr, Call):
        return expr
    args = tuple(widen_decimal_arith(a, ranges) for a in expr.args)
    expr = Call(expr.dtype, expr.name, args)
    if expr.name not in _ARITH or not isinstance(expr.dtype, DecimalType):
        return expr
    if expr.dtype.dtype != np.dtype(np.int64):
        return expr  # result lane already narrow
    if config.narrow_lanes:
        iv = _interval(expr, ranges)
        if iv is not None and iv[0] >= _I32_MIN and iv[1] <= _I32_MAX:
            return expr  # proven to fit the operands' 32-bit lanes
    # widen decimal operands to the wide lane before computing
    wide_args = tuple(
        Cast(DecimalType(TypeKind.DECIMAL, 18, a.dtype.scale), a, False)
        if isinstance(a.dtype, DecimalType)
        and a.dtype.dtype != np.dtype(np.int64) else a
        for a in expr.args)
    return Call(expr.dtype, expr.name, wide_args)


# ------------------------------------------------------------------ phase 3

ValuePair = Tuple[torch.Tensor, Optional[torch.Tensor]]

_DECIMAL_POW = [10 ** i for i in range(19)]
_US_DAY = 86_400_000_000
#: per-row random draws, evaluated here (they need the row capacity)
_RANDOM = {"rand", "random", "secure_rand", "secure_random"}


def _round_div(v: torch.Tensor, p: int) -> torch.Tensor:
    """Integer ``v / p`` rounded half away from zero (DecimalUtil rescale)."""
    q = torch.div(torch.abs(v) + p // 2, p, rounding_mode="floor")
    return torch.sign(v) * q


def _eval_cast(v, valid, src: DataType, dst: DataType) -> ValuePair:
    if src == dst:
        return v, valid
    src_dec = isinstance(src, DecimalType)
    dst_dec = isinstance(dst, DecimalType)
    if src_dec and dst_dec:
        ds = dst.scale - src.scale
        lane = torch_dtype(dst.dtype)
        if ds == 0:
            return v.to(lane), valid
        if ds > 0:
            return v.to(lane) * _DECIMAL_POW[ds], valid
        return _round_div(v, _DECIMAL_POW[-ds]).to(lane), valid
    if src_dec:
        if dst.is_floating:
            return true_divide(v.to(torch_dtype(dst.dtype)),
                               _DECIMAL_POW[src.scale]), valid
        if dst.is_integer:
            q = _round_div(v, _DECIMAL_POW[src.scale])
            return q.to(torch_dtype(dst.dtype)), valid
        raise TypeError(f"cast {src} -> {dst}")
    if dst_dec:
        if src.is_floating:
            scaled = v * _DECIMAL_POW[dst.scale]
            # half away from zero (velox/type/DecimalUtil.h rescale)
            r = torch.sign(scaled) * torch.floor(torch.abs(scaled) + 0.5)
            ok = torch.isfinite(v)
            valid = ok if valid is None else torch.logical_and(valid, ok)
            return r.to(torch_dtype(dst.dtype)), valid
        if src.is_integer:
            return (v.to(torch_dtype(dst.dtype))
                    * _DECIMAL_POW[dst.scale]), valid
        raise TypeError(f"cast {src} -> {dst}")
    if dst.kind == TypeKind.BOOLEAN:
        return v != 0, valid
    if src.kind == TypeKind.BOOLEAN:
        return v.to(torch_dtype(dst.dtype)), valid
    # date <-> timestamp (velox/type/TimestampConversion.h)
    if src.kind == TypeKind.DATE and dst.kind == TypeKind.TIMESTAMP:
        return v.to(torch.int64) * _US_DAY, valid
    if src.kind == TypeKind.TIMESTAMP and dst.kind == TypeKind.DATE:
        return torch.div(v, _US_DAY, rounding_mode="floor").to(
            torch.int32), valid
    if dst.is_floating or dst.is_integer:
        # Presto cast matrix (velox/type/Conversions.h): float->int rounds
        # HALF AWAY FROM ZERO; overflow / NaN / inf become nulls
        out_t = torch_dtype(dst.dtype)
        if src.is_floating and dst.is_integer:
            info = np.iinfo(dst.dtype)
            r = torch.sign(v) * torch.floor(torch.abs(v) + 0.5)
            ok = torch.logical_and(
                torch.isfinite(v),
                torch.logical_and(r >= float(info.min),
                                  r <= float(info.max)))
            valid = ok if valid is None else torch.logical_and(valid, ok)
            return r.to(out_t), valid
        if (src.is_integer and dst.is_integer
                and np.dtype(dst.dtype).itemsize
                < np.dtype(src.dtype).itemsize):
            info = np.iinfo(dst.dtype)
            ok = torch.logical_and(v >= info.min, v <= info.max)
            valid = ok if valid is None else torch.logical_and(valid, ok)
            return v.to(out_t), valid
        return v.to(out_t), valid
    raise TypeError(f"unsupported cast {src} -> {dst}")


class ExprSet:
    """Compiled expression set over a fixed schema + dictionaries.

    Analog of velox::exec::ExprSet (velox/expression/Expr.h:133): shares
    subexpression results across the set via the eval memo. Literal
    tensors are made once per device and kept, so evaluating a split
    copies nothing from the host.
    """

    def __init__(self, exprs: Sequence[Expr], schema: RowType,
                 dictionaries: Optional[Dict[str, "Dictionary"]] = None,
                 ranges: Optional[Dict[str, Tuple[int, int]]] = None):
        self.schema = schema
        self.dictionaries = dictionaries or {}
        self.ranges = ranges or {}
        resolved = [resolve_types(e, schema) for e in exprs]
        bound = [bind_strings(e, self.dictionaries, self.ranges)
                 for e in resolved]
        self.exprs = [widen_decimal_arith(e, self.ranges) for e in bound]
        #: dictionary of each result column (string passthroughs and
        #: transforms)
        self.result_dictionaries = [
            e.dictionary if isinstance(e, DictTransform)
            else (self.dictionaries.get(e.name)
                  if isinstance(e, FieldRef) and e.dtype is not None
                  and e.dtype.is_string else None)
            for e in self.exprs]
        self._consts: Dict[tuple, ValuePair] = {}

    def evaluate(self, arrays: Dict[str, ValuePair]) -> List[ValuePair]:
        """arrays maps field name -> (values, valid) on one device."""
        device = next(iter(arrays.values()))[0].device if arrays \
            else torch.device("cpu")
        memo: Dict[Expr, ValuePair] = {}
        return [self._eval(e, arrays, memo, device) for e in self.exprs]

    def _eval(self, expr, arrays, memo, device) -> ValuePair:
        hit = memo.get(expr)
        if hit is None:
            hit = self._eval_inner(expr, arrays, memo, device)
            if not (isinstance(expr, Call) and expr.name in _RANDOM):
                memo[expr] = hit      # no two rand() calls share a draw
        return hit

    def _literal(self, expr: Literal, device) -> ValuePair:
        key = (expr, str(device))
        hit = self._consts.get(key)
        if hit is not None:
            return hit
        if expr.value is None:
            dt = expr.dtype.dtype if expr.dtype and \
                expr.dtype.kind != TypeKind.UNKNOWN else np.int64
            hit = (torch.zeros((), dtype=torch_dtype(dt), device=device),
                   torch.zeros((), dtype=torch.bool, device=device))
        elif isinstance(expr.value, DeviceTable):
            # a table literal goes to its impl as it is: the impl picks
            # its form from the host values (functions/scalar.py)
            hit = (expr.value, None)
        elif isinstance(expr.value, str):
            raise RuntimeError(
                f"string literal {expr.value!r} reached device eval — "
                "string expressions must bind against a dictionary column")
        else:
            v = expr.value
            if isinstance(expr.dtype, DecimalType):
                v = int(round(v * 10 ** expr.dtype.scale))
            hit = (torch.full((), v, dtype=torch_dtype(expr.dtype.dtype),
                              device=device), None)
        self._consts[key] = hit
        return hit

    def _host_table(self, table: np.ndarray, device) -> torch.Tensor:
        """A bind-time host table on ``device``, uploaded once per set."""
        key = ("table", id(table), str(device))
        hit = self._consts.get(key)
        if hit is None:
            hit = self._consts[key] = (torch.from_numpy(table).to(device),
                                       table)   # keeps id(table) unique
        return hit[0]

    def _gather_codes(self, table: np.ndarray, codes, device):
        """``table[code + 1]``: code -1 (null, padding) reads entry 0."""
        t = self._host_table(table, device)
        idx = codes.to(torch.int64).clamp(-1, t.shape[0] - 2) + 1
        return t.index_select(0, idx.reshape(-1)).reshape(codes.shape)

    def _eval_inner(self, expr, arrays, memo, device) -> ValuePair:
        if isinstance(expr, FieldRef):
            return arrays[expr.name]
        if isinstance(expr, DictTransform):
            codes, valid = self._eval(expr.codes, arrays, memo, device)
            return self._gather_codes(expr.table, codes, device), valid
        if isinstance(expr, Call) and expr.name == "dict_lookup_bool":
            codes, valid = self._eval(expr.args[0], arrays, memo, device)
            return self._gather_codes(expr.args[1].value, codes,
                                      device), valid
        if isinstance(expr, Literal):
            return self._literal(expr, device)
        if isinstance(expr, Cast):
            v, valid = self._eval(expr.expr, arrays, memo, device)
            return _eval_cast(v, valid, expr.expr.dtype, expr.dtype)
        if isinstance(expr, TryExpr):
            return self._eval(expr.expr, arrays, memo, device)
        if isinstance(expr, Call):
            if expr.name in _RANDOM:
                return self._eval_random(expr, arrays, memo, device)
            pairs = [self._eval(a, arrays, memo, device) for a in expr.args]
            fn = lookup_function(expr.name)
            if not fn.default_nulls:
                return fn.impl(*pairs)
            if not pairs:        # a constant: pi(), e(), nan(), infinity()
                return torch.tensor(fn.impl(), device=device,
                                    dtype=torch_dtype(expr.dtype.dtype)), None
            values = [p[0] for p in pairs]
            if fn.promote_args:
                tensors = [v for v in values if isinstance(v, torch.Tensor)]
                common = tensors[0].dtype
                for v in tensors[1:]:
                    common = torch.promote_types(common, v.dtype)
                values = [v.to(common) if isinstance(v, torch.Tensor)
                          else v for v in values]
            vals = fn.impl(*values)
            valid = None
            for _, va in pairs:
                if va is not None:
                    valid = (va if valid is None
                             else torch.logical_and(valid, va))
            # broadcast literal-only validity to value shape
            if valid is not None and valid.shape != vals.shape:
                valid = torch.broadcast_to(valid, vals.shape)
            return vals, valid
        raise TypeError(f"cannot evaluate {expr!r}")

    def _eval_random(self, expr, arrays, memo, device) -> ValuePair:
        """rand()/random(): a DOUBLE in [0, 1) for each row of the batch's
        capacity; rand(n): an integer in [0, n), NULL where n is
        (velox/functions/prestosql/Rand.h). Each evaluation draws from a
        generator of its own on the batch's device, seeded from
        ``os.urandom``; there is no global RNG state."""
        cap = next((v.shape[0] for v, _ in arrays.values()
                    if isinstance(v, torch.Tensor) and v.ndim >= 1), 1)
        gen = torch.Generator(device=device)
        gen.manual_seed(int.from_bytes(os.urandom(8), "little") >> 1)
        u = torch.rand(cap, generator=gen, dtype=torch.float64,
                       device=device)
        if not expr.args:
            return u, None
        bound, bvalid = self._eval(expr.args[0], arrays, memo, device)
        n = torch.clamp(bound, min=1).to(torch.float64)
        return torch.floor(u * n).to(torch.int64), bvalid
