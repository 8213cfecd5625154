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
   dictionaries are sorted, so codes are ranks); a compare of two string
   columns compares ranks in the union of their dictionaries; ``like``
   and ``starts_with``/``ends_with`` become a lookup of a per-value
   match table; every other string function, a cast from a string, and
   ``date_format`` or an integer-to-string function over a column with
   stats becomes a ``DictTransform``: a gather into the codes of a new
   sorted dictionary or into a typed value table, with a validity table
   where the function can return NULL. Each table is computed on the
   host once per distinct value (or per value of the column's range)
   and kept with its dictionary; string columns otherwise pass
   through.
3. ``widen_decimal_arith`` then evaluation over ``(values, valid)`` pairs
   with common-subexpression memoization (``rand`` is drawn anew for
   every call). There is no tracing: every node runs as torch ops on the
   device of the input tensors.

Integer promotion follows the reference, not torch: a 0-d int64 literal
against an int32 column yields int64 (torch alone would keep int32), so
every default-null call promotes its operands to one dtype first.
"""

from __future__ import annotations

import datetime
import functools
import os
import re
import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from velox_tpu_torch import torch_dtype, true_divide
from velox_tpu_torch.types import (
    BIGINT, BOOLEAN, DATE, DOUBLE, DataType, INTEGER, TIMESTAMP, VARCHAR,
)
from velox_tpu_torch.types.types import (
    ArrayType, DecimalType, MapType, RowType, TypeKind, array,
    common_numeric_type, map_, row_type,
)
from velox_tpu_torch.expr.ir import (
    Call, Cast, Expr, FieldRef, Lambda, Literal, TryExpr,
)
from velox_tpu_torch.functions.registry import lookup_function
from velox_tpu_torch.functions.scalar import DeviceTable
from velox_tpu_torch.utils.tz import ZoneTable, zone_table



@dataclass(frozen=True, eq=False)
class DictTransform(Expr):
    """A string function applied to a dictionary column at bind time: run
    once per distinct dictionary value on the host, then on the device a
    single gather ``table[code + 1]``, into the codes of the new sorted
    dictionary for a string result or into the values of any other
    (velox/expression/Expr.cpp:1280 evalWithMemo memoizes per base
    value; here the memo is precomputed). Where the function can return
    NULL, ``valid_table`` is gathered beside the values and ANDed into
    the validity."""

    codes: Expr = None          # type: ignore[assignment]
    table: object = None        # np.ndarray: old code + 1 -> new code
    dictionary: object = None   # vector.column.Dictionary of the results
    valid_table: object = None  # optional np bool: code + 1 -> non-null

    @property
    def children(self):
        return (self.codes,)

    # identity semantics: two same-typed transforms must not collide in
    # the evaluation memo
    def __eq__(self, other):
        return self is other

    def __hash__(self):
        return id(self)


@dataclass(frozen=True, eq=False)
class PairTransform(Expr):
    """A host function of two dictionary columns (the sketch set
    operations), evaluated once per distinct pair of codes that occurs in
    a batch: the pairs are found on the device (one host sync), the host
    calls ``fn`` on each new pair's values (kept across batches in
    ``memo``), and the device gathers the results. The JAX package
    enumerates the whole cross product of the two dictionaries at bind
    time, which a column of 10^5 sketch blobs puts out of reach; the
    results are the same."""

    codes_a: Expr = None        # type: ignore[assignment]
    codes_b: Expr = None        # type: ignore[assignment]
    values_a: tuple = ()
    values_b: tuple = ()
    fn: object = None
    memo: object = None         # dict: (i, j) -> result or None

    @property
    def children(self):
        return (self.codes_a, self.codes_b)

    def __eq__(self, other):
        return self is other

    def __hash__(self):
        return id(self)


_EPOCH = datetime.date(1970, 1, 1)
_ARITH = {"plus", "minus", "multiply", "divide", "mod"}
_COMPARE = {"eq", "neq", "lt", "lte", "gt", "gte"}
_RANGE_COMPARE = {"lt", "lte", "gt", "gte"}


# ------------------------------------------------------------------ phase 1

def resolve_types(expr: Expr, schema: RowType) -> Expr:
    """Bind field types, resolve result types, insert implicit casts."""
    if isinstance(expr, FieldRef):
        try:
            return FieldRef(schema.find_child(expr.name), expr.name)
        except KeyError:
            # a dotted subfield of a ROW column ("r.a"): the evaluation
            # reads the child lane under the same dotted name
            t = _navigate_row_field(schema, expr.name)
            if t is None:
                raise
            return FieldRef(t, expr.name)

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
        if expr.name in _HIGHER_ORDER_FUNCS:
            return _resolve_higher_order(expr, schema)
        if expr.name in _COMPARE or expr.name in (
                "between", "is_null", "is_not_null"):
            wide = _resolve_wide_compare(expr, schema)
            if wide is not None:
                return wide
        if expr.name in ("dot_product", "l2_squared", "l2_norm"):
            return resolve_types(_vector_math(expr), schema)
        args = tuple(resolve_types(a, schema) for a in expr.args)
        name = expr.name
        complex_ = _resolve_complex_call(name, args)
        if complex_ is not None:
            return complex_
        string = _resolve_string_call(name, args)
        if string is not None:
            return string
        if name in _DAY_PART_FNS or name in _TIME_PART_FNS:
            a0 = args[0]
            if a0.dtype is not None and a0.dtype.kind == TypeKind.TIMESTAMP:
                # an argument that at_timezone or an earlier resolution
                # already adjusted stays as it is
                if not (isinstance(a0, Call) and a0.name in (
                        "__tz_adjust", "__tz_unadjust")):
                    a0 = _session_adjust(a0)
                if name in _DAY_PART_FNS:
                    # day-granularity parts read DATE lanes: TIMESTAMP
                    # microseconds floor-divide to days first
                    a0 = Call(DATE, "__ts_days", (a0,))
                rt = DATE if name == "last_day_of_month" else BIGINT
                return Call(rt, name, (a0,) + args[1:])
        if name in ("timezone_hour", "timezone_minute"):
            return Call(BIGINT, f"__{name}", (args[0], _session_zone()))
        if name in ("at_timezone", "with_timezone"):
            # at_timezone shifts an instant to the zone's wall clock (there
            # is no zone-carrying timestamp type, so the local instant is
            # materialized); with_timezone reads a wall clock as local
            if not (isinstance(args[1], Literal)
                    and isinstance(args[1].value, str)):
                raise TypeError(f"{name} zone must be a string literal")
            impl = ("__tz_adjust" if name == "at_timezone"
                    else "__tz_unadjust")
            return Call(TIMESTAMP, impl, (args[0], Literal(
                BIGINT, zone_table(args[1].value))))
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


def _wide_lanes(schema: RowType, name: str):
    """(lane FieldRefs (d2, d1, d0), scale) when ``name`` is a shredded
    long-decimal column (``types/widedec.py`` lane names), else None."""
    from velox_tpu_torch.types.widedec import parse_lane

    for n in schema.names:
        if n.startswith(f"{name}#w2s"):
            base, _d, scale = parse_lane(n)
            if base != name:
                continue
            lanes = [f"{name}#w{d}s{scale}" for d in (2, 1, 0)]
            if all(schema.contains(x) for x in lanes):
                return [FieldRef(BIGINT, x) for x in lanes], scale
    return None


def _literal_unscaled(e: Expr, scale: int) -> int:
    """A literal's unscaled value at ``scale``, exactly: an integer or a
    numeral's decimal text, never through a float (the JAX package takes
    ``round(v * 10**scale)`` of a float and loses digits past 2^53)."""
    import decimal

    if not isinstance(e, Literal) or e.value is None:
        raise TypeError("long-decimal comparison needs a literal operand")
    v = e.value
    if isinstance(v, bool) or not isinstance(v, (int, float,
                                                 decimal.Decimal)):
        raise TypeError("long-decimal comparison needs a numeric literal")
    if isinstance(v, int):
        return v * 10 ** scale
    d = decimal.Decimal(e.text or repr(v)) if isinstance(v, float) else v
    return int(d.scaleb(scale, decimal.Context(prec=80)).to_integral_value(
        decimal.ROUND_HALF_EVEN))


def _resolve_wide_compare(expr: Call, schema: RowType):
    """A compare or NULL test on a shredded long-decimal column: the
    literal splits into signed digits and the compare becomes a
    lexicographic chain over the three lanes (signed digits order like
    the int128 values, velox/type/HugeInt.h); ``IS [NOT] NULL`` reads
    the top lane. None where no operand is such a column."""
    from velox_tpu_torch.types.widedec import split_ints

    ref = next((a for a in expr.args if isinstance(a, FieldRef)
                and not schema.contains(a.name)), None)
    if ref is None:
        return None
    wl = _wide_lanes(schema, ref.name)
    if wl is None:
        return None
    lanes, scale = wl
    name = expr.name
    if name in ("is_null", "is_not_null"):
        return resolve_types(Call(BOOLEAN, name, (lanes[0],)), schema)

    def digits(e):
        d2, d1, d0 = split_ints([_literal_unscaled(e, scale)])
        return [Literal(BIGINT, int(d[0])) for d in (d2, d1, d0)]

    f2, f1, f0 = lanes

    def chain(op, lits):
        # lexicographic (d2, d1, d0) <op> (L2, L1, L0), op strict
        l2, l1, l0 = lits
        return Call(BOOLEAN, "or", (
            Call(BOOLEAN, op, (f2, l2)),
            Call(BOOLEAN, "and", (
                Call(BOOLEAN, "eq", (f2, l2)),
                Call(BOOLEAN, "or", (
                    Call(BOOLEAN, op, (f1, l1)),
                    Call(BOOLEAN, "and", (
                        Call(BOOLEAN, "eq", (f1, l1)),
                        Call(BOOLEAN, op, (f0, l0))))))))))

    def equal(lits):
        l2, l1, l0 = lits
        return Call(BOOLEAN, "and", (
            Call(BOOLEAN, "eq", (f2, l2)),
            Call(BOOLEAN, "and", (Call(BOOLEAN, "eq", (f1, l1)),
                                  Call(BOOLEAN, "eq", (f0, l0))))))

    others = [a for a in expr.args if a is not ref]
    if name == "between":
        lo, hi = digits(others[0]), digits(others[1])
        out = Call(BOOLEAN, "and", (
            Call(BOOLEAN, "or", (chain("gt", lo), equal(lo))),
            Call(BOOLEAN, "or", (chain("lt", hi), equal(hi)))))
        return resolve_types(out, schema)
    lits = digits(others[0])
    if name == "eq":
        out = equal(lits)
    elif name == "neq":
        out = Call(BOOLEAN, "not", (equal(lits),))
    else:
        op = name
        if not isinstance(expr.args[0], FieldRef):   # literal <op> field
            op = {"lt": "gt", "lte": "gte", "gt": "lt", "gte": "lte"}[op]
        out = chain({"lt": "lt", "lte": "lt", "gt": "gt", "gte": "gt"}[op],
                    lits)
        if op in ("lte", "gte"):
            out = Call(BOOLEAN, "or", (out, equal(lits)))
    return resolve_types(out, schema)


#: date parts that read DATE (day) lanes
_DAY_PART_FNS = {
    "year", "month", "day", "day_of_month", "day_of_week", "dow",
    "day_of_year", "doy", "quarter", "week", "week_of_year",
    "last_day_of_month",
}
#: parts of the time of day, which read TIMESTAMP lanes
_TIME_PART_FNS = {"hour", "minute", "second", "millisecond"}


def _session_zone() -> Literal:
    from velox_tpu_torch.utils.config import config

    return Literal(BIGINT, zone_table(config.session_timezone))


def _session_adjust(a0: Expr) -> Expr:
    """A TIMESTAMP expression read in the session zone (itself under a
    UTC session)."""
    from velox_tpu_torch.utils.config import config

    if config.session_timezone.strip().upper() in ("UTC", "GMT", ""):
        return a0
    return Call(a0.dtype, "__tz_adjust", (a0, _session_zone()))


def _navigate_row_field(schema: RowType, dotted: str):
    """The type of "r.a.b" where column "r" is ROW-typed, or None."""
    parts = dotted.split(".")
    for k in range(len(parts) - 1, 0, -1):
        head = ".".join(parts[:k])
        if not schema.contains(head):
            continue
        t = schema.find_child(head)
        ok = True
        for nm in parts[k:]:
            if t.kind != TypeKind.ROW or not t.contains(nm):
                ok = False
                break
            t = t.find_child(nm)
        if ok:
            return t
    return None


def _vector_math(expr: Call) -> Expr:
    """``dot_product``/``l2_squared``/``l2_norm`` over arrays, rewritten
    onto ``zip_with``/``transform`` and ``array_sum``."""
    x, y = FieldRef(None, "x"), FieldRef(None, "y")
    if expr.name == "l2_norm":
        return Call(None, "sqrt", (Call(None, "array_sum", (
            Call(None, "transform", (expr.args[0], Lambda(
                None, ("x",), Call(None, "multiply", (x, x))))),)),))
    if expr.name == "dot_product":
        body = Call(None, "multiply", (x, y))
    else:
        d = Call(None, "minus", (x, y))
        body = Call(None, "multiply", (d, d))
    return Call(None, "array_sum", (Call(None, "zip_with", (
        expr.args[0], expr.args[1], Lambda(None, ("x", "y"), body))),))


def _need(args, kind, name: str, n: int = 1) -> None:
    for a in args[:n]:
        if not isinstance(a.dtype, kind):
            raise TypeError(f"{name} expects {kind.__name__} arguments")


def _resolve_complex_call(name: str, args) -> Optional[Expr]:
    """The result type of a call that makes or reads an ARRAY, MAP or ROW
    (the JAX package's ``resolve_types`` branches); None for any other."""
    a0 = args[0].dtype if args else None
    if name in ("row_constructor", "row"):
        rt = row_type([f"c{i + 1}" for i in range(len(args))],
                      [a.dtype for a in args])
        return Call(rt, "row_constructor", args)
    if name == "map_entries":
        _need(args, MapType, name)
        return Call(array(row_type(["key", "value"], [a0.key, a0.value])),
                    name, args)
    if name == "zip":
        _need(args, ArrayType, name, len(args))
        return Call(array(row_type(
            [f"c{i + 1}" for i in range(len(args))],
            [a.dtype.element for a in args])), name, args)
    if name in ("concat", "reverse") and isinstance(a0, ArrayType):
        if name == "reverse":
            return Call(a0, "array_reverse", args)
        if len(args) != 2:
            raise TypeError("concat over arrays takes exactly two inputs")
        if (not isinstance(args[1].dtype, ArrayType)
                or args[1].dtype.element.kind != a0.element.kind):
            raise TypeError("concat: array types differ")
        return Call(a0, "array_concat", args)
    if name in ("split", "regexp_split", "regexp_extract_all"):
        return Call(array(VARCHAR), name, args)
    if name in ("array_sort", "array_distinct", "slice", "array_sort_desc",
                "array_duplicates", "shuffle", "remove_nulls", "trim_array",
                "array_top_n"):
        _need(args, ArrayType, name)
        return Call(a0, name, args)
    if name == "map_concat":
        _need(args, MapType, name, 2)
        if (a0.key.kind != args[1].dtype.key.kind
                or a0.value.kind != args[1].dtype.value.kind):
            raise TypeError("map_concat: map types differ")
        return Call(a0, name, args)
    if name == "array_remove":
        # filter(a, x -> x <> v OR x IS NULL): NULL elements stay
        # (ArrayRemoveFunction.h)
        _need(args, ArrayType, name)
        px = FieldRef(a0.element, "__arx")
        body = Call(BOOLEAN, "or", (
            Call(BOOLEAN, "neq", (px, args[1])),
            Call(BOOLEAN, "is_null", (px,))))
        return Call(a0, "filter", (args[0], Lambda(BOOLEAN, ("__arx",),
                                                   body)))
    if name in ("array_intersect", "array_except", "array_union",
                "arrays_overlap"):
        _need(args, ArrayType, name, 2)
        if a0.element.kind != args[1].dtype.element.kind:
            raise TypeError(f"{name}: element types differ")
        return Call(BOOLEAN if name == "arrays_overlap" else a0, name, args)
    if name in ("array_has_duplicates", "map_key_exists",
                "map_keys_overlap"):
        return Call(BOOLEAN, name, args)
    if name == "array_cum_sum":
        return Call(array(DOUBLE if a0.element.is_floating else BIGINT),
                    name, args)
    if name == "array_normalize":
        return Call(array(DOUBLE), name, args)
    if name in ("map_subset", "map_intersect", "map_except",
                "map_remove_null_values", "map_top_n",
                "map_values_in_range", "remap_keys"):
        _need(args, MapType, name)
        return Call(a0, name, args)
    if name == "map_normalize":
        return Call(map_(a0.key, DOUBLE), name, args)
    if name in ("map_top_n_keys", "map_keys_by_top_n_values"):
        return Call(array(a0.key), name, args)
    if name == "map_top_n_values":
        return Call(array(a0.value), name, args)
    if name == "map":
        _need(args, ArrayType, name, 2)
        return Call(map_(a0.element, args[1].dtype.element), name, args)
    if name in ("map_from_entries", "multimap_from_entries"):
        et = a0.element
        if not isinstance(et, RowType) or len(et.children) != 2:
            raise TypeError(f"{name} expects ARRAY(ROW(k, v))")
        vt = et.children[1] if name == "map_from_entries" else array(
            et.children[1])
        return Call(map_(et.children[0], vt), name, args)
    if name in ("split_to_map", "split_to_multimap"):
        # split_to_multimap: duplicate keys repeat as entries (the JAX
        # package's form, not Presto's map(k, array(v)))
        return Call(map_(VARCHAR, VARCHAR), name, args)
    if name == "flatten":
        if not isinstance(a0.element, ArrayType):
            raise TypeError("flatten expects ARRAY(ARRAY(T))")
        return Call(a0.element, name, args)
    if name in ("ngrams", "combinations", "array_split_into_chunks"):
        return Call(array(a0), name, args)
    if name == "array_frequency":
        return Call(map_(a0.element, INTEGER), name, args)
    if name == "cosine_similarity":
        return Call(DOUBLE, name, args)
    if name == "array_join":
        return Call(VARCHAR, name, args)
    if (name == "element_at" and len(args) == 2
            and isinstance(args[0], Call)
            and args[0].name == "array_constructor"
            and isinstance(args[1], Literal)):
        # ARRAY[e1..en][k] folds to its k-th entry (1-based, negative
        # from the end, NULL out of bounds)
        entries, et = args[0].args, a0.element
        k = int(args[1].value)
        if k < 0:
            k = len(entries) + 1 + k
        if not 1 <= k <= len(entries):
            return Literal(et, None)
        picked = entries[k - 1]
        if picked.dtype is not None and picked.dtype.kind != et.kind:
            return Cast(et, picked, False)
        return picked
    if name == "array_constructor":
        et = None
        for a in args:
            if a.dtype is None:
                continue
            et = a.dtype if et is None else (
                a.dtype if a.dtype.kind == et.kind
                else common_numeric_type(et, a.dtype))
        return Call(array(et if et is not None else BIGINT), name, args)
    if name == "repeat":
        return Call(array(a0), name, args)
    if name == "sequence":
        if len(args) != 2:
            raise TypeError("sequence(start, stop) takes 2 arguments")
        return Call(array(BIGINT), name, args)
    if name in ("map_keys", "map_values"):
        _need(args, MapType, name)
        return Call(array(a0.key if name == "map_keys" else a0.value),
                    name, args)
    return None


#: surface array functions rewritten onto the derived lanes at bind time
_ARRAY_FUNCS = {
    "cardinality", "array_sum", "array_average", "array_min", "array_max",
    "contains", "element_at", "array_position",
}

#: map lambda matches: the array match forms pointed at the key or value
#: lane (velox/functions/prestosql/MapFunctions.h)
_MAP_MATCH_FNS = {
    "any_keys_match": (("k", "any"), lambda mt: mt.key),
    "all_keys_match": (("k", "all"), lambda mt: mt.key),
    "no_keys_match": (("k", "none"), lambda mt: mt.key),
    "any_values_match": (("v", "any"), lambda mt: mt.value),
    "no_values_match": (("v", "none"), lambda mt: mt.value),
    "map_values_any_match": (("v", "any"), lambda mt: mt.value),
    "map_values_all_match": (("v", "all"), lambda mt: mt.value),
    "map_values_none_match": (("v", "none"), lambda mt: mt.value),
}

#: functions taking a lambda
_HIGHER_ORDER_FUNCS = {
    "transform", "any_match", "all_match", "none_match",
    "transform_values", "map_filter", "filter", "transform_keys",
    "zip_with", "map_zip_with", "find_first", "find_first_index",
    "array_max_by", "array_min_by", "transform_with_index",
} | set(_MAP_MATCH_FNS)


def _lambda_schema(params, param_types, outer: RowType) -> RowType:
    """A lambda body's scope: the parameters, then the outer row's
    scalar columns (captures), which the parameters shadow."""
    names, types = list(params), list(param_types)
    for n, t in zip(outer.names, outer.children):
        if n in params or isinstance(t, (ArrayType, MapType)):
            continue
        names.append(n)
        types.append(t)
    return RowType(TypeKind.ROW, tuple(names), tuple(types))


def _lambda_body(lam, param_types, schema: RowType) -> Lambda:
    if len(lam.params) != len(param_types):
        raise TypeError(f"lambda takes {len(param_types)} parameters")
    body = resolve_types(lam.body, _lambda_schema(lam.params, param_types,
                                                  schema))
    return Lambda(body.dtype, lam.params, body)


def _resolve_higher_order(expr: Call, schema: RowType) -> Expr:
    """fn(collection, lambda): the body types against the parameters and
    the outer row's scalar columns."""
    name = expr.name
    if not expr.args or not isinstance(expr.args[-1], Lambda):
        raise TypeError(f"{name} expects a lambda as its last argument")
    if name in ("zip_with", "map_zip_with"):
        if len(expr.args) != 3:
            raise TypeError(f"{name} expects (x, y, lambda)")
        a = resolve_types(expr.args[0], schema)
        b = resolve_types(expr.args[1], schema)
        kind = ArrayType if name == "zip_with" else MapType
        _need((a, b), kind, name, 2)
        if name == "zip_with":
            lam = _lambda_body(expr.args[2], (a.dtype.element,
                                              b.dtype.element), schema)
            return Call(array(lam.dtype), name, (a, b, lam))
        lam = _lambda_body(expr.args[2], (a.dtype.key, a.dtype.value,
                                          b.dtype.value), schema)
        return Call(map_(a.dtype.key, lam.dtype), name, (a, b, lam))
    if len(expr.args) != 2:
        raise TypeError(f"{name} expects (collection, lambda)")
    arr = resolve_types(expr.args[0], schema)
    t = arr.dtype
    if name in ("transform_values", "map_filter", "transform_keys"):
        _need((arr,), MapType, name)
        lam = _lambda_body(expr.args[1], (t.key, t.value), schema)
        if name == "map_filter":
            _boolean_body(lam, name)
            return Call(t, name, (arr, lam))
        if name == "transform_keys":
            return Call(map_(lam.dtype, t.value), name, (arr, lam))
        return Call(map_(t.key, lam.dtype), name, (arr, lam))
    if name in _MAP_MATCH_FNS:
        _need((arr,), MapType, name)
        lam = _lambda_body(expr.args[1], (_MAP_MATCH_FNS[name][1](t),),
                           schema)
        _boolean_body(lam, name)
        return Call(BOOLEAN, name, (arr, lam))
    _need((arr,), ArrayType, name)
    if name == "transform_with_index":
        lam = _lambda_body(expr.args[1], (t.element, BIGINT), schema)
        return Call(array(lam.dtype), name, (arr, lam))
    lam = _lambda_body(expr.args[1], (t.element,), schema)
    if name == "transform":
        return Call(array(lam.dtype), name, (arr, lam))
    if name in ("array_max_by", "array_min_by"):
        return Call(t.element, name, (arr, lam))
    _boolean_body(lam, name)
    if name == "filter":
        return Call(t, name, (arr, lam))
    if name == "find_first":
        return Call(t.element, name, (arr, lam))
    if name == "find_first_index":
        return Call(BIGINT, name, (arr, lam))
    return Call(BOOLEAN, name, (arr, lam))


def _boolean_body(lam: Lambda, name: str) -> None:
    if lam.dtype.kind != TypeKind.BOOLEAN:
        raise TypeError(f"{name} lambda must return BOOLEAN")


def _substitute_param(expr: Expr, param: str, repl: Expr) -> Expr:
    if isinstance(expr, FieldRef):
        return repl if expr.name == param else expr
    if isinstance(expr, Call):
        return Call(expr.dtype, expr.name, tuple(
            _substitute_param(a, param, repl) for a in expr.args))
    if isinstance(expr, Cast):
        return Cast(expr.dtype, _substitute_param(expr.expr, param, repl),
                    expr.null_on_failure)
    if isinstance(expr, TryExpr):
        return TryExpr(expr.dtype,
                       _substitute_param(expr.expr, param, repl))
    return expr


def _wrap_captures(expr: Expr, params, lanes) -> Expr:
    """Captured outer-row FieldRefs inside a lambda body become
    ``__capture(st, ln, elemv, col)``: gathered to the element capacity
    by owning row at evaluation (velox/expression/LambdaExpr.cpp)."""
    st, ln, ev = lanes
    if isinstance(expr, FieldRef):
        if expr.name in params or "#" in expr.name:
            return expr
        return Call(expr.dtype, "__capture", (st, ln, ev, expr))
    if isinstance(expr, Call):
        return Call(expr.dtype, expr.name, tuple(
            _wrap_captures(a, params, lanes) for a in expr.args))
    if isinstance(expr, Cast):
        return Cast(expr.dtype, _wrap_captures(expr.expr, params, lanes),
                    expr.null_on_failure)
    if isinstance(expr, TryExpr):
        return TryExpr(expr.dtype, _wrap_captures(expr.expr, params, lanes))
    return expr


def _lanes(x: str, lane: str, lane_t: DataType):
    return (FieldRef(INTEGER, f"{x}#start"), FieldRef(INTEGER, f"{x}#len"),
            FieldRef(lane_t, f"{x}#{lane}"))


def _lambda_over(x: str, lane: str, lane_t: DataType, lam: Lambda):
    """A one-parameter lambda body over a collection lane, captures
    wrapped: ``(st, ln, ev, body)``."""
    st, ln, ev = _lanes(x, lane, lane_t)
    body = _substitute_param(lam.body, lam.params[0], ev)
    return st, ln, ev, _wrap_captures(body, lam.params, (st, ln, ev))


def _string_pass(et: DataType, out: Expr, d) -> Expr:
    """A string element read back through its dictionary (the codes keep
    it as the result's dictionary)."""
    if not et.is_string:
        return out
    n = len(d) if d is not None else 0
    table = np.concatenate([[-1], np.arange(n)]).astype(np.int32)
    return DictTransform(et, out, table, d)


def _key_code(lit: Expr, et: DataType, d, name: str) -> Expr:
    """A literal compared with a string lane becomes its code there."""
    if not et.is_string:
        return lit
    if not isinstance(lit, Literal):
        raise TypeError(f"{name} on string elements needs a literal")
    return Literal(INTEGER, d.code_of(lit.value) if d is not None else -2)


def bind_array_funcs(expr: Expr, dictionaries: Dict[str, "Dictionary"]
                     ) -> Expr:
    """Rewrite array and map function calls onto the collection column's
    derived lanes (``x#start``, ``x#len``, ``x#elemv``; a map's ``x#kv``
    and ``x#vv``: ``exec/operator.py`` ``eval_pairs``), so that
    ``array_sum(x)`` and the rest evaluate as flat segment reductions
    that hold for any (gathered, shared) offsets
    (velox/functions/prestosql/ArrayFunctions.h runs per row)."""
    if not isinstance(expr, Call):
        if isinstance(expr, Cast):
            return Cast(expr.dtype, bind_array_funcs(expr.expr, dictionaries),
                        expr.null_on_failure)
        if isinstance(expr, TryExpr):
            return TryExpr(expr.dtype,
                           bind_array_funcs(expr.expr, dictionaries))
        return expr
    name, args = expr.name, expr.args
    a0 = args[0].dtype if args else None

    def column(kind) -> str:
        if not isinstance(args[0], FieldRef):
            raise TypeError(f"{name} requires a {kind} column reference")
        return args[0].name

    if name in ("any_match", "all_match", "none_match"):
        x = column("ARRAY")
        st, ln, _, body = _lambda_over(x, "elemv", a0.element, args[1])
        return Call(BOOLEAN, f"__array_{name}", (st, ln, body))
    if name in _MAP_MATCH_FNS:
        x = column("MAP")
        (lane, mode), lane_t = _MAP_MATCH_FNS[name][0], \
            _MAP_MATCH_FNS[name][1](a0)
        st, ln, _, body = _lambda_over(x, "kv" if lane == "k" else "vv",
                                       lane_t, args[1])
        return Call(BOOLEAN, f"__array_{mode}_match", (st, ln, body))
    if name in ("find_first", "find_first_index", "array_max_by",
                "array_min_by"):
        x = column("ARRAY")
        et = a0.element
        st, ln, ev, body = _lambda_over(x, "elemv", et, args[1])
        if name == "find_first_index":
            return Call(BIGINT, "__array_find_first_index", (st, ln, body))
        op = {"find_first": "__array_find_first",
              "array_max_by": "__array_max_by",
              "array_min_by": "__array_min_by"}[name]
        return _string_pass(et, Call(et, op, (st, ln, body, ev)),
                            dictionaries.get(f"{x}#elemv"))
    if name in _PROJECTION_ONLY:
        raise TypeError(
            f"{name}(...) is only supported as a top-level projection")
    if isinstance(a0, MapType) and name in ("map_key_exists",
                                            "map_keys_overlap"):
        x = column("MAP")
        st, ln, kv = _lanes(x, "kv", a0.key)
        d = dictionaries.get(f"{x}#kv")
        if name == "map_key_exists":
            lit = _key_code(bind_array_funcs(args[1], dictionaries),
                            a0.key, d, name)
            return Call(BOOLEAN, "__array_contains", (st, ln, kv, lit))
        arr = args[1]
        if not (isinstance(arr, Call) and arr.name == "array_constructor"
                and all(isinstance(a, Literal) for a in arr.args)):
            raise TypeError(
                "map_keys_overlap needs a literal ARRAY[...] argument")
        vals = [a.value for a in arr.args]
        if a0.key.is_string:
            table = np.zeros((len(d) if d is not None else 0) + 1, np.bool_)
            for v in vals:
                c = d.code_of(v) if d is not None else -2
                if c >= 0:
                    table[c + 1] = True
            hit = Call(BOOLEAN, "dict_lookup_bool",
                       (kv, Literal(BOOLEAN, table)))
        else:
            hit = Call(BOOLEAN, "in", (kv, *[Literal(a0.key, v)
                                             for v in vals]))
        return Call(BOOLEAN, "__array_any_match", (st, ln, hit))
    if isinstance(a0, MapType) and name in ("cardinality", "element_at"):
        x = column("MAP")
        st, ln, kv = _lanes(x, "kv", a0.key)
        if name == "cardinality":
            return Cast(BIGINT, ln, False)
        vv = FieldRef(a0.value, f"{x}#vv")
        lit = _key_code(bind_array_funcs(args[1], dictionaries), a0.key,
                        dictionaries.get(f"{x}#kv"), name)
        return _string_pass(
            a0.value, Call(a0.value, "__map_element_at",
                           (st, ln, kv, vv, lit)),
            dictionaries.get(f"{x}#vv"))
    if isinstance(a0, ArrayType) and name in _ARRAY_FUNCS:
        x = column("ARRAY")
        et = a0.element
        st, ln, ev = _lanes(x, "elemv", et)
        d = dictionaries.get(f"{x}#elemv")
        if name == "cardinality":
            return Cast(BIGINT, ln, False)
        if name == "array_sum":
            return Call(expr.dtype, "__array_sum", (st, ln, ev))
        if name in ("array_min", "array_max"):
            return _string_pass(et, Call(et, f"__{name}", (st, ln, ev)), d)
        if name == "array_average":
            return Call(DOUBLE, "__array_avg", (st, ln, ev))
        arg = bind_array_funcs(args[1], dictionaries)
        if name == "element_at":
            return _string_pass(et, Call(et, "__array_element_at",
                                         (st, ln, ev, arg)), d)
        lit = _key_code(arg, et, d, name)
        if name == "array_position":
            return Call(BIGINT, "__array_position", (st, ln, ev, lit))
        return Call(BOOLEAN, "__array_contains", (st, ln, ev, lit))
    return Call(expr.dtype, name, tuple(bind_array_funcs(a, dictionaries)
                                        for a in args))


#: collection-valued calls that run only as a top-level projection
#: (``ProjectOp``)
_PROJECTION_ONLY = {
    "transform", "transform_values", "map_filter", "map_concat", "filter",
    "transform_keys", "zip_with", "array_concat", "array_reverse",
    "map_keys", "map_values", "sequence", "slice", "repeat", "array_sort",
    "array_distinct", "array_intersect", "array_except", "array_union",
    "arrays_overlap", "split", "regexp_split", "regexp_extract_all",
}


def _resolve_string_call(name: str, args) -> Optional[Expr]:
    """The result type of a string function, all of which phase 2 binds
    to dictionary transforms; None for any other name. The array-valued
    ones (``split``, ``regexp_split``, ``regexp_extract_all``) resolve
    with the complex calls."""
    if name in ("substr", "substring"):
        return Call(VARCHAR, "substr", args)
    if name in ("upper", "lower", "trim", "ltrim", "rtrim", "reverse",
                "concat", "replace", "lpad", "rpad", "split_part",
                "date_format", "format_datetime") or name in _INT_VALUE_FNS:
        return Call(VARCHAR, name, args)
    if name in ("length", "strpos", "position"):
        return Call(BIGINT, name, args)
    if name in ("starts_with", "ends_with"):
        return Call(BOOLEAN, name, args)
    if name in _DICT_VALUE_FNS:
        return Call(_DICT_VALUE_FNS[name][0], name, args)
    if name in _PAIR_HOST_FNS:
        return Call(_PAIR_HOST_FNS[name][0], name, args)
    if (name == "cardinality" and args and args[0].dtype is not None
            and args[0].dtype.is_string):
        # cardinality of a sketch blob (HLL / SetDigest / KHLL), not of an
        # ARRAY or MAP
        return Call(BIGINT, "sketch_cardinality", args)
    if (name == "data_size_for_stats" and args[0].dtype is not None
            and args[0].dtype.is_string):
        # a 4-byte length prefix and the UTF-8 bytes (velox/functions/
        # prestosql/aggregates/MaxSizeForStatsAggregate.cpp); fixed-width
        # types take the registered function
        return Call(BIGINT, "plus", (Call(BIGINT, "octet_length", args),
                                     Literal(BIGINT, 4)))
    if name == "to_iso8601":
        if args[0].dtype is None or args[0].dtype.kind != TypeKind.DATE:
            raise TypeError("to_iso8601 supports DATE inputs")
        return Call(VARCHAR, "date_format",
                    (args[0], Literal(VARCHAR, "%Y-%m-%d")))
    if name == "typeof" and args:
        t = args[0].dtype
        return Literal(VARCHAR, str(t).lower() if t is not None
                       else "unknown")
    return None


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
    rx = re.compile(_like_to_regex(pattern))
    return _bool_table(d, ("like", pattern),
                       lambda v: rx.match(v) is not None)


def _per_value(d, fn) -> np.ndarray:
    """``fn`` of every value of ``d``, as an object array."""
    vals = d.values.tolist()
    out = np.empty(len(vals), dtype=object)
    out[:] = [fn(v) for v in vals]
    return out


def _coded(out: np.ndarray):
    """(old code + 1 -> new code table, sorted result dictionary, valid
    table or None) of one string result per dictionary value, None for
    NULL: one ``np.unique``."""
    from velox_tpu_torch.vector.column import Dictionary

    ok = np.not_equal(out, None).astype(np.bool_)
    uniq, inv = np.unique(out[ok], return_inverse=True)
    table = np.full(len(out) + 1, -1, dtype=np.int32)
    table[1:][ok] = inv.reshape(-1)
    valid = None if ok.all() else np.concatenate([[False], ok])
    return table, Dictionary(uniq), valid


def _typed(out: np.ndarray, lane):
    """(old code + 1 -> value table, None, valid table or None) of one
    value per dictionary value, None for NULL."""
    ok = np.not_equal(out, None).astype(np.bool_)
    table = np.zeros(len(out) + 1, dtype=lane)
    table[1:][ok] = np.asarray(out[ok].tolist(), dtype=lane)
    valid = None if ok.all() else np.concatenate([[False], ok])
    return table, None, valid


def _string_transform(d, key: tuple, fn):
    """``_coded`` of a string function over ``d``, kept with ``d``."""
    return d.derived(key, lambda d: _coded(_per_value(d, fn)))


def _typed_transform(d, key: tuple, fn, lane):
    """``_typed`` of a function over ``d``, kept with ``d``."""
    return d.derived(key, lambda d: _typed(_per_value(d, fn), lane))


def _bool_table(d, key: tuple, fn) -> np.ndarray:
    """A match table over ``d`` for ``dict_lookup_bool``, kept with
    ``d``."""
    def make(d):
        table = np.zeros(len(d) + 1, dtype=np.bool_)
        table[1:] = _per_value(d, fn).astype(np.bool_)
        return table

    return d.derived(key, make)


def _dict_arg(name, args, dictionaries, pos: int = 0):
    """(codes expr, Dictionary, literal values of the other arguments) of
    a call on the string column at ``pos``."""
    src = _dict_source((args[pos],), dictionaries)
    if src is None or src[1] is None:
        raise TypeError(f"{name} requires a dictionary-encoded input")
    extras = []
    for j, a in enumerate(args):
        if j == pos:
            continue
        if not isinstance(a, Literal):
            raise TypeError(f"{name}: arguments other than the string "
                            "column must be literals")
        extras.append(a.value)
    return src[0], src[1], tuple(extras)


def _bind_substr(args, dictionaries) -> Expr:
    codes_expr, d, extras = _dict_arg("substr", args, dictionaries)
    start = int(extras[0])
    length = int(extras[1]) if len(extras) > 1 else None
    lo = start - 1 if start >= 1 else start       # SQL is 1-based
    made = _string_transform(
        d, ("substr", start, length),
        lambda s: s[lo:] if length is None else s[lo:lo + length])
    return DictTransform(VARCHAR, codes_expr, *made)


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


def _parse_string(s: str, dst: DataType):
    """A string cast to ``dst`` with the reference's parse rules
    (velox/expression/CastExpr.h with Presto's rules): surrounding blanks
    are ignored, and a value that does not parse, or does not fit an
    integer lane, is None (NULL)."""
    s2 = s.strip()
    try:
        if dst.kind == TypeKind.BOOLEAN:
            low = s2.lower()
            return 1 if low in ("true", "t", "1") else (
                0 if low in ("false", "f", "0") else None)
        if dst.kind == TypeKind.DATE:
            return (datetime.date.fromisoformat(s2) - _EPOCH).days
        if isinstance(dst, DecimalType):
            from decimal import Decimal

            v = int(Decimal(s2).scaleb(dst.scale))
        elif dst.is_floating:
            return float(s2)
        elif "." in s2 or "e" in s2.lower():
            v = int(float(s2))
        else:
            v = int(s2)
    except (ValueError, ArithmeticError):
        return None
    info = np.iinfo(dst.dtype)
    return v if info.min <= v <= info.max else None


def _bind_string_cast(cast: Cast, child: Expr, dictionaries) -> Expr:
    """CAST(varchar AS boolean/date/decimal/float/integer): every distinct
    dictionary value parsed once on the host into a table of the target
    lane, beside a validity table that makes an unparseable value NULL
    (the engine has no row-level errors, so CAST behaves as TRY_CAST)."""
    dst = cast.dtype
    src = _dict_source((child,), dictionaries)
    if src is None or src[1] is None:
        raise TypeError("a string cast requires a dictionary-encoded input")
    codes_expr, d = src
    made = _typed_transform(d, ("cast", str(dst)),
                            lambda v: _parse_string(v, dst),
                            np.dtype(dst.dtype))
    return DictTransform(dst, codes_expr, *made)


def _union_ranks(da, db):
    """Each dictionary's values as ranks in the sorted union of both
    (code + 1 -> rank, -1 for NULL), kept with ``da``."""
    def make(da):
        va, vb = da.values, db.values
        union = np.unique(np.concatenate([va, vb]))
        return tuple(
            np.concatenate([[-1], np.searchsorted(union, v)]).astype(
                np.int32) for v in (va, vb))

    return da.derived(("union_ranks", db), make)


def _bind_string_cmp_pair(name, sa, sb) -> Expr:
    """A compare of two dictionary-encoded string columns. Codes of two
    dictionaries cannot be compared: both code spaces map onto ranks in
    the sorted union of their values (order-preserving, so range compares
    work too), and the ranks compare. A NULL on either side ranks -1, and
    the validity conjunction makes the compare NULL there."""
    (ca, da), (cb, db) = sa, sb
    ta, tb = _union_ranks(da, db)
    ra = DictTransform(INTEGER, ca, ta, None)
    rb = DictTransform(INTEGER, cb, tb, None)
    valid = Call(BOOLEAN, "and", (
        Call(BOOLEAN, "gte", (ra, Literal(INTEGER, 0))),
        Call(BOOLEAN, "gte", (rb, Literal(INTEGER, 0)))))
    return Call(BOOLEAN, "and", (valid, Call(BOOLEAN, name, (ra, rb))))


#: one-argument string functions, run once per dictionary value
_STRING_HOST_FNS = {
    "upper": lambda s: s.upper(),
    "lower": lambda s: s.lower(),
    "trim": lambda s: s.strip(),
    "ltrim": lambda s: s.lstrip(),
    "rtrim": lambda s: s.rstrip(),
    "reverse": lambda s: s[::-1],
}


def _bind_string_fn(name, args, dictionaries) -> Expr:
    """``length``, ``concat`` of one string column with literals before
    and after it, and the functions of ``_STRING_HOST_FNS``."""
    if name == "concat":
        cols = [j for j, a in enumerate(args)
                if not (isinstance(a, Literal) and isinstance(a.value, str))]
        if len(cols) != 1:
            raise TypeError("concat takes one string column and string "
                            "literals")
        pre = "".join(a.value for a in args[:cols[0]])
        post = "".join(a.value for a in args[cols[0] + 1:])
        codes_expr, d, _ = _dict_arg(name, args[cols[0]:cols[0] + 1],
                                     dictionaries)
        made = _string_transform(d, ("concat", pre, post),
                                 lambda s: f"{pre}{s}{post}")
        return DictTransform(VARCHAR, codes_expr, *made)
    codes_expr, d, _ = _dict_arg(name, args, dictionaries)
    if name == "length":
        # code points, not bytes
        return DictTransform(BIGINT, codes_expr, *_typed_transform(
            d, ("length",), len, np.int64))
    made = _string_transform(d, (name,), _STRING_HOST_FNS[name])
    return DictTransform(VARCHAR, codes_expr, *made)


def _split_part(s, delim, idx):
    parts = s.split(delim)
    return parts[idx - 1] if 1 <= idx <= len(parts) else None


def _pad(s: str, n: int, p: str, left: bool) -> str:
    if len(s) >= n:
        return s[:n]
    if not p:
        return s
    fill = (p * n)[:n - len(s)]
    return fill + s if left else s + fill


#: string functions with literal arguments after the string
#: (velox/functions/prestosql/StringFunctions.h), run once per dictionary
#: value; the two-argument trims are ``trim2``, ``ltrim2`` and ``rtrim2``
_STRING_MULTI_FNS = {
    "replace": lambda s, a, b="": s.replace(a, b),
    "trim2": lambda s, chars: s.strip(chars),
    "ltrim2": lambda s, chars: s.lstrip(chars),
    "rtrim2": lambda s, chars: s.rstrip(chars),
    "position": lambda s, sub: s.find(sub) + 1,
    "lpad": lambda s, n, p: _pad(s, n, p, True),
    "rpad": lambda s, n, p: _pad(s, n, p, False),
    "split_part": _split_part,
    "strpos": lambda s, sub: s.find(sub) + 1,
    "starts_with": lambda s, pre: s.startswith(pre),
    "ends_with": lambda s, suf: s.endswith(suf),
}


def _bind_string_multi(name, args, dictionaries) -> Expr:
    codes_expr, d, extras = _dict_arg(name, args, dictionaries)
    fn = _STRING_MULTI_FNS[name]
    key = (name,) + tuple(map(repr, extras))
    if name in ("strpos", "position"):
        return DictTransform(BIGINT, codes_expr, *_typed_transform(
            d, key, lambda s: fn(s, *extras), np.int64))
    if name in ("starts_with", "ends_with"):
        return Call(BOOLEAN, "dict_lookup_bool", (codes_expr, Literal(
            BOOLEAN, _bool_table(d, key, lambda s: fn(s, *extras)))))
    made = _string_transform(d, key, lambda s: fn(s, *extras))
    return DictTransform(VARCHAR, codes_expr, *made)


def _make_dict_value_fns():
    """name -> (result type, host function) of the value-function family
    (regex, datetime parse, JSON, URL, hashes and codecs, IP and the
    string additions: velox/functions/lib/Re2Functions.h,
    DateTimeFormatter/, prestosql/json/, URLFunctions.h,
    BinaryFunctions.h, StringFunctions.h), each run once per distinct
    dictionary value, the digest and sketch readers among them (one call
    per distinct blob: ``functions/digest.py``, ``functions/sketch.py``)."""
    from velox_tpu_torch.functions import hostfns as H
    from velox_tpu_torch.functions import sketch as SK

    return {
        "regexp_like": (BOOLEAN, H.regexp_like),
        "regexp_extract": (VARCHAR, H.regexp_extract),
        "regexp_replace": (VARCHAR, H.regexp_replace),
        "regexp_count": (BIGINT, H.regexp_count),
        "regexp_position": (BIGINT, H.regexp_position),
        "parse_datetime": (TIMESTAMP, H.parse_datetime_micros),
        "from_iso8601_date": (DATE, H.from_iso8601_date_days),
        "from_iso8601_timestamp": (
            TIMESTAMP, H.from_iso8601_timestamp_micros),
        "json_extract_scalar": (VARCHAR, H.json_extract_scalar),
        "json_extract": (VARCHAR, H.json_extract),
        "json_array_length": (BIGINT, H.json_array_length),
        "json_size": (BIGINT, H.json_size),
        "is_json_scalar": (BOOLEAN, H.is_json_scalar),
        "url_extract_host": (VARCHAR, H.url_extract_host),
        "url_extract_protocol": (VARCHAR, H.url_extract_protocol),
        "url_extract_path": (VARCHAR, H.url_extract_path),
        "url_extract_query": (VARCHAR, H.url_extract_query),
        "url_extract_fragment": (VARCHAR, H.url_extract_fragment),
        "url_extract_port": (BIGINT, H.url_extract_port),
        "url_extract_parameter": (VARCHAR, H.url_extract_parameter),
        "levenshtein_distance": (BIGINT, H.levenshtein_distance),
        "hamming_distance": (BIGINT, H.hamming_distance),
        "md5": (VARCHAR, H.md5_hex),
        "sha256": (VARCHAR, H.sha256_hex),
        "crc32": (BIGINT, H.crc32_int),
        "codepoint": (BIGINT, H.codepoint_int),
        "normalize": (VARCHAR, H.normalize_nfc),
        "word_stem": (VARCHAR, H.word_stem_en),
        "octet_length": (BIGINT, H.octet_length),
        "ip_prefix": (VARCHAR, H.ip_prefix),
        "ip_subnet_min": (VARCHAR, H.ip_subnet_min),
        "ip_subnet_max": (VARCHAR, H.ip_subnet_max),
        "is_subnet_of": (BOOLEAN, H.is_subnet_of),
        "is_private_ip": (BOOLEAN, H.is_private_ip),
        "sha1": (VARCHAR, H.sha1_hex),
        "sha512": (VARCHAR, H.sha512_hex),
        "xxhash64": (VARCHAR, H.xxhash64_hex),
        "hmac_sha1": (VARCHAR, H.hmac_sha1),
        "hmac_sha256": (VARCHAR, H.hmac_sha256),
        "hmac_sha512": (VARCHAR, H.hmac_sha512),
        "hmac_md5": (VARCHAR, H.hmac_md5),
        "to_hex": (VARCHAR, H.to_hex),
        "from_hex": (VARCHAR, H.from_hex),
        "to_base64": (VARCHAR, H.to_base64),
        "from_base64": (VARCHAR, H.from_base64),
        "to_base64url": (VARCHAR, H.to_base64url),
        "from_base64url": (VARCHAR, H.from_base64url),
        "to_base32": (VARCHAR, H.to_base32),
        "from_base32": (VARCHAR, H.from_base32),
        "from_utf8": (VARCHAR, H.from_utf8),
        "to_utf8": (VARCHAR, H.to_utf8),
        "from_base": (BIGINT, H.from_base),
        "soundex": (VARCHAR, H.soundex),
        "translate": (VARCHAR, H.translate3),
        "luhn_check": (BOOLEAN, H.luhn_check),
        "url_encode": (VARCHAR, H.url_encode),
        "url_decode": (VARCHAR, H.url_decode),
        "json_parse": (VARCHAR, H.json_parse),
        "json_format": (VARCHAR, H.json_format),
        "json_array_contains": (BOOLEAN, H.json_array_contains),
        "json_array_get": (VARCHAR, H.json_array_get),
        "murmur3_x64_128": (VARCHAR, H.murmur3_x64_128_hex),
        "bit_length": (BIGINT, H.bit_length_int),
        "strrpos": (BIGINT, H.strrpos),
        "replace_first": (VARCHAR, H.replace_first3),
        "longest_common_prefix": (VARCHAR, H.longest_common_prefix2),
        "jarowinkler_similarity": (DOUBLE, H.jarowinkler_similarity2),
        "trail": (VARCHAR, H.trail_n),
        "key_sampling_percent": (DOUBLE, H.key_sampling_percent),
        # intervals are BIGINT millisecond lanes (velox IntervalDayTime)
        "date_parse": (TIMESTAMP, H.date_parse_micros),
        "parse_duration": (BIGINT, H.parse_duration_ms),
        "to_milliseconds": (BIGINT, lambda v: v),
        "parse_presto_data_size": (BIGINT, H.parse_presto_data_size_int),
        "fnv1_32": (BIGINT, H.fnv1_32),
        "fnv1_64": (BIGINT, H.fnv1_64),
        "fnv1a_32": (BIGINT, H.fnv1a_32),
        "fnv1a_64": (BIGINT, H.fnv1a_64),
        "from_big_endian_32": (BIGINT, H.from_big_endian_32),
        "from_big_endian_64": (BIGINT, H.from_big_endian_64),
        "from_ieee754_32": (DOUBLE, H.from_ieee754_32),
        "from_ieee754_64": (DOUBLE, H.from_ieee754_64),
        "xxhash128": (VARCHAR, H.xxhash128_hex),
        "spooky_hash_v2_32": (VARCHAR, H.spooky_hash_v2_32),
        "spooky_hash_v2_64": (VARCHAR, H.spooky_hash_v2_64),
        "value_at_quantile": (DOUBLE, H.digest_value_at_quantile),
        "quantile_at_value": (DOUBLE, H.digest_quantile_at_value),
        # sketch blob readers (HyperLogLogFunctions.h, SetDigestFunctions,
        # KHyperLogLog, TDigestFunctions.h)
        "sketch_cardinality": (BIGINT, SK.sketch_cardinality),
        "scale_tdigest": (VARCHAR, _scale_tdigest_host),
        "trimmed_mean": (DOUBLE, _trimmed_mean_host),
        "hash_counts": (VARCHAR, SK.hash_counts),
        "uniqueness_distribution": (VARCHAR, SK.uniqueness_distribution),
        "reidentification_potential": (DOUBLE,
                                       SK.reidentification_potential),
    }


def _parse_each(d) -> dict:
    """``parse_digest`` of every value of a dictionary (the error, where a
    value is no digest)."""
    from velox_tpu_torch.functions.digest import parse_digest

    out = {}
    for v in d.values.tolist():
        try:
            out[v] = parse_digest(v)
        except Exception as e:      # raised again by the reader that reads it
            out[v] = e
    return out


def _make_digest_readers():
    """name -> reader of a parsed digest (``functions/digest.py``), which
    the binder calls with the parse it keeps with the dictionary."""
    from velox_tpu_torch.functions import digest as D

    return {
        "value_at_quantile": lambda p, v, q: D.value_at_quantile_parsed(p, q),
        "quantile_at_value": lambda p, v, x: D.quantile_at_value_parsed(
            p, x),
        "trimmed_mean": lambda p, v, lo, hi: D.trimmed_mean_parsed(
            p, float(lo), float(hi)),
        "scale_tdigest": lambda p, v, f: D.scale_tdigest_parsed(
            p, v.split("|", 1)[0], float(f)),
    }


_DIGEST_READERS = _make_digest_readers()


def _scale_tdigest_host(blob, factor):
    from velox_tpu_torch.functions.digest import scale_tdigest_blob

    return scale_tdigest_blob(blob, float(factor))


def _trimmed_mean_host(blob, lo, hi):
    from velox_tpu_torch.functions.digest import trimmed_mean_blob

    return trimmed_mean_blob(blob, float(lo), float(hi))


_DICT_VALUE_FNS = _make_dict_value_fns()


def _make_pair_host_fns():
    """name -> (result type, host function) of the functions of TWO
    dictionary columns (the sketch set operations of
    ``functions/sketch.py``), evaluated once per distinct pair of values;
    the device sees one combined-code gather."""
    from velox_tpu_torch.functions import sketch as SK

    return {
        "intersection_cardinality": (BIGINT, SK.intersection_cardinality),
        "jaccard_index": (DOUBLE, SK.jaccard_index),
    }


_PAIR_HOST_FNS = _make_pair_host_fns()

def _bind_pair_host(name, args, dictionaries) -> Expr:
    """A function of two dictionary columns (or literals): a
    ``PairTransform`` over their codes and values."""
    dst, fn = _PAIR_HOST_FNS[name]

    def source(a):
        if isinstance(a, Literal):
            if a.value is None:
                return Literal(INTEGER, -1), ()
            return Literal(INTEGER, 0), (str(a.value),)
        s = _dict_source((a,), dictionaries)
        if s is None or s[1] is None:
            raise TypeError(
                f"{name} requires dictionary-encoded (or literal) inputs")
        return s[0], tuple(str(v) for v in s[1].values)

    ca, va = source(args[0])
    cb, vb = source(args[1])
    return PairTransform(dst, ca, cb, va, vb, fn, {})


def _bind_dict_value(name, args, dictionaries) -> Expr:
    """A value function over one dictionary column, the other arguments
    literals (the column need not come first: ``is_subnet_of(prefix,
    ip)``): a typed table gather with a validity table for the values the
    function maps to NULL. An all-literal call folds to a constant."""
    from velox_tpu_torch.vector.column import Dictionary

    dst, fn = _DICT_VALUE_FNS[name]
    if all(isinstance(a, Literal) for a in args):
        try:
            v = fn(*[a.value for a in args])
        except Exception:
            v = None
        if not dst.is_string:
            return Literal(dst, v)
        nd = Dictionary([] if v is None else [str(v)])
        table = np.asarray([-1] if v is None else [-1, 0], np.int32)
        return DictTransform(dst, Literal(INTEGER, -1 if v is None else 0),
                             table, nd)
    pos = next(j for j, a in enumerate(args) if not isinstance(a, Literal))
    codes_expr, d, extras = _dict_arg(name, args, dictionaries, pos)

    def call(v):
        return fn(*extras[:pos], v, *extras[pos:])

    if name == "sketch_cardinality":
        # every HyperLogLog blob of the dictionary estimated in one pass
        from velox_tpu_torch.functions.sketch import sketch_cardinalities

        def batch(d):
            out = np.empty(len(d), dtype=object)
            out[:] = sketch_cardinalities(d.values.tolist())
            return _typed(out, np.dtype(dst.dtype))

        return DictTransform(dst, codes_expr,
                             *d.derived((name,), batch))
    if name in _DIGEST_READERS and pos == 0:
        # each blob parsed once for every digest reader of the dictionary
        parsed = d.derived(("parse_digest",), _parse_each)
        reader = _DIGEST_READERS[name]

        def call(v):  # noqa: F811
            p = parsed[v]
            if isinstance(p, Exception):
                raise p
            return reader(p, v, *extras)

    key = (name, pos) + tuple(map(repr, extras))
    made = (_string_transform(d, key, call) if dst.is_string
            else _typed_transform(d, key, call, np.dtype(dst.dtype)))
    return DictTransform(dst, codes_expr, *made)


#: the widest integer range a value-formatting table enumerates; a DATE
#: column spans far less (a century is about 36.5k days)
_MAX_FORMAT_SPAN = 1 << 17


def _range_codes(name, arg0, ranges):
    """(lane value - min, min, span) of a column whose stats bound it."""
    if not isinstance(arg0, FieldRef) or arg0.name not in ranges:
        raise NotImplementedError(
            f"{name} needs column min/max stats to enumerate the value "
            "range (table-global stats attach at ingest)")
    lo, hi = (int(x) for x in ranges[arg0.name])
    span = hi - lo + 1
    if span > _MAX_FORMAT_SPAN:
        raise NotImplementedError(f"{name}: range too wide ({span})")
    codes = Call(BIGINT, "minus", (Cast(BIGINT, arg0, False),
                                   Literal(BIGINT, lo)))
    return codes, lo, span


@functools.lru_cache(maxsize=256)
def _enumerated(fn, lo: int, span: int, extras: tuple):
    """``_coded`` of ``fn(v, *extras)`` for every v of [lo, lo + span),
    kept for the process as a dictionary keeps its transforms."""
    out = np.empty(span, dtype=object)
    out[:] = [fn(lo + i, *extras) for i in range(span)]
    return _coded(out)


def _bind_range_format(name, args, ranges) -> Expr:
    """date_format/format_datetime over a DATE lane: every day of the
    column's (min, max) stats formatted once on the host, then a table
    gather (the kArray trick applied to formatting). TIMESTAMP lanes
    (microseconds, an unbounded span) are out of the table's reach."""
    from velox_tpu_torch.functions import hostfns as H

    if not isinstance(args[1], Literal):
        raise TypeError(f"{name} format must be a literal")
    if args[0].dtype.kind != TypeKind.DATE:
        raise NotImplementedError(
            f"{name} supports DATE lanes (timestamp spans are not "
            "enumerable); date_trunc first")
    codes, lo, span = _range_codes(name, args[0], ranges)
    fday = (H.date_format_days if name == "date_format"
            else H.format_datetime_days)
    return DictTransform(VARCHAR, codes,
                         *_enumerated(fday, lo, span, (args[1].value,)))


def _to_base(v: int, radix: int):
    if not 2 <= radix <= 36:
        return None
    digs = "0123456789abcdefghijklmnopqrstuvwxyz"
    a, out = abs(int(v)), []
    while True:
        out.append(digs[a % radix])
        a //= radix
        if a == 0:
            break
    return ("-" if v < 0 else "") + "".join(reversed(out))


def _day_text(fmt: str):
    return lambda days: (_EPOCH + datetime.timedelta(days=int(days))
                         ).strftime(fmt)


def _human_readable_seconds(secs) -> str:
    """Presto's human_readable_seconds (DateTimeFunctions.h)."""
    secs = int(round(secs))
    parts = []
    for unit, span in (("week", 604800), ("day", 86400), ("hour", 3600),
                       ("minute", 60), ("second", 1)):
        q, secs = divmod(secs, span)
        if q:
            parts.append(f"{q} {unit}{'s' if q != 1 else ''}")
    return ", ".join(parts) if parts else "0 seconds"


def _make_int_value_fns():
    """Integer -> string functions over a column whose stats bound it:
    every value of the (min, max) span once on the host, then a table
    gather."""
    from velox_tpu_torch.functions import hostfns as H

    return {
        "chr": lambda v: chr(v) if 0 <= v < 0x110000 else None,
        "to_base": _to_base,
        "to_big_endian_32": H.to_big_endian_32,
        "to_big_endian_64": H.to_big_endian_64,
        "day_name": _day_text("%A"),
        "month_name": _day_text("%B"),
        "human_readable_seconds": _human_readable_seconds,
    }


_INT_VALUE_FNS = _make_int_value_fns()


def _bind_int_value(name, args, ranges) -> Expr:
    from velox_tpu_torch.vector.column import Dictionary

    fn = _INT_VALUE_FNS[name]
    if all(isinstance(a, Literal) for a in args):
        v = fn(*[int(a.value) for a in args])
        nd = Dictionary([] if v is None else [str(v)])
        table = np.asarray([-1] if v is None else [-1, 0], np.int32)
        return DictTransform(VARCHAR, Literal(INTEGER, -1 if v is None
                                              else 0), table, nd)
    codes, lo, span = _range_codes(name, args[0], ranges)
    extras = tuple(int(a.value) for a in args[1:])
    return DictTransform(VARCHAR, codes, *_enumerated(fn, lo, span, extras))


def bind_strings(expr: Expr, dictionaries: Dict[str, "Dictionary"],
                 ranges: Optional[Dict[str, tuple]] = None) -> Expr:
    """Rewrite string predicates and functions over dictionary columns
    into code programs.

    ``eq``/``neq`` against a literal compare codes; range compares become
    rank compares (dictionaries are sorted, so codes are ranks); two
    string columns compare ranks in the union of their dictionaries;
    string functions and casts become ``DictTransform`` gathers.
    """
    if (isinstance(expr, DictTransform) and isinstance(expr.codes, Call)
            and expr.codes.name.startswith(("__array_", "__map_"))):
        # a string element read back by bind_array_funcs: its lambda body
        # still holds string compares to bind
        inner = expr.codes
        return dataclasses.replace(expr, codes=Call(
            inner.dtype, inner.name, tuple(
                bind_strings(a, dictionaries, ranges) for a in inner.args)))
    if isinstance(expr, (FieldRef, Literal, DictTransform, PairTransform)):
        return expr
    if isinstance(expr, Cast):
        child = bind_strings(expr.expr, dictionaries, ranges)
        if (child.dtype is not None and child.dtype.is_string
                and not expr.dtype.is_string):
            return _bind_string_cast(expr, child, dictionaries)
        return Cast(expr.dtype, child, expr.null_on_failure)
    if isinstance(expr, TryExpr):
        return TryExpr(expr.dtype,
                       bind_strings(expr.expr, dictionaries, ranges))
    if not isinstance(expr, Call):
        return expr

    args = tuple(bind_strings(a, dictionaries, ranges) for a in expr.args)
    name = expr.name
    bound = _bind_string_call(name, args, dictionaries, ranges or {})
    if bound is not None:
        return bound
    if (name == "if" and len(args) == 3 and expr.dtype is not None
            and expr.dtype.is_string):
        bound = _bind_string_if(args, dictionaries, expr.dtype)
        if bound is not None:
            return bound
    if name in _COMPARE and len(args) == 2 and _other_literal(args) is None:
        sa = _dict_source((args[0],), dictionaries)
        sb = _dict_source((args[1],), dictionaries)
        if (sa is not None and sb is not None and sa[1] is not None
                and sb[1] is not None):
            return _bind_string_cmp_pair(name, sa, sb)
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


def _bind_string_call(name, args, dictionaries, ranges) -> Optional[Expr]:
    """A string function's dictionary transform, or None for any other
    call."""
    if name == "substr":
        return _bind_substr(args, dictionaries)
    if name in ("trim", "ltrim", "rtrim") and len(args) == 2:
        # the trim(string, chars) overloads (StringFunctions.h)
        return _bind_string_multi(name + "2", args, dictionaries)
    if name in _STRING_HOST_FNS or name in ("length", "concat"):
        return _bind_string_fn(name, args, dictionaries)
    if name in _STRING_MULTI_FNS:
        return _bind_string_multi(name, args, dictionaries)
    if name in _DICT_VALUE_FNS:
        return _bind_dict_value(name, args, dictionaries)
    if name in _PAIR_HOST_FNS:
        return _bind_pair_host(name, args, dictionaries)
    if name in ("date_format", "format_datetime"):
        return _bind_range_format(name, args, ranges)
    if name in _INT_VALUE_FNS:
        return _bind_int_value(name, args, ranges)
    return None


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


def _const_string(e: Expr) -> Expr:
    """A bare string literal in a projection ('web' AS channel), a
    constant vector in velox: here a one-value dictionary, codes all 0."""
    if (isinstance(e, Literal) and e.dtype is not None
            and e.dtype.is_string and isinstance(e.value, str)):
        from velox_tpu_torch.vector.column import Dictionary

        return DictTransform(e.dtype, Literal(INTEGER, 0),
                             np.asarray([-1, 0], np.int32),
                             Dictionary([e.value]))
    return e


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
        resolved = [bind_array_funcs(resolve_types(e, schema),
                                     self.dictionaries) for e in exprs]
        bound = [_const_string(bind_strings(e, self.dictionaries,
                                            self.ranges))
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
        elif isinstance(expr.value, (DeviceTable, ZoneTable)):
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

    def _eval_pairs(self, expr: PairTransform, arrays, memo, device
                    ) -> ValuePair:
        """``fn`` of each row's (value_a, value_b): once per distinct code
        pair of the batch (and of the expression's earlier batches); a
        NULL code on either side, or a None result, is NULL."""
        from velox_tpu_torch.utils import syncs

        ca, va = self._eval(expr.codes_a, arrays, memo, device)
        cb, vb = self._eval(expr.codes_b, arrays, memo, device)
        ca = ca.to(torch.int64).expand(cb.shape) if ca.dim() == 0 else \
            ca.to(torch.int64)
        cb = cb.to(torch.int64).expand(ca.shape) if cb.dim() == 0 else \
            cb.to(torch.int64)
        nb = len(expr.values_b) + 1
        comb = (ca.clamp(min=-1) + 1) * nb + (cb.clamp(min=-1) + 1)
        uniq, inv = torch.unique(comb, return_inverse=True)
        lane = (np.dtype(np.int64) if expr.dtype.is_integer
                else np.dtype(expr.dtype.dtype))
        table = np.zeros(len(uniq), dtype=lane)
        ok = np.zeros(len(uniq), dtype=np.bool_)
        for k, u in enumerate(syncs.to_numpy(uniq).tolist()):
            i, j = u // nb - 1, u % nb - 1
            if i < 0 or j < 0:
                continue
            if (i, j) not in expr.memo:
                expr.memo[(i, j)] = expr.fn(expr.values_a[i],
                                            expr.values_b[j])
            v = expr.memo[(i, j)]
            if v is not None:
                table[k], ok[k] = v, True
        out = torch.from_numpy(table).to(device).index_select(0, inv)
        valid = torch.from_numpy(ok).to(device).index_select(0, inv)
        for v in (va, vb):
            if v is not None:
                valid = valid & v
        return out.to(torch_dtype(expr.dtype.dtype)), valid

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
            out = self._gather_codes(expr.table, codes, device)
            if expr.valid_table is not None:
                ok = self._gather_codes(expr.valid_table, codes, device)
                valid = ok if valid is None else torch.logical_and(valid, ok)
            return out, valid
        if isinstance(expr, PairTransform):
            return self._eval_pairs(expr, arrays, memo, device)
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
