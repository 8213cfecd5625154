"""Small SQL expression parser -> IR.

Analog of velox/parse/ExpressionsParser.h (which wraps the DuckDB SQL
parser): used by PlanBuilder and tests so plans read like the reference's
fluent test plans (velox/exec/tests/utils/PlanBuilder.h:92). Supports the
subset TPC-H + tests need: literals, identifiers, arithmetic, comparisons,
AND/OR/NOT, BETWEEN, IN, LIKE, IS [NOT] NULL, CASE WHEN, CAST, TRY,
function calls, DATE 'yyyy-mm-dd' / INTERVAL 'n' DAY literals.
"""

from __future__ import annotations

import datetime
import re
from typing import List, Optional, Tuple

from velox_tpu_torch.types import (
    BIGINT, BOOLEAN, DATE, DOUBLE, INTEGER, REAL, VARCHAR, DataType,
)
from velox_tpu_torch.types.types import (
    DECIMAL, INTERVAL_DAY_TIME, INTERVAL_YEAR_MONTH, TypeKind,
)
from velox_tpu_torch.expr.ir import (
    Call, Cast, Expr, FieldRef, Literal, TryExpr,
    and_, call, eq, gt, gte, if_, lit, lt, lte, neq, not_, or_, switch,
)

_TOKEN_RE = re.compile(r"""
    \s*(?:
      (?P<date>DATE\s*'(?P<datev>[^']*)')
    | (?P<interval>INTERVAL\s*'(?P<intv>[^']*)'\s*(?P<intunit>DAY|HOUR|MINUTE|SECOND|MONTH|YEAR)S?)
    | (?P<num>\d+\.\d+(?:[eE][+-]?\d+)?|\.\d+|\d+(?:[eE][+-]?\d+)?)
    | (?P<str>'(?:[^']|'')*')
    | (?P<name>[A-Za-z_][A-Za-z0-9_]*)
    | (?P<op><=|>=|<>|!=|->|=|<|>|\+|-|\*|/|%|\(|\)|\[|\]|,|\.)
    )""", re.VERBOSE | re.IGNORECASE)

_KEYWORDS = {
    "AND", "OR", "NOT", "BETWEEN", "IN", "LIKE", "IS", "NULL", "CASE",
    "WHEN", "THEN", "ELSE", "END", "CAST", "AS", "TRY", "TRUE", "FALSE",
    "DATE", "INTERVAL",
}

_TYPE_NAMES = {
    "BOOLEAN": BOOLEAN, "TINYINT": DataType(TypeKind.TINYINT),
    "SMALLINT": DataType(TypeKind.SMALLINT), "INTEGER": INTEGER,
    "INT": INTEGER, "BIGINT": BIGINT, "REAL": REAL, "DOUBLE": DOUBLE,
    "VARCHAR": VARCHAR, "DATE": DATE,
    "TIMESTAMP": DataType(TypeKind.TIMESTAMP),
}


class _Tokens:
    def __init__(self, text: str):
        self.toks: List[Tuple[str, str]] = []
        pos = 0
        while pos < len(text):
            m = _TOKEN_RE.match(text, pos)
            if not m or m.end() == pos:
                if text[pos:].strip() == "":
                    break
                raise SyntaxError(f"bad token at: {text[pos:pos+20]!r}")
            pos = m.end()
            if m.group("date"):
                self.toks.append(("DATE_LIT", m.group("datev")))
            elif m.group("interval"):
                self.toks.append(
                    ("INTERVAL_LIT",
                     f"{m.group('intv')}:{m.group('intunit').upper()}"))
            elif m.group("num"):
                self.toks.append(("NUM", m.group("num")))
            elif m.group("str"):
                s = m.group("str")[1:-1].replace("''", "'")
                self.toks.append(("STR", s))
            elif m.group("name"):
                n = m.group("name")
                if n.upper() in _KEYWORDS:
                    self.toks.append((n.upper(), n))
                else:
                    self.toks.append(("NAME", n))
            else:
                self.toks.append(("OP", m.group("op")))
        self.i = 0

    def peek(self) -> Tuple[str, str]:
        return self.toks[self.i] if self.i < len(self.toks) else ("EOF", "")

    def next(self) -> Tuple[str, str]:
        t = self.peek()
        self.i += 1
        return t

    def accept(self, kind: str, value: Optional[str] = None) -> bool:
        k, v = self.peek()
        if k == kind and (value is None or v == value):
            self.i += 1
            return True
        return False

    def expect(self, kind: str, value: Optional[str] = None):
        k, v = self.next()
        if k != kind or (value is not None and v != value):
            raise SyntaxError(f"expected {value or kind}, got {v!r}")
        return v


def parse_expr(text: str) -> Expr:
    toks = _Tokens(text)
    e = _parse_arg(toks)  # lambda-aware: x -> body / (a, b) -> body
    k, v = toks.peek()
    if k != "EOF":
        raise SyntaxError(f"trailing input at {v!r}")
    return e


def _parse_or(t: _Tokens) -> Expr:
    e = _parse_and(t)
    args = [e]
    while t.accept("OR"):
        args.append(_parse_and(t))
    return or_(*args) if len(args) > 1 else e


def _parse_and(t: _Tokens) -> Expr:
    e = _parse_not(t)
    args = [e]
    while t.accept("AND"):
        args.append(_parse_not(t))
    return and_(*args) if len(args) > 1 else e


def _parse_not(t: _Tokens) -> Expr:
    if t.accept("NOT"):
        return not_(_parse_not(t))
    return _parse_predicate(t)


def _parse_predicate(t: _Tokens) -> Expr:
    e = _parse_additive(t)
    negate = False
    if t.accept("NOT"):
        negate = True
    k, v = t.peek()
    out = None
    if k == "OP" and v in ("=", "<>", "!=", "<", "<=", ">", ">="):
        t.next()
        rhs = _parse_additive(t)
        ops = {"=": eq, "<>": neq, "!=": neq, "<": lt, "<=": lte,
               ">": gt, ">=": gte}
        out = ops[v](e, rhs)
    elif k == "BETWEEN":
        t.next()
        lo = _parse_additive(t)
        t.expect("AND")
        hi = _parse_additive(t)
        out = call("between", e, lo, hi)
    elif k == "IN":
        t.next()
        t.expect("OP", "(")
        items = [_parse_or(t)]
        while t.accept("OP", ","):
            items.append(_parse_or(t))
        t.expect("OP", ")")
        out = call("in", e, *items)
    elif k == "LIKE":
        t.next()
        pat = _parse_additive(t)
        out = call("like", e, pat)
    elif k == "IS":
        t.next()
        if t.accept("NOT"):
            t.expect("NULL")
            out = call("is_not_null", e)
        else:
            t.expect("NULL")
            out = call("is_null", e)
    if out is None:
        if negate:
            raise SyntaxError("dangling NOT")
        return e
    return not_(out) if negate else out


def _parse_additive(t: _Tokens) -> Expr:
    e = _parse_multiplicative(t)
    while True:
        k, v = t.peek()
        if k == "OP" and v in ("+", "-"):
            t.next()
            rhs = _parse_multiplicative(t)
            if v == "+" and _is_interval(rhs):
                e = call("plus", e, _interval_days(rhs))
            elif v == "-" and _is_interval(rhs):
                e = call("minus", e, _interval_days(rhs))
            else:
                e = call("plus" if v == "+" else "minus", e, rhs)
        else:
            return e


def _parse_multiplicative(t: _Tokens) -> Expr:
    e = _parse_unary(t)
    while True:
        k, v = t.peek()
        if k == "OP" and v in ("*", "/", "%"):
            t.next()
            rhs = _parse_unary(t)
            name = {"*": "multiply", "/": "divide", "%": "mod"}[v]
            e = call(name, e, rhs)
        else:
            return e


def _parse_unary(t: _Tokens) -> Expr:
    if t.accept("OP", "-"):
        return call("negate", _parse_unary(t))
    if t.accept("OP", "+"):
        return _parse_unary(t)
    e = _parse_primary(t)
    # postfix subscript: a[i] -> element_at (Presto SUBSCRIPT; array
    # access is 1-based, map access by key)
    while t.accept("OP", "["):
        idx = _parse_or(t)
        t.expect("OP", "]")
        e = call("element_at", e, idx)
    return e


_INTERVAL_MARK = "__interval_days__"


def _is_interval(e: Expr) -> bool:
    return (isinstance(e, Literal) and e.dtype is not None
            and e.dtype.kind in (TypeKind.INTERVAL_DAY_TIME,
                                 TypeKind.INTERVAL_YEAR_MONTH))


def _interval_days(e: Expr) -> Expr:
    """Whole-day day-time literals lower to plain day counts at parse
    time (keeps DATE +/- INTERVAL 'n' DAY a constant-foldable integer
    shift the scan-pushdown range analysis can see); anything else
    stays typed for the compiler's interval arithmetic."""
    if (e.dtype.kind == TypeKind.INTERVAL_DAY_TIME
            and e.value is not None and e.value % 86_400_000 == 0):
        return lit(e.value // 86_400_000, INTEGER)
    return e


def _parse_arg(t: _Tokens) -> Expr:
    """Function-call argument: a lambda ``x -> expr`` or an expression
    (velox parse: LambdaTypedExpr for higher-order functions)."""
    from velox_tpu_torch.expr.ir import Lambda

    k, v = t.peek()
    if k == "NAME" and t.i + 1 < len(t.toks) and \
            t.toks[t.i + 1] == ("OP", "->"):
        t.next()
        t.next()
        return Lambda(None, (v,), _parse_or(t))
    # multi-parameter form: (a, b[, c...]) -> expr (zip_with /
    # map_zip_with / reduce_agg combine lambdas)
    if k == "OP" and v == "(":
        j = t.i + 1
        params = []
        while (j + 1 < len(t.toks) and t.toks[j][0] == "NAME"
               and t.toks[j + 1] in (("OP", ","), ("OP", ")"))):
            params.append(t.toks[j][1])
            if t.toks[j + 1] == ("OP", ")"):
                j += 2
                break
            j += 2
        else:
            j = -1
        if (params and j > 0 and j < len(t.toks)
                and t.toks[j] == ("OP", "->")):
            t.i = j + 1
            return Lambda(None, tuple(params), _parse_or(t))
    return _parse_or(t)


def _parse_primary(t: _Tokens) -> Expr:
    k, v = t.next()
    if k == "NUM":
        if "." in v or "e" in v.lower():
            return lit(float(v), DOUBLE)
        return lit(int(v), BIGINT)
    if k == "STR":
        return lit(v, VARCHAR)
    if k == "TRUE":
        return lit(True, BOOLEAN)
    if k == "FALSE":
        return lit(False, BOOLEAN)
    if k == "NULL":
        return Literal(None, None)
    if k == "DATE_LIT":
        d = datetime.date.fromisoformat(v)
        days = (d - datetime.date(1970, 1, 1)).days
        return lit(days, DATE)
    if k == "INTERVAL_LIT":
        # typed interval literals (velox/type/Type.h IntervalDayTime /
        # IntervalYearMonth): day-time carries int64 milliseconds,
        # year-month int32 months
        n, unit = v.split(":")
        n = int(n)
        if unit in ("DAY", "HOUR", "MINUTE", "SECOND"):
            ms = n * {"DAY": 86_400_000, "HOUR": 3_600_000,
                      "MINUTE": 60_000, "SECOND": 1_000}[unit]
            return lit(ms, INTERVAL_DAY_TIME)
        return lit(n * (12 if unit == "YEAR" else 1),
                   INTERVAL_YEAR_MONTH)
    if k == "TRY":
        t.expect("OP", "(")
        inner = _parse_or(t)
        t.expect("OP", ")")
        return TryExpr(None, inner)
    if k == "CAST":
        t.expect("OP", "(")
        inner = _parse_or(t)
        t.expect("AS")
        tk, tv = t.next()
        dtype = _parse_type(t, tv)
        t.expect("OP", ")")
        return Cast(dtype, inner, False)
    if k == "CASE":
        conds = []
        while t.accept("WHEN"):
            c = _parse_or(t)
            t.expect("THEN")
            val = _parse_or(t)
            conds.extend([c, val])
        if t.accept("ELSE"):
            conds.append(_parse_or(t))
        t.expect("END")
        return switch(*conds)
    if k == "NAME":
        if v.upper() == "ARRAY" and t.accept("OP", "["):
            # ARRAY[e1, e2, ...] literal/constructor
            args = []
            if not t.accept("OP", "]"):
                args.append(_parse_or(t))
                while t.accept("OP", ","):
                    args.append(_parse_or(t))
                t.expect("OP", "]")
            return call("array_constructor", *args)
        if t.accept("OP", "("):
            args = []
            if not t.accept("OP", ")"):
                args.append(_parse_arg(t))
                while t.accept("OP", ","):
                    args.append(_parse_arg(t))
                t.expect("OP", ")")
            return call(_canon_fn(v), *args)
        # dotted subfield access: shredded ROW leaves are plain columns
        # named "s.f" (velox/type/Subfield.h paths as column names)
        name = v
        while t.accept("OP", "."):
            tk2, v2 = t.next()
            if tk2 != "NAME":
                raise SyntaxError(f"expected field name after '.', "
                                  f"got {v2!r}")
            name = f"{name}.{v2}"
        return FieldRef(None, name)
    if k == "OP" and v == "(":
        e = _parse_or(t)
        t.expect("OP", ")")
        return e
    raise SyntaxError(f"unexpected token {v!r}")


def _parse_type(t: _Tokens, name: str) -> DataType:
    up = name.upper()
    if up == "DECIMAL":
        t.expect("OP", "(")
        p = int(t.expect("NUM"))
        t.expect("OP", ",")
        s = int(t.expect("NUM"))
        t.expect("OP", ")")
        return DECIMAL(p, s)
    if up in _TYPE_NAMES:
        return _TYPE_NAMES[up]
    raise SyntaxError(f"unknown type {name}")


def _canon_fn(name: str) -> str:
    return name.lower()
