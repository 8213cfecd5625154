"""Typed expression IR.

Analog of the ITypedExpr tree (velox/core/Expressions.h:61-566): FieldAccess,
Constant, Call, Cast, Lambda + the special forms velox keeps in
velox/expression (ConjunctExpr, SwitchExpr, CoalesceExpr, TryExpr). Nodes are
immutable and hashable so common-subexpression elimination (the analog of
Expr::computeDistinctFields / shared-subexpr caching, velox/expression/
Expr.cpp:934) is a dict over node identity.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Any, Optional, Sequence, Tuple

import numpy as np

from velox_tpu_torch.types import DataType, BOOLEAN
from velox_tpu_torch.types.types import TypeKind


@dataclass(frozen=True)
class Expr:
    """Base expression node. ``dtype`` is the resolved result type (None
    until type resolution binds it against an input schema)."""

    dtype: Optional[DataType]

    @property
    def children(self) -> Tuple["Expr", ...]:
        return ()

    def __str__(self) -> str:  # pragma: no cover
        return repr(self)


@dataclass(frozen=True)
class FieldRef(Expr):
    name: str = ""

    def __str__(self) -> str:
        return self.name


@dataclass(frozen=True, eq=False)
class Literal(Expr):
    value: Any = None
    #: the numeral as written, for a DOUBLE literal the parser read: a
    #: long-decimal compare takes its digits from here, not the float
    text: Optional[str] = None

    def __str__(self) -> str:
        return repr(self.value)

    # ndarray payloads (bound lookup tables) aren't hashable/eq-comparable;
    # compare those by object identity so CSE memo dicts still work.
    def __eq__(self, other):
        if not isinstance(other, Literal):
            return NotImplemented
        if isinstance(self.value, np.ndarray) or isinstance(
                getattr(other, "value", None), np.ndarray):
            return self is other
        return self.dtype == other.dtype and self.value == other.value

    def __hash__(self):
        if isinstance(self.value, np.ndarray):
            return hash((self.dtype, id(self.value)))
        return hash((self.dtype, self.value))

    def __repr__(self):
        # ndarray payloads repr by identity: the default repr truncates
        # ('...'), which would collide cache keys built from expr reprs
        if isinstance(self.value, np.ndarray):
            return (f"Literal(<array#{id(self.value)} "
                    f"n={self.value.shape}>)")
        return f"Literal({self.dtype!r}, {self.value!r})"


@dataclass(frozen=True)
class Call(Expr):
    """Function call, including special forms identified by name:
    and/or/not/if/switch/coalesce/is_null — mirroring Velox's special-form
    registry (velox/expression/SpecialFormRegistry.h)."""

    name: str = ""
    args: Tuple[Expr, ...] = ()

    @property
    def children(self) -> Tuple[Expr, ...]:
        return self.args

    def __str__(self) -> str:
        return f"{self.name}({', '.join(map(str, self.args))})"


@dataclass(frozen=True)
class Cast(Expr):
    """CAST(expr AS dtype); null_on_failure=True is TRY_CAST."""

    expr: Expr = None  # type: ignore[assignment]
    null_on_failure: bool = False

    @property
    def children(self) -> Tuple[Expr, ...]:
        return (self.expr,)

    def __str__(self) -> str:
        return f"cast({self.expr} as {self.dtype})"


@dataclass(frozen=True)
class TryExpr(Expr):
    """TRY(expr): row-level errors become nulls (velox/expression/TryExpr.h).
    On TPU there are no exceptions; functions that can fail produce an error
    lane that TRY converts into invalidity."""

    expr: Expr = None  # type: ignore[assignment]

    @property
    def children(self) -> Tuple[Expr, ...]:
        return (self.expr,)


@dataclass(frozen=True)
class Lambda(Expr):
    """Lambda for array/map higher-order functions (velox LambdaExpr.h)."""

    params: Tuple[str, ...] = ()
    body: Expr = None  # type: ignore[assignment]

    @property
    def children(self) -> Tuple[Expr, ...]:
        return (self.body,)


# ---------------------------------------------------------------- builders

def field(name: str, dtype: Optional[DataType] = None) -> FieldRef:
    return FieldRef(dtype, name)


def lit(value: Any, dtype: Optional[DataType] = None) -> Literal:
    return Literal(dtype, value)


def call(name: str, *args: Expr, dtype: Optional[DataType] = None) -> Call:
    return Call(dtype, name, tuple(args))


def cast(expr: Expr, dtype: DataType, null_on_failure: bool = False) -> Cast:
    return Cast(dtype, expr, null_on_failure)


def try_(expr: Expr) -> TryExpr:
    return TryExpr(expr.dtype, expr)


def and_(*args: Expr) -> Call:
    return Call(BOOLEAN, "and", tuple(args))


def or_(*args: Expr) -> Call:
    return Call(BOOLEAN, "or", tuple(args))


def not_(arg: Expr) -> Call:
    return Call(BOOLEAN, "not", (arg,))


def if_(cond: Expr, then: Expr, else_: Optional[Expr] = None) -> Call:
    args = (cond, then) if else_ is None else (cond, then, else_)
    return Call(then.dtype, "if", args)


def switch(*args: Expr) -> Call:
    """switch(c1, v1, c2, v2, ..., [else]) — SQL CASE."""
    return Call(args[1].dtype, "switch", tuple(args))


def coalesce(*args: Expr) -> Call:
    return Call(args[0].dtype, "coalesce", tuple(args))


def is_null(arg: Expr) -> Call:
    return Call(BOOLEAN, "is_null", (arg,))


def eq(a: Expr, b: Expr) -> Call:
    return Call(BOOLEAN, "eq", (a, b))


def neq(a: Expr, b: Expr) -> Call:
    return Call(BOOLEAN, "neq", (a, b))


def lt(a: Expr, b: Expr) -> Call:
    return Call(BOOLEAN, "lt", (a, b))


def lte(a: Expr, b: Expr) -> Call:
    return Call(BOOLEAN, "lte", (a, b))


def gt(a: Expr, b: Expr) -> Call:
    return Call(BOOLEAN, "gt", (a, b))


def gte(a: Expr, b: Expr) -> Call:
    return Call(BOOLEAN, "gte", (a, b))


def plus(a: Expr, b: Expr) -> Call:
    return Call(None, "plus", (a, b))


def minus(a: Expr, b: Expr) -> Call:
    return Call(None, "minus", (a, b))


def multiply(a: Expr, b: Expr) -> Call:
    return Call(None, "multiply", (a, b))


def divide(a: Expr, b: Expr) -> Call:
    return Call(None, "divide", (a, b))
