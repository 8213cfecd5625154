"""Logical types and their device (dtype) mapping.

Reference behavioral contract: velox/type/Type.h:74-96 (TypeKind), :528 (Type
tree with parameters and ROW field names). A copy of the JAX package's
``types/types.py``; differences from Velox:

* Every scalar kind carries a canonical ``numpy`` dtype (the torch dtype
  follows from it) so columns are always fixed-width device tensors.
* VARCHAR is *logically* a string but *physically* dictionary-encoded: int32
  codes on device + a host-side value table (see vector/column.py). There is
  no StringView analog.
* DECIMAL(p, s) with p <= 18 is a scaled int64 lane ("short decimal",
  velox/type/DecimalUtil.h behavioral analog). Money math stays in integer
  lanes end-to-end; conversion to double happens only at the result surface.
* TIMESTAMP is int64 microseconds since epoch (Velox stores s+ns,
  velox/type/Timestamp.h; micros keep one lane and cover TPC-H needs).
* DATE is int32 days since epoch (matches Velox DATE semantics).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np


class TypeKind(enum.Enum):
    # Scalar kinds (velox/type/Type.h:74-96)
    BOOLEAN = "BOOLEAN"
    TINYINT = "TINYINT"
    SMALLINT = "SMALLINT"
    INTEGER = "INTEGER"
    BIGINT = "BIGINT"
    REAL = "REAL"
    DOUBLE = "DOUBLE"
    VARCHAR = "VARCHAR"
    VARBINARY = "VARBINARY"
    TIMESTAMP = "TIMESTAMP"
    DATE = "DATE"          # Velox models DATE as a logical type over INTEGER
    DECIMAL = "DECIMAL"    # short decimal: scaled int64
    # interval types (velox/type/Type.h IntervalDayTime/IntervalYearMonth)
    INTERVAL_DAY_TIME = "INTERVAL_DAY_TIME"      # int64 milliseconds
    INTERVAL_YEAR_MONTH = "INTERVAL_YEAR_MONTH"  # int32 months
    # Complex kinds
    ARRAY = "ARRAY"
    MAP = "MAP"
    ROW = "ROW"
    UNKNOWN = "UNKNOWN"

    @property
    def is_scalar(self) -> bool:
        return self not in (TypeKind.ARRAY, TypeKind.MAP, TypeKind.ROW)


# Device dtype for each scalar kind. Booleans are stored as bool arrays
# (XLA packs them as i8 lanes); VARCHAR is the dictionary-code dtype.
_KIND_TO_DTYPE = {
    TypeKind.BOOLEAN: np.dtype(np.bool_),
    TypeKind.TINYINT: np.dtype(np.int8),
    TypeKind.SMALLINT: np.dtype(np.int16),
    TypeKind.INTEGER: np.dtype(np.int32),
    TypeKind.BIGINT: np.dtype(np.int64),
    TypeKind.REAL: np.dtype(np.float32),
    TypeKind.DOUBLE: np.dtype(np.float64),
    TypeKind.VARCHAR: np.dtype(np.int32),     # dictionary codes
    TypeKind.VARBINARY: np.dtype(np.int32),   # dictionary codes
    TypeKind.TIMESTAMP: np.dtype(np.int64),   # micros since epoch
    TypeKind.DATE: np.dtype(np.int32),        # days since epoch
    TypeKind.DECIMAL: np.dtype(np.int64),     # unscaled value
    TypeKind.INTERVAL_DAY_TIME: np.dtype(np.int64),    # milliseconds
    TypeKind.INTERVAL_YEAR_MONTH: np.dtype(np.int32),  # months
    TypeKind.UNKNOWN: np.dtype(np.int8),
}


@dataclass(frozen=True)
class DataType:
    """A logical type. Frozen and hashable so types can key registries."""

    kind: TypeKind

    @property
    def dtype(self) -> np.dtype:
        """Canonical device dtype for this type's value lane."""
        try:
            return _KIND_TO_DTYPE[self.kind]
        except KeyError:
            raise TypeError(f"{self.kind} has no single device dtype")

    @property
    def is_string(self) -> bool:
        return self.kind in (TypeKind.VARCHAR, TypeKind.VARBINARY)

    @property
    def is_integer(self) -> bool:
        return self.kind in (
            TypeKind.TINYINT, TypeKind.SMALLINT, TypeKind.INTEGER,
            TypeKind.BIGINT, TypeKind.DATE,
        )

    @property
    def is_floating(self) -> bool:
        return self.kind in (TypeKind.REAL, TypeKind.DOUBLE)

    @property
    def is_numeric(self) -> bool:
        return self.is_integer or self.is_floating or self.kind == TypeKind.DECIMAL

    @property
    def is_orderable(self) -> bool:
        return self.kind.is_scalar and self.kind != TypeKind.UNKNOWN

    def __str__(self) -> str:
        return self.kind.value

    def equivalent(self, other: "DataType") -> bool:
        return self == other


@dataclass(frozen=True)
class DecimalType(DataType):
    precision: int = 18
    scale: int = 0

    def __post_init__(self):
        # long decimals (p <= 38) ride int64 lanes as long as every
        # VALUE fits (~1.8e19 unscaled) — ingestion rejects true
        # 128-bit values loudly (vector/arrow_bridge.py; velox HugeInt
        # deviation documented in PARITY.md)
        if self.precision > 38:
            raise NotImplementedError(
                f"decimal precision {self.precision} > 38")

    @property
    def dtype(self) -> np.dtype:
        return decimal_lane_dtype(self)

    def __str__(self) -> str:
        return f"DECIMAL({self.precision},{self.scale})"


def decimal_lane_dtype(t: "DecimalType") -> np.dtype:
    """Device lane for a decimal: int32 in narrow-lane mode when the
    precision provably fits (TPUs emulate 64-bit; SURVEY.md §7 hard part
    #5 — int paths never through float, and on TPU never through 64-bit
    when 32 suffice)."""
    from velox_tpu_torch.utils.config import config

    if config.narrow_lanes and t.precision <= 9:
        return np.dtype(np.int32)
    return np.dtype(np.int64)


@dataclass(frozen=True)
class ArrayType(DataType):
    element: DataType = None  # type: ignore[assignment]

    def __str__(self) -> str:
        return f"ARRAY<{self.element}>"


@dataclass(frozen=True)
class MapType(DataType):
    key: DataType = None    # type: ignore[assignment]
    value: DataType = None  # type: ignore[assignment]

    def __str__(self) -> str:
        return f"MAP<{self.key},{self.value}>"


@dataclass(frozen=True)
class RowType(DataType):
    """Struct type with named children (velox/type/Type.h RowType)."""

    names: Tuple[str, ...] = ()
    children: Tuple[DataType, ...] = ()

    def __post_init__(self):
        assert len(self.names) == len(self.children)

    @property
    def size(self) -> int:
        return len(self.names)

    def index_of(self, name: str) -> int:
        try:
            return self.names.index(name)
        except ValueError:
            raise KeyError(f"field {name!r} not in {self.names}")

    def contains(self, name: str) -> bool:
        return name in self.names

    def child_at(self, i: int) -> DataType:
        return self.children[i]

    def find_child(self, name: str) -> DataType:
        return self.children[self.index_of(name)]

    def __str__(self) -> str:
        inner = ", ".join(f"{n}:{c}" for n, c in zip(self.names, self.children))
        return f"ROW<{inner}>"

    def union(self, other: "RowType") -> "RowType":
        return RowType(
            TypeKind.ROW,
            self.names + other.names,
            self.children + other.children,
        )


def row(**fields: DataType) -> RowType:
    return RowType(TypeKind.ROW, tuple(fields.keys()), tuple(fields.values()))


def row_type(names, children) -> RowType:
    return RowType(TypeKind.ROW, tuple(names), tuple(children))


# Singleton scalar types
BOOLEAN = DataType(TypeKind.BOOLEAN)
TINYINT = DataType(TypeKind.TINYINT)
SMALLINT = DataType(TypeKind.SMALLINT)
INTEGER = DataType(TypeKind.INTEGER)
BIGINT = DataType(TypeKind.BIGINT)
REAL = DataType(TypeKind.REAL)
DOUBLE = DataType(TypeKind.DOUBLE)
VARCHAR = DataType(TypeKind.VARCHAR)
VARBINARY = DataType(TypeKind.VARBINARY)
TIMESTAMP = DataType(TypeKind.TIMESTAMP)
DATE = DataType(TypeKind.DATE)
INTERVAL_DAY_TIME = DataType(TypeKind.INTERVAL_DAY_TIME)
INTERVAL_YEAR_MONTH = DataType(TypeKind.INTERVAL_YEAR_MONTH)
UNKNOWN = DataType(TypeKind.UNKNOWN)
ROW = TypeKind.ROW
ARRAY = TypeKind.ARRAY
MAP = TypeKind.MAP


def DECIMAL(precision: int, scale: int) -> DecimalType:
    return DecimalType(TypeKind.DECIMAL, precision, scale)


def array(element: DataType) -> ArrayType:
    return ArrayType(TypeKind.ARRAY, element)


def map_(key: DataType, value: DataType) -> MapType:
    return MapType(TypeKind.MAP, key, value)


#: numeric widening order used by binary-op type resolution
_NUMERIC_ORDER = [
    TypeKind.TINYINT, TypeKind.SMALLINT, TypeKind.INTEGER, TypeKind.BIGINT,
    TypeKind.REAL, TypeKind.DOUBLE,
]


def common_numeric_type(a: DataType, b: DataType) -> DataType:
    """Presto-style implicit numeric widening for arithmetic/comparison."""
    if a == b:
        return a
    if a.kind == TypeKind.DECIMAL or b.kind == TypeKind.DECIMAL:
        # decimal op decimal handled by caller (scale math); decimal vs float
        # widens to double
        if a.is_floating or b.is_floating:
            return DOUBLE
        if a.kind == TypeKind.DECIMAL and b.kind == TypeKind.DECIMAL:
            return a if a == b else DOUBLE
        return a if a.kind == TypeKind.DECIMAL else b
    if not (a.is_numeric and b.is_numeric):
        raise TypeError(f"no common numeric type for {a} and {b}")
    ia = _NUMERIC_ORDER.index(a.kind)
    ib = _NUMERIC_ORDER.index(b.kind)
    return DataType(_NUMERIC_ORDER[max(ia, ib)])
