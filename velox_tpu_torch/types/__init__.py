"""Logical types (a copy of the JAX package's ``types/types.py``)."""

from velox_tpu_torch.types.types import (
    TypeKind,
    DataType,
    BOOLEAN,
    TINYINT,
    SMALLINT,
    INTEGER,
    BIGINT,
    REAL,
    DOUBLE,
    VARCHAR,
    VARBINARY,
    DATE,
    TIMESTAMP,
    DECIMAL,
    ROW,
    ARRAY,
    MAP,
    UNKNOWN,
    RowType,
    ArrayType,
    MapType,
    DecimalType,
)

__all__ = [
    "TypeKind", "DataType", "RowType", "ArrayType", "MapType", "DecimalType",
    "BOOLEAN", "TINYINT", "SMALLINT", "INTEGER", "BIGINT", "REAL", "DOUBLE",
    "VARCHAR", "VARBINARY", "DATE", "TIMESTAMP", "DECIMAL", "ROW", "ARRAY",
    "MAP", "UNKNOWN",
]
