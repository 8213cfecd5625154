"""Shared set-up of the port's differential tests: seeded TPC-H tables,
registered in both packages' catalogs from the same numpy arrays."""

import contextlib

import numpy as np
import pyarrow as pa

from velox_tpu.io import catalog as jax_catalog
from velox_tpu.utils.config import config as jax_config
from velox_tpu_torch.io import catalog as torch_catalog
from velox_tpu_torch.io.tpch import (
    as_money_schema, lineitem_columns, tpch_columns,
)
from velox_tpu_torch.utils.config import config as torch_config

SF = 0.01
SEED = 20240601
BATCH_ROWS = 1 << 14

#: (narrow_lanes, money schema) of each differential configuration
CONFIGS = [(True, "cents"), (False, "cents"), (True, "double")]


def arrow_table(columns, dictionaries, money):
    """The same data as an Arrow table for the JAX package: strings
    decoded, dates as date32, plus the money schema's overrides."""
    cols, overrides = as_money_schema(columns, money)
    arrays = {}
    for name, v in cols.items():
        if name in dictionaries:
            values = np.asarray(dictionaries[name], dtype=object)
            arrays[name] = pa.array(values[v].tolist(), type=pa.string())
        elif v.dtype.kind == "M":
            days = v.astype("datetime64[D]").astype(np.int64)
            arrays[name] = pa.array(days.astype(np.int32), type=pa.date32())
        else:
            arrays[name] = pa.array(v)
    return pa.table(arrays), overrides


@contextlib.contextmanager
def lineitem_in_both(narrow: bool, money: str, sf: float = SF,
                     batch_rows: int = BATCH_ROWS):
    """Register one seeded lineitem in both catalogs under ``narrow``;
    drop both tables and restore both configs afterwards."""
    old = (jax_config.narrow_lanes, torch_config.narrow_lanes)
    jax_config.narrow_lanes = torch_config.narrow_lanes = narrow
    try:
        columns, dictionaries = lineitem_columns(sf, SEED)
        cols, overrides = as_money_schema(columns, money)
        torch_catalog.register_columns(
            "lineitem", cols, dictionaries, batch_rows, overrides,
            device="cpu")
        table, overrides = arrow_table(columns, dictionaries, money)
        jax_catalog.register_arrow("lineitem", table, batch_rows,
                                   decimal_overrides=overrides)
        yield columns, dictionaries
    finally:
        jax_catalog.drop_table("lineitem")
        torch_catalog.drop_table("lineitem")
        jax_config.narrow_lanes, torch_config.narrow_lanes = old


@contextlib.contextmanager
def tables_in_both(narrow: bool, money: str, sf: float = SF,
                   batch_rows: int = BATCH_ROWS):
    """Register seeded lineitem, orders and customer in both catalogs
    under ``narrow``; drop every table and restore both configs
    afterwards. Yields the generated cents columns per table and the
    dictionaries."""
    old = (jax_config.narrow_lanes, torch_config.narrow_lanes)
    jax_config.narrow_lanes = torch_config.narrow_lanes = narrow
    tables, dictionaries = tpch_columns(sf, SEED)
    try:
        for name, columns in tables.items():
            dicts = {c: v for c, v in dictionaries.items() if c in columns}
            cols, overrides = as_money_schema(columns, money)
            torch_catalog.register_columns(
                name, cols, dicts, batch_rows, overrides, device="cpu")
            table, overrides = arrow_table(columns, dicts, money)
            jax_catalog.register_arrow(name, table, batch_rows,
                                       decimal_overrides=overrides)
        yield tables, dictionaries
    finally:
        for name in tables:
            jax_catalog.drop_table(name)
            torch_catalog.drop_table(name)
        jax_config.narrow_lanes, torch_config.narrow_lanes = old
