"""Shared set-up of the port's differential tests: seeded TPC-H tables
and hand-made tables, registered in both packages' catalogs from the same
numpy arrays, and the row-for-row comparison of two results."""

import contextlib

import numpy as np
import pyarrow as pa

from velox_tpu.io import catalog as jax_catalog
from velox_tpu.utils.config import config as jax_config
from velox_tpu_torch.io import catalog as torch_catalog
from velox_tpu_torch.io.tpch import (
    as_money_schema, lineitem_columns, table_dictionaries, tpch_columns,
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
                   batch_rows: int = BATCH_ROWS, tables=None):
    """Register seeded TPC-H ``tables`` (default: all eight) in both
    catalogs under ``narrow``; drop every table and restore both configs
    afterwards. Yields the generated cents columns per table and the
    dictionaries."""
    old = (jax_config.narrow_lanes, torch_config.narrow_lanes)
    jax_config.narrow_lanes = torch_config.narrow_lanes = narrow
    data, dictionaries = tpch_columns(sf, SEED, tables)
    try:
        for name, columns in data.items():
            dicts = table_dictionaries(columns, dictionaries)
            cols, overrides = as_money_schema(columns, money)
            torch_catalog.register_columns(
                name, cols, dicts, batch_rows, overrides, device="cpu")
            table, overrides = arrow_table(columns, dicts, money)
            jax_catalog.register_arrow(name, table, batch_rows,
                                       decimal_overrides=overrides)
        yield data, dictionaries
    finally:
        for name in data:
            jax_catalog.drop_table(name)
            torch_catalog.drop_table(name)
        jax_config.narrow_lanes, torch_config.narrow_lanes = old


def assert_same(got: dict, exp: dict, what: str = "") -> None:
    """Row for row: DOUBLE columns to ``rtol=1e-9``, every other column
    (integers, decimals, dates, strings, nulls) exactly."""
    assert list(got) == list(exp), what
    for c in exp:
        assert len(got[c]) == len(exp[c]), f"{what} {c}"
        floats = [v for v in exp[c] if isinstance(v, float)]
        if floats:
            assert [v is None for v in got[c]] == \
                [v is None for v in exp[c]], f"{what} {c}"
            np.testing.assert_allclose(
                [v for v in got[c] if v is not None],
                [v for v in exp[c] if v is not None], rtol=1e-9,
                err_msg=f"{what} {c}")
        else:
            assert got[c] == exp[c], f"{what} {c}"


@contextlib.contextmanager
def table_in_both(name, columns, dictionaries=None, overrides=None,
                  batch_rows: int = 128):
    """Register one hand-made table in both catalogs: string columns as
    int32 codes into ``dictionaries`` (-1 is NULL), integer columns named
    in ``overrides`` as unscaled decimals, ``datetime64[D]`` columns as
    dates and finer ``datetime64`` units as timestamps."""
    dictionaries = dictionaries or {}
    torch_catalog.register_columns(name, columns, dictionaries, batch_rows,
                                   overrides, device="cpu")
    arrays = {}
    for c, v in columns.items():
        if c in dictionaries:
            values = np.asarray(list(dictionaries[c]) + [None], dtype=object)
            arrays[c] = pa.array(values[v].tolist(), type=pa.string())
        elif v.dtype == np.dtype("datetime64[D]"):
            days = v.astype(np.int64)
            arrays[c] = pa.array(days.astype(np.int32), type=pa.date32())
        else:
            # finer datetime64 units become Arrow timestamps
            arrays[c] = pa.array(v)
    jax_catalog.register_arrow(name, pa.table(arrays), batch_rows,
                               decimal_overrides=overrides)
    try:
        yield
    finally:
        jax_catalog.drop_table(name)
        torch_catalog.drop_table(name)


def values_in_both(columns, nulls=None, dictionaries=None,
                   batch_rows: int = 128, overrides=None):
    """The same rows as literal batches of each package, for
    ``PlanBuilder.values``: ``(jax_batches, torch_batches)``, each a list
    of splits of at most ``batch_rows`` rows. String columns are int32
    codes into ``dictionaries`` (-1 is NULL); ``nulls`` maps other
    columns to a bool mask of their NULL rows (their values read 0);
    integer columns named in ``overrides`` are unscaled decimals."""
    import torch

    from velox_tpu_torch.vector.batch import Batch as TorchBatch
    from velox_tpu_torch.vector.column import Column as TorchColumn

    nulls = nulls or {}
    dictionaries = dictionaries or {}
    columns = {c: (np.where(nulls[c], np.zeros_like(v), v)
                   if c in nulls else v) for c, v in columns.items()}
    table = torch_catalog.register_columns(
        "_values_in_both", columns, dictionaries, batch_rows, overrides,
        device="cpu")
    torch_catalog.drop_table("_values_in_both")
    torch_batches = []
    for i, b in enumerate(table.batches):
        cols = dict(b.columns)
        for c, mask in nulls.items():
            valid = np.zeros(b.capacity, dtype=bool)
            valid[:b.num_rows] = ~mask[i * batch_rows:
                                       i * batch_rows + b.num_rows]
            old = cols[c]
            cols[c] = TorchColumn(old.dtype, old.values,
                                  torch.from_numpy(valid), old.dictionary,
                                  old.stats)
        torch_batches.append(TorchBatch(cols, b.sel, b.num_rows))
    arrays = {}
    for c, v in columns.items():
        if c in dictionaries:
            values = np.asarray(list(dictionaries[c]) + [None], dtype=object)
            arrays[c] = pa.array(values[v].tolist(), type=pa.string())
        else:
            arrays[c] = pa.array(v, mask=nulls.get(c))
    # the JAX catalog's splits share one sorted dictionary per column
    jax_batches = jax_catalog.register_arrow(
        "_values_in_both", pa.table(arrays), batch_rows,
        decimal_overrides=overrides).batches
    jax_catalog.drop_table("_values_in_both")
    return jax_batches, torch_batches


#: TPC-DS scale of the differential tests: every spec query returns rows
TPCDS_SF = 0.01
TPCDS_SEED = 7


@contextlib.contextmanager
def tpcds_in_both(sf: float = TPCDS_SF, batch_rows: int = BATCH_ROWS,
                  prefix: str = ""):
    """Generate the TPC-DS tables with each package's generator and
    register them in its catalog under ``prefix``; yield the port's
    arrays (``tpcds_columns``) and drop every table afterwards."""
    from velox_tpu.io.tpcds import register_tpcds as jax_register
    from velox_tpu_torch.io.tpcds import TABLES, register_tpcds

    jax_register(sf, batch_rows, TPCDS_SEED, prefix)
    try:
        yield register_tpcds(sf, batch_rows, TPCDS_SEED, prefix,
                             device="cpu")
    finally:
        for name in TABLES:
            jax_catalog.drop_table(prefix + name)
            torch_catalog.drop_table(prefix + name)
