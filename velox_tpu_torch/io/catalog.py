"""Session catalog: named tables -> device batch splits.

The port of ``velox_tpu/io/catalog.py`` without pyarrow: a table is
registered from numpy arrays and becomes a list of fixed-capacity device
Batches ("splits") that TableScan drains. ``register_columns`` produces
exactly the splits the JAX package's ``register_arrow`` -> ``ingest_splits``
produces for the same data:

* lane-rounded split capacities (multiples of 128); the ragged tail gets
  its own capacity;
* table-global SORTED string dictionaries (ORDER BY sorts codes);
* decimal overrides (integer columns taken as unscaled decimals, on the
  lane ``decimal_lane_dtype`` picks when the table is registered);
* table-global ``(min, max)`` stats on integer and date lanes, and the
  ``sorted_cols``/``unique_cols`` ordering facts the optimizer reads;
* long decimals (``shred_wide_decimals``): a DECIMAL(p > 18) column given
  as Python ints (``None`` is NULL) stays one int64 lane while every value
  fits int64, and otherwise becomes three signed-digit lanes
  ``{c}#w{d}s{scale}`` (``types/widedec.py``), listed in
  ``Table.wide_groups``.

This is where the state a query reads crosses to the device: the device
is fixed here, once (``device=None`` means the CUDA card).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from velox_tpu_torch import resolve_device
from velox_tpu_torch.types import (
    BIGINT, BOOLEAN, DATE, DOUBLE, INTEGER, REAL, SMALLINT, TIMESTAMP,
    TINYINT, VARCHAR,
)
from velox_tpu_torch.types.types import DataType, DecimalType, RowType, TypeKind
from velox_tpu_torch.utils.testvalue import TestValue
from velox_tpu_torch.vector.batch import Batch
from velox_tpu_torch.vector.column import Column, Dictionary

_NP_TYPES = {
    np.dtype(np.int8): TINYINT, np.dtype(np.int16): SMALLINT,
    np.dtype(np.int32): INTEGER, np.dtype(np.int64): BIGINT,
    np.dtype(np.float32): REAL, np.dtype(np.float64): DOUBLE,
    np.dtype(np.bool_): BOOLEAN,
}


@dataclass
class Table:
    name: str
    schema: RowType
    batches: List[Batch]
    #: columns verified nondecreasing in storage order at ingest
    sorted_cols: frozenset = frozenset()
    #: subset of sorted_cols that are strictly increasing (hence unique)
    unique_cols: frozenset = frozenset()
    #: long-decimal columns shredded to digit lanes (types/widedec.py)
    wide_groups: Dict[str, List[str]] = field(default_factory=dict)

    @property
    def num_rows(self) -> int:
        return sum(b.num_rows or 0 for b in self.batches)

    def make_splits(self) -> List[Batch]:
        """The splits of one TableScan (an injection point: a test can
        fail a read here, as the JAX package's file splits can)."""
        TestValue.adjust("velox_tpu.scan.read_split", self)
        return list(self.batches)


_TABLES: Dict[str, Table] = {}


def get_table(name: str) -> Table:
    try:
        return _TABLES[name]
    except KeyError:
        raise KeyError(f"no table {name!r}; registered: {sorted(_TABLES)}")


def drop_table(name: str) -> None:
    _TABLES.pop(name, None)


def _sorted_dictionary(codes: np.ndarray, values: Sequence[str]):
    """Keep the dictionary entries the column uses, sorted; remap codes
    to ranks (-1 stays null). Matches an arrow dictionary-encode of the
    decoded column followed by the JAX catalog's sort."""
    values = np.asarray(values, dtype=object)
    live = codes >= 0
    used = np.bincount(codes[live], minlength=len(values)) > 0
    kept = np.nonzero(used)[0]
    order = np.argsort(values[kept].astype(str), kind="stable")
    rank = np.full(len(values), -1, dtype=np.int32)
    rank[kept[order]] = np.arange(len(kept), dtype=np.int32)
    out = np.where(live, rank[np.where(live, codes, 0)], -1)
    return Dictionary(list(values[kept[order]])), out.astype(np.int32)


def _is_date(arr: np.ndarray) -> bool:
    return arr.dtype == np.dtype("datetime64[D]")


def _column_type(name: str, arr: np.ndarray, dictionaries) -> DataType:
    if name in dictionaries:
        return VARCHAR
    if arr.dtype.kind == "M":
        # day precision is a DATE; any finer unit a microsecond
        # TIMESTAMP, as the JAX package's Arrow ingest keeps it
        return DATE if _is_date(arr) else TIMESTAMP
    try:
        return _NP_TYPES[arr.dtype]
    except KeyError:
        raise TypeError(f"column {name}: unsupported dtype {arr.dtype}")


def _lane(arr: np.ndarray) -> np.ndarray:
    """Host lane values: dates as int32 days since the epoch, timestamps
    as int64 microseconds since the epoch."""
    if arr.dtype.kind == "M":
        if _is_date(arr):
            return arr.astype(np.int64).astype(np.int32)
        return arr.astype("datetime64[us]").astype(np.int64)
    return arr


def _ordering_stats(lanes: Mapping[str, np.ndarray], types) -> tuple:
    """Nondecreasing / strictly increasing integer and date lanes."""
    sorted_cols, unique_cols = set(), set()
    for name, v in lanes.items():
        t = types[name]
        if not (t.is_integer or t.kind == TypeKind.DATE) or t.is_string:
            continue
        if len(v) == 0:
            continue
        d = np.diff(v)
        if len(d) == 0 or (d >= 0).all():
            sorted_cols.add(name)
            if len(d) == 0 or (d > 0).all():
                unique_cols.add(name)
    return frozenset(sorted_cols), frozenset(unique_cols)


def shred_wide_decimals(columns: Mapping[str, np.ndarray],
                        decimal_overrides: Dict[str, tuple]):
    """The numpy counterpart of the JAX package's ``shred_wide_decimals``:
    each overridden column held as Python ints (an object array, ``None``
    for NULL) becomes an int64 lane when every value fits int64, else the
    three digit lanes ``{c}#w{d}s{scale}`` in its place (their override
    dropped: the lanes are BIGINT, the scale rides their names). Returns
    (columns, overrides, NULL masks by column, wide groups)."""
    from velox_tpu_torch.types.widedec import lane_names, split_ints

    out: Dict[str, np.ndarray] = {}
    overrides = dict(decimal_overrides)
    nulls: Dict[str, np.ndarray] = {}
    wide: Dict[str, List[str]] = {}
    for c, arr in columns.items():
        arr = np.asarray(arr)
        if c not in overrides or arr.dtype != object:
            out[c] = arr
            continue
        isnull = np.equal(arr, None).astype(bool)
        vals = np.where(isnull, 0, arr)
        fits = bool(np.all((vals >= -(1 << 63)) & (vals < (1 << 63))))
        if fits:
            out[c] = vals.astype(np.int64)
            if isnull.any():
                nulls[c] = isnull
            continue
        names = lane_names(c, overrides.pop(c)[1])
        for n, lane in zip(names, split_ints(vals)):
            out[n] = lane
            if isnull.any():
                nulls[n] = isnull
        wide[c] = names
    return out, overrides, nulls, wide


def register_columns(
    name: str, columns: Mapping[str, np.ndarray],
    dictionaries: Optional[Mapping[str, Union[Sequence[str],
                                              Dictionary]]] = None,
    batch_rows: int = 1 << 20,
    decimal_overrides: Optional[Dict[str, tuple]] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> Table:
    """Ingest numpy columns as device splits of <= ``batch_rows`` rows.

    ``dictionaries`` names the string columns: each such column holds
    int32 codes (-1 = null) into its value list. ``decimal_overrides``
    maps integer columns to ``(precision, scale)``: the stored integers
    are unscaled decimals (cents); one given as an object array of Python
    ints may hold ``None`` (NULL) and values past int64
    (``shred_wide_decimals``). ``device=None`` means the CUDA card;
    without one this raises, and callers that want the CPU say so.
    """
    dev = resolve_device(device)
    dictionaries = {k: (v.values if isinstance(v, Dictionary) else v)
                    for k, v in (dictionaries or {}).items()}
    columns, decimal_overrides, nulls, wide_groups = shred_wide_decimals(
        columns, dict(decimal_overrides or {}))
    names = list(columns)
    lanes = {n: _lane(np.asarray(columns[n])) for n in names}
    lengths = {len(v) for v in lanes.values()}
    if len(lengths) != 1:
        raise ValueError(f"table {name}: columns differ in length")
    n = lengths.pop()
    types: Dict[str, DataType] = {
        c: _column_type(c, np.asarray(columns[c]), dictionaries)
        for c in names}

    encoded: Dict[str, tuple] = {}
    for c in names:
        if types[c].is_string:
            encoded[c] = _sorted_dictionary(
                lanes[c].astype(np.int64), dictionaries[c])
    # stats and ordering facts come from the raw integer/date lanes
    # (string codes and floats carry none), as the arrow ingest reads them
    stats = {}
    for c in names:
        t = types[c]
        if t.is_string or not (t.is_integer or t.kind == TypeKind.DATE):
            continue
        if n:
            stats[c] = (int(lanes[c].min()), int(lanes[c].max()))
    sorted_cols, unique_cols = _ordering_stats(
        {c: lanes[c] for c in names}, types)
    for c, (p, s) in decimal_overrides.items():
        types[c] = DecimalType(TypeKind.DECIMAL, p, s)

    batch_rows = min(batch_rows, max(n, 1))
    cap = max(-(-batch_rows // 128) * 128, 128)
    batches: List[Batch] = []
    for start in range(0, max(n, 1), batch_rows):
        rows = min(batch_rows, n - start)
        ccap = (cap if rows == batch_rows
                else max(-(-rows // 128) * 128, 128))
        cols = {}
        for c in names:
            t = types[c]
            if c in encoded:
                gdict, codes = encoded[c]
                vals = np.full(ccap, -1, dtype=np.int32)
                vals[:rows] = codes[start:start + rows]
                valid = None
                if (vals[:rows] < 0).any():
                    v = np.zeros(ccap, dtype=bool)
                    v[:rows] = vals[:rows] >= 0
                    valid = torch.from_numpy(v).to(dev)
                cols[c] = Column(t, torch.from_numpy(vals).to(dev), valid,
                                 gdict)
                continue
            vals = np.zeros(ccap, dtype=t.dtype)
            vals[:rows] = lanes[c][start:start + rows]
            if 0 < rows < ccap:
                # pad by replicating the last value (ascending lanes
                # stay ascending through the tail, as at JAX ingest)
                vals[rows:] = vals[rows - 1]
            valid = None
            if c in nulls:
                v = np.zeros(ccap, dtype=bool)
                v[:rows] = ~nulls[c][start:start + rows]
                valid = torch.from_numpy(v).to(dev)
            cols[c] = Column(t, torch.from_numpy(vals).to(dev), valid,
                             stats=stats.get(c))
        sel = torch.zeros(ccap, dtype=torch.bool)
        sel[:rows] = True
        batches.append(Batch(cols, sel.to(dev), num_rows=rows))
    schema = batches[0].schema
    t = Table(name, schema, batches, sorted_cols=sorted_cols,
              unique_cols=unique_cols, wide_groups=wide_groups)
    _TABLES[name] = t
    return t

