"""Column: fixed-width device value lane + validity + optional dictionary.

The port of ``velox_tpu/vector/column.py``: flat and dictionary columns,
and the ARRAY, MAP and ROW columns with their host constructors
(``make_array_column``, ``make_map_column``, ``make_row_column``).
``valid[i] == True`` means row i
is non-null; ``valid is None`` means all rows are non-null. String
columns hold int32 codes into a host-side :class:`Dictionary`, with code
-1 for null or padding.
"""

from __future__ import annotations

import datetime
import decimal
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from velox_tpu_torch.types import DataType


class Dictionary:
    """Host-side value table for string columns (a copy of the JAX
    package's). Codes index ``values``; -1 is null/padding.

    A dictionary never changes, so what is derived from its values (a
    LIKE pattern's match table, a substr's code remap) is computed once
    and kept with it (``derived``). The value -> code index is built at
    the first ``code_of``: a 14M-value comment dictionary never needs
    one."""

    __slots__ = ("values", "_index", "_derived")

    def __init__(self, values: Sequence[str]):
        self.values = np.asarray(values, dtype=object)
        self._index = None
        self._derived = {}

    def __len__(self) -> int:
        return len(self.values)

    def code_of(self, value: str) -> int:
        """Code for a string literal, or -2 if absent (never matches)."""
        if self._index is None:
            self._index = {v: i for i, v in enumerate(self.values)}
        return self._index.get(value, -2)

    def derived(self, key: tuple, make: Callable[["Dictionary"], object]):
        """``make(self)``, computed once per ``key``."""
        hit = self._derived.get(key)
        if hit is None:
            hit = self._derived[key] = make(self)
        return hit

    def decode(self, codes: np.ndarray) -> np.ndarray:
        """Host-side gather codes -> strings (None for negative codes)."""
        out = np.empty(len(codes), dtype=object)
        codes = np.asarray(codes)
        in_range = codes >= 0
        out[~in_range] = None
        out[in_range] = self.values[codes[in_range]]
        return out


@dataclass(frozen=True)
class Column:
    """One column of a Batch. ``values`` has the batch's capacity."""

    dtype: DataType
    values: torch.Tensor                    # (capacity,)
    valid: Optional[torch.Tensor] = None    # (capacity,) bool, None = all
    dictionary: Optional[Dictionary] = None
    #: table-global (min, max) of the raw lane values (the VectorHasher
    #: stats analog): drives narrow-lane and interval decisions
    stats: Optional[tuple] = None

    @property
    def capacity(self) -> int:
        return self.values.shape[0]

    def validity(self) -> torch.Tensor:
        if self.valid is not None:
            return self.valid
        return torch.ones((self.capacity,), dtype=torch.bool,
                          device=self.values.device)

    def gather(self, indices: torch.Tensor) -> "Column":
        """Row gather; indices are clipped into [0, capacity) and callers
        mask garbage rows through the batch selection."""
        idx = indices.clamp(0, self.capacity - 1)
        vals = self.values.index_select(0, idx)
        valid = (self.valid.index_select(0, idx)
                 if self.valid is not None else None)
        return Column(self.dtype, vals, valid, self.dictionary, self.stats)

    def to_pylist(self, num_rows: Optional[int] = None) -> list:
        """Host values of the first ``num_rows`` slots, NULLs as None
        and each type as ``Batch.to_pydict`` gives it."""
        vals = self.values[:num_rows].cpu().numpy()
        py = host_values(self.dtype, self.dictionary, vals)
        if self.valid is None:
            return py
        ok = self.valid[:num_rows].cpu().numpy()
        return [v if k else None for v, k in zip(py, ok)]


_EPOCH = datetime.date(1970, 1, 1)
_EPOCH_TS = datetime.datetime(1970, 1, 1)
_DEC_CTX = decimal.Context(prec=60)


def host_values(dtype: DataType, dictionary: Optional[Dictionary],
                vals: np.ndarray) -> list:
    """One lane's host values as Python objects: strings through the
    dictionary, decimals as ``decimal.Decimal``, dates as
    ``datetime.date``, timestamps as ``datetime.datetime`` (the JAX
    package's Arrow output)."""
    from velox_tpu_torch.types.types import DecimalType, TypeKind

    if dictionary is not None:
        return list(dictionary.decode(vals))
    if isinstance(dtype, DecimalType):
        s = dtype.scale
        return [decimal.Decimal(int(v)).scaleb(-s, _DEC_CTX)
                for v in vals.tolist()]
    if dtype.kind == TypeKind.DATE:
        return [_EPOCH + datetime.timedelta(days=int(v))
                for v in vals.tolist()]
    if dtype.kind == TypeKind.TIMESTAMP:
        return [_EPOCH_TS + datetime.timedelta(microseconds=int(v))
                for v in vals.tolist()]
    return vals.tolist()


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return x.index_select(0, idx.clamp(0, x.shape[0] - 1))


def _take_valid(valid: Optional[torch.Tensor], idx: torch.Tensor):
    return None if valid is None else _take(valid, idx)


def _all_rows(cap: int, device) -> torch.Tensor:
    return torch.ones((cap,), dtype=torch.bool, device=device)


def _referenced(col, num_rows, flats):
    """An ARRAY or MAP column's first ``num_rows`` rows read back: their
    validity and lengths, each row's start in ``flats``' values gathered
    to the elements the live rows reference (in row order, so a large
    element column is not read whole), and those values."""
    starts = col.starts[:num_rows].cpu().numpy().astype(np.int64)
    lengths = col.lengths[:num_rows].cpu().numpy().astype(np.int64)
    valid = (None if col.valid is None
             else col.valid[:num_rows].cpu().numpy())
    live = np.maximum(lengths if valid is None
                      else np.where(valid, lengths, 0), 0)
    new_starts = np.cumsum(live) - live
    idx = np.repeat(starts - new_starts, live) + np.arange(int(live.sum()))
    it = torch.from_numpy(idx).to(col.starts.device)
    return valid, lengths, new_starts, [f.gather(it).to_pylist()
                                        for f in flats]


@dataclass(frozen=True)
class ArrayColumn:
    """ARRAY column: offsets into one flat element column.

    ``starts``/``lengths`` (int32) live at the batch capacity; ``elements``
    is a flat :class:`Column` (or a nested Array/Row column) with a
    capacity of its own. A row gather moves offsets only and shares the
    elements (velox/vector/ComplexVector.h:571 ArrayVector)."""

    dtype: DataType
    starts: torch.Tensor
    lengths: torch.Tensor
    elements: object
    valid: Optional[torch.Tensor] = None
    #: flat-column attributes, so loops over columns skip complex ones
    dictionary = None
    stats = None

    @property
    def capacity(self) -> int:
        return self.starts.shape[0]

    def validity(self) -> torch.Tensor:
        return (self.valid if self.valid is not None
                else _all_rows(self.capacity, self.starts.device))

    def gather(self, indices: torch.Tensor) -> "ArrayColumn":
        return ArrayColumn(self.dtype, _take(self.starts, indices),
                           _take(self.lengths, indices), self.elements,
                           _take_valid(self.valid, indices))

    def to_pylist(self, num_rows: Optional[int] = None) -> list:
        valid, lengths, starts, (elems,) = _referenced(
            self, num_rows, [self.elements])
        return [None if valid is not None and not valid[i]
                else elems[starts[i]: starts[i] + lengths[i]]
                for i in range(len(starts))]


@dataclass(frozen=True)
class MapColumn:
    """MAP column: offsets into flat key and value columns of one shared
    capacity (velox/vector/ComplexVector.h:589 MapVector). Keys are
    unique within a map, except in the entries ``split_to_multimap``
    repeats. Host output is a list of (key, value) pairs per row."""

    dtype: DataType
    starts: torch.Tensor
    lengths: torch.Tensor
    keys: Column
    values: object
    valid: Optional[torch.Tensor] = None
    dictionary = None
    stats = None

    @property
    def capacity(self) -> int:
        return self.starts.shape[0]

    def validity(self) -> torch.Tensor:
        return (self.valid if self.valid is not None
                else _all_rows(self.capacity, self.starts.device))

    def gather(self, indices: torch.Tensor) -> "MapColumn":
        return MapColumn(self.dtype, _take(self.starts, indices),
                         _take(self.lengths, indices), self.keys,
                         self.values, _take_valid(self.valid, indices))

    def to_pylist(self, num_rows: Optional[int] = None) -> list:
        valid, lengths, starts, (ks, vs) = _referenced(
            self, num_rows, [self.keys, self.values])
        out = []
        for i in range(len(starts)):
            if valid is not None and not valid[i]:
                out.append(None)
            else:
                s, n = starts[i], lengths[i]
                out.append(list(zip(ks[s: s + n], vs[s: s + n])))
        return out


@dataclass(frozen=True)
class RowColumn:
    """ROW (struct) column: named children at the batch capacity
    (velox/vector/ComplexVector.h:31 RowVector). Expressions build them
    (``row_constructor``, ``map_entries``, ``zip``); a NULL row leaves
    its children's slots as padding."""

    dtype: DataType
    children: tuple
    valid: Optional[torch.Tensor] = None
    dictionary = None
    stats = None

    @property
    def capacity(self) -> int:
        return self.children[0].capacity

    @property
    def names(self) -> tuple:
        return tuple(self.dtype.names)

    def child(self, name: str):
        return self.children[self.dtype.index_of(name)]

    def validity(self) -> torch.Tensor:
        if self.valid is not None:
            return self.valid
        c = self.children[0]
        dev = (c.values if isinstance(c, Column) else c.validity()).device
        return _all_rows(self.capacity, dev)

    def gather(self, indices: torch.Tensor) -> "RowColumn":
        return RowColumn(self.dtype,
                         tuple(c.gather(indices) for c in self.children),
                         _take_valid(self.valid, indices))

    def to_pylist(self, num_rows: Optional[int] = None) -> list:
        kids = [c.to_pylist(num_rows) for c in self.children]
        n = len(kids[0]) if kids else 0
        valid = (None if self.valid is None
                 else self.valid[:n].cpu().numpy())
        return [None if valid is not None and not valid[i]
                else {nm: kids[j][i] for j, nm in enumerate(self.names)}
                for i in range(n)]


COMPLEX_COLUMNS = (ArrayColumn, MapColumn, RowColumn)


def element_capacity(n: int) -> int:
    """The capacity of a flat element column of ``n`` values: a power of
    two of at least one lane (128), as the JAX package pads them."""
    return max(128, 1 << (max(n, 1) - 1).bit_length())


def _row_valid(data: Sequence, capacity: int, device):
    if all(row is not None for row in data):
        return None
    v = np.zeros(capacity, dtype=bool)
    v[:len(data)] = [row is not None for row in data]
    return torch.from_numpy(v).to(device)


def make_column(dtype: DataType, data: Sequence, capacity: int,
                device) -> Column:
    """Host list -> padded Column (``None`` is NULL; strings get a sorted
    dictionary, NULL code -1)."""
    from velox_tpu_torch import torch_dtype

    n = len(data)
    if n > capacity:
        raise ValueError(f"{n} values over capacity {capacity}")
    if dtype.is_string:
        arr = np.asarray(list(data), dtype=object)
        present = np.asarray([v is not None for v in arr], dtype=bool)
        uniq, inv = np.unique(arr[present].astype(str),
                              return_inverse=True)
        vals = np.full(capacity, -1, dtype=np.int32)
        codes = np.full(n, -1, dtype=np.int32)
        codes[present] = inv.astype(np.int32)
        vals[:n] = codes
        valid = None
        if not present.all():
            v = np.zeros(capacity, dtype=bool)
            v[:n] = present
            valid = torch.from_numpy(v).to(device)
        return Column(dtype, torch.from_numpy(vals).to(device), valid,
                      Dictionary([str(u) for u in uniq]))
    vals = np.zeros(capacity, dtype=dtype.dtype)
    vals[:n] = np.asarray([0 if x is None else x for x in data],
                          dtype=dtype.dtype)
    valid = _row_valid(list(data), capacity, device)
    return Column(dtype, torch.from_numpy(vals).to(torch_dtype(
        dtype.dtype)).to(device), valid)


def make_any_column(dtype: DataType, data: Sequence, capacity: int,
                    device):
    """Host list -> a column of ``dtype``'s kind (flat or complex)."""
    from velox_tpu_torch.types.types import TypeKind

    if dtype.kind == TypeKind.ARRAY:
        return make_array_column(dtype, data, capacity, device)
    if dtype.kind == TypeKind.MAP:
        return make_map_column(dtype, data, capacity, device)
    if dtype.kind == TypeKind.ROW:
        return make_row_column(dtype, data, capacity, device)
    return make_column(dtype, data, capacity, device)


def make_array_column(dtype: DataType, data: Sequence, capacity: int,
                      device) -> ArrayColumn:
    """Host list of lists -> ArrayColumn (``None`` is a NULL row of
    length 0); the elements get a capacity of their own."""
    starts = np.zeros(capacity, dtype=np.int32)
    lengths = np.zeros(capacity, dtype=np.int32)
    flat: list = []
    for i, row in enumerate(data):
        starts[i] = len(flat)
        if row is not None:
            lengths[i] = len(row)
            flat.extend(row)
    elements = make_any_column(dtype.element, flat,
                               element_capacity(len(flat)), device)
    return ArrayColumn(dtype, torch.from_numpy(starts).to(device),
                       torch.from_numpy(lengths).to(device), elements,
                       _row_valid(list(data), capacity, device))


def _entries(row) -> list:
    return list(row.items()) if isinstance(row, dict) else list(row)


def make_map_column(dtype: DataType, data: Sequence, capacity: int,
                    device) -> MapColumn:
    """Host list of dicts (or of (key, value) pair lists) -> MapColumn."""
    starts = np.zeros(capacity, dtype=np.int32)
    lengths = np.zeros(capacity, dtype=np.int32)
    flat_k: list = []
    flat_v: list = []
    for i, row in enumerate(data):
        starts[i] = len(flat_k)
        if row is not None:
            ents = _entries(row)
            lengths[i] = len(ents)
            for k, v in ents:
                flat_k.append(k)
                flat_v.append(v)
    ecap = element_capacity(len(flat_k))
    return MapColumn(dtype, torch.from_numpy(starts).to(device),
                     torch.from_numpy(lengths).to(device),
                     make_column(dtype.key, flat_k, ecap, device),
                     make_any_column(dtype.value, flat_v, ecap, device),
                     _row_valid(list(data), capacity, device))


def make_row_column(dtype: DataType, data: Sequence, capacity: int,
                    device) -> RowColumn:
    """Host list of dicts -> RowColumn (``None`` is a NULL row)."""
    kids = []
    for nm, ct in zip(dtype.names, dtype.children):
        vals = [None if row is None else row.get(nm) for row in data]
        kids.append(make_any_column(ct, vals, capacity, device))
    return RowColumn(dtype, tuple(kids),
                     _row_valid(list(data), capacity, device))
