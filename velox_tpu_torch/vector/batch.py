"""Batch: a set of named Columns + a device selection mask.

The port of ``velox_tpu/vector/batch.py``: ``capacity`` is padded (lane
multiples at ingest, powers of two for intermediates), ``sel`` is a device
bool mask of active rows, and ``num_rows`` is an optional host-known row
count. Batches are immutable; transformations return new Batches sharing
unchanged tensors.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from velox_tpu_torch.types.types import RowType, TypeKind, row_type
from velox_tpu_torch.vector.column import (
    COMPLEX_COLUMNS, ArrayColumn, Column, Dictionary, MapColumn, RowColumn,
    host_values, make_any_column,
)

#: batch capacities are padded to a multiple of this
LANE = 128


def round_capacity(n: int) -> int:
    """Round up to a shape bucket: next power of two, at least one lane."""
    n = max(n, LANE)
    return 1 << (n - 1).bit_length()


class Batch:
    __slots__ = ("columns", "sel", "num_rows")

    def __init__(self, columns: Dict[str, Column], sel: torch.Tensor,
                 num_rows: Optional[int] = None):
        self.columns = dict(columns)
        self.sel = sel
        self.num_rows = num_rows
        cap = sel.shape[0]
        for name, col in self.columns.items():
            if col.capacity != cap:
                raise ValueError(f"column {name} capacity {col.capacity} "
                                 f"!= batch {cap}")

    # ---------------------------------------------------------- properties
    @property
    def capacity(self) -> int:
        return self.sel.shape[0]

    @property
    def device(self) -> torch.device:
        return self.sel.device

    @property
    def names(self) -> List[str]:
        return list(self.columns)

    @property
    def schema(self) -> RowType:
        return row_type(self.names, [c.dtype for c in self.columns.values()])

    def column(self, name: str) -> Column:
        return self.columns[name]

    def __contains__(self, name: str) -> bool:
        return name in self.columns

    # -------------------------------------------------------- construction
    @staticmethod
    def from_pydict(data: Dict[str, Sequence], types: Dict[str, object],
                    capacity: Optional[int] = None,
                    device=None) -> "Batch":
        """Host lists -> one batch (``None`` is NULL). ARRAY columns take
        lists, MAP columns dicts or (key, value) pair lists, ROW columns
        dicts. Integer lanes get (min, max) stats, as the JAX package's
        ``from_pydict`` gives them."""
        from velox_tpu_torch import resolve_device

        device = resolve_device(device)
        names = list(data)
        n = len(data[names[0]]) if names else 0
        cap = capacity if capacity is not None else round_capacity(n)
        cols = {}
        for name in names:
            col = make_any_column(types[name], list(data[name]), cap, device)
            if (isinstance(col, Column) and col.dictionary is None
                    and not col.values.dtype.is_floating_point
                    and col.values.dtype != torch.bool):
                lane = col.values[:n].cpu().numpy()
                if col.valid is not None:
                    lane = lane[col.valid[:n].cpu().numpy()]
                if lane.size:
                    col = Column(col.dtype, col.values, col.valid, None,
                                 (int(lane.min()), int(lane.max())))
            cols[name] = col
        sel = torch.arange(cap, device=device) < n
        return Batch(cols, sel, num_rows=n)

    @staticmethod
    def empty_like(schema: RowType, capacity: int,
                   device: torch.device) -> "Batch":
        from velox_tpu_torch import torch_dtype

        cols = {}
        for name, t in zip(schema.names, schema.children):
            if t.kind in (TypeKind.ARRAY, TypeKind.MAP, TypeKind.ROW):
                cols[name] = make_any_column(t, [], capacity, device)
                continue
            d = Dictionary([]) if t.is_string else None
            cols[name] = Column(
                t, torch.zeros((capacity,), dtype=torch_dtype(t.dtype),
                               device=device), None, d)
        return Batch(cols, torch.zeros((capacity,), dtype=torch.bool,
                                       device=device), num_rows=0)

    # ------------------------------------------------------ transformations
    def with_sel(self, sel: torch.Tensor,
                 num_rows: Optional[int] = None) -> "Batch":
        return Batch(self.columns, sel, num_rows)

    def with_column(self, name: str, col: Column) -> "Batch":
        cols = dict(self.columns)
        cols[name] = col
        return Batch(cols, self.sel, self.num_rows)

    def project(self, names: Iterable[str]) -> "Batch":
        return Batch({n: self.columns[n] for n in names}, self.sel,
                     self.num_rows)

    def gather(self, indices: torch.Tensor, sel: torch.Tensor,
               num_rows: Optional[int] = None) -> "Batch":
        """Row gather of every column (indices clipped; callers mask
        garbage rows via ``sel``)."""
        return Batch({n: c.gather(indices) for n, c in self.columns.items()},
                     sel, num_rows)

    # ------------------------------------------------------------- queries
    def selected_count(self) -> int:
        """Host sync: the number of active rows."""
        from velox_tpu_torch.utils.syncs import to_int

        return to_int(self.sel.sum())

    def compact_prefix(self, count: Optional[int] = None) -> "Batch":
        """``compact`` for a batch whose active rows are exactly
        ``[0, count)``: slices every column instead of gathering."""
        if count is None:
            count = self.selected_count()
        cap2 = round_capacity(max(count, 1))
        if cap2 >= self.capacity:
            return self
        cols = {n: _slice_column(c, cap2) for n, c in self.columns.items()}
        sel2 = torch.arange(cap2, device=self.device) < count
        return Batch(cols, sel2, count)

    def compact(self, count: Optional[int] = None) -> "Batch":
        """Gather the active rows, in order, to the front of a
        right-sized batch (one host sync for the count if not given)."""
        from velox_tpu_torch.ops.sort import pack_indices

        if count is None:
            count = self.selected_count()
        cap2 = round_capacity(max(count, 1))
        if cap2 >= self.capacity:
            return self
        idx = pack_indices(self.sel)[:cap2]
        sel2 = torch.arange(cap2, device=self.device) < count
        return self.gather(idx, sel2, count)

    # --------------------------------------------------------- host output
    def to_pydict(self, limit: Optional[int] = None) -> Dict[str, list]:
        """Materialize the active rows on the host. Decimals come out as
        ``decimal.Decimal``, strings as ``str``, dates as ``datetime.date``
        and timestamps as ``datetime.datetime``, as the JAX package's
        Arrow output gives them.
        One device-to-host copy per lane, after the selection."""
        from velox_tpu_torch.utils.syncs import nonzero, to_numpy

        idx = nonzero(self.sel)
        if limit is not None:
            idx = idx[:limit]
        out: Dict[str, list] = {}
        for name, col in self.columns.items():
            if isinstance(col, COMPLEX_COLUMNS):
                # arrays as lists, maps as (key, value) pair lists, rows
                # as dicts; the flat element columns go to the host whole
                out[name] = col.gather(idx).to_pylist()
                continue
            vals = to_numpy(col.values.index_select(0, idx))
            valid = (to_numpy(col.valid.index_select(0, idx))
                     if col.valid is not None else None)
            py = host_values(col.dtype, col.dictionary, vals)
            if valid is not None:
                py = [v if ok else None for v, ok in zip(py, valid)]
            out[name] = py
        return out

    def __repr__(self) -> str:
        fields = ", ".join(f"{n}:{c.dtype}" for n, c in self.columns.items())
        nr = self.num_rows if self.num_rows is not None else "?"
        return f"Batch[{fields}; rows={nr}/{self.capacity}]"


def harmonize_dictionaries(batches: Sequence[Batch]) -> List[Batch]:
    """Re-encode string columns so every batch shares ONE Dictionary per
    column: the merged sorted union, so codes stay ranks and sort keys
    stay valid. A no-op when the dictionaries are already shared, which
    the catalog's table-global dictionaries make the common case; they
    differ where an empty result made its own (``Batch.empty_like``)."""
    if len(batches) <= 1:
        return list(batches)
    out_cols = [dict(b.columns) for b in batches]
    changed = False
    for n in batches[0].names:
        parts = [b.columns[n] for b in batches]
        if isinstance(parts[0], COMPLEX_COLUMNS):
            continue
        dicts = [p.dictionary for p in parts if p.dictionary is not None]
        if not dicts:
            continue
        d0 = dicts[0]
        if len(dicts) == len(parts) and all(d is d0 for d in dicts[1:]):
            continue
        if len(dicts) != len(parts):
            raise ValueError(f"column {n}: dictionary-coded and plain "
                             "parts mixed")
        full = list({id(d): d for d in dicts if len(d)}.values())
        # empty dictionaries (empty results) hold no codes: when every
        # other part shares one dictionary, that one is the union
        merged = full[0] if len(full) == 1 else Dictionary(sorted(
            {str(v) for dd in dicts for v in dd.values}))
        for i, p in enumerate(parts):
            if p.dictionary is merged:
                continue
            table = np.asarray(
                [-1] + [merged.code_of(str(v))
                        for v in p.dictionary.values], dtype=np.int32)
            table_t = torch.from_numpy(table).to(p.values.device)
            idx = (p.values.to(torch.int64) + 1).clamp(0, len(table) - 1)
            # stats described the old code space: drop them
            out_cols[i][n] = Column(p.dtype, table_t.index_select(0, idx),
                                    p.valid, merged, None)
        changed = True
    if not changed:
        return list(batches)
    return [Batch(cols, b.sel, b.num_rows)
            for cols, b in zip(out_cols, batches)]


def concat_batches(batches: Sequence[Batch],
                   capacity: Optional[int] = None) -> Batch:
    """Concatenate same-schema batches into one padded batch. String
    columns are first brought onto one Dictionary per column
    (``harmonize_dictionaries``)."""
    if not batches:
        raise ValueError("concat of zero batches")
    if len(batches) == 1 and capacity is None:
        return batches[0]
    batches = harmonize_dictionaries(batches)
    total = sum(b.capacity for b in batches)
    cap = capacity if capacity is not None else round_capacity(total)
    if cap < total:
        raise ValueError(f"capacity {cap} < {total} rows")
    pad = cap - total
    device = batches[0].device

    def cat(parts: List[torch.Tensor], fill=0) -> torch.Tensor:
        if pad:
            parts = parts + [torch.full((pad,), fill, dtype=parts[0].dtype,
                                        device=device)]
        return torch.cat(parts)

    cols = {}
    for n in batches[0].names:
        parts = [b.columns[n] for b in batches]
        if isinstance(parts[0], COMPLEX_COLUMNS):
            cols[n] = _concat_complex(parts, pad)
            continue
        d = parts[0].dictionary
        valid = None
        if any(p.valid is not None for p in parts):
            valid = cat([p.validity() for p in parts], False)
        stats = None
        if all(p.stats is not None for p in parts):
            stats = (min(p.stats[0] for p in parts),
                     max(p.stats[1] for p in parts))
        cols[n] = Column(parts[0].dtype, cat([p.values for p in parts]),
                         valid, d, stats)
    sel = cat([b.sel for b in batches], False)
    nr = None
    if all(b.num_rows is not None for b in batches):
        nr = sum(b.num_rows for b in batches)
    return Batch(cols, sel, nr)


def _slice_column(c, cap2: int):
    """Any column cut to its first ``cap2`` rows; the flat element
    columns of an ARRAY or MAP are shared as they are."""
    cut = (lambda t: None if t is None else t[:cap2])
    if isinstance(c, ArrayColumn):
        return ArrayColumn(c.dtype, c.starts[:cap2], c.lengths[:cap2],
                           c.elements, cut(c.valid))
    if isinstance(c, MapColumn):
        return MapColumn(c.dtype, c.starts[:cap2], c.lengths[:cap2],
                         c.keys, c.values, cut(c.valid))
    if isinstance(c, RowColumn):
        return RowColumn(c.dtype, tuple(_slice_column(k, cap2)
                                        for k in c.children), cut(c.valid))
    return Column(c.dtype, c.values[:cap2], cut(c.valid), c.dictionary,
                  c.stats)


def _cat_padded(parts: List[torch.Tensor], pad: int, fill=0):
    if pad:
        parts = parts + [torch.full((pad,), fill, dtype=parts[0].dtype,
                                    device=parts[0].device)]
    return torch.cat(parts)


def _cat_valid(parts, pad: int) -> Optional[torch.Tensor]:
    if all(p.valid is None for p in parts):
        return None
    return _cat_padded([p.validity() for p in parts], pad, False)


def _concat_complex(parts, pad: int):
    """ARRAY, MAP and ROW parts concatenated: a ROW child by child; an
    ARRAY or MAP's offsets shift by the element capacity of the parts
    before it, and its flat columns concatenate once
    (``_concat_offset_columns``/``_concat_row_columns`` of the JAX
    package). Element string columns of different dictionaries are
    brought onto one first."""
    if isinstance(parts[0], RowColumn):
        kids = []
        for j in range(len(parts[0].children)):
            sub = [p.children[j] for p in parts]
            kids.append(_concat_complex(sub, pad)
                        if isinstance(sub[0], COMPLEX_COLUMNS)
                        else _concat_flat(sub, pad))
        return RowColumn(parts[0].dtype, tuple(kids),
                         _cat_valid(parts, pad))
    is_map = isinstance(parts[0], MapColumn)
    flats = [p.keys if is_map else p.elements for p in parts]
    offs, off = [], 0
    for f in flats:
        offs.append(off)
        off += f.capacity
    starts = _cat_padded([p.starts + o for p, o in zip(parts, offs)], pad)
    lengths = _cat_padded([p.lengths for p in parts], pad)
    valid = _cat_valid(parts, pad)

    def flat(cs):
        return (_concat_complex(cs, 0) if isinstance(cs[0], COMPLEX_COLUMNS)
                else _concat_flat(cs, 0))

    if is_map:
        return MapColumn(parts[0].dtype, starts, lengths, flat(flats),
                         flat([p.values for p in parts]), valid)
    return ArrayColumn(parts[0].dtype, starts, lengths, flat(flats), valid)


def _concat_flat(parts: List[Column], pad: int) -> Column:
    """Flat columns of one type concatenated (one dictionary)."""
    if any(p.dictionary is not None for p in parts):
        d0 = parts[0].dictionary
        if not all(p.dictionary is d0 for p in parts):
            sels = [torch.ones(p.capacity, dtype=torch.bool,
                               device=p.values.device) for p in parts]
            parts = [b.columns["c"] for b in harmonize_dictionaries(
                [Batch({"c": p}, s) for p, s in zip(parts, sels)])]
    return Column(parts[0].dtype, _cat_padded([p.values for p in parts],
                                               pad),
                  _cat_valid(parts, pad), parts[0].dictionary)
