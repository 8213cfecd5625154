"""Batch: a set of named Columns + a device selection mask.

The port of ``velox_tpu/vector/batch.py``: ``capacity`` is padded (lane
multiples at ingest, powers of two for intermediates), ``sel`` is a device
bool mask of active rows, and ``num_rows`` is an optional host-known row
count. Batches are immutable; transformations return new Batches sharing
unchanged tensors.
"""

from __future__ import annotations

import datetime
import decimal
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from velox_tpu_torch.types.types import (
    DecimalType, RowType, TypeKind, row_type,
)
from velox_tpu_torch.vector.column import Column, Dictionary

#: batch capacities are padded to a multiple of this
LANE = 128

_EPOCH = datetime.date(1970, 1, 1)
_EPOCH_TS = datetime.datetime(1970, 1, 1)
_DEC_CTX = decimal.Context(prec=60)


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
    def empty_like(schema: RowType, capacity: int,
                   device: torch.device) -> "Batch":
        from velox_tpu_torch import torch_dtype

        cols = {}
        for name, t in zip(schema.names, schema.children):
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
        cols = {n: Column(c.dtype, c.values[:cap2],
                          None if c.valid is None else c.valid[:cap2],
                          c.dictionary, c.stats)
                for n, c in self.columns.items()}
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
            vals = to_numpy(col.values.index_select(0, idx))
            valid = (to_numpy(col.valid.index_select(0, idx))
                     if col.valid is not None else None)
            if col.dictionary is not None:
                py = list(col.dictionary.decode(vals))
            elif isinstance(col.dtype, DecimalType):
                s = col.dtype.scale
                py = [decimal.Decimal(int(v)).scaleb(-s, _DEC_CTX)
                      for v in vals.tolist()]
            elif col.dtype.kind == TypeKind.DATE:
                py = [_EPOCH + datetime.timedelta(days=int(v))
                      for v in vals.tolist()]
            elif col.dtype.kind == TypeKind.TIMESTAMP:
                py = [_EPOCH_TS + datetime.timedelta(microseconds=int(v))
                      for v in vals.tolist()]
            else:
                py = vals.tolist()
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
