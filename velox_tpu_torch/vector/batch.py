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

import torch

from velox_tpu_torch.types.types import (
    DecimalType, RowType, TypeKind, row_type,
)
from velox_tpu_torch.vector.column import Column, Dictionary

#: batch capacities are padded to a multiple of this
LANE = 128

_EPOCH = datetime.date(1970, 1, 1)
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

    def project(self, names: Iterable[str]) -> "Batch":
        return Batch({n: self.columns[n] for n in names}, self.sel,
                     self.num_rows)

    def gather(self, indices: torch.Tensor, sel: torch.Tensor,
               num_rows: Optional[int] = None) -> "Batch":
        """Row gather of every column (indices clipped; callers mask
        garbage rows via ``sel``)."""
        return Batch({n: c.gather(indices) for n, c in self.columns.items()},
                     sel, num_rows)

    # --------------------------------------------------------- host output
    def to_pydict(self, limit: Optional[int] = None) -> Dict[str, list]:
        """Materialize the active rows on the host. Decimals come out as
        ``decimal.Decimal``, strings as ``str`` and dates as
        ``datetime.date``, as the JAX package's Arrow output gives them.
        One device-to-host copy per lane, after the selection."""
        idx = torch.nonzero(self.sel).squeeze(1)
        if limit is not None:
            idx = idx[:limit]
        out: Dict[str, list] = {}
        for name, col in self.columns.items():
            vals = col.values.index_select(0, idx).cpu().numpy()
            valid = (col.valid.index_select(0, idx).cpu().numpy()
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


def concat_batches(batches: Sequence[Batch],
                   capacity: Optional[int] = None) -> Batch:
    """Concatenate same-schema batches into one padded batch. String
    columns must share one Dictionary (the catalog's dictionaries are
    table-global, and aggregation keys carry theirs through)."""
    if not batches:
        raise ValueError("concat of zero batches")
    if len(batches) == 1 and capacity is None:
        return batches[0]
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
        if any(p.dictionary is not d for p in parts):
            raise ValueError(f"column {n}: batches carry different "
                             "dictionaries")
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
