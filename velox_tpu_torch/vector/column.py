"""Column: fixed-width device value lane + validity + optional dictionary.

The port of ``velox_tpu/vector/column.py`` (flat and dictionary columns;
complex types wait for a later slice). ``valid[i] == True`` means row i
is non-null; ``valid is None`` means all rows are non-null. String
columns hold int32 codes into a host-side :class:`Dictionary`, with code
-1 for null or padding.
"""

from __future__ import annotations

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
