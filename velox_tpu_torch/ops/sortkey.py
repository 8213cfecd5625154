"""Order-preserving sort-key encoding (the port of ``ops/sortkey.py``).

Every orderable scalar lane maps to an integer whose signed order equals
the SQL order of the values: integers and dictionary codes (ranks of the
catalog's sorted dictionaries) pass through, floats get the sign-flip
trick on their bits. Descending order is bitwise NOT. Nulls are a
separate preceding key (0/1), so no value collides with the null rank.
"""

from __future__ import annotations

from typing import List, Optional

import torch


def _float_key(values: torch.Tensor) -> torch.Tensor:
    """Float bits as a signed integer in the float's total order (NaN
    greatest, -0.0 == +0.0)."""
    itype = torch.int32 if values.dtype == torch.float32 else torch.int64
    low = (1 << 31) - 1 if itype == torch.int32 else (1 << 63) - 1
    canon = torch.where(torch.isnan(values),
                        torch.full_like(values, float("nan")).abs(),
                        values + 0.0)  # -0.0 + 0.0 == +0.0
    i = canon.view(itype)
    return i ^ torch.where(i < 0, torch.full_like(i, low),
                           torch.zeros_like(i))


def encode_sort_key(values: torch.Tensor, valid: Optional[torch.Tensor], *,
                    descending: bool = False,
                    nulls_first: bool = False) -> List[torch.Tensor]:
    """One column as 1-2 integer key operands (null rank, value key),
    compared lexicographically."""
    if values.dtype.is_floating_point:
        keys = [_float_key(values)]
    elif values.dtype == torch.bool or values.element_size() <= 4:
        keys = [values.to(torch.int32)]
    else:
        keys = [values.to(torch.int64)]
    if descending:
        keys = [~k for k in keys]
    if valid is None:
        return keys
    null_rank = torch.where(
        valid, torch.tensor(1 if nulls_first else 0, dtype=torch.int32,
                            device=valid.device),
        torch.tensor(0 if nulls_first else 1, dtype=torch.int32,
                     device=valid.device))
    return [null_rank] + keys
