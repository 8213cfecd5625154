"""Multi-key stable sort over fixed-capacity batches (the port of
``ops/sort.py``).

Keys are encoded to integer operands (sortkey.py) behind a leading
"inactive" operand, so unselected rows sort to the back. torch has no
multi-operand sort, so the lexicographic order comes from chained STABLE
sorts, least significant operand first.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from velox_tpu_torch.ops.sortkey import encode_sort_key

#: (values, valid, descending, nulls_first)
SortKey = Tuple[torch.Tensor, Optional[torch.Tensor], bool, bool]


def _operands(keys: Sequence[SortKey],
              sel: torch.Tensor) -> List[torch.Tensor]:
    ops: List[torch.Tensor] = [(~sel).to(torch.int32)]
    for values, valid, desc, nf in keys:
        ops.extend(encode_sort_key(values, valid, descending=desc,
                                   nulls_first=nf))
    return ops


def lex_sort(ops: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stable lexicographic permutation of equal-length operands."""
    n = ops[0].shape[0]
    perm = torch.arange(n, dtype=torch.int64, device=ops[0].device)
    for op in reversed(ops):
        _, idx = torch.sort(op.index_select(0, perm), stable=True)
        perm = perm.index_select(0, idx)
    return perm


def sort_indices(keys: Sequence[SortKey], sel: torch.Tensor) -> torch.Tensor:
    """Stable sort; returns the int64 permutation with active rows first:
    ``out[i]`` is the original row of the i-th row in sort order."""
    return lex_sort(_operands(keys, sel))
