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


def compact_indices(sel: torch.Tensor) -> torch.Tensor:
    """Stable partition of the active rows to the front."""
    return sort_indices([], sel)


def top_n_indices(keys: Sequence[SortKey], sel: torch.Tensor, n: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The first ``n`` rows in sort order: ``(indices, out_sel)``, each of
    length ``min(n, capacity)``. The sort is stable, so rows that tie on
    every key keep their input order, as the reference's stable sort
    leaves them."""
    top = sort_indices(keys, sel)[:n]
    return top, sel.index_select(0, top)


def pack_indices(sel: torch.Tensor, fill: Optional[int] = None
                 ) -> torch.Tensor:
    """int64 positions of the True entries of ``sel``, front-packed in
    order and padded with ``fill`` (default: the capacity) to the
    capacity. No host sync: each active row scatters its index to its
    rank, inactive rows to a spare slot past the end."""
    cap = sel.shape[0]
    if fill is None:
        fill = cap
    rank = torch.cumsum(sel, 0) - 1
    slot = torch.where(sel, rank, torch.full_like(rank, cap))
    out = torch.full((cap + 1,), fill, dtype=torch.int64, device=sel.device)
    out.scatter_(0, slot, torch.arange(cap, device=sel.device))
    return out[:cap]
