"""Group-id assignment (the kArray mode of the JAX package's
``ops/groupby.py``).

``group_ids_array``: when every grouping key is dictionary-coded and the
product of the dictionary sizes is small, a row's group id is the
mixed-radix combination of its keys' value ids (velox VectorHasher value-id
mode). Ids are stable across batches, so accumulators persist. Inactive
or out-of-range rows get the sentinel id ``num_groups``.
"""

from __future__ import annotations

from typing import Sequence

import torch


def group_ids_array(value_ids: Sequence[torch.Tensor],
                    radices: Sequence[int], sel: torch.Tensor,
                    num_groups: int) -> torch.Tensor:
    """int32 gid per row: sum of ``value_ids[k] * stride_k``, sentinel
    ``num_groups`` where unselected or out of range."""
    gid = torch.zeros(sel.shape, dtype=torch.int32, device=sel.device)
    stride = 1
    for vid, radix in zip(value_ids, radices):
        gid = gid + vid.to(torch.int32) * stride
        stride *= radix
    ok = sel & (gid >= 0) & (gid < num_groups)
    return torch.where(ok, gid, torch.full_like(gid, num_groups))
