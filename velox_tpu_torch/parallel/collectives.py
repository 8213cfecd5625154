"""Collectives over the shards of a mesh: the counterparts of
``jax.lax.all_to_all``, ``all_gather`` and a reduction of flags.

Each takes one tensor (or one list of tensors) a shard and returns one a
shard on its device. A tensor moves to another device with
``.to(device, non_blocking=True)``, which CUDA copies device to device
(NVLink or PCIe peer access), never staged on the host; shards on the
same device exchange nothing but views.
"""

from __future__ import annotations

from typing import List, Sequence

import torch


def _on(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    return t if t.device == device else t.to(device, non_blocking=True)


def all_to_all(send: Sequence[Sequence[torch.Tensor]],
               devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """``send[s][r]`` is what shard ``s`` sends shard ``r``; shard ``r``
    receives ``cat_s send[s][r]`` (rows of earlier shards first), on
    ``devices[r]``."""
    n = len(devices)
    out = []
    for r in range(n):
        parts = [_on(send[s][r], devices[r]) for s in range(len(send))]
        out.append(parts[0] if len(parts) == 1 else torch.cat(parts))
    return out


def all_gather(xs: Sequence[torch.Tensor],
               devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """Every shard receives the shards' tensors stacked in shard order
    (``(n,) + shape``)."""
    out, cache = [], {}
    for d in devices:
        if d not in cache:
            cache[d] = torch.stack([_on(x, d) for x in xs])
        out.append(cache[d])
    return out


def any_reduce(flags: Sequence[torch.Tensor],
               device: torch.device) -> torch.Tensor:
    """The OR of the shards' flag tensors, on ``device``."""
    out = _on(flags[0], device)
    for f in flags[1:]:
        out = out | _on(f, device)
    return out
