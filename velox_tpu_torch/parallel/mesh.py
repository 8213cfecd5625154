"""The shard mesh (the port of ``velox_tpu/parallel/mesh.py``).

One data axis (``"d"``); each shard runs the same steps on its part of
the data, as each of a velox Task's parallel pipelines does
(velox/exec/Task.h:207). The
JAX package's mesh has one device a shard and asserts ``n <= devices``;
here shards go round robin over the visible devices of the requested
kind, so eight shards live on one card (all on ``cuda:0``), or on the
CPU in the tests.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch

from velox_tpu_torch import resolve_device


class Mesh:
    """``devices[i]`` holds shard ``i``; ``axis`` names the data axis."""

    def __init__(self, devices: Sequence[torch.device], axis: str = "d"):
        if not devices:
            raise ValueError("a mesh needs at least one shard")
        self.devices: List[torch.device] = [torch.device(d) for d in devices]
        self.axis = axis

    @property
    def size(self) -> int:
        return len(self.devices)

    def __len__(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({self.axis}={self.size}: {self.devices})"


def _visible(kind: torch.device) -> List[torch.device]:
    if kind.type == "cuda":
        if kind.index is not None:
            return [kind]
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [kind]


def device_count(device: Union[str, torch.device, None] = None) -> int:
    """The visible devices of the kind (default: CUDA cards; raises
    without one)."""
    return len(_visible(resolve_device(device)))


def make_mesh(n: Optional[int] = None, axis: str = "d",
              device: Union[str, torch.device, None] = None) -> Mesh:
    """``n`` shards (default: one a visible device) round robin over the
    visible devices of ``device``'s kind. ``device=None`` means the CUDA
    cards and raises without one; pass ``device="cpu"`` for the CPU."""
    devs = _visible(resolve_device(device))
    n = len(devs) if n is None else int(n)
    if n < 1:
        raise ValueError(f"a mesh needs at least one shard, not {n}")
    return Mesh([devs[i % len(devs)] for i in range(n)], axis)
