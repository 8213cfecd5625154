"""Host syncs: every place the port waits on the device.

Each function here reads a device value on the host, which waits for the
work queued before it. Eager torch learns data-dependent sizes (a batch's
group count, a join's match total) only this way, so the count of such
waits is a per-query metric: ``reset()`` before a query, read ``count``
after it. On the CPU the same calls are counted, so a test can pin a
query's sync count without a card.
"""

from __future__ import annotations

import numpy as np
import torch

#: host reads since the last ``reset()``
count = 0


def reset() -> None:
    global count
    count = 0


def _tick() -> None:
    global count
    count += 1


def to_int(t: torch.Tensor) -> int:
    """A 0-d (or 1-element) device tensor as a Python int."""
    _tick()
    return int(t.item())


def any_true(t: torch.Tensor) -> bool:
    """Whether any element of a device tensor is true."""
    _tick()
    return bool(t.any().item())


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A device tensor copied to a host numpy array."""
    _tick()
    return t.cpu().numpy()


def nonzero(mask: torch.Tensor) -> torch.Tensor:
    """int64 positions of the True entries, in order (the output size is
    data-dependent, so torch waits for the device to learn it)."""
    _tick()
    return torch.nonzero(mask).squeeze(1)
