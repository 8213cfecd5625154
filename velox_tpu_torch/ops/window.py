"""Window-function building blocks over sorted partitions (the port of
``ops/window.py``).

Sort once by (partition keys, sort keys); then every window function is a
segmented scan or a gather against partition and peer boundaries. The
reference builds these from associative scans with a reset flag; torch
has none, so segment boundaries come from a prefix sum of the change
flags and one scatter and gather (no ``cummax``/``cummin``, no read of a
device value on the host), and the scans run on ``segment_scan``
(``ops/groupby.py``): exact int64 prefix sums for integer sums, a
log-step scan for floats and min/max.
"""

from __future__ import annotations

from typing import Tuple

import torch

from velox_tpu_torch.ops.groupby import segment_scan


def _segment_numbers(seg_change: torch.Tensor) -> torch.Tensor:
    """Per row, how many segment heads lie at or before it (int64)."""
    return torch.cumsum(seg_change, 0)


def segment_starts(seg_change: torch.Tensor) -> torch.Tensor:
    """For each row, index of its segment's first row (sorted layout).

    ``seg_change[i]`` is True when row i opens a new segment; rows before
    the first head belong to a segment that starts at 0.
    """
    n = seg_change.shape[0]
    idx = torch.arange(n, dtype=torch.int64, device=seg_change.device)
    seg = _segment_numbers(seg_change)
    # table[k] = the k-th head's index (1-based k); table[0] = 0
    table = torch.zeros(n + 2, dtype=torch.int64, device=seg_change.device)
    table.scatter_(0, torch.where(seg_change, seg,
                                  torch.full_like(seg, n + 1)), idx)
    return table.index_select(0, seg)


def segment_ends(seg_change: torch.Tensor,
                 n_valid: torch.Tensor) -> torch.Tensor:
    """For each row, one past its segment's last row (sorted layout),
    clipped to ``n_valid``."""
    n = seg_change.shape[0]
    idx = torch.arange(n, dtype=torch.int64, device=seg_change.device)
    seg = _segment_numbers(seg_change)
    # the next segment's head, else n
    table = torch.full((n + 2,), n, dtype=torch.int64,
                       device=seg_change.device)
    table.scatter_(0, torch.where(seg_change, seg,
                                  torch.full_like(seg, n + 1)), idx)
    table[n + 1] = n
    return torch.minimum(table.index_select(0, seg + 1),
                         n_valid.to(torch.int64))


def segmented_cumsum(values: torch.Tensor,
                     seg_change: torch.Tensor) -> torch.Tensor:
    """Inclusive running sum that resets at segment starts."""
    return segment_scan(values, seg_change, "add")


def segmented_scan(values: torch.Tensor, seg_change: torch.Tensor,
                   op: str) -> torch.Tensor:
    """Inclusive segmented scan with ``op`` in add, min, max."""
    return segment_scan(values, seg_change, op)


def row_numbers(part_change: torch.Tensor) -> torch.Tensor:
    """1-based row number within each partition (sorted layout)."""
    idx = torch.arange(part_change.shape[0], dtype=torch.int64,
                       device=part_change.device)
    return idx - segment_starts(part_change) + 1


def ranks(part_change: torch.Tensor, peer_change: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rank, dense_rank), 1-based, sorted layout.

    ``peer_change`` marks rows whose sort key differs from the previous
    row (a new peer group); partition starts are always peer changes.
    """
    new_peer = part_change | peer_change
    rank = segment_starts(new_peer) - segment_starts(part_change) + 1
    dense = segmented_cumsum(new_peer.to(torch.int64), part_change)
    return rank, dense
