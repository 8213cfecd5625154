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


def _clip_take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return x.index_select(0, idx.clamp(0, x.shape[0] - 1))


# Reductions over arbitrary [start, end) ranges of a flat lane: window
# frames, and the elements of each row of an ARRAY column.

def range_minmax(v, start, end, op: str, ident, max_len: int):
    """Reduce [start, end) frames with a sparse table, level by level:
    level j holds op over [i, i + 2^j), and a frame of length L reads
    level floor(log2 L) twice (overlapping; min and max are idempotent).
    Only one level is alive at a time, and the levels stop at the longest
    frame ``max_len`` (a host-known bound)."""
    comb = torch.minimum if op == "min" else torch.maximum
    cap = v.shape[0]
    length = (end - start).clamp(min=0)
    res = torch.full(start.shape, ident, dtype=v.dtype, device=v.device)
    t = v
    w = 1
    while True:
        use = (length >= w) & (length < 2 * w)
        cand = comb(_clip_take(t, start), _clip_take(t, end - w))
        res = torch.where(use, cand, res)
        if 2 * w > max_len or w >= cap:
            break
        shifted = torch.cat([t[w:], torch.full((min(w, cap),), ident,
                                               dtype=t.dtype,
                                               device=t.device)])[:cap]
        t = comb(t, shifted)
        w <<= 1
    return res


def _two_sum(a, b):
    """``a + b`` as a rounded sum and its exact rounding error (Knuth's
    TwoSum)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def range_sum(v, start, end, max_len: int):
    """Sum of ``v`` over each [start, end) frame, exact to the last bit in
    practice and local to the frame.

    A difference of running sums lets one NaN or infinity poison every
    later frame and one large value wipe the digits of the small frames
    after it. Here NaN, +inf and -inf are counted per frame with int64
    prefixes, and the finite values are summed from disjoint
    power-of-two blocks: level j holds the sums of [i, i + 2^j), and a
    frame of length L reads one block for each set bit of L, lowest
    first. Each block carries its rounding error (TwoSum), so a frame's
    result is its double-double sum rounded once. One level is alive at
    a time, and the levels stop at the longest frame ``max_len``."""
    cap = v.shape[0]
    zero = torch.zeros_like(v)
    nan = torch.isnan(v)
    pinf = v == float("inf")
    ninf = v == float("-inf")
    fin = torch.where(nan | pinf | ninf, zero, v)
    length = (end - start).clamp(min=0)
    hi = torch.zeros(start.shape, dtype=v.dtype, device=v.device)
    lo = torch.zeros_like(hi)
    pos = start.clone()
    t, e = fin, zero
    w = 1
    while True:
        use = (length & w) != 0
        s, err = _two_sum(hi, _clip_take(t, pos))
        hi = torch.where(use, s, hi)
        lo = torch.where(use, lo + err + _clip_take(e, pos), lo)
        pos = torch.where(use, pos + w, pos)
        if 2 * w > max_len or w >= cap:
            break
        nxt = torch.cat([t[w:], zero[:min(w, cap)]])[:cap]
        nxe = torch.cat([e[w:], zero[:min(w, cap)]])[:cap]
        t, err = _two_sum(t, nxt)
        e = e + nxe + err
        w <<= 1
    out = hi + lo

    def count(flag):
        c = torch.cat([torch.zeros(1, dtype=torch.int64,
                                   device=flag.device),
                       torch.cumsum(flag.to(torch.int64), 0)])
        return _clip_take(c, end) - _clip_take(c, start)

    n_nan, n_pinf, n_ninf = count(nan), count(pinf), count(ninf)
    out = torch.where(n_pinf > 0, torch.full_like(hi, float("inf")), out)
    out = torch.where(n_ninf > 0, torch.full_like(hi, float("-inf")), out)
    return torch.where((n_nan > 0) | ((n_pinf > 0) & (n_ninf > 0)),
                       torch.full_like(hi, float("nan")), out)


def run_owners(starts: torch.Tensor, live: torch.Tensor, n: int
               ) -> torch.Tensor:
    """For each of ``n`` slots, the last live row whose start lies at or
    before it (-1 before the first), where ``starts`` ascend strictly over
    the live rows (the offsets of a compact layout). Each live row marks
    its start, a prefix sum numbers the runs, and one gather reads the
    row: no ``cummax``, which runs hundreds of milliseconds over 2^26
    slots on the H100."""
    from velox_tpu_torch.ops.sort import pack_indices

    at = torch.where(live, starts.to(torch.int64),
                     torch.full((), n, dtype=torch.int64,
                                device=live.device)).clamp(0, n)
    head = torch.zeros(n + 1, dtype=torch.int64, device=live.device)
    head.index_add_(0, at, torch.ones_like(at))
    seg = torch.cumsum(head[:n], 0) - 1
    rows = pack_indices(live)
    return torch.where(seg >= 0, rows.index_select(0, seg.clamp(min=0)),
                       torch.full_like(seg, -1))
