"""Hash and range shuffles between the shards of a mesh (the port of
``velox_tpu/parallel/shuffle.py``).

The JAX package buckets each device's rows into a fixed
``(n_dev, cap_per_dest)`` send tensor whose default ``cap_per_dest`` is
the shard's whole capacity, so every shard sends ``n_dev`` times its
padded rows, and ``jax.lax.all_to_all`` exchanges them. The port keeps
that layout in ``bucket_by_destination`` and sizes each destination by
its real row count instead (``repartition``): one host read of the
``(shards, destinations)`` counts per shuffle (the "optimistic" sizing
the reference's docstring names), after which each shard's rows, sorted
stably by destination, go out in slices. Shard ``r`` receives, in shard
order, the rows every shard sent it, in their order there: the rows the
reference receives, without its padding.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from velox_tpu_torch.ops.hash import hash_columns, partition_ids
from velox_tpu_torch.parallel.collectives import all_to_all
from velox_tpu_torch.utils import syncs
from velox_tpu_torch.vector.batch import (
    Batch, harmonize_dictionaries, round_capacity,
)
from velox_tpu_torch.vector.column import COMPLEX_COLUMNS, Column

#: (start, end, bytes) of every shuffle since ``shuffle_stats``: CUDA
#: events on a card, ``perf_counter`` seconds on the CPU
_SHUFFLES: list = []


def _clock(device: torch.device):
    if device.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter()


def shuffle_stats() -> Tuple[int, float, int]:
    """(bytes, seconds, shuffles) of the shuffles since the last call
    (one synchronize on a card)."""
    if any(not isinstance(s, float) for s, _, _ in _SHUFFLES):
        torch.cuda.synchronize()
    nbytes, sec = 0, 0.0
    for start, end, n in _SHUFFLES:
        nbytes += n
        sec += (end - start if isinstance(start, float)
                else start.elapsed_time(end) / 1e3)
    count = len(_SHUFFLES)
    _SHUFFLES.clear()
    return nbytes, sec, count


def bucket_by_destination(
    arrays: Sequence[torch.Tensor],
    dest: torch.Tensor,
    sel: torch.Tensor,
    n_dest: int,
    cap_per_dest: int,
) -> Tuple[List[torch.Tensor], torch.Tensor, torch.Tensor]:
    """One shard's rows in the reference's ``(n_dest, cap_per_dest)`` send
    layout, stable by destination. Rows past a destination's capacity are
    counted, never silently dropped: returns (bucketed arrays, valid
    ``(n_dest, cap)``, overflow count)."""
    cap = dest.shape[0]
    device = dest.device
    d = torch.where(sel, dest.to(torch.int64),
                    torch.full_like(dest, n_dest, dtype=torch.int64))
    perm = torch.sort(d, stable=True).indices
    sorted_d = d.index_select(0, perm)
    starts = torch.searchsorted(
        sorted_d, torch.arange(n_dest, dtype=torch.int64, device=device))
    pos = torch.arange(cap, device=device) - starts.index_select(
        0, sorted_d.clamp(0, n_dest - 1))
    live = sorted_d < n_dest
    ok = live & (pos < cap_per_dest)
    overflow = (live & (pos >= cap_per_dest)).sum()
    spare = n_dest * cap_per_dest
    slot = torch.where(ok, sorted_d * cap_per_dest + pos,
                       torch.full_like(pos, spare))
    out = []
    for a in arrays:
        buf = torch.zeros(spare + 1, dtype=a.dtype, device=device)
        buf.index_copy_(0, slot, a.index_select(0, perm))
        out.append(buf[:spare].reshape(n_dest, cap_per_dest))
    valid = torch.zeros(spare + 1, dtype=torch.bool, device=device)
    valid.index_fill_(0, slot, True)
    return out, valid[:spare].reshape(n_dest, cap_per_dest), overflow


def repartition(
    arrays: Sequence[Sequence[torch.Tensor]],
    dest: Sequence[torch.Tensor],
    sel: Sequence[torch.Tensor],
    devices: Sequence[torch.device],
    pad: bool = False,
) -> Tuple[List[List[torch.Tensor]], List[int]]:
    """Move each shard's selected rows to their destination shard.

    ``arrays[s]`` are shard ``s``'s lanes, ``dest[s]`` each row's
    destination and ``sel[s]`` its live rows. Returns ``recv[r]`` (the
    lanes of the rows shard ``r`` receives, in shard order and then row
    order) and each shard's row count, read on the host once for the
    whole shuffle. ``pad`` rounds each received lane up to a batch
    capacity (zeros past the rows)."""
    n = len(devices)
    home = devices[0]
    start = _clock(home)
    perms, counts = [], []
    for d, s in zip(dest, sel):
        dd = torch.where(s, d.to(torch.int64),
                         torch.full_like(d, n, dtype=torch.int64))
        perms.append(torch.sort(dd, stable=True).indices)
        counts.append(torch.bincount(dd, minlength=n + 1)[:n])
    table = syncs.to_numpy(torch.stack([c.to(home) for c in counts]))
    recv_rows = table.sum(axis=0).astype(np.int64).tolist()
    sent = table.sum(axis=1).astype(np.int64)
    recv: List[List[torch.Tensor]] = [[] for _ in range(n)]
    nbytes = 0
    for j in range(len(arrays[0]) if arrays else 0):
        send = []
        for s, lanes in enumerate(arrays):
            a = lanes[j].index_select(0, perms[s][:int(sent[s])])
            nbytes += a.numel() * a.element_size()
            send.append(list(torch.split(a, table[s].tolist())))
        if pad:
            # zeros up to each shard's capacity, received last
            like = arrays[0][j]
            send.append([torch.zeros(
                (round_capacity(rows) - rows,) + tuple(like.shape[1:]),
                dtype=like.dtype, device=d)
                for rows, d in zip(recv_rows, devices)])
        for r, lane in enumerate(all_to_all(send, devices)):
            recv[r].append(lane)
    _SHUFFLES.append((start, _clock(home), nbytes))
    return recv, recv_rows


def hash_destinations(key_cols, n: int) -> torch.Tensor:
    """Each row's destination shard by its key hash (the reference's
    ``partition_ids(hash_columns(...))``)."""
    return partition_ids(hash_columns(key_cols), n)


def hash_repartition(
    arrays: Sequence[Sequence[torch.Tensor]],
    key_cols: Sequence[Sequence[Tuple[torch.Tensor, Optional[torch.Tensor]]]],
    sel: Sequence[torch.Tensor],
    devices: Sequence[torch.device],
    pad: bool = False,
) -> Tuple[List[List[torch.Tensor]], List[torch.Tensor], int]:
    """Repartition every shard's rows by key hash: equal keys land on one
    shard, the contract the distributed aggregation and window rely on.
    Returns (received lanes per shard, received valid masks, overflow:
    always 0, since sends are sized). Unpadded, every received row is
    valid; ``pad`` rounds each shard's lanes up to a batch capacity."""
    n = len(devices)
    dest = [hash_destinations(kc, n) for kc in key_cols]
    recv, rows = repartition(arrays, dest, sel, devices, pad)
    valid = [torch.arange(lanes[0].shape[0] if lanes else r,
                          device=d) < r
             for lanes, r, d in zip(recv, rows, devices)]
    return recv, valid, 0


def shuffle_batches(shards: Sequence[Batch], dest: Sequence[torch.Tensor],
                    devices: Sequence[torch.device]) -> List[Batch]:
    """Each shard's batch split by row destination and reassembled: shard
    ``r`` gets one batch of the rows sent to it (capacity rounded up, the
    rows a dense prefix), string columns on one dictionary."""
    shards = harmonize_dictionaries(list(shards))
    names = shards[0].names
    layout = []  # (name, has valid lane)
    for nm in names:
        c = shards[0].column(nm)
        if isinstance(c, COMPLEX_COLUMNS):
            raise NotImplementedError(
                f"shuffling the ARRAY/MAP/ROW column {nm}")
        layout.append((nm, any(b.column(nm).valid is not None
                               for b in shards)))
    arrays = []
    for b in shards:
        lanes = []
        for nm, has_valid in layout:
            c = b.column(nm)
            lanes.append(c.values)
            if has_valid:
                lanes.append(c.validity())
        arrays.append(lanes)
    recv, rows = repartition(arrays, dest, [b.sel for b in shards], devices,
                             pad=True)
    out = []
    for r, lanes in enumerate(recv):
        cols, i = {}, 0
        for nm, has_valid in layout:
            c0 = shards[0].column(nm)
            vals = lanes[i]
            i += 1
            valid = None
            if has_valid:
                valid = lanes[i]
                i += 1
            cols[nm] = Column(c0.dtype, vals, valid, c0.dictionary, c0.stats)
        cap = lanes[0].shape[0] if lanes else round_capacity(rows[r])
        sel = torch.arange(cap, device=devices[r]) < rows[r]
        out.append(Batch(cols, sel, rows[r]))
    return out
