"""Distributed hash aggregation: partial -> hash shuffle -> final (the
port of ``velox_tpu/parallel/aggregate.py``).

Every shard groups its rows (sort-based, ``ops/groupby.py``) and
accumulates partial lanes, the groups (not the raw rows) are shuffled
by key hash, and each shard combines and extracts the groups it
received: velox's partial aggregation -> PartitionedOutput -> Exchange ->
final aggregation fragment chain (velox/exec/AggregateCompanionAdapter.h)
over the mesh. Keyless, each shard's one partial group is gathered to
every shard, which all hold the same result.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from velox_tpu_torch.functions.aggregates import init_lane, lookup_aggregate
from velox_tpu_torch.ops.groupby import group_ids_sorted
from velox_tpu_torch.parallel.collectives import all_gather
from velox_tpu_torch.parallel.shuffle import hash_repartition
from velox_tpu_torch.types import DataType


def _devices(mesh):
    return list(getattr(mesh, "devices", mesh))


def make_distributed_aggregate(
    mesh,
    num_keys: int,
    specs: Sequence[Tuple[str, Optional[DataType]]],
):
    """The aggregation step over every shard of ``mesh``.

    ``specs``: (aggregate name, input type, or None for ``count(*)``).
    The step takes one entry a shard in each argument::

        step(key_vals[s]: [lanes], key_valids[s]: [valid | None],
             agg_vals[s]: [values | None], sel[s])

    and returns, a shard, ``(group key lanes, their valid masks, results,
    result valid masks, live groups)``: the groups whose key hashes to
    that shard, in key order (keyless: the one global group, slot 0, on
    every shard)."""
    devices = _devices(mesh)
    n = len(devices)
    fns = [lookup_aggregate(name) for name, _ in specs]
    arg_types = [at for _, at in specs]

    def init(fn, at, cap, device):
        return tuple(init_lane(lane, at, cap, device) for lane in fn.lanes)

    def keyless(agg_vals, sel):
        heads = []   # per aggregate, per lane: each shard's slot 0
        for i, (fn, at) in enumerate(zip(fns, arg_types)):
            per_shard = []
            for vals, s in zip(agg_vals, sel):
                gids = group_ids_sorted([], s)[0]
                accs = fn.accumulate(init(fn, at, s.shape[0], s.device),
                                     gids, vals[i], s)
                per_shard.append([a[0] for a in accs])
            heads.append([all_gather([h[li] for h in per_shard], devices)
                          for li in range(len(fn.lanes))])
        out = []
        for r, dev in enumerate(devices):
            gsel = torch.zeros(n, dtype=torch.bool, device=dev)
            gsel[0] = True
            results, valids = [], []
            for i, (fn, at) in enumerate(zip(fns, arg_types)):
                final = fn.combine(
                    init(fn, at, n, dev), torch.zeros(n, dtype=torch.int64,
                                                      device=dev),
                    tuple(heads[i][li][r] for li in range(len(fn.lanes))),
                    torch.ones(n, dtype=torch.bool, device=dev))
                v, va = fn.extract(final, gsel)
                results.append(v)
                valids.append(va)
            out.append(([], [], results, valids, gsel))
        return out

    def step(key_vals, key_valids, agg_vals, sel):
        if num_keys == 0:
            return keyless(agg_vals, sel)
        # ---- local partial aggregation, one shard at a time
        payloads, key_cols, group_sels = [], [], []
        lane_splits: List[int] = []
        has_valid = [va is not None for va in key_valids[0]]
        for kv, kva, av, s in zip(key_vals, key_valids, agg_vals, sel):
            gids, group_rows, group_sel, _ = group_ids_sorted(
                list(zip(kv, kva)), s)
            lanes, lane_splits = [], []
            for fn, at, vals in zip(fns, arg_types, av):
                accs = fn.accumulate(init(fn, at, s.shape[0], s.device),
                                     gids, vals, s)
                lane_splits.append(len(accs))
                lanes.extend(accs)
            gk = [v.index_select(0, group_rows) for v in kv]
            gkv = [None if va is None else va.index_select(0, group_rows)
                   for va in kva]
            payloads.append(gk + [va for va in gkv if va is not None]
                            + lanes)
            key_cols.append(list(zip(gk, gkv)))
            group_sels.append(group_sel)
        # ---- shuffle the groups by key hash
        recv, recv_sel, _ = hash_repartition(payloads, key_cols, group_sels,
                                             devices, pad=True)
        # ---- final aggregation of each shard's groups
        out = []
        for lanes_in, rsel in zip(recv, recv_sel):
            rk = lanes_in[:num_keys]
            off = num_keys
            rkv: List[Optional[torch.Tensor]] = []
            for hv in has_valid:
                rkv.append(lanes_in[off] if hv else None)
                off += int(hv)
            gids2, group_rows2, group_sel2, _ = group_ids_sorted(
                list(zip(rk, rkv)), rsel)
            results, valids = [], []
            for fn, at, nsl in zip(fns, arg_types, lane_splits):
                accs = fn.combine(init(fn, at, rsel.shape[0], rsel.device),
                                  gids2, tuple(lanes_in[off:off + nsl]),
                                  rsel)
                off += nsl
                v, va = fn.extract(accs, group_sel2)
                results.append(v)
                valids.append(va)
            out.append(([v.index_select(0, group_rows2) for v in rk],
                        [None if va is None
                         else va.index_select(0, group_rows2) for va in rkv],
                        results, valids, group_sel2))
        return out

    return step
