"""Distributed probe pipelines: scan -> hash joins -> transforms ->
aggregation over the shards of a mesh (the port of
``velox_tpu/parallel/pipeline.py``).

Build sides run serially and every shard probes the same build (a
replica on each other device: a broadcast join, small side by plan
construction). The probe scan is cut into one part a shard, and each
shard runs the probe -> transform -> partial-aggregation chain on its
rows with the serial operators' own per-batch code (``FilterOp``,
``ProjectOp``, ``HashProbeOp.runs``/``expand``,
``HashAggregationOp.make_generic_fn``), so the two paths cannot drift. An
expansion join reads every shard's match total in one host sync, the
counterpart of the reference's one sync for a shared capacity
(velox/exec/HashProbe.cpp:796 output sizing). Right and full joins OR
the shards' matched flags once and emit the unmatched build rows after
the sharded stream.

Chains handled, as in the reference: TableScan [-> semi/anti probe |
inner or left probe | filter | project]* [-> right/full probe] [->
single-step or PARTIAL hash aggregation], then, without an aggregation,
a window partitioned by keys (a hash shuffle by the partition keys, the
window per shard), a top-K prune before a TopN or OrderBy + Limit, or an
ORDER BY range-partitioned on its first key (splitters sampled on the
device) and sorted per shard. What follows runs serially on the
gathered result.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, List, Optional

import torch

from velox_tpu_torch.plan.nodes import AggStep, JoinType as JT
from velox_tpu_torch.utils import syncs
from velox_tpu_torch.vector.batch import (
    LANE, Batch, concat_batches, harmonize_dictionaries, round_capacity,
)
from velox_tpu_torch.vector.column import COMPLEX_COLUMNS, Column

#: rows of the first key sampled for the range splitters
_SPLITTER_SAMPLE = 1 << 16


# ------------------------------------------------------------- placement

def move(obj, device: torch.device, memo: Optional[dict] = None):
    """``obj`` with its tensors on ``device`` (copied device to device,
    never through the host): tensors, columns, batches, containers and
    the plain objects of a join bridge. What is already there is
    shared."""
    memo = {} if memo is None else memo
    key = id(obj)
    if key in memo:
        return memo[key]
    if isinstance(obj, torch.Tensor):
        out = obj if obj.device == device else obj.to(device,
                                                       non_blocking=True)
    elif isinstance(obj, Batch):
        out = Batch({n: move(c, device, memo) for n, c in obj.columns.items()},
                    move(obj.sel, device, memo), obj.num_rows)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = dataclasses.replace(obj, **{
            f.name: move(getattr(obj, f.name), device, memo)
            for f in dataclasses.fields(obj)
            if isinstance(getattr(obj, f.name),
                          (torch.Tensor, Column, tuple, list)
                          + COMPLEX_COLUMNS)})
    elif isinstance(obj, (tuple, list)):
        out = type(obj)(move(x, device, memo) for x in obj)
    elif isinstance(obj, dict):
        out = {k: move(v, device, memo) for k, v in obj.items()}
    elif hasattr(obj, "__dict__") and type(obj).__module__.startswith(
            "velox_tpu_torch.exec"):
        out = copy.copy(obj)
        for k, v in vars(obj).items():
            if k not in ("node", "on_ready"):
                setattr(out, k, move(v, device, memo))
    else:
        out = obj
    memo[key] = out
    return out


def _slice_rows(big: Batch, lo: int, hi: int) -> Batch:
    cols = {}
    for n, c in big.columns.items():
        if isinstance(c, COMPLEX_COLUMNS):
            cols[n] = c.gather(torch.arange(lo, hi, device=big.device))
        else:
            cols[n] = Column(c.dtype, c.values[lo:hi],
                             None if c.valid is None else c.valid[lo:hi],
                             c.dictionary, c.stats)
    return Batch(cols, big.sel[lo:hi])


def shard_batches(batches: List[Batch], mesh) -> List[Batch]:
    """A scan's splits as one part a shard: their concatenation (as the
    reference concatenates them) cut into ``mesh.size`` equal slices of
    at least one lane, slice ``i`` on shard ``i``'s device. Splits that
    already are those slices are used as they are."""
    n = mesh.size
    total = (batches[0].capacity if len(batches) == 1
             else round_capacity(sum(b.capacity for b in batches)))
    shard_cap = max(-(-total // n), LANE)
    if len(batches) == n and all(b.capacity == shard_cap for b in batches):
        parts = list(batches)
    else:
        big = concat_batches(batches, shard_cap * n)
        parts = [_slice_rows(big, i * shard_cap, (i + 1) * shard_cap)
                 for i in range(n)]
    return [move(b, d) for b, d in zip(parts, mesh.devices)]


class _Replicas:
    """A join bridge on each device that holds a shard: the bridge
    itself on its own device, a copy elsewhere (made once)."""

    def __init__(self, bridge):
        self.bridge = bridge
        self._by_device: Dict[torch.device, object] = {}

    def on(self, device: torch.device):
        home = self.bridge.build_batch.device
        if device == home:
            return self.bridge
        if device not in self._by_device:
            self._by_device[device] = move(self.bridge, device)
        return self._by_device[device]


# ---------------------------------------------------------------- chains

def _classify(ops):
    """The sharded chain after the scan (``(kind, op)``), the operator
    index where it stops, the aggregation that ends it, and the probe
    count; None when a probe form is not covered (the reference's
    rules)."""
    from velox_tpu_torch.exec.operators import (
        FilterOp, HashAggregationOp, HashProbeOp, ProjectOp,
        StreamingAggregationOp,
    )

    chain, agg, n_probes = [], None, 0
    k = 1
    while k < len(ops):
        op = ops[k]
        if isinstance(op, HashProbeOp):
            if op.jt in op._SEMI_LIKE and op._filter is None:
                chain.append(("semi", op))
            elif op.jt in (JT.INNER, JT.LEFT):
                if op.jt == JT.LEFT and op._filter is not None:
                    return None   # filtered left joins stay serial
                chain.append(("inner", op))
            elif op.jt in (JT.RIGHT, JT.FULL):
                # the unmatched build rows come once, from the OR of
                # every shard's flags: a right/full probe ends the chain
                if op._filter is not None:
                    return None
                chain.append(("inner", op))
                n_probes += 1
                k += 1
                break
            else:
                return None
            n_probes += 1
        elif isinstance(op, (FilterOp, ProjectOp)):
            chain.append(("transform", op))
        elif (isinstance(op, HashAggregationOp)
              and not isinstance(op, StreamingAggregationOp)
              and op.step in (AggStep.SINGLE, AggStep.PARTIAL)
              and not op.has_distinct and not op._collect
              and all(lane.width == 1 for f in op.fns for lane in f.lanes)):
            agg = op
            k += 1
            break
        else:
            break
        k += 1
    return chain, k, agg, n_probes


def _run_builds(pipelines) -> None:
    """Every build pipeline to its end; each sink publishes its bridge."""
    from velox_tpu_torch.exec.task import _stream

    for p in pipelines:
        if p.is_output:
            continue
        for _ in _stream(p.operators, len(p.operators) - 1):
            pass
        p.operators[-1].no_more_input()


def _scan_shards(scan, mesh) -> List[List[Batch]]:
    """The scan's splits, filtered as the serial scan filters them (its
    subfilter and the pushed dynamic filters), one part a shard (no part
    at all for a table without splits)."""
    splits = []
    while scan._splits:
        splits.append(scan.get_output())
    if not splits:
        return [[] for _ in mesh.devices]
    return [[b] for b in shard_batches(splits, mesh)]


def _each(shards, fn) -> List[List[Batch]]:
    return [[o for b in bs for o in fn(b)] for bs in shards]


def _transform(op, b: Batch) -> List[Batch]:
    op.add_input(b)
    out = []
    while True:
        o = op.get_output()
        if o is None:
            return out
        out.append(o)


def semi_probe(probe, shards, replicas: _Replicas):
    """A semi or anti probe on every shard: a narrower selection."""
    def one(b):
        br = replicas.on(b.device)
        probe.note_probe_dicts(b)
        (first, count), null_valid = probe.runs(b, br)
        return probe.expand(b, first, count, null_valid, br)[0]

    return _each(shards, one)


def expansion_probe(probe, shards, replicas: _Replicas, home):
    """An inner, left, right or full probe on every shard: every batch's
    match runs, ONE host read of all their pair totals, then each
    expansion. Returns the shards' output and, for right and full joins,
    the unmatched build rows (None without any)."""
    from velox_tpu_torch.ops.join import output_counts

    left_like = probe.jt in probe._LEFT_LIKE
    work, totals = [], []
    for bs in shards:
        for b in bs:
            br = replicas.on(b.device)
            probe.note_probe_dicts(b)
            (first, count), null_valid = probe.runs(b, br)
            work.append((b, first, count, null_valid, br))
            totals.append(output_counts(count, b.sel if left_like else None)
                          .to(torch.int64).sum().to(home))
    host = (syncs.to_numpy(torch.stack(totals)).tolist() if totals else [])
    out, flags, i = [], [], 0
    for bs in shards:
        mine = []
        for _ in bs:
            b, first, count, null_valid, br = work[i]
            outs, hit = probe.expand(b, first, count, null_valid, br,
                                     total=int(host[i]))
            i += 1
            mine.extend(outs)
            if hit is not None:
                flags.append(hit)
        out.append(mine)
    tail = None
    if probe.jt in (JT.RIGHT, JT.FULL):
        from velox_tpu_torch.parallel.collectives import any_reduce

        br = probe.bridge
        if flags:
            br.matched = br.matched | any_reduce(flags, br.matched.device)
        tail = probe._emit_build_side()
    return out, tail


def _batches(shards) -> List[Batch]:
    return [b for bs in shards for b in bs]


def _schema_has(shards, names) -> bool:
    bs = _batches(shards)
    return bool(bs) and all(n in bs[0] for n in names)


def window_flush(win, shards, mesh) -> Optional[List[List[Batch]]]:
    """A distributed window: every row to the shard its partition keys
    hash to (strings by value), then the window's own evaluation on each
    shard (``WindowOp.evaluate``)."""
    from velox_tpu_torch.exec.fragments import _key_lane
    from velox_tpu_torch.parallel.shuffle import (
        hash_destinations, shuffle_batches,
    )

    node = win.node
    if not _schema_has(shards, win.needed_columns()):
        return None
    sources = _batches(shards)
    # strings by value (crc32), as the exchange routes them
    dest = [hash_destinations([_key_lane(b.column(k))
                               for k in node.partition_keys], mesh.size)
            for b in sources]
    received = shuffle_batches(sources, dest, mesh.devices)
    return [[win.evaluate(b)] for b in received]


def ranged_sort(node, shards, mesh) -> List[List[Batch]]:
    """A distributed ORDER BY: rows range-partitioned on the first key
    by splitters sampled on the device (no host read), each shard's rows
    sorted; shard order is then the global order. Rows equal on every
    key keep their arrival order, as the serial stable sort keeps
    them."""
    from velox_tpu_torch.ops.sort import sort_indices
    from velox_tpu_torch.ops.sortkey import encode_sort_key
    from velox_tpu_torch.parallel.shuffle import shuffle_batches

    n = mesh.size
    home = mesh.devices[0]
    k0 = node.keys[0]
    # string codes compare as values only on one sorted dictionary
    sources = harmonize_dictionaries(_batches(shards))

    def enc(b):
        c = b.column(k0.name)
        key = encode_sort_key(c.values, None, descending=k0.descending)[-1]
        live = b.sel if c.valid is None else b.sel & c.valid
        return key.to(torch.int64), live, c.valid

    total = sum(b.capacity for b in sources)
    step = max(1, total // _SPLITTER_SAMPLE)
    keys = [enc(b) for b in sources]
    big = torch.iinfo(torch.int64).max
    sample = torch.cat([torch.where(live[::step], key[::step],
                                    torch.full_like(key[::step], big)).to(home)
                        for key, live, _ in keys])
    count = torch.cat([live[::step].to(home)
                       for _, live, _ in keys]).sum()
    ordered = torch.sort(sample).values
    i = torch.arange(1, n, device=home)
    pos = ((count - 1).clamp(min=0) * i) // n
    splitters = ordered.index_select(0, pos)
    dest = []
    for key, _, valid in keys:
        d = torch.searchsorted(splitters.to(key.device), key, right=True)
        if valid is not None:
            d = torch.where(valid, d, torch.full_like(
                d, 0 if k0.nulls_first else n - 1))
        dest.append(d)
    received = shuffle_batches(sources, dest, mesh.devices)
    out = []
    for b in received:
        spec = [(b.column(kk.name).values, b.column(kk.name).valid,
                 kk.descending, kk.nulls_first) for kk in node.keys]
        perm = sort_indices(spec, b.sel)
        out.append([b.gather(perm, b.sel.index_select(0, perm), b.num_rows)])
    return out


def _top_k_prune(rest, shards):
    """Before a TopN (or OrderBy + Limit), each shard batch keeps only its
    own top K rows: a row outside them cannot be in the global top K."""
    from velox_tpu_torch.exec.operators import LimitOp, OrderByOp, TopNOp
    from velox_tpu_torch.ops.sort import top_n_indices

    op0 = rest[0]
    if isinstance(op0, TopNOp):
        count = op0.node.count
    elif (isinstance(op0, OrderByOp) and len(rest) > 1
          and isinstance(rest[1], LimitOp)):
        count = rest[1].node.count + rest[1].node.offset
    else:
        return shards
    names = [kk.name for kk in op0.node.keys]
    if not _schema_has(shards, names):
        return shards

    def prune(b):
        if b.capacity <= count:
            return [b]
        keys = [(b.column(kk.name).values, b.column(kk.name).valid,
                 kk.descending, kk.nulls_first) for kk in op0.node.keys]
        idx, osel = top_n_indices(keys, b.sel, count)
        return [b.gather(idx, osel)]

    return _each(shards, prune)


def run_serially(rest, batches: List[Batch]) -> List[Batch]:
    """The operators after the sharded chain, over the gathered batches,
    one after another as the serial loop runs them."""
    for op in rest:
        outs = []
        for b in batches:
            if not op.needs_input():
                break
            op.add_input(b)
            while True:
                o = op.get_output()
                if o is None:
                    break
                outs.append(o)
        op.no_more_input()
        while not op.is_finished():
            o = op.get_output()
            if o is None:
                break
            outs.append(o)
        batches = outs
    return batches


def aggregate_parts(agg, parts, home) -> List[Batch]:
    """The aggregation at the end of a sharded chain. ``parts`` yields
    each shard batch's ``(columns, selection, dictionaries)`` on its
    device (``dictionaries``: a name -> dictionary map, or the batch);
    each runs the generic partial step there, its partials move to the
    first shard's device and merge there (a PARTIAL step emits them)."""
    agg._mode = "generic"
    fn = agg.make_generic_fn()
    for cols, sel, dicts in parts:
        agg.note_key_dicts(dicts)
        gkeys, lanes, gsel, dreps = move(fn(cols, sel), home)
        agg.push_generic_entry(gkeys, lanes, gsel, dreps)
    agg.no_more_input()
    out = []
    while True:
        b = agg.get_output()
        if b is None:
            break
        out.append(b)
    return out


def try_distributed_pipeline(pipelines, out_ops, mesh
                             ) -> Optional[List[Batch]]:
    """The output batches (none for an empty result), or None where the
    plan's shape is not covered (decided before anything runs but the
    build sides, as the reference decides)."""
    from velox_tpu_torch.exec.operators import TableScanOp
    from velox_tpu_torch.exec.window_ops import WindowOp

    ops = out_ops
    if not ops or not isinstance(ops[0], TableScanOp):
        return None
    scan = ops[0]
    got = _classify(ops)
    if got is None:
        return None
    chain, k, agg, n_probes = got
    rest = ops[k:]
    if n_probes == 0:
        return None

    _run_builds(pipelines)
    for kind, op in chain:
        if kind == "transform":
            continue
        if not op.bridge.ready:
            return None   # nested bridge shapes are not covered
        if op.bridge.spill_parts is not None:
            raise NotImplementedError(
                "a distributed probe needs an unspilled build side")

    shards = _scan_shards(scan, mesh)
    home = mesh.devices[0]
    tails: List[Batch] = []
    for kind, op in chain:
        if kind == "transform":
            shards = _each(shards, lambda b, op=op: _transform(op, b))
        elif kind == "semi":
            shards = semi_probe(op, shards, _Replicas(op.bridge))
        else:
            shards, tail = expansion_probe(op, shards, _Replicas(op.bridge),
                                           home)
            if tail is not None:
                tails.append(tail)

    if agg is None and not tails and rest:
        op0 = rest[0]
        if (type(op0) is WindowOp and op0.node.partition_keys):
            flushed = window_flush(op0, shards, mesh)
            if flushed is not None:
                shards = flushed
                rest = rest[1:]
        if rest:
            shards = _top_k_prune(rest, shards)
            ob = _plain_orderby(rest)
            if ob is not None and _schema_has(shards, [ob.node.keys[0].name]):
                shards = ranged_sort(ob.node, shards, mesh)
                rest = rest[1:]   # the shards in order are sorted

    if agg is not None:
        from velox_tpu_torch.exec.operators import _cols_of

        batches = aggregate_parts(
            agg, ((_cols_of(b, agg._needed), b.sel, b)
                  for b in _batches(shards)), home)
    else:
        batches = [move(b, home) for b in _batches(shards)] + tails
    # the shape was taken: its result stands, even with no rows
    return run_serially(rest, batches)


def _plain_orderby(rest):
    from velox_tpu_torch.exec.operators import LimitOp, OrderByOp, TopNOp

    op0 = rest[0]
    if not isinstance(op0, OrderByOp) or isinstance(op0, TopNOp):
        return None
    if len(rest) > 1 and isinstance(rest[1], LimitOp):
        return None   # the top-K prune serves it
    return op0
