"""Distributed plan execution over a mesh of shards (the port of
``velox_tpu/parallel/runner.py``).

``run_plan_distributed`` tries the reference's four strategies in its
order and records the one taken in ``last_strategy``:

1. ``broadcast_semi_join``: a two-pipeline plan whose output pipeline is
   scan -> unfiltered semi or anti probe: the build runs serially, each
   shard probes its part of the scan, what follows runs serially;
2. ``distributed_pipeline``: ``parallel/pipeline.py``;
3. ``fused_scan_agg``: one fused scan -> transforms -> aggregation
   pipeline, each shard's part through the fused stages and the
   generic partial step, the partials merged by the aggregation;
4. ``serial_fallback``: any other shape, through the serial ``run_plan``
   on the tables' own device (the card).

The plan is planned as the reference plans it here: without the
optimizer's rewrites (hash joins, not merge joins), whatever
``config.optimize_plans`` says; the serial fallback runs ``run_plan``,
which applies them. The result is ``{column: [values]}``, as ``run_plan``
returns it. A strategy that fails raises; none falls back quietly.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from velox_tpu_torch.parallel.mesh import make_mesh
from velox_tpu_torch.vector.batch import Batch

#: how the LAST ``run_plan_distributed`` call executed
last_strategy: str = ""


def run_plan_distributed(plan, mesh=None, axis: str = "d"
                         ) -> Dict[str, List]:
    """Execute ``plan`` over ``mesh`` (default: one shard a card); see
    the module's docstring for the strategies."""
    from velox_tpu_torch.exec.task import _build, collect_result

    plan = _build(plan)
    return collect_result(distributed_batches(plan, mesh, axis),
                          plan.output_type.names)


def distributed_batches(plan, mesh=None, axis: str = "d") -> List[Batch]:
    """``run_plan_distributed``'s result as the batches it gathered on the
    first shard's device (a consumer that compares on the device reads
    them so)."""
    global last_strategy
    from velox_tpu_torch.exec import memory
    from velox_tpu_torch.exec.task import LocalPlanner, Task, _build

    plan = _build(plan)
    mesh = mesh or make_mesh(axis=axis)
    pool = memory.MemoryPool(f"query.{plan.id}.distributed",
                             memory.root_pool, kind="query")
    planner = None
    token = memory._current.set(pool)
    try:
        planner = LocalPlanner(plan)
        for strategy, run in (("broadcast_semi_join", _broadcast_semi_join),
                              ("distributed_pipeline", _pipeline),
                              ("fused_scan_agg", _fused_scan_agg)):
            batches = run(planner, mesh)
            if batches is not None:
                last_strategy = strategy
                return batches
    finally:
        try:
            memory._current.reset(token)
        except ValueError:
            pass
        if planner is not None:
            for p in planner.pipelines:
                for op in p.operators:
                    op.close()
        pool.close()
    # expansion joins past the covered shapes, non-fusable shapes
    last_strategy = "serial_fallback"
    return list(Task(plan).run())


def _pipeline(planner, mesh) -> Optional[List[Batch]]:
    from velox_tpu_torch.parallel.pipeline import try_distributed_pipeline

    return try_distributed_pipeline(planner.pipelines, planner.operators,
                                    mesh)


def _broadcast_semi_join(planner, mesh) -> Optional[List[Batch]]:
    """Broadcast semi join: the build side runs serially and every shard
    probes against it; only semi-like joins without a filter (their probe
    only narrows the selection), as in the reference."""
    from velox_tpu_torch.exec.operators import HashProbeOp, TableScanOp
    from velox_tpu_torch.parallel.pipeline import (
        _Replicas, _run_builds, _scan_shards, move, run_serially, semi_probe,
    )
    from velox_tpu_torch.plan.nodes import JoinType as JT

    ops = planner.operators
    if len(planner.pipelines) != 2:
        return None
    if not (len(ops) >= 2 and isinstance(ops[0], TableScanOp)
            and isinstance(ops[1], HashProbeOp)):
        return None
    probe = ops[1]
    if probe.jt not in (JT.LEFT_SEMI, JT.ANTI, JT.ANTI_SIMPLE):
        return None
    if probe._filter is not None:
        return None
    _run_builds(planner.pipelines)
    if probe.bridge.spill_parts is not None:
        raise NotImplementedError(
            "a distributed probe needs an unspilled build side")
    shards = semi_probe(probe, _scan_shards(ops[0], mesh),
                        _Replicas(probe.bridge))
    home = mesh.devices[0]
    batches = [move(b, home) for bs in shards for b in bs]
    return run_serially(ops[2:], batches)


def _fused_scan_agg(planner, mesh) -> Optional[List[Batch]]:
    """One fused scan -> transforms -> aggregation pipeline: each shard's
    part through the fused stages and the aggregation's generic partial
    step (``aggregate_parts``); the partials merge as ordinary
    entries."""
    from velox_tpu_torch.exec.fused import FusedScanAggOp, _run_stages
    from velox_tpu_torch.exec.operator import eval_pairs
    from velox_tpu_torch.parallel.pipeline import (
        aggregate_parts, shard_batches,
    )

    ops = planner.operators
    if not (len(ops) == 1 and isinstance(ops[0], FusedScanAggOp)
            and len(planner.pipelines) == 1):
        return None
    fused = ops[0]
    agg = fused.agg
    scan = fused.scan
    splits = []
    while scan._splits:
        b = scan._splits.popleft().project(scan.node.all_columns)
        for df in scan.dynamic_filters:
            b = b.with_sel(df.filter_sel(b))
        splits.append(b)

    def parts():
        for b in (shard_batches(splits, mesh) if splits else ()):
            stages, dicts = fused._compile(b)
            env, sel = _run_stages(stages, eval_pairs(b), b.sel)
            yield {n: env[n] for n in agg._needed}, sel, dicts

    return aggregate_parts(agg, parts(), mesh.devices[0])
