"""Fused linear pipelines: ``TableScan -> (Filter|Project)* ->
Aggregation`` as one operator.

The port of ``velox_tpu/exec/fused.py``. In the JAX package the fused
step is one jitted program per split; here it runs eagerly, so what
fusion keeps is the structure: the scan's filter, every predicate and
projection and the aggregation's grouping and accumulation run per split
inside one operator, with no intermediate Batch and no operator hand-off.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from velox_tpu_torch.utils.config import config
from velox_tpu_torch.vector.batch import Batch
from velox_tpu_torch.vector.column import Column, Dictionary
from velox_tpu_torch.exec.operator import (
    Operator, batch_ranges, eval_dicts, eval_pairs,
)
from velox_tpu_torch.exec.operators import (
    FilterOp, HashAggregationOp, ProjectOp, StreamingAggregationOp,
    TableScanOp,
)
from velox_tpu_torch.plan.nodes import AggStep


def maybe_fuse(chain: List[Operator]) -> List[Operator]:
    """Rewrite a planned operator chain into a fused one when it matches."""
    if not config.fused_pipelines or len(chain) < 2:
        return chain
    if not isinstance(chain[0], TableScanOp):
        return chain
    k = 1
    while k < len(chain) and isinstance(chain[k], (FilterOp, ProjectOp)):
        k += 1
    # a streaming aggregation keeps its open group between batches and
    # emits per batch: it stays its own operator
    if (k == len(chain) - 1 and isinstance(chain[-1], HashAggregationOp)
            and not isinstance(chain[-1], StreamingAggregationOp)
            and chain[-1].step != AggStep.FINAL):
        return [FusedScanAggOp(chain)]
    if k > 1:
        return [FusedScanOp(chain[:k])] + chain[k:]
    return chain


def _stages(scan: TableScanOp, transforms, batch: Batch):
    """Bind the scan filter and each transform for this split's
    dictionaries and stats: (stages, dictionaries after the chain)."""
    dicts: Dict[str, Optional[Dictionary]] = dict(eval_dicts(batch))
    ranges = batch_ranges(batch)
    stages = []
    if scan._filter is not None:
        _, run = scan._filter.pure(
            {n: d for n, d in dicts.items() if d is not None},
            "filter", ranges)
        stages.append(("filter", run, None))
    for op in transforms:
        live = {n: d for n, d in dicts.items() if d is not None}
        if isinstance(op, FilterOp):
            _, run = op._eval.pure(live, "filter", ranges)
            stages.append(("filter", run, None))
        else:
            expr_set, run = op._eval.pure(live, "project", ranges)
            names = list(op.node.names)
            stages.append(("project", run, names))
            dicts = dict(zip(names, expr_set.result_dictionaries))
    return stages, dicts


def _run_stages(stages, cols, sel):
    env = cols
    for kind, run, names in stages:
        if kind == "filter":
            sel = run(env, sel)
        else:
            env = dict(zip(names, run(env, sel)))
    return env, sel


def _dict_signature(batch: Batch) -> tuple:
    return tuple(sorted((n, id(c.dictionary))
                        for n, c in batch.columns.items()
                        if c.dictionary is not None))


class FusedScanOp(Operator):
    """Scan -> filters/projects per split (no aggregation)."""

    def __init__(self, chain: List[Operator]):
        self.scan: TableScanOp = chain[0]
        self.transforms = chain[1:]
        super().__init__(chain[-1].node)
        self._step_cache: Dict[tuple, tuple] = {}

    def get_output(self) -> Optional[Batch]:
        if not self.scan._splits:
            return None
        b = self.scan._splits.popleft().project(self.scan.node.all_columns)
        for df in self.scan.dynamic_filters:
            b = b.with_sel(df.filter_sel(b))
        sig = _dict_signature(b)
        hit = self._step_cache.get(sig)
        if hit is None:
            hit = _stages(self.scan, self.transforms, b)
            self._step_cache[sig] = hit
        stages, out_dicts = hit
        env, sel = _run_stages(stages, eval_pairs(b), b.sel)
        out_cols = {}
        for n, t in zip(self.output_type.names, self.output_type.children):
            vals, valid = env[n]
            out_cols[n] = Column(t, vals, valid, out_dicts.get(n))
        return Batch(out_cols, sel)

    def is_finished(self) -> bool:
        return not self.scan._splits


class FusedScanAggOp(Operator):
    """Scan -> transforms -> aggregation, one step per split."""

    blocking = True

    def __init__(self, chain: List[Operator]):
        self.scan: TableScanOp = chain[0]
        self.transforms = chain[1:-1]
        self.agg: HashAggregationOp = chain[-1]
        super().__init__(self.agg.node)
        self._step_cache: Dict[tuple, tuple] = {}
        self._done = False

    def _compile(self, batch: Batch):
        """(stages, aggregation step fn, mode) for this split's
        dictionary signature."""
        sig = _dict_signature(batch)
        hit = self._step_cache.get(sig)
        if hit is not None:
            return hit
        stages, dicts = _stages(self.scan, self.transforms, batch)
        agg = self.agg
        key_dicts = {k: dicts.get(k) for k in agg.keys}
        mode = agg.decide_mode_dicts(key_dicts)
        agg.note_key_dicts(dicts)
        agg_fn = (agg.make_array_fn() if mode == "array"
                  else agg.make_generic_fn())
        hit = (stages, agg_fn, mode)
        self._step_cache[sig] = hit
        return hit

    def _pump(self) -> None:
        agg = self.agg
        while self.scan._splits:
            b = self.scan._splits.popleft().project(
                self.scan.node.all_columns)
            stages, agg_fn, mode = self._compile(b)
            env, sel = _run_stages(stages, eval_pairs(b), b.sel)
            agg._device = b.device
            if mode == "array":
                st = agg.ensure_array_state(b.device)
                st["accs"], st["seen"] = agg_fn(
                    env, sel, st["accs"], st["seen"])
            else:
                agg.push_generic_entry(*agg_fn(env, sel))
        agg.no_more_input()
        self._done = True

    def get_output(self) -> Optional[Batch]:
        if not self._done:
            self._pump()
        return self.agg.get_output()

    def is_finished(self) -> bool:
        return self._done and self.agg.is_finished()
