"""Task: plan -> pipelines -> serial driver loop.

The port of ``velox_tpu/exec/task.py`` for the operators of this slice.
``LocalPlanner`` lowers the plan into an operator chain and fuses
``TableScan -> (Filter|Project)* -> Aggregation`` prefixes
(``exec/fused.py``); ``Task.run`` pulls batches through it. ``run_plan``
returns the result as a dict of Python lists (there is no pyarrow):
decimals as ``decimal.Decimal``, strings as ``str``.
"""

from __future__ import annotations

from typing import Dict, Iterator, List

from velox_tpu_torch.vector.batch import Batch
from velox_tpu_torch.exec.operator import Operator
from velox_tpu_torch.exec.operators import (
    FilterOp, HashAggregationOp, OrderByOp, ProjectOp, TableScanOp,
)
from velox_tpu_torch.plan.nodes import (
    AggregationNode, FilterNode, OrderByNode, PlanNode, ProjectNode,
    TableScanNode,
)

_SIMPLE_OPERATORS = {
    FilterNode: FilterOp,
    ProjectNode: ProjectOp,
    AggregationNode: HashAggregationOp,
    OrderByNode: OrderByOp,
}


class LocalPlanner:
    """Lower the plan tree into one output chain
    (velox/exec/LocalPlanner.cpp); joins and unions, which start new
    pipelines, are not ported yet."""

    def __init__(self, plan: PlanNode):
        from velox_tpu_torch.exec.fused import maybe_fuse

        self.operators: List[Operator] = maybe_fuse(self._lower(plan))

    def _lower(self, node: PlanNode) -> List[Operator]:
        if isinstance(node, TableScanNode):
            return [TableScanOp(node)]
        cls = _SIMPLE_OPERATORS.get(type(node))
        if cls is None:
            raise NotImplementedError(
                f"no operator for {type(node).__name__} in velox_tpu_torch "
                "yet")
        chain = self._lower(node.sources[0])
        chain.append(cls(node))
        return chain


def _stream(ops: List[Operator], i: int) -> Iterator[Batch]:
    """Serial driver inner loop (velox/exec/Driver.cpp analog)."""
    op = ops[i]
    if i == 0:
        while not op.is_finished():
            b = op.get_output()
            if b is None:
                break
            yield b
        return
    for b in _stream(ops, i - 1):
        op.add_input(b)
        while True:
            out = op.get_output()
            if out is None:
                break
            yield out
    op.no_more_input()
    while not op.is_finished():
        out = op.get_output()
        if out is None:
            break
        yield out


class Task:
    """Owns one plan's execution (velox/exec/Task.h, serial mode)."""

    def __init__(self, plan: PlanNode):
        from velox_tpu_torch.utils.config import config

        if config.optimize_plans:
            from velox_tpu_torch.plan.optimizer import optimize_plan

            plan = optimize_plan(plan)
        self.plan = plan
        self.planner = LocalPlanner(plan)

    def run(self) -> Iterator[Batch]:
        ops = self.planner.operators
        yield from _stream(ops, len(ops) - 1)


def run_plan(plan) -> Dict[str, List]:
    """Execute and materialize the result as ``{column: [values]}``."""
    from velox_tpu_torch.plan.builder import PlanBuilder

    if isinstance(plan, PlanBuilder):
        plan = plan.build()
    out: Dict[str, List] = {n: [] for n in plan.output_type.names}
    for b in Task(plan).run():
        for n, vals in b.to_pydict().items():
            out[n].extend(vals)
    return out


#: the JAX package's name for the same result surface
run_plan_pydict = run_plan
