"""Task: plan -> pipelines -> serial driver loop.

The port of ``velox_tpu/exec/task.py`` for the operators of the ported
slices. ``LocalPlanner`` splits the plan into pipelines at join builds
(velox/exec/LocalPlanner.cpp mustStartNewPipeline): each hash, merge or
cross join's build side becomes a pipeline ending in a build sink that
publishes a ``JoinBridge``; build pipelines run to completion first, in creation
order (a topological order of the bridges), then the output pipeline
streams. Each source of a union or merge after the first runs the same
way, into a sink pipeline that buffers its batches for the union. Each
chain is offered to ``maybe_fuse`` (``exec/fused.py``).
``run_plan`` returns the result as a dict of Python lists (there is no
pyarrow): decimals as ``decimal.Decimal``, strings as ``str``.
"""

from __future__ import annotations

from typing import Dict, Iterator, List

from velox_tpu_torch.vector.batch import Batch
from velox_tpu_torch.exec.operator import Operator
from velox_tpu_torch.exec.operators import (
    AssignUniqueIdOp, CrossBuildOp, CrossProbeOp, EnforceSingleRowOp,
    FilterOp, HashAggregationOp, HashBuildOp, HashProbeOp, JoinBridge,
    LimitOp, MergeJoinBuildOp, MergeJoinProbeOp, OrderByOp, ProjectOp,
    StreamingAggregationOp, TableScanOp, TopNOp, ValuesOp,
)
from velox_tpu_torch.exec.window_ops import (
    ExpandOp, GroupIdOp, LocalMergeOp, MarkDistinctOp, RowNumberOp,
    StreamingWindowOp, TopNRowNumberOp, UnionAllOp, UnionBridge,
    UnionSinkOp, WindowOp,
)
from velox_tpu_torch.plan.nodes import (
    AggregationNode, AssignUniqueIdNode, CrossJoinNode, EnforceSingleRowNode,
    ExpandNode, FilterNode, GroupIdNode, HashJoinNode, JoinType, LimitNode,
    LocalMergeNode, MarkDistinctNode, MergeJoinNode, OrderByNode, PlanNode,
    ProjectNode, RowNumberNode, StreamingAggregationNode,
    StreamingWindowNode, TableScanNode, TopNNode, TopNRowNumberNode,
    UnionAllNode, ValuesNode, WindowNode,
)

_SIMPLE_OPERATORS = {
    FilterNode: FilterOp,
    ProjectNode: ProjectOp,
    AggregationNode: HashAggregationOp,
    StreamingAggregationNode: StreamingAggregationOp,
    OrderByNode: OrderByOp,
    TopNNode: TopNOp,
    LimitNode: LimitOp,
    EnforceSingleRowNode: EnforceSingleRowOp,
    AssignUniqueIdNode: AssignUniqueIdOp,
    WindowNode: WindowOp,
    StreamingWindowNode: StreamingWindowOp,
    RowNumberNode: RowNumberOp,
    TopNRowNumberNode: TopNRowNumberOp,
    MarkDistinctNode: MarkDistinctOp,
    ExpandNode: ExpandOp,
    GroupIdNode: GroupIdOp,
}

#: join types whose probe can push a build-side filter into its scan:
#: those that drop the probe rows without a match (left and full joins
#: keep them, anti joins want them)
_PUSHDOWN_JOINS = (JoinType.INNER, JoinType.LEFT_SEMI, JoinType.RIGHT,
                   JoinType.RIGHT_SEMI)


class Pipeline:
    def __init__(self, operators: List[Operator], is_output: bool):
        self.operators = operators
        self.is_output = is_output


class LocalPlanner:
    """Split the plan tree into pipelines (velox/exec/LocalPlanner.cpp)."""

    def __init__(self, plan: PlanNode):
        from velox_tpu_torch.exec.fused import maybe_fuse

        self.pipelines: List[Pipeline] = []
        chain = self._lower(plan)
        self.pipelines = [Pipeline(maybe_fuse(p.operators), p.is_output)
                          for p in self.pipelines]
        self.pipelines.append(Pipeline(maybe_fuse(chain), is_output=True))

    @property
    def operators(self) -> List[Operator]:
        """The output pipeline's operators."""
        return self.pipelines[-1].operators

    def _lower(self, node: PlanNode) -> List[Operator]:
        if isinstance(node, ValuesNode):
            return [ValuesOp(node)]
        if isinstance(node, TableScanNode):
            return [TableScanOp(node)]
        if isinstance(node, HashJoinNode):   # MergeJoinNode included
            merge = isinstance(node, MergeJoinNode)
            bridge = JoinBridge(node)
            build_chain = self._lower(node.right)
            build_chain.append(
                (MergeJoinBuildOp if merge else HashBuildOp)(node, bridge))
            self.pipelines.append(Pipeline(build_chain, is_output=False))
            chain = self._lower(node.left)
            probe = (MergeJoinProbeOp if merge else HashProbeOp)(node, bridge)
            # dynamic filter pushdown: the build side's keys filter the
            # probe side's scan (velox/exec/HashProbe.cpp:419-444)
            if (isinstance(chain[0], TableScanOp)
                    and any(k in chain[0].node.columns
                            for k in node.left_keys)
                    and node.join_type in _PUSHDOWN_JOINS):
                probe.pushdown_scan = chain[0]
            chain.append(probe)
            return chain
        if isinstance(node, (UnionAllNode, LocalMergeNode)):
            # sources[1:] each run first into a sink pipeline
            bridge = UnionBridge()
            for src in node.inputs[1:]:
                sink_chain = self._lower(src)
                sink_chain.append(UnionSinkOp(node, bridge))
                self.pipelines.append(Pipeline(sink_chain, is_output=False))
            chain = self._lower(node.inputs[0])
            chain.append((UnionAllOp if isinstance(node, UnionAllNode)
                          else LocalMergeOp)(node, bridge))
            return chain
        if isinstance(node, CrossJoinNode):
            bridge = JoinBridge(node)
            build_chain = self._lower(node.right)
            build_chain.append(CrossBuildOp(node, bridge))
            self.pipelines.append(Pipeline(build_chain, is_output=False))
            chain = self._lower(node.left)
            chain.append(CrossProbeOp(node, bridge))
            return chain
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
    upstream = _stream(ops, i - 1)
    for b in upstream:
        if not op.needs_input():
            break
        op.add_input(b)
        while True:
            out = op.get_output()
            if out is None:
                break
            yield out
            if op.is_finished():
                upstream.close()
                return
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
        for p in self.planner.pipelines:
            if p.is_output:
                continue
            for _ in _stream(p.operators, len(p.operators) - 1):
                pass
            # the build sink publishes its bridge here
            p.operators[-1].no_more_input()
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
