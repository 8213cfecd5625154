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

A node type outside the built-in set takes its operator from a factory:
one registered for the process (``register_operator``), or one a Task
is given for itself (``factories``; the exchange's operators, bound to
their fragment's buffers, come this way). A ``tracer``
(``utils/trace.py``) records the input batches of chosen nodes.
``run_plan_grouped`` runs the output pipeline's splits in groups with a
barrier between them.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, List, Optional

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
    UnionSinkOp, UnnestOp, WindowOp,
)
from velox_tpu_torch.plan.nodes import (
    AggregationNode, AssignUniqueIdNode, CrossJoinNode, EnforceSingleRowNode,
    ExpandNode, FilterNode, GroupIdNode, HashJoinNode, JoinType, LimitNode,
    LocalMergeNode, MarkDistinctNode, MergeJoinNode, OrderByNode, PlanNode,
    ProjectNode, RowNumberNode, StreamingAggregationNode,
    StreamingWindowNode, TableScanNode, TopNNode, TopNRowNumberNode,
    UnionAllNode, UnnestNode, ValuesNode, WindowNode,
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
    UnnestNode: UnnestOp,
}

#: node type -> factory(node) -> Operator, for node types outside the
#: built-in set (velox/exec/Operator.h:452 translator registry)
_OPERATOR_REGISTRY: Dict[type, Callable] = {}


def register_operator(node_type: type, factory: Callable) -> None:
    """Make ``factory(node)`` the operator of every ``node_type`` node."""
    _OPERATOR_REGISTRY[node_type] = factory


def make_operator(node) -> Operator:
    """The operator of a single-source plan node alone (trace replay)."""
    cls = _SIMPLE_OPERATORS.get(type(node))
    if cls is None:
        raise NotImplementedError(
            f"replay unsupported for {type(node).__name__}")
    return cls(node)


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

    def __init__(self, plan: PlanNode,
                 factories: Optional[Dict[type, Callable]] = None):
        from velox_tpu_torch.exec.fused import maybe_fuse

        self.factories = factories or {}
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
        factory = (self.factories.get(type(node))
                   or _OPERATOR_REGISTRY.get(type(node)))
        if factory is not None:
            chain = self._lower(node.sources[0]) if node.sources else []
            chain.append(factory(node))
            return chain
        cls = _SIMPLE_OPERATORS.get(type(node))
        if cls is None:
            raise NotImplementedError(
                f"no operator for {type(node).__name__} in velox_tpu_torch "
                "yet")
        chain = self._lower(node.sources[0])
        chain.append(cls(node))
        return chain


def _stream(ops: List[Operator], i: int, tracer=None) -> Iterator[Batch]:
    """The serial loop of one pipeline (velox/exec/Driver.cpp analog); a
    ``tracer`` records the input of the operators of the nodes it wants
    (velox/exec/Driver.cpp:600-611)."""
    op = ops[i]
    if i == 0:
        while not op.is_finished():
            b = op.get_output()
            if b is None:
                break
            yield b
        return
    upstream = _stream(ops, i - 1, tracer)
    for b in upstream:
        if not op.needs_input():
            break
        if tracer is not None and tracer.wants(op.node.id):
            tracer.record(op.node.id, b)
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

    def __init__(self, plan: PlanNode, tracer=None,
                 factories: Optional[Dict[type, Callable]] = None):
        from velox_tpu_torch.exec import memory
        from velox_tpu_torch.utils.config import config

        if config.optimize_plans:
            from velox_tpu_torch.plan.optimizer import optimize_plan

            plan = optimize_plan(plan)
        self.plan = plan
        # the query's pool: the buffers of the operators made under it
        # hang off it (exec/memory.py; velox Task::pool)
        self.pool = memory.MemoryPool(f"query.{plan.id}", memory.root_pool,
                                      kind="query")
        with memory.scoped_pool(self.pool):
            self.planner = LocalPlanner(plan, factories)
        self.tracer = tracer

    def run(self) -> Iterator[Batch]:
        from velox_tpu_torch.exec import memory
        from velox_tpu_torch.utils.metrics import (
            METRIC_TASK_EXECUTIONS, reporter,
        )

        reporter.add_counter(METRIC_TASK_EXECUTIONS)
        # the pool stays ambient for buffers made mid-run (a spilled
        # join's probe buffer)
        token = memory._current.set(self.pool)
        try:
            for p in self.planner.pipelines:
                if p.is_output:
                    continue
                for _ in _stream(p.operators, len(p.operators) - 1,
                                 self.tracer):
                    pass
                # the build sink publishes its bridge here
                p.operators[-1].no_more_input()
            ops = self.planner.operators
            yield from _stream(ops, len(ops) - 1, self.tracer)
        finally:
            try:
                memory._current.reset(token)
            except ValueError:   # closed from another context (by GC)
                pass
            self.close()

    def close(self) -> None:
        """Close every operator and the query pool (a Task that never
        ran, too)."""
        for p in self.planner.pipelines:
            for op in p.operators:
                op.close()
        self.pool.close()


def _build(plan) -> PlanNode:
    from velox_tpu_torch.plan.builder import PlanBuilder

    return plan.build() if isinstance(plan, PlanBuilder) else plan


def collect_result(batches, names) -> Dict[str, List]:
    """Batches as ``{column: [values]}`` (``reassemble_wide`` applied)."""
    out: Dict[str, List] = {n: [] for n in names}
    for b in batches:
        for n, vals in b.to_pydict().items():
            out[n].extend(vals)
    return reassemble_wide(out)


def run_plan(plan, tracer=None) -> Dict[str, List]:
    """Execute and materialize the result as ``{column: [values]}``; the
    digit lanes of a long decimal come back as one column of
    ``decimal.Decimal`` values (``reassemble_wide``)."""
    plan = _build(plan)
    return collect_result(Task(plan, tracer).run(), plan.output_type.names)


def _leaf_scan(task: Task) -> Optional[TableScanOp]:
    """The TableScan that starts the output pipeline (inside a fused
    operator, too), or None."""
    for op in task.planner.operators:
        if isinstance(op, TableScanOp):
            return op
        inner = getattr(op, "scan", None)
        if isinstance(inner, TableScanOp):
            return inner
    return None


def run_plan_grouped(plan, num_groups: int, tracer=None
                     ) -> Iterator[Dict[str, List]]:
    """Grouped execution (velox/core/PlanFragment.h
    groupedExecutionLeafNodeIds with exec/Task.h:215 barriers): the
    output pipeline's leaf splits run in ``num_groups`` groups, split
    ``i`` in group ``i % num_groups``, one Task a group, with a barrier
    (``velox_tpu.task_barriers``) between groups. A blocking operator's
    state lives within one group, so the caller must bucket the table so
    that no grouping or join key spans two groups; scans, filters and
    projections are always safe. Yields one ``{column: [values]}`` a
    group that emitted a batch, as the group finishes."""
    from velox_tpu_torch.utils.metrics import METRIC_TASK_BARRIERS, reporter

    plan = _build(plan)
    probe = Task(plan, tracer)
    try:
        scan = _leaf_scan(probe)
        if scan is None:
            raise ValueError("grouped execution needs a leaf TableScan in "
                             "the output pipeline")
        splits = list(scan._splits)
    finally:
        probe.close()
    for g in range(num_groups):
        group = splits[g::num_groups]
        if not group:
            continue
        task = Task(plan, tracer)
        scan = _leaf_scan(task)
        scan._splits.clear()
        scan._splits.extend(group)
        batches = list(task.run())
        reporter.add_counter(METRIC_TASK_BARRIERS)
        if batches:
            yield collect_result(batches, plan.output_type.names)


def reassemble_wide(out: Dict[str, List]) -> Dict[str, List]:
    """Each triple of long-decimal lanes ``{base}#w{2,1,0}s{scale}`` back
    into one DECIMAL(38, scale) column named ``base`` at the place of its
    first lane (the JAX package's Arrow output): ``d2 * 2^84 + d1 * 2^42 +
    d0``; an average (``{base}#wn`` present) divided by its count,
    rounded half away from zero; a magnitude of 10^38 or more is NULL."""
    import decimal

    from velox_tpu_torch.types.widedec import parse_lane

    wide: Dict[tuple, Dict[int, str]] = {}
    for name in out:
        pl = parse_lane(name)
        if pl is not None:
            wide.setdefault((pl[0], pl[2]), {})[pl[1]] = name
    wide = {k: v for k, v in wide.items() if set(v) == {0, 1, 2}}
    if not wide:
        return out
    lane_of = {n: k for k, v in wide.items() for n in v.values()}
    ctx = decimal.Context(prec=60)
    res: Dict[str, List] = {}
    for name, vals in out.items():
        if name.endswith("#wn") and name[:-3] in {b for b, _ in wide}:
            continue   # an average's divisor, read below
        if name not in lane_of:
            res[name] = vals
            continue
        base, scale = lane_of[name]
        if base in res:
            continue
        lanes = wide[(base, scale)]
        d2, d1, d0 = (out[lanes[d]] for d in (2, 1, 0))
        cnt = out.get(f"{base}#wn")
        col = []
        for i in range(len(d2)):
            if d2[i] is None:
                col.append(None)
                continue
            v = (int(d2[i]) << 84) + (int(d1[i]) << 42) + int(d0[i])
            if cnt is not None:
                n = int(cnt[i]) if cnt[i] else 0
                if n == 0:
                    col.append(None)
                    continue
                sgn = -1 if v < 0 else 1
                v = sgn * ((2 * abs(v) + n) // (2 * n))
            col.append(None if abs(v) >= 10 ** 38 else
                       decimal.Decimal(v).scaleb(-scale, ctx))
        res[base] = col
    return res


#: the JAX package's name for the same result surface
run_plan_pydict = run_plan
