"""Sort-order property pass: pick merge/streaming physical operators.

Velox receives fully-optimized plans from a host engine and keeps ordering
metadata on plan nodes; here the engine itself must choose the physical
shapes, because on this TPU backend the difference is structural: a
MergeJoin build is a null-packing gather while a HashJoin build compiles a
`lax.sort` kernel (erratic multi-minute remote compiles at SF1 — BASELINE
r1 notes), and a StreamingAggregation never sorts at all. Round 1
hand-picked these shapes via `tpch_plan(n, clustered=True)`; this pass
derives them (VERDICT r1 weak item 2: "a sort-order property pass so
clustered plan shapes are chosen automatically").

Bottom-up over the plan tree, three stream properties are propagated:

* ``sorted_cols`` — columns nondecreasing in stream order (seeded from
  ingest-verified physical ordering, io/catalog.py Table.sorted_cols);
* ``unique_cols`` — columns with no duplicate values in the stream;
* ``fd`` — functional dependencies: determinant column -> columns whose
  value is fixed per determinant value (seeded by unique scan keys,
  extended through joins on unique build keys and pass-through projects).

Rewrites (strict wins — the merge/streaming forms share all the generic
machinery and only skip the sort):

* HashJoinNode -> MergeJoinNode when the BUILD side stream is sorted on
  the join key (single key, or first key sorted+unique so the packed
  normalized key stays ascending — ops/join.py JoinKeyCodec order).
* AggregationNode -> StreamingAggregationNode (SINGLE, no distinct) when
  some group key g is sorted and every other key is in fd[g] — equal-g
  runs are then constant in all keys, i.e. the input is key-clustered
  (velox/exec/StreamingAggregation.h contract).
"""

from __future__ import annotations

import dataclasses
from dataclasses import fields as dc_fields
from typing import Dict, FrozenSet, Tuple

from velox_tpu_torch.expr.ir import Expr, FieldRef
from velox_tpu_torch.plan.nodes import (
    AggregationNode,
    AggStep,
    CrossJoinNode,
    FilterNode,
    HashJoinNode,
    JoinType,
    LimitNode,
    MergeJoinNode,
    OrderByNode,
    PlanNode,
    ProjectNode,
    SourceNode,
    StreamingAggregationNode, StreamingWindowNode, WindowNode,
    TableScanNode,
    TopNNode,
)


@dataclasses.dataclass(frozen=True)
class StreamProps:
    sorted_cols: FrozenSet[str] = frozenset()
    unique_cols: FrozenSet[str] = frozenset()
    fd: Tuple[Tuple[str, FrozenSet[str]], ...] = ()

    def fd_map(self) -> Dict[str, FrozenSet[str]]:
        return dict(self.fd)


_EMPTY = StreamProps()


def _mkfd(d: Dict[str, FrozenSet[str]]) -> Tuple:
    return tuple(sorted((k, frozenset(v)) for k, v in d.items() if v))


def _expr_fields(e: Expr) -> FrozenSet[str]:
    """All column names an expression reads (None-safe, conservative)."""
    if e is None:
        return frozenset()
    if isinstance(e, FieldRef):
        return frozenset([e.name])
    out = set()
    for c in getattr(e, "children", ()) or ():
        out |= _expr_fields(c)
    return frozenset(out)


def _retype(node: PlanNode, new_cls, **changes) -> PlanNode:
    """Rebuild ``node`` as ``new_cls`` with the same field values."""
    vals = {f.name: getattr(node, f.name) for f in dc_fields(node)}
    vals.update(changes)
    return new_cls(**vals)


class _Optimizer:
    def __init__(self):
        self._props: Dict[str, StreamProps] = {}

    # -------------------------------------------------------------- walk
    def run(self, node: PlanNode) -> PlanNode:
        new_sources = tuple(self.run(s) for s in node.sources)
        node = self._replace_sources(node, new_sources)
        node = self._rewrite(node)
        self._props[node.id] = self._derive(node)
        return node

    def _replace_sources(self, node, new_sources):
        if not new_sources:
            return node
        if isinstance(node, SourceNode):
            return dataclasses.replace(node, source=new_sources[0])
        if isinstance(node, (HashJoinNode, CrossJoinNode)):
            return dataclasses.replace(
                node, left=new_sources[0], right=new_sources[1])
        # generic multi-source nodes (union, merge): find tuple field
        for f in dc_fields(node):
            v = getattr(node, f.name)
            if isinstance(v, tuple) and v and all(
                    isinstance(x, PlanNode) for x in v):
                return dataclasses.replace(node, **{f.name: new_sources})
        return node

    def _p(self, node: PlanNode) -> StreamProps:
        return self._props.get(node.id, _EMPTY)

    # ---------------------------------------------------------- rewrites
    def _rewrite(self, node: PlanNode) -> PlanNode:
        if (type(node) is FilterNode
                and type(node.source) is StreamingAggregationNode
                and node.source.step == AggStep.SINGLE
                and node.source.having is None
                and _expr_fields(node.predicate)
                <= set(node.source.output_type.names)):
            # HAVING fold: groups failing the predicate never
            # materialize (StreamingAggregationNode.having; the emit
            # stage sizes to the passing-group count)
            return dataclasses.replace(
                node.source, having=node.predicate)
        if type(node) is HashJoinNode and node.right_keys:
            bp = self._p(node.right)
            k0 = node.right_keys[0]
            ok = (
                (len(node.right_keys) == 1 and k0 in bp.sorted_cols)
                or (k0 in bp.sorted_cols and k0 in bp.unique_cols)
            )
            if ok:
                return _retype(node, MergeJoinNode)
        if type(node) is WindowNode and node.partition_keys:
            ip = self._p(node.source)
            fd = ip.fd_map()
            for g in node.partition_keys:
                if g not in ip.sorted_cols:
                    continue
                rest = set(node.partition_keys) - {g}
                if rest <= fd.get(g, frozenset()):
                    return _retype(node, StreamingWindowNode)
        if (type(node) is AggregationNode
                and node.step == AggStep.SINGLE and node.keys
                and not any(a.distinct for a in node.aggregates)):
            ip = self._p(node.source)
            fd = ip.fd_map()
            for g in node.keys:
                if g not in ip.sorted_cols:
                    continue
                rest = set(node.keys) - {g}
                if rest <= fd.get(g, frozenset()):
                    return _retype(node, StreamingAggregationNode)
        return node

    # ------------------------------------------------------- propagation
    def _derive(self, node: PlanNode) -> StreamProps:
        if isinstance(node, TableScanNode):
            return self._scan_props(node)
        if isinstance(node, (FilterNode, LimitNode)):
            return self._p(node.source)
        if isinstance(node, ProjectNode):
            return self._project_props(node)
        if isinstance(node, StreamingAggregationNode):
            return self._streaming_agg_props(node)
        if isinstance(node, AggregationNode):
            return _EMPTY
        if isinstance(node, WindowNode):
            # window functions append columns; results scatter back to
            # arrival order, so input ordering properties pass through
            return self._p(node.source)
        if isinstance(node, (OrderByNode, TopNNode)):
            return self._orderby_props(node)
        if isinstance(node, HashJoinNode):  # includes MergeJoinNode
            return self._join_props(node)
        return _EMPTY

    def _scan_props(self, node: TableScanNode) -> StreamProps:
        from velox_tpu_torch.io.catalog import _TABLES

        t = _TABLES.get(node.table)
        if t is None:
            return _EMPTY
        cols = frozenset(node.columns or t.schema.names)
        sorted_cols = frozenset(getattr(t, "sorted_cols", ())) & cols
        unique_cols = frozenset(getattr(t, "unique_cols", ())) & cols
        fd = {u: cols - {u} for u in unique_cols}
        return StreamProps(sorted_cols, unique_cols, _mkfd(fd))

    def _project_props(self, node: ProjectNode) -> StreamProps:
        ip = self._p(node.source)
        # pass-through (identity/rename) outputs inherit membership
        passthru = {}  # input col -> output names
        deps = {}      # output name -> input cols it reads
        for name, e in zip(node.names, node.exprs):
            deps[name] = _expr_fields(e)
            if isinstance(e, FieldRef):
                passthru.setdefault(e.name, []).append(name)

        def outs(col):
            return passthru.get(col, ())

        sorted_cols = frozenset(
            o for c in ip.sorted_cols for o in outs(c))
        unique_cols = frozenset(
            o for c in ip.unique_cols for o in outs(c))
        fd = {}
        for k, det in ip.fd_map().items():
            basis = det | {k}
            determined = frozenset(
                name for name, d in deps.items() if d and d <= basis)
            for ko in outs(k):
                fd[ko] = determined - {ko}
        return StreamProps(sorted_cols, unique_cols, _mkfd(fd))

    def _streaming_agg_props(self, node) -> StreamProps:
        ip = self._p(node.source)
        out = frozenset(node.keys) | frozenset(node.agg_names)
        g_sorted = frozenset(node.keys) & ip.sorted_cols
        fd = ip.fd_map()
        props_fd = {}
        unique = set()
        for g in g_sorted:
            if set(node.keys) - {g} <= fd.get(g, frozenset()):
                # g identifies the group -> unique per output row,
                # determines every output column
                unique.add(g)
                props_fd[g] = out - {g}
        return StreamProps(g_sorted, frozenset(unique), _mkfd(props_fd))

    def _orderby_props(self, node) -> StreamProps:
        ip = self._p(node.source)
        k0 = node.keys[0] if node.keys else None
        sorted_cols = frozenset()
        if k0 is not None and not k0.descending:
            sorted_cols = frozenset([k0.name])
        return StreamProps(sorted_cols, ip.unique_cols, ip.fd)

    def _join_props(self, node: HashJoinNode) -> StreamProps:
        pp = self._p(node.left)
        bp = self._p(node.right)
        out = frozenset(node.output_type.names)
        probe_cols = frozenset(node.left.output_type.names)
        build_cols = frozenset(node.right.output_type.names)
        if probe_cols & build_cols:
            return _EMPTY  # ambiguous name ownership

        jt = node.join_type
        if jt in (JoinType.LEFT_SEMI, JoinType.ANTI, JoinType.ANTI_SIMPLE):
            # output is a subsequence of the probe stream
            return StreamProps(
                pp.sorted_cols & out, pp.unique_cols & out,
                _mkfd({k: v & out for k, v in pp.fd_map().items()
                       if k in out}))
        if jt not in (JoinType.INNER, JoinType.LEFT):
            return _EMPTY

        # probe-major expansion (ops/join.py expand_matches): probe order
        # survives; probe uniqueness survives only if each probe row
        # matches at most one build row
        build_unique = (
            node.right_keys[0] in bp.unique_cols
            if len(node.right_keys) == 1 else False)
        sorted_cols = set(pp.sorted_cols & out)
        unique_cols = (pp.unique_cols & out) if build_unique else frozenset()
        fd = {k: v & out for k, v in pp.fd_map().items() if k in out}
        gained = frozenset()
        if build_unique and node.filter is None:
            bfd = bp.fd_map().get(node.right_keys[0], frozenset())
            gained = (build_cols | bfd) & out
            for lk in node.left_keys:
                if lk in out:
                    fd[lk] = fd.get(lk, frozenset()) | gained
            # transitive: any probe determinant of lk also gains
            for k, v in list(fd.items()):
                if node.left_keys[0] in v:
                    fd[k] = v | gained
        if jt is JoinType.INNER:
            # join-key equivalence: in the output stream the build key
            # column EQUALS the probe key column row-by-row, so it
            # inherits the probe key's ordering and determinants even
            # when the probe key itself is projected away (the Q18
            # shape: group keys name o_orderkey while the stream is
            # sorted on l_orderkey)
            pfd = pp.fd_map()
            for lk, rk in zip(node.left_keys, node.right_keys):
                if rk not in out or lk == rk:
                    continue
                if lk in pp.sorted_cols:
                    sorted_cols.add(rk)
                det = (pfd.get(lk, frozenset()) | {lk} | gained) & out
                fd[rk] = (fd.get(rk, frozenset()) | det
                          | fd.get(lk, frozenset())) - {rk}
        return StreamProps(frozenset(sorted_cols), unique_cols,
                           _mkfd(fd))


def optimize_plan(plan: PlanNode) -> PlanNode:
    """Return an equivalent plan with merge/streaming operators chosen
    wherever ingest-verified physical ordering proves them safe."""
    return _Optimizer().run(plan)
