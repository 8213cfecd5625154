"""Fluent PlanBuilder.

Analog of velox/exec/tests/utils/PlanBuilder.h:92, promoted to the primary
embedding API (like PyPlanBuilder, velox/python/runner/PyLocalRunner.h).
Resolves output schemas eagerly, lowers expression-valued aggregation
keys/args into pre-projections (what velox's AggregationNode planning does
via PlanBuilder::aggregation), and parses the SQL expression dialect of
velox_tpu/expr/parser.py.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple, Union

from velox_tpu_torch.types import BIGINT, BOOLEAN, DataType
from velox_tpu_torch.types.types import RowType, row_type
from velox_tpu_torch.expr.ir import Call, Expr, FieldRef, Lambda, Literal
from velox_tpu_torch.expr.parser import parse_expr
from velox_tpu_torch.expr.compiler import resolve_types
from velox_tpu_torch.functions.aggregates import lookup_aggregate
from velox_tpu_torch.plan.nodes import (
    GroupIdNode,
    AggStep, AggregateSpec, AggregationNode, AssignUniqueIdNode,
    CrossJoinNode, EnforceSingleRowNode, ExchangeNode, FilterNode,
    HashJoinNode, JoinType, LimitNode, LocalPartitionNode, MarkDistinctNode,
    MergeJoinNode, OrderByNode, PlanNode, ProjectNode, RowNumberNode,
    SortField, TableScanNode, TableWriteNode, TopNNode, TopNRowNumberNode,
    UnnestNode,
    ValuesNode, WindowNode, WindowSpec, new_id,
)

_ALIAS_RE = re.compile(r"\s+[Aa][Ss]\s+([A-Za-z_]\w*)\s*$")
_AGG_RE = re.compile(r"(?is)^\s*([A-Za-z_]\w*)\s*\((.*)\)\s*$")
#: the direction keyword needs leading whitespace, else a trailing
#: "desc" in a column name (i_item_desc) parses as DESC
_SORT_RE = re.compile(
    r"(?i)^\s*(.*?)(?:\s+(asc|desc))?(?:\s+nulls\s+(first|last))?\s*$")


def parse_named_expr(text: str, default_name: Optional[str] = None
                     ) -> Tuple[str, Expr]:
    """Parse ``<expr> [AS alias]``; plain fields name themselves."""
    m = _ALIAS_RE.search(text)
    if m and text[: m.start()].count("(") == text[: m.start()].count(")"):
        return m.group(1), parse_expr(text[: m.start()])
    e = parse_expr(text)
    if isinstance(e, FieldRef):
        return e.name, e
    return default_name or text.strip(), e


def _parse_sort(text: str) -> SortField:
    m = _SORT_RE.match(text)
    assert m, text
    name = m.group(1)
    desc = (m.group(2) or "asc").lower() == "desc"
    nulls = m.group(3)
    # NULLS LAST is the default regardless of direction (Presto;
    # velox/duckdb/conversion/DuckParser.cpp:935)
    nulls_first = (nulls or "last").lower() == "first"
    return SortField(name, desc, nulls_first)


def _split_args(inner: str) -> List[str]:
    out, depth, cur = [], 0, []
    for ch in inner:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        if ch == "," and depth == 0:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if cur:
        out.append("".join(cur))
    return [a.strip() for a in out if a.strip()]


def _parse_agg(text: str, default_name: str
               ) -> Tuple[str, str, List[Expr], bool]:
    """'sum(x) AS s' -> (name, fn, [arg exprs], distinct)."""
    name = default_name
    m = _ALIAS_RE.search(text)
    body = text
    if m and text[: m.start()].count("(") == text[: m.start()].count(")"):
        name, body = m.group(1), text[: m.start()]
    cm = _AGG_RE.match(body)
    if not cm:
        raise SyntaxError(f"not an aggregate call: {text!r}")
    fn = cm.group(1).lower()
    inner = cm.group(2).strip()
    distinct = False
    if re.match(r"(?i)^distinct\s", inner):
        distinct = True
        inner = inner[len("distinct"):].strip()
    if inner in ("", "*"):
        args: List[Expr] = []
    else:
        args = [parse_expr(a) for a in _split_args(inner)]
    return name, fn, args, distinct


def _collect_field_refs(expr):
    from velox_tpu_torch.expr.ir import FieldRef

    if isinstance(expr, FieldRef):
        yield expr
    for c in expr.children:
        yield from _collect_field_refs(c)


def _expand_wide(parsed, schema, masks):
    """Long-decimal aggregate expansion: ``count``/``sum``/``avg``/
    ``min``/``max`` over a shredded DECIMAL(p > 18) column become
    aggregates of its digit lanes whose output names carry the lane
    pattern (``{name}#w{d}s{scale}``, and ``{name}#wn`` for an average's
    count); ``run_plan`` reassembles them. Sums read all three lanes and
    carry between them (``functions/aggregates_wide.py``), where the JAX
    package sums each lane alone. A mask on the call applies to every
    lane aggregate."""
    from velox_tpu_torch.expr.compiler import _wide_lanes

    out = []
    for name, fn, fargs, distinct in parsed:
        wl = None
        if (len(fargs) == 1 and isinstance(fargs[0], FieldRef)
                and not schema.contains(fargs[0].name)):
            wl = _wide_lanes(schema, fargs[0].name)
        if wl is None:
            out.append((name, fn, fargs, distinct))
            continue
        lanes, scale = wl
        lane_out = [f"{name}#w{d}s{scale}" for d in (2, 1, 0)]
        if name in masks:
            for ln in lane_out + [f"{name}#wn"]:
                masks[ln] = masks[name]
        if fn == "count":
            out.append((name, "count", [lanes[2]], distinct))
        elif fn in ("sum", "avg"):
            for d, ln in zip((2, 1, 0), lane_out):
                out.append((ln, f"sum_wide{d}", list(lanes), distinct))
            if fn == "avg":
                out.append((f"{name}#wn", "count", [lanes[2]], distinct))
        elif fn in ("min", "max"):
            for d, ln in zip((2, 1, 0), lane_out):
                out.append((ln, f"{fn}_wide{d}", list(lanes), distinct))
        else:
            raise NotImplementedError(f"{fn} over long-decimal columns")
    return out


class PlanBuilder:
    """Build a plan tree fluently; every method returns self."""

    def __init__(self, node: Optional[PlanNode] = None):
        self.node = node

    def fork(self) -> "PlanBuilder":
        """New builder over the current node: chain a second consumer
        off a shared sub-plan (CTE) without mutating this chain —
        builder methods rebind ``self.node`` in place."""
        return PlanBuilder(self.node)

    # ------------------------------------------------------------- leaves
    def values(self, batches: Sequence) -> "PlanBuilder":
        schema = batches[0].schema
        self.node = ValuesNode(new_id(), schema, tuple(batches))
        return self

    def table_scan(
        self, table: str, columns: Optional[Sequence[str]] = None,
        subfilter: Optional[str] = None,
    ) -> "PlanBuilder":
        from velox_tpu_torch.io.catalog import get_table

        t = get_table(table)
        names = list(columns) if columns else list(t.schema.names)
        groups = dict(getattr(t, "struct_groups", None) or {})
        # long-decimal columns expand to digit lanes the same way
        # struct columns expand to leaves (types/widedec.py)
        groups.update(getattr(t, "wide_groups", None) or {})
        if groups:
            expanded = []
            for n in names:
                expanded.extend(groups.get(n, [n]))
            names = expanded
        types = [t.schema.find_child(n) for n in names]
        schema = row_type(names, types)
        sf = None
        filter_cols: List[str] = []
        if subfilter is not None:
            # filter-only columns (velox ScanSpec children that are read
            # for filtering but not projected): resolve against the full
            # table schema, record the extras
            sf0 = parse_expr(subfilter)
            refs = sorted({f.name for f in _collect_field_refs(sf0)})
            filter_cols = [n for n in refs if n not in names]
            full = row_type(
                names + filter_cols,
                types + [t.schema.find_child(n) for n in filter_cols])
            sf = resolve_types(sf0, full)
        self.node = TableScanNode(
            new_id(), schema, table, tuple(names), sf,
            tuple(filter_cols))
        return self

    def exchange(self, schema: RowType, num_partitions: int = 1
                 ) -> "PlanBuilder":
        self.node = ExchangeNode(new_id(), schema, num_partitions)
        return self

    # --------------------------------------------------------- row-by-row
    def filter(self, predicate: Union[str, Expr]) -> "PlanBuilder":
        e = parse_expr(predicate) if isinstance(predicate, str) else predicate
        e = resolve_types(e, self.node.output_type)
        self.node = FilterNode(
            new_id(), self.node.output_type, self.node, e)
        return self

    def project(self, projections: Sequence[Union[str, Tuple[str, Expr]]]
                ) -> "PlanBuilder":
        names: List[str] = []
        exprs: List[Expr] = []
        for i, p in enumerate(projections):
            if isinstance(p, tuple):
                name, e = p
            else:
                name, e = parse_named_expr(p, f"p{i}")
            e = resolve_types(e, self.node.output_type)
            names.append(name)
            exprs.append(e)
        exprs = self._peel_complex_args(names, exprs)
        schema = row_type(names, [e.dtype for e in exprs])
        self.node = ProjectNode(
            new_id(), schema, self.node, tuple(names), tuple(exprs))
        return self

    def _peel_complex_args(self, names: List[str],
                           exprs: List[Expr]) -> List[Expr]:
        """Materialize NESTED array/map-typed calls into chained
        pre-projections: the complex-function appliers (ProjectOp /
        exec/complex_fns.py) take their array/map inputs as COLUMNS,
        so e.g. ngrams(split(s, ' '), 2) becomes
        project(__cx0 := split(s, ' ')) then ngrams(__cx0, 2) — the
        velox analog is the implicit intermediate vector every nested
        vector-function call produces."""
        from velox_tpu_torch.expr.ir import Call, Cast, Lambda, TryExpr
        from velox_tpu_torch.types.types import ArrayType, MapType

        pending: List[Tuple[str, Expr]] = []
        counter = [0]

        def peel(e: Expr, top: bool) -> Expr:
            if isinstance(e, Lambda):
                return e          # bodies evaluate in element space
            if isinstance(e, Cast):
                return Cast(e.dtype, peel(e.expr, False),
                            e.null_on_failure)
            if isinstance(e, TryExpr):
                return TryExpr(e.dtype, peel(e.expr, False))
            if not isinstance(e, Call):
                return e
            new_args = tuple(peel(a, False) for a in e.args)
            if new_args != e.args:
                e = Call(e.dtype, e.name, new_args)
            if (not top and isinstance(e.dtype, (ArrayType, MapType))
                    and e.name != "array_constructor"):
                tmp = f"__cx{counter[0]}"
                counter[0] += 1
                pending.append((tmp, e))
                return FieldRef(e.dtype, tmp)
            return e

        out = [peel(e, True) for e in exprs]
        for tmp, te in pending:
            src = self.node.output_type
            pnames = list(src.names) + [tmp]
            pexprs = [FieldRef(t, n)
                      for n, t in zip(src.names, src.children)] + [te]
            schema = row_type(pnames, [x.dtype for x in pexprs])
            self.node = ProjectNode(
                new_id(), schema, self.node, tuple(pnames),
                tuple(pexprs))
        return out

    # -------------------------------------------------------- aggregation
    def aggregate(
        self,
        keys: Sequence[str],
        aggs: Sequence[str],
        step: Union[str, AggStep] = AggStep.SINGLE,
        masks: Optional[Dict[str, str]] = None,
    ) -> "PlanBuilder":
        step = AggStep(step) if isinstance(step, str) else step
        schema = self.node.output_type
        masks = dict(masks or {})

        key_names: List[str] = []
        pre_names: List[str] = []
        pre_exprs: List[Expr] = []
        need_project = False
        for i, k in enumerate(keys):
            name, e = parse_named_expr(k, f"k{i}")
            e = resolve_types(e, schema)
            key_names.append(name)
            pre_names.append(name)
            pre_exprs.append(e)
            if not (isinstance(e, FieldRef) and e.name == name):
                need_project = True

        specs: List[AggregateSpec] = []
        agg_names: List[str] = []
        arg_types: List[Optional[DataType]] = []
        for name, fn, fargs, distinct in _expand_wide(
                [_parse_agg(a, f"a{i}") for i, a in enumerate(aggs)],
                schema, masks):
            if fn in ("max_data_size_for_stats", "sum_data_size_for_stats"):
                # MaxSizeForStatsAggregate / SumDataSizeForStats: max or
                # sum over the per-row serialized size
                fargs = [Call(None, "data_size_for_stats", tuple(fargs))]
                fn = fn.split("_data_size", 1)[0]
            lookup_aggregate(fn)  # validate early
            options = None
            if fn == "reduce_agg":
                # reduce_agg(x, init, (a, b) -> combine): the init and the
                # lambda stay on the host (spec.options); only the value
                # expression becomes an input column
                assert len(fargs) == 3 and isinstance(fargs[1], Literal) \
                    and isinstance(fargs[2], Lambda), (
                        "reduce_agg(x, init_literal, (a, b) -> expr)")
                options = (fargs[1].value, fargs[2])
                fargs = fargs[:1]
            fields: List[str] = []
            types: List[DataType] = []
            for ai, arg in enumerate(fargs):
                arg = resolve_types(arg, schema)
                types.append(arg.dtype)
                if isinstance(arg, FieldRef):
                    fields.append(arg.name)
                    if arg.name not in pre_names:
                        pre_names.append(arg.name)
                        pre_exprs.append(arg)
                else:
                    f = f"{name}_arg{ai}" if len(fargs) > 1 else \
                        f"{name}_arg"
                    fields.append(f)
                    pre_names.append(f)
                    pre_exprs.append(arg)
                    need_project = True
            # single-arg keeps the scalar form (serde/operator compat);
            # multi-arg aggregates (min_by, covar, corr ...) carry tuples
            arg_field = (None if not fields
                         else fields[0] if len(fields) == 1
                         else tuple(fields))
            at = (None if not types
                  else types[0] if len(types) == 1 else tuple(types))
            mask = masks.get(name)
            if mask is not None and mask not in pre_names:
                pre_names.append(mask)
                pre_exprs.append(resolve_types(FieldRef(None, mask), schema))
            specs.append(AggregateSpec(fn, arg_field, mask, distinct,
                                       options))
            agg_names.append(name)
            arg_types.append(at)

        source = self.node
        if need_project:
            pschema = row_type(pre_names, [e.dtype for e in pre_exprs])
            source = ProjectNode(
                new_id(), pschema, source, tuple(pre_names), tuple(pre_exprs))
            schema = pschema

        key_types = [schema.find_child(n) for n in key_names]
        out_names = list(key_names)
        out_types = list(key_types)
        for name, spec, at in zip(agg_names, specs, arg_types):
            fn = lookup_aggregate(spec.fn)
            if step == AggStep.PARTIAL:
                if fn.collect_kind in ("array", "set", "map") \
                        and not fn.lanes:
                    # the page form: the collected ARRAY/MAP as one page
                    # column, which FINAL expands into element rows
                    out_names.append(f"{name}$0")
                    out_types.append(fn.resolve_type(at))
                    continue
                # one column per accumulator lane, ``name$lane``; a matrix
                # lane one per slot, ``name$lane@slot``
                for li, (lane, lt) in enumerate(
                        zip(fn.lanes, fn.lane_types(at))):
                    if lane.width == 1:
                        out_names.append(f"{name}${li}")
                        out_types.append(lt)
                    else:
                        for j in range(lane.width):
                            out_names.append(f"{name}${li}@{j}")
                            out_types.append(lt)
            else:
                out_names.append(name)
                out_types.append(fn.resolve_type(at))
        out_schema = row_type(out_names, out_types)
        self.node = AggregationNode(
            new_id(), out_schema, source, step, tuple(key_names),
            tuple(agg_names), tuple(specs))
        return self

    def partial_aggregation(self, keys: Sequence[str], aggs: Sequence[str],
                            masks: Optional[Dict[str, str]] = None
                            ) -> "PlanBuilder":
        """The PARTIAL step: emits the keys and each aggregate's lanes."""
        return self.aggregate(keys, aggs, AggStep.PARTIAL, masks)

    def final_aggregation(self, keys: Optional[Sequence[str]] = None,
                          aggs: Optional[Sequence[str]] = None
                          ) -> "PlanBuilder":
        """The FINAL step over partial lane columns. With no arguments the
        keys and aggregates are those of the nearest PARTIAL aggregation
        upstream; explicit ``aggs`` name lane columns ``name$i``."""
        schema = self.node.output_type
        if keys is None or aggs is None:
            src = self.node
            while src is not None and not (
                    isinstance(src, AggregationNode)
                    and src.step == AggStep.PARTIAL):
                src = src.sources[0] if src.sources else None
            if src is None:
                raise ValueError("no upstream partial aggregation")
            key_names = list(src.keys)
            agg_names = list(src.agg_names)
            specs = list(src.aggregates)
        else:
            key_names = list(keys)
            agg_names, specs = [], []
            for i, a in enumerate(aggs):
                name, fn, _, distinct = _parse_agg(a, f"a{i}")
                agg_names.append(name)
                specs.append(AggregateSpec(fn, None, None, distinct))
        out_names = list(key_names)
        out_types = [schema.find_child(n) for n in key_names]
        for name, spec in zip(agg_names, specs):
            lane_types = []
            li = 0
            while True:
                if schema.contains(f"{name}${li}"):
                    lane_types.append(schema.find_child(f"{name}${li}"))
                elif schema.contains(f"{name}${li}@0"):
                    lane_types.append(schema.find_child(f"{name}${li}@0"))
                else:
                    break
                li += 1
            if not lane_types:
                raise ValueError(f"no partial lanes for {name}")
            out_names.append(name)
            out_types.append(lookup_aggregate(spec.fn).resolve_final_type(
                tuple(lane_types)))
        self.node = AggregationNode(
            new_id(), row_type(out_names, out_types), self.node,
            AggStep.FINAL, tuple(key_names), tuple(agg_names), tuple(specs))
        return self

    def distinct(self) -> "PlanBuilder":
        return self.aggregate(list(self.node.output_type.names), [])

    # -------------------------------------------------------------- order
    def order_by(self, keys: Sequence[str]) -> "PlanBuilder":
        sf = tuple(_parse_sort(k) for k in keys)
        self.node = OrderByNode(
            new_id(), self.node.output_type, self.node, sf)
        return self

    def top_n(self, keys: Sequence[str], count: int) -> "PlanBuilder":
        sf = tuple(_parse_sort(k) for k in keys)
        self.node = TopNNode(
            new_id(), self.node.output_type, self.node, sf, count)
        return self

    def limit(self, count: int, offset: int = 0) -> "PlanBuilder":
        self.node = LimitNode(
            new_id(), self.node.output_type, self.node, offset, count)
        return self

    # -------------------------------------------------------------- joins
    def hash_join(
        self,
        right: Union["PlanBuilder", PlanNode],
        left_keys: Sequence[str],
        right_keys: Sequence[str],
        join_type: Union[str, JoinType] = JoinType.INNER,
        output: Optional[Sequence[str]] = None,
        filter: Optional[str] = None,
        merge: bool = False,
    ) -> "PlanBuilder":
        rnode = right.node if isinstance(right, PlanBuilder) else right
        jt = JoinType(join_type) if isinstance(join_type, str) else join_type
        lt, rt = self.node.output_type, rnode.output_type

        if jt in (JoinType.LEFT_SEMI, JoinType.ANTI, JoinType.ANTI_SIMPLE):
            all_names = list(lt.names)
            all_types = list(lt.children)
        elif jt == JoinType.RIGHT_SEMI:
            all_names = list(rt.names)
            all_types = list(rt.children)
        else:
            dup = set(lt.names) & set(rt.names)
            assert not dup, f"join output name clash: {sorted(dup)}"
            all_names = list(lt.names) + list(rt.names)
            all_types = list(lt.children) + list(rt.children)

        if output is not None:
            keep = {n: t for n, t in zip(all_names, all_types)}
            all_names = list(output)
            all_types = [keep[n] for n in all_names]
        schema = row_type(all_names, all_types)

        fexpr = None
        if filter is not None:
            both = row_type(
                tuple(lt.names) + tuple(rt.names),
                tuple(lt.children) + tuple(rt.children))
            fexpr = resolve_types(parse_expr(filter), both)

        cls = MergeJoinNode if merge else HashJoinNode
        self.node = cls(
            new_id(), schema, self.node, rnode, jt,
            tuple(left_keys), tuple(right_keys), fexpr)
        return self

    def merge_join(self, *args, **kwargs) -> "PlanBuilder":
        return self.hash_join(*args, merge=True, **kwargs)

    def index_lookup_join(
        self, right: Union["PlanBuilder", PlanNode],
        left_keys: Sequence[str], right_keys: Sequence[str],
        join_type: Union[str, JoinType] = JoinType.INNER,
        output: Optional[Sequence[str]] = None,
    ) -> "PlanBuilder":
        """Join against an indexed table source
        (velox/exec/IndexLookupJoin.h:24): the right side must be a
        TableScan whose lookup key the catalog verified strictly
        increasing (unique) at ingest. Lowered onto the kArray
        direct-address probe (the index)."""
        from velox_tpu_torch.io.catalog import get_table
        from velox_tpu_torch.plan.nodes import IndexLookupJoinNode, TableScanNode

        rnode = right.node if isinstance(right, PlanBuilder) else right
        assert isinstance(rnode, TableScanNode), (
            "index_lookup_join right side must be a TableScan")
        t = get_table(rnode.table)
        for k in right_keys:
            assert k in t.unique_cols, (
                f"index_lookup_join: {k!r} is not a verified-unique "
                f"index column of {rnode.table!r} "
                f"(unique: {sorted(t.unique_cols)})")
        self.hash_join(right, left_keys, right_keys, join_type, output)
        n = self.node
        self.node = IndexLookupJoinNode(
            n.id, n.output_type, n.left, n.right, n.join_type,
            n.left_keys, n.right_keys, n.filter)
        return self

    def cross_join(
        self,
        right: Union["PlanBuilder", PlanNode],
        filter: Optional[str] = None,
        output: Optional[Sequence[str]] = None,
        join_type: Union[str, JoinType] = JoinType.INNER,
    ) -> "PlanBuilder":
        rnode = right.node if isinstance(right, PlanBuilder) else right
        jt = JoinType(join_type) if isinstance(join_type, str) else join_type
        lt, rt = self.node.output_type, rnode.output_type
        all_names = list(lt.names) + list(rt.names)
        all_types = list(lt.children) + list(rt.children)
        if output is not None:
            keep = {n: t for n, t in zip(all_names, all_types)}
            all_names = list(output)
            all_types = [keep[n] for n in all_names]
        schema = row_type(all_names, all_types)
        fexpr = None
        if filter is not None:
            both = row_type(
                tuple(lt.names) + tuple(rt.names),
                tuple(lt.children) + tuple(rt.children))
            fexpr = resolve_types(parse_expr(filter), both)
        self.node = CrossJoinNode(new_id(), schema, self.node, rnode, jt, fexpr)
        return self

    # ------------------------------------------------------------- window
    def window(
        self, partition_keys: Sequence[str], sort_keys: Sequence[str],
        functions: Sequence[str],
    ) -> "PlanBuilder":
        """functions: e.g. 'row_number() AS rn', 'rank() AS r',
        'sum(x) AS s'."""
        schema = self.node.output_type
        specs: List[WindowSpec] = []
        out_names = list(schema.names)
        out_types = list(schema.children)
        for i, f in enumerate(functions):
            frame = None
            frame_type = "rows"
            bound = (r"(?:unbounded\s+(?:preceding|following)"
                     r"|current\s+row"
                     r"|\d+(?:\.\d+)?\s+(?:preceding|following))")
            m = re.search(
                rf"(?i)\s+(rows|range)\s+between\s+({bound})"
                rf"\s+and\s+({bound})", f)
            if m:
                f = f[: m.start()] + f[m.end():]
                frame_type = m.group(1).lower()

                def parse_bound(txt, is_start):
                    t = txt.lower()
                    if "unbounded" in t:
                        return None
                    if "current" in t:
                        return 0
                    num = float(t.split()[0])
                    if frame_type == "rows":
                        num = int(num)
                    # start "following" / end "preceding" are negative
                    return num if ("preceding" in t) == is_start                         else -num

                frame = (parse_bound(m.group(2), True),
                         parse_bound(m.group(3), False))
            name, fn, fargs, _ = _parse_agg(f, f"w{i}")
            arg_field = None
            arg_literal = None
            at = None
            for a in fargs:
                from velox_tpu_torch.expr.ir import Literal

                if isinstance(a, FieldRef) and arg_field is None:
                    arg_field = a.name
                    at = resolve_types(a, schema).dtype
                elif isinstance(a, Literal) and arg_literal is None:
                    arg_literal = a.value
                else:
                    raise SyntaxError(
                        f"window arg must be a field or literal: {f!r}")
            specs.append(
                WindowSpec(name, fn, arg_field, arg_literal, frame,
                           frame_type))
            out_names.append(name)
            out_types.append(_window_result_type(fn, at))
        self.node = WindowNode(
            new_id(), row_type(out_names, out_types), self.node,
            tuple(partition_keys), tuple(_parse_sort(k) for k in sort_keys),
            tuple(specs))
        return self

    def row_number(
        self, partition_keys: Sequence[str],
        row_number_name: Optional[str] = "row_number",
        limit: Optional[int] = None,
    ) -> "PlanBuilder":
        schema = self.node.output_type
        if row_number_name is not None:
            schema = row_type(
                list(schema.names) + [row_number_name],
                list(schema.children) + [BIGINT])
        self.node = RowNumberNode(
            new_id(), schema, self.node, tuple(partition_keys),
            row_number_name, limit)
        return self

    def top_n_row_number(
        self, partition_keys: Sequence[str], sort_keys: Sequence[str],
        limit: int, row_number_name: Optional[str] = "row_number",
    ) -> "PlanBuilder":
        schema = self.node.output_type
        if row_number_name is not None:
            schema = row_type(
                list(schema.names) + [row_number_name],
                list(schema.children) + [BIGINT])
        self.node = TopNRowNumberNode(
            new_id(), schema, self.node, tuple(partition_keys),
            tuple(_parse_sort(k) for k in sort_keys), row_number_name, limit)
        return self

    # --------------------------------------------------------------- misc
    def group_id(self, grouping_sets: Sequence[Sequence[str]],
                 group_id_name: str = "group_id") -> "PlanBuilder":
        schema = self.node.output_type
        self.node = GroupIdNode(
            new_id(),
            row_type(
                list(schema.names) + [group_id_name],
                list(schema.children) + [BIGINT]),
            self.node,
            tuple(tuple(g) for g in grouping_sets), group_id_name)
        return self

    def mark_distinct(self, marker: str, keys: Sequence[str]) -> "PlanBuilder":
        schema = self.node.output_type
        schema = row_type(
            list(schema.names) + [marker],
            list(schema.children) + [BOOLEAN])
        self.node = MarkDistinctNode(
            new_id(), schema, self.node, marker, tuple(keys))
        return self

    def assign_unique_id(self, id_name: str = "unique_id",
                         task_unique_id: int = 0) -> "PlanBuilder":
        schema = self.node.output_type
        schema = row_type(
            list(schema.names) + [id_name],
            list(schema.children) + [BIGINT])
        self.node = AssignUniqueIdNode(
            new_id(), schema, self.node, id_name, task_unique_id)
        return self

    def enforce_single_row(self) -> "PlanBuilder":
        self.node = EnforceSingleRowNode(
            new_id(), self.node.output_type, self.node)
        return self

    def streaming_aggregate(
        self, keys: Sequence[str], aggs: Sequence[str],
        masks: Optional[Dict[str, str]] = None,
    ) -> "PlanBuilder":
        """Aggregation assuming input is clustered on ``keys``
        (velox PlanBuilder::streamingAggregation)."""
        from velox_tpu_torch.plan.nodes import StreamingAggregationNode

        self.aggregate(keys, aggs, AggStep.SINGLE, masks)
        n = self.node
        self.node = StreamingAggregationNode(
            n.id, n.output_type, n.source, n.step, n.keys, n.agg_names,
            n.aggregates)
        return self

    def unnest(self, replicated: Sequence[str], unnest: Sequence[str],
               ordinality: Optional[str] = None) -> "PlanBuilder":
        """Explode ARRAY columns (velox PlanBuilder::unnest,
        velox/exec/tests/utils/PlanBuilder.h:1124): output = replicated
        scalars + one element column per unnest input (+ optional 1-based
        BIGINT ordinality)."""
        from velox_tpu_torch.types.types import ArrayType

        schema = self.node.output_type
        types = dict(zip(schema.names, schema.children))
        names: List[str] = list(replicated)
        children: List[DataType] = [types[n] for n in replicated]
        for n in unnest:
            t = types[n]
            assert isinstance(t, ArrayType), f"unnest of non-ARRAY {n}: {t}"
            names.append(n)
            children.append(t.element)
        if ordinality is not None:
            names.append(ordinality)
            children.append(BIGINT)
        out = row_type(names, children)
        self.node = UnnestNode(
            new_id(), out, self.node, tuple(replicated), tuple(unnest),
            ordinality)
        return self

    def table_write(self, path: str, format: str = "parquet",
                    partition_by: Sequence[str] = (),
                    scale_writers: int = 1) -> "PlanBuilder":
        """Write the plan's output to a file/dataset; the plan then
        returns ROW<rows BIGINT> (velox PlanBuilder::tableWrite).
        ``scale_writers > 1`` fans hot partitions out across several
        balanced files (ScaleWriterLocalPartition analog)."""
        out = row_type(["rows"], [BIGINT])
        self.node = TableWriteNode(
            new_id(), out, self.node, path, format, tuple(partition_by),
            scale_writers)
        return self

    def union_all(self, others: Sequence["PlanBuilder"]) -> "PlanBuilder":
        """Bag union with same-schema sources (velox
        PlanBuilder::localPartition gather form)."""
        from velox_tpu_torch.plan.nodes import UnionAllNode

        nodes = [self.node] + [
            o.node if isinstance(o, PlanBuilder) else o for o in others]
        for n in nodes[1:]:
            assert tuple(n.output_type.names) == tuple(
                nodes[0].output_type.names), "union schema mismatch"
        self.node = UnionAllNode(
            new_id(), nodes[0].output_type, tuple(nodes))
        return self

    def local_merge(self, others: Sequence["PlanBuilder"],
                    keys: Sequence[str]) -> "PlanBuilder":
        """Ordered merge of key-sorted sources (velox
        PlanBuilder::localMerge)."""
        from velox_tpu_torch.plan.nodes import LocalMergeNode

        nodes = [self.node] + [
            o.node if isinstance(o, PlanBuilder) else o for o in others]
        sort_keys = tuple(_parse_sort(k) for k in keys)
        self.node = LocalMergeNode(
            new_id(), nodes[0].output_type, tuple(nodes), sort_keys)
        return self

    def local_partition(self, keys: Sequence[str],
                        num_partitions: int) -> "PlanBuilder":
        self.node = LocalPartitionNode(
            new_id(), self.node.output_type, self.node, tuple(keys),
            num_partitions)
        return self

    def build(self) -> PlanNode:
        assert self.node is not None
        return self.node


def _window_result_type(fn: str, arg_type: Optional[DataType]) -> DataType:
    from velox_tpu_torch.types import DOUBLE

    if fn in ("row_number", "rank", "dense_rank", "ntile", "count"):
        return BIGINT
    if fn in ("percent_rank", "cume_dist"):
        return DOUBLE
    if fn in ("lead", "lag", "first_value", "last_value", "nth_value"):
        assert arg_type is not None
        return arg_type
    # aggregate-as-window
    return lookup_aggregate(fn).resolve_type(arg_type)
