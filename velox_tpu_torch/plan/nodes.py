"""PlanNode hierarchy.

Analog of velox/core/PlanNode.h:175 (~36 node types, :354-6501). Nodes are
immutable descriptions; ``output_type`` is resolved eagerly by PlanBuilder
so every node carries its schema (velox nodes do the same via outputType()).
Each node maps to one Operator in velox_tpu/exec (velox/exec/LocalPlanner.cpp
driver-factory analog).
"""

from __future__ import annotations

import enum
import itertools
from dataclasses import dataclass, field as dc_field
from typing import Dict, List, Optional, Sequence, Tuple

from velox_tpu_torch.types.types import RowType
from velox_tpu_torch.expr.ir import Expr

_ids = itertools.count()


def _next_id() -> str:
    return str(next(_ids))


@dataclass(frozen=True)
class PlanNode:
    """Base node: id + resolved output schema."""

    id: str
    output_type: RowType

    @property
    def sources(self) -> Tuple["PlanNode", ...]:
        return ()

    def name(self) -> str:
        return type(self).__name__.replace("Node", "")


@dataclass(frozen=True)
class SourceNode(PlanNode):
    """One-input node."""

    source: PlanNode = None  # type: ignore[assignment]

    @property
    def sources(self) -> Tuple[PlanNode, ...]:
        return (self.source,)


# ------------------------------------------------------------------ leaves

@dataclass(frozen=True)
class ValuesNode(PlanNode):
    """Literal batches (velox/core/PlanNode.h ValuesNode :354)."""

    batches: Tuple = ()


@dataclass(frozen=True)
class TableScanNode(PlanNode):
    """Scan of a catalog table (velox TableScanNode; connector splits come
    from the session catalog, velox/connectors/Connector.h DataSource
    analog). ``subfilter`` is an optional pushed-down predicate applied by
    the scan itself (ScanSpec analog, velox/dwio/common/ScanSpec.h:41)."""

    table: str = ""
    columns: Tuple[str, ...] = ()
    subfilter: Optional[Expr] = None
    #: columns read ONLY to evaluate the subfilter (velox ScanSpec
    #: filter-only children): scanned + filtered, then dropped
    filter_columns: Tuple[str, ...] = ()

    @property
    def all_columns(self) -> Tuple[str, ...]:
        return tuple(self.columns) + tuple(self.filter_columns)


@dataclass(frozen=True)
class ExchangeNode(PlanNode):
    """Fragment boundary: consumes a remote/distributed source
    (velox/core/PlanNode.h:2182)."""

    num_partitions: int = 1


# ------------------------------------------------------------ row-by-row

@dataclass(frozen=True)
class FilterNode(SourceNode):
    predicate: Expr = None  # type: ignore[assignment]


@dataclass(frozen=True)
class ProjectNode(SourceNode):
    names: Tuple[str, ...] = ()
    exprs: Tuple[Expr, ...] = ()


# ------------------------------------------------------------- aggregation

class AggStep(enum.Enum):
    SINGLE = "single"
    PARTIAL = "partial"
    FINAL = "final"


@dataclass(frozen=True)
class AggregateSpec:
    """One aggregate call: fn over an input field (None = count(*)),
    optionally masked by a boolean field and/or distinct
    (velox/core/PlanNode.h AggregationNode::Aggregate).

    ``arg`` is a field name, a TUPLE of field names for multi-argument
    aggregates (min_by, covar_samp, corr ...), or None."""

    fn: str
    arg: Optional[object]
    mask: Optional[str] = None
    distinct: bool = False
    #: extra host parameters (reduce_agg: (init literal, combine
    #: Lambda)); serde round-trips exprs like any typed expr
    options: Optional[tuple] = None

    def __post_init__(self):
        # JSON serde round-trips tuples as lists; normalize so frozen
        # dataclass equality/hashing survive plan_from_dict
        if isinstance(self.arg, list):
            object.__setattr__(self, "arg", tuple(self.arg))


@dataclass(frozen=True)
class AggregationNode(SourceNode):
    step: AggStep = AggStep.SINGLE
    keys: Tuple[str, ...] = ()
    agg_names: Tuple[str, ...] = ()
    aggregates: Tuple[AggregateSpec, ...] = ()


@dataclass(frozen=True)
class StreamingAggregationNode(AggregationNode):
    """Aggregation over key-clustered input
    (velox/core/PlanNode.h AggregationNode step + exec/
    StreamingAggregation.h); closes groups on key change.

    ``having`` is a predicate over the aggregation's OWN output columns,
    folded in by the optimizer from a following FilterNode (the SQL
    HAVING shape): groups failing it never materialize — the emit stage
    sizes its output to the passing-group count, so a selective HAVING
    over millions of groups emits a tiny batch instead of a full-width
    one + a separate filter pass (TPC-H Q18's big_orders subquery)."""

    having: "Expr | None" = None


@dataclass(frozen=True)
class ExpandNode(SourceNode):
    """Each input row -> N rows from N projection lists
    (velox/core/PlanNode.h:1913, feeds grouping sets)."""

    projections: Tuple[Tuple[Expr, ...], ...] = ()
    names: Tuple[str, ...] = ()


@dataclass(frozen=True)
class GroupIdNode(SourceNode):
    """GROUPING SETS expansion (velox/core/PlanNode.h:2018)."""

    grouping_sets: Tuple[Tuple[str, ...], ...] = ()
    group_id_name: str = "group_id"


@dataclass(frozen=True)
class MarkDistinctNode(SourceNode):
    """Adds a boolean marker on first occurrence per key
    (velox/core/PlanNode.h:5638)."""

    marker: str = ""
    keys: Tuple[str, ...] = ()


# ------------------------------------------------------------------ order

@dataclass(frozen=True)
class SortField:
    name: str
    descending: bool = False
    nulls_first: bool = False


@dataclass(frozen=True)
class OrderByNode(SourceNode):
    keys: Tuple[SortField, ...] = ()


@dataclass(frozen=True)
class TopNNode(SourceNode):
    keys: Tuple[SortField, ...] = ()
    count: int = 0


@dataclass(frozen=True)
class LimitNode(SourceNode):
    offset: int = 0
    count: int = 0


# ------------------------------------------------------------------- joins

class JoinType(enum.Enum):
    INNER = "inner"
    LEFT = "left"
    RIGHT = "right"
    FULL = "full"
    LEFT_SEMI = "left_semi"
    RIGHT_SEMI = "right_semi"
    ANTI = "anti"          # null-aware: NOT IN semantics
    ANTI_SIMPLE = "anti_simple"  # NOT EXISTS semantics


@dataclass(frozen=True)
class HashJoinNode(PlanNode):
    """Equi-join (velox AbstractJoinNode core/PlanNode.h:3238; 10 join
    types). ``left`` is the probe side, ``right`` the build side (matches
    velox's convention)."""

    left: PlanNode = None   # type: ignore[assignment]
    right: PlanNode = None  # type: ignore[assignment]
    join_type: JoinType = JoinType.INNER
    left_keys: Tuple[str, ...] = ()
    right_keys: Tuple[str, ...] = ()
    filter: Optional[Expr] = None

    @property
    def sources(self) -> Tuple[PlanNode, ...]:
        return (self.left, self.right)


@dataclass(frozen=True)
class IndexLookupJoinNode(HashJoinNode):
    """Lookup join against an INDEXED source (velox/core/PlanNode.h
    IndexLookupJoinNode + exec/IndexLookupJoin.h:24). TPU redesign: the
    kArray direct-address table this engine builds for every join IS
    the index (two gathers per probe row), so the lookup join lowers to
    the ordinary build/probe machinery — the node exists for plan
    parity and validates the index precondition (the right side must be
    a table scan whose key column the catalog verified strictly
    increasing at ingest)."""


@dataclass(frozen=True)
class MergeJoinNode(HashJoinNode):
    """Join over inputs already sorted on the keys
    (velox/exec/MergeJoin.h:47)."""


@dataclass(frozen=True)
class CrossJoinNode(PlanNode):
    """Nested-loop join (velox NestedLoopJoinNode core/PlanNode.h:4089)."""

    left: PlanNode = None   # type: ignore[assignment]
    right: PlanNode = None  # type: ignore[assignment]
    join_type: JoinType = JoinType.INNER
    filter: Optional[Expr] = None

    @property
    def sources(self) -> Tuple[PlanNode, ...]:
        return (self.left, self.right)


# ------------------------------------------------------------------ window

@dataclass(frozen=True)
class WindowSpec:
    """One window function call (velox/core/PlanNode.h:5261 WindowNode)."""

    name: str          # output column
    fn: str            # row_number, rank, sum, ...
    arg: Optional[str] = None          # input field
    arg_literal: Optional[float] = None  # ntile(k) / lead(x, k) constant
    #: frame (preceding, following); None components = UNBOUNDED;
    #: frame=None = the default RANGE UNBOUNDED PRECEDING..CURRENT ROW.
    #: "N following" as the start / "N preceding" as the end are
    #: negative offsets. For frame_type="range" the offsets are ORDER-BY
    #: VALUE deltas (k-range, velox/exec/window/KRangeFrameBound.h) and
    #: 0 means CURRENT ROW (= the peer-group bound).
    frame: Optional[Tuple[Optional[float], Optional[float]]] = None
    #: "rows" | "range"
    frame_type: str = "rows"


@dataclass(frozen=True)
class WindowNode(SourceNode):
    partition_keys: Tuple[str, ...] = ()
    sort_keys: Tuple[SortField, ...] = ()
    functions: Tuple[WindowSpec, ...] = ()


@dataclass(frozen=True)
class StreamingWindowNode(WindowNode):
    """Window over input CLUSTERED by the partition keys
    (velox/exec/window/RowsStreamingWindowBuild.h): complete partitions
    evaluate and emit per input batch; only the trailing incomplete
    partition buffers across batches."""


@dataclass(frozen=True)
class RowNumberNode(SourceNode):
    """Partitioned row numbering w/o sort (velox/core/PlanNode.h:5495)."""

    partition_keys: Tuple[str, ...] = ()
    row_number_name: Optional[str] = "row_number"
    limit: Optional[int] = None


@dataclass(frozen=True)
class TopNRowNumberNode(SourceNode):
    """Keep top-N rows per partition (velox/core/PlanNode.h:6000)."""

    partition_keys: Tuple[str, ...] = ()
    sort_keys: Tuple[SortField, ...] = ()
    row_number_name: Optional[str] = "row_number"
    limit: int = 1


# ------------------------------------------------------------------- misc

@dataclass(frozen=True)
class UnionAllNode(PlanNode):
    """Bag union of same-schema sources (velox MixedUnion /
    LocalPartition-gather form, core/PlanNode.h:2545)."""

    inputs: Tuple[PlanNode, ...] = ()

    @property
    def sources(self) -> Tuple[PlanNode, ...]:
        return self.inputs


@dataclass(frozen=True)
class LocalMergeNode(PlanNode):
    """K-way ordered merge of key-sorted sources (velox
    LocalMergeNode core/PlanNode.h:1459 / exec/Merge.h:33). On TPU one
    bitonic sort over the union IS the merge."""

    inputs: Tuple[PlanNode, ...] = ()
    keys: Tuple["SortField", ...] = ()

    @property
    def sources(self) -> Tuple[PlanNode, ...]:
        return self.inputs


@dataclass(frozen=True)
class UnnestNode(SourceNode):
    """Explode array columns (velox/core/PlanNode.h:4860)."""

    replicated: Tuple[str, ...] = ()
    unnest: Tuple[str, ...] = ()
    ordinality: Optional[str] = None


@dataclass(frozen=True)
class AssignUniqueIdNode(SourceNode):
    """(velox/core/PlanNode.h:5153)"""

    id_name: str = "unique_id"
    task_unique_id: int = 0


@dataclass(frozen=True)
class EnforceSingleRowNode(SourceNode):
    """Uncorrelated scalar subquery guard (velox/core/PlanNode.h:5069)."""


@dataclass(frozen=True)
class TableWriteNode(SourceNode):
    """File sink (velox/core/PlanNode.h TableWriteNode; HiveDataSink
    velox/connectors/hive/HiveDataSink.h:406). Emits one summary row with
    the written row count."""

    path: str = ""
    format: str = "parquet"
    partition_by: Tuple[str, ...] = ()
    #: >1 enables skew-scaled file fan-out (ScaleWriterLocalPartition)
    scale_writers: int = 1


@dataclass(frozen=True)
class LocalPartitionNode(SourceNode):
    """In-task repartition (velox/core/PlanNode.h:2545); keys empty =
    round robin / gather."""

    keys: Tuple[str, ...] = ()
    num_partitions: int = 1


def new_id() -> str:
    return _next_id()
