"""Plan IR and the fluent PlanBuilder (copies of the JAX package's)."""

from velox_tpu_torch.plan.nodes import (  # noqa: F401
    AggregateSpec, AggregationNode, AggStep, FilterNode, OrderByNode,
    PlanNode, ProjectNode, SortField, TableScanNode,
)
from velox_tpu_torch.plan.builder import PlanBuilder  # noqa: F401
