"""Scalar and aggregate functions (Presto semantics) over torch tensors."""

from velox_tpu_torch.functions.registry import (  # noqa: F401
    ScalarFunction, lookup_function, register_function, registry,
)
import velox_tpu_torch.functions.scalar  # noqa: F401  (registers)
from velox_tpu_torch.functions.aggregates import (  # noqa: F401
    AggregateFunction, aggregate_registry, lookup_aggregate,
)
