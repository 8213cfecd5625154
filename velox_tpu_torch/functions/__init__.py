"""Scalar and aggregate functions (Presto semantics) over torch tensors."""

from velox_tpu_torch.functions.registry import (  # noqa: F401
    ScalarFunction, lookup_function, register_function, registry,
)
import velox_tpu_torch.functions.scalar  # noqa: F401  (registers)
from velox_tpu_torch.functions.aggregates import (  # noqa: F401
    AggregateFunction, aggregate_registry, lookup_aggregate,
)
import velox_tpu_torch.functions.aggregates_multi  # noqa: F401,E402
import velox_tpu_torch.functions.aggregates_collect  # noqa: F401,E402
# approx_percentile gains digest lanes (its PARTIAL/FINAL form) on top of
# the exact single-step collect kind: register after the collect kinds
from velox_tpu_torch.functions.aggregates_digest import (  # noqa: E402
    register_percentile_digest,
)
from velox_tpu_torch.functions.aggregates_wide import (  # noqa: E402
    register_wide_aggregates,
)

register_percentile_digest()
register_wide_aggregates()
import velox_tpu_torch.functions.aggregates_noisy  # noqa: F401,E402
