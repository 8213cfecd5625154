"""Session configuration.

Analog of velox/core/QueryConfig.h pared to the knobs the port honors.
One process-wide instance (``config``), a copy of the JAX package's
``SessionConfig`` restricted to the flags this slice reads.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field


@dataclass
class SessionConfig:
    #: narrow lanes: DECIMAL(p<=9) lanes become int32, and grouped sums
    #: of 32-bit lanes go through the exact grouped-sum kernels
    #: (ops/grouped_sum.py)
    narrow_lanes: bool = field(
        default_factory=lambda: os.environ.get(
            "VELOX_TPU_NARROW_LANES", "0") == "1")

    #: run scan -> filter/project -> aggregation chains as one operator
    #: (exec/fused.py)
    fused_pipelines: bool = True

    #: run the sort-order property pass (plan/optimizer.py)
    optimize_plans: bool = True

    #: largest key span a join indexes with a direct-address (kArray)
    #: table instead of searching its sorted build keys
    karray_join_span: int = 1 << 26


config = SessionConfig()
