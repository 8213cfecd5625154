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

    #: abandon a partial aggregation whose groups/rows ratio reaches
    #: ``abandon_partial_agg_min_pct`` once it has seen
    #: ``abandon_partial_agg_min_rows`` rows (velox
    #: abandon_partial_aggregation_min_pct / _min_rows)
    abandon_partial_agg_min_pct: float = 0.8
    abandon_partial_agg_min_rows: int = 100_000

    #: run scan -> filter/project -> aggregation chains as one operator
    #: (exec/fused.py)
    fused_pipelines: bool = True

    #: run the sort-order property pass (plan/optimizer.py)
    optimize_plans: bool = True

    #: largest key span a join indexes with a direct-address (kArray)
    #: table instead of searching its sorted build keys
    karray_join_span: int = 1 << 26

    #: session time zone (velox session_timezone with
    #: adjust_timestamp_to_session_timezone): the parts of a TIMESTAMP
    #: (hour, day, year, ...) read its instants in this zone
    #: (utils/tz.py)
    session_timezone: str = "UTC"

    #: device bytes that the buffers of blocking operators may hold
    #: before the largest moves to host RAM (exec/spill.py); None: no
    #: limit
    spill_memory_budget_bytes: "int | None" = None
    #: device bytes that one query's buffers may hold before its own
    #: largest moves to host RAM (exec/memory.py); None: no limit
    query_memory_cap_bytes: "int | None" = None
    #: hash partitions of a spilled aggregation's partials and of a
    #: spilled join build; the output merges or joins one at a time
    spill_agg_partitions: int = 8
    spill_join_partitions: int = 8
    #: host bytes of spilled batches beyond which the largest holder's
    #: batches move to page files (the third rung); None: host RAM is
    #: the last rung
    spill_host_budget_bytes: "int | None" = None
    #: threads that write page files in the background (0: the caller
    #: writes them)
    spill_io_threads: int = 2
    #: directory of the page files (None: the system's temporary one)
    spill_dir: "str | None" = None


config = SessionConfig()
