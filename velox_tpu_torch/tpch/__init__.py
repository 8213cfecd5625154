"""TPC-H query plans: all 22 queries, and the clustered Q3/Q18 variants."""

from velox_tpu_torch.tpch.queries import (  # noqa: F401
    CLUSTERED_QUERIES, SUPPORTED_QUERIES, tpch_plan,
)
