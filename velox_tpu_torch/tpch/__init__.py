"""TPC-H query plans ported so far (Q1, Q3, Q6, Q18)."""

from velox_tpu_torch.tpch.queries import (  # noqa: F401
    CLUSTERED_QUERIES, SUPPORTED_QUERIES, tpch_plan,
)
