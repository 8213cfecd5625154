"""TPC-H query plans ported so far (Q1, Q6)."""

from velox_tpu_torch.tpch.queries import (  # noqa: F401
    SUPPORTED_QUERIES, tpch_plan,
)
