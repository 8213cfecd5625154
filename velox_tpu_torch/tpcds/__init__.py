"""TPC-DS query plans: copies of the JAX package's, line for line."""

from velox_tpu_torch.tpcds.queries import (  # noqa: F401
    FULL_EMPTY, FULL_PARAMS, FULL_QUERIES, SPEC_QUERIES, SUPPORTED_QUERIES,
    tpcds_plan,
)

__all__ = ["tpcds_plan", "SUPPORTED_QUERIES", "SPEC_QUERIES",
           "FULL_QUERIES", "FULL_PARAMS", "FULL_EMPTY"]
