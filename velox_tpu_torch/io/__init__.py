"""Session catalog and the TPC-H lineitem generator."""

from velox_tpu_torch.io.catalog import (  # noqa: F401
    Table, drop_table, get_table, register_columns,
)
