"""Wire formats (the port of the JAX package's ``serial``)."""

from velox_tpu_torch.serial.page import (
    deserialize_compact_rows, deserialize_page, serialize_compact_rows,
    serialize_page,
)

__all__ = ["serialize_page", "deserialize_page", "serialize_compact_rows",
           "deserialize_compact_rows"]
