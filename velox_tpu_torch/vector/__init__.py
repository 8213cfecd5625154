"""Columns and batches over torch tensors."""

from velox_tpu_torch.vector.column import Column, Dictionary  # noqa: F401
from velox_tpu_torch.vector.batch import Batch  # noqa: F401
