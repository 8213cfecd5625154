"""Shared utilities: session config."""

from velox_tpu_torch.utils.config import SessionConfig, config  # noqa: F401
