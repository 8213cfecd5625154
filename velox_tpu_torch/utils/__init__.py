"""Shared utilities: configuration, fault injection, batch dumps and
query tracing."""

from velox_tpu_torch.utils.config import SessionConfig, config  # noqa: F401
from velox_tpu_torch.utils.testvalue import TestValue  # noqa: F401

_TRACE = ("QueryTracer", "load_batch", "replay_operator", "save_batch")


def __getattr__(name):
    # utils/trace.py needs the vector layer, which imports this package
    if name in _TRACE:
        from velox_tpu_torch.utils import trace

        return getattr(trace, name)
    raise AttributeError(name)
