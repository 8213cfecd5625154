"""velox_tpu_torch — the velox_tpu query engine ported to PyTorch and CUDA.

A second package beside ``velox_tpu`` (the JAX reference). It keeps the
reference's module paths and names so each counterpart is easy to find,
imports nothing of it, and runs eagerly on torch tensors. The kernels the
reference wrote in Pallas are hand-written CUDA C++ under ``csrc/``, built
with ``nvcc`` at first use (``ops/grouped_sum.py``).

The device is fixed when a table is ingested (``io/catalog.py``):
``device=None`` means the CUDA card, and ingest raises when there is none.
Callers that want the CPU (the tests) pass ``device="cpu"``. torch has
native int64/float64, so nothing corresponds to ``jax_enable_x64``.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

__version__ = "0.1.0"

_NP_TO_TORCH = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}


def torch_dtype(dt) -> torch.dtype:
    """torch dtype of a numpy dtype (or of a torch dtype, unchanged)."""
    if isinstance(dt, torch.dtype):
        return dt
    return _NP_TO_TORCH[np.dtype(dt)]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device tables live on: the card unless the caller asks.

    ``None`` means CUDA; without a card that raises instead of falling
    back to the CPU, so a run never silently measures the wrong device.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "velox_tpu_torch: no CUDA device is available; pass "
                "device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def true_divide(v: torch.Tensor, divisor: float) -> torch.Tensor:
    """``v / divisor``, correctly rounded on every device. CUDA divides a
    tensor by a host scalar as a multiplication by the scalar's
    reciprocal, which is an ulp off for most divisors (0.01 among them);
    a divisor that lives on the device is divided by."""
    return v / torch.full((), divisor, dtype=v.dtype, device=v.device)
