"""Scalar function registry.

Analog of velox's SimpleFunctionRegistry + FunctionSignature/SignatureBinder
(velox/expression/FunctionSignature.h:123, SignatureBinder.h:115), distilled:
a function owns a ``resolve_type`` rule (args -> result type) instead of a
declarative signature language, and its ``impl`` is a torch transform over
value lanes. Null handling:

* ``default_nulls=True`` (most functions): result validity = AND of argument
  validities; the engine computes it outside ``impl`` (the analog of Velox's
  propagatesNulls fast path, velox/expression/Expr.cpp:1235).
* ``default_nulls=False``: ``impl`` receives and returns (values, valid)
  pairs and manages validity itself (special forms, coalesce, is_null).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Sequence

from velox_tpu_torch.types import DataType


@dataclass(frozen=True)
class ScalarFunction:
    name: str
    #: (arg_types) -> result DataType; raises TypeError on mismatch
    resolve_type: Callable[[Sequence[DataType]], DataType]
    #: default_nulls: impl(*value_arrays) -> value_array
    #: else:          impl(*(values, valid) pairs) -> (values, valid)
    impl: Callable
    default_nulls: bool = True
    #: functions safe to apply directly to dictionary codes (eq/neq/in/hash)
    dictionary_safe: bool = False
    #: deterministic (enables CSE); all are for now
    deterministic: bool = True


registry: Dict[str, ScalarFunction] = {}


def register_function(fn: ScalarFunction, overwrite: bool = True) -> None:
    if not overwrite and fn.name in registry:
        raise ValueError(f"function {fn.name} already registered")
    registry[fn.name] = fn


def lookup_function(name: str) -> ScalarFunction:
    try:
        return registry[name]
    except KeyError:
        raise KeyError(
            f"no scalar function {name!r}; registered: {sorted(registry)}"
        )
