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

A default-null call casts its operands to one dtype before ``impl`` sees
them (``promote_args``), as the JAX package's 0-d int64 literals widen an
int32 column. Functions whose arguments play different roles (a count
and a date, a value and its digits) opt out and cast what they need.
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
    #: deterministic (enables CSE); rand and its aliases are not
    deterministic: bool = True
    #: default-null calls: cast every operand to one dtype first
    promote_args: bool = True


registry: Dict[str, ScalarFunction] = {}


def register_function(fn: ScalarFunction, overwrite: bool = True) -> None:
    if not overwrite and fn.name in registry:
        raise ValueError(f"function {fn.name} already registered")
    registry[fn.name] = fn


def lookup_function(name: str) -> ScalarFunction:
    """The function registered as ``name``; a name the port lacks raises
    ``NotImplementedError``, as every other missing piece does."""
    try:
        return registry[name]
    except KeyError:
        raise NotImplementedError(
            f"scalar function {name!r} is not ported; registered: "
            f"{sorted(registry)}") from None
