"""Filter pushdown classes (the port of the JAX package's
``types/filters.py``).

The behavior of velox/type/Filter.h's ranges, value sets, null tests,
negations and multi-ranges as mask producers: each filter turns a value
tensor and its validity into a boolean selection with torch ops.
``null_allowed`` is Velox's nullAllowed flag: a NULL row passes where it
is set. No scan is wired to them, as in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class Filter:
    """Base filter. ``null_allowed`` mirrors Velox's nullAllowed flag."""

    null_allowed: bool = False

    def mask(self, values: torch.Tensor, valid: torch.Tensor
             ) -> torch.Tensor:
        """The boolean selection of ``values`` with validity ``valid``."""
        m = self._test(values)
        if self.null_allowed:
            return torch.where(valid, m, torch.ones_like(m))
        return m & valid

    def _test(self, values):  # pragma: no cover - abstract
        raise NotImplementedError


def _const(values: torch.Tensor, fill: bool) -> torch.Tensor:
    return torch.full(values.shape, fill, dtype=torch.bool,
                      device=values.device)


@dataclass(frozen=True)
class AlwaysTrue(Filter):
    def mask(self, values, valid):
        return _const(values, True)

    def _test(self, values):
        return _const(values, True)


@dataclass(frozen=True)
class AlwaysFalse(Filter):
    def mask(self, values, valid):
        return _const(values, False)

    def _test(self, values):
        return _const(values, False)


@dataclass(frozen=True)
class IsNull(Filter):
    def mask(self, values, valid):
        return ~valid


@dataclass(frozen=True)
class IsNotNull(Filter):
    def mask(self, values, valid):
        return valid


@dataclass(frozen=True)
class BigintRange(Filter):
    """[lower, upper] inclusive on integer lanes (Filter.h kBigintRange)."""

    lower: int = -(2**63)
    upper: int = 2**63 - 1

    def _test(self, values):
        return (values >= self.lower) & (values <= self.upper)


@dataclass(frozen=True)
class NegatedBigintRange(Filter):
    lower: int = 0
    upper: int = 0

    def _test(self, values):
        return (values < self.lower) | (values > self.upper)


@dataclass(frozen=True)
class DoubleRange(Filter):
    """Float range with open or closed bounds (Filter.h kDoubleRange)."""

    lower: float = -np.inf
    lower_exclusive: bool = False
    upper: float = np.inf
    upper_exclusive: bool = False

    def _test(self, values):
        lo = values > self.lower if self.lower_exclusive \
            else values >= self.lower
        hi = values < self.upper if self.upper_exclusive \
            else values <= self.upper
        return lo & hi


@dataclass(frozen=True)
class BigintValuesUsingHashTable(Filter):
    """IN-list over integers (Filter.h kBigintValuesUsingHashTable): one
    compare a value, OR-ed. Dictionary-coded string predicates reach it
    as code lists."""

    values: Tuple[int, ...] = ()

    def _test(self, values):
        m = _const(values, False)
        for v in self.values:
            m = m | (values == v)
        return m


@dataclass(frozen=True)
class BytesValues(Filter):
    """IN-list over strings: the host turns it into a code list of the
    column's dictionary before any evaluation."""

    values: Tuple[str, ...] = ()

    def _test(self, values):  # pragma: no cover - rewritten to codes
        raise RuntimeError(
            "BytesValues must be rewritten to BigintValuesUsingHashTable "
            "over dictionary codes before device evaluation")


@dataclass(frozen=True)
class MultiRange(Filter):
    """OR of disjoint filters (Filter.h kMultiRange)."""

    filters: Tuple[Filter, ...] = ()

    def mask(self, values, valid):
        m = self.filters[0].mask(values, valid)
        for f in self.filters[1:]:
            m = m | f.mask(values, valid)
        if self.null_allowed:
            m = m | ~valid
        return m
