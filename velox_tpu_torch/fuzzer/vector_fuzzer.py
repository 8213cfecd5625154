"""Random batch generation (velox/vector/fuzzer/VectorFuzzer.h:77 analog;
the port of ``velox_tpu/fuzzer/vector_fuzzer.py``).

Columns are host lists with ``None`` for NULL (dates as days since the
epoch); for a seed the values and NULLs are the JAX package's, drawn in
the same order.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from velox_tpu_torch.types import (
    BIGINT, BOOLEAN, DATE, DOUBLE, INTEGER, VARCHAR,
)
from velox_tpu_torch.vector.batch import Batch

#: each kind's SQL type
KIND_TYPES = {"bigint": BIGINT, "integer": INTEGER, "double": DOUBLE,
              "boolean": BOOLEAN, "varchar": VARCHAR, "date": DATE}


class VectorFuzzer:
    """Random columns of every supported scalar type with configurable
    null ratio and string cardinality."""

    def __init__(self, seed: int = 0, null_ratio: float = 0.1,
                 string_pool: int = 12):
        self.rng = np.random.default_rng(seed)
        self.null_ratio = null_ratio
        self.pool = [
            f"s{i:02d}" for i in range(string_pool)]

    def _nulls(self, vals: list) -> list:
        return [
            None if self.rng.random() < self.null_ratio else v
            for v in vals]

    def column(self, kind: str, n: int) -> List:
        r = self.rng
        if kind == "bigint":
            v = r.integers(-1000, 1000, n).tolist()
        elif kind == "integer":
            v = r.integers(-100, 100, n).tolist()
        elif kind == "double":
            v = np.round(r.normal(scale=50, size=n), 3).tolist()
        elif kind == "boolean":
            v = (r.random(n) < 0.5).tolist()
        elif kind == "varchar":
            v = [self.pool[i] for i in r.integers(0, len(self.pool), n)]
        elif kind == "date":
            v = r.integers(8000, 12000, n).tolist()
        else:
            raise KeyError(kind)
        return self._nulls(v)

    def batch(self, spec: Dict[str, str], n: int, device=None) -> Batch:
        """One batch of ``spec``'s columns on ``device`` (default: the
        card)."""
        return Batch.from_pydict(
            self.table(spec, n), {name: KIND_TYPES[kind]
                                  for name, kind in spec.items()},
            device=device)

    def table(self, spec: Dict[str, str], n: int) -> Dict[str, List]:
        return {name: self.column(kind, n) for name, kind in spec.items()}
