"""Batch dumps, query tracing and operator replay (the port of the JAX
package's ``utils/trace.py``).

* ``save_batch``/``load_batch``: an encoding-preserving dump of a batch
  (velox VectorSaver, docs/develop/debugging/vector-saver.rst): values
  (dictionary codes for strings), validity, selection, dictionaries,
  stats and types in an ``.npz`` with a ``.meta.json`` beside it, the
  JAX package's layout, so a dump written by either package loads in the
  other.
* ``QueryTracer``: records every input batch of chosen plan nodes while
  a query runs (velox/exec/OperatorTraceWriter.h:37; ``Task(plan,
  tracer=...)`` hooks it into the driver loop).
* ``replay_operator``: runs one node's operator again over its recorded
  inputs (the velox/tool/trace replayers), without the plan above it.

Flat columns only: an ARRAY, MAP or ROW column raises, as the JAX
package's dump cannot hold one either.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from velox_tpu_torch import resolve_device
from velox_tpu_torch.types.types import DataType, DecimalType, TypeKind
from velox_tpu_torch.vector.batch import Batch
from velox_tpu_torch.vector.column import Column, Dictionary


def _type_to_json(t: DataType) -> dict:
    d = {"kind": t.kind.value}
    if isinstance(t, DecimalType):
        d["precision"] = t.precision
        d["scale"] = t.scale
    return d


def _type_from_json(d: dict) -> DataType:
    kind = TypeKind(d["kind"])
    if kind == TypeKind.DECIMAL:
        return DecimalType(kind, d["precision"], d["scale"])
    return DataType(kind)


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _meta_path(path: str) -> str:
    base = path[:-4] if path.endswith(".npz") else path
    return base + ".meta.json"


def save_batch(batch: Batch, path: str) -> None:
    """Write ``batch`` to ``path`` (``.npz``) and its ``.meta.json``."""
    arrays = {"__sel__": batch.sel.cpu().numpy()}
    meta: Dict[str, object] = {"num_rows": batch.num_rows, "columns": {}}
    for n, c in batch.columns.items():
        if not isinstance(c, Column):
            raise NotImplementedError(
                f"save_batch holds flat columns only, not {n} "
                f"({c.dtype})")
        arrays[f"v__{n}"] = c.values.cpu().numpy()
        if c.valid is not None:
            arrays[f"m__{n}"] = c.valid.cpu().numpy()
        meta["columns"][n] = {
            "type": _type_to_json(c.dtype),
            "dictionary": (None if c.dictionary is None
                           else list(map(str, c.dictionary.values))),
            "stats": (None if c.stats is None
                      else [int(x) for x in c.stats]),
        }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(_npz_path(path), **arrays)
    with open(_meta_path(path), "w") as f:
        json.dump(meta, f)


def load_batch(path: str, device=None) -> Batch:
    """A dump back as a batch on ``device`` (``None``: the card)."""
    device = resolve_device(device)
    with np.load(_npz_path(path)) as npz, open(_meta_path(path)) as f:
        meta = json.load(f)

        def lane(key):
            return torch.from_numpy(np.array(npz[key])).to(device)

        cols = {}
        for n, cm in meta["columns"].items():
            d = (None if cm["dictionary"] is None
                 else Dictionary(cm["dictionary"]))
            valid = lane(f"m__{n}") if f"m__{n}" in npz.files else None
            stats = tuple(cm["stats"]) if cm.get("stats") else None
            cols[n] = Column(_type_from_json(cm["type"]), lane(f"v__{n}"),
                             valid, d, stats)
        return Batch(cols, lane("__sel__"), meta["num_rows"])


class QueryTracer:
    """Record the input batches of chosen plan nodes (all without
    ``node_ids``) under ``trace_dir/<node id>/input_NNNNN``."""

    def __init__(self, trace_dir: str, node_ids: Optional[List[str]] = None):
        self.trace_dir = trace_dir
        self.node_ids = set(node_ids) if node_ids else None
        self._counts: Dict[str, int] = {}

    def wants(self, node_id: str) -> bool:
        return self.node_ids is None or node_id in self.node_ids

    def record(self, node_id: str, batch: Batch) -> None:
        i = self._counts.get(node_id, 0)
        self._counts[node_id] = i + 1
        save_batch(batch,
                   os.path.join(self.trace_dir, node_id, f"input_{i:05d}"))

    def recorded_inputs(self, node_id: str) -> List[str]:
        d = os.path.join(self.trace_dir, node_id)
        return sorted(os.path.join(d, f[:-4]) for f in os.listdir(d)
                      if f.endswith(".npz"))


def replay_operator(trace_dir: str, node, device=None) -> List[Batch]:
    """``node``'s operator run again over its recorded inputs, loaded on
    ``device`` (velox/tool/trace/TraceReplayRunner.cpp)."""
    from velox_tpu_torch.exec.task import make_operator

    op = make_operator(node)
    out: List[Batch] = []
    try:
        for p in QueryTracer(trace_dir).recorded_inputs(node.id):
            op.add_input(load_batch(p, device))
            while True:
                b = op.get_output()
                if b is None:
                    break
                out.append(b)
        op.no_more_input()
        while not op.is_finished():
            b = op.get_output()
            if b is None:
                break
            out.append(b)
    finally:
        op.close()
    return out
