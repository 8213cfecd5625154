"""Shared pieces of the fuzzer tests: the JAX package's fuzzers run with
their engine calls routed to the port, and plans compared as JSON.

``route_to_port`` takes a JAX plan through the JAX package's
``plan_to_dict``, the port's serde and the port's ``run_plan`` on the
CPU, under the spill budget the JAX fuzzer has set in its own config.
``PortExprSet`` stands in for the JAX package's ``ExprSet``: it builds
the JAX one first (so the JAX fuzzer skips the trees it skips), records
each tree and both packages' verdicts, and evaluates with the port's.
No XLA program of the JAX package's engine is compiled.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from velox_tpu.expr.compiler import ExprSet as JaxExprSet
from velox_tpu.plan import serde as jax_serde
from velox_tpu.utils.config import config as jax_config
from velox_tpu_torch.exec import run_plan
from velox_tpu_torch.expr.compiler import ExprSet as TorchExprSet
from velox_tpu_torch.plan import serde as torch_serde
from velox_tpu_torch.utils.config import config as torch_config
from velox_tpu_torch.vector.column import Dictionary


def canonical(obj, ids=None):
    """A plan's JSON value without the port's literal ``text`` keys and
    with node ids renumbered in order of appearance (each package
    numbers nodes from a counter of its own process)."""
    ids = {} if ids is None else ids
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            if k == "text" and obj.get("k") == "lit":
                continue
            if k == "id" and isinstance(v, str):
                v = ids.setdefault(v, str(len(ids)))
            out[k] = canonical(v, ids)
        return out
    if isinstance(obj, list):
        return [canonical(v, ids) for v in obj]
    return obj


def jax_plan_json(plan) -> dict:
    return canonical(json.loads(jax_serde.plan_to_json(plan)))


def torch_plan_json(plan) -> dict:
    return canonical(json.loads(torch_serde.plan_to_json(plan)))


def route_to_port(plan, seen=None):
    """The JAX ``plan``'s result from the port on the CPU; ``seen``
    collects each plan's canonical JSON."""
    d = jax_serde.plan_to_dict(plan)
    if seen is not None:
        seen.append(canonical(json.loads(json.dumps(d))))
    node = torch_serde.plan_from_dict(d, device="cpu")
    old = torch_config.spill_memory_budget_bytes
    torch_config.spill_memory_budget_bytes = \
        jax_config.spill_memory_budget_bytes
    try:
        return run_plan(node)
    finally:
        torch_config.spill_memory_budget_bytes = old


def torch_expr(e):
    return torch_serde.expr_from_dict(jax_serde.expr_to_dict(e))


class PortExprSet:
    """The JAX fuzzer's ``ExprSet`` evaluated by the port's. ``log``
    gets one ``(tree dict, jax_ok, port_ok)`` a tree."""

    log: list = []

    def __init__(self, exprs, schema, dictionaries=None):
        tree = canonical(jax_serde.expr_to_dict(exprs[0]))
        try:
            jax_set = JaxExprSet(exprs, schema, dictionaries)
        except (TypeError, KeyError):
            self.log.append((tree, False, self._port_ok(exprs, schema,
                                                        dictionaries)))
            raise
        self.field_names = jax_set.field_names
        try:
            self.port = self._port(exprs, schema, dictionaries)
        except (TypeError, KeyError):
            self.log.append((tree, True, False))
            raise
        self.log.append((tree, True, True))

    @staticmethod
    def _port(exprs, schema, dictionaries):
        return TorchExprSet(
            [torch_expr(e) for e in exprs],
            torch_serde.type_from_dict(jax_serde.type_to_dict(schema)),
            {n: Dictionary(list(d.values))
             for n, d in (dictionaries or {}).items()})

    @classmethod
    def _port_ok(cls, exprs, schema, dictionaries) -> bool:
        try:
            cls._port(exprs, schema, dictionaries)
        except (TypeError, KeyError):
            return False
        return True

    def evaluate(self, arrays):
        pairs = {n: (torch.from_numpy(np.array(v)),
                     None if va is None else torch.from_numpy(np.array(va)))
                 for n, (v, va) in arrays.items()}
        return [(v.numpy(), None if va is None else va.numpy())
                for v, va in self.port.evaluate(pairs)]
