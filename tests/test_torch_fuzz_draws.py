"""The port's six fuzzers draw the JAX package's cases.

For each fuzzer and two seeds the JAX fuzzer runs with its engine calls
routed to the port (``tests/torch_fuzz_shim.py``), so its own checks
judge the port's results while its plans are recorded; the port's
fuzzer then draws the same seed, and each case must be the reference's:
vector values and NULL masks, expression trees (through each package's
``serde.expr_to_dict``) with the same trees skipped as untyped, plans as
canonical ``plan_to_dict`` JSON, and the aggregation fuzzer's list of
registered aggregates it has no entry for.
"""

import datetime

import numpy as np
import pyarrow as pa
import pytest

from velox_tpu.fuzzer import aggregation_fuzzer as jax_agg
from velox_tpu.fuzzer import expression_fuzzer as jax_expr
from velox_tpu.fuzzer import join_fuzzer as jax_join
from velox_tpu.fuzzer import plan_fuzzer as jax_plan
from velox_tpu.fuzzer import vector_fuzzer as jax_vector
from velox_tpu.fuzzer import window_fuzzer as jax_window
from velox_tpu_torch.expr.compiler import ExprSet
from velox_tpu_torch.fuzzer import aggregation_fuzzer as agg
from velox_tpu_torch.fuzzer import expression_fuzzer as expr
from velox_tpu_torch.fuzzer import join_fuzzer as join
from velox_tpu_torch.fuzzer import plan_fuzzer as planf
from velox_tpu_torch.fuzzer import window_fuzzer as window
from velox_tpu_torch.fuzzer.vector_fuzzer import KIND_TYPES, VectorFuzzer
from velox_tpu_torch.plan import serde as torch_serde
from velox_tpu_torch.vector.batch import Batch

from torch_fuzz_shim import (
    PortExprSet, canonical, route_to_port, torch_plan_json,
)

EPOCH = datetime.date(1970, 1, 1)
KINDS = ["bigint", "integer", "double", "boolean", "varchar", "date"]


def _routed(module, monkeypatch):
    """Route ``module``'s engine calls to the port; returns the list the
    plans' JSON is recorded in."""
    seen = []
    monkeypatch.setattr(module, "run_plan_pydict",
                        lambda plan: route_to_port(plan, seen))
    return seen


@pytest.mark.parametrize("seed", [3, 17])
def test_vector_fuzzer_values_and_nulls(seed):
    jvf, vf = jax_vector.VectorFuzzer(seed, null_ratio=0.2), \
        VectorFuzzer(seed, null_ratio=0.2)
    for kind in KINDS * 2:
        want = jvf.column(kind, 77)
        if kind == "date":
            want = want.cast(pa.int32())
        got = vf.column(kind, 77)
        assert got == want.to_pylist(), kind
        assert [v is None for v in got] == \
            want.is_null().to_pylist(), kind
    spec = {k[0] + str(i): k for i, k in enumerate(KINDS)}
    jb, b = jvf.batch(spec, 50), vf.batch(spec, 50, device="cpu")
    assert str(b.schema) == str(jb.schema)
    got = b.to_pydict()
    # the port's to_pydict gives a DATE as datetime.date, the JAX
    # package's Batch.to_pydict as days since the epoch
    got["d5"] = [None if d is None else (d - EPOCH).days
                 for d in got["d5"]]
    assert got == jb.to_pydict()
    assert b.columns["v4"].dictionary is not None
    jt = jvf.table(spec, 9)
    jt = jt.set_column(5, "d5", jt["d5"].cast(pa.int32()))
    assert vf.table(spec, 9) == jt.to_pydict()


@pytest.mark.parametrize("seed", [11, 4])
def test_expression_fuzzer_trees_and_skips(seed, monkeypatch):
    iterations, rows = 60, 48
    tables = []
    batch = jax_vector.VectorFuzzer.batch

    def recording(self, spec, n):
        b = batch(self, spec, n)
        tables.append(b.to_pydict())
        return b

    PortExprSet.log.clear()
    monkeypatch.setattr(jax_vector.VectorFuzzer, "batch", recording)
    monkeypatch.setattr(jax_expr, "ExprSet", PortExprSet)
    checked = jax_expr.run_expression_fuzz(iterations, seed, rows)
    log = list(PortExprSet.log)
    assert len(log) == len(tables) == iterations

    rng = np.random.default_rng(seed + 99)
    vf = VectorFuzzer(seed + 1)
    port_ok = []
    for it in range(iterations):
        schema, table, e = expr.draw_iteration(rng, vf, it, seed, rows)
        assert table == tables[it], it
        assert canonical(torch_serde.expr_to_dict(e)) == log[it][0], it
        b = Batch.from_pydict(table, {c: KIND_TYPES[k]
                                      for c, k in schema.items()},
                              device="cpu")
        try:
            ExprSet([e], b.schema, {n: c.dictionary
                                    for n, c in b.columns.items()
                                    if c.dictionary is not None})
            port_ok.append(True)
        except (TypeError, KeyError):
            port_ok.append(False)
    assert port_ok == [jax_ok for _, jax_ok, _ in log]
    assert all(ok for _, _, ok in log)
    assert expr.run_expression_fuzz(iterations, seed, rows,
                                    device="cpu") == checked


@pytest.mark.parametrize("seed", [23, 6])
def test_window_fuzzer_plans(seed, monkeypatch):
    iterations = 16
    seen = _routed(jax_window, monkeypatch)
    jax_window.run_window_fuzz(iterations, seed)
    rng = np.random.default_rng(seed)
    got = [torch_plan_json(window.draw_case(rng).plan("cpu").build())
           for _ in range(iterations)]
    assert got == seen


@pytest.mark.parametrize("seed", [21, 8])
def test_join_fuzzer_plans(seed, monkeypatch):
    iterations = 14
    seen = _routed(jax_join, monkeypatch)
    jax_join.run_join_fuzz(iterations, seed)
    rng = np.random.default_rng(seed)
    got = []
    for _ in range(iterations):
        case = join.draw_case(rng)
        # hash, merge, then the hash plan again under the spill budget
        got += [torch_plan_json(case.hash_plan("cpu").build()),
                torch_plan_json(case.merge_plan("cpu").build()),
                torch_plan_json(case.hash_plan("cpu").build())]
    assert got == seen


@pytest.mark.parametrize("seed", [7, 8])
def test_plan_fuzzer_plans(seed, monkeypatch):
    iterations = 20
    seen = _routed(jax_plan, monkeypatch)
    jax_plan.run_plan_fuzz(iterations, seed)
    rng = np.random.default_rng(seed)
    got = [torch_plan_json(planf.draw_case(rng).plan("cpu").build())
           for _ in range(iterations)]
    assert got == seen


@pytest.mark.parametrize("seed", [22, 2])
def test_aggregation_fuzzer_plans_and_missing(seed, monkeypatch):
    iterations = 24
    seen = _routed(jax_agg, monkeypatch)
    missing = jax_agg.run_aggregation_fuzz(iterations, seed)
    assert agg.missing_aggregates() == missing
    rng = np.random.default_rng(seed)
    fns = agg.fuzzed_aggregates()
    got = []
    for i in range(iterations):
        case = agg.draw_case(rng, i, fns)
        got += [torch_plan_json(make().build())
                for make, _ in case.plans("cpu").values()]
    assert got == seen
