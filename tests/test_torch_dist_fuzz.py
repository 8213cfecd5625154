"""The port's distributed and exchange fuzzers.

For a seed the port's distributed fuzzer draws the JAX package's tables
and plans: the plans written by each package's ``plan_to_json`` are the
same JSON (the port's literal ``text`` keys aside, ROADMAP queue C; node
ids renumbered). The
JAX fuzzer's own runs are stubbed out there, so only its draws are
compared. Then a few iterations run distributed on 8 shards against the
port's serial ``run_plan``, and the exchange fuzzer streams random pages
through the local and TCP exchange.
"""

import json

import numpy as np
import pytest

import velox_tpu.io as jax_io
import velox_tpu.parallel.runner as jax_runner
from velox_tpu.fuzzer import distributed_fuzzer as jax_fuzzer
from velox_tpu.plan import serde as jax_serde
from velox_tpu_torch.fuzzer import (
    draw_case, run_distributed_fuzz, run_exchange_fuzz,
)
from velox_tpu_torch.parallel import make_mesh
from velox_tpu_torch.plan import serde as torch_serde


def _canonical(obj, ids=None):
    """The JSON value without the port's literal ``text`` keys and with
    node ids renumbered in order of appearance (each package numbers
    nodes from a counter of its own process)."""
    ids = {} if ids is None else ids
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            if k == "text" and obj.get("k") == "lit":
                continue
            if k == "id" and isinstance(v, str):
                v = ids.setdefault(v, str(len(ids)))
            out[k] = _canonical(v, ids)
        return out
    if isinstance(obj, list):
        return [_canonical(v, ids) for v in obj]
    return obj


def _jax_draws(seed, iterations, monkeypatch):
    """The JAX fuzzer's tables and plans for ``seed``, its runs stubbed."""
    tables, plans = [], []

    class _Empty:
        def to_pydict(self):
            return {}

    register_arrow = jax_io.register_arrow

    def register(name, table, *a, **kw):
        tables.append({c: table.column(c).to_numpy() for c in
                       table.column_names})
        return register_arrow(name, table, *a, **kw)

    def serial(plan):
        plans.append(jax_serde.plan_to_json(plan))
        return _Empty()

    monkeypatch.setattr(jax_io, "register_arrow", register)
    monkeypatch.setattr(jax_fuzzer, "run_plan", serial)
    monkeypatch.setattr(jax_runner, "run_plan_distributed",
                        lambda plan, mesh=None: _Empty())
    jax_fuzzer.run_distributed_fuzz(iterations, seed)
    return tables, plans


@pytest.mark.parametrize("seed", [0, 7])
def test_the_fuzzer_draws_the_references_plans(seed, monkeypatch):
    from velox_tpu_torch.io.catalog import drop_table, register_columns

    iterations = 12
    tables, plans = _jax_draws(seed, iterations, monkeypatch)
    assert len(plans) == iterations
    rng = np.random.default_rng(seed)
    for i in range(iterations):
        columns, plan, what = draw_case(rng, device="cpu")
        for c in ("k", "k2", "v"):
            assert np.array_equal(columns[c], tables[i][c]), (i, c)
        # the scan's schema comes from the catalog
        register_columns("dfz_t", columns, {}, 1 << 9, device="cpu")
        try:
            got = json.loads(torch_serde.plan_to_json(plan().build()))
        finally:
            drop_table("dfz_t")
        assert _canonical(got) == _canonical(json.loads(plans[i])), (i, what)


def test_distributed_equals_serial():
    strategies = run_distributed_fuzz(
        iterations=10, seed=3, mesh=make_mesh(8, device="cpu"))
    assert len(strategies) == 10
    assert "distributed_pipeline" in strategies


@pytest.mark.parametrize("seed", [0, 5])
def test_the_exchange_reassembles_the_stream(seed):
    run_exchange_fuzz(iterations=8, seed=seed, device="cpu")


def test_the_fuzzers_run_on_the_card_unless_asked(monkeypatch):
    """Without a card, and without ``device="cpu"`` or a CPU mesh, every
    fuzzer entry point raises rather than run on the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        draw_case(np.random.default_rng(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_distributed_fuzz(iterations=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_exchange_fuzz(iterations=1)
