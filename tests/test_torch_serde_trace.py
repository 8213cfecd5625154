"""Plan serde, batch dumps, query tracing and grouped execution: the port
against the JAX package.

A plan written by either package's ``plan_to_json`` is read by the
other's ``plan_from_json`` and written again: the JSON must come back
unchanged but for the port's one extra key (``Literal.text``, ROADMAP
queue C), for every TPC-H plan (22, with Q3 and Q18's clustered forms)
and the 15 TPC-DS spec plans; plans shipped across run to the same rows
as at home. ``save_batch`` dumps load in the other package with equal
values, NULLs, selection, dictionaries and types; a trace recorded by
one package replays in the other; ``run_plan_grouped`` yields the JAX
package's groups.
"""

import json

import numpy as np
import pyarrow as pa
import pytest

from torch_tpch_data import (
    assert_same, table_in_both, tables_in_both, tpcds_in_both,
    values_in_both,
)
from velox_tpu.exec import run_plan as jax_run_plan
from velox_tpu.exec.task import Task as JaxTask
from velox_tpu.exec.task import run_plan_grouped as jax_grouped
from velox_tpu.plan import PlanBuilder as JaxPlanBuilder
from velox_tpu.plan import serde as jax_serde
from velox_tpu.tpcds import tpcds_plan as jax_tpcds_plan
from velox_tpu.tpch import tpch_plan as jax_tpch_plan
from velox_tpu.utils import trace as jax_trace
from velox_tpu_torch.exec import run_plan as torch_run_plan
from velox_tpu_torch.io import catalog as torch_catalog
from velox_tpu_torch.exec.task import (
    make_operator, register_operator, run_plan_grouped,
)
from velox_tpu_torch.plan import PlanBuilder as TorchPlanBuilder
from velox_tpu_torch.plan import serde as torch_serde
from velox_tpu_torch.tpcds import SPEC_QUERIES
from velox_tpu_torch.tpcds import tpcds_plan as torch_tpcds_plan
from velox_tpu_torch.tpch import tpch_plan as torch_tpch_plan
from velox_tpu_torch.utils import trace as torch_trace
from velox_tpu_torch.utils.metrics import reporter

SF = 0.01
TPCH = [(n, False) for n in range(1, 23)] + [(3, True), (18, True)]


def _built(p):
    return p.build() if hasattr(p, "build") else p


def _without_text(obj):
    """The JSON value with every literal's ``text`` key dropped."""
    if isinstance(obj, dict):
        return {k: _without_text(v) for k, v in obj.items()
                if not (k == "text" and obj.get("k") == "lit")}
    if isinstance(obj, list):
        return [_without_text(v) for v in obj]
    return obj


def _crosses(torch_plan, jax_plan, what):
    """Each package reads the other's JSON and writes it back unchanged
    (the port's ``text`` keys aside); each is stable at home."""
    tj = torch_serde.plan_to_json(torch_plan)
    jj = jax_serde.plan_to_json(jax_plan)
    assert torch_serde.plan_to_json(
        torch_serde.plan_from_json(tj, device="cpu")) == tj, what
    back = jax_serde.plan_to_json(jax_serde.plan_from_json(tj))
    assert json.loads(back) == _without_text(json.loads(tj)), what
    assert torch_serde.plan_to_json(
        torch_serde.plan_from_json(jj, device="cpu")) == jj, what


@pytest.fixture(scope="module")
def tpch():
    with tables_in_both(True, "cents", SF) as data:
        yield data


def test_every_tpch_plan_crosses_both_ways(tpch):
    for n, clustered in TPCH:
        _crosses(_built(torch_tpch_plan(n, SF, clustered=clustered)),
                 _built(jax_tpch_plan(n, SF, clustered=clustered)),
                 f"Q{n}{'c' if clustered else ''}")


def test_every_tpcds_spec_plan_crosses_both_ways():
    with tpcds_in_both(prefix=""):
        for q in SPEC_QUERIES:
            _crosses(_built(torch_tpcds_plan(q)), _built(jax_tpcds_plan(q)),
                     f"q{q}")


def test_shipped_tpch_plans_run_to_the_same_rows(tpch):
    """Q1 and Q6 written by the port run in the JAX package, and written
    by the JAX package run in the port, to the rows of the home run."""
    for n in (1, 6):
        tplan = _built(torch_tpch_plan(n, SF))
        jplan = _built(jax_tpch_plan(n, SF))
        want = torch_run_plan(tplan)
        shipped = jax_serde.plan_from_json(torch_serde.plan_to_json(tplan))
        assert_same(jax_run_plan(shipped).to_pydict(), want, f"Q{n} in JAX")
        back = torch_serde.plan_from_json(jax_serde.plan_to_json(jplan),
                                          device="cpu")
        assert_same(torch_run_plan(back), want, f"Q{n} in the port")


def _values_plans():
    rng = np.random.default_rng(2)
    n = 300
    cols = {"k": rng.integers(0, 9, n).astype(np.int64),
            "v": np.round(rng.normal(size=n), 4),
            "s": rng.integers(-1, 4, n).astype(np.int32),
            "d": rng.integers(-5000, 5000, n).astype(np.int64)}
    nulls = {"k": rng.random(n) < 0.1}
    jb, tb = values_in_both(cols, nulls, {"s": ["a", "b", "c", "d"]},
                            batch_rows=128, overrides={"d": (12, 2)})

    def make(pb, batches):
        return (pb().values(batches).filter("v > -1.5")
                .project(["k", "s", "d", "v * 2.5 AS v2"])
                .aggregate(["k", "s"], ["sum(v2) AS sv", "sum(d) AS sd",
                                        "count(*) AS c"])
                .order_by(["k", "s"]).build())

    return make(JaxPlanBuilder, jb), make(TorchPlanBuilder, tb)


def test_values_pages_and_literals_cross_both_ways():
    """A ValuesNode's pages (NULLs, strings, decimals) go across both
    ways; the port's DOUBLE literal carries its numeral as ``text``, the
    one key the JAX package does not write and ignores on reading."""
    jplan, tplan = _values_plans()
    want = jax_run_plan(jplan).to_pydict()
    assert_same(torch_run_plan(tplan), want)
    tj = torch_serde.plan_to_json(tplan)
    assert '"text":"2.5"' in tj
    assert '"text"' not in jax_serde.plan_to_json(
        jax_serde.plan_from_json(tj))
    assert_same(jax_run_plan(jax_serde.plan_from_json(tj)).to_pydict(),
                want, "port plan in JAX")
    back = torch_serde.plan_from_json(jax_serde.plan_to_json(jplan),
                                      device="cpu")
    assert_same(torch_run_plan(back), want, "JAX plan in the port")
    _crosses(tplan, jplan, "values")


def _dump_batches():
    """The same batch in both packages: NULLs, a string dictionary, a
    decimal, a date, and a selection that drops a row."""
    import torch

    cols = {"a": np.array([1, 0, 3, 4, 5], np.int64),
            "s": np.array([0, 1, -1, 0, 2], np.int32),
            "d": np.array([150, 0, -225, 1, 999], np.int64),
            "t": np.arange(9131, 9136).astype("datetime64[D]")}
    (jb,), (tb,) = values_in_both(
        cols, {"a": np.array([False, True, False, False, False])},
        {"s": ["x", "y", "z"]}, overrides={"d": (9, 2)})
    keep = np.zeros(tb.capacity, bool)
    keep[[0, 1, 3, 4]] = True
    return jb, tb.with_sel(torch.from_numpy(keep), 4)


def test_batch_dumps_load_in_either_package(tmp_path):
    import jax.numpy as jnp

    jb, tb = _dump_batches()
    jb = jb.with_sel(jnp.asarray(tb.sel.numpy()), 4)
    torch_trace.save_batch(tb, str(tmp_path / "port"))
    from_port = jax_trace.load_batch(str(tmp_path / "port"))
    assert from_port.to_pydict() == jb.to_pydict()
    jax_trace.save_batch(jb, str(tmp_path / "jax"))
    from_jax = torch_trace.load_batch(str(tmp_path / "jax"), device="cpu")
    assert from_jax.to_pydict() == tb.to_pydict()
    assert from_jax.num_rows == from_port.num_rows == 4
    for name, col in from_jax.columns.items():
        jcol = from_port.columns[name]
        assert col.dtype.kind.name == jcol.dtype.kind.name, name
        assert np.array_equal(col.values.numpy(), np.asarray(jcol.values))
        assert (col.valid is None) == (jcol.valid is None), name
        if col.valid is not None:
            assert np.array_equal(col.valid.numpy(), np.asarray(jcol.valid))
        assert (None if col.dictionary is None else list(
            col.dictionary.values)) == (None if jcol.dictionary is None
                                        else list(jcol.dictionary.values))
    assert np.array_equal(from_jax.sel.numpy(), np.asarray(from_port.sel))


def test_trace_recorded_by_either_package_replays_in_the_port(tmp_path):
    jplan, tplan = _values_plans()
    jagg, tagg = jplan.source, tplan.source     # under the OrderBy
    tracer = torch_trace.QueryTracer(str(tmp_path / "t"), [tagg.id])
    original = torch_run_plan(
        TorchPlanBuilder(tagg).order_by(["k", "s"]).build(), tracer=tracer)
    assert tracer.recorded_inputs(tagg.id)

    def ordered(batches, node):
        return torch_run_plan(TorchPlanBuilder().values(batches)
                              .order_by(["k", "s"]).build())

    replayed = torch_trace.replay_operator(str(tmp_path / "t"), tagg,
                                           device="cpu")
    assert_same(ordered(replayed, tagg), original)
    # a trace the JAX package recorded, replayed in the port under the
    # port's node of the same shape
    jtracer = jax_trace.QueryTracer(str(tmp_path / "j"), [jagg.id])
    list(JaxTask(jagg, tracer=jtracer).run())
    (tmp_path / "j" / jagg.id).rename(tmp_path / "j" / tagg.id)
    from_jax = torch_trace.replay_operator(str(tmp_path / "j"), tagg,
                                           device="cpu")
    assert_same(ordered(from_jax, tagg), original)


def test_grouped_execution_matches_jax():
    """Eight splits bucketed by key, four groups: each group's rows (a
    filter, a projection and an aggregation inside the group) equal the
    JAX package's group, and each group is one barrier."""
    rng = np.random.default_rng(8)
    n = 8 * 64
    bucket = np.repeat(np.arange(8), 64)
    cols = {"k": (bucket * 100 + rng.integers(0, 5, n)).astype(np.int64),
            "v": rng.integers(0, 1000, n).astype(np.int64)}
    with table_in_both("grouped_t", cols, batch_rows=64):
        def make(pb):
            return (pb().table_scan("grouped_t").filter("v > 100")
                    .project(["k", "v * 2 AS v2"])
                    .aggregate(["k"], ["sum(v2) AS s", "count(*) AS c"])
                    .build())

        want = [t.to_pydict() for t in jax_grouped(make(JaxPlanBuilder), 4)]
        before = reporter.counters["velox_tpu.task_barriers"]
        got = list(run_plan_grouped(make(TorchPlanBuilder), 4))
        assert reporter.counters["velox_tpu.task_barriers"] - before == 4
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            assert_same(g, w)
        values = TorchPlanBuilder().values(
            torch_catalog.get_table("grouped_t").batches).build()
        with pytest.raises(ValueError, match="leaf TableScan"):
            list(run_plan_grouped(values, 2))


def test_operator_registry_and_make_operator():
    """A node type outside the built-in set runs through a registered
    factory; ``make_operator`` builds a single-source node's operator and
    refuses a join."""
    from dataclasses import dataclass

    from velox_tpu_torch.exec.operator import Operator
    from velox_tpu_torch.exec.operators import FilterOp
    from velox_tpu_torch.plan.nodes import SourceNode, new_id
    from velox_tpu_torch.types import BIGINT
    from velox_tpu_torch.vector.batch import Batch

    @dataclass(frozen=True)
    class DoubleNode(SourceNode):
        pass

    class DoubleOp(Operator):
        def __init__(self, node):
            super().__init__(node)
            self._q = []

        def add_input(self, b):
            self._q += [b, b]

        def get_output(self):
            return self._q.pop(0) if self._q else None

        def is_finished(self):
            return self.no_more_input_seen and not self._q

    b = Batch.from_pydict({"x": [1, 2, 3]}, {"x": BIGINT}, device="cpu")
    src = TorchPlanBuilder().values([b]).build()
    node = DoubleNode(new_id(), src.output_type, src)
    register_operator(DoubleNode, DoubleOp)
    assert torch_run_plan(node) == {"x": [1, 2, 3, 1, 2, 3]}
    filt = TorchPlanBuilder(src).filter("x > 1").build()
    assert isinstance(make_operator(filt), FilterOp)
    other = Batch.from_pydict({"y": [2, 3]}, {"y": BIGINT}, device="cpu")
    join = TorchPlanBuilder(src).hash_join(
        TorchPlanBuilder().values([other]), ["x"], ["y"], "inner").build()
    with pytest.raises(NotImplementedError):
        make_operator(join)
