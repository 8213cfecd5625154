"""The join types and operators the 18 TPC-H queries beyond
Q1/Q3/Q6/Q18 add, each held against the JAX package on small hand-made
tables with NULL keys, through both packages' ``run_plan`` on the CPU:
left outer joins, the null-aware anti join (NOT IN: a NULL build key
empties the result, a NULL probe key drops its row), the plain anti join
(NOT EXISTS), residual join filters on inner, left-semi and both anti
joins, string keys over differing dictionaries, cross joins, and the
scalar-subquery guard ``EnforceSingleRowOp``. Every result is integer or
string and must be equal, row order included. The port runs each plan
with ``optimize_plans`` on (the build side ascends on ``k``, so the
single-key joins become merge joins) and off (hash joins), against one
JAX run."""

import numpy as np
import pytest

from torch_tpch_data import assert_same, table_in_both
from velox_tpu.exec import run_plan as jax_run_plan
from velox_tpu.plan import PlanBuilder as JaxPlanBuilder
from velox_tpu_torch.exec import run_plan as torch_run_plan
from velox_tpu_torch.exec.operators import HashProbeOp
from velox_tpu_torch.plan import PlanBuilder as TorchPlanBuilder
from velox_tpu_torch.utils.config import config as torch_config

PROBE_WORDS = ["ant", "bee", "cat", "dog", "eel"]
BUILD_WORDS = ["bee", "cat", "cow", "eel", "fox", "yak"]

#: k NULL where it is 7 (the catalog ingests no NULL integers)
NULL_K = "CASE WHEN k = 7 THEN NULL ELSE k END AS k"


def _tables():
    rng = np.random.default_rng(20240611)
    n_p, n_b = 90, 60
    probe = {
        "k": rng.integers(0, 16, n_p).astype(np.int64),
        "s": rng.integers(-1, len(PROBE_WORDS), n_p).astype(np.int32),
        "v": rng.integers(0, 30, n_p).astype(np.int64),
    }
    build = {
        "k": np.sort(rng.integers(5, 26, n_b)).astype(np.int64),
        "s": rng.integers(-1, len(BUILD_WORDS), n_b).astype(np.int32),
        "w": rng.integers(0, 30, n_b).astype(np.int64),
    }
    return probe, build


def probe(b, null_keys=False):
    p = b().table_scan("jp", columns=["k", "s", "v"])
    return p.project([NULL_K, "s", "v"]) if null_keys else p


def build(b, null_keys=False, names=("bk", "bs", "w")):
    bk, bs, w = names
    p = b().table_scan("jb", columns=["k", "s", "w"])
    if null_keys:
        p = p.project([NULL_K, "s", "w"])
    return p.project([f"k AS {bk}", f"s AS {bs}", f"w AS {w}"])


PLANS = {
    "inner_filter": lambda b: probe(b).hash_join(
        build(b), ["k"], ["bk"], "inner", filter="w > v",
        output=["k", "v", "w", "bs"]),
    "left": lambda b: probe(b).hash_join(
        build(b), ["k"], ["bk"], "left", output=["k", "s", "v", "w", "bs"]),
    "left_null_probe_keys": lambda b: probe(b, True).hash_join(
        build(b), ["k"], ["bk"], "left", output=["k", "v", "w"]),
    "left_count_build_column": lambda b: probe(b).hash_join(
        build(b), ["k"], ["bk"], "left", output=["k", "w"]).aggregate(
        ["k"], ["count(w) AS n", "count(*) AS rows"]).order_by(["k"]),
    "semi_filter": lambda b: probe(b).hash_join(
        build(b), ["k"], ["bk"], "left_semi", filter="w < v + 5"),
    "anti": lambda b: probe(b).hash_join(build(b), ["k"], ["bk"], "anti"),
    "anti_null_build_key": lambda b: probe(b).hash_join(
        build(b, True), ["k"], ["bk"], "anti"),
    "anti_null_probe_keys": lambda b: probe(b, True).hash_join(
        build(b), ["k"], ["bk"], "anti"),
    "anti_filter": lambda b: probe(b, True).hash_join(
        build(b), ["k"], ["bk"], "anti", filter="w > v"),
    "anti_filter_null_build_key": lambda b: probe(b).hash_join(
        build(b, True), ["k"], ["bk"], "anti", filter="w > v"),
    "anti_simple": lambda b: probe(b, True).hash_join(
        build(b, True), ["k"], ["bk"], "anti_simple"),
    "anti_simple_filter": lambda b: probe(b, True).hash_join(
        build(b), ["k"], ["bk"], "anti_simple", filter="w <> v"),
    "string_key_semi": lambda b: probe(b).hash_join(
        build(b), ["s"], ["bs"], "left_semi"),
    "string_key_anti_null_build": lambda b: probe(b).hash_join(
        build(b), ["s"], ["bs"], "anti"),
    "string_key_anti_simple": lambda b: probe(b).hash_join(
        build(b), ["s"], ["bs"], "anti_simple"),
    "string_key_left": lambda b: probe(b).hash_join(
        build(b), ["s"], ["bs"], "left", output=["s", "v", "w"]),
    "two_key_inner_filter": lambda b: probe(b).hash_join(
        build(b), ["k", "s"], ["bk", "bs"], "inner", filter="v <> w",
        output=["k", "s", "v", "w"]),
    "cross_filter": lambda b: probe(b).cross_join(
        build(b).filter("w < 6"), filter="v < w + bk - 10"),
    "cross_empty_build": lambda b: probe(b).cross_join(
        build(b).filter("w > 1000")),
    "scalar_subquery": lambda b: probe(b).cross_join(
        build(b).aggregate([], ["max(w) AS mw"]).enforce_single_row()
    ).filter("v > mw - 10"),
    "single_row_empty": lambda b: probe(b).filter("v < 3").cross_join(
        build(b).filter("w > 1000").project(["w"]).enforce_single_row()),
}


@pytest.fixture(scope="module")
def jax_rows():
    """Both tables in both catalogs (24-row splits, so probes and builds
    span several batches), and each plan's JAX rows, computed once."""
    p, b = _tables()
    rows = {}
    with table_in_both("jp", p, {"s": PROBE_WORDS}, batch_rows=24), \
            table_in_both("jb", b, {"s": BUILD_WORDS}, batch_rows=24):

        def expected(name):
            if name not in rows:
                rows[name] = jax_run_plan(
                    PLANS[name](JaxPlanBuilder).build()).to_pydict()
            return rows[name]

        yield expected


#: the plans each test holds, by the join type or operator they cover
CASES = {
    "left_outer": ["left", "left_null_probe_keys", "left_count_build_column",
                   "string_key_left"],
    "null_aware_anti": ["anti", "anti_null_build_key", "anti_null_probe_keys",
                        "anti_filter", "anti_filter_null_build_key",
                        "string_key_anti_null_build"],
    "anti_simple": ["anti_simple", "anti_simple_filter",
                    "string_key_anti_simple"],
    "filtered_inner_and_semi": ["inner_filter", "semi_filter",
                                "two_key_inner_filter", "string_key_semi"],
    "cross_and_single_row": ["cross_filter", "cross_empty_build",
                             "scalar_subquery", "single_row_empty"],
}


@pytest.mark.parametrize("case", list(CASES))
def test_join_matches_jax(jax_rows, case, monkeypatch):
    for name in CASES[case]:
        exp = jax_rows(name)
        for optimize in (True, False):
            monkeypatch.setattr(torch_config, "optimize_plans", optimize)
            assert_same(torch_run_plan(PLANS[name](TorchPlanBuilder)), exp,
                        f"{name} optimize={optimize}")


def test_anti_cases_are_not_vacuous(jax_rows):
    """The null-aware cases differ as the semantics say they must."""
    assert len(jax_rows("anti")["k"]) > 0
    assert jax_rows("anti_null_build_key")["k"] == []
    assert jax_rows("anti_filter_null_build_key")["k"] == []
    assert None in jax_rows("left")["w"]
    assert None in jax_rows("anti_simple")["k"]
    assert None not in jax_rows("anti_null_probe_keys")["k"]


def test_filtered_expansion_runs_in_chunks(jax_rows, monkeypatch):
    """A filtered semi or anti join whose match pairs outnumber the
    chunk expands a few probe rows at a time, to the same rows."""
    monkeypatch.setattr(HashProbeOp, "_EXPAND_CHUNK", 7)
    for name in ("semi_filter", "anti_filter", "inner_filter", "left"):
        assert_same(torch_run_plan(PLANS[name](TorchPlanBuilder)),
                    jax_rows(name), name)


def test_single_row_guard_raises_on_two_rows():
    def plan(b):
        return probe(b).cross_join(
            build(b).filter("w < 6").project(["w"]).enforce_single_row())

    p, b = _tables()
    with table_in_both("jp", p, {"s": PROBE_WORDS}), \
            table_in_both("jb", b, {"s": BUILD_WORDS}):
        with pytest.raises(Exception, match="single row"):
            jax_run_plan(plan(JaxPlanBuilder).build()).to_pydict()
        with pytest.raises(RuntimeError, match="single row"):
            torch_run_plan(plan(TorchPlanBuilder))
