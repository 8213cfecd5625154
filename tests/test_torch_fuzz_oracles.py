"""The port's plain-Python fuzzer oracles against the JAX package's
pandas ones, and the port's six fuzzers end to end on the CPU.

The expression and join oracles are module functions in both packages
and are compared case by case on every drawn case. The window and plan
oracles of the JAX package are inline in its fuzz loops: there the JAX
fuzzer runs with its engine call answered by the port's oracle for the
same drawn case (the draws are the same, ``test_torch_fuzz_draws.py``),
so the JAX fuzzer's own pandas checks judge the port's oracle. Where the
port's SQL departs from pandas (a ``sum`` of only NULLs is NULL, not
0.0), the departure is pinned here by seed and iteration and listed in
ROADMAP under the reference's differences. ``test_torch_fuzz_draws.py``
also runs the JAX fuzzers' checks on the port's engine results; here
the one drawn case where the JAX aggregation fuzzer's check is wrong is
pinned.
"""

import math
from collections import Counter

import numpy as np
import pandas as pd
import pytest

from velox_tpu.fuzzer import aggregation_fuzzer as jax_agg
from velox_tpu.fuzzer import expression_fuzzer as jax_expr
from velox_tpu.fuzzer import join_fuzzer as jax_join
from velox_tpu.fuzzer import plan_fuzzer as jax_plan
from velox_tpu.fuzzer import window_fuzzer as jax_window
from velox_tpu.plan import serde as jax_serde
from velox_tpu_torch.exec import run_plan
from velox_tpu_torch.fuzzer import aggregation_fuzzer as agg
from velox_tpu_torch.fuzzer import expression_fuzzer as expr
from velox_tpu_torch.fuzzer import join_fuzzer as join
from velox_tpu_torch.fuzzer import plan_fuzzer as planf
from velox_tpu_torch.fuzzer import window_fuzzer as window
from velox_tpu_torch.fuzzer.vector_fuzzer import VectorFuzzer
from velox_tpu_torch.plan import serde as torch_serde

from torch_fuzz_shim import route_to_port


def _na(v) -> bool:
    return v is None or (isinstance(v, float) and math.isnan(v))


def _same(a, b) -> bool:
    """One row of two oracles: NULL for NULL, booleans and numbers by
    value (pandas holds a nullable integer column as float64)."""
    if _na(a) or _na(b):
        return _na(a) and _na(b)
    if isinstance(a, (bool, np.bool_)) or isinstance(b, (bool, np.bool_)):
        return bool(a) == bool(b)
    if isinstance(a, str) or isinstance(b, str):
        return a == b
    return math.isclose(float(a), float(b), rel_tol=1e-12, abs_tol=1e-15)


@pytest.mark.parametrize("seed", [0, 11])
def test_expression_oracle_equals_the_references(seed):
    rows = 64
    rng = np.random.default_rng(seed + 99)
    vf = VectorFuzzer(seed + 1)
    compared = 0
    for it in range(100):
        _, table, e = expr.draw_iteration(rng, vf, it, seed, rows)
        n = len(next(iter(table.values())))
        got = expr._oracle(e, table, n)
        jtree = jax_serde.expr_from_dict(torch_serde.expr_to_dict(e))
        want = jax_expr._oracle(jtree, pd.DataFrame(table))
        for i in range(n):
            assert _same(got[i], want.iloc[i]), (it, i, e, got[i],
                                                 want.iloc[i])
        compared += n
    assert compared > 4000


def test_join_oracle_equals_the_references():
    """Every drawn case of three seeds, whatever its filter and keys (the
    fuzzers consult the oracle on the filterless one-key ones)."""
    types = set()
    for seed in (21, 8, 0):
        rng = np.random.default_rng(seed)
        for it in range(50):
            c = join.draw_case(rng)
            got = join._oracle(c.left, c.right, c.jt, c.out_cols)
            want = jax_join._pandas_oracle(c.left, c.right, c.jt,
                                           c.out_cols)
            assert got == want, (seed, it, c.describe())
            types.add(c.jt)
    assert types == set(join._JOIN_TYPES)


def test_window_oracle_judged_by_the_references(monkeypatch):
    iterations = 40
    for seed in (23, 6):
        rng = np.random.default_rng(seed)
        answers = iter([window.draw_case(rng) for _ in range(iterations)])

        def oracle(plan, answers=answers):
            case = next(answers)
            exp = window.oracle(case)
            return {"w": [exp[rid] for rid in range(len(case.data["rid"]))]}

        monkeypatch.setattr(jax_window, "run_plan_pydict", oracle)
        jax_window.run_window_fuzz(iterations, seed)
        assert next(answers, None) is None


#: (seed, iteration) -> the group keys whose ``sum(v)`` the port's oracle
#: gives as NULL, every ``v`` of the group being NULL, where the JAX
#: package's pandas oracle gives 0.0
PLAN_DEPARTURES = {(11, 0): [3], (27, 13): [0, 2]}


def test_plan_oracle_judged_by_the_references(monkeypatch):
    """Four seeds' 200 cases; the departures are each the port's SQL
    NULL against pandas' 0.0, and the port's engine gives the NULL."""
    iterations = 50
    departures = {}
    for seed in (7, 8, 11, 27):
        rng = np.random.default_rng(seed)
        answers = iter(enumerate(
            [planf.draw_case(rng) for _ in range(iterations)]))

        def oracle(plan, seed=seed, answers=answers):
            i, case = next(answers)
            out = planf.oracle(case)
            if case.agg_fn == "sum":
                keys = out["g"] if case.agg_keyed else [None]
                nulls = [k for k, a, c in zip(keys, out["a"], out["c"])
                         if a is None and c > 0]
                if nulls:
                    departures[(seed, i)] = nulls
                    out["a"] = [0.0 if a is None and c > 0 else a
                                for a, c in zip(out["a"], out["c"])]
            return out

        monkeypatch.setattr(jax_plan, "run_plan_pydict", oracle)
        jax_plan.run_plan_fuzz(iterations, seed)
        assert next(answers, None) is None
    assert departures == PLAN_DEPARTURES
    planf.run_plan_fuzz(14, seed=27, device="cpu")


def test_a_sum_of_only_nulls_is_null_in_the_port_and_zero_in_pandas():
    """The plan fuzzer's one SQL departure from pandas, on a hand-made
    case: the port's oracle and engine both give NULL."""
    left = {"k": [1, 1, 2], "v": [None, None, 0.5], "g": [0, 0, 1]}
    right = {"k": [1], "v": [0.1], "g": [0]}
    for keyed in (True, False):
        case = planf.Case(left, right, "left_semi", 0.0, False, keyed,
                          "sum", [0, 3], [0, 1])
        want = planf.oracle(case)
        assert want["a"] == [None] and want["c"] == [2]
        planf.check(0, case, run_plan(case.plan("cpu").build()), want)
    assert pd.Series([np.nan, np.nan]).sum() == 0.0


def test_the_references_aggregation_check_fails_on_a_correct_digest(
        monkeypatch):
    """Seed 109 draws ``approx_percentile(x, 0.5)`` with no key over 108
    rows (101 non-NULL values) at iteration 1: past 64 values a group the
    two-step digest is an approximation (0.215 where the exact single
    step gives 0.213), which
    the JAX fuzzer's exact comparison refuses. The port's fuzzer holds
    it to the digest's rank error instead."""
    monkeypatch.setattr(jax_agg, "run_plan_pydict", route_to_port)
    with pytest.raises(AssertionError, match="approx_percentile.*"
                       "partial_final disagrees"):
        jax_agg.run_aggregation_fuzz(2, 109)
    rng = np.random.default_rng(109)
    fns = agg.fuzzed_aggregates()
    agg.draw_case(rng, 0, fns)
    case = agg.draw_case(rng, 1, fns)
    assert case.fn == "approx_percentile" and not case.keyed
    assert agg._past_exact_digest(case)
    make, _ = case.plans("cpu")["partial_final"]
    two_step = run_plan(make().build())
    assert agg._digest_rank_errors(case, two_step) == []
    assert agg._digest_rank_errors(case, {"a": [0.9]}) != []
    agg.run_aggregation_fuzz(2, 109, device="cpu")


@pytest.mark.parametrize("name", ["expression", "window", "join", "plan",
                                  "aggregation"])
def test_the_port_fuzzers_run_end_to_end(name):
    if name == "expression":
        assert expr.run_expression_fuzz(60, seed=31, rows=64,
                                        device="cpu") > 40
    elif name == "window":
        window.run_window_fuzz(30, seed=32, device="cpu")
    elif name == "join":
        assert join.run_join_fuzz(25, seed=33, device="cpu") == {
            "hash": 25, "merge": 25, "spilled": 25}
    elif name == "plan":
        planf.run_plan_fuzz(40, seed=34, device="cpu")
    else:
        strategies = Counter()
        assert agg.run_aggregation_fuzz(
            50, seed=35, device="cpu", strategies=strategies) == \
            agg.missing_aggregates()
        assert set(strategies) == {"single", "partial_final", "streaming",
                                   "spilled"}
