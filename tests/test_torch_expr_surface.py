"""The expression and aggregate surface the 18 TPC-H queries beyond
Q1/Q3/Q6/Q18 add, each held against the JAX package on one small
hand-made table with NULLs, through both packages' ``run_plan`` on the
CPU: ``LIKE``/``NOT LIKE`` (leading, trailing and inner ``%``, ``_``),
``substr``, ``year``, ``CASE`` with string, numeric and NULL branches,
decimal division and decimal times a DOUBLE literal, ``min``/``max`` in
kArray, generic and streaming aggregation, and ``count(distinct)``.
Integer, decimal, date and string results must be equal, row order
included; DOUBLE results agree to rtol=1e-9. Each plan runs once in the
JAX package and is shared by the cases that read it."""

import numpy as np
import pytest

from torch_tpch_data import assert_same, table_in_both
from velox_tpu.exec import run_plan as jax_run_plan
from velox_tpu.plan import PlanBuilder as JaxPlanBuilder
from velox_tpu_torch.exec import run_plan as torch_run_plan
from velox_tpu_torch.plan import PlanBuilder as TorchPlanBuilder
from velox_tpu_torch.utils.config import config as torch_config

N = 300
STRINGS = ["abcd", "abxcd", "xyz", "b_d", "abc", "aXcd", "Customer x "
           "Complaints", "cd", "", "a", "zzabcd", "PROMO BRASS", "ab%"]
GROUPS = ["red", "green", "blue", "grey"]

PROJECTIONS = {
    "like_prefix": "s LIKE 'ab%'",
    "like_suffix": "s LIKE '%cd'",
    "like_inner": "s LIKE '%b%d%'",
    "like_one_char": "s LIKE 'a_c%'",
    "like_exact": "s LIKE 'abcd'",
    "like_everything": "s LIKE '%'",
    "not_like": "s NOT LIKE '%x%'",
    "substr_len": "substr(s, 2, 3)",
    "substr_rest": "substr(s, 2)",
    "substr_head": "substr(s, 1, 2)",
    "year": "year(d)",
    "if_string": "if(x > 5, s, 'zz')",
    "if_string_null": "if(x > 5, g, NULL)",
    "case_decimal_double": "CASE WHEN x > 5 THEN m ELSE 0.0 END",
    "case_ints": "CASE WHEN x > 15 THEN 1 WHEN x > 5 THEN 2 ELSE 3 END",
    "case_no_else": "CASE WHEN x > 10 THEN m END",
    "case_decimals": "CASE WHEN g = 'red' THEN m ELSE m * 2 END",
    "case_string_cond": "CASE WHEN s LIKE '%c%' THEN x ELSE 0 - x END",
    "decimal_div_literal": "m / 7.0",
    "decimal_div_decimal": "m / (m + 1000.0)",
    "double_times_double_div_decimal": "100.0 * f / m",
    "literal_times_decimal": "0.2 * m",
    "decimal_times_literal": "m * 0.5",
    "int_div": "(x - 10) / 3",
    "double_div_int": "f / x",
    "decimal_or": "m > 10.0 OR s LIKE 'ab%'",
}

AGGREGATES = {
    "array_minmax": lambda b: b.aggregate(
        ["g"], ["min(m) AS mn", "max(m) AS mx", "min(f) AS mnf",
                "max(x) AS mxx", "max(d) AS mxd"]),
    "generic_minmax_distinct": lambda b: b.aggregate(
        ["x"], ["min(m) AS mn", "max(f) AS mxf", "count(distinct g) AS cg",
                "count(distinct m) AS cm", "sum(m) AS sm"]).order_by(["x"]),
    "keyless_distinct": lambda b: b.aggregate(
        [], ["count(distinct x) AS cx", "count(distinct s) AS cs",
             "min(m) AS mn", "max(d) AS mxd", "count(*) AS n"]),
    "streaming_minmax": lambda b: b.streaming_aggregate(
        ["k"], ["min(m) AS mn", "max(f) AS mxf", "min(x) AS mnx",
                "max(m) AS mxm", "count(*) AS n"]),
    "decimal_avg_ratio": lambda b: b.project(
        ["g", "m", "CASE WHEN x > 5 THEN m ELSE 0.0 END AS dm"]).aggregate(
        ["g"], ["avg(m) AS am", "sum(dm) AS sd", "sum(m) AS sm"]).project(
        ["g", "am", "sd / sm AS share", "0.2 * am AS lim"]),
}

FILTERS = {
    "like_and_not_like": "s LIKE '%b%' AND s NOT LIKE 'ab%'",
    "substr_in": "substr(s, 1, 2) IN ('ab', 'xy', 'cd')",
    "year_eq": "year(d) = 1996",
    "case_in_filter": "CASE WHEN x > 10 THEN m ELSE 0.0 END > 5.0",
}


def _table():
    rng = np.random.default_rng(20240607)
    s = rng.integers(-1, len(STRINGS), N).astype(np.int32)   # -1: NULL
    g = rng.integers(0, len(GROUPS), N).astype(np.int32)
    days = rng.integers(-2000, 12000, N)
    days[:4] = [0, -1, 11016, 10956]          # 1970, 1969, 2000-02-29, 1999
    return {
        "s": s, "g": g,
        "x": rng.integers(0, 21, N).astype(np.int64),
        "k": np.sort(rng.integers(0, 60, N)).astype(np.int64),
        "d": days.astype("datetime64[D]"),
        "m": rng.integers(-99999, 999999, N).astype(np.int64),
        "f": rng.normal(0, 100, N),
    }


@pytest.fixture(scope="module")
def jax_rows():
    """The table in both catalogs, and each plan's JAX rows, computed
    once when first asked for."""
    rows = {}
    with table_in_both("ex", _table(), {"s": STRINGS, "g": GROUPS},
                       {"m": (7, 2)}):

        def expected(key, plan):
            if key not in rows:
                rows[key] = jax_run_plan(
                    plan(JaxPlanBuilder).build()).to_pydict()
            return rows[key]

        yield expected


def _scan(builder):
    return builder().table_scan("ex", columns=["s", "g", "x", "k", "d",
                                               "m", "f"])


def _projection(builder):
    return _scan(builder).project(
        ["k"] + [f"{e} AS {n}" for n, e in PROJECTIONS.items()])


#: the projections and filters each test holds, by the surface it covers
SURFACES = {
    "like": (["like_prefix", "like_suffix", "like_inner", "like_one_char",
              "like_exact", "like_everything", "not_like"],
             ["like_and_not_like"]),
    "substr": (["substr_len", "substr_rest", "substr_head"], ["substr_in"]),
    "year": (["year"], ["year_eq"]),
    "case": (["if_string", "if_string_null", "case_decimal_double",
              "case_ints", "case_no_else", "case_decimals",
              "case_string_cond"], ["case_in_filter"]),
    "arithmetic": (["decimal_div_literal", "decimal_div_decimal",
                    "double_times_double_div_decimal",
                    "literal_times_decimal", "decimal_times_literal",
                    "int_div", "double_div_int", "decimal_or"], []),
}


def _filter_plan(name):
    def plan(builder):
        return (builder().table_scan("ex", columns=["s", "x", "d", "m"],
                                     subfilter=FILTERS[name])
                .project(["s", "x", "m"]))
    return plan


@pytest.mark.parametrize("group", list(SURFACES))
def test_expressions_match_jax(jax_rows, group):
    columns, filters = SURFACES[group]
    exp = jax_rows("projection", _projection)
    got = torch_run_plan(_projection(TorchPlanBuilder))
    assert_same({c: got[c] for c in columns}, {c: exp[c] for c in columns},
                group)
    for name in filters:
        exp = jax_rows(name, _filter_plan(name))
        assert len(exp["x"]) > 0, name
        assert_same(torch_run_plan(_filter_plan(name)(TorchPlanBuilder)),
                    exp, name)


@pytest.mark.parametrize("names", [
    ["array_minmax", "streaming_minmax"],
    ["generic_minmax_distinct", "keyless_distinct"],
    ["decimal_avg_ratio"]], ids=["minmax", "count_distinct", "decimal_avg"])
def test_aggregation_matches_jax(jax_rows, names, monkeypatch):
    """Each plan with ``optimize_plans`` on and off against one JAX run."""
    for name in names:
        def plan(builder, name=name):
            return AGGREGATES[name](_scan(builder))

        exp = jax_rows(name, plan)
        for optimize in (True, False):
            monkeypatch.setattr(torch_config, "optimize_plans", optimize)
            assert_same(torch_run_plan(plan(TorchPlanBuilder)), exp,
                        f"{name} optimize={optimize}")
