"""The 14 single-argument aggregates beyond sum/count/avg/min/max
(``count_if``, the variance family, ``bool_and``/``bool_or``,
``arbitrary``, ``checksum``, ``geometric_mean``, ``skewness``,
``kurtosis``) held against the JAX package on the CPU in every mode the
port runs them in: keyless, kArray (a dictionary key), generic (an
integer key, ``optimize_plans`` off) and streaming (the table ascends on
the key, ``optimize_plans`` on). The table has NULL inputs, all-NULL
groups and groups of 1-7 rows, so the ``n >= 2/3/4`` NULL rules of the
sample statistics act. Integers, booleans and ``checksum`` must be
equal, DOUBLE results to rtol=1e-9.

Where the JAX package cannot be the reference: ``arbitrary`` over a
VARCHAR raises there (its codes reach Arrow without their dictionary),
so the port's strings are held against plain Python: each group's
largest string."""

import numpy as np
import pytest

from torch_tpch_data import assert_same, table_in_both
from velox_tpu.exec import run_plan as jax_run_plan
from velox_tpu.plan import PlanBuilder as JaxPlanBuilder
from velox_tpu_torch.exec import run_plan as torch_run_plan
from velox_tpu_torch.plan import PlanBuilder as TorchPlanBuilder
from velox_tpu_torch.plan.nodes import StreamingAggregationNode
from velox_tpu_torch.plan.optimizer import optimize_plan
from velox_tpu_torch.utils.config import config as torch_config

WORDS = ["kiwi", "apple", "pear", "fig"]

#: NULL where f = 1; f = 1 on every row of each group k = 0 (mod 7)
PROJECT = ["k", "s", "ws",
           "CASE WHEN f = 1 THEN NULL ELSE x END AS x",
           "CASE WHEN f = 1 THEN NULL ELSE i END AS i",
           "CASE WHEN f = 1 THEN NULL ELSE i > 0 END AS b"]

AGGS = [
    "count_if(b) AS n_b", "variance(x) AS var_x", "var_samp(i) AS vs_i",
    "var_pop(x) AS vp_x", "stddev(i) AS sd_i", "stddev_samp(x) AS ss_x",
    "stddev_pop(i) AS sp_i", "bool_and(b) AS all_b", "bool_or(b) AS any_b",
    "arbitrary(i) AS arb_i", "arbitrary(x) AS arb_x",
    "checksum(i) AS ck_i", "checksum(x) AS ck_x", "checksum(b) AS ck_b",
    "geometric_mean(x) AS gm_x", "geometric_mean(i) AS gm_i",
    "skewness(x) AS sk_x", "skewness(i) AS sk_i", "kurtosis(x) AS ku_x",
    "kurtosis(i) AS ku_i",
]

#: mode -> (group keys, optimize_plans)
MODES = {"keyless": ([], True), "karray": (["s"], True),
         "generic": (["k"], False), "streaming": (["k"], True)}


def _table():
    rng = np.random.default_rng(20240615)
    sizes = np.resize([1, 2, 3, 4, 5, 7], 42)
    k = np.repeat(np.arange(42), sizes).astype(np.int64)
    n = len(k)
    f = np.where(k % 7 == 0, 1, (rng.random(n) < 0.2).astype(np.int64))
    return {
        "k": k,
        "s": rng.integers(-1, len(WORDS), n).astype(np.int32),
        "ws": rng.integers(-1, len(WORDS), n).astype(np.int32),
        "f": f.astype(np.int64),
        "x": rng.standard_normal(n) * 50 + 3,
        "i": rng.integers(-40, 60, n).astype(np.int64),
    }


def _plan(pb, keys, aggs=AGGS):
    return pb().table_scan("ag").project(PROJECT).aggregate(keys, aggs)


@pytest.fixture(scope="module")
def ag_table():
    """The table in both catalogs (24-row splits: groups and streams
    cross batches), and each mode's JAX rows, computed once."""
    t = _table()
    rows = {}
    with table_in_both("ag", t, {"s": sorted(WORDS), "ws": sorted(WORDS)},
                       batch_rows=24):

        def expected(mode):
            if mode not in rows:
                keys, _ = MODES[mode]
                rows[mode] = jax_run_plan(
                    _plan(JaxPlanBuilder, keys).build()).to_pydict()
            return rows[mode]

        yield t, expected


@pytest.mark.parametrize("mode", list(MODES))
def test_aggregates_match_jax(ag_table, mode, monkeypatch):
    _, expected = ag_table
    keys, optimize = MODES[mode]
    monkeypatch.setattr(torch_config, "optimize_plans", optimize)
    plan = _plan(TorchPlanBuilder, keys)
    if mode == "streaming":
        assert isinstance(optimize_plan(plan.build()),
                          StreamingAggregationNode)
    assert_same(torch_run_plan(plan), expected(mode), mode)


def test_null_rules_are_not_vacuous(ag_table):
    """Groups of 1-3 valid rows null the sample statistics, an all-NULL
    group nulls every value but ``count_if`` and ``checksum``."""
    _, expected = ag_table
    got = expected("streaming")
    for name in ("vs_i", "sk_x", "ku_i"):     # n >= 2, 3, 4
        assert None in got[name] and any(
            v is not None for v in got[name]), name
    dead = [i for i, k in enumerate(got["k"]) if k % 7 == 0]
    assert dead and all(got["gm_x"][i] is None and got["arb_i"][i] is None
                        and got["all_b"][i] is None
                        and got["n_b"][i] == 0 and got["ck_i"][i] == 0
                        for i in dead)
    assert set(got["all_b"]) >= {True, False}
    assert set(got["any_b"]) >= {True, False}


@pytest.mark.parametrize("mode", list(MODES))
def test_arbitrary_varchar_against_python(ag_table, mode, monkeypatch):
    """Each group's largest string (its sorted dictionary's last code),
    NULL where the group has none; the JAX package raises here."""
    t, _ = ag_table
    keys, optimize = MODES[mode]
    monkeypatch.setattr(torch_config, "optimize_plans", optimize)
    got = torch_run_plan(
        TorchPlanBuilder().table_scan("ag")
        .aggregate(keys, ["arbitrary(ws) AS a", "count(ws) AS n"]))
    words = sorted(WORDS)
    groups = {}
    for row, code in enumerate(t["ws"]):
        key = tuple(words[t[c][row]] if c == "s" and t[c][row] >= 0
                    else (None if c == "s" else int(t[c][row]))
                    for c in keys)
        groups.setdefault(key, []).append(
            None if code < 0 else words[code])
    got_rows = {tuple(got[c][r] for c in keys): (got["a"][r], got["n"][r])
                for r in range(len(got["a"]))}
    assert len(got_rows) == len(groups)
    for key, vals in groups.items():
        live = [v for v in vals if v is not None]
        assert got_rows[key] == ((max(live) if live else None), len(live))


def test_checksum_of_nan_and_infinities_matches_jax():
    """``checksum`` of a DOUBLE hashes trunc(x * 1e6) as XLA converts it:
    NaN to 0, +inf and values beyond 2^63 to the int64 max, -inf to the
    min (torch's own cast on the CPU gives the min for all of them)."""
    x = np.array([np.nan, np.inf, -np.inf, 1e300, -1e300, 0.0, -0.0,
                  2.5e-7, -2.5e-7, 1.9999999e-6, 12.345678, -7.0])
    groups = np.arange(len(x), dtype=np.int64)
    with table_in_both("ck", {"g": groups, "x": x}):
        for keys in ([], ["g"]):
            exp = jax_run_plan(JaxPlanBuilder().table_scan("ck").aggregate(
                keys, ["checksum(x) AS c"]).build()).to_pydict()
            got = torch_run_plan(TorchPlanBuilder().table_scan("ck")
                                 .aggregate(keys, ["checksum(x) AS c"]))
            assert got == exp, keys
    # NaN and 0.0 hash alike, as do everything below 1e-6 in magnitude
    assert exp["c"][0] == exp["c"][5] == exp["c"][7] == exp["c"][8]


def test_count_if_keeps_out_of_the_multi_sum_kernel(ag_table, monkeypatch):
    """kArray aggregation sends only all-additive integer aggregates to
    B2, as the reference does: ``count_if``'s bool argument keeps the
    whole node on the scatter path; ``count(x)`` and ``sum(x)`` take B2,
    with ``count(x)`` as one count lane (it raised an IndexError there
    before), and equal the JAX package."""
    from velox_tpu_torch.ops import grouped_sum

    calls = []
    real = grouped_sum.grouped_multi_sum_i32
    monkeypatch.setattr(grouped_sum, "grouped_multi_sum_i32",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    monkeypatch.setattr(torch_config, "narrow_lanes", True)
    for aggs, launches in ((["count_if(b) AS n", "sum(i) AS t"], 0),
                           (["count(i) AS n", "sum(i) AS t",
                             "count(*) AS r"], 7)):
        calls.clear()
        got = torch_run_plan(_plan(TorchPlanBuilder, ["s"], aggs))
        assert len(calls) == launches, aggs     # once a 24-row split
        assert_same(got, jax_run_plan(
            _plan(JaxPlanBuilder, ["s"], aggs).build()).to_pydict(), aggs)


def test_registry_holds_the_references_single_argument_aggregates():
    """The port registers the 19 aggregates of the JAX package's
    ``functions/aggregates.py``, each under the JAX package's name."""
    from velox_tpu.functions.aggregates import aggregate_registry as jax_reg
    from velox_tpu_torch.functions.aggregates import aggregate_registry

    names = {"sum", "count", "count_if", "avg", "min", "max", "variance",
             "var_samp", "var_pop", "stddev", "stddev_samp", "stddev_pop",
             "bool_and", "bool_or", "arbitrary", "checksum",
             "geometric_mean", "skewness", "kurtosis"}
    assert set(aggregate_registry) == names
    assert names <= set(jax_reg)
    for name in names:
        assert len(aggregate_registry[name].lanes) == len(
            jax_reg[name].lanes), name
