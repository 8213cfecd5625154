"""The 17 aggregates of the JAX package's ``functions/aggregates_multi.py``
and ``aggregates_noisy.py`` (``min_by``, ``max_by``, the covariance
family, the bitwise aggregates, ``approx_distinct``, ``product``,
``entropy`` and the four noisy gaussian aggregates) held against the JAX
package on the CPU in every mode: keyless, kArray (a dictionary key),
generic (an integer key, ``optimize_plans`` off) and streaming (the table
ascends on the key), with ``narrow_lanes`` on and off, over 24-row
splits with NULLs in either argument, a decimal argument and ties on the
comparison value.

Tolerances: integers, decimals and the bitwise results exactly, DOUBLE
to rtol 1e-9; ``entropy`` to rtol 1e-6 and atol 1e-12 (the reference
takes its ``log2`` in float32, the port in float64); the noisy sums to
1e-6 x scale (the draw is float32 in both, through each library's own
``log`` and ``cos``), the noisy counts exactly.

Where the JAX package cannot be the reference: its streaming aggregation
raises for the matrix lanes of the bitwise aggregates and
``approx_distinct``; their values do not depend on the mode, so the
port's streaming rows are held against the JAX package's generic rows.
"""

import numpy as np
import pytest

from torch_tpch_data import assert_same, table_in_both, values_in_both
from velox_tpu.exec import run_plan as jax_run_plan
from velox_tpu.plan import PlanBuilder as JaxPlanBuilder
from velox_tpu.utils.config import config as jax_config
from velox_tpu_torch.exec import run_plan as torch_run_plan
from velox_tpu_torch.plan import PlanBuilder as TorchPlanBuilder
from velox_tpu_torch.plan.nodes import StreamingAggregationNode
from velox_tpu_torch.plan.optimizer import optimize_plan
from velox_tpu_torch.utils.config import config as torch_config

WORDS = ["kiwi", "apple", "pear", "fig"]

#: NULL where f = 1 (every row of each group k = 0 mod 7); d is DECIMAL
#: (12, 2) cents; w ties often (0..2)
PROJECT = ["k", "s", "w", "c",
           "CASE WHEN f = 1 THEN NULL ELSE x END AS x",
           "CASE WHEN f = 1 THEN NULL ELSE i END AS i",
           "CASE WHEN f = 2 THEN NULL ELSE d END AS d"]

#: the aggregates whose rows do not depend on the mode (matrix lanes)
MATRIX = ["bitwise_and_agg(i) AS band", "bitwise_or_agg(i) AS bor",
          "bitwise_xor_agg(k) AS bxor", "approx_distinct(i) AS ad",
          "approx_distinct(x) AS adx"]

AGGS = [
    "min_by(i, x) AS mb_ix", "max_by(x, w) AS xb_xw", "min_by(d, w) AS mb_dw",
    "covar_samp(x, i) AS cs", "covar_pop(d, x) AS cp",
    "corr(x, i) AS co", "regr_slope(x, d) AS rs", "regr_intercept(i, x) AS ri",
    "product(x) AS px", "entropy(c) AS en",
    "noisy_count_gaussian(i, 2.0) AS nc", "noisy_count_if_gaussian("
    "i > 0, 3.0, 5) AS nci", "noisy_sum_gaussian(x, 1.5, 7) AS ns",
    "noisy_avg_gaussian(d, 0.5) AS na",
]

#: the noisy sums' scales
NOISY_SCALE = {"ns": 1.5, "na": 0.5}

#: mode -> (group keys, optimize_plans)
MODES = {"keyless": ([], True), "karray": (["s"], True),
         "generic": (["k"], False), "streaming": (["k"], True)}


def _table():
    rng = np.random.default_rng(20260917)
    sizes = np.resize([1, 2, 3, 4, 5, 7, 9], 40)
    k = np.repeat(np.arange(40), sizes).astype(np.int64)
    n = len(k)
    f = np.where(k % 7 == 0, 1, rng.integers(0, 6, n))
    return {
        "k": k,
        "s": rng.integers(-1, len(WORDS), n).astype(np.int32),
        "w": rng.integers(0, 3, n).astype(np.int64),
        "c": rng.integers(0, 6, n).astype(np.int64),
        "f": f.astype(np.int64),
        "x": np.round(rng.standard_normal(n) * 20 + 3, 3),
        "i": rng.integers(-1000, 1000, n).astype(np.int64),
        "d": rng.integers(-99999, 99999, n).astype(np.int64),
    }


def _plan(pb, keys, aggs):
    return pb().table_scan("mt").project(PROJECT).aggregate(keys, aggs)


def assert_aggs(got: dict, exp: dict, what: str) -> None:
    """``assert_same`` but for ``entropy`` and the noisy sums."""
    got = dict(got)
    loose = [c for c in exp if c == "en" or c in NOISY_SCALE]
    for c in loose:
        g, e = got.pop(c), exp[c]
        assert [v is None for v in g] == [v is None for v in e], what
        live = [i for i, v in enumerate(e) if v is not None]
        if c == "en":
            np.testing.assert_allclose([g[i] for i in live],
                                       [e[i] for i in live], rtol=1e-6,
                                       atol=1e-12, err_msg=f"{what} {c}")
        else:
            np.testing.assert_allclose([g[i] for i in live],
                                       [e[i] for i in live], rtol=0,
                                       atol=1e-6 * NOISY_SCALE[c],
                                       err_msg=f"{what} {c}")
    assert_same(got, {c: v for c, v in exp.items() if c not in loose}, what)


@pytest.fixture(scope="module")
def mt_table():
    """The table in both catalogs (24-row splits: groups and streams
    cross batches) and each (mode, narrow) case's JAX rows, computed
    once."""
    rows = {}
    old = jax_config.narrow_lanes, torch_config.narrow_lanes
    with table_in_both("mt", _table(), {"s": sorted(WORDS)},
                       overrides={"d": (12, 2)}, batch_rows=24):

        def expected(mode, narrow, aggs):
            key = (mode, narrow, tuple(aggs))
            if key not in rows:
                keys, optimize = MODES[mode]
                jax_config.narrow_lanes = narrow
                jax_config.optimize_plans = optimize
                try:
                    rows[key] = jax_run_plan(
                        _plan(JaxPlanBuilder, keys, aggs).build()
                    ).to_pydict()
                finally:
                    jax_config.optimize_plans = True
            return rows[key]

        yield expected
    jax_config.narrow_lanes, torch_config.narrow_lanes = old


@pytest.mark.parametrize("mode,narrow", [
    ("keyless", True), ("karray", True), ("generic", True),
    ("generic", False), ("streaming", True)])
def test_aggregates_match_jax(mt_table, mode, narrow, monkeypatch):
    from velox_tpu_torch.functions import aggregates, aggregates_multi

    keys, optimize = MODES[mode]
    monkeypatch.setattr(torch_config, "optimize_plans", optimize)
    monkeypatch.setattr(torch_config, "narrow_lanes", narrow)
    # the HLL extract reads its registers a few groups at a time
    monkeypatch.setattr(aggregates_multi, "_EXTRACT_GROUPS", 2)
    if mode in ("keyless", "karray"):
        # into few groups, the per-group reductions that a 2^23-row
        # split takes on the card
        monkeypatch.setattr(aggregates, "_FEW_GROUPS_MIN_ROWS", 0)
    if mode == "streaming":
        assert isinstance(optimize_plan(
            _plan(TorchPlanBuilder, keys, AGGS).build()),
            StreamingAggregationNode)
        # the JAX package's streaming aggregation raises on matrix lanes
        exp = {**mt_table(mode, narrow, AGGS),
               **{c: v for c, v in mt_table("generic", narrow,
                                            MATRIX).items()
                  if c not in keys}}
    else:
        exp = mt_table(mode, narrow, AGGS + MATRIX)
    got = torch_run_plan(_plan(TorchPlanBuilder, keys, AGGS + MATRIX))
    assert_aggs(got, exp, f"{mode} narrow={narrow}")


def test_the_data_holds_what_the_tests_claim(mt_table):
    """NULL results where a group has no valid pair, ties on ``w``, and a
    group whose ``min_by`` payload is itself NULL."""
    got = mt_table("generic", True, AGGS + MATRIX)
    assert None in got["mb_ix"] and None in got["co"] and None in got["cs"]
    assert any(v is not None for v in got["co"])
    t = _table()
    ties = [(g, w) for g in range(40)
            for w in [t["w"][t["k"] == g].min()]
            if (t["w"][t["k"] == g] == w).sum() > 1]
    assert len(ties) > 10
    # the first row of least w in some group has a NULL d (f = 2)
    assert any(t["f"][t["k"] == g][np.argmin(t["w"][t["k"] == g])] == 2
               for g in range(40))
    assert None in got["mb_dw"]
    assert set(got["nc"]) != {0}


def test_tie_rule_follows_the_mode():
    """``min_by(v, c)`` over one group whose optimum c = 1 lies in both
    of two batches: the kArray aggregation keeps the first such row of
    the last batch (14), the generic and keyless ones the first overall
    (11), in both packages."""
    cols = {"g": np.zeros(8, np.int64), "s": np.zeros(8, np.int32),
            "v": np.arange(10, 18, dtype=np.int64),
            "c": np.array([5, 1, 1, 9, 1, 1, 3, 1], np.int64)}
    jb, tb = values_in_both(cols, dictionaries={"s": ["a"]}, batch_rows=4)
    for keys, want in ((["s"], 14), (["g"], 11), ([], 11)):
        aggs = ["min_by(v, c) AS m", "max_by(v, c) AS x"]
        exp = jax_run_plan(JaxPlanBuilder().values(jb).aggregate(
            keys, aggs).build()).to_pydict()
        got = torch_run_plan(TorchPlanBuilder().values(tb).aggregate(
            keys, aggs))
        assert got == exp, keys
        assert got["m"] == [want] and got["x"] == [13], keys


def test_nan_and_inf_stay_in_their_group(monkeypatch):
    """By a dictionary key (kArray), a NaN argument in one group, an inf
    in another and a finite x whose x * x overflows in a third leave the
    fourth group's statistics finite, and every group equals the JAX
    package's, in one step and two: through the scatters, and through
    the per-group reductions that take their place into few groups
    (``aggregates._FEW_GROUPS``)."""
    from velox_tpu_torch.functions import aggregates

    x = np.round(np.random.default_rng(5).standard_normal(24) * 5 + 20, 3)
    x[[2, 8, 14]] = np.nan, np.inf, 1e200
    # entropy's argument without the 1e200, which overflows the JAX
    # package's float32 log2 (the port's is float64)
    e = np.where(x == 1e200, 30.0, x)
    cols = {"s": np.repeat(np.arange(4, dtype=np.int32), 6), "x": x,
            "y": np.arange(24.0) % 7, "e": e}
    jb, tb = values_in_both(cols, dictionaries={"s": WORDS}, batch_rows=8)
    aggs = ["covar_samp(x, y) AS cs", "corr(y, x) AS co",
            "regr_intercept(y, x) AS ri", "entropy(e) AS en",
            "product(x) AS px", "noisy_sum_gaussian(x, 1.5, 7) AS ns",
            "noisy_avg_gaussian(x, 0.5) AS na", "min_by(y, x) AS mb"]
    exp = jax_run_plan(JaxPlanBuilder().values(jb).aggregate(
        ["s"], aggs).build()).to_pydict()
    fourth = exp["s"].index(WORDS[3])
    assert all(np.isfinite(exp[c][fourth]) for c in exp if c != "s")
    assert np.isnan(exp["cs"][exp["s"].index(WORDS[0])])
    for min_rows in (aggregates._FEW_GROUPS_MIN_ROWS, 0):
        monkeypatch.setattr(aggregates, "_FEW_GROUPS_MIN_ROWS", min_rows)
        got = torch_run_plan(TorchPlanBuilder().values(tb).aggregate(
            ["s"], aggs))
        assert_aggs(got, exp, f"one step, min_rows={min_rows}")
        got = torch_run_plan(TorchPlanBuilder().values(tb).partial_aggregation(
            ["s"], aggs).final_aggregation())
        assert_aggs(got, exp, f"two steps, min_rows={min_rows}")


def test_two_step_matches_jax(mt_table, monkeypatch):
    """``min_by``, ``max_by``, ``corr``, the bitwise and the noisy
    aggregates through PARTIAL -> FINAL (64 ``name$0@j`` columns for each
    bitwise aggregate) in the kArray, generic and keyless modes, equal to
    the JAX package's single step (its two-step kArray result is empty;
    ``tests/test_torch_agg_steps.py``)."""
    aggs = ["min_by(i, x) AS mb_ix", "max_by(d, w) AS xb_dw",
            "corr(x, i) AS co", "bitwise_and_agg(i) AS band",
            "bitwise_xor_agg(k) AS bxor", "noisy_sum_gaussian(x, 1.5, 7) "
            "AS ns", "noisy_count_gaussian(i, 2.0) AS nc"]
    monkeypatch.setattr(torch_config, "optimize_plans", False)
    monkeypatch.setattr(torch_config, "narrow_lanes", True)
    for mode in ("karray", "generic", "keyless"):
        keys, _ = MODES[mode]
        plan = (TorchPlanBuilder().table_scan("mt").project(PROJECT)
                .partial_aggregation(keys, aggs))
        assert sum(n.startswith("band$0@")
                   for n in plan.node.output_type.names) == 64
        got = torch_run_plan(plan.final_aggregation())
        assert_aggs(got, mt_table(mode, True, aggs), f"two-step {mode}")


def test_max_data_size_for_stats_matches_jax():
    """``max_data_size_for_stats``/``sum_data_size_for_stats`` rewrite to
    max/sum over ``data_size_for_stats`` in both builders."""
    cols = {"g": np.array([0, 0, 1, 1, 1], np.int64),
            "v": np.array([5, -1, 7, 8, 9], np.int64),
            "x": np.array([1.5, 2.5, 0.0, 3.0, 4.0])}
    nulls = {"v": np.array([False, True, False, False, True])}
    jb, tb = values_in_both(cols, nulls)
    aggs = ["max_data_size_for_stats(v) AS mv",
            "sum_data_size_for_stats(v) AS sv",
            "sum_data_size_for_stats(x) AS sx"]
    for keys in (["g"], []):
        exp = jax_run_plan(JaxPlanBuilder().values(jb).aggregate(
            keys, aggs).build()).to_pydict()
        got = torch_run_plan(TorchPlanBuilder().values(tb).aggregate(
            keys, aggs))
        assert got == exp, keys


def test_numpy_copies_match_the_port():
    """The chip check's numpy oracles (``tpch/agg_step_plans.py``):
    the HLL estimate over the same hash equals the port's, and lies
    within 10% of the true distinct count in the linear-counting range;
    the float32 gaussian draw agrees to 1e-6 (numpy's own ``log`` and
    ``cos``)."""
    import torch

    from velox_tpu_torch.functions.aggregates_multi import hll_bucket_rank
    from velox_tpu_torch.functions.aggregates_noisy import group_gaussian
    from velox_tpu_torch.tpch import agg_step_plans as asp

    rng = np.random.default_rng(5)
    for v, ratio in ((rng.integers(0, 1500, 20000), (0.9, 1.1)),
                     (rng.standard_normal(3000), (0.9, 1.1)),
                     (rng.integers(0, 9000, 60000), (1.6, 2.2))):
        bucket, rank = hll_bucket_rank(torch.from_numpy(v))
        nb, nr = asp.hll_bucket_rank(v)
        assert np.array_equal(bucket.numpy(), nb)
        assert np.array_equal(rank.numpy(), nr)
        gids = rng.integers(0, 3, len(v))
        want = asp.approx_distinct(v, gids, 3)
        exact = np.array([len(np.unique(v[gids == g])) for g in range(3)])
        got = torch_run_plan(TorchPlanBuilder().values(values_in_both(
            {"g": gids, "v": v}, batch_rows=4096)[1]).aggregate(
            ["g"], ["approx_distinct(v) AS a"]).order_by(["g"]))
        assert got["a"] == want.tolist()
        # the reference's rank is one above the usual leading-zero count
        # of its 53-bit remainder: past the linear-counting range (2.5 x
        # 1024 registers) the estimate is about twice the count
        assert np.all((want >= ratio[0] * exact)
                      & (want <= ratio[1] * exact)), (want, exact)
    seeds = np.array([0, 7, -3, 2 ** 40 + 5], np.int64)
    for ng in (1, 50):
        for sd in seeds:
            z = group_gaussian(torch.full((ng,), int(sd)), ng).numpy()
            np.testing.assert_allclose(
                z, asp.group_gaussian(np.full(ng, sd), ng), rtol=0,
                atol=1e-6, err_msg=f"{ng} {sd}")


def test_registry_holds_the_references_multi_argument_aggregates():
    """The port registers the 17 aggregates of the JAX package's
    ``aggregates_multi.py`` and ``aggregates_noisy.py`` under their
    names, each with the reference's lanes and lane widths."""
    from velox_tpu.functions.aggregates import aggregate_registry as jax_reg
    from velox_tpu_torch.functions.aggregates import aggregate_registry

    import velox_tpu.functions.aggregates_multi  # noqa: F401
    import velox_tpu.functions.aggregates_noisy  # noqa: F401

    names = {"min_by", "max_by", "covar_samp", "covar_pop", "corr",
             "regr_slope", "regr_intercept", "bitwise_and_agg",
             "bitwise_or_agg", "bitwise_xor_agg", "approx_distinct",
             "product", "entropy", "noisy_count_gaussian",
             "noisy_count_if_gaussian", "noisy_sum_gaussian",
             "noisy_avg_gaussian"}
    assert names <= set(aggregate_registry) and names <= set(jax_reg)
    for name in names:
        assert [(lane.name, lane.width)
                for lane in aggregate_registry[name].lanes] == [
            (lane.name, lane.width) for lane in jax_reg[name].lanes], name
