"""The math functions of the port's scalar surface against the JAX
package, on one small hand-made table with NULLs and edge values (0,
+-0.0, NaN, +-inf, exact halves, int64 extremes): ``round`` with and
without digits (half away from zero, at +-0.5, +-2.5, 1.005 at 2 digits),
``floor``/``ceil``/``truncate``/``sign``, the transcendental,
trigonometric and hyperbolic functions, the NaN and infinity tests and
constants, ``data_size_for_stats``, ``width_bucket``, ``clamp``, ``pmod``
and ``great_circle_distance``. Integer, decimal, boolean and NULL results
must be equal, DOUBLE ones to rtol=1e-9. The JAX rows are computed once
per module."""

import math

import numpy as np
import pytest

from torch_tpch_data import assert_same, values_in_both
from velox_tpu.exec import run_plan as jax_run_plan
from velox_tpu.plan import PlanBuilder as JaxPlanBuilder
from velox_tpu_torch.exec import run_plan as torch_run_plan
from velox_tpu_torch.plan import PlanBuilder as TorchPlanBuilder

N = 120
I64 = np.iinfo(np.int64)
HALVES = [0.5, -0.5, 2.5, -2.5, 1.5, -1.5, 0.0, -0.0, np.nan, np.inf,
          -np.inf, 1.005, -1.005, 2.675, 0.125, 1e300, -1e-300, 0.49999999]

PROJECTIONS = {
    "round": {
        "round_f": "round(f)", "round_f2": "round(f, 2)",
        "round_f0": "round(f, 0)", "round_fneg": "round(f, -1)",
        "round_fd": "round(f, d)", "round_i": "round(i)",
        "round_j2": "round(j, 2)", "round_m": "round(m, 1)",
        "round_lit": "round(1.005, 2)",
    },
    "floor_sign": {
        "floor_f": "floor(f)", "ceil_f": "ceil(f)", "ceiling_f": "ceiling(f)",
        "floor_i": "floor(i)", "ceil_j": "ceil(j)",
        "truncate_f": "truncate(f)", "truncate_f2": "truncate(f, 2)",
        "truncate_i": "truncate(i)", "sign_f": "sign(f)",
        "sign_i": "sign(i)", "sign_j": "sign(j)", "abs_f": "abs(f)",
    },
    "transcendental": {
        "sqrt": "sqrt(g)", "cbrt": "cbrt(f)", "exp": "exp(u)",
        "ln": "ln(g)", "log2": "log2(g)", "log10": "log10(g)",
        "power": "power(g, u)", "pow": "pow(u, 3.0)",
        # BIGINT arguments: the JAX package takes an INTEGER one through
        # float32 (jnp's promotion), the port through float64
        "sqrt_k": "sqrt(k)", "exp_k": "exp(k)", "ln_k": "ln(k)",
    },
    "trigonometric": {
        "sin": "sin(f)", "cos": "cos(f)", "tan": "tan(u)",
        "asin": "asin(u)", "acos": "acos(u)", "atan": "atan(f)",
        "sinh": "sinh(u)", "cosh": "cosh(u)", "tanh": "tanh(f)",
        "atan2": "atan2(f, u)", "atan2_j": "atan2(j, g)",
        "degrees": "degrees(f)", "radians": "radians(f)",
    },
    "tests_constants": {
        "is_nan": "is_nan(f)", "is_finite": "is_finite(f)",
        "is_infinite": "is_infinite(f)", "is_nan_j": "is_nan(j)",
        "pi": "pi()", "e": "e()", "nan": "is_nan(nan())",
        "infinity": "infinity()", "neg_infinity": "-infinity()",
        "pi_times": "pi() * u",
        "size_i": "data_size_for_stats(i)", "size_j": "data_size_for_stats(j)",
        "size_f": "data_size_for_stats(f)",
    },
    "buckets_clamp_pmod": {
        "wb": "width_bucket(u, -1.0, 1.0, 8)",
        "wb_desc": "width_bucket(u, 1.0, -1.0, 4)",
        "wb_edge": "width_bucket(f, 0.0, 5.0, 5)",
        "wb_j": "width_bucket(j, -10, 10, n)",
        "clamp_f": "clamp(f, -1.0, 1.0)", "clamp_j": "clamp(j, -3, 4)",
        "clamp_i": "clamp(i, -100, 100)",
        "pmod_i": "pmod(i, 7)", "pmod_neg": "pmod(j, -3)",
        "pmod_j": "pmod(j, z)", "pmod_f": "pmod(f, 1.5)",
        "pmod_fneg": "pmod(u, -0.25)",
        "gcd": "great_circle_distance(lat1, lon1, lat2, lon2)",
        "gcd_same": "great_circle_distance(lat1, lon1, lat1, lon1)",
    },
}


def _columns():
    rng = np.random.default_rng(20240612)
    f = np.round(rng.normal(0, 50, N), 3)
    f[:len(HALVES)] = HALVES
    i = rng.integers(-10 ** 6, 10 ** 6, N)
    i[:4] = [0, I64.max, I64.min, -1]
    lat = rng.uniform(-90, 90, (2, N))
    lon = rng.uniform(-180, 180, (2, N))
    lat[:, 0] = [90.0, -90.0]             # pole to pole
    lon[:, 1] = [-179.5, 179.5]           # across the antimeridian
    cols = {
        "f": f, "i": i,
        "j": rng.integers(-20, 21, N).astype(np.int32),
        "z": rng.integers(-2, 3, N).astype(np.int32),
        "k": rng.integers(0, 30, N),
        "d": rng.integers(-2, 4, N),
        "n": rng.integers(1, 9, N),
        "u": np.round(rng.uniform(-1.2, 1.2, N), 4),
        "g": np.abs(rng.normal(0, 30, N)),
        "m": rng.integers(-99999, 99999, N),
        "lat1": lat[0], "lon1": lon[0], "lat2": lat[1], "lon2": lon[1],
    }
    cols["u"][:4] = [1.0, -1.0, 0.0, -0.0]
    cols["g"][:3] = [0.0, np.inf, 1.0]
    nulls = {c: rng.random(N) < 0.12
             for c in ("j", "k", "u", "g", "d", "m")}
    nulls["f"] = np.zeros(N, bool)
    nulls["f"][len(HALVES):len(HALVES) + 10] = True
    return cols, nulls


@pytest.fixture(scope="module")
def jax_rows():
    batches = values_in_both(*_columns(), overrides={"m": (9, 2)})
    rows = {}

    def plan(builder, which, group):
        return builder().values(batches[which]).project(
            [f"{e} AS {n}" for n, e in PROJECTIONS[group].items()])

    def get(group):
        if group not in rows:
            rows[group] = jax_run_plan(
                plan(JaxPlanBuilder, 0, group).build()).to_pydict()
        return rows[group], torch_run_plan(plan(TorchPlanBuilder, 1, group))

    return get


@pytest.mark.parametrize("group", list(PROJECTIONS))
def test_math_matches_jax(jax_rows, group):
    exp, got = jax_rows(group)
    assert_same(got, exp, group)
    assert any(v is None for c in got.values() for v in c), group


def test_round_half_away_from_zero(jax_rows):
    """The exact halves themselves, away from zero, as Presto rounds
    (torch.round would give 0, -0, 2, -2)."""
    exp, got = jax_rows("round")
    want = [1.0, -1.0, 3.0, -3.0, 2.0, -2.0, 0.0, 0.0]
    assert got["round_f"][:8] == want
    assert exp["round_f"][:8] == want
    # 1.005 is 1.00499999999999989... in binary: 1.0, as in the JAX package
    assert got["round_f2"][11:13] == [1.0, -1.0]
    assert got["round_lit"][0] == 1.0
    assert math.isnan(got["round_f"][8])
    assert got["round_f"][9:11] == [math.inf, -math.inf]
