"""The probability functions and ``rand`` of the port's scalar surface,
on one small hand-made table with NULLs: every CDF, the Wilson
intervals and every ``inverse_*_cdf``, each against ``scipy`` and
against the JAX package, and the port's own ``betainc``.

Tolerances. The port computes in float64 on every device; the JAX
package narrows these functions to float32 (about 1e-7 relative per
operation, as its ``functions/scalar.py`` documents).
- Against scipy: ``rtol=1e-9, atol=1e-9``. The largest error measured
  on this table is torch's ``gammaincc`` near a = x = 20 (4e-10
  absolute, in ``poisson_cdf``); every other CDF is within 2e-13.
- Against the JAX package: CDF values to ``atol=1e-4``, about 840
  float32 epsilons (the largest deviation measured is 2.2e-5, in
  ``binomial_cdf``). A continuous quantile's error is the CDF's error
  over the density, so quantiles are compared in probability: scipy's
  CDF at the port's quantile and at the JAX package's agree to
  ``atol=1e-3``. The float32 t CDF is flat within sqrt(df * 1.2e-7) of
  0, and a bisection can stop anywhere there: up to 0.4 * sqrt(30 *
  1.2e-7) = 7.6e-4 in probability (3.9e-4 measured, at p = 0.5).
- Discrete quantiles equal scipy's exactly, and the JAX package's
  except in rows where a CDF value lies within 1e-6 of ``p``, where the
  float32 CDF cannot tell the two sides apart; such rows are counted and
  printed, and kept in the inputs.

``rand`` draws in [0, 1) (DOUBLE) or [0, n) (BIGINT, NULL where n is),
and two calls in one projection draw differently."""

import numpy as np
import pytest
import scipy.special
import scipy.stats as st

from torch_tpch_data import values_in_both
from velox_tpu.exec import run_plan as jax_run_plan
from velox_tpu.plan import PlanBuilder as JaxPlanBuilder
from velox_tpu_torch.exec import run_plan as torch_run_plan
from velox_tpu_torch.plan import PlanBuilder as TorchPlanBuilder

N = 200
EXACT = dict(rtol=1e-9, atol=1e-9)
FLOAT32_ATOL = 1e-4
FLOAT32_QUANTILE_ATOL = 1e-3

#: name -> (expression, scipy oracle over the columns)
CDFS = {
    "normal_cdf": ("normal_cdf(1.5, a, x)",
                   lambda c: st.norm.cdf(c["x"], 1.5, c["a"])),
    "cauchy_cdf": ("cauchy_cdf(0.5, a, x)",
                   lambda c: st.cauchy.cdf(c["x"], 0.5, c["a"])),
    "chi_squared_cdf": ("chi_squared_cdf(df, xp)",
                        lambda c: st.chi2.cdf(c["xp"], c["df"])),
    "gamma_cdf": ("gamma_cdf(a, b, xp)",
                  lambda c: st.gamma.cdf(c["xp"], c["a"], scale=c["b"])),
    "laplace_cdf": ("laplace_cdf(0.5, a, x)",
                    lambda c: st.laplace.cdf(c["x"], 0.5, c["a"])),
    # Q(floor(k) + 1, lam), which is poisson.cdf for k >= 0; below, both
    # packages follow Q (0 at k = -1, NaN under it), not scipy's 0
    "poisson_cdf": ("poisson_cdf(lam, k)",
                    lambda c: scipy.special.gammaincc(np.floor(c["k"]) + 1,
                                                      c["lam"])),
    "weibull_cdf": ("weibull_cdf(a, b, xp)",
                    lambda c: st.weibull_min.cdf(c["xp"], c["a"],
                                                 scale=c["b"])),
    "beta_cdf": ("beta_cdf(a, b, u)",
                 lambda c: st.beta.cdf(c["u"], c["a"], c["b"])),
    "f_cdf": ("f_cdf(a, b, xp)",
              lambda c: st.f.cdf(c["xp"], c["a"], c["b"])),
    "binomial_cdf": ("binomial_cdf(n, ps, k)",
                     lambda c: st.binom.cdf(c["k"], c["n"], c["ps"])),
    "t_cdf": ("t_cdf(df, x)", lambda c: st.t.cdf(c["x"], c["df"])),
}

#: name -> (expression, scipy quantile, scipy CDF of a quantile)
INVERSES = {
    "inverse_normal_cdf": (
        "inverse_normal_cdf(1.5, a, p)",
        lambda c: st.norm.ppf(c["p"], 1.5, c["a"]),
        lambda c, q: st.norm.cdf(q, 1.5, c["a"])),
    "inverse_cauchy_cdf": (
        "inverse_cauchy_cdf(0.5, a, p)",
        lambda c: st.cauchy.ppf(c["p"], 0.5, c["a"]),
        lambda c, q: st.cauchy.cdf(q, 0.5, c["a"])),
    "inverse_laplace_cdf": (
        "inverse_laplace_cdf(0.5, a, p)",
        lambda c: st.laplace.ppf(c["p"], 0.5, c["a"]),
        lambda c, q: st.laplace.cdf(q, 0.5, c["a"])),
    "inverse_weibull_cdf": (
        "inverse_weibull_cdf(a, b, p)",
        lambda c: st.weibull_min.ppf(c["p"], c["a"], scale=c["b"]),
        lambda c, q: st.weibull_min.cdf(q, c["a"], scale=c["b"])),
    "inverse_beta_cdf": (
        "inverse_beta_cdf(a, b, p)",
        lambda c: st.beta.ppf(c["p"], c["a"], c["b"]),
        lambda c, q: st.beta.cdf(q, c["a"], c["b"])),
    "inverse_chi_squared_cdf": (
        "inverse_chi_squared_cdf(df, p)",
        lambda c: st.chi2.ppf(c["p"], c["df"]),
        lambda c, q: st.chi2.cdf(q, c["df"])),
    "inverse_gamma_cdf": (
        "inverse_gamma_cdf(a, b, p)",
        lambda c: st.gamma.ppf(c["p"], c["a"], scale=c["b"]),
        lambda c, q: st.gamma.cdf(q, c["a"], scale=c["b"])),
    "inverse_f_cdf": (
        "inverse_f_cdf(a, b, p)",
        lambda c: st.f.ppf(c["p"], c["a"], c["b"]),
        lambda c, q: st.f.cdf(q, c["a"], c["b"])),
    "inverse_t_cdf": (
        "inverse_t_cdf(df, p)",
        lambda c: st.t.ppf(c["p"], c["df"]),
        lambda c, q: st.t.cdf(q, c["df"])),
}

#: name -> (expression, scipy quantile, scipy CDF at an integer)
DISCRETE = {
    "inverse_binomial_cdf": (
        "inverse_binomial_cdf(n, ps, pb)",
        lambda c: st.binom.ppf(c["pb"], c["n"], c["ps"]),
        lambda c, k: st.binom.cdf(k, c["n"], c["ps"])),
    "inverse_poisson_cdf": (
        "inverse_poisson_cdf(lam, pp)",
        lambda c: st.poisson.ppf(c["pp"], c["lam"]),
        lambda c, k: st.poisson.cdf(k, c["lam"])),
}

WILSON = {
    "wilson_interval_lower": "wilson_interval_lower(s, nn, z)",
    "wilson_interval_upper": "wilson_interval_upper(s, nn, z)",
}


def _columns():
    rng = np.random.default_rng(20240615)
    c = {"p": rng.uniform(0.001, 0.999, N), "x": rng.normal(0, 3, N),
         "a": rng.uniform(0.5, 20, N), "b": rng.uniform(0.5, 20, N),
         "df": rng.integers(1, 31, N).astype(float),
         "n": rng.integers(1, 100, N).astype(float),
         "ps": rng.uniform(0.01, 0.99, N),
         "k": rng.integers(-2, 60, N).astype(float),
         "lam": rng.uniform(0.1, 50, N), "u": rng.uniform(0, 1, N),
         "xp": np.abs(rng.normal(0, 5, N)),
         "pb": rng.uniform(0.001, 0.999, N),
         "pp": rng.uniform(0.001, 0.999, N),
         "s": rng.integers(0, 50, N).astype(float),
         "z": rng.uniform(0.5, 3, N),
         "m": rng.integers(-3, 40, N)}
    c["nn"] = c["s"] + rng.integers(1, 50, N)
    c["p"][:6] = [1e-6, 0.5, 1 - 1e-6, 0.025, 0.975, 0.1]
    c["x"][:3] = [0.0, -40.0, 40.0]
    c["u"][:3] = [0.0, 1.0, 0.5]
    c["xp"][:2] = [0.0, 1e3]
    # probabilities 3e-8 beside a CDF value: float64 tells the two sides
    # of the step apart, float32 may not
    off = np.asarray([-3e-8, 3e-8] * 3)
    kk = np.floor(c["n"][6:12] * c["ps"][6:12])
    c["pb"][6:12] = st.binom.cdf(kk, c["n"][6:12], c["ps"][6:12]) + off
    c["pp"][6:12] = st.poisson.cdf(np.floor(c["lam"][6:12]),
                                   c["lam"][6:12]) + off
    nulls = {name: rng.random(N) < 0.08
             for name in ("a", "p", "pb", "lam", "m")}
    for name in ("a", "p", "pb"):
        nulls[name][:12] = False
    return c, nulls


@pytest.fixture(scope="module")
def rows():
    cols, nulls = _columns()
    batches = values_in_both(cols, nulls)
    exprs = {n: e for n, (e, *_) in {**CDFS, **INVERSES, **DISCRETE}.items()}
    exprs.update(WILSON)
    proj = [f"{e} AS {n}" for n, e in exprs.items()]
    exp = jax_run_plan(JaxPlanBuilder().values(batches[0]).project(proj)
                       .build()).to_pydict()
    got = torch_run_plan(TorchPlanBuilder().values(batches[1]).project(proj))
    return cols, nulls, got, exp, batches


def _valid(got, name):
    """(mask of non-NULL rows, their values as float64)."""
    vals = got[name]
    mask = np.asarray([v is not None for v in vals])
    return mask, np.asarray([v for v in vals if v is not None], np.float64)


def _null_rows(nulls, *names):
    out = np.zeros(N, bool)
    for n in names:
        out |= nulls.get(n, np.zeros(N, bool))
    return out


def test_cdfs_against_scipy(rows):
    cols, nulls, got, _, _ = rows
    for name, (expr, oracle) in CDFS.items():
        mask, vals = _valid(got, name)
        args = expr[expr.index("(") + 1:-1].replace(" ", "").split(",")
        np.testing.assert_array_equal(~mask, _null_rows(nulls, *args), name)
        np.testing.assert_allclose(vals, oracle(cols)[mask], **EXACT,
                                   err_msg=name)


def test_cdfs_against_jax(rows):
    _, _, got, exp, _ = rows
    for name in list(CDFS) + list(WILSON):
        assert [v is None for v in got[name]] == \
            [v is None for v in exp[name]], name
        np.testing.assert_allclose(
            _valid(got, name)[1], _valid(exp, name)[1], rtol=0,
            atol=FLOAT32_ATOL, err_msg=name)


def test_continuous_inverses_against_scipy(rows):
    cols, _, got, _, _ = rows
    for name, (_, ppf, _) in INVERSES.items():
        mask, vals = _valid(got, name)
        np.testing.assert_allclose(vals, ppf(cols)[mask], **EXACT,
                                   err_msg=name)


def test_continuous_inverses_against_jax(rows):
    """Where the port's and the JAX package's quantiles fall, in
    probability."""
    cols, _, got, exp, _ = rows
    for name, (_, _, cdf) in INVERSES.items():
        mask, vals = _valid(got, name)
        jmask, jvals = _valid(exp, name)
        assert (mask == jmask).all(), name
        sub = {c: v[mask] for c, v in cols.items()}
        np.testing.assert_allclose(cdf(sub, vals), cdf(sub, jvals), rtol=0,
                                   atol=FLOAT32_QUANTILE_ATOL, err_msg=name)


def test_discrete_inverses(rows):
    cols, _, got, exp, _ = rows
    for name, (expr, ppf, cdf) in DISCRETE.items():
        mask, vals = _valid(got, name)
        assert vals.dtype == np.float64 and \
            all(type(v) is int for v in got[name] if v is not None), name
        np.testing.assert_array_equal(vals, ppf(cols)[mask], name)
        jmask, jvals = _valid(exp, name)
        assert (mask == jmask).all(), name
        p = cols["pb" if "binomial" in name else "pp"][mask]
        sub = {c: v[mask] for c, v in cols.items()}
        near = ((np.abs(cdf(sub, vals) - p) < 1e-6)
                | (np.abs(cdf(sub, vals - 1) - p) < 1e-6))
        differ = vals != jvals
        print(f"{name}: {int(near.sum())} rows with a CDF value within 1e-6 "
              f"of p, {int(differ.sum())} differ from the JAX package")
        assert near.sum() >= 6, name
        assert not (differ & ~near).any(), name


def test_wilson_intervals(rows):
    cols, _, got, _, _ = rows
    s, n, z = cols["s"], cols["nn"], cols["z"]
    p = s / n
    center = p + z * z / (2 * n)
    spread = z * np.sqrt(p * (1 - p) / n + z * z / (4 * n * n))
    denom = 1 + z * z / n
    np.testing.assert_allclose(got["wilson_interval_lower"],
                               (center - spread) / denom, rtol=1e-12)
    np.testing.assert_allclose(got["wilson_interval_upper"],
                               (center + spread) / denom, rtol=1e-12)


def test_betainc_against_scipy():
    """The port's regularized incomplete beta over shapes from 1e-2 to
    1e4 and the whole unit interval, edges included."""
    import torch

    from velox_tpu_torch.functions.special import betainc

    rng = np.random.default_rng(3)
    a = np.exp(rng.uniform(np.log(1e-2), np.log(1e4), 4000))
    b = np.exp(rng.uniform(np.log(1e-2), np.log(1e4), 4000))
    x = rng.uniform(0, 1, 4000)
    x[:4] = [0.0, 1.0, 1e-300, 1 - 1e-16]
    got = betainc(torch.from_numpy(a), torch.from_numpy(b),
                  torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, scipy.special.betainc(a, b, x),
                               rtol=1e-9, atol=1e-12)
    bad = betainc(torch.tensor([0.0, 1.0, np.nan]), torch.tensor(1.0),
                  torch.tensor([0.5, np.nan, 0.5]))
    assert torch.isnan(bad).all()


def test_rand(rows):
    _, nulls, _, _, batches = rows
    got = torch_run_plan(TorchPlanBuilder().values(batches[1]).project([
        "rand() AS r1", "rand() AS r2", "random() AS r3",
        "secure_rand() AS r4", "rand(m) AS rm", "random(7) AS r7",
        "secure_random(m) AS rs", "rand(0) AS r0"]))
    for c in ("r1", "r2", "r3", "r4"):
        v = np.asarray(got[c])
        assert v.dtype == np.float64 and ((v >= 0) & (v < 1)).all(), c
        assert len(np.unique(v)) > N // 2, c
    assert got["r1"] != got["r2"]          # two calls, two draws
    m = _columns()[0]["m"]
    for c in ("rm", "rs"):
        assert [v is None for v in got[c]] == list(nulls["m"]), c
        assert all(type(v) is int and 0 <= v < max(b, 1)
                   for v, b in zip(got[c], m) if v is not None), c
    assert set(got["r7"]) <= set(range(7)) and len(set(got["r7"])) > 3
    assert got["r0"] == [0] * N
    plan = TorchPlanBuilder().values(batches[1]).project(
        ["rand() AS a", "rand(m) AS b", "random(7) AS c"]).build()
    assert [str(t) for t in plan.output_type.children] == \
        ["DOUBLE", "BIGINT", "BIGINT"]
