"""Probability functions (Presto semantics), over torch in float64.

The JAX package's CDFs, Wilson intervals and ``inverse_*_cdf`` family
(velox/functions/prestosql/Probability*.h). The reference narrows them
to float32, because float64 transcendentals were emulated on its chip;
the H100 runs float64 natively, so these run in float64 throughout.
Inverses without a closed form use the reference's fixed-count search:
48 doublings bracket the quantile and 64 bisections pin it, and the
discrete inverses (binomial, Poisson) bisect the integer lattice for the
smallest k with cdf(k) >= p. ``betainc`` is the port's own
(``functions/special.py``); the rest are ``torch.special``.
"""

from __future__ import annotations

import math

import torch

from velox_tpu_torch.types import BIGINT, DOUBLE
from velox_tpu_torch.functions.registry import ScalarFunction, register_function
from velox_tpu_torch.functions.special import betainc
from velox_tpu_torch.utils import syncs

_special = torch.special


def _register(name, fn, result=DOUBLE):
    """``fn`` sees its arguments as float64 tensors."""
    register_function(ScalarFunction(
        name, lambda a: result,
        lambda *args: fn(*[a.to(torch.float64) for a in args])))


# ------------------------------------------------------------------ CDFs

def _cauchy_cdf(m, s, x):
    # tail-stable: 0.5 + atan((x - m) / s) / pi cancels for x << m
    d = x - m
    lo = torch.atan2(s, -d) / math.pi
    hi = 1.0 - torch.atan2(s, d) / math.pi
    return torch.where(d < 0, lo, hi)


def _laplace_cdf(m, s, x):
    return torch.where(x < m, 0.5 * torch.exp((x - m) / s),
                       1.0 - 0.5 * torch.exp(-(x - m) / s))


def _weibull_cdf(a, b, x):
    return -torch.expm1(-torch.pow(torch.clamp(x, min=0.0) / b, a))


def _f_cdf(d1, d2, x):
    return betainc(d1 * 0.5, d2 * 0.5, d1 * x / (d1 * x + d2))


def _binomial_cdf(n, p, k):
    fk = torch.floor(k)
    body = betainc(torch.clamp(n - fk, min=1.0), fk + 1.0, 1.0 - p)
    return torch.where(k >= n, torch.ones_like(body),
                       torch.where(k < 0, torch.zeros_like(body), body))


def _poisson_cdf(lam, k):
    return _special.gammaincc(torch.floor(k) + 1.0, lam)


def _t_below(df, x):
    """The t CDF at -|x|: the reference's I_{df/(df+x^2)}(df/2, 1/2) / 2,
    and near x = 0, where df / (df + x^2) rounds to 1 and that form goes
    flat, 1/2 - I_{x^2/(df+x^2)}(1/2, df/2) / 2."""
    x2 = x * x
    near = x2 < df
    half = torch.full_like(df, 0.5)
    ib = 0.5 * betainc(torch.where(near, half, df * 0.5),
                       torch.where(near, df * 0.5, half),
                       torch.where(near, x2, df) / (df + x2))
    return torch.where(near, 0.5 - ib, ib)


def _t_cdf(df, x):
    below = _t_below(df, x)
    return torch.where(x > 0, 1.0 - below, below)


def _wilson(lower: bool):
    def impl(s, n, z):
        p = s / n
        z2 = z * z
        center = p + z2 / (2.0 * n)
        spread = z * torch.sqrt(p * (1.0 - p) / n + z2 / (4.0 * n * n))
        return (center - spread if lower else center + spread) \
            / (1.0 + z2 / n)
    return impl


_register("normal_cdf", lambda m, sd, x: _special.ndtr((x - m) / sd))
_register("beta_cdf", betainc)
_register("cauchy_cdf", _cauchy_cdf)
_register("chi_squared_cdf",
          lambda k, x: _special.gammainc(k * 0.5, x * 0.5))
_register("gamma_cdf",
          lambda shape, scale, x: _special.gammainc(shape, x / scale))
_register("laplace_cdf", _laplace_cdf)
_register("poisson_cdf", _poisson_cdf)
_register("weibull_cdf", _weibull_cdf)
_register("f_cdf", _f_cdf)
_register("binomial_cdf", _binomial_cdf)
_register("t_cdf", _t_cdf)
_register("wilson_interval_lower", _wilson(True))
_register("wilson_interval_upper", _wilson(False))


# -------------------------------------------------------------- inverses

def _bisect(cdf, p, lo, hi, iters: int = 64):
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        below = cdf(mid) < p
        lo, hi = torch.where(below, mid, lo), torch.where(below, hi, mid)
    return 0.5 * (lo + hi)


def _grow_hi(cdf, p, hi, iters: int = 48):
    """Double ``hi`` until cdf(hi) >= p, at most ``iters`` times. A lane
    that stops never grows again, so the loop ends (one host sync a
    step) once no lane grows: the same bound as all ``iters`` steps."""
    for _ in range(iters):
        grow = cdf(hi) < p
        if not syncs.any_true(grow):
            break
        hi = torch.where(grow, hi * 2.0, hi)
    return hi


def _inverse_on_half_line(cdf, p):
    """Quantile of a distribution on [0, inf)."""
    zero = torch.zeros_like(p)
    return _bisect(cdf, p, zero, _grow_hi(cdf, p, torch.ones_like(p)))


def _inv_beta(a, b, p):
    return _bisect(lambda x: betainc(a, b, x), p, torch.zeros_like(p),
                   torch.ones_like(p))


def _inv_chi2(df, p):
    return _inverse_on_half_line(
        lambda x: _special.gammainc(df * 0.5, x * 0.5), p)


def _inv_gamma(shape, scale, p):
    return _inverse_on_half_line(
        lambda x: _special.gammainc(shape, x / scale), p)


def _inv_f(d1, d2, p):
    return _inverse_on_half_line(lambda x: _f_cdf(d1, d2, x), p)


def _inv_t(df, p):
    hi = torch.ones_like(p)
    for _ in range(48):
        below = _t_below(df, hi)     # the CDF at -hi; 1 - below at hi
        wider = (1.0 - below < p) | (below > p)
        if not syncs.any_true(wider):
            break
        hi = torch.where(wider, hi * 2.0, hi)
    return _bisect(lambda x: _t_cdf(df, x), p, -hi, hi)


def _int_bisect(cdf, p, hi):
    """Smallest integer k in [0, hi] with cdf(k) >= p."""
    lo = torch.full_like(hi, -1.0)
    for _ in range(48):
        # once every lane has hi = lo + 1 the steps change nothing
        if not syncs.any_true(hi - lo > 1.0):
            break
        mid = torch.floor(0.5 * (lo + hi))
        # keep cdf(lo) < p <= cdf(hi); a mid at lo would stall
        mid = torch.minimum(torch.where(mid <= lo, lo + 1.0, mid), hi)
        below = cdf(mid) < p
        lo, hi = torch.where(below, mid, lo), torch.where(below, hi, mid)
    return hi


def _inv_binomial(n, ps, p):
    return _int_bisect(lambda k: _binomial_cdf(n, ps, k), p, n)


def _inv_poisson(lam, p):
    def cdf(k):
        return torch.where(k < 0, torch.zeros_like(k), _poisson_cdf(lam, k))

    hi = _grow_hi(cdf, p, torch.clamp(lam, min=1.0), iters=40)
    return _int_bisect(cdf, p, hi)


_register("inverse_normal_cdf",
          lambda m, sd, p: m + sd * _special.ndtri(p))
_register("inverse_cauchy_cdf",
          lambda m, s, p: m + s * torch.tan(math.pi * (p - 0.5)))
_register("inverse_laplace_cdf",
          lambda m, s, p: m - s * torch.sign(p - 0.5)
          * torch.log1p(-2.0 * torch.abs(p - 0.5)))
_register("inverse_weibull_cdf",
          lambda a, b, p: b * torch.pow(-torch.log1p(-p), 1.0 / a))
_register("inverse_beta_cdf", _inv_beta)
_register("inverse_chi_squared_cdf", _inv_chi2)
_register("inverse_gamma_cdf", _inv_gamma)
_register("inverse_f_cdf", _inv_f)
_register("inverse_t_cdf", _inv_t)
_register("inverse_binomial_cdf",
          lambda n, ps, p: _inv_binomial(n, ps, p).to(torch.int64), BIGINT)
_register("inverse_poisson_cdf",
          lambda lam, p: _inv_poisson(lam, p).to(torch.int64), BIGINT)
