"""Special functions torch lacks, in float64.

``betainc``, the regularized incomplete beta function I_x(a, b), which
the beta, F, binomial and Student t distributions reduce to. torch has
``ndtr``, ``ndtri``, ``gammainc`` and ``gammaincc``, not this one.

The continued fraction of I_x(a, b) (Numerical Recipes' ``betacf``,
evaluated by the modified Lentz method) converges quickly where
x < (a + 1) / (a + b + 2); elsewhere I_x(a, b) = 1 - I_{1-x}(b, a)
moves the argument there. Every lane runs the same terms: the loop ends
when the largest step of any lane is below float64's precision, checked
every ``_CHECK_EVERY`` terms (one host sync each), or after ``_MAX_TERMS``.
"""

from __future__ import annotations

import torch

from velox_tpu_torch.utils import syncs

_TINY = 1e-300
_EPS = 2.0 ** -53
_CHECK_EVERY = 16
_MAX_TERMS = 4096


def _not_tiny(v):
    return torch.where(torch.abs(v) < _TINY, _TINY, v)


def _betacf(a, b, x):
    """The continued fraction of I_x(a, b), times ``a B(a, b)`` over
    ``x^a (1 - x)^b``. Each step is eager torch over whole lanes, so the
    ops are few and fused where torch offers it (``addcmul``,
    ``addcdiv``)."""
    one = torch.ones_like(x)
    qab = a + b
    c = one
    d = torch.reciprocal(_not_tiny(1.0 - qab * x / (a + 1.0)))
    h = d
    a2m = a.clone()                      # a + 2m, kept step to step
    for m in range(1, _MAX_TERMS + 1):
        a2m_1 = a2m + 1.0                # a + 2m - 1 of this step
        a2m = a2m + 2.0
        num = (b - m) * x * m / (a2m_1 * a2m)
        d = torch.reciprocal(_not_tiny(torch.addcmul(one, num, d)))
        c = _not_tiny(torch.addcdiv(one, num, c))
        h = h * d * c
        num = (a + m) * (qab + m) * x / (a2m * (a2m + 1.0))
        d = torch.reciprocal(_not_tiny(torch.addcmul(one, num, d,
                                                     value=-1.0)))
        c = _not_tiny(torch.addcdiv(one, num, c, value=-1.0))
        step = d * c
        h = h * step
        if m % _CHECK_EVERY == 0 and not syncs.any_true(
                torch.abs(step - 1.0) > 4 * _EPS):
            break
    return h


def betainc(a, b, x):
    """I_x(a, b) elementwise over broadcast float64 tensors: 0 at x <= 0,
    1 at x >= 1, NaN where a or b is not positive or an input is NaN."""
    a, b, x = torch.broadcast_tensors(
        a.to(torch.float64), b.to(torch.float64), x.to(torch.float64))
    bad = (a <= 0) | (b <= 0) | torch.isnan(a) | torch.isnan(b) \
        | torch.isnan(x)
    # bad lanes run the fraction at (1, 1, 1/2), which converges at once
    one = torch.ones_like(a)
    a, b = torch.where(bad, one, a), torch.where(bad, one, b)
    x = torch.where(bad, 0.5 * one, x)
    swap = x > (a + 1.0) / (a + b + 2.0)
    aa = torch.where(swap, b, a)
    bb = torch.where(swap, a, b)
    inner = torch.clamp(x, 0.0, 1.0)
    xx = torch.where(swap, 1.0 - inner, inner)
    # log x and log(1 - x) of the swapped argument, each from the
    # original x so that neither loses digits to 1 - x
    log_x = torch.where(swap, torch.log1p(-inner), torch.log(inner))
    log_1mx = torch.where(swap, torch.log(inner), torch.log1p(-inner))
    lbeta = torch.lgamma(aa) + torch.lgamma(bb) - torch.lgamma(aa + bb)
    front = torch.exp(aa * log_x + bb * log_1mx - lbeta) / aa
    r = front * _betacf(aa, bb, xx)
    r = torch.where(swap, 1.0 - r, r)
    r = torch.where(x <= 0.0, torch.zeros_like(r),
                    torch.where(x >= 1.0, torch.ones_like(r), r))
    return torch.where(bad, torch.full_like(r, float("nan")), r)
