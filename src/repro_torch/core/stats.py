"""Two-sample Student's t-test (Matlab ``ttest2`` semantics) — paper Table 1/2.

The port's copy of ``repro.core.stats``.

Equal-variance pooled two-sample t statistic with right-/left-/two-tailed decisions
at significance ``alpha``.  The Student-t CDF is computed from the regularized
incomplete beta function (Numerical-Recipes continued fraction) so there is no scipy
dependency.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np


def _betacf(a: float, b: float, x: float, max_iter: int = 200, eps: float = 3e-12):
    """Continued fraction for the incomplete beta function (NR 6.4)."""
    qab, qap, qam = a + b, a + 1.0, a - 1.0
    c = 1.0
    d = 1.0 - qab * x / qap
    if abs(d) < 1e-300:
        d = 1e-300
    d = 1.0 / d
    h = d
    for m in range(1, max_iter + 1):
        m2 = 2 * m
        aa = m * (b - m) * x / ((qam + m2) * (a + m2))
        d = 1.0 + aa * d
        if abs(d) < 1e-300:
            d = 1e-300
        c = 1.0 + aa / c
        if abs(c) < 1e-300:
            c = 1e-300
        d = 1.0 / d
        h *= d * c
        aa = -(a + m) * (qab + m) * x / ((a + m2) * (qap + m2))
        d = 1.0 + aa * d
        if abs(d) < 1e-300:
            d = 1e-300
        c = 1.0 + aa / c
        if abs(c) < 1e-300:
            c = 1e-300
        d = 1.0 / d
        delta = d * c
        h *= delta
        if abs(delta - 1.0) < eps:
            return h
    return h  # pragma: no cover — converges in <60 iters for our df range


def betainc_reg(a: float, b: float, x: float) -> float:
    """Regularized incomplete beta I_x(a, b)."""
    if x <= 0.0:
        return 0.0
    if x >= 1.0:
        return 1.0
    ln_front = (
        math.lgamma(a + b)
        - math.lgamma(a)
        - math.lgamma(b)
        + a * math.log(x)
        + b * math.log1p(-x)
    )
    front = math.exp(ln_front)
    if x < (a + 1.0) / (a + b + 2.0):
        return front * _betacf(a, b, x) / a
    return 1.0 - front * _betacf(b, a, 1.0 - x) / b


def t_cdf(t: float, df: float) -> float:
    """CDF of Student's t with ``df`` degrees of freedom."""
    x = df / (df + t * t)
    p = 0.5 * betainc_reg(df / 2.0, 0.5, x)
    return 1.0 - p if t > 0 else p


@dataclass(frozen=True)
class TTestResult:
    t: float
    df: float
    p_two: float
    p_right: float  # H_a: mu1 > mu2
    p_left: float  # H_a: mu1 < mu2

    def reject(self, tail: str, alpha: float = 0.05) -> int:
        """Matlab ttest2 h-output: 1 = reject H0 at level alpha."""
        p = {"two": self.p_two, "right": self.p_right, "left": self.p_left}[tail]
        return int(p < alpha)


def ttest2(g1, g2) -> TTestResult:
    """Pooled-variance two-sample t-test (Matlab default 'Vartype'='equal')."""
    g1 = np.asarray(g1, dtype=np.float64)
    g2 = np.asarray(g2, dtype=np.float64)
    n1, n2 = len(g1), len(g2)
    if n1 < 2 or n2 < 2:
        raise ValueError("need at least 2 samples per group")
    m1, m2 = g1.mean(), g2.mean()
    v1, v2 = g1.var(ddof=1), g2.var(ddof=1)
    df = n1 + n2 - 2
    sp2 = ((n1 - 1) * v1 + (n2 - 1) * v2) / df
    denom = math.sqrt(sp2 * (1.0 / n1 + 1.0 / n2))
    if denom == 0.0:
        t = 0.0 if m1 == m2 else math.copysign(math.inf, m1 - m2)
    else:
        t = (m1 - m2) / denom
    cdf = t_cdf(t, df) if math.isfinite(t) else (1.0 if t > 0 else 0.0)
    return TTestResult(
        t=t,
        df=df,
        p_two=2.0 * min(cdf, 1.0 - cdf),
        p_right=1.0 - cdf,
        p_left=cdf,
    )


def outperforms(g1, g2, alpha: float = 0.05) -> tuple[int, int]:
    """Paper Table 2 convention: returns (right_h, left_h) for groups (G1, G2).

    G2 'outperforms' G1 iff right-tailed h == 0 and left-tailed h == 1
    (i.e. we cannot claim mu1 > mu2, and we can claim mu1 < mu2).
    """
    r = ttest2(g1, g2)
    return r.reject("right", alpha), r.reject("left", alpha)
