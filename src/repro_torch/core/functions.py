"""Registry of target functions f(x) with analytic first/second derivatives.

The paper's spacing rule (Eq. 11) needs ``max |f''|`` over a sub-interval, so every
registered function carries a closed-form second derivative.  Callables are written
against the ``numpy`` namespace by default (the design flow is offline) but accept any
array namespace via the ``xp`` argument so the same formulas run under ``torch``
for the runtime oracles.

This is the port's own copy of ``repro.core.functions``: the port imports nothing
of the JAX package, so it carries the registry itself (tests/test_torch_core.py
holds the two copies to the same tables).

The six benchmark functions of the paper (Tables 2/3) are registered with the paper's
intervals; additional ML nonlinearities (gelu, silu, softplus, erf) extend the registry
for the framework integration.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import numpy as np

Array = np.ndarray
FnOfX = Callable[..., Array]

_SQRT_2PI = math.sqrt(2.0 * math.pi)
_SQRT_2 = math.sqrt(2.0)
_INV_SQRT_PI = 1.0 / math.sqrt(math.pi)


def _phi(x, xp):
    """Standard normal pdf."""
    return xp.exp(-0.5 * x * x) / _SQRT_2PI


def _sigmoid(x, xp):
    # Numerically-stable logistic.
    return xp.where(x >= 0, 1.0 / (1.0 + xp.exp(-x)), xp.exp(x) / (1.0 + xp.exp(x)))


def _erf(x, xp):
    if xp is np:
        return np.vectorize(math.erf)(np.asarray(x, dtype=np.float64))
    return xp.erf(x)  # torch.erf


@dataclass(frozen=True)
class FunctionSpec:
    """A target function with analytic derivatives and a default approximation interval."""

    name: str
    f: FnOfX
    d2f: FnOfX  # second derivative (signed)
    interval: Tuple[float, float]  # paper/default interval [x0, x0 + a)
    d1f: FnOfX | None = None  # first derivative (for exact-grad mode)
    # |f''| monotonicity over typical intervals: one of {"none", "increasing",
    # "decreasing"}; "none" forces a grid max. Pure metadata fast-path hint.
    abs_d2_monotone: str = "none"
    notes: str = ""

    def max_abs_d2(self, lo: float, hi: float, grid: int = 4097) -> float:
        """max over [lo, hi] of |f''| — monotone fast path, else dense grid + endpoints."""
        if hi <= lo:
            raise ValueError(f"empty interval [{lo}, {hi})")
        d2 = self.d2f
        if self.abs_d2_monotone == "increasing":
            return float(abs(d2(np.asarray(hi))))
        if self.abs_d2_monotone == "decreasing":
            return float(abs(d2(np.asarray(lo))))
        xs = np.linspace(lo, hi, grid)
        return float(np.max(np.abs(d2(xs))))


_REGISTRY: Dict[str, FunctionSpec] = {}


def register(spec: FunctionSpec) -> FunctionSpec:
    if spec.name in _REGISTRY:
        raise ValueError(f"duplicate function spec {spec.name!r}")
    _REGISTRY[spec.name] = spec
    return spec


def get(name: str) -> FunctionSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown function {name!r}; known: {sorted(_REGISTRY)}") from None


def names() -> list[str]:
    return sorted(_REGISTRY)


# --------------------------------------------------------------------------------------
# The paper's six benchmark functions (Table 2 intervals).
# --------------------------------------------------------------------------------------

register(
    FunctionSpec(
        name="log",
        f=lambda x, xp=np: xp.log(x),
        d1f=lambda x, xp=np: 1.0 / x,
        d2f=lambda x, xp=np: -1.0 / (x * x),
        interval=(0.625, 15.625),
        abs_d2_monotone="decreasing",  # |f''| = 1/x^2 decreasing for x>0
        notes="paper Fig.3-5 exemplar",
    )
)

register(
    FunctionSpec(
        name="exp",
        f=lambda x, xp=np: xp.exp(x),
        d1f=lambda x, xp=np: xp.exp(x),
        d2f=lambda x, xp=np: xp.exp(x),
        interval=(0.0, 5.0),
        abs_d2_monotone="increasing",
        notes="paper Table 2",
    )
)

register(
    FunctionSpec(
        name="tan",
        f=lambda x, xp=np: xp.tan(x),
        d1f=lambda x, xp=np: 1.0 + xp.tan(x) ** 2,
        # f'' = 2 tan(x) sec^2(x) = 2 t (1 + t^2)
        d2f=lambda x, xp=np: 2.0 * xp.tan(x) * (1.0 + xp.tan(x) ** 2),
        interval=(-1.5, 0.0),
        abs_d2_monotone="none",  # |f''| decreasing on [-1.5,0) but Table 3 uses [-1.5,1.5)
        notes="paper Table 2 uses [-1.5,0), Table 3 [-1.5,1.5)",
    )
)

register(
    FunctionSpec(
        name="tanh",
        f=lambda x, xp=np: xp.tanh(x),
        d1f=lambda x, xp=np: 1.0 - xp.tanh(x) ** 2,
        # f'' = -2 t (1 - t^2)
        d2f=lambda x, xp=np: -2.0 * xp.tanh(x) * (1.0 - xp.tanh(x) ** 2),
        interval=(-8.0, 0.0),
        notes="paper Table 2 uses [-8,0), Table 3 [-8,8)",
    )
)

register(
    FunctionSpec(
        name="sigmoid",
        f=lambda x, xp=np: _sigmoid(x, xp),
        d1f=lambda x, xp=np: _sigmoid(x, xp) * (1.0 - _sigmoid(x, xp)),
        # f'' = s(1-s)(1-2s)
        d2f=lambda x, xp=np: (
            _sigmoid(x, xp) * (1.0 - _sigmoid(x, xp)) * (1.0 - 2.0 * _sigmoid(x, xp))
        ),
        interval=(-10.0, 0.0),
        notes="paper writes 1/(1+e^-x) in Table 2 ([-10,0)) and 1/(1+e^x) in Table 3",
    )
)

register(
    FunctionSpec(
        name="gauss",
        f=lambda x, xp=np: xp.exp(-0.5 * x * x),
        d1f=lambda x, xp=np: -x * xp.exp(-0.5 * x * x),
        # f'' = (x^2 - 1) e^{-x^2/2}
        d2f=lambda x, xp=np: (x * x - 1.0) * xp.exp(-0.5 * x * x),
        interval=(-6.0, 0.0),
        notes="paper Table 2 uses [-6,0), Table 3 [-6,6)",
    )
)

# --------------------------------------------------------------------------------------
# Framework nonlinearities (beyond the paper's benchmark set).
# --------------------------------------------------------------------------------------

register(
    FunctionSpec(
        name="gelu",
        # exact (erf) GELU: x * Phi(x)
        f=lambda x, xp=np: x * 0.5 * (1.0 + _erf(x / _SQRT_2, xp)),
        d1f=lambda x, xp=np: 0.5 * (1.0 + _erf(x / _SQRT_2, xp)) + x * _phi(x, xp),
        # f'' = phi(x) (2 - x^2)
        d2f=lambda x, xp=np: _phi(x, xp) * (2.0 - x * x),
        interval=(-8.0, 8.0),
    )
)

register(
    FunctionSpec(
        name="silu",
        f=lambda x, xp=np: x * _sigmoid(x, xp),
        d1f=lambda x, xp=np: _sigmoid(x, xp)
        + x * _sigmoid(x, xp) * (1.0 - _sigmoid(x, xp)),
        # f'' = 2 s(1-s) + x s(1-s)(1-2s)
        d2f=lambda x, xp=np: (
            2.0 * _sigmoid(x, xp) * (1.0 - _sigmoid(x, xp))
            + x
            * _sigmoid(x, xp)
            * (1.0 - _sigmoid(x, xp))
            * (1.0 - 2.0 * _sigmoid(x, xp))
        ),
        interval=(-10.0, 10.0),
    )
)

register(
    FunctionSpec(
        name="softplus",
        f=lambda x, xp=np: xp.where(
            x > 20.0, x, xp.log1p(xp.exp(xp.minimum(x, 20.0)))
        ),
        d1f=lambda x, xp=np: _sigmoid(x, xp),
        d2f=lambda x, xp=np: _sigmoid(x, xp) * (1.0 - _sigmoid(x, xp)),
        interval=(-10.0, 10.0),
    )
)

register(
    FunctionSpec(
        name="erf",
        f=lambda x, xp=np: _erf(x, xp),
        d1f=lambda x, xp=np: 2.0 * _INV_SQRT_PI * xp.exp(-x * x),
        d2f=lambda x, xp=np: -4.0 * x * _INV_SQRT_PI * xp.exp(-x * x),
        interval=(-4.0, 4.0),
    )
)

# exp over a negative shifted domain: the softmax backend (exp(x - max) with x-max <= 0).
register(
    FunctionSpec(
        name="exp_neg",
        f=lambda x, xp=np: xp.exp(x),
        d1f=lambda x, xp=np: xp.exp(x),
        d2f=lambda x, xp=np: xp.exp(x),
        interval=(-16.0, 0.0),
        abs_d2_monotone="increasing",
        notes="softmax exponent domain after max-subtraction; clamp at -16 (exp=1.1e-7)",
    )
)


# Sigmoid over the symmetric interval used by gate activations in the model zoo.
register(
    FunctionSpec(
        name="sigmoid_sym",
        f=lambda x, xp=np: _sigmoid(x, xp),
        d1f=lambda x, xp=np: _sigmoid(x, xp) * (1.0 - _sigmoid(x, xp)),
        d2f=lambda x, xp=np: (
            _sigmoid(x, xp) * (1.0 - _sigmoid(x, xp)) * (1.0 - 2.0 * _sigmoid(x, xp))
        ),
        interval=(-12.0, 12.0),
        notes="gate sigmoid; clamp error at +/-12 is 6.1e-6",
    )
)


# --------------------------------------------------------------------------------------
# RangeFold members: full-period trig plus the canonical-interval cores the
# reduction stage (core.range_reduce) folds onto.  sin/cos also work as plain
# bounded-table members on one period; the *_core entries are what the folded
# modes actually look up after reduction.
# --------------------------------------------------------------------------------------

register(
    FunctionSpec(
        name="sin",
        f=lambda x, xp=np: xp.sin(x),
        d1f=lambda x, xp=np: xp.cos(x),
        d2f=lambda x, xp=np: -xp.sin(x),
        interval=(-3.14159265, 3.14159265),
        notes="one period as the bounded-table default; full f32 range via RangeFold",
    )
)

register(
    FunctionSpec(
        name="cos",
        f=lambda x, xp=np: xp.cos(x),
        d1f=lambda x, xp=np: -xp.sin(x),
        d2f=lambda x, xp=np: -xp.cos(x),
        interval=(-3.14159265, 3.14159265),
        notes="one period as the bounded-table default; full f32 range via RangeFold",
    )
)

register(
    FunctionSpec(
        name="sin_core",
        f=lambda x, xp=np: xp.sin(x),
        d1f=lambda x, xp=np: xp.cos(x),
        d2f=lambda x, xp=np: -xp.sin(x),
        interval=(-0.79, 0.79),
        notes="trig fold target: [-pi/4, pi/4] plus k-rounding guard band",
    )
)

register(
    FunctionSpec(
        name="cos_core",
        f=lambda x, xp=np: xp.cos(x),
        d1f=lambda x, xp=np: -xp.sin(x),
        d2f=lambda x, xp=np: -xp.cos(x),
        interval=(-0.79, 0.79),
        notes="trig fold target: [-pi/4, pi/4] plus k-rounding guard band",
    )
)

register(
    FunctionSpec(
        name="exp_core",
        f=lambda x, xp=np: xp.exp(x),
        d1f=lambda x, xp=np: xp.exp(x),
        d2f=lambda x, xp=np: xp.exp(x),
        interval=(-0.36, 0.36),
        abs_d2_monotone="increasing",
        notes="exp fold target: [-ln2/2, ln2/2] plus guard band; exp(x)=2^k*exp_core(r)",
    )
)

register(
    FunctionSpec(
        name="log_core",
        f=lambda x, xp=np: xp.log(x),
        d1f=lambda x, xp=np: 1.0 / x,
        d2f=lambda x, xp=np: -1.0 / (x * x),
        interval=(0.70, 1.42),
        abs_d2_monotone="decreasing",
        notes="log fold target: [sqrt2/2, sqrt2); log(x)=e*ln2+log_core(m)",
    )
)
