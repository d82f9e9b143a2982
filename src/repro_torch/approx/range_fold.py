"""RangeFold: serve unbounded-domain transcendentals from the bounded f32 pack
(the port of the JAX package's ``approx/range_fold.py``).

The fold math lives in :mod:`repro_torch.core.range_reduce`; this module is
the approx layer around it — the plain versions, the differentiable closures
and the dispatch that turn a reduction plus a canonical-interval pack member
into a full-f32-range ``sin`` / ``cos`` / ``exp`` / ``log``:

    sin(x) = +-{sin_core, cos_core}(r),     x = k*(pi/2) + r   (quadrant select)
    exp(x) = 2^k * exp_core(r),             r in [-ln2/2, ln2/2]
    log(x) = e*ln2 + log_core(m),           x = m * 2^e, m in [sqrt2/2, sqrt2)

Two serving shapes, as in the reference:

* **static** (``folded_pack`` / ``folded_pack_ref``): the fold, one or two
  core lookups and the reconstruction run in ONE CUDA kernel
  (:func:`repro_torch.kernels.table_pack_lookup.folded_pack_lookup`); the
  plain version :func:`eval_folded_ref` applies the identical op sequence in
  PyTorch, bit for bit.
* **routed** (``folded_routed_pack`` / ``folded_routed_pack_ref``): the fold
  and the reconstruction run as PyTorch prologue and epilogue around the
  routed kernel, which does the core lookups with a runtime fn_id on one row.

Non-foldable members fall through to the plain pack paths unchanged, so the
``folded_*`` modes are a superset of ``table_pack`` / ``routed_pack``.

Error contracts (held full-range by ``tests/harness/fullrange.py``): folded
sin/cos/log keep the pack's ABSOLUTE Ea bound over the whole finite f32
range; folded exp is RELATIVE — ``|err| <= Ea * max(1, |exp(x)|)`` — because
the ``2^k`` reconstruction scales the core table's absolute error.
"""

from __future__ import annotations

import torch

from repro_torch.core.range_reduce import (exp_edges, exp_fold, exp_reconstruct,
                                           log_edges, log_fold, log_reconstruct,
                                           trig_edges, trig_fold, trig_reconstruct,
                                           trig_slope_reconstruct, u32_bits)

from .table_pack import (FOLDABLE, eval_pack_ref, eval_pack_slope,
                         eval_routed_ref, make_pack_fn, make_routed_unary_fn)
from .torch_table import slope_rule

FOLDED_MODES = ("folded_pack", "folded_pack_ref",
                "folded_routed_pack", "folded_routed_pack_ref")

# The canonical-interval members the folds look up; ApproxConfig.pack()
# appends them to pack_functions whenever a folded mode (or rope_table) needs
# them.
FOLDED_CORE_MEMBERS = ("sin_core", "cos_core", "exp_core", "log_core")


def _check_cores(pack, name: str) -> None:
    missing = [c for c in FOLDABLE[name] if c not in pack.names]
    if missing:
        raise KeyError(
            f"folded {name!r} needs core members {missing} in the pack; "
            f"pack has {pack.names} (ApproxConfig.pack() appends the cores "
            f"automatically in folded modes)")


def _log_slope_mask(xf: torch.Tensor) -> torch.Tensor:
    """1.0 on positive NORMAL finite lanes, else 0.0 — decided BITWISE, as
    in the reference (whose backend flushes subnormals inconsistently inside
    one fused computation).  Subnormal lanes get slope 0 like the other edge
    lanes."""
    bits = u32_bits(xf)
    field = (bits >> 23) & 0xFF
    pos_normal = ((bits >> 31) == 0) & (field >= 1) & (field <= 254)
    return pos_normal.to(torch.float32)


def _log_slope_safe_x(xf: torch.Tensor) -> torch.Tensor:
    """xf with the non-(positive-normal) lanes replaced by 1.0 through the
    reference's arithmetic ``xf * mask + (1 - mask)``."""
    mask = _log_slope_mask(xf)
    return xf * mask + (1.0 - mask)


# --------------------------------------------------------------------------------------
# plain versions (the *_ref runtimes and the kernels' yardstick)
# --------------------------------------------------------------------------------------


def eval_folded_ref(pack, name: str, x: torch.Tensor, *,
                    extrapolate: bool = False) -> torch.Tensor:
    """Fold + core lookup + reconstruct in plain PyTorch — the
    ``folded_pack_ref`` runtime and the plain version of the fused folded
    kernel, bit-identical to the reference's eager ``eval_folded_ref``.  A
    foldable name returns f32 whatever x's dtype, as the reference's does;
    non-foldable members fall through to :func:`eval_pack_ref`."""
    if name not in FOLDABLE:
        return eval_pack_ref(pack, name, x, extrapolate=extrapolate)
    _check_cores(pack, name)
    xf = x.to(torch.float32)
    if name in ("sin", "cos"):
        r, q, sflip = trig_fold(xf)
        ys = eval_pack_ref(pack, "sin_core", r)
        yc = eval_pack_ref(pack, "cos_core", r)
        return trig_edges(xf, trig_reconstruct(name, ys, yc, q, sflip))
    if name == "exp":
        r, k = exp_fold(xf)
        return exp_edges(xf, exp_reconstruct(eval_pack_ref(pack, "exp_core", r), k))
    m, e = log_fold(xf)
    return log_edges(xf, log_reconstruct(eval_pack_ref(pack, "log_core", m), e))


def eval_folded_slope(pack, name: str, x: torch.Tensor, *,
                      extrapolate: bool = False) -> torch.Tensor:
    """d/dx of the folded surrogate by the chain rule over the CORE table
    slopes (unit inner derivative for trig and exp, ``m / x`` for log);
    non-finite and out-of-support lanes give 0, as in the reference."""
    if name not in FOLDABLE:
        return eval_pack_slope(pack, name, x, extrapolate=extrapolate)
    _check_cores(pack, name)
    xf = x.to(torch.float32)
    if name in ("sin", "cos"):
        r, q, sflip = trig_fold(xf)
        ds = eval_pack_slope(pack, "sin_core", r)
        dc = eval_pack_slope(pack, "cos_core", r)
        sl = trig_slope_reconstruct(name, ds, dc, q, sflip)
        return torch.where(torch.isfinite(xf), sl, 0.0)
    if name == "exp":
        r, k = exp_fold(xf)
        sl = exp_reconstruct(eval_pack_slope(pack, "exp_core", r), k)
        # the 2^k rescale overflows exactly where exp(x) itself does
        return torch.where(torch.isfinite(xf) & torch.isfinite(sl), sl, 0.0)
    m, e = log_fold(xf)
    return _log_slope_mask(xf) * eval_pack_slope(pack, "log_core", m) \
        * (m / _log_slope_safe_x(xf))


# --------------------------------------------------------------------------------------
# static dispatch (the fused kernel) and the differentiable closure
# --------------------------------------------------------------------------------------


def folded_lookup(pack, name: str, x: torch.Tensor, *,
                  extrapolate: bool = False) -> torch.Tensor:
    """Kernel-side ``folded_pack`` evaluation: the fused fold + lookup kernel
    for a foldable member, the plain pack kernel otherwise."""
    from repro_torch.kernels import table_pack_lookup as K

    if name in FOLDABLE:
        _check_cores(pack, name)
        return K.folded_pack_lookup(pack, name, x)
    return K.table_pack_lookup(pack, name, x, extrapolate=extrapolate)


def make_folded_fn(pack, name: str, *, use_kernel: bool = True, exact_d1=None,
                   extrapolate: bool = False):
    """Differentiable full-range unary served through the folded pack — what
    ``ApproxConfig(mode="folded_pack[_ref]").unary`` and ``rope_sin_cos``
    build.  ``use_kernel=True`` runs ``folded_pack_lookup`` without a
    gradient and the fused value + slope ``folded_pack_grad`` under one;
    ``use_kernel=False`` the plain versions.  Tangent: the chain-ruled core
    slope, or ``exact_d1(x)`` when given."""
    if name not in FOLDABLE:
        return make_pack_fn(pack, name, use_kernel=use_kernel,
                            exact_d1=exact_d1, extrapolate=extrapolate)
    _check_cores(pack, name)
    if use_kernel:
        from repro_torch.kernels import table_pack_lookup as K

        value = lambda v: K.folded_pack_lookup(pack, name, v)
        fused = lambda v: K.folded_pack_grad(pack, name, v)
    else:
        value = lambda v: eval_folded_ref(pack, name, v)
        fused = lambda v: (value(v), eval_folded_slope(pack, name, v))
    if exact_d1 is not None:
        fused = lambda v: (value(v), exact_d1(v))
    return slope_rule(value, fused)


# --------------------------------------------------------------------------------------
# routed dispatch (the fold as PyTorch prologue/epilogue around the routed kernel)
# --------------------------------------------------------------------------------------


def _routed_core(pack, cname: str, r: torch.Tensor, use_kernel: bool):
    """One core lookup through the ROUTED path, r viewed as one row."""
    from repro_torch.kernels import routed_pack_lookup as R

    v = r.reshape(1, -1)
    out = (R.routed_pack_lookup(pack, cname, v) if use_kernel
           else eval_routed_ref(pack, cname, v))
    return out.reshape(r.shape)


def eval_folded_routed(pack, name: str, x: torch.Tensor, *, use_kernel: bool,
                       extrapolate: bool = False) -> torch.Tensor:
    """``folded_routed_pack[_ref]`` evaluation: PyTorch fold prologue, the
    core lookups through the routed dispatch, PyTorch reconstruction
    epilogue.  Kernel and plain version share this function (``use_kernel``
    picks only the inner routed call), so their bit parity is the routed
    dispatch contract."""
    if name not in FOLDABLE:
        from repro_torch.kernels import routed_pack_lookup as R

        v = x.reshape(1, -1)
        out = (R.routed_pack_lookup(pack, name, v, extrapolate=extrapolate)
               if use_kernel else
               eval_routed_ref(pack, name, v, extrapolate=extrapolate))
        return out.reshape(x.shape)
    _check_cores(pack, name)
    xf = x.to(torch.float32)
    if name in ("sin", "cos"):
        r, q, sflip = trig_fold(xf)
        ys = _routed_core(pack, "sin_core", r, use_kernel)
        yc = _routed_core(pack, "cos_core", r, use_kernel)
        return trig_edges(xf, trig_reconstruct(name, ys, yc, q, sflip))
    if name == "exp":
        r, k = exp_fold(xf)
        return exp_edges(xf, exp_reconstruct(
            _routed_core(pack, "exp_core", r, use_kernel), k))
    m, e = log_fold(xf)
    return log_edges(xf, log_reconstruct(
        _routed_core(pack, "log_core", m, use_kernel), e))


def make_folded_routed_unary_fn(pack, name: str, *, use_kernel: bool = True,
                                exact_d1=None, extrapolate: bool = False):
    """Differentiable folded unary over the ROUTED core lookups — what
    ``ApproxConfig(mode="folded_routed_pack[_ref]").unary`` builds.  The
    tangent is the chain-ruled core slope: on the card the slope output of
    ``folded_pack_grad`` (the same function as :func:`eval_folded_slope`, bit
    for bit, in x's dtype), in the plain mode :func:`eval_folded_slope`;
    ``exact_d1(x)`` when given."""
    if name not in FOLDABLE:
        return make_routed_unary_fn(pack, name, use_kernel=use_kernel,
                                    exact_d1=exact_d1, extrapolate=extrapolate)
    _check_cores(pack, name)
    value = lambda v: eval_folded_routed(pack, name, v, use_kernel=use_kernel)
    if exact_d1 is not None:
        slope = exact_d1
    elif use_kernel:
        from repro_torch.kernels import table_pack_lookup as K

        slope = lambda v: K.folded_pack_grad(pack, name, v)[1]
    else:
        slope = lambda v: eval_folded_slope(pack, name, v)
    return slope_rule(value, lambda v: (value(v), slope(v)))
