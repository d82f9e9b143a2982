"""The port's QuantPack and PolyPack (design flow, runtimes, modes, model)
against the JAX reference, on the same numpy inputs.

Contract (tolerances stated with their reason):

* design flow: the port's ``quantize``, ``packing`` and ``design`` copies give
  identical arrays (f64 codes, scales, metadata) and the same plan (the same
  candidate per member, the same bytes) as the reference's;
* plain versions (``eval_quant_pack_ref`` / ``_slope``, ``eval_poly_pack_ref``
  / ``_slope`` and the CPU wrappers): bitwise equal to the reference's EAGER
  oracles, which round every op on its own, on every member, with
  extrapolation on and off, in f32 and bf16.  Slopes are compared on finite
  inputs: at a NaN input the slope reads the codes at address 0 of the width
  group, where the eager oracle's unclamped gather and the port agree only by
  the conversion rule, which the value already covers;
* against the reference's Pallas kernels in interpret mode (as the JAX tests
  run them on the CPU): XLA contracts the dequantization ``r + scale * c``,
  the lerp and each Horner step ``y * t + c`` into FMAs there.  Each
  contraction moves a result by at most one rounding of its largest operand,
  so values are held within 4 ULP at the scale of the largest intermediate of
  the element's evaluation (the dequantized codes, the lerp or Horner terms
  and the result); past the cell grid with extrapolation the rounding
  differences of the edge cell's slope are multiplied by the distance beyond
  it, so there the bound is multiplied by ``1 + |t - clip(t, 0, 1)|``.  The
  polynomial slope is held within ``rtol=1e-5, atol=1e-7``,
  the bound the reference's own tests/test_poly_pack.py holds its fused slope
  to against its oracle;
* gradients through ``make_quant_pack_fn`` / ``make_poly_pack_fn`` /
  ``ApproxConfig.unary``: exactly ``slope * dy``, and bitwise equal to the
  reference's VJP of its ``custom_jvp`` (one product per element on both
  sides); with ``exact_grad`` within ``1e-6 * (|want| + |dy|)`` (the two
  frameworks' transcendentals differ by an ULP, see tests/test_torch_pack.py);
* inputs are normal floats or zero: XLA on the CPU flushes subnormal inputs
  to zero, PyTorch and the CUDA kernels do not (the card tests keep them);
* model: reduced stablelm (2 layers, d=64) serves the mixed-EOS queue
  token-identical to the JAX ContinuousEngine, f32 compute; training loss
  within 1e-5 relative and each gradient leaf within 1e-3 of its norm of
  ``jax.value_and_grad`` (the bounds of tests/test_torch_train.py, for the
  reasons given there).
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.approx import ApproxConfig as JApprox
from repro.approx import table_pack as tp_ref
from repro.core import design as j_design
from repro.core import packing as j_packing
from repro.core import quantize as j_quantize
from repro.kernels.table_pack_lookup import (poly_pack_grad_pallas,
                                             poly_pack_lookup_pallas,
                                             quant_pack_grad_pallas,
                                             quant_pack_lookup_pallas)
from repro_torch import approx as port_approx
from repro_torch.approx import TABLE_MODES, ApproxConfig, table_pack
from repro_torch.core import design, packing, quantize
from repro_torch.core.functions import get as get_function
from repro_torch.kernels import table_pack_lookup as K

NAMES = ("gelu", "silu", "tanh", "sigmoid_sym", "softplus", "exp_neg")
EA = 1e-4  # stablelm-3b's own settings: e_a 1e-4, omega 0.2
OMEGA = 0.2
# one member per degree, each at another code width (the reference's
# tests/test_poly_pack.py MIXED pack)
MIXED = (("tanh", 1, 32), ("exp_neg", 3, 8), ("gelu", 2, 16))
N = 1 << 13


# --------------------------------------------------------------------------------------
# packs, built once per module on both sides
# --------------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def quant():
    return (tp_ref.build_quant_pack(NAMES, EA, omega=OMEGA),
            table_pack.build_quant_pack(NAMES, EA, omega=OMEGA, device="cpu"))


@pytest.fixture(scope="module")
def poly():
    return (tp_ref.build_poly_pack(NAMES, EA, omega=OMEGA),
            table_pack.build_poly_pack(NAMES, EA, omega=OMEGA, device="cpu"))


@pytest.fixture(scope="module")
def mixed():
    j = [j_design.poly_member(n, EA, degree=d, bits=b) for n, d, b in MIXED]
    t = [design.poly_member(n, EA, degree=d, bits=b) for n, d, b in MIXED]
    return (tp_ref.from_poly_layout(j_packing.poly_pack_layout(j)),
            table_pack.from_poly_layout(packing.poly_pack_layout(t), "cpu"))


PACKS = ("quant", "poly", "mixed")


@pytest.fixture(params=PACKS)
def any_pack(request):
    return request.param, request.getfixturevalue(request.param)


def _ports(kind):
    """(plain value, plain slope, wrapper value, wrapper grad, reference
    oracle value, slope, interpret kernel value, grad) of a pack kind."""
    if kind == "quant":
        return (table_pack.eval_quant_pack_ref, table_pack.eval_quant_pack_slope,
                K.quant_pack_lookup, K.quant_pack_grad,
                tp_ref.eval_quant_pack_ref, tp_ref.eval_quant_pack_slope,
                quant_pack_lookup_pallas, quant_pack_grad_pallas)
    return (table_pack.eval_poly_pack_ref, table_pack.eval_poly_pack_slope,
            K.poly_pack_lookup, K.poly_pack_grad,
            tp_ref.eval_poly_pack_ref, tp_ref.eval_poly_pack_slope,
            poly_pack_lookup_pallas, poly_pack_grad_pallas)


def inputs(pack, fid, seed=0, n=N):
    """Uniform over the member's domain +- 3, every boundary and its f32
    neighbours, and the specials; subnormals removed (see the docstring)."""
    lo, hi = pack.domains[fid]
    bo = pack.bounds_offset(fid)
    b = pack.boundaries[bo: bo + pack.n_intervals[fid] + 1].numpy()
    rng = np.random.default_rng(seed)
    x = np.concatenate([
        rng.uniform(lo - 3.0, hi + 3.0, n), b,
        np.nextafter(b, np.float32(np.inf)), np.nextafter(b, np.float32(-np.inf)),
        [np.inf, -np.inf, np.nan, -2e38, 2e38, 0.0, -0.0, lo, hi]]).astype(np.float32)
    subnormal = (x != 0) & (np.abs(x) < np.finfo(np.float32).tiny)
    return x[~subnormal]


def ulps(a, b):
    """Per-element distance in f32 units in the last place (NaN pairs: 0)."""
    def ordered(v):
        i = np.asarray(v, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    d = np.abs(ordered(a) - ordered(b))
    return np.where(np.isnan(a) & np.isnan(b), 0, d)


def assert_bitwise(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert int(ulps(got, want).max()) == 0


# --------------------------------------------------------------------------------------
# design flow: quantize, packing, design
# --------------------------------------------------------------------------------------


def _assert_arrays_equal(a, b, fields):
    for f in fields:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)


SPEC_FIELDS = ("boundaries", "inv_delta", "delta", "base", "seg_count", "values")
QUANT_FIELDS = ("codes", "scale", "zero", "ramp")
POLY_FIELDS = ("boundaries", "inv_delta", "delta", "base", "seg_count", "zero",
               "ramp", "scale", "codes")


@pytest.mark.parametrize("e_a", [1e-4, 1e-6])
@pytest.mark.parametrize("name", NAMES)
def test_quant_member_matches_reference(name, e_a):
    """plan_quant_member (refinement, int8/int16 choice, chord-residual
    codes) gives the reference's member, array for array."""
    j = j_quantize.plan_quant_member(name, e_a, omega=OMEGA)
    t = quantize.plan_quant_member(name, e_a, omega=OMEGA)
    assert (t.bits, t.rho, t.e_a, t.name, t.footprint) == (j.bits, j.rho, j.e_a,
                                                           j.name, j.footprint)
    _assert_arrays_equal(t.spec, j.spec, SPEC_FIELDS)
    _assert_arrays_equal(t, j, QUANT_FIELDS)
    np.testing.assert_array_equal(quantize.chord_residual_ranges(t.spec),
                                  j_quantize.chord_residual_ranges(j.spec))
    assert (t.codes_bytes, t.meta_bytes) == (j.codes_bytes, j.meta_bytes)


def test_quantize_helpers_match_reference():
    from repro.core.flow import cached_table as j_cached
    from repro_torch.core.flow import cached_table

    tol = 0.1 * EA
    for bits in (8, 16):
        assert quantize.quant_rounding_limit(tol, bits) == \
            j_quantize.quant_rounding_limit(tol, bits)
        lim = quantize.quant_rounding_limit(tol, bits)
        t = quantize.refine_for_quantization(cached_table("gelu", 0.9 * EA), lim)
        j = j_quantize.refine_for_quantization(j_cached("gelu", 0.9 * EA), lim)
        _assert_arrays_equal(t, j, SPEC_FIELDS)
        _assert_arrays_equal(quantize.quantize_spec(t, tol, bits, rho=0.9, e_a=EA),
                             j_quantize.quantize_spec(j, tol, bits, rho=0.9, e_a=EA),
                             QUANT_FIELDS)
    with pytest.raises(ValueError, match="refine first"):
        quantize.quantize_spec(cached_table("gelu", 0.9 * EA), tol, 8, rho=0.9, e_a=EA)
    for kw in (dict(rho=1.0), dict(dtype="int4")):
        with pytest.raises(ValueError):
            quantize.plan_quant_member("gelu", EA, **kw)


def test_quant_pack_layout_matches_reference():
    jm = [j_quantize.plan_quant_member(n, EA, omega=OMEGA, dtype=d)
          for n, d in zip(NAMES, ("int8", "int16") * 3)]
    tm = [quantize.plan_quant_member(n, EA, omega=OMEGA, dtype=d)
          for n, d in zip(NAMES, ("int8", "int16") * 3)]
    j, t = j_packing.quant_pack_layout(jm), packing.quant_pack_layout(tm)
    assert (t.names, t.n_intervals, t.entry_bits) == (j.names, j.n_intervals,
                                                      j.entry_bits)
    _assert_arrays_equal(t, j, ("boundaries", "inv_delta", "delta", "base",
                                "seg_count", "scale", "zero", "ramp",
                                "value_offset", "codes8", "codes16"))
    assert (t.footprint, t.footprint_bytes, t.meta_bytes) == (
        j.footprint, j.footprint_bytes, j.meta_bytes)
    x = np.linspace(-9, 9, 501)
    for f in range(len(NAMES)):
        np.testing.assert_array_equal(t.eval(f, x), j.eval(f, x))
    with pytest.raises(ValueError, match="duplicate"):
        packing.quant_pack_layout(tm[:1] * 2)


@pytest.mark.parametrize("name", NAMES)
def test_design_candidates_match_reference(name, poly):
    """Every (degree, dtype) candidate of the menu: the same feasibility, the
    same bytes, the same member arrays (built once, by the poly fixture's
    plans, and memoized on both sides)."""
    tc = design.enumerate_candidates(name, EA, omega=OMEGA)
    jc = j_design.enumerate_candidates(name, EA, omega=OMEGA)
    assert [(c.degree, c.dtype, c.entries, c.codes_bytes, c.meta_bytes)
            for c in tc] == [(c.degree, c.dtype, c.entries, c.codes_bytes,
                              c.meta_bytes) for c in jc]
    for a, b in zip(tc, jc):
        _assert_arrays_equal(a.member, b.member, POLY_FIELDS)
        assert (a.member.bits, a.member.rho, a.member.lo, a.member.hi) == (
            b.member.bits, b.member.rho, b.member.lo, b.member.hi)
    assert ([(c.degree, c.dtype) for c in design.pareto_front(tc)]
            == [(c.degree, c.dtype) for c in j_design.pareto_front(jc)])


def _chosen(plan):
    return [(c.name, c.degree, c.dtype, c.total_bytes) for c in plan.chosen]


@pytest.mark.parametrize("budget", [None, 3000, 5000])
def test_plan_matches_reference(budget, poly):
    t = design.plan(NAMES, EA, budget, omega=OMEGA)
    j = j_design.plan(NAMES, EA, budget, omega=OMEGA)
    assert _chosen(t) == _chosen(j)
    assert (t.total_bytes, t.total_entries, t.describe()) == (
        j.total_bytes, j.total_entries, j.describe())
    if budget is None:
        assert t.total_bytes == 2088  # the cheapest plan at stablelm's settings
    else:
        assert t.total_bytes <= budget
    lt = packing.poly_pack_layout(list(t.members))
    lj = j_packing.poly_pack_layout(list(j.members))
    assert (lt.names, lt.n_intervals, lt.degrees, lt.entry_bits, lt.max_degree) == (
        lj.names, lj.n_intervals, lj.degrees, lj.entry_bits, lj.max_degree)
    _assert_arrays_equal(lt, lj, ("boundaries", "inv_delta", "delta", "base",
                                  "seg_count", "zero", "ramp", "scale",
                                  "value_offset", "codes8", "codes16", "codes32"))
    assert (lt.footprint, lt.footprint_bytes, lt.meta_bytes) == (
        lj.footprint, lj.footprint_bytes, lj.meta_bytes)


def test_infeasible_budget_raises_as_reference(poly):
    with pytest.raises(ValueError) as jerr:
        j_design.plan(NAMES, EA, 600, omega=OMEGA)
    with pytest.raises(ValueError) as terr:
        design.plan(NAMES, EA, 600, omega=OMEGA)
    assert str(terr.value) == str(jerr.value)
    assert "pack budget 600 B infeasible" in str(terr.value)
    with pytest.raises(ValueError, match="member budget 10 B infeasible"):
        quantize.plan_quant_member("gelu", EA, omega=OMEGA, budget_bytes=10)


def test_mixed_layout_and_helpers_match_reference(mixed):
    jp, tp = mixed
    assert tp.degrees == (1, 3, 2) and tp.entry_bits == (32, 8, 16)
    assert tp.max_lanes == jp.max_lanes == 4
    for f in ("boundaries", "inv_delta", "base", "seg_count", "zero", "ramp",
              "scale", "codes8", "codes16", "codes32"):
        a, b = getattr(tp, f).numpy(), np.asarray(getattr(jp, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for deg in (1, 2, 3):
        assert design.interp_error_const(deg) == j_design.interp_error_const(deg)
        assert design.poly_cell_width(0.3, EA, deg) == j_design.poly_cell_width(0.3, EA, deg)


# --------------------------------------------------------------------------------------
# the runtime artifacts
# --------------------------------------------------------------------------------------


def test_pack_artifacts_match_reference(any_pack):
    kind, (jp, tp) = any_pack
    assert (tp.names, tp.n_intervals, tp.entry_bits) == (jp.names, jp.n_intervals,
                                                         jp.entry_bits)
    groups = ("codes8", "codes16") + (("codes32",) if kind != "quant" else ())
    planes = ("boundaries", "inv_delta", "base", "seg_count", "scale", "zero", "ramp")
    for f in planes + groups:
        a, b = getattr(tp, f).numpy(), np.asarray(getattr(jp, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert (tp.footprint, tp.footprint_bytes) == (jp.footprint, jp.footprint_bytes)
    for fid in range(tp.n_functions):
        assert tp.bounds_offset(fid) == jp.bounds_offset(fid)
        assert tp.lane_offset(fid) == jp.lane_offset(fid)
        assert tp.codes_for(fid) is getattr(tp, f"codes{tp.entry_bits[fid]}")
        bo, n = tp.bounds_offset(fid), tp.n_intervals[fid]
        assert tp.domains[fid] == (float(jp.boundaries[bo]), float(jp.boundaries[bo + n]))
    if kind == "quant":
        assert tp.rho == jp.rho
    else:
        assert (tp.degrees, tp.max_degree) == (jp.degrees, jp.max_degree)


def test_pack_contracts(quant, poly):
    _, q = quant
    _, p = poly
    for pk in (q, p):
        assert pk.member_id("silu") == pk.fn_id("silu") == 1
        with pytest.raises(KeyError, match="'nope' not in pack"):
            pk.member_id("nope")
        with pytest.raises(KeyError, match="out of range"):
            pk.member_id(6)
    # an unused width group keeps a 1-entry dummy, left out of the footprint
    assert q.codes16.shape == (1,) and q.footprint == q.codes8.shape[0] == 1020
    assert p.codes8.shape == p.codes32.shape == (1,) and p.footprint == 488
    assert p.footprint_bytes == 2 * 488
    with pytest.raises(KeyError):
        K.quant_pack_lookup(q, 7, torch.zeros(3))


def test_exact_integer_limit():
    """A width group of 2^24 codes would address past f32's exact integers:
    refused, as the reference refuses it."""
    big = np.broadcast_to(np.int64(0), (1 << 24,))
    ql = packing.quant_pack_layout([quantize.plan_quant_member("gelu", EA)])
    with pytest.raises(ValueError, match="exact-integer"):
        table_pack.from_quant_layout(dataclasses.replace(ql, codes8=big), "cpu")
    pl = packing.poly_pack_layout([design.poly_member("gelu", EA, degree=1, bits=32)])
    with pytest.raises(ValueError, match="exact-integer"):
        table_pack.from_poly_layout(dataclasses.replace(pl, codes16=big), "cpu")


# --------------------------------------------------------------------------------------
# plain versions against the eager oracles and the interpret-mode kernels
# --------------------------------------------------------------------------------------


@pytest.mark.parametrize("extrapolate", [False, True])
def test_bitwise_vs_eager_oracle(any_pack, extrapolate):
    kind, (jp, tp) = any_pack
    value, slope, kval, kgrad, jval, jslope, _, _ = _ports(kind)
    for fid, name in enumerate(tp.names):
        x = inputs(tp, fid, seed=fid)
        fin = x[np.isfinite(x)]
        for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
            want = np.asarray(jval(jp, name, jnp.asarray(x, jdt),
                                   extrapolate=extrapolate)).astype(np.float32)
            want_s = np.asarray(jslope(jp, name, jnp.asarray(fin, jdt),
                                       extrapolate=extrapolate)).astype(np.float32)
            xt, ft = torch.from_numpy(x).to(dt), torch.from_numpy(fin).to(dt)
            for got in (value(tp, name, xt, extrapolate=extrapolate),
                        kval(tp, fid, xt, extrapolate=extrapolate),
                        kgrad(tp, fid, xt, extrapolate=extrapolate)[0]):
                assert got.dtype == dt
                assert_bitwise(got.float().numpy(), want)
            for got in (slope(tp, name, ft, extrapolate=extrapolate),
                        kgrad(tp, fid, ft, extrapolate=extrapolate)[1]):
                assert got.dtype == dt
                assert_bitwise(got.float().numpy(), want_s)


def _quant_scale(tp, fid, x, extrapolate):
    """Per element, the largest intermediate of the quantized lookup (the
    chord ramp's terms, the dequantized endpoints and their terms, the lerp
    term) and the extrapolation factor ``1 + |t - clip(t, 0, 1)|`` (the
    port's own selector and address math)."""
    xf = torch.from_numpy(x)
    p, invd, base, segs, scale, zero, ramp = table_pack._quant_select(tp, fid, xf)
    u = (xf - p) * invd
    i = table_pack.clamp_cell(u, segs)
    c0, c1 = table_pack._quant_codes(tp, fid, base, i)
    r = zero + ramp * i
    y0, y1 = r + scale * c0, (r + ramp) + scale * c1
    t = u - i if extrapolate else torch.clamp(u - i, 0.0, 1.0)
    terms = (zero, ramp * i, r, y0, y1, scale * c0, scale * c1, t * (y1 - y0))
    return (torch.stack([v.abs() for v in terms]).amax(0).numpy(),
            (1 + (t - torch.clamp(t, 0.0, 1.0)).abs()).numpy())


def _quant_slope_scale(tp, fid, x):
    """Per element, the largest term of the quantized slope
    ``(ramp + scale * (c1 - c0)) * invd``, each taken times ``invd``."""
    xf = torch.from_numpy(x)
    p, invd, base, segs, scale, zero, ramp = table_pack._quant_select(tp, fid, xf)
    i = table_pack.clamp_cell((xf - p) * invd, segs)
    c0, c1 = table_pack._quant_codes(tp, fid, base, i)
    return (torch.maximum(ramp.abs(), (scale * (c1 - c0)).abs()) * invd.abs()).numpy()


def _poly_scale(tp, fid, x, extrapolate):
    """Per element, the largest intermediate of the Horner evaluation (the
    dequantized lanes and the terms of their ramps, each Horner product and
    partial sum, the tangent term) and the extrapolation factor."""
    xf = torch.from_numpy(x)
    p, invd, base, segs, meta = table_pack._poly_select(tp, fid, xf)
    u = (xf - p) * invd
    i = table_pack.clamp_cell(u, segs)
    cs = table_pack._poly_coeffs(tp, fid, base, i, meta)
    t = u - i
    tc = torch.clamp(t, 0.0, 1.0)
    terms = list(cs) + [v for z, r, sc in meta for v in (z, r * i, z + r * i)]
    y = cs[-1]
    for c in reversed(cs[:-1]):
        terms += [y * tc, y * tc + c]
        y = y * tc + c
    if extrapolate:
        g = table_pack.poly_horner_d1(cs, tc)
        terms += [g * (t - tc), y + g * (t - tc)]
    amp = 1 + (t - tc).abs() if extrapolate else torch.ones_like(t)
    return torch.stack([v.abs() for v in terms]).amax(0).numpy(), amp.numpy()


@pytest.mark.parametrize("extrapolate", [False, True])
def test_within_ulps_of_interpret_kernels(any_pack, extrapolate):
    kind, (jp, tp) = any_pack
    value, slope, _, _, _, _, kern, kgrad = _ports(kind)
    scale_of = _quant_scale if kind == "quant" else _poly_scale
    for fid, name in enumerate(tp.names):
        x = inputs(tp, fid, seed=10 + fid)
        got = value(tp, name, torch.from_numpy(x), extrapolate=extrapolate).numpy()
        want = np.asarray(kern(jp, name, jnp.asarray(x), extrapolate=extrapolate))
        ks = np.asarray(kgrad(jp, name, jnp.asarray(x), extrapolate=extrapolate)[1])
        scale, amp = scale_of(tp, fid, x, extrapolate)
        # an infinite distance past the grid (x = +-inf, or u overflowing)
        # times an edge slope that one side rounds to exactly 0 is NaN there
        # and +-inf on the other side: such elements are held to nothing
        keep = np.isfinite(amp)
        assert (np.isnan(got) == np.isnan(want))[keep].all()
        fin = np.isfinite(got) & np.isfinite(want) & keep
        inf = keep & ~fin & ~np.isnan(got)
        assert (got[inf] == want[inf]).all()
        scale = np.maximum(scale[fin], np.abs(want[fin]))
        with np.errstate(over="ignore"):  # a tail far past the grid: no bound
            tol = 4 * np.spacing(scale.astype(np.float32)) * amp[fin]
        err = np.abs(got[fin] - want[fin])
        assert (err <= tol).all(), (name, float(np.max(err / tol)))
        xf = np.isfinite(x)
        s = slope(tp, name, torch.from_numpy(x[xf]), extrapolate=extrapolate).numpy()
        if kind == "quant":  # (ramp + scale * (c1 - c0)) * invd: 1 contraction
            sc = np.maximum(_quant_slope_scale(tp, fid, x[xf]), np.abs(ks[xf]))
            assert (np.abs(s - ks[xf]) <= 4 * np.spacing(sc.astype(np.float32))).all()
        else:
            np.testing.assert_allclose(s, ks[xf], rtol=1e-5, atol=1e-7, err_msg=name)


# --------------------------------------------------------------------------------------
# gradients
# --------------------------------------------------------------------------------------


def _grad(f, x, dy):
    x = x.clone().requires_grad_(True)
    y = f(x)
    y.backward(dy)
    return y.detach(), x.grad


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("kind", PACKS)
def test_pack_fn_backward_is_slope_times_dy(kind, use_kernel, request):
    jp, tp = request.getfixturevalue(kind)
    make = table_pack.make_quant_pack_fn if kind == "quant" else table_pack.make_poly_pack_fn
    jmake = tp_ref.make_quant_pack_fn if kind == "quant" else tp_ref.make_poly_pack_fn
    _, slope, _, kgrad, _, _, _, _ = _ports(kind)
    rng = np.random.default_rng(7)
    for fid, name in enumerate(tp.names):
        ex = name in ("gelu", "silu", "softplus")
        lo, hi = tp.domains[fid]
        xn = rng.uniform(lo - 2, hi + 2, 3000).astype(np.float32)
        dyn = rng.normal(0, 1, xn.size).astype(np.float32)
        for dt in (torch.float32, torch.bfloat16):
            x, dy = torch.from_numpy(xn).to(dt), torch.from_numpy(dyn).to(dt)
            f = make(tp, name, use_kernel=use_kernel, extrapolate=ex)
            y, g = _grad(f, x, dy)
            want_y, s = kgrad(tp, fid, x, extrapolate=ex)
            assert g.dtype == dt
            assert torch.equal(y, want_y) and torch.equal(g, s * dy)
            with torch.inference_mode():  # no gradient recorded: the value path
                assert torch.equal(f(x), want_y)
        jy, vjp = jax.vjp(jmake(jp, name, use_pallas=False, extrapolate=ex),
                          jnp.asarray(xn))
        y, g = _grad(make(tp, name, use_kernel=use_kernel, extrapolate=ex),
                     torch.from_numpy(xn), torch.from_numpy(dyn))
        assert_bitwise(y, jy)
        assert_bitwise(g, vjp(jnp.asarray(dyn))[0])
        d1 = lambda v: torch.cos(v)  # any analytic derivative
        y, g = _grad(make(tp, name, use_kernel=use_kernel, exact_d1=d1, extrapolate=ex),
                     torch.from_numpy(xn), torch.from_numpy(dyn))
        assert torch.equal(g, torch.cos(torch.from_numpy(xn)) * torch.from_numpy(dyn))


UNARY_MODES = ("quant_pack", "quant_pack_ref", "poly_pack", "poly_pack_ref")


def test_modes_are_ported():
    for mode in UNARY_MODES:
        assert mode in TABLE_MODES
        ApproxConfig(mode=mode, e_a=EA, omega=OMEGA).unary("silu", "cpu")
    # every mode of the reference is ported: the refusal table is gone
    assert not hasattr(port_approx, "NOT_PORTED")


@pytest.mark.parametrize("mode", UNARY_MODES)
@pytest.mark.parametrize("name", ["silu", "gelu", "tanh", "sigmoid", "exp", "softplus"])
def test_unary_matches_reference(mode, name, quant, poly):
    """ApproxConfig.unary, remaps and odd extension included, bitwise against
    the reference's eager oracle path (its ``_ref`` mode)."""
    x = np.linspace(-12.0, 12.0, 2001).astype(np.float32)
    if name == "exp":
        x = np.minimum(x, 0.0)
    jmode = mode if mode.endswith("_ref") else mode + "_ref"
    want = np.asarray(JApprox(mode=jmode, e_a=EA, omega=OMEGA).unary(name)(jnp.asarray(x)))
    got = ApproxConfig(mode=mode, e_a=EA, omega=OMEGA).unary(name, "cpu")(
        torch.from_numpy(x)).numpy()
    assert_bitwise(got, want)


@pytest.mark.parametrize("exact_grad", [False, True])
@pytest.mark.parametrize("mode", UNARY_MODES)
@pytest.mark.parametrize("name", ["silu", "gelu", "tanh", "sigmoid", "exp"])
def test_unary_grad_matches_reference(mode, name, exact_grad, quant, poly):
    rng = np.random.default_rng(13)
    x = np.linspace(-12.0, 12.0, 2001).astype(np.float32)
    if name == "exp":
        x = np.minimum(x, 0.0)
    dy = rng.normal(0, 1, x.size).astype(np.float32)
    jmode = mode if mode.endswith("_ref") else mode + "_ref"
    jf = JApprox(mode=jmode, e_a=EA, omega=OMEGA, exact_grad=exact_grad).unary(name)
    _, vjp = jax.vjp(jf, jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(dy))[0])
    f = ApproxConfig(mode=mode, e_a=EA, omega=OMEGA, exact_grad=exact_grad).unary(name, "cpu")
    _, got = _grad(f, torch.from_numpy(x), torch.from_numpy(dy))
    if exact_grad:
        assert (np.abs(got.numpy() - want) <= 1e-6 * (np.abs(want) + np.abs(dy))).all()
    else:
        assert_bitwise(got, want)


def test_pack_caches_and_attn_exp(quant, poly):
    """Per-device caches keyed as the reference's; TableFlash in these modes
    serves the exponent from the f32 pack."""
    a = ApproxConfig(mode="quant_pack", e_a=EA, omega=OMEGA)
    assert a.quant_pack("cpu") is a.quant_pack("cpu")
    assert dataclasses.replace(a, quant_rho=0.8).quant_pack("cpu") is not a.quant_pack("cpu")
    p = ApproxConfig(mode="poly_pack", e_a=EA, omega=OMEGA)
    assert p.poly_pack("cpu") is p.poly_pack("cpu")
    assert p._pack_for_mode("cpu") is p.poly_pack("cpu")
    assert a._pack_for_mode("cpu") is a.quant_pack("cpu")
    assert dataclasses.replace(p, pack_budget=5000).poly_pack("cpu").degrees != \
        p.poly_pack("cpu").degrees
    z = torch.linspace(-30, 0, 301)
    want = K.tableflash_exp_plain(a.pack("cpu"), z)
    for mode in UNARY_MODES:
        got = dataclasses.replace(a, mode=mode, attn_table=True).attn_exp("cpu")(z)
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="infeasible"):
        dataclasses.replace(p, pack_budget=600).unary("silu", "cpu")


# --------------------------------------------------------------------------------------
# the model: serving and training against the reference
# --------------------------------------------------------------------------------------


def _pair(mode, attn):
    from repro.models import build_model as j_build_model
    from repro_torch.convert import params_from_jax
    from repro_torch.models import build_model, reduced
    from tests.test_archs import reduced as j_reduced

    jm = j_build_model(j_reduced("stablelm-3b").replace(
        compute_dtype="float32",
        approx=JApprox(mode=mode, e_a=EA, omega=OMEGA, attn_table=attn)))
    tm = build_model(reduced("stablelm-3b").replace(
        compute_dtype="float32",
        approx=ApproxConfig(mode=mode, e_a=EA, omega=OMEGA, attn_table=attn)),
        device="cpu")
    jp = jm.init(jax.random.key(0))
    return jm, jp, tm, params_from_jax(tm.cfg, jax.tree.map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("attn", [False, True])
@pytest.mark.parametrize("mode", ["quant_pack", "poly_pack"])
def test_greedy_tokens_match_reference_engine(mode, attn, quant, poly):
    from repro.serving.engine import ContinuousEngine as JContinuousEngine
    from repro_torch.kernels import _lib
    from repro_torch.serving.engine import ContinuousEngine
    from tests.test_serving import mixed_requests

    jm, jp, tm, tp = _pair(mode, attn)
    assert (tm.attn_exp is not None) == attn
    want = JContinuousEngine(jm, jp, batch_size=2, cache_len=64).serve(
        mixed_requests(np.random.default_rng(3), 8))
    _lib.reset_launches()
    got = ContinuousEngine(tm, tp, batch_size=2, cache_len=64).serve(
        mixed_requests(np.random.default_rng(3), 8))
    assert not any(_lib.launches.values())  # CPU tensors: plain versions only
    for i, (a, b) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(b.tokens, a.tokens, err_msg=f"req {i}")
        assert (b.steps, b.prompt_len) == (a.steps, a.prompt_len)


@pytest.mark.parametrize("mode", ["quant_pack", "poly_pack"])
def test_loss_and_grads_match_reference(mode, quant, poly):
    from repro_torch.convert import params_from_jax
    from repro_torch.train.loop import batch_to, value_and_grad
    from repro_torch.tree import leaves_with_path

    jm, jp, tm, tp = _pair(mode, True)
    rng = np.random.default_rng(0)
    b = {"tokens": rng.integers(0, tm.cfg.vocab, (4, 16)).astype(np.int32),
         "targets": rng.integers(0, tm.cfg.vocab, (4, 16)).astype(np.int32)}
    b["targets"][:, :3] = -1
    jl, jg = jax.jit(jax.value_and_grad(jm.loss))(
        jp, {k: jnp.asarray(v) for k, v in b.items()})
    tl, tg = value_and_grad(tm, tp, batch_to(b, "cpu"))
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    want = dict(leaves_with_path(params_from_jax(
        tm.cfg, jax.tree.map(np.asarray, jg), "cpu")))
    got = dict(leaves_with_path(tg))
    assert want.keys() == got.keys()
    for k, w in want.items():
        assert torch.isfinite(got[k]).all(), k
        err = float(torch.linalg.vector_norm(got[k] - w))
        assert err <= 1e-3 * float(torch.linalg.vector_norm(w)) + 1e-12, (k, err)


# --------------------------------------------------------------------------------------
# launchers
# --------------------------------------------------------------------------------------


def test_serve_cli_poly_pack_budget(capsys, poly):
    from repro_torch.launch.serve import main

    res = main(["--arch", "stablelm-3b", "--reduced", "--device", "cpu",
                "--requests", "3", "--batch", "2", "--max-new", "3",
                "--approx-mode", "poly_pack", "--pack-budget", "5000",
                "--attn-table"])
    assert [r.steps for r in res] == [3, 3, 3]
    assert "served 3 requests, 9 tokens on cpu" in capsys.readouterr().out
    with pytest.raises(ValueError, match="pack budget 600 B infeasible"):
        main(["--arch", "stablelm-3b", "--reduced", "--device", "cpu",
              "--requests", "1", "--approx-mode", "poly_pack",
              "--pack-budget", "600"])


def test_train_cli_quant_pack_and_budget(tmp_path, capsys, monkeypatch, quant):
    from repro_torch.launch import train

    out = train.main(["--arch", "stablelm-3b", "--reduced", "--device", "cpu",
                      "--steps", "2", "--batch", "4", "--seq", "16",
                      "--approx-mode", "quant_pack", "--ckpt-dir", str(tmp_path)])
    assert "done: step=2 loss" in capsys.readouterr().out
    assert all(np.isfinite(out["losses"]))
    seen = {}
    real_build = train.build_model

    def spy(cfg, device):
        seen["approx"] = cfg.approx
        return real_build(cfg, device)

    monkeypatch.setattr(train, "build_model", spy)
    monkeypatch.setattr(train, "run", lambda *a, **k: {"losses": [], "final_step": 0})
    train.main(["--arch", "stablelm-3b", "--reduced", "--device", "cpu",
                "--approx-mode", "poly_pack", "--pack-budget", "4321"])
    assert seen["approx"].mode == "poly_pack" and seen["approx"].pack_budget == 4321


def test_exact_d1_is_the_registry_derivative():
    """``exact_grad`` selects the registry's ``d1f`` in the new modes too."""
    x = torch.linspace(-5, 5, 101)
    d1 = partial(get_function("silu").d1f, xp=torch)
    for mode in UNARY_MODES:
        f = ApproxConfig(mode=mode, e_a=EA, omega=OMEGA, exact_grad=True).unary("silu", "cpu")
        _, g = _grad(f, x, torch.ones_like(x))
        assert torch.equal(g, d1(x))


# --------------------------------------------------------------------------------------
# The packs' shared-memory residency reports (``smem()``)
# --------------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def layouts():
    """The quantized layout and the planner's plan of stablelm-3b's packs,
    as build_quant_pack / build_poly_pack make them."""
    quant = packing.quant_pack_layout(
        [quantize.plan_quant_member(n, EA, omega=OMEGA) for n in NAMES])
    plan = design.plan(list(NAMES), EA, None, dtypes=design.POLY_DTYPES,
                       algorithm="hierarchical", omega=OMEGA, rho=0.9)
    return quant, plan


@pytest.mark.parametrize("kind", PACKS)
def test_smem_report_is_the_built_image(kind, layouts, request):
    """``QuantPackLayout.smem()`` / ``PolyPackLayout.smem()`` price, byte for
    byte, the staging image the pack builds (``QuantTablePack.image``,
    ``PolyTablePack.image``) at stablelm-3b's settings, staged whole; the
    planner's ``PackPlan.smem()`` is the poly pack's."""
    _, tp = request.getfixturevalue(kind)
    if kind == "quant":
        layout = layouts[0]
    elif kind == "poly":
        layout = packing.poly_pack_layout(list(layouts[1].members))
        assert layouts[1].smem() == layout.smem()
    else:
        layout = packing.poly_pack_layout(
            [design.poly_member(n, EA, degree=d, bits=b) for n, d, b in MIXED])
    report = layout.smem()
    assert report.image_bytes == tp.image.numel() * tp.image.element_size()
    assert report.budget_bytes == 48 * 1024 and report.staging == "image"
    assert 0 < report.table_bytes < report.image_bytes
