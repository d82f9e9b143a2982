"""The port's RangeFold (range reduction, the folded plain versions and
closures, the folded modes, ``rope_table``) against the JAX reference, on the
same numpy inputs.

Contract (tolerances stated with their reason):

* ``core.range_reduce``: the folds (``trig_fold`` with both reduction
  regimes, ``exp_fold``, ``log_fold``), the reconstructions and the edge
  handlers are bitwise equal to the reference's on the full-range samples of
  ``tests/harness/fullrange.py``.  Inputs are normal floats, zero and the
  non-finite specials (XLA on the CPU flushes subnormal inputs to zero,
  PyTorch and the CUDA kernels do not); ``log_fold`` is bitwise on
  subnormal inputs too, since both sides read them bitwise;
* plain versions (``eval_folded_ref`` / ``_slope``, the CPU wrappers, the
  routed shape): bitwise equal to the reference's EAGER oracles, which round
  every op on its own, NaN positions matched; where the port's output is
  subnormal, XLA on the CPU flushes it to zero (exp below about -87.3 and
  the log slope at tiny x), and only there a 0 is accepted in its place;
* against the reference's Pallas kernels in interpret mode (jit, where XLA
  contracts FMAs), measured on this tree over the full-range samples:
  sin and cos within 2^-23 absolute (one rounding at the scale of the core
  tables' values, which lie in [-1, 1]; measured 2^-24), exp within 2 ULP of
  |y| (the core lerp's one rounding at its scale, at most twice |exp_core|,
  scaled exactly by 2^k; measured 1 ULP), log within 4 ULP at
  ``max(|y|, 0.5)`` (the lerp's and the two reconstruction sums' roundings;
  measured 9 ULP of |y| near x = 1, 2.4e-7 absolute); slopes bitwise on
  finite inputs (products only, no contraction), XLA's flushed subnormals
  aside.  At non-finite x the reference's jitted kernel gives a log slope of
  0 where its eager oracle and the port give NaN, so slopes are compared on
  finite x there;
* the full-range Ea contract holds for the port (``differential_report``
  with the port as ``impl``): sin / cos / log absolute, exp relative;
* gradients through ``make_folded_fn``, ``make_folded_routed_unary_fn`` and
  ``ApproxConfig.unary``: exactly ``slope * dy``, and bitwise equal to the
  reference's VJP of its ``custom_jvp`` in the plain mode;
* model: reduced stablelm (2 layers, d=64, f32 compute) with ``rope_table``
  serves the mixed-EOS queue token-identical to the JAX ContinuousEngine in
  the same mode, with prefill logits within 1e-4 (the bound of
  tests/test_torch_model.py), and trains 2 steps with losses within 1e-4
  relative and grad norms within 1e-3 (tests/test_torch_train.py).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harness.fullrange import FOLDED_FUNCS, differential_report, fullrange_samples
from repro.approx import ApproxConfig as JApprox
from repro.approx import range_fold as rf_ref
from repro.core import range_reduce as rr_ref
from repro.kernels.table_pack_lookup import (folded_pack_grad_pallas,
                                             folded_pack_lookup_pallas)
from repro_torch import approx as port_approx
from repro_torch.approx import (FOLDED_CORE_MEMBERS, FOLDED_MODES, SHARDED_MODES,
                                TABLE_MODES, ApproxConfig, range_fold, table_pack)
from repro_torch.core import range_reduce as rr
from repro_torch.kernels import _lib
from repro_torch.kernels import table_pack_lookup as K

EA = 1e-4  # stablelm-3b's own settings: e_a 1e-4, omega 0.2
OMEGA = 0.2
TINY = np.finfo(np.float32).tiny
SPECIALS = np.float32([np.inf, -np.inf, np.nan, 0.0, -0.0])


def normal_samples(seed=0, fast=True):
    """The full-range samples without subnormals, plus the specials."""
    x = fullrange_samples(fast=fast, seed=seed)
    x = x[(np.abs(x) >= TINY) | (x == 0)]
    return np.concatenate([SPECIALS, x]).astype(np.float32)


def subnormal(a):
    a = np.asarray(a)
    return (np.abs(a) < TINY) & (a != 0)


def assert_eager_bitwise(got, want):
    """Bitwise, NaN positions matched; a port subnormal may meet XLA's 0."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    same = (got.view(np.int32) == want.view(np.int32)) | (np.isnan(got) & np.isnan(want))
    flushed = subnormal(got) & (want == 0)
    assert (same | flushed).all(), (got[~(same | flushed)][:5], want[~(same | flushed)][:5])


def assert_bitwise(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    same = (got.view(np.int32) == want.view(np.int32)) | (np.isnan(got) & np.isnan(want))
    assert same.all()


# --------------------------------------------------------------------------------------
# packs, built once per module on both sides
# --------------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def packs():
    return (JApprox(mode="folded_pack", e_a=EA, omega=OMEGA).pack(),
            ApproxConfig(mode="folded_pack", e_a=EA, omega=OMEGA).pack("cpu"))


# --------------------------------------------------------------------------------------
# 1. range reduction
# --------------------------------------------------------------------------------------


def test_trig_fold_bitwise_both_regimes():
    x = normal_samples(seed=1, fast=False)
    x = x[np.isfinite(x)]
    assert (np.abs(x) >= rr.TRIG_CW_MAX).sum() > 1000  # Payne-Hanek lanes
    assert (np.abs(x) < rr.TRIG_CW_MAX).sum() > 1000  # Cody-Waite lanes
    r, q, sflip = rr.trig_fold(torch.from_numpy(x))
    jr, jq, js = rr_ref.trig_fold(jnp.asarray(x))
    assert r.dtype == torch.float32 and q.dtype == torch.int32
    assert_bitwise(r.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(sflip.numpy(), np.asarray(js))
    # the fold is the identity on the canonical interval
    core = np.float32(np.random.default_rng(0).uniform(-0.78, 0.78, 500))
    r, q, sflip = rr.trig_fold(torch.from_numpy(core))
    assert_bitwise(r.numpy(), core)
    assert not q.any() and not sflip.any()


def test_payne_hanek_and_shift_bitwise():
    rng = np.random.default_rng(2)
    ax = np.float32(np.exp(rng.uniform(np.log(2048.0), np.log(3.3e38), 4000)))
    r, q = rr._payne_hanek(torch.from_numpy(ax))
    jr, jq = rr_ref._payne_hanek(jnp.asarray(ax))
    assert_bitwise(r.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    v = rng.integers(0, 1 << 28, 2000)
    s = rng.integers(-40, 41, 2000)
    got = rr._shift_mod32(torch.from_numpy(v), torch.from_numpy(s)).numpy()
    want = np.asarray(rr_ref._shift_mod32(jnp, jnp.asarray(v, jnp.uint32),
                                          jnp.asarray(s, jnp.int32)))
    np.testing.assert_array_equal(got, want.astype(np.int64))


def test_exp_fold_and_reconstruct_bitwise():
    x = normal_samples(seed=3)
    x = x[np.isfinite(x)]
    r, k = rr.exp_fold(torch.from_numpy(x))
    jr, jk = rr_ref.exp_fold(jnp.asarray(x))
    assert_bitwise(r.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(k.numpy(), np.asarray(jk))
    assert int(k.min()) == -rr.EXP_K_MAX and int(k.max()) == rr.EXP_K_MAX
    kk = np.arange(-252, 253, dtype=np.int32)
    y = np.float32(np.random.default_rng(4).uniform(0.69, 1.44, kk.size))
    got = rr.exp_reconstruct(torch.from_numpy(y), torch.from_numpy(kk)).numpy()
    assert_eager_bitwise(got, rr_ref.exp_reconstruct(jnp.asarray(y), jnp.asarray(kk)))
    assert np.isinf(got[-1]) and got[0] == 0.0 and subnormal(got).any()
    np.testing.assert_array_equal(rr.pow2(torch.arange(-126, 128)).numpy(),
                                  np.float32(2.0) ** np.arange(-126, 128, dtype=np.float32))


def test_log_fold_bitwise_with_subnormals():
    x = fullrange_samples(fast=False, seed=5)
    x = np.concatenate([SPECIALS, x]).astype(np.float32)
    assert subnormal(x).sum() > 500
    m, e = rr.log_fold(torch.from_numpy(x))
    jm, je = rr_ref.log_fold(jnp.asarray(x))
    assert_bitwise(m.numpy(), np.asarray(jm))
    assert_bitwise(e.numpy(), np.asarray(je))
    pos = (x > 0) & np.isfinite(x)
    mm, ee = m.numpy()[pos].astype(np.float64), e.numpy()[pos].astype(np.float64)
    np.testing.assert_array_equal(mm * 2.0 ** ee, x[pos])  # x = m * 2^e exactly


@pytest.mark.parametrize("kind", ["sin", "cos"])
def test_trig_reconstructions_and_edges_bitwise(kind):
    rng = np.random.default_rng(6)
    x = normal_samples(seed=6)
    ys, yc = (np.float32(rng.uniform(-1, 1, x.size)) for _ in range(2))
    r, q, sflip = rr.trig_fold(torch.from_numpy(x))
    jr, jq, js = rr_ref.trig_fold(jnp.asarray(x))
    t = lambda a: torch.from_numpy(a)
    got = rr.trig_edges(t(x), rr.trig_reconstruct(kind, t(ys), t(yc), q, sflip))
    want = rr_ref.trig_edges(jnp.asarray(x), rr_ref.trig_reconstruct(
        kind, jnp.asarray(ys), jnp.asarray(yc), jq, js))
    fin = np.isfinite(x)  # q of a non-finite lane is garbage on both sides
    assert_bitwise(got.numpy()[fin], np.asarray(want)[fin])
    assert np.isnan(got.numpy()[~fin]).all()
    got = rr.trig_slope_reconstruct(kind, t(ys), t(yc), q, sflip)
    want = rr_ref.trig_slope_reconstruct(kind, jnp.asarray(ys), jnp.asarray(yc), jq, js)
    assert_bitwise(got.numpy()[fin], np.asarray(want)[fin])


def test_exp_log_reconstruct_and_edges_bitwise():
    rng = np.random.default_rng(7)
    x = normal_samples(seed=7)
    y = np.float32(rng.uniform(-3, 3, x.size))
    e = np.float32(rng.integers(-149, 128, x.size))
    t = torch.from_numpy
    assert_bitwise(rr.exp_edges(t(x), t(y)).numpy(),
                   np.asarray(rr_ref.exp_edges(jnp.asarray(x), jnp.asarray(y))))
    assert_bitwise(rr.log_edges(t(x), t(y)).numpy(),
                   np.asarray(rr_ref.log_edges(jnp.asarray(x), jnp.asarray(y))))
    assert_bitwise(rr.log_reconstruct(t(y), t(e)).numpy(),
                   np.asarray(rr_ref.log_reconstruct(jnp.asarray(y), jnp.asarray(e))))
    with pytest.raises(ValueError, match="sin/cos"):
        rr.quadrant_select("tan", t(y), t(y), t(e).to(torch.int32))


def test_constants_match_reference():
    for name in ("PIO2_HI", "PIO2_MID", "PIO2_LO", "TWO_OVER_PI", "TRIG_CW_MAX",
                 "PH_SCALE", "PH_LIMBS", "LN2_HI", "LN2_LO", "INV_LN2", "EXP_K_MAX",
                 "SQRT2", "SIN_CORE_INTERVAL", "COS_CORE_INTERVAL",
                 "EXP_CORE_INTERVAL", "LOG_CORE_INTERVAL"):
        got, want = getattr(rr, name), getattr(rr_ref, name)
        assert type(got) is type(want) and got == want, name


# --------------------------------------------------------------------------------------
# 2. plain versions against the eager oracles and the interpret-mode kernels
# --------------------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", FOLDED_FUNCS)
def test_folded_plain_bitwise_vs_eager_oracle(packs, name, dtype):
    jp, tp = packs
    x = normal_samples(seed=8, fast=False)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    xt, xj = torch.from_numpy(x).to(tdt), jnp.asarray(x, jdt)
    y = range_fold.eval_folded_ref(tp, name, xt)
    s = range_fold.eval_folded_slope(tp, name, xt)
    assert y.dtype == s.dtype == torch.float32  # as the reference: f32 out
    assert_eager_bitwise(y.numpy(), rf_ref.eval_folded_ref(jp, name, xj))
    assert_eager_bitwise(s.numpy(), rf_ref.eval_folded_slope(jp, name, xj))
    # the CPU wrappers: the plain version in x's dtype, no launch
    _lib.reset_launches()
    ky = K.folded_pack_lookup(tp, name, xt)
    gy, gs = K.folded_pack_grad(tp, name, xt)
    assert ky.dtype == gy.dtype == gs.dtype == tdt
    for got, want in ((ky, y), (gy, y), (gs, s)):
        assert torch.equal(torch.nan_to_num(got, 7.0), torch.nan_to_num(want.to(tdt), 7.0))
    assert not any(_lib.launches.values())


def _interp_tolerance(name, want):
    """The stated bound against the interpret-mode kernels (module
    docstring), per element."""
    if name in ("sin", "cos"):
        return np.full(want.shape, 2.0 ** -23)
    if name == "exp":
        return 2 * np.spacing(np.abs(want).astype(np.float32)).astype(np.float64)
    return 4 * np.spacing(np.maximum(np.abs(want), 0.5).astype(np.float32)).astype(
        np.float64)


def _assert_within_interp(name, got, want, slope=False, x=None):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if slope:  # compared on finite x (module docstring)
        fin = np.isfinite(x)
        got, want = got[fin], want[fin]
        assert_eager_bitwise(got, want)
        return
    assert (np.isnan(got) == np.isnan(want)).all()
    inf = np.isinf(got) | np.isinf(want)
    assert (got[inf] == want[inf]).all()
    flushed = subnormal(got) & (want == 0)
    keep = np.isfinite(got) & ~flushed
    d = np.abs(got[keep].astype(np.float64) - want[keep])
    assert (d <= _interp_tolerance(name, want[keep])).all(), (name, d.max())


@pytest.mark.parametrize("name", FOLDED_FUNCS)
def test_folded_plain_within_tolerance_of_interpret_kernels(packs, name):
    jp, tp = packs
    x = normal_samples(seed=9)
    pad = (-x.size) % 256
    xp = jnp.asarray(np.pad(x, (0, pad)).reshape(1, -1))
    ky = np.asarray(folded_pack_lookup_pallas(jp, name, xp))[0, : x.size]
    gy, gs = (np.asarray(v)[0, : x.size] for v in folded_pack_grad_pallas(jp, name, xp))
    np.testing.assert_array_equal(gy, ky)  # the reference's two kernels agree
    xt = torch.from_numpy(x)
    _assert_within_interp(name, K.folded_pack_lookup(tp, name, xt), ky)
    _assert_within_interp(name, K.folded_pack_grad(tp, name, xt)[1], gs, slope=True, x=x)


@pytest.mark.parametrize("name", FOLDED_FUNCS)
def test_folded_routed_plain_and_kernel_shapes(packs, name):
    """The routed shape: the port's kernel path (on the CPU, the routed
    wrapper's plain version) and its plain path are bitwise equal to each
    other, to the static folded plain version and to the reference's eager
    routed shape; within the stated bound of its interpret-mode one."""
    jp, tp = packs
    x = normal_samples(seed=10)[:1400].reshape(-1, 7)
    xt, xj = torch.from_numpy(np.ascontiguousarray(x)), jnp.asarray(x)
    got_k = range_fold.eval_folded_routed(tp, name, xt, use_kernel=True)
    got_p = range_fold.eval_folded_routed(tp, name, xt, use_kernel=False)
    assert got_k.shape == x.shape
    assert torch.equal(torch.nan_to_num(got_k, 7.0), torch.nan_to_num(got_p, 7.0))
    assert_bitwise(got_k.numpy(), range_fold.eval_folded_ref(tp, name, xt).numpy())
    assert_eager_bitwise(got_p.numpy(), rf_ref.eval_folded_routed(jp, name, xj,
                                                                   use_pallas=False))
    want = rf_ref.eval_folded_routed(jp, name, xj, use_pallas=True)
    _assert_within_interp(name, got_k.numpy(), want)


@pytest.mark.parametrize("name", FOLDED_FUNCS)
def test_fold_image_covers_every_read(packs, name):
    """The kind's staging image (``TablePack.fold_images``, what a block of
    the folded kernels stages on the card) holds every float the folded
    lookup reads: its rebased core rows address the same floats as the
    pack's rows, and with every value of the pack outside the image's span
    poisoned with NaN the plain value and slope keep their bits over the
    full-range samples (subnormals and the specials included)."""
    _, tp = packs
    image, m_img = tp.fold_images[name]
    img = image.numpy()
    cores = [tp.fn_id(c) for c in range_fold.FOLDABLE[name]]
    starts, v_at = table_pack.member_image_layout([tp.n_intervals[f] for f in cores])
    assert image.dtype == torch.float32 and image.is_contiguous()
    assert img.size % 4 == 0 and v_at + m_img <= img.size < v_at + m_img + 4
    vals, v0 = img[v_at: v_at + m_img], set()
    for f, at in zip(cores, starts):
        n = tp.n_intervals[f]
        rows = [img[at: at + n + 1]] + [img[at + n + 1 + k * n: at + 2 * n + 1 + k * n]
                                        for k in range(3)]
        assert_bitwise(rows[0], tp.boundaries[f, : n + 1].numpy())
        assert_bitwise(rows[1], tp.inv_delta[f, :n].numpy())
        assert_bitwise(rows[3], tp.seg_count[f, :n].numpy())
        pbase = tp.base[f, :n].numpy()
        v0 |= set((pbase - rows[2]).tolist())
        for j in range(n):  # every cell's values, from the image and the pack
            k = np.arange(int(rows[3][j]) + 1)
            assert_bitwise(vals[int(rows[2][j]) + k], tp.values.numpy()[int(pbase[j]) + k])
    (v0,) = v0  # one shift rebases every core row
    poisoned = tp.values.clone()
    poisoned[: int(v0)] = float("nan")
    poisoned[int(v0) + m_img:] = float("nan")
    bad = dataclasses.replace(tp, values=poisoned)
    x = torch.from_numpy(np.concatenate([SPECIALS, fullrange_samples(fast=True, seed=12)]))
    for fn in (range_fold.eval_folded_ref, range_fold.eval_folded_slope):
        assert_bitwise(fn(bad, name, x).numpy(), fn(tp, name, x).numpy())


def test_folded_routed_plain_members_fall_through(packs):
    jp, tp = packs
    x = np.float32(np.random.default_rng(11).normal(0, 3, (3, 40)))
    for name in ("gelu", "tanh"):
        got = range_fold.eval_folded_routed(tp, name, torch.from_numpy(x),
                                            use_kernel=True, extrapolate=True)
        assert_bitwise(got.numpy(), rf_ref.eval_folded_routed(
            jp, name, jnp.asarray(x), use_pallas=False, extrapolate=True))
        assert_bitwise(range_fold.eval_folded_ref(tp, name, torch.from_numpy(x)).numpy(),
                       np.asarray(rf_ref.eval_folded_ref(jp, name, jnp.asarray(x))))
        assert torch.equal(  # the kernel-side dispatch: the plain pack kernel
            range_fold.folded_lookup(tp, name, torch.from_numpy(x), extrapolate=True),
            K.table_pack_lookup(tp, name, torch.from_numpy(x), extrapolate=True))
    for name in FOLDED_FUNCS:  # ... and the fused folded kernel
        xt = torch.from_numpy(np.abs(x))
        assert torch.equal(range_fold.folded_lookup(tp, name, xt),
                           K.folded_pack_lookup(tp, name, xt))


def test_folded_errors(packs):
    _, tp = packs
    x = torch.ones(4)
    with pytest.raises(KeyError, match=r"folded kernel serves \['cos', 'exp', 'log', "
                                       r"'sin'\], got 'gelu'"):
        K.folded_pack_lookup(tp, "gelu", x)
    with pytest.raises(KeyError, match="folded kernel serves"):
        K.folded_pack_grad(tp, "tanh", x)
    plain = ApproxConfig(mode="table_pack", e_a=EA, omega=OMEGA).pack("cpu")
    for f in (range_fold.eval_folded_ref, range_fold.eval_folded_slope):
        with pytest.raises(KeyError, match=r"needs core members \['sin_core', "
                                           r"'cos_core'\]"):
            f(plain, "sin", x)
    with pytest.raises(KeyError, match="exp_core"):
        range_fold.make_folded_fn(plain, "exp")
    with pytest.raises(KeyError, match="log_core"):
        range_fold.make_folded_routed_unary_fn(plain, "log")
    with pytest.raises(KeyError, match="sin_core"):  # the kernel's fn_id lookup
        K.folded_pack_lookup(plain, "cos", x)


def test_fullrange_ea_contract(packs):
    """sin/cos/exp/log meet their Ea contracts over the 10^+-38 log-spaced
    samples (subnormal inputs included) through the port's folded unary."""
    x = fullrange_samples(fast=True)
    for mode in ("folded_pack", "folded_pack_ref", "folded_routed_pack"):
        cfg = ApproxConfig(mode=mode, e_a=EA)
        for name in FOLDED_FUNCS:
            f = cfg.unary(name, "cpu")
            rep = differential_report(
                name, lambda v, _f=f: _f(torch.from_numpy(v)).numpy(), x, EA)
            assert rep["passed"], (mode, name, rep["max_err"], rep["worst_x"],
                                   rep["n_edge_fail"])
            assert rep["n_checked"] > 0.45 * x.size  # log: the positive lanes


# --------------------------------------------------------------------------------------
# 3. closures, gradients, ApproxConfig
# --------------------------------------------------------------------------------------


def _grad(f, x, dy):
    x = x.clone().requires_grad_(True)
    y = f(x)
    y.backward(dy)
    return y.detach(), x.grad


def _finite_inputs(seed):
    x = normal_samples(seed=seed)
    x = x[np.isfinite(x)]
    x = np.concatenate([x[np.abs(x) < 1e4], x[np.abs(x) >= 1e4][:200]])
    return x, np.float32(np.random.default_rng(seed).normal(0, 1, x.size))


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("name", FOLDED_FUNCS)
def test_make_folded_fn_values_and_grads(packs, name, use_kernel):
    jp, tp = packs
    x, dy = _finite_inputs(12)
    if name == "log":
        x = np.abs(x) + np.float32(1e-3)
    xt, dyt = torch.from_numpy(x), torch.from_numpy(dy)
    for make in (range_fold.make_folded_fn, range_fold.make_folded_routed_unary_fn):
        f = make(tp, name, use_kernel=use_kernel)
        y, g = _grad(f, xt, dyt)
        want_y, want_s = K.folded_pack_grad_plain(tp, name, xt)
        assert torch.equal(y, want_y) and torch.equal(g, want_s * dyt)
        with torch.inference_mode():  # no gradient recorded: the value path
            assert torch.equal(f(xt), want_y)
        jy, vjp = jax.vjp(rf_ref.make_folded_fn(jp, name, use_pallas=False),
                          jnp.asarray(x))
        assert_eager_bitwise(y.numpy(), jy)
        assert_eager_bitwise(g.numpy(), vjp(jnp.asarray(dy))[0])
        d1 = lambda v: torch.cos(v)  # exact_d1 is honoured
        _, g = _grad(make(tp, name, use_kernel=use_kernel, exact_d1=d1), xt, dyt)
        assert torch.equal(g, torch.cos(xt) * dyt)


def test_non_foldable_names_fall_through(packs):
    _, tp = packs
    rng = np.random.default_rng(13)
    x = torch.from_numpy(np.float32(rng.normal(0, 3, 300)))
    dy = torch.from_numpy(np.float32(rng.normal(0, 1, 300)))
    for name in ("gelu", "silu", "tanh"):
        for uk in (True, False):
            a = _grad(range_fold.make_folded_fn(tp, name, use_kernel=uk,
                                                extrapolate=True), x, dy)
            b = _grad(range_fold.make_folded_routed_unary_fn(
                tp, name, use_kernel=uk, extrapolate=True), x, dy)
            want = (K.table_pack_lookup_plain(tp, name, x, extrapolate=True),
                    K.table_pack_grad_plain(tp, name, x, extrapolate=True)[1] * dy)
            for got in (a, b):
                assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_folded_modes_are_ported():
    assert FOLDED_MODES == ("folded_pack", "folded_pack_ref", "folded_routed_pack",
                            "folded_routed_pack_ref")
    for mode in FOLDED_MODES + SHARDED_MODES:
        assert mode in TABLE_MODES
    # the sharded modes were the last ones left to port: no refusal table
    assert SHARDED_MODES == ("sharded_pack", "sharded_pack_ref")
    assert not hasattr(port_approx, "NOT_PORTED")
    for mode in FOLDED_MODES + ("table_pack",):
        names = ApproxConfig(mode=mode, e_a=EA, omega=OMEGA,
                             rope_table=mode == "table_pack").pack("cpu").names
        assert names[-4:] == FOLDED_CORE_MEMBERS
    assert "sin_core" not in ApproxConfig(mode="table_pack").pack("cpu").names
    # cores already listed are not appended twice
    a = ApproxConfig(mode="folded_pack", pack_functions=("gelu", "exp_core"))
    assert a.pack("cpu").names == ("gelu", "exp_core", "sin_core", "cos_core", "log_core")


@pytest.mark.parametrize("mode", FOLDED_MODES)
def test_unary_matches_reference(mode, packs):
    """ApproxConfig.unary in every folded mode, value and gradient, bitwise
    against the reference's eager plain mode: foldable names keep their
    identity ("exp" is the folded exp, not exp_neg), the others are the pack
    members (odd extension and remaps included)."""
    jmode = "folded_routed_pack_ref" if "routed" in mode else "folded_pack_ref"
    x, dy = _finite_inputs(14)
    x = x[np.abs(x) < 50]
    dy = dy[: x.size]
    cfg = ApproxConfig(mode=mode, e_a=EA, omega=OMEGA)
    for name in ("sin", "cos", "exp", "log", "gelu", "silu", "tanh", "sigmoid"):
        xi = np.abs(x) + np.float32(1e-3) if name == "log" else x
        y, g = _grad(cfg.unary(name, "cpu"), torch.from_numpy(xi), torch.from_numpy(dy))
        jy, vjp = jax.vjp(JApprox(mode=jmode, e_a=EA, omega=OMEGA).unary(name),
                          jnp.asarray(xi))
        assert_eager_bitwise(y.numpy(), jy)
        assert_eager_bitwise(g.numpy(), vjp(jnp.asarray(dy))[0])
    # exp in a folded mode is the full-range exp, not the exp_neg clamp
    big = torch.tensor([3.0, 10.0, 80.0])
    assert torch.allclose(cfg.unary("exp", "cpu")(big), torch.exp(big), rtol=2e-4)
    with pytest.raises(KeyError, match="pack_functions"):
        cfg.unary("softplus_nope", "cpu")


@pytest.mark.parametrize("mode", ["folded_pack", "folded_pack_ref", "table_pack_ref"])
def test_softmax_matches_reference(mode):
    """``softmax`` with ``softmax_table``: the folded modes take exp over the
    whole shifted range (no -16 clamp), the others clamp into exp_neg's
    domain; value and gradient bitwise against the reference's plain mode.
    The shift is a constant to the gradient (the reference's stop_gradient)."""
    jmode = mode if mode.endswith("_ref") else mode + "_ref"
    rng = np.random.default_rng(15)
    x = np.float32(rng.normal(0, 8, (4, 33)))
    where = rng.uniform(size=x.shape) > 0.2
    dy = np.float32(rng.normal(0, 1, x.shape))
    cfg = ApproxConfig(mode=mode, e_a=EA, omega=OMEGA, softmax_table=True)
    jcfg = JApprox(mode=jmode, e_a=EA, omega=OMEGA, softmax_table=True)
    for w in (None, where):
        f = lambda v: cfg.softmax(v, where=None if w is None else torch.from_numpy(w),
                                  device="cpu")
        y, g = _grad(f, torch.from_numpy(x), torch.from_numpy(dy))
        jy, vjp = jax.vjp(lambda v: jcfg.softmax(v, where=w), jnp.asarray(x))
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(g.numpy(), np.asarray(vjp(jnp.asarray(dy))[0]),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode", ["table_pack", "table_pack_ref", "quant_pack",
                                  "routed_poly_pack_ref", "folded_pack",
                                  "folded_routed_pack_ref", "table_pallas"])
def test_rope_sin_cos_matches_reference(mode):
    """rope_sin_cos in any table mode: the folded trig of the f32 pack (with
    the cores appended), cached per configuration and device; bitwise against
    the reference's eager folded trig and within the stated bound of its
    interpret-mode kernel."""
    cfg = ApproxConfig(mode=mode, e_a=EA, omega=OMEGA, rope_table=True)
    sc = cfg.rope_sin_cos("cpu")
    assert sc is cfg.rope_sin_cos("cpu")
    positions = np.arange(0, 4096, 3, dtype=np.float32)
    freqs = 1.0 / (10_000.0 ** (np.arange(0, 80, 2, dtype=np.float32) / 80))
    ang = np.float32(positions[:, None] * freqs)
    s, c = sc(torch.from_numpy(ang))
    jp = JApprox(mode="folded_pack", e_a=EA, omega=OMEGA).pack()
    for got, name in ((s, "sin"), (c, "cos")):
        assert_eager_bitwise(got.numpy(), rf_ref.eval_folded_ref(jp, name, jnp.asarray(ang)))
        assert float(np.abs(got.numpy() - getattr(np, name)(ang.astype(np.float64))).max()) \
            <= EA * 1.02 + 1e-5
    jsc = JApprox(mode="table_pack", e_a=EA, omega=OMEGA, rope_table=True).rope_sin_cos()
    jflat = jnp.asarray(ang.reshape(1, -1))
    js, jc = jsc(jflat)
    _assert_within_interp("sin", s.numpy().reshape(1, -1), js)
    _assert_within_interp("cos", c.numpy().reshape(1, -1), jc)
    assert ApproxConfig(mode="exact", rope_table=True).rope_sin_cos("cpu") is None
    assert ApproxConfig(mode=mode).rope_sin_cos("cpu") is None


# --------------------------------------------------------------------------------------
# 4. the model, serving and training, against the reference
# --------------------------------------------------------------------------------------


def _pair(mode, rope=True, attn=True):
    from repro.models import build_model as j_build_model
    from repro_torch.convert import params_from_jax
    from repro_torch.models import build_model, reduced
    from tests.test_archs import reduced as j_reduced

    kw = dict(mode=mode, e_a=EA, omega=OMEGA, attn_table=attn, rope_table=rope)
    jm = j_build_model(j_reduced("stablelm-3b").replace(
        compute_dtype="float32", approx=JApprox(**kw)))
    tm = build_model(reduced("stablelm-3b").replace(
        compute_dtype="float32", approx=ApproxConfig(**kw)), device="cpu")
    jp = jm.init(jax.random.key(0))
    return jm, jp, tm, params_from_jax(tm.cfg, jax.tree.map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("mode", ["folded_pack", "folded_routed_pack", "table_pack"])
def test_rope_table_serving_matches_reference(mode):
    from repro.serving.engine import ContinuousEngine as JContinuousEngine
    from repro_torch.serving.engine import ContinuousEngine
    from tests.test_serving import mixed_requests

    jm, jp, tm, tp = _pair(mode)
    assert tm.rope_sin_cos is not None
    rng = np.random.default_rng(16)
    toks = rng.integers(0, tm.cfg.vocab, (2, 11)).astype(np.int32)
    jl, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, jm.init_cache(2, 64))
    with torch.inference_mode():
        tl, _ = tm.prefill(tp, {"tokens": torch.from_numpy(toks).long()},
                           tm.init_cache(2, 64))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    want = JContinuousEngine(jm, jp, batch_size=2, cache_len=64).serve(
        mixed_requests(np.random.default_rng(3), 8))
    _lib.reset_launches()
    got = ContinuousEngine(tm, tp, batch_size=2, cache_len=64).serve(
        mixed_requests(np.random.default_rng(3), 8))
    assert not any(_lib.launches.values())  # CPU tensors: plain versions only
    for i, (a, b) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(b.tokens, a.tokens, err_msg=f"req {i}")


@pytest.mark.parametrize("mode", ["folded_pack", "table_pack"])
def test_rope_table_training_matches_reference(mode):
    from repro.optim import adamw as j_adamw
    from repro.train.loop import make_train_step as j_make_train_step
    from repro_torch.convert import train_state_from_jax
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.optim import adamw
    from repro_torch.train.loop import batch_to, make_train_step

    jm, jp, tm, _ = _pair(mode)
    opt = dict(lr=1e-3, warmup_steps=1, total_steps=2)
    jstate = {"params": jp, "opt": j_adamw.init(jp), "step": jnp.zeros((), jnp.int32)}
    tstate = train_state_from_jax(tm.cfg, jax.tree.map(np.asarray, jstate), "cpu")
    jstep = jax.jit(j_make_train_step(jm, j_adamw.AdamWConfig(**opt), accum=2))
    tstep = make_train_step(tm, adamw.AdamWConfig(**opt), accum=2)
    data = SyntheticLM(DataConfig(vocab=tm.cfg.vocab, global_batch=4, seq_len=16))
    jl, tl = [], []
    for s in range(2):
        b = data.batch_at(s)
        jstate, jmet = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tmet = tstep(tstate, batch_to(b, "cpu"))
        jl.append(float(jmet["loss"]))
        tl.append(float(tmet["loss"]))
        gt, gj = float(tmet["grad_norm"]), float(jmet["grad_norm"])
        assert abs(gt - gj) <= 1e-3 * abs(gj)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert all(math.isfinite(v) for v in tl)


# --------------------------------------------------------------------------------------
# launchers
# --------------------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["folded_pack", "folded_routed_pack_ref", "table_pack"])
def test_serve_cli_rope_table(mode, capsys):
    from repro_torch.launch.serve import main

    res = main(["--arch", "stablelm-3b", "--reduced", "--device", "cpu",
                "--requests", "3", "--batch", "2", "--max-new", "3",
                "--approx-mode", mode, "--rope-table", "--attn-table"])
    assert [r.steps for r in res] == [3, 3, 3]
    assert "served 3 requests, 9 tokens on cpu" in capsys.readouterr().out


@pytest.mark.parametrize("mode", ["folded_pack", "table_pack_ref"])
def test_train_cli_rope_table(mode, tmp_path, capsys):
    from repro_torch.launch import train

    out = train.main(["--arch", "stablelm-3b", "--reduced", "--device", "cpu",
                      "--steps", "2", "--batch", "4", "--seq", "16", "--accum", "2",
                      "--approx-mode", mode, "--rope-table", "--attn-table",
                      "--ckpt-dir", str(tmp_path)])
    assert "done: step=2 loss" in capsys.readouterr().out
    assert all(np.isfinite(out["losses"]))


def test_rope_table_threads_into_the_model():
    from repro_torch.models import build_model, reduced

    base = reduced("stablelm-3b")
    on = build_model(base.replace(approx=dataclasses.replace(
        base.approx, mode="table_pack", rope_table=True)), device="cpu")
    off = build_model(base.replace(approx=dataclasses.replace(
        base.approx, mode="table_pack")), device="cpu")
    assert on.rope_sin_cos is not None and off.rope_sin_cos is None
