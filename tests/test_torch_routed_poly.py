"""The port's routed PolyPack (per-row fn_id over the polynomial pack) against
the JAX reference, on the same numpy inputs.

Contract (tolerances stated with their reason):

* the routing operands (``routing_scalars``: interval counts, boundary and
  lane offsets, code widths and coefficient strides) and the layout's offsets
  are the reference's, value for value;
* plain versions (``eval_routed_poly_ref`` / ``_slope`` and the CPU
  wrappers): bitwise equal to the reference's EAGER oracles and row for row
  to the port's static poly dispatch of the row's member, on mixed rows with
  extrapolation off, on and per member, in f32 and bf16, over stablelm-3b's
  poly pack and the reference's mixed-degree, mixed-width pack.  Slopes are
  compared on finite inputs (tests/test_torch_quant_poly.py gives the
  reason);
* against the reference's routed poly kernels in interpret mode: values
  within 4 ULP at the scale of the largest Horner intermediate, times
  ``1 + |t - clip(t, 0, 1)|`` past the cell grid, and slopes within
  ``rtol=1e-5, atol=1e-7`` (the bounds and reasons of
  tests/test_torch_quant_poly.py: XLA contracts the dequantization and each
  Horner step into FMAs there);
* gradients through ``make_routed_fn`` / ``make_routed_unary_fn`` /
  ``ApproxConfig``: exactly ``slope * dy``, and bitwise equal to the
  reference's VJP of its ``custom_jvp`` in its plain mode;
* inputs are normal floats or zero (XLA on the CPU flushes subnormal inputs);
* model: reduced stablelm (2 layers, d=64, f32 compute) in
  ``routed_poly_pack`` serves the mixed-EOS queue token-identical to the JAX
  ContinuousEngine, and 2 train steps give losses within 1e-4 relative and
  grad norms within 1e-3 (tests/test_torch_train.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.approx import ApproxConfig as JApprox
from repro.approx import table_pack as tp_ref
from repro.core import design as j_design
from repro.core import packing as j_packing
from repro.kernels.routed_pack_lookup import (routed_poly_pack_grad_pallas,
                                              routed_poly_pack_lookup_pallas)
from repro_torch.approx import ROUTED_MODES, ApproxConfig, table_pack
from repro_torch.core import design, packing
from repro_torch.kernels import _lib
from repro_torch.kernels import routed_pack_lookup as R
from repro_torch.kernels import table_pack_lookup as K
from tests.test_torch_quant_poly import _poly_scale
from tests.test_torch_routed import (FLAGS, _flags, assert_bitwise,
                                     assert_image_covers_every_read, image_sections,
                                     mixed_rows, row_inputs)

NAMES = ("gelu", "silu", "tanh", "sigmoid_sym", "softplus", "exp_neg")
EA = 1e-4  # stablelm-3b's own settings: e_a 1e-4, omega 0.2
OMEGA = 0.2
# one member per degree, each at another code width (the reference's
# tests/test_poly_pack.py MIXED pack)
MIXED = (("tanh", 1, 32), ("exp_neg", 3, 8), ("gelu", 2, 16))
SLOTS = ("gelu", "silu", "tanh", "sigmoid", "softplus", "exp")


@pytest.fixture(scope="module")
def poly():
    return (tp_ref.build_poly_pack(NAMES, EA, omega=OMEGA),
            table_pack.build_poly_pack(NAMES, EA, omega=OMEGA, device="cpu"))


@pytest.fixture(scope="module")
def mixed():
    j = j_packing.poly_pack_layout(
        [j_design.poly_member(n, EA, degree=d, bits=b) for n, d, b in MIXED])
    t = packing.poly_pack_layout(
        [design.poly_member(n, EA, degree=d, bits=b) for n, d, b in MIXED])
    return tp_ref.from_poly_layout(j), table_pack.from_poly_layout(t, "cpu"), j, t


KINDS = ("poly", "mixed")


def _packs(kind, request):
    got = request.getfixturevalue(kind)
    return got[0], got[1]


# --------------------------------------------------------------------------------------
# routing operands
# --------------------------------------------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
def test_routing_scalars_match_reference(kind, request):
    jp, tp = _packs(kind, request)
    got, want = tp.routing_scalars(), jp.routing_scalars()
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and g.device == tp.device
        np.testing.assert_array_equal(g.numpy(), w)
    assert tp.routing_scalars() is tp.routing_scalars()  # built once, with the pack
    assert got[4].tolist() == [d + 1 for d in tp.degrees]


def test_layout_offsets_match_reference(mixed):
    *_, j, t = mixed
    np.testing.assert_array_equal(t.bounds_offsets, j.bounds_offsets)
    np.testing.assert_array_equal(t.lane_offsets, j.lane_offsets)
    assert t.bounds_offsets.dtype == t.lane_offsets.dtype == np.int32
    assert set(t.entry_bits) == {8, 16, 32} and len(set(t.degrees)) == 3


@pytest.mark.parametrize("reader", ["routed", "static"])
@pytest.mark.parametrize("kind", KINDS)
def test_staging_image_covers_every_read(kind, reader, request):
    """The pack's staging image (``PolyTablePack.image``, what a block of the
    routed poly kernels, and of the static poly kernels, stages on the card
    where it fits) holds every value they read: its routing sections are the
    routing operands, and a pack whose planes and code groups are all read
    from the image's sections (nothing of the pack outside them) gives the
    routed plain value and slope, or each member's static ones, with the
    same bits, extrapolation off, on and per member."""
    _, tp = _packs(kind, request)
    rebuilt = image_sections(
        tp, table_pack.POLY_IMAGE_SECTIONS,
        table_pack.poly_image_layout(tp.n_functions, tp.inv_delta.shape[0],
                                     tp.max_lanes, tp.codes8.shape[0],
                                     tp.codes16.shape[0], tp.codes32.shape[0]),
        ("boundaries", "inv_delta", "base", "seg_count", "zero", "ramp", "scale"),
        ("codes8", "codes16", "codes32"))
    if reader == "routed":
        assert_image_covers_every_read(tp, rebuilt, table_pack.eval_routed_poly_ref,
                                       table_pack.eval_routed_poly_slope)
    else:
        assert_image_covers_every_read(tp, rebuilt, table_pack.eval_poly_pack_ref,
                                       table_pack.eval_poly_pack_slope, static=True)


def test_routed_poly_errors(poly):
    _, tp = poly
    with pytest.raises(KeyError, match=r"'nope' not in pack \('gelu'"):
        R.routed_poly_pack_lookup(tp, ["gelu", "nope"], torch.zeros(2, 3))
    with pytest.raises(ValueError, match="leading row axis"):
        R.routed_poly_pack_grad(tp, "gelu", torch.tensor(1.0))
    with pytest.raises(ValueError, match="one flag per member"):
        R.routed_poly_pack_lookup(tp, "gelu", torch.zeros(2, 3), extrapolate=(True,))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        R.routed_poly_pack_lookup(tp, "gelu", torch.zeros(2, 3, dtype=torch.float64))
    with pytest.raises(KeyError, match="nope"):
        table_pack.make_routed_fn(tp, ["gelu", "nope"])


# --------------------------------------------------------------------------------------
# plain versions against the eager oracles, the static dispatch and the
# interpret-mode kernels
# --------------------------------------------------------------------------------------


@pytest.mark.parametrize("flags", FLAGS)
@pytest.mark.parametrize("kind", KINDS)
def test_bitwise_vs_eager_oracle_and_static(kind, flags, request):
    jp, tp = _packs(kind, request)
    ex = _flags(tp, flags)
    ids, x = mixed_rows(tp, seed=3)
    fin = np.where(np.isfinite(x), x, 0.0).astype(np.float32)
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        want = np.asarray(tp_ref.eval_routed_poly_ref(
            jp, ids, jnp.asarray(x, jdt), extrapolate=ex)).astype(np.float32)
        want_s = np.asarray(tp_ref.eval_routed_poly_slope(
            jp, ids, jnp.asarray(fin, jdt), extrapolate=ex)).astype(np.float32)
        xt, ft = torch.from_numpy(x).to(dt), torch.from_numpy(fin).to(dt)
        got = table_pack.eval_routed_poly_ref(tp, ids, xt, extrapolate=ex)
        for g in (got, R.routed_poly_pack_lookup(tp, ids, xt, extrapolate=ex),
                  R.routed_poly_pack_grad(tp, ids, xt, extrapolate=ex)[0]):
            assert g.dtype == dt
            assert_bitwise(g.float().numpy(), want)
        got_s = table_pack.eval_routed_poly_slope(tp, ids, ft, extrapolate=ex)
        for g in (got_s, R.routed_poly_pack_grad(tp, ids, ft, extrapolate=ex)[1]):
            assert g.dtype == dt
            assert_bitwise(g.float().numpy(), want_s)
        flags_of = table_pack.routed_extr_flags(tp, ex)
        for r, f in enumerate(ids):  # row r is the static dispatch of its member
            e = bool(flags_of[f])
            assert_bitwise(got[r].float(), table_pack.eval_poly_pack_ref(
                tp, f, xt[r], extrapolate=e).float())
            assert torch.equal(got_s[r], table_pack.eval_poly_pack_slope(
                tp, f, ft[r], extrapolate=e))


@pytest.mark.parametrize("flags", FLAGS)
@pytest.mark.parametrize("kind", KINDS)
def test_within_ulps_of_interpret_kernels(kind, flags, request):
    jp, tp = _packs(kind, request)
    ex = _flags(tp, flags)
    flags_of = table_pack.routed_extr_flags(tp, ex)
    ids, x = mixed_rows(tp, seed=11, cols=256)
    got = table_pack.eval_routed_poly_ref(tp, ids, torch.from_numpy(x),
                                          extrapolate=ex).numpy()
    want = np.asarray(routed_poly_pack_lookup_pallas(jp, ids, jnp.asarray(x),
                                                     extrapolate=ex))
    ky, ks = (np.asarray(v) for v in routed_poly_pack_grad_pallas(
        jp, ids, jnp.asarray(x), extrapolate=ex))
    np.testing.assert_array_equal(ky, want)  # the reference's two kernels agree
    for r, f in enumerate(ids):
        e = bool(flags_of[f])
        xr = x[r]
        scale, amp = _poly_scale(tp, f, xr, e)
        keep = np.isfinite(amp)  # see tests/test_torch_quant_poly.py
        assert (np.isnan(got[r]) == np.isnan(want[r]))[keep].all()
        fin = np.isfinite(got[r]) & np.isfinite(want[r]) & keep
        inf = keep & ~fin & ~np.isnan(got[r])
        assert (got[r][inf] == want[r][inf]).all()
        sc = np.maximum(scale[fin], np.abs(want[r][fin]))
        with np.errstate(over="ignore"):
            tol = 4 * np.spacing(sc.astype(np.float32)) * amp[fin]
        assert (np.abs(got[r][fin] - want[r][fin]) <= tol).all(), tp.names[f]
        xf = np.isfinite(xr)
        s = table_pack.eval_poly_pack_slope(tp, f, torch.from_numpy(xr[xf]),
                                            extrapolate=e).numpy()
        np.testing.assert_allclose(s, ks[r][xf], rtol=1e-5, atol=1e-7,
                                   err_msg=tp.names[f])


def test_tensor_ids_are_clamped(poly):
    jp, tp = poly
    raw = [1, 0, 10_000, -7, 5, 3]
    clamped = [min(max(i, 0), tp.n_functions - 1) for i in raw]
    x = np.stack([row_inputs(tp, f, seed=f) for f in clamped])
    ids = torch.tensor(raw, dtype=torch.int64)
    want = np.asarray(tp_ref.eval_routed_poly_ref(jp, clamped, jnp.asarray(x)))
    xt = torch.from_numpy(x)
    for got in (table_pack.eval_routed_poly_ref(tp, ids, xt),
                R.routed_poly_pack_lookup(tp, ids, xt),
                R.routed_poly_pack_grad(tp, ids, xt)[0],
                table_pack.make_routed_fn(tp, ids)(xt)):
        assert_bitwise(got, want)


def test_shapes_round_trip(poly):
    jp, tp = poly
    rng = np.random.default_rng(5)
    for shape in [(1,), (3,), (2, 5), (4, 257), (3, 2, 130), (2, 0), (0, 4)]:
        x = rng.normal(0, 3, shape).astype(np.float32)
        ids = [r % tp.n_functions for r in range(shape[0])]
        got = R.routed_poly_pack_lookup(tp, ids, torch.from_numpy(x))
        assert got.shape == x.shape and got.dtype == torch.float32
        if x.size:
            assert_bitwise(got, tp_ref.eval_routed_poly_ref(jp, ids, jnp.asarray(x)))


# --------------------------------------------------------------------------------------
# closures and gradients
# --------------------------------------------------------------------------------------


def _grad(f, x, dy):
    x = x.clone().requires_grad_(True)
    y = f(x)
    y.backward(dy)
    return y.detach(), x.grad


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("kind", KINDS)
def test_make_routed_fn_values_and_grads(kind, use_kernel, request):
    jp, tp = _packs(kind, request)
    ids, x = mixed_rows(tp, seed=21, cols=256)
    x = np.where(np.isfinite(x), x, 0.0).astype(np.float32)
    dy = np.random.default_rng(22).normal(0, 1, x.shape).astype(np.float32)
    ex = tuple(n in ("gelu", "silu", "softplus") for n in tp.names)
    f = table_pack.make_routed_fn(tp, ids, use_kernel=use_kernel, extrapolate=ex)
    for dt in (torch.float32, torch.bfloat16):
        xt, dyt = torch.from_numpy(x).to(dt), torch.from_numpy(dy).to(dt)
        y, g = _grad(f, xt, dyt)
        want_y, s = R.routed_poly_pack_grad_plain(tp, ids, xt, extrapolate=ex)
        assert g.dtype == dt
        assert torch.equal(y, want_y) and torch.equal(g, s * dyt)
        with torch.inference_mode():  # no gradient recorded: the value path
            assert torch.equal(f(xt), want_y)
    jy, vjp = jax.vjp(tp_ref.make_routed_fn(jp, ids, use_pallas=False, extrapolate=ex),
                      jnp.asarray(x))
    y, g = _grad(f, torch.from_numpy(x), torch.from_numpy(dy))
    assert_bitwise(y, jy)
    assert_bitwise(g, vjp(jnp.asarray(dy))[0])


@pytest.mark.parametrize("use_kernel", [True, False])
def test_make_routed_unary_fn_values_and_grads(use_kernel, poly):
    jp, tp = poly
    rng = np.random.default_rng(31)
    for fid, name in enumerate(tp.names):
        ex = name in ("gelu", "silu", "softplus")
        lo, hi = tp.domains[fid]
        x = rng.uniform(lo - 2, hi + 2, (3, 7, 40)).astype(np.float32)
        dy = rng.normal(0, 1, x.shape).astype(np.float32)
        f = table_pack.make_routed_unary_fn(tp, name, use_kernel=use_kernel,
                                            extrapolate=ex)
        xt, dyt = torch.from_numpy(x), torch.from_numpy(dy)
        y, g = _grad(f, xt, dyt)
        assert y.shape == g.shape == xt.shape
        assert torch.equal(y, table_pack.eval_poly_pack_ref(tp, fid, xt, extrapolate=ex))
        assert torch.equal(g, table_pack.eval_poly_pack_slope(
            tp, fid, xt, extrapolate=ex) * dyt)
        jy, vjp = jax.vjp(tp_ref.make_routed_unary_fn(jp, name, use_pallas=False,
                                                      extrapolate=ex), jnp.asarray(x))
        assert_bitwise(y, jy)
        assert_bitwise(g, vjp(jnp.asarray(dy))[0])
        d1 = lambda v: torch.cos(v)  # exact_d1 is honoured
        _, g = _grad(table_pack.make_routed_unary_fn(
            tp, name, use_kernel=use_kernel, exact_d1=d1, extrapolate=ex), xt, dyt)
        assert torch.equal(g, torch.cos(xt) * dyt)


# --------------------------------------------------------------------------------------
# ApproxConfig
# --------------------------------------------------------------------------------------


def test_routed_poly_modes_are_ported():
    assert ROUTED_MODES[-2:] == ("routed_poly_pack", "routed_poly_pack_ref")
    a = ApproxConfig(mode="routed_poly_pack", e_a=EA, omega=OMEGA)
    assert a._pack_for_mode("cpu") is a.poly_pack("cpu")
    assert dataclasses.replace(a, mode="routed_poly_pack_ref")._pack_for_mode(
        "cpu") is a.poly_pack("cpu")


@pytest.mark.parametrize("mode", ["routed_poly_pack", "routed_poly_pack_ref"])
def test_routed_poly_unary_bitwise_equal_static(mode, poly):
    """A routed poly unary is the static poly unary, value and gradient, and
    the reference's (eager ``_ref``) unary, remaps and odd extension
    included."""
    static_mode = "poly_pack" if mode == "routed_poly_pack" else "poly_pack_ref"
    rng = np.random.default_rng(41)
    x = np.concatenate([np.linspace(-12, 12, 1001),
                        rng.normal(0, 4, 600)]).astype(np.float32)
    dy = rng.normal(0, 1, x.size).astype(np.float32)
    for name in ("gelu", "silu", "tanh", "sigmoid", "exp", "softplus"):
        xi = np.minimum(x, 0.0) if name == "exp" else x
        xt, dyt = torch.from_numpy(xi), torch.from_numpy(dy)
        cfg = ApproxConfig(mode=mode, e_a=EA, omega=OMEGA)
        y, g = _grad(cfg.unary(name, "cpu"), xt, dyt)
        ys, gs = _grad(dataclasses.replace(cfg, mode=static_mode).unary(name, "cpu"),
                       xt, dyt)
        assert torch.equal(y, ys) and torch.equal(g, gs), name
        jy, vjp = jax.vjp(JApprox(mode="routed_poly_pack_ref", e_a=EA,
                                  omega=OMEGA).unary(name), jnp.asarray(xi))
        assert_bitwise(y, jy)
        assert_bitwise(g, vjp(jnp.asarray(dy))[0])


@pytest.mark.parametrize("mode", ["routed_poly_pack", "routed_poly_pack_ref",
                                  "poly_pack", "poly_pack_ref"])
def test_routed_fn_matches_per_slot_unary(mode, poly):
    """One routed call over the poly pack is the per-slot unaries, odd-extended
    tanh rows included, and the reference's routed_fn (its eager plain mode)
    value and gradient, bit for bit."""
    cfg = ApproxConfig(mode=mode, e_a=EA, omega=OMEGA)
    rng = np.random.default_rng(51)
    x = rng.normal(0, 3, (len(SLOTS), 2, 64)).astype(np.float32)
    dy = rng.normal(0, 1, x.shape).astype(np.float32)
    f = cfg.routed_fn(SLOTS, "cpu")
    y, g = _grad(f, torch.from_numpy(x), torch.from_numpy(dy))
    for i, n in enumerate(SLOTS):
        yi, gi = _grad(cfg.unary(n, "cpu"), torch.from_numpy(x[i]),
                       torch.from_numpy(dy[i]))
        assert torch.equal(y[i], yi), (mode, n)
        assert torch.equal(g[i], gi), (mode, n)
    jf = JApprox(mode="routed_poly_pack_ref", e_a=EA, omega=OMEGA).routed_fn(SLOTS)
    jy, vjp = jax.vjp(jf, jnp.asarray(x))
    assert_bitwise(y, jy)
    assert_bitwise(g, vjp(jnp.asarray(dy))[0])


def test_attn_exp_in_routed_poly_mode():
    """TableFlash in routed_poly_pack serves the exponent from the f32 pack."""
    a = ApproxConfig(mode="routed_poly_pack", e_a=EA, omega=OMEGA, attn_table=True)
    z = torch.linspace(-30, 0, 301)
    assert torch.equal(a.attn_exp("cpu")(z), K.tableflash_exp_plain(a.pack("cpu"), z))


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
def test_greedy_tokens_match_reference_engine(attn, poly):
    from repro.serving.engine import ContinuousEngine as JContinuousEngine
    from repro_torch.serving.engine import ContinuousEngine
    from tests.test_serving import mixed_requests

    jm, jp, tm, tp = _pair("routed_poly_pack", attn)
    want = JContinuousEngine(jm, jp, batch_size=2, cache_len=64).serve(
        mixed_requests(np.random.default_rng(3), 8))
    _lib.reset_launches()
    got = ContinuousEngine(tm, tp, batch_size=2, cache_len=64).serve(
        mixed_requests(np.random.default_rng(3), 8))
    assert not any(_lib.launches.values())  # CPU tensors: plain versions only
    for i, (a, b) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(b.tokens, a.tokens, err_msg=f"req {i}")
        assert (b.steps, b.prompt_len) == (a.steps, a.prompt_len)


def test_two_train_steps_match_reference(poly):
    from repro.optim import adamw as j_adamw
    from repro.train.loop import make_train_step as j_make_train_step
    from repro_torch.convert import train_state_from_jax
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.optim import adamw
    from repro_torch.train.loop import batch_to, make_train_step

    jm, jp, tm, _ = _pair("routed_poly_pack", True)
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
    assert all(np.isfinite(tl))


# --------------------------------------------------------------------------------------
# launchers
# --------------------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["routed_poly_pack", "routed_poly_pack_ref"])
def test_serve_cli_routed_poly(mode, capsys, poly):
    from repro_torch.launch.serve import main

    res = main(["--arch", "stablelm-3b", "--reduced", "--device", "cpu",
                "--requests", "3", "--batch", "2", "--max-new", "3",
                "--approx-mode", mode, "--attn-table", "--rope-table"])
    assert [r.steps for r in res] == [3, 3, 3]
    assert "served 3 requests, 9 tokens on cpu" in capsys.readouterr().out


def test_train_cli_routed_poly(tmp_path, capsys, poly):
    from repro_torch.launch import train

    out = train.main(["--arch", "stablelm-3b", "--reduced", "--device", "cpu",
                      "--steps", "2", "--batch", "4", "--seq", "16", "--accum", "2",
                      "--approx-mode", "routed_poly_pack", "--ckpt-dir", str(tmp_path)])
    assert "done: step=2 loss" in capsys.readouterr().out
    assert all(np.isfinite(out["losses"]))
