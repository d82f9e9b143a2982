"""The port's table and pack runtimes against the JAX reference, on the same
numpy inputs.

Contract (tolerances stated with their reason):

* bitwise equal to the reference's EAGER oracles (``eval_pack_ref``,
  ``eval_table_ref``, ``make_attn_exp_fn(pack, use_pallas=False)``): both
  round every op on its own;
* within 1 ULP of the jitted oracle and of the Pallas kernels in interpret
  mode (as the JAX tests run them on the CPU): XLA contracts the lerp
  ``y0 + t * (y1 - y0)`` into an FMA there, which moves a few percent of
  points by one rounding.  The ULP is taken at the lerp's own scale,
  max(|y0|, |y1|, |t * (y1 - y0)|, |y|): near a zero crossing the result is
  far smaller than its operands, and one rounding of the operands is many
  ULPs of the result;
* inputs are normal floats or zero: XLA on the CPU flushes subnormal inputs
  to zero, PyTorch and the CUDA kernels do not (the card tests keep them);
* the TableFlash zero tail is exactly 0 below lo, and ``member_id`` raises
  ``KeyError`` for unknown names and out-of-range ids;
* slopes (the grad kernels' second output): bitwise equal to the eager
  ``eval_pack_slope`` / ``eval_table_slope`` on finite inputs (the eager
  oracle's gathers do not clamp a non-finite address), and within 1 ULP of
  the slope itself against the Pallas grad kernels in interpret mode;
* gradients through ``make_pack_fn`` / ``make_table_fn`` /
  ``make_attn_exp_fn`` / ``ApproxConfig.unary``: exactly ``slope * dy``, and
  bitwise equal to the reference's VJP of its ``custom_jvp`` (both compute
  one product per element).

On the CPU the kernel wrappers run their plain versions, so the wrapper is
held to the same contract.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.approx import jax_table as jt_ref
from repro.approx import table_pack as tp_ref
from repro.core import function_names
from repro.core.flow import cached_table as j_cached
from repro.kernels.table_grad import table_lookup_grad_pallas
from repro.kernels.table_lookup import table_lookup_pallas
from repro.kernels.table_pack_lookup import (table_pack_grad_pallas,
                                             table_pack_lookup_pallas,
                                             tableflash_exp_pallas)
from repro_torch.approx import ApproxConfig, SHARDED_MODES, torch_table, table_pack
from repro_torch.core.flow import cached_table
from repro_torch.core.functions import get as get_function
from repro_torch.kernels import _lib
from repro_torch.kernels import table_grad as TG
from repro_torch.kernels import table_lookup as TL
from repro_torch.kernels import table_pack_lookup as K

NAMES = ("gelu", "silu", "tanh", "sigmoid_sym", "softplus", "exp_neg")
N = 1 << 14


@pytest.fixture(scope="module")
def packs():
    j = tp_ref.build_pack(NAMES, 1e-4, omega=0.2)
    t = table_pack.build_pack(NAMES, 1e-4, omega=0.2, device="cpu")
    return j, t


def inputs(lo, hi, bounds, seed=0):
    """Uniform over the domain +- 3, every boundary and its f32 neighbours,
    and the edge values of the main path."""
    rng = np.random.default_rng(seed)
    b = np.asarray(bounds, np.float32)
    b = b[np.isfinite(b)]
    x = np.concatenate([
        rng.uniform(lo - 3.0, hi + 3.0, N), b,
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


def lerp_scale(brow, invd_row, base_row, segs_row, n, values, x, extrapolate):
    """max(|y0|, |y1|, |t * (y1 - y0)|) of each element's lerp (the port's
    own selector and address math)."""
    xf = torch.from_numpy(x)
    p, invd, base, segs = torch_table._select_params(brow, invd_row, base_row,
                                                     segs_row, n, xf)
    u = (xf - p) * invd
    i = torch.minimum(torch.clamp(torch.floor(u), min=0.0), segs - 1.0)
    a0, a1 = torch_table.pair_address(base, i, values.shape[0])
    y0, y1 = values[a0], values[a1]
    t = u - i if extrapolate else torch.clamp(u - i, 0.0, 1.0)
    return torch.maximum(torch.maximum(y0.abs(), y1.abs()),
                         (t * (y1 - y0)).abs()).numpy()


def assert_within_ulp(got, want, scale):
    """|got - want| <= 1 ULP at ``scale``; NaN and inf positions identical."""
    got, want = np.asarray(got), np.asarray(want)
    assert (np.isnan(got) == np.isnan(want)).all()
    fin = np.isfinite(want) & np.isfinite(got)
    assert (got[~fin & ~np.isnan(got)] == want[~fin & ~np.isnan(want)]).all()
    scale = np.maximum(np.abs(scale[fin]), np.abs(want[fin]))
    tol = np.spacing(scale.astype(np.float32))
    assert (np.abs(got[fin] - want[fin]) <= tol).all(), \
        np.max(np.abs(got[fin] - want[fin]) / tol)


@pytest.mark.parametrize("extrapolate", [False, True])
@pytest.mark.parametrize("name", NAMES)
class TestPack:
    def test_bitwise_vs_eager_oracle(self, packs, name, extrapolate):
        jp, tp = packs
        fid = tp.fn_id(name)
        x = inputs(*tp.domains[fid], tp.boundaries[fid].numpy())
        want = tp_ref.eval_pack_ref(jp, name, jnp.asarray(x), extrapolate=extrapolate)
        xt = torch.from_numpy(x)
        assert_bitwise(table_pack.eval_pack_ref(tp, name, xt,
                                                extrapolate=extrapolate), want)
        assert_bitwise(K.table_pack_lookup(tp, name, xt, extrapolate=extrapolate),
                       want)

    def test_bf16_bitwise_vs_eager_oracle(self, packs, name, extrapolate):
        jp, tp = packs
        fid = tp.fn_id(name)
        x = inputs(*tp.domains[fid], tp.boundaries[fid].numpy(), seed=1)
        want = tp_ref.eval_pack_ref(jp, name, jnp.asarray(x, jnp.bfloat16),
                                    extrapolate=extrapolate)
        got = K.table_pack_lookup(tp, name, torch.from_numpy(x).to(torch.bfloat16),
                                  extrapolate=extrapolate)
        assert got.dtype == torch.bfloat16
        assert_bitwise(got.float().numpy(), np.asarray(want).astype(np.float32))

    def test_within_one_ulp_of_jit_and_interpret_kernel(self, packs, name,
                                                        extrapolate):
        jp, tp = packs
        fid = tp.fn_id(name)
        x = inputs(*tp.domains[fid], tp.boundaries[fid].numpy(), seed=2)
        got = table_pack.eval_pack_ref(tp, name, torch.from_numpy(x),
                                       extrapolate=extrapolate).numpy()
        scale = lerp_scale(tp.boundaries[fid], tp.inv_delta[fid], tp.base[fid],
                           tp.seg_count[fid], tp.n_intervals[fid], tp.values, x,
                           extrapolate)
        jitted = jax.jit(lambda v: tp_ref.eval_pack_ref(
            jp, name, v, extrapolate=extrapolate))(jnp.asarray(x))
        assert_within_ulp(got, jitted, scale)
        kern = table_pack_lookup_pallas(jp, name, jnp.asarray(x),
                                        extrapolate=extrapolate)
        assert_within_ulp(got, kern, scale)

    def test_slope_bitwise_vs_eager_oracle(self, packs, name, extrapolate):
        jp, tp = packs
        fid = tp.fn_id(name)
        x = inputs(*tp.domains[fid], tp.boundaries[fid].numpy(), seed=3)
        x = x[np.isfinite(x)]  # the oracle's slope at +-inf is inf - inf
        want = tp_ref.eval_pack_slope(jp, name, jnp.asarray(x), extrapolate=extrapolate)
        got = table_pack.eval_pack_slope(tp, name, torch.from_numpy(x),
                                         extrapolate=extrapolate)
        assert_bitwise(got, want)

    def test_grad_plain_bitwise_vs_eager_oracle(self, packs, name, extrapolate):
        """``table_pack_grad_plain`` (and the CPU wrapper) is the eager
        ``(eval_pack_ref, eval_pack_slope)`` pair, in f32 and bf16."""
        jp, tp = packs
        fid = tp.fn_id(name)
        x = inputs(*tp.domains[fid], tp.boundaries[fid].numpy(), seed=5)
        x = x[np.isfinite(x)]
        for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
            xj = jnp.asarray(x, jdt)
            want_y = tp_ref.eval_pack_ref(jp, name, xj, extrapolate=extrapolate)
            want_s = tp_ref.eval_pack_slope(jp, name, xj, extrapolate=extrapolate)
            xt = torch.from_numpy(x).to(dt)
            for y, slope in (K.table_pack_grad_plain(tp, name, xt, extrapolate=extrapolate),
                             K.table_pack_grad(tp, fid, xt, extrapolate=extrapolate)):
                assert y.dtype == slope.dtype == dt
                assert_bitwise(y.float().numpy(), np.asarray(want_y).astype(np.float32))
                assert_bitwise(slope.float().numpy(),
                               np.asarray(want_s).astype(np.float32))

    def test_grad_within_one_ulp_of_interpret_kernel(self, packs, name, extrapolate):
        jp, tp = packs
        fid = tp.fn_id(name)
        x = inputs(*tp.domains[fid], tp.boundaries[fid].numpy(), seed=6)
        y, slope = K.table_pack_grad_plain(tp, name, torch.from_numpy(x),
                                           extrapolate=extrapolate)
        ky, ks = table_pack_grad_pallas(jp, name, jnp.asarray(x), extrapolate=extrapolate)
        scale = lerp_scale(tp.boundaries[fid], tp.inv_delta[fid], tp.base[fid],
                           tp.seg_count[fid], tp.n_intervals[fid], tp.values, x,
                           extrapolate)
        assert_within_ulp(y.numpy(), ky, scale)
        assert_within_ulp(slope.numpy(), ks, np.zeros_like(x))


@pytest.mark.parametrize("extrapolate", [False, True])
@pytest.mark.parametrize("name", function_names())
def test_table_bitwise_vs_eager_oracle(name, extrapolate):
    jt = jt_ref.from_spec(j_cached(name, 1e-4))
    tt = torch_table.from_spec(cached_table(name, 1e-4), device="cpu")
    x = inputs(float(tt.boundaries[0]), float(tt.boundaries[-1]),
               tt.boundaries.numpy(), seed=4)
    want = jt_ref.eval_table_ref(jt, jnp.asarray(x), extrapolate=extrapolate)
    assert_bitwise(torch_table.eval_table_ref(tt, torch.from_numpy(x),
                                              extrapolate=extrapolate), want)


def _table_pair(name):
    return (jt_ref.from_spec(j_cached(name, 1e-4)),
            torch_table.from_spec(cached_table(name, 1e-4), device="cpu"))


@pytest.mark.parametrize("extrapolate", [False, True])
@pytest.mark.parametrize("name", function_names())
def test_table_kernels_plain_bitwise_vs_eager_oracle(name, extrapolate):
    """``table_lookup[_grad]_plain`` and the CPU wrappers are the eager
    ``eval_table_ref`` / ``eval_table_slope``."""
    jt, tt = _table_pair(name)
    x = inputs(float(tt.boundaries[0]), float(tt.boundaries[-1]),
               tt.boundaries.numpy(), seed=8)
    want_y = jt_ref.eval_table_ref(jt, jnp.asarray(x), extrapolate=extrapolate)
    xt = torch.from_numpy(x)
    assert_bitwise(TL.table_lookup_plain(tt, xt, extrapolate=extrapolate), want_y)
    assert_bitwise(TL.table_lookup(tt, xt, extrapolate=extrapolate), want_y)
    fin = np.isfinite(x)
    want_s = jt_ref.eval_table_slope(jt, jnp.asarray(x[fin]), extrapolate=extrapolate)
    for y, slope in (TG.table_lookup_grad_plain(tt, xt[fin], extrapolate=extrapolate),
                     TG.table_lookup_grad(tt, xt[fin], extrapolate=extrapolate)):
        assert_bitwise(y, want_y[fin])
        assert_bitwise(slope, want_s)


@pytest.mark.parametrize("extrapolate", [False, True])
@pytest.mark.parametrize("name", function_names())
def test_table_kernels_within_one_ulp_of_interpret_kernels(name, extrapolate):
    jt, tt = _table_pair(name)
    x = inputs(float(tt.boundaries[0]), float(tt.boundaries[-1]),
               tt.boundaries.numpy(), seed=9)
    xt = torch.from_numpy(x)
    scale = lerp_scale(tt.boundaries, tt.inv_delta, tt.base, tt.seg_count,
                       tt.n_intervals, tt.values, x, extrapolate)
    y = TL.table_lookup_plain(tt, xt, extrapolate=extrapolate).numpy()
    assert_within_ulp(y, table_lookup_pallas(jt, jnp.asarray(x), extrapolate=extrapolate),
                      scale)
    gy, gs = TG.table_lookup_grad_plain(tt, xt, extrapolate=extrapolate)
    ky, ks = table_lookup_grad_pallas(jt, jnp.asarray(x), extrapolate=extrapolate)
    assert_within_ulp(gy.numpy(), ky, scale)
    assert_within_ulp(gs.numpy(), ks, np.zeros_like(x))


def test_table_wrapper_contract():
    _, tt = _table_pair("silu")
    for dt in (torch.float64, torch.float16):
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            TL.table_lookup(tt, torch.zeros(4, dtype=dt))
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            TG.table_lookup_grad(tt, torch.zeros(4, dtype=dt))
    with pytest.raises(ValueError, match="table lives on cpu, x on meta"):
        TL.table_lookup(tt, torch.zeros(4, device="meta"))
    before = dict(K.launches)
    y, s = TG.table_lookup_grad(tt, torch.zeros(3, 0))
    assert y.shape == s.shape == (3, 0)
    assert K.launches == before  # the plain version on the CPU is no launch


@pytest.mark.parametrize("entry,n_out", [("tp_tableflash_exp", 1), ("tp_pack_grad", 2),
                                         ("tp_routed_lookup", 1)])
@pytest.mark.parametrize("case", ["contiguous", "permuted", "strided", "size-1 dims"])
def test_launch_operands_keep_the_layout(entry, n_out, case):
    """What a launch reads and writes: an elementwise entry reads a dense x
    in memory order without a copy and writes outputs with x's strides, as
    ``torch.exp`` (and so the plain versions) would, so that a reduction
    downstream sums in the same order (flash attention's exponents come
    permuted from its score einsum: (B, S, G, Qg, T) with the group axis
    outermost); a routed entry, whose rows carry their ids, and an x with
    gaps read x in logical order into contiguous outputs.  A stand-in kernel
    (out = 2 x, element by element in the order read) checks the pairing."""
    base = torch.randn(3, 5, 2, 7)
    x = {"contiguous": base, "permuted": base.permute(0, 2, 1, 3),
         "strided": base[:, ::2], "size-1 dims": base[1:2].permute(2, 0, 1, 3)}[case]
    flat, outs = _lib.operands(entry, x, n_out)
    assert len(outs) == n_out and flat.numel() == x.numel() and flat.is_contiguous()
    routed = entry.startswith("tp_routed")
    dense = case != "strided"
    if dense and not routed:
        assert flat.data_ptr() == x.data_ptr()  # a view: no copy
        assert all(o.stride() == x.stride() for o in outs)
    else:
        assert all(o.is_contiguous() for o in outs)
    for o in outs:  # the kernel writes each output's memory in flat's order
        torch.as_strided(o, (o.numel(),), (1,), o.storage_offset()).copy_(2 * flat)
        assert o.shape == x.shape and torch.equal(o, 2 * x)
    if case == "permuted" and not routed:
        assert outs[0].stride() == torch.exp(x).stride() != x.contiguous().stride()


# --------------------------------------------------------------------------------------
# gradients: backward = slope * dy, and the reference's VJP
# --------------------------------------------------------------------------------------


def _x_dy(lo, hi, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    x = rng.uniform(lo - 2.0, hi + 2.0, 3000).astype(np.float32)
    dy = rng.normal(0, 1, 3000).astype(np.float32)
    return torch.from_numpy(x).to(dtype), torch.from_numpy(dy).to(dtype)


def _grad(f, x, dy):
    x = x.clone().requires_grad_(True)
    y = f(x)
    y.backward(dy)
    return y.detach(), x.grad


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("name", NAMES)
def test_pack_fn_backward_is_slope_times_dy(packs, name, use_kernel, dtype):
    _, tp = packs
    fid = tp.fn_id(name)
    ex = name in ("gelu", "silu", "softplus")
    x, dy = _x_dy(*tp.domains[fid], seed=fid, dtype=dtype)
    f = table_pack.make_pack_fn(tp, name, use_kernel=use_kernel, extrapolate=ex)
    y, g = _grad(f, x, dy)
    want_y, slope = K.table_pack_grad_plain(tp, fid, x, extrapolate=ex)
    assert g.dtype == dtype
    assert torch.equal(y, want_y) and torch.equal(g, slope * dy)
    with torch.inference_mode():  # no gradient recorded: the value path
        assert torch.equal(f(x), want_y)
    d1 = lambda v: torch.cos(v)  # any analytic derivative
    fe = table_pack.make_pack_fn(tp, name, use_kernel=use_kernel, exact_d1=d1,
                                 extrapolate=ex)
    y, g = _grad(fe, x, dy)
    assert torch.equal(y, want_y) and torch.equal(g, torch.cos(x) * dy)


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("name", ["silu", "tanh", "exp_neg", "gelu"])
def test_table_fn_backward_is_slope_times_dy(name, use_kernel):
    _, tt = _table_pair(name)
    ex = name in ("gelu", "silu")
    x, dy = _x_dy(float(tt.boundaries[0]), float(tt.boundaries[-1]), seed=11)
    y, g = _grad(torch_table.make_table_fn(tt, use_kernel=use_kernel, extrapolate=ex),
                 x, dy)
    want_y, slope = TG.table_lookup_grad_plain(tt, x, extrapolate=ex)
    assert torch.equal(y, want_y) and torch.equal(g, slope * dy)
    d1 = partial(get_function(name).d1f, xp=torch)
    y, g = _grad(torch_table.make_table_fn(tt, use_kernel=use_kernel, exact_d1=d1,
                                           extrapolate=ex), x, dy)
    assert torch.equal(y, want_y) and torch.equal(g, d1(x) * dy)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_attn_exp_backward_is_raw_slope_times_dy(packs, use_kernel):
    jp, tp = packs
    z = np.concatenate([np.linspace(-40.0, 0.0, 4001),
                        [-16.0, np.nextafter(np.float32(-16), -np.inf), -2e38]]
                       ).astype(np.float32)
    dy = np.random.default_rng(12).normal(0, 1, z.size).astype(np.float32)
    y, g = _grad(table_pack.make_attn_exp_fn(tp, use_kernel=use_kernel),
                 torch.from_numpy(z), torch.from_numpy(dy))
    slope = table_pack.eval_pack_slope(tp, "exp_neg", torch.from_numpy(z))
    assert torch.equal(g, slope * torch.from_numpy(dy))
    assert (g[torch.from_numpy(z) < -16.0] == 0).all()
    jy, vjp = jax.vjp(tp_ref.make_attn_exp_fn(jp, use_pallas=False), jnp.asarray(z))
    assert_bitwise(y, jy)
    assert_bitwise(g, vjp(jnp.asarray(dy))[0])


class TestTableFlash:
    def _x(self):
        return np.concatenate([np.linspace(-40.0, 0.0, 4096),
                               [0.0, -0.0, -16.0, np.nextafter(np.float32(-16), 0),
                                np.nextafter(np.float32(-16), -np.inf), -(1 << 31),
                                -2e38, -np.inf, np.nan]]).astype(np.float32)

    def test_bitwise_vs_eager_oracle(self, packs):
        jp, tp = packs
        x = self._x()
        want = tp_ref.make_attn_exp_fn(jp, use_pallas=False)(jnp.asarray(x))
        xt = torch.from_numpy(x)
        assert_bitwise(K.tableflash_exp_plain(tp, xt), want)
        assert_bitwise(K.tableflash_exp(tp, xt), want)
        assert_bitwise(table_pack.make_attn_exp_fn(tp)(xt), want)

    def test_within_one_ulp_of_interpret_kernel(self, packs):
        jp, tp = packs
        x = self._x()
        got = K.tableflash_exp_plain(tp, torch.from_numpy(x)).numpy()
        fid = tp.fn_id("exp_neg")
        scale = lerp_scale(tp.boundaries[fid], tp.inv_delta[fid], tp.base[fid],
                           tp.seg_count[fid], tp.n_intervals[fid], tp.values,
                           np.maximum(x, np.float32(-16.0)), False)
        assert_within_ulp(got, tableflash_exp_pallas(jp, jnp.asarray(x)), scale)
        assert_within_ulp(got, jax.jit(tp_ref.make_attn_exp_fn(
            jp, use_pallas=False))(jnp.asarray(x)), scale)

    def test_zero_tail_exact(self, packs):
        _, tp = packs
        lo = tp.domains[tp.fn_id("exp_neg")][0]
        assert lo == -16.0
        x = torch.tensor([lo, np.nextafter(np.float32(lo), -np.inf), -1e4, -2e38,
                          float(-(1 << 31)), float("-inf"), 0.0])
        y = K.tableflash_exp(tp, x)
        assert y[0] > 0.0  # x = lo is in-domain: exp(-16) > 0
        assert (y[1:6] == 0.0).all() and not torch.signbit(y[1:6]).any()
        assert abs(float(y[6]) - 1.0) <= 1e-4 * 1.02 + 1e-5

    def test_bf16_keeps_dtype(self, packs):
        _, tp = packs
        x = torch.linspace(-20, 0, 257).to(torch.bfloat16)
        y = K.tableflash_exp(tp, x)
        assert y.dtype == torch.bfloat16 and (y[x < -16] == 0).all()

    def test_member_image_covers_every_read(self, packs):
        """exp_neg's staging image (``TablePack.flash_image``, what a block of
        the TableFlash kernel stages on the card) holds every float the
        lookup reads: its row is the pack's exp_neg row over the real
        sub-intervals with the base rebased by one shift, its values are the
        pack's over that span, and with every value of the pack outside the
        span poisoned with NaN the plain TableFlash keeps its bits (NaN,
        +-inf, z < lo, subnormals and a linspace over [-40, 0])."""
        _, tp = packs
        fid = tp.fn_id("exp_neg")
        n = tp.n_intervals[fid]
        image, m_img = tp.flash_image
        img = image.numpy()
        (at,), v_at = table_pack.member_image_layout([n])
        assert image.dtype == torch.float32 and image.is_contiguous()
        assert img.size % 4 == 0 and v_at + m_img <= img.size < v_at + m_img + 4
        rows = [img[at: at + n + 1]] + [img[at + n + 1 + k * n: at + 2 * n + 1 + k * n]
                                        for k in range(3)]
        assert_bitwise(rows[0], tp.boundaries[fid, : n + 1].numpy())
        assert_bitwise(rows[1], tp.inv_delta[fid, :n].numpy())
        assert_bitwise(rows[3], tp.seg_count[fid, :n].numpy())
        (v0,) = set((tp.base[fid, :n].numpy() - rows[2]).tolist())
        v0 = int(v0)
        assert_bitwise(img[v_at: v_at + m_img], tp.values.numpy()[v0: v0 + m_img])
        poisoned = tp.values.clone()
        poisoned[:v0] = float("nan")
        poisoned[v0 + m_img:] = float("nan")
        bad = dataclasses.replace(tp, values=poisoned)
        tiny = np.finfo(np.float32).smallest_subnormal
        x = torch.from_numpy(np.concatenate(
            [self._x(), [np.inf, tiny, -tiny, -1e-40, -16.5, -1e30]]).astype(np.float32))
        assert_bitwise(K.tableflash_exp_plain(bad, x), K.tableflash_exp_plain(tp, x))



def _row_of(image, at, n):
    """(bounds, invd, base, segs) of a staging image's row of ``n``
    sub-intervals at word ``at`` (member_image_layout)."""
    return (image[at: at + n + 1],) + tuple(
        image[at + n + 1 + k * n: at + 2 * n + 1 + k * n] for k in range(3))


def _cell_points(bounds, invd, segs):
    """The middle of every cell of a row (so a lookup reads every value its
    member holds), every boundary and its f32 neighbours, the specials
    (+-inf, NaN, out of domain) and subnormals."""
    b = bounds.numpy()
    mids = np.concatenate([b[j] + (np.arange(int(segs[j])) + 0.5) / float(invd[j])
                           for j in range(len(segs))])
    tiny = np.finfo(np.float32).smallest_subnormal
    rng = np.random.default_rng(11)
    return torch.from_numpy(np.concatenate([
        mids, b, np.nextafter(b, np.float32(np.inf)), np.nextafter(b, np.float32(-np.inf)),
        rng.uniform(b[0] - 3.0, b[-1] + 3.0, 1024),
        [np.inf, -np.inf, np.nan, -np.nan, -2e38, 2e38, 0.0, -0.0, tiny, -tiny, 1e-40,
         -1e-40]]).astype(np.float32))


@pytest.mark.parametrize("reader", ["pack", "table"])
def test_static_image_covers_every_read(reader, packs):
    """What a static launch stages where it fits (the pack's
    ``TablePack.image`` for ``tp_pack_lookup`` / ``tp_pack_grad``, a table's
    ``TorchTable.image`` for ``tp_table_lookup`` / ``tp_table_grad``) holds
    every float it reads: a pack (or table) rebuilt only from the sections
    the launch addresses (the member's row from its start, over its real
    sub-intervals; the image's values), NaN everywhere else (the other
    members' rows, the row's padding), gives each member's plain value and
    slope with the same bits, extrapolation off and on, at NaN, +-inf,
    out-of-domain, boundary and subnormal lanes and a point in every cell.
    The image's values are the pack's from its first entry, so a NaN x's
    address 0 (whose extrapolated slope is ``(v[1] - v[0]) * invd[0]``)
    reads the pack's own pair."""
    _, tp = packs
    if reader == "pack":
        image, m_img = tp.image
        starts, v_at = table_pack.member_image_layout(tp.n_intervals)
        assert m_img == tp.footprint and image.numel() == (v_at + m_img + 3) // 4 * 4
        assert_bitwise(image[v_at: v_at + m_img], tp.values)
        values = image[v_at: v_at + m_img]
        cases = []
        for fid, (at, n) in enumerate(zip(starts, tp.n_intervals)):
            planes = [torch.full_like(p, float("nan")) for p in
                      (tp.boundaries, tp.inv_delta, tp.base, tp.seg_count)]
            for plane, sec in zip(planes, _row_of(image, at, n)):
                plane[fid, : sec.numel()] = sec
            assert_bitwise(planes[2][fid, :n], tp.base[fid, :n])  # not rebased
            rebuilt = dataclasses.replace(tp, boundaries=planes[0], inv_delta=planes[1],
                                          base=planes[2], seg_count=planes[3],
                                          values=values)
            fns = tuple(lambda pk, x, ex, f=f, fid=fid: f(pk, fid, x, extrapolate=ex)
                        for f in (table_pack.eval_pack_ref, table_pack.eval_pack_slope))
            cases.append(fns + (rebuilt, tp, _row_of(image, at, n)))
    else:
        cases = []
        for name in tp.names:
            tt = torch_table.from_spec(cached_table(name, 1e-4), device="cpu")
            n, m = tt.n_intervals, tt.footprint
            v_at = table_pack.member_image_layout([n])[1]
            assert v_at == 4 * n + 1 and tt.image.numel() == (v_at + m + 3) // 4 * 4
            row = _row_of(tt.image, 0, n)
            rebuilt = torch_table.TorchTable(
                boundaries=row[0], inv_delta=row[1], delta=torch.full_like(row[1], np.nan),
                base=row[2], seg_count=row[3], values=tt.image[v_at: v_at + m])
            fns = tuple(lambda t, x, ex, f=f: f(t, x, extrapolate=ex)
                        for f in (torch_table.eval_table_ref, torch_table.eval_table_slope))
            cases.append(fns + (rebuilt, tt, row))
    for value, slope, rebuilt, ref, row in cases:
        x = _cell_points(row[0], row[1], row[3])
        for ex in (False, True):
            for f in (value, slope):
                assert_bitwise(f(rebuilt, x, ex), f(ref, x, ex))


class TestContracts:
    def test_member_id_keyerror(self, packs):
        _, tp = packs
        assert tp.member_id("silu") == tp.fn_id("silu") == 1
        assert tp.member_id(5) == 5
        with pytest.raises(KeyError, match="'nope' not in pack"):
            tp.member_id("nope")
        for bad in (6, -1):
            with pytest.raises(KeyError, match="out of range"):
                tp.member_id(bad)
        with pytest.raises(KeyError):
            K.table_pack_lookup(tp, 7, torch.zeros(3))

    def test_attn_exp_needs_exp_neg(self):
        with pytest.raises(KeyError, match="exp_neg"):
            ApproxConfig(mode="table_pack_ref", attn_table=True,
                         pack_functions=("gelu", "tanh")).attn_exp("cpu")
        assert ApproxConfig(mode="exact", attn_table=True).attn_exp("cpu") is None
        assert ApproxConfig(mode="table_pack").attn_exp("cpu") is None

    def test_wrapper_dtype_check(self, packs):
        """The wrappers take what the kernels take, on either device."""
        _, tp = packs
        for dt in (torch.float64, torch.float16):
            with pytest.raises(TypeError, match="float32 or bfloat16"):
                K.table_pack_lookup(tp, "silu", torch.zeros(4, dtype=dt))
            with pytest.raises(TypeError, match="float32 or bfloat16"):
                K.tableflash_exp(tp, torch.zeros(4, dtype=dt))

    @pytest.mark.parametrize("mode", SHARDED_MODES)
    def test_unported_modes_raise(self, mode, packs):
        """The two modes this test once found refused (the sharded ones) are
        ported: each serves, equal to the replicated pack it shards (held to
        the reference in tests/test_torch_sharded.py)."""
        _, tp = packs
        x = torch.from_numpy(inputs(-12.0, 12.0, [], seed=5))
        f = ApproxConfig(mode=mode, e_a=1e-4, omega=0.2, pack_shards=3).unary("silu", "cpu")
        # equal as values (NaN positions matched): a shard sum turns an
        # owner's -0.0 into +0.0
        np.testing.assert_array_equal(
            f(x).numpy(), table_pack.eval_pack_ref(tp, "silu", x, extrapolate=True).numpy())

    def test_unknown_mode_and_rope_table(self):
        with pytest.raises(ValueError, match="unknown approx mode"):
            ApproxConfig(mode="bogus").unary("silu", "cpu")
        with pytest.raises(ValueError, match="unknown approx mode"):
            ApproxConfig(mode="bogus", rope_table=True).rope_sin_cos("cpu")
        # rope_table serves the rotary sin/cos through the folded trig
        # members (tests/test_torch_fold.py holds them to the reference)
        sin_cos = ApproxConfig(mode="table_pack", rope_table=True).rope_sin_cos("cpu")
        ang = torch.linspace(0.0, 300.0, 1001)
        s, c = sin_cos(ang)
        assert float((s - torch.sin(ang)).abs().max()) < 1e-3
        assert float((c - torch.cos(ang)).abs().max()) < 1e-3
        assert ApproxConfig(mode="exact", rope_table=True).rope_sin_cos() is None

    def test_no_cuda_is_an_error(self):
        from repro_torch.device import resolve_device

        if torch.cuda.is_available():
            assert resolve_device().type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                resolve_device()
            with pytest.raises(RuntimeError):
                ApproxConfig(mode="table_pack").pack()
        assert resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("mode", ["exact", "table_ref", "table_pack", "table_pack_ref"])
@pytest.mark.parametrize("name", ["silu", "gelu", "tanh", "sigmoid", "exp"])
def test_unary_matches_reference(mode, name):
    """ApproxConfig.unary, remaps and odd extension included, against the JAX
    package's: bitwise in table modes (eager oracle), close in exact mode."""
    from repro.approx import ApproxConfig as JApprox

    x = np.linspace(-12.0, 12.0, 2001).astype(np.float32)
    if name == "exp":
        x = np.minimum(x, 0.0)
    want = np.asarray(JApprox(mode=mode if mode != "table_pack" else "table_pack_ref",
                              e_a=1e-4, omega=0.2).unary(name)(jnp.asarray(x)))
    got = ApproxConfig(mode=mode, e_a=1e-4, omega=0.2).unary(name, "cpu")(
        torch.from_numpy(x)).numpy()
    if mode == "exact":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        assert_bitwise(got, want)


@pytest.mark.parametrize("exact_grad", [False, True])
@pytest.mark.parametrize("mode", ["table_ref", "table_pallas", "table_pack", "table_pack_ref"])
@pytest.mark.parametrize("name", ["silu", "gelu", "tanh", "sigmoid", "exp"])
def test_unary_grad_matches_reference(mode, name, exact_grad):
    """The gradient of ``ApproxConfig.unary`` (odd extension, remaps and
    ``exact_grad`` included) against the reference's VJP of its custom_jvp:
    bitwise with the table slope; with the analytic derivative, the
    derivative within 1e-6 relative plus 1e-6 absolute, i.e. the gradient
    within ``1e-6 * (|want| + |dy|)``.  The two frameworks' transcendentals
    differ by an ULP, and the derivatives cancel in the tails: gelu's
    ``0.5 * (1 + erf(x / sqrt 2))`` and tanh's ``1 - tanh(x)**2``, where one
    framework rounds erf or tanh to exactly -1 and the other does not."""
    from repro.approx import ApproxConfig as JApprox

    rng = np.random.default_rng(13)
    x = np.linspace(-12.0, 12.0, 2001).astype(np.float32)
    if name == "exp":
        x = np.minimum(x, 0.0)
    dy = rng.normal(0, 1, x.size).astype(np.float32)
    jmode = {"table_pallas": "table_ref", "table_pack": "table_pack_ref"}.get(mode, mode)
    jf = JApprox(mode=jmode, e_a=1e-4, omega=0.2, exact_grad=exact_grad).unary(name)
    _, vjp = jax.vjp(jf, jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(dy))[0])
    f = ApproxConfig(mode=mode, e_a=1e-4, omega=0.2, exact_grad=exact_grad).unary(name, "cpu")
    _, got = _grad(f, torch.from_numpy(x), torch.from_numpy(dy))
    if exact_grad:
        assert (np.abs(got.numpy() - want) <= 1e-6 * (np.abs(want) + np.abs(dy))).all()
    else:
        assert_bitwise(got, want)


def test_softmax_table_matches_reference():
    from repro.approx import ApproxConfig as JApprox

    rng = np.random.default_rng(5)
    x = rng.normal(0, 4, (3, 17)).astype(np.float32)
    where = rng.random((3, 17)) > 0.3
    for table in (False, True):
        jc = JApprox(mode="table_pack_ref", e_a=1e-4, softmax_table=table)
        tc = ApproxConfig(mode="table_pack_ref", e_a=1e-4, softmax_table=table)
        for w in (None, where):
            want = np.asarray(jc.softmax(jnp.asarray(x), where=None if w is None
                                         else jnp.asarray(w)))
            got = tc.softmax(torch.from_numpy(x), where=None if w is None else
                             torch.from_numpy(w), device="cpu").numpy()
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


# --------------------------------------------------------------------------------------
# The packs' shared-memory residency reports (``smem()``)
# --------------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def folded_layout():
    from repro_torch.approx import FOLDED_CORE_MEMBERS
    from repro_torch.core import pack_layout

    names = NAMES + FOLDED_CORE_MEMBERS  # stablelm's pack with rope_table's cores
    lay = pack_layout([cached_table(n, 1e-4, omega=0.2) for n in names])
    return lay, table_pack.from_layout(lay, "cpu")


@pytest.mark.parametrize("image", ["whole", "flash", "sin", "exp", "log"])
def test_smem_report_is_the_built_image(image, folded_layout):
    """``PackLayout.smem(members)`` prices, byte for byte, the staging image
    the pack builds: the whole pack's (``TablePack.image``), TableFlash's
    (``flash_image``) and each fold's (``fold_images``), at stablelm-3b's
    settings (e_a 1e-4, omega 0.2), all staged whole (under 48 KB)."""
    from repro_torch.approx import FOLDABLE

    lay, tp = folded_layout
    if image == "whole":
        report, (built, m_img) = lay.smem(), tp.image
    elif image == "flash":
        report, (built, m_img) = lay.smem(("exp_neg",)), tp.flash_image
    else:
        report, (built, m_img) = lay.smem(FOLDABLE[image]), tp.fold_images[image]
    assert report.image_bytes == built.numel() * built.element_size()
    assert report.table_bytes == 4 * m_img and report.meta_bytes > 0
    assert report.budget_bytes == 48 * 1024 and report.fits and report.staging == "image"


def test_smem_report_past_the_budget():
    """exp_neg at e_a 3e-9 (chip_smoke's phase 3 case) has an image past
    48 KB: the report says the image is not staged, and what the launch
    stages instead (the row alone: the values do not fit either)."""
    from repro_torch.core import pack_layout

    lay = pack_layout([cached_table("exp_neg", 3e-9)])
    report = lay.smem(("exp_neg",))
    built, _ = table_pack.from_layout(lay, "cpu").flash_image
    assert report.image_bytes == built.numel() * 4 > 48 * 1024
    assert not report.fits and report.staging == report.fallback == "meta"
    assert report.fallback_bytes == 4 * (4 * lay.n_max + 1)


@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
def test_smem_report_is_the_sharded_image(n_shards, folded_layout):
    """``ShardedPackLayout.smem()`` prices ``ShardedTablePack.image``; the
    value kernels' fallback stages the member's rows and the range's slab,
    all the shards (``shard=None``) or one."""
    from repro_torch.core import shard_pack_layout

    lay, _ = folded_layout
    sl = shard_pack_layout(lay, n_shards)
    sp = table_pack.from_sharded_layout(sl, "cpu")
    report, one = sl.smem(), sl.smem(shard=n_shards - 1)
    assert report.image_bytes == sp.image[0].numel() * 4 == one.image_bytes
    assert report.table_bytes == sp.values.numel() * 4
    assert one.fallback_bytes <= report.fallback_bytes
    with pytest.raises(IndexError):
        sl.smem(shard=n_shards)
