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
  ``KeyError`` for unknown names and out-of-range ids.

On the CPU the kernel wrappers run their plain versions, so the wrapper is
held to the same contract.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.approx import jax_table as jt_ref
from repro.approx import table_pack as tp_ref
from repro.core import function_names
from repro.core.flow import cached_table as j_cached
from repro.kernels.table_pack_lookup import (table_pack_lookup_pallas,
                                             tableflash_exp_pallas)
from repro_torch.approx import ApproxConfig, NOT_PORTED, torch_table, table_pack
from repro_torch.core.flow import cached_table
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
    a0, a1 = torch_table._pair_address(base, i, values.shape[0])
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

    def test_backward_raises(self, packs):
        _, tp = packs
        f = table_pack.make_pack_fn(tp, "silu", use_kernel=True)
        x = torch.linspace(-3, 3, 11, requires_grad=True)
        y = f(x)
        with pytest.raises(NotImplementedError, match="queue 1, item 6"):
            y.sum().backward()
        with torch.inference_mode():
            assert f(torch.zeros(2)).shape == (2,)

    @pytest.mark.parametrize("mode", sorted(NOT_PORTED))
    def test_unported_modes_raise(self, mode):
        with pytest.raises(NotImplementedError, match="ROADMAP queue"):
            ApproxConfig(mode=mode).unary("silu", "cpu")

    def test_unknown_mode_and_rope_table(self):
        with pytest.raises(ValueError, match="unknown approx mode"):
            ApproxConfig(mode="bogus").unary("silu", "cpu")
        with pytest.raises(NotImplementedError, match="RangeFold"):
            ApproxConfig(mode="table_pack", rope_table=True).rope_sin_cos()
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
