"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``; every test skips without a card (decided inside the fixture,
never at import, so every pytest worker collects the same tests).  Run on the
machine with the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

Comparisons are bitwise (NaN positions matched): the kernels are built with
``-fmad=false`` and round every operation as the plain versions do.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.approx import ApproxConfig
from repro_torch.approx.table_pack import (build_pack, build_poly_pack,
                                          build_quant_pack, build_sharded_pack,
                                          from_poly_layout, from_quant_layout,
                                          make_routed_unary_fn, routed_extr_flags)
from repro_torch.approx.torch_table import TorchTable, from_spec
from repro_torch.core import design
from repro_torch.core.flow import cached_table
from repro_torch.core.packing import poly_pack_layout, quant_pack_layout
from repro_torch.core.quantize import plan_quant_member
from repro_torch.kernels import routed_pack_lookup as R
from repro_torch.kernels import table_grad as TG
from repro_torch.kernels import table_lookup as TL
from repro_torch.kernels import table_pack_lookup as K

pytestmark = pytest.mark.gpu

NAMES = ("gelu", "silu", "tanh", "sigmoid_sym", "softplus", "exp_neg")
# one member per degree, each at another code width (the reference's
# tests/test_poly_pack.py MIXED pack)
MIXED = (("tanh", 1, 32), ("exp_neg", 3, 8), ("gelu", 2, 16))


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def pack(cuda):
    return build_pack(NAMES, 1e-4, omega=0.2, device=cuda)


@pytest.fixture(scope="module")
def quant(cuda):
    return build_quant_pack(NAMES, 1e-4, omega=0.2, device=cuda)


@pytest.fixture(scope="module")
def poly(cuda):
    return build_poly_pack(NAMES, 1e-4, omega=0.2, device=cuda)


@pytest.fixture(scope="module")
def mixed(cuda):
    members = [design.poly_member(n, 1e-4, degree=d, bits=b) for n, d, b in MIXED]
    return from_poly_layout(poly_pack_layout(members), cuda)


def edge_input(pack, fid, n, dtype, seed=0):
    lo, hi = pack.domains[fid]
    rng = np.random.default_rng(seed)
    b = pack.boundaries[fid, : pack.n_intervals[fid] + 1].cpu().numpy()
    tiny = np.float32(np.finfo(np.float32).smallest_subnormal)
    x = np.concatenate([
        b, np.nextafter(b, np.float32(np.inf)), np.nextafter(b, np.float32(-np.inf)),
        [np.inf, -np.inf, np.nan, -2e38, 2e38, 0.0, -0.0, tiny, -tiny, lo, hi],
        rng.uniform(lo - 4, hi + 4, n)]).astype(np.float32)
    return torch.from_numpy(x).to("cuda").to(dtype)


def ragged_edge_input(pack, fid, n, dtype, seed=0):
    """edge_input for a quantized or polynomial pack (flat boundary rows)."""
    lo, hi = pack.domains[fid]
    bo = pack.bounds_offset(fid)
    b = pack.boundaries[bo: bo + pack.n_intervals[fid] + 1].cpu().numpy()
    rng = np.random.default_rng(seed)
    tiny = np.float32(np.finfo(np.float32).smallest_subnormal)
    x = np.concatenate([
        b, np.nextafter(b, np.float32(np.inf)), np.nextafter(b, np.float32(-np.inf)),
        [np.inf, -np.inf, np.nan, -2e38, 2e38, 0.0, -0.0, tiny, -tiny, lo, hi],
        rng.uniform(lo - 4, hi + 4, n)]).astype(np.float32)
    return torch.from_numpy(x).to("cuda").to(dtype)


def assert_bitwise(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    ity = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
    both_nan = torch.isnan(got) & torch.isnan(want)
    bad = (got.view(ity) != want.view(ity)) & ~both_nan
    assert int(bad.sum()) == 0, (got[bad][:5], want[bad][:5])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("extrapolate", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_pack_kernel_bitwise(pack, name, extrapolate, dtype):
    fid = pack.fn_id(name)
    x = edge_input(pack, fid, 4093, dtype)
    got = K.table_pack_lookup(pack, fid, x, extrapolate=extrapolate)
    torch.cuda.synchronize()
    assert_bitwise(got, K.table_pack_lookup_plain(pack, fid, x,
                                                  extrapolate=extrapolate))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tableflash_kernel_bitwise(pack, dtype):
    """stablelm's pack: exp_neg's staging image fits a block's budget, so the
    launch stages the image (NaN, +-inf, subnormal and z < lo lanes
    included)."""
    assert 4 * pack.flash_image[0].numel() <= SMEM_BUDGET
    fid = pack.fn_id("exp_neg")
    x = torch.cat([edge_input(pack, fid, 2000, dtype),
                   torch.linspace(-40, 0, 3001, device="cuda").to(dtype)])
    got = K.tableflash_exp(pack, x)
    torch.cuda.synchronize()
    assert_bitwise(got, K.tableflash_exp_plain(pack, x))
    assert (got[x < -16.0] == 0).all()


def test_values_beyond_shared_memory(cuda):
    """A pack larger than the kernel's static shared budget (10,240 f32
    values) is read from global memory: same bits.  TableFlash over it stages
    exp_neg's image (23 KB); at e_a 3e-9 that image is past the budget too,
    and the launch stages exp_neg's row and reads the values from global
    memory: same bits, NaN lanes included."""
    big = build_pack(("silu", "exp_neg"), 3e-8, omega=0.2, device=cuda)
    assert big.footprint > 10240
    for fid in range(2):
        x = edge_input(big, fid, 5000, torch.float32, seed=fid)
        assert_bitwise(K.table_pack_lookup(big, fid, x, extrapolate=True),
                       K.table_pack_lookup_plain(big, fid, x, extrapolate=True))
    finer = build_pack(("silu", "exp_neg"), 3e-9, omega=0.2, device=cuda)
    for pk, fits in ((big, True), (finer, False)):
        assert (4 * pk.flash_image[0].numel() <= SMEM_BUDGET) == fits
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.cat([edge_input(pk, 1, 3000, dtype, seed=2),
                           torch.linspace(-30, 0, 7777, device="cuda").to(dtype)])
            assert_bitwise(K.tableflash_exp(pk, x), K.tableflash_exp_plain(pk, x))


def test_wrapper_contract(pack):
    K.reset_launches()
    x = torch.randn(3, 5, 7, device="cuda").transpose(0, 2)  # not contiguous
    y = K.table_pack_lookup(pack, "silu", x)
    assert y.shape == x.shape and y.stride() == x.stride()  # as torch.exp(x) would
    assert_bitwise(y, K.table_pack_lookup_plain(pack, "silu", x))
    K.tableflash_exp(pack, -x.abs())
    K.table_pack_lookup(pack, "silu", torch.empty(0, device="cuda"))  # no launch
    cpu_pack = build_pack(NAMES, 1e-4, omega=0.2, device="cpu")
    K.table_pack_lookup(cpu_pack, "silu", x.cpu())  # plain version, no launch
    assert K.launches == {"table_pack_lookup": 1, "tableflash_exp": 1,
                          "table_pack_grad": 0, "table_lookup": 0,
                          "table_lookup_grad": 0, "quant_pack_lookup": 0,
                          "quant_pack_grad": 0, "poly_pack_lookup": 0,
                          "poly_pack_grad": 0,
                          "routed_pack_lookup": 0, "routed_pack_grad": 0,
                          "routed_quant_pack_lookup": 0, "routed_quant_pack_grad": 0,
                          "folded_pack_lookup": 0, "folded_pack_grad": 0,
                          "routed_poly_pack_lookup": 0, "routed_poly_pack_grad": 0,
                          "sharded_pack_lookup": 0, "sharded_pack_grad": 0,
                          "sharded_routed_pack_lookup": 0,
                          "sharded_routed_pack_grad": 0}
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        K.table_pack_lookup(pack, "silu", x.half())
    for p, t in ((cpu_pack, x), (pack, x.cpu())):
        with pytest.raises(ValueError, match="pack lives on"):
            K.table_pack_lookup(p, "silu", t)
        with pytest.raises(ValueError, match="pack lives on"):
            K.tableflash_exp(p, t)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("extrapolate", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_pack_grad_kernel_bitwise(pack, name, extrapolate, dtype):
    fid = pack.fn_id(name)
    x = edge_input(pack, fid, 4093, dtype)
    y, slope = K.table_pack_grad(pack, fid, x, extrapolate=extrapolate)
    torch.cuda.synchronize()
    want_y, want_s = K.table_pack_grad_plain(pack, fid, x, extrapolate=extrapolate)
    assert_bitwise(y, want_y)
    assert_bitwise(slope, want_s)
    assert_bitwise(y, K.table_pack_lookup(pack, fid, x, extrapolate=extrapolate))


def _table_edges(jt, n, dtype, seed=0):
    """Every boundary and its neighbours, specials, and uniform draws."""
    lo, hi = float(jt.boundaries[0]), float(jt.boundaries[-1])
    rng = np.random.default_rng(seed)
    b = jt.boundaries.cpu().numpy()
    tiny = np.float32(np.finfo(np.float32).smallest_subnormal)
    x = np.concatenate([
        b, np.nextafter(b, np.float32(np.inf)), np.nextafter(b, np.float32(-np.inf)),
        [np.inf, -np.inf, np.nan, -2e38, 2e38, 0.0, -0.0, tiny, -tiny, lo, hi],
        rng.uniform(lo - 4, hi + 4, n)]).astype(np.float32)
    return torch.from_numpy(x).to("cuda").to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("extrapolate", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_table_kernels_bitwise(cuda, name, extrapolate, dtype):
    jt = ApproxConfig(e_a=1e-4, omega=0.2).table_for(name, cuda)
    x = _table_edges(jt, 4093, dtype)
    got = TL.table_lookup(jt, x, extrapolate=extrapolate)
    y, slope = TG.table_lookup_grad(jt, x, extrapolate=extrapolate)
    torch.cuda.synchronize()
    want_y, want_s = TG.table_lookup_grad_plain(jt, x, extrapolate=extrapolate)
    assert_bitwise(got, TL.table_lookup_plain(jt, x, extrapolate=extrapolate))
    assert_bitwise(y, want_y)
    assert_bitwise(slope, want_s)


def test_grad_kernels_beyond_shared_memory(cuda):
    """A pack and a table larger than the static shared budget (10,240 f32
    values) are read from global memory: same bits, value and slope."""
    big = build_pack(("silu", "exp_neg"), 3e-8, omega=0.2, device=cuda)
    assert big.footprint > 10240
    for fid in range(2):
        x = edge_input(big, fid, 5000, torch.float32, seed=fid)
        for ex in (False, True):
            for a, b in zip(K.table_pack_grad(big, fid, x, extrapolate=ex),
                            K.table_pack_grad_plain(big, fid, x, extrapolate=ex)):
                assert_bitwise(a, b)
    jt = from_spec(cached_table("silu", 3e-8, omega=0.2), cuda)
    assert jt.footprint > 10240
    x = _table_edges(jt, 5000, torch.float32)
    assert_bitwise(TL.table_lookup(jt, x, extrapolate=True),
                   TL.table_lookup_plain(jt, x, extrapolate=True))
    for a, b in zip(TG.table_lookup_grad(jt, x), TG.table_lookup_grad_plain(jt, x)):
        assert_bitwise(a, b)


@pytest.mark.parametrize("T", [27, 283, 1500])
def test_flash_attention_kernel_exponent_bitwise_plain(pack, cuda, T):
    """flash_attention with the TableFlash kernel equals the same attention
    with its plain version, bit for bit, at internvl2-1b's prefill width
    (256 patches + 27 tokens: 283 queries and keys) and whisper's encoder
    (1,500, with KV_PAD lanes): the exponent's input comes permuted from
    the score einsum, and the kernel's output must keep that layout, or the
    running sum over the keys adds in another order (2 of 4 x 283 x 16 x 64
    outputs of a layer differed when the kernel's output was contiguous)."""
    from repro_torch.approx.table_pack import make_attn_exp_fn
    from repro_torch.models.attention import flash_attention

    g = torch.Generator(device="cuda").manual_seed(T)
    q = torch.randn((4, T, 16, 1, 64), generator=g, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn((4, T, 16, 64), generator=g, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    pos = torch.arange(T, device="cuda")
    for causal in (True, False):
        got, want = (flash_attention(q, k, v, pos, pos, causal=causal,
                                     exp_fn=make_attn_exp_fn(pack, use_kernel=u))
                     for u in (True, False))
        assert_bitwise(got, want)
    z = torch.einsum("bsgqd,btgd->bsgqt", q.float(), k.float()).clamp(max=0)
    assert not z.is_contiguous()  # the score einsum's layout, group axis outermost
    assert K.tableflash_exp(pack, z).stride() == K.tableflash_exp_plain(pack, z).stride()


def test_grad_wrappers_contract(pack, cuda):
    K.reset_launches()
    jt = ApproxConfig(e_a=1e-4, omega=0.2).table_for("silu", cuda)
    x = torch.randn(3, 5, 7, device="cuda").transpose(0, 2)  # not contiguous
    for y, s in (K.table_pack_grad(pack, "silu", x), TG.table_lookup_grad(jt, x)):
        assert y.shape == s.shape == x.shape and y.stride() == s.stride() == x.stride()
    TL.table_lookup(jt, x)
    TL.table_lookup(jt, torch.empty(0, device="cuda"))  # no launch
    TG.table_lookup_grad(jt, torch.empty(0, device="cuda"))
    assert K.launches == {"table_pack_lookup": 0, "tableflash_exp": 0,
                          "table_pack_grad": 1, "table_lookup": 1,
                          "table_lookup_grad": 1, "quant_pack_lookup": 0,
                          "quant_pack_grad": 0, "poly_pack_lookup": 0,
                          "poly_pack_grad": 0,
                          "routed_pack_lookup": 0, "routed_pack_grad": 0,
                          "routed_quant_pack_lookup": 0, "routed_quant_pack_grad": 0,
                          "folded_pack_lookup": 0, "folded_pack_grad": 0,
                          "routed_poly_pack_lookup": 0, "routed_poly_pack_grad": 0,
                          "sharded_pack_lookup": 0, "sharded_pack_grad": 0,
                          "sharded_routed_pack_lookup": 0,
                          "sharded_routed_pack_grad": 0}
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        TG.table_lookup_grad(jt, x.half())
    with pytest.raises(ValueError, match="table lives on"):
        TL.table_lookup(jt, x.cpu())
    with pytest.raises(ValueError, match="pack lives on"):
        K.table_pack_grad(pack, "silu", x.cpu())
    # 65 sub-intervals, one more than the kernels once staged (and refused
    # beyond): served, bitwise equal to the plain versions
    n = 65
    wide = TorchTable(
        boundaries=torch.linspace(0, 1, n + 1, device="cuda"),
        inv_delta=torch.full((n,), float(n), device="cuda"),
        delta=torch.full((n,), 1.0 / n, device="cuda"),
        base=torch.arange(n, dtype=torch.float32, device="cuda") * 2,
        seg_count=torch.ones(n, device="cuda"),
        values=torch.randn(2 * n + 1, generator=torch.Generator().manual_seed(0)).cuda())
    xw = _table_edges(wide, 4093, torch.float32)
    for ex in (False, True):
        assert_bitwise(TL.table_lookup(wide, xw, extrapolate=ex),
                       TL.table_lookup_plain(wide, xw, extrapolate=ex))
        for a, b in zip(TG.table_lookup_grad(wide, xw, extrapolate=ex),
                        TG.table_lookup_grad_plain(wide, xw, extrapolate=ex)):
            assert_bitwise(a, b)
    assert K.launches["table_lookup"] == 3 and K.launches["table_lookup_grad"] == 3
    # the 279-interval quantized silu member (stablelm's settings at e_a 1e-6)
    q = build_quant_pack(NAMES, 1e-6, omega=0.2, device=cuda)
    fid = q.fn_id("silu")
    assert q.n_intervals[fid] == 279
    xq = ragged_edge_input(q, fid, 4093, torch.float32)
    for ex in (False, True):
        for a, b in zip(K.quant_pack_grad(q, fid, xq, extrapolate=ex),
                        K.quant_pack_grad_plain(q, fid, xq, extrapolate=ex)):
            assert_bitwise(a, b)


def test_reduced_model_trains_card_matches_cpu(cuda):
    """Reduced stablelm, f32, table_pack with TableFlash, 2 train steps
    (accum 2): the kernels on the card against the plain versions on the CPU,
    losses within 1e-4 relative (the card and the CPU sum the matrix
    products in other orders)."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import build_model, reduced
    from repro_torch.optim import adamw
    from repro_torch.train.loop import batch_to, init_state, make_train_step
    from repro_torch.tree import tree_map

    cfg = reduced("stablelm-3b").replace(compute_dtype="float32", approx=ApproxConfig(
        mode="table_pack", e_a=1e-4, omega=0.2, attn_table=True))
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, global_batch=4, seq_len=16))
    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=2)
    cpu_state = init_state(build_model(cfg, "cpu"))
    losses = {}
    for dev in ("cpu", "cuda"):
        model = build_model(cfg, dev)
        state = tree_map(lambda t: t.detach().clone().to(dev), cpu_state)
        step = make_train_step(model, opt, accum=2)
        K.reset_launches()
        losses[dev] = []
        for s in range(2):
            state, m = step(state, batch_to(data.batch_at(s), dev))
            losses[dev].append(float(m["loss"]))
        if dev == "cuda":
            assert K.launches["table_pack_grad"] > 0 and K.launches["tableflash_exp"] > 0
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)


def test_reduced_model_card_matches_cpu(cuda):
    """Reduced stablelm, f32, table_pack with TableFlash: the kernels on the
    card against the plain versions on the CPU (logits within 1e-4, same
    greedy tokens)."""
    from repro_torch.models import build_model, reduced
    from repro_torch.serving.engine import ContinuousEngine, Request

    cfg = reduced("stablelm-3b").replace(compute_dtype="float32", approx=ApproxConfig(
        mode="table_pack", e_a=1e-4, omega=0.2, attn_table=True))
    cpu_model, gpu_model = build_model(cfg, "cpu"), build_model(cfg, cuda)
    params = cpu_model.init(torch.Generator().manual_seed(0))

    def to(t, dev):
        if isinstance(t, dict):
            return {k: to(v, dev) for k, v in t.items()}
        if isinstance(t, list):
            return [to(v, dev) for v in t]
        return t.to(dev)

    rng = np.random.default_rng(2)
    reqs = [Request(prompt=rng.integers(0, 128, (int(n),)).astype(np.int32),
                    max_new_tokens=6) for n in rng.integers(3, 12, 5)]
    K.reset_launches()
    got = ContinuousEngine(gpu_model, to(params, cuda), 2, 64).serve(reqs)
    assert K.launches["table_pack_lookup"] > 0 and K.launches["tableflash_exp"] > 0
    want = ContinuousEngine(cpu_model, params, 2, 64).serve(reqs)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.tokens, b.tokens)


# --------------------------------------------------------------------------------------
# QuantPack and PolyPack kernels
# --------------------------------------------------------------------------------------


def _value_and_grad_bitwise(lookup, grad, lookup_plain, grad_plain, pack, fid, x, ex):
    got = lookup(pack, fid, x, extrapolate=ex)
    y, slope = grad(pack, fid, x, extrapolate=ex)
    torch.cuda.synchronize()
    want_y, want_s = grad_plain(pack, fid, x, extrapolate=ex)
    assert_bitwise(got, lookup_plain(pack, fid, x, extrapolate=ex))
    assert_bitwise(y, want_y)
    assert_bitwise(slope, want_s)
    assert_bitwise(got, y)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("extrapolate", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_quant_kernels_bitwise(quant, name, extrapolate, dtype):
    fid = quant.fn_id(name)
    _value_and_grad_bitwise(K.quant_pack_lookup, K.quant_pack_grad,
                            K.quant_pack_lookup_plain, K.quant_pack_grad_plain,
                            quant, fid, ragged_edge_input(quant, fid, 4093, dtype),
                            extrapolate)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("extrapolate", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_poly_kernels_bitwise(poly, name, extrapolate, dtype):
    fid = poly.fn_id(name)
    _value_and_grad_bitwise(K.poly_pack_lookup, K.poly_pack_grad,
                            K.poly_pack_lookup_plain, K.poly_pack_grad_plain,
                            poly, fid, ragged_edge_input(poly, fid, 4093, dtype),
                            extrapolate)


@pytest.mark.parametrize("extrapolate", [False, True])
def test_mixed_poly_pack_bitwise(mixed, extrapolate):
    """Degrees 1, 2, 3 at code widths f32, int16, int8 in one pack."""
    assert mixed.entry_bits == (32, 8, 16) and mixed.max_lanes == 4
    for fid in range(len(MIXED)):
        for dtype in (torch.float32, torch.bfloat16):
            _value_and_grad_bitwise(
                K.poly_pack_lookup, K.poly_pack_grad, K.poly_pack_lookup_plain,
                K.poly_pack_grad_plain, mixed, fid,
                ragged_edge_input(mixed, fid, 4093, dtype, seed=fid), extrapolate)


def test_quant_members_beyond_64_intervals(cuda):
    """The quantized pack at e_a 1e-6: every member has 119 to 279
    sub-intervals; all served, bitwise, value and slope, both dtypes."""
    q = build_quant_pack(NAMES, 1e-6, omega=0.2, device=cuda)
    assert min(q.n_intervals) > 64
    for fid in range(len(NAMES)):
        for dtype in (torch.float32, torch.bfloat16):
            for ex in (False, True):
                _value_and_grad_bitwise(
                    K.quant_pack_lookup, K.quant_pack_grad, K.quant_pack_lookup_plain,
                    K.quant_pack_grad_plain, q, fid,
                    ragged_edge_input(q, fid, 4093, dtype, seed=fid), ex)


def test_global_memory_metadata(cuda):
    """Metadata rows beyond the kernels' 48 KB of shared staging (a
    4,000-interval table, a 2,500-interval polynomial member) are read from
    global memory: same bits."""
    n = 4000
    rng = np.random.default_rng(3)
    wide = TorchTable(
        boundaries=torch.linspace(-2, 2, n + 1, device="cuda"),
        inv_delta=torch.full((n,), n / 4.0, device="cuda"),
        delta=torch.full((n,), 4.0 / n, device="cuda"),
        base=torch.arange(n, dtype=torch.float32, device="cuda") * 2,
        seg_count=torch.ones(n, device="cuda"),
        values=torch.from_numpy(rng.normal(0, 1, 2 * n + 1).astype(np.float32)).cuda())
    x = _table_edges(wide, 20000, torch.float32)
    for ex in (False, True):
        assert_bitwise(TL.table_lookup(wide, x, extrapolate=ex),
                       TL.table_lookup_plain(wide, x, extrapolate=ex))
        for a, b in zip(TG.table_lookup_grad(wide, x, extrapolate=ex),
                        TG.table_lookup_grad_plain(wide, x, extrapolate=ex)):
            assert_bitwise(a, b)
    member = design.poly_member("silu", 1e-4, degree=1, bits=32)
    n = 2500
    spaced = dataclasses.replace(
        member, boundaries=np.linspace(member.lo, member.hi, n + 1),
        inv_delta=np.full(n, 1.0), delta=np.full(n, 1.0),
        base=np.arange(n) * 2, seg_count=np.ones(n, np.int64),
        zero=np.zeros((n, 2)), ramp=np.zeros((n, 2)), scale=np.ones((n, 2)),
        codes=rng.normal(0, 1, 2 * n))
    pk = from_poly_layout(poly_pack_layout([spaced]), cuda)
    x = ragged_edge_input(pk, 0, 20000, torch.float32)
    for ex in (False, True):
        _value_and_grad_bitwise(K.poly_pack_lookup, K.poly_pack_grad,
                                K.poly_pack_lookup_plain, K.poly_pack_grad_plain,
                                pk, 0, x, ex)


def test_quant_poly_wrappers_contract(quant, poly, cuda):
    K.reset_launches()
    x = torch.randn(3, 5, 7, device="cuda").transpose(0, 2)  # not contiguous
    for lookup, grad, pk in ((K.quant_pack_lookup, K.quant_pack_grad, quant),
                             (K.poly_pack_lookup, K.poly_pack_grad, poly)):
        y = lookup(pk, "silu", x)
        yg, s = grad(pk, "silu", x)
        assert y.shape == yg.shape == s.shape == x.shape
        assert y.stride() == yg.stride() == s.stride() == x.stride()
        lookup(pk, "silu", torch.empty(0, device="cuda"))  # no launch
        grad(pk, "silu", torch.empty(0, device="cuda"))
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            lookup(pk, "silu", x.half())
        with pytest.raises(ValueError, match="pack lives on"):
            grad(pk, "silu", x.cpu())
        with pytest.raises(KeyError):
            lookup(pk, 9, x)
    cpu_q = build_quant_pack(NAMES, 1e-4, omega=0.2, device="cpu")
    K.quant_pack_lookup(cpu_q, "silu", x.cpu())  # plain version, no launch
    with pytest.raises(ValueError, match="pack lives on"):
        K.quant_pack_lookup(cpu_q, "silu", x)
    assert K.launches == {"table_pack_lookup": 0, "tableflash_exp": 0,
                          "table_pack_grad": 0, "table_lookup": 0,
                          "table_lookup_grad": 0, "quant_pack_lookup": 1,
                          "quant_pack_grad": 1, "poly_pack_lookup": 1,
                          "poly_pack_grad": 1,
                          "routed_pack_lookup": 0, "routed_pack_grad": 0,
                          "routed_quant_pack_lookup": 0, "routed_quant_pack_grad": 0,
                          "folded_pack_lookup": 0, "folded_pack_grad": 0,
                          "routed_poly_pack_lookup": 0, "routed_poly_pack_grad": 0,
                          "sharded_pack_lookup": 0, "sharded_pack_grad": 0,
                          "sharded_routed_pack_lookup": 0,
                          "sharded_routed_pack_grad": 0}


@pytest.mark.parametrize("mode", ["quant_pack", "poly_pack"])
def test_reduced_quant_poly_card_matches_cpu(cuda, mode):
    """Reduced stablelm, f32, in ``mode`` with TableFlash: serving on the card
    (the quant/poly kernels and tableflash_exp) token-identical to the plain
    versions on the CPU, and 2 train steps with losses within 1e-4 relative
    (the card and the CPU sum the matrix products in other orders)."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import build_model, reduced
    from repro_torch.optim import adamw
    from repro_torch.serving.engine import ContinuousEngine, Request
    from repro_torch.train.loop import batch_to, init_state, make_train_step
    from repro_torch.tree import tree_map

    cfg = reduced("stablelm-3b").replace(compute_dtype="float32", approx=ApproxConfig(
        mode=mode, e_a=1e-4, omega=0.2, attn_table=True))
    rng = np.random.default_rng(2)
    reqs = [Request(prompt=rng.integers(0, 128, (int(n),)).astype(np.int32),
                    max_new_tokens=6) for n in rng.integers(3, 12, 5)]
    cpu_state = init_state(build_model(cfg, "cpu"))
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, global_batch=4, seq_len=16))
    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=2)
    served, losses = {}, {}
    for dev in ("cpu", "cuda"):
        model = build_model(cfg, dev)
        state = tree_map(lambda t: t.detach().clone().to(dev), cpu_state)
        K.reset_launches()
        served[dev] = ContinuousEngine(model, state["params"], 2, 64).serve(reqs)
        step = make_train_step(model, opt, accum=2)
        losses[dev] = []
        for s in range(2):
            state, m = step(state, batch_to(data.batch_at(s), dev))
            losses[dev].append(float(m["loss"]))
        if dev == "cuda":
            assert K.launches[f"{mode}_lookup"] > 0 and K.launches[f"{mode}_grad"] > 0
            assert K.launches["tableflash_exp"] > 0
    for a, b in zip(served["cuda"], served["cpu"]):
        np.testing.assert_array_equal(a.tokens, b.tokens)
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)


# --------------------------------------------------------------------------------------
# routed dispatch
# --------------------------------------------------------------------------------------

# the reference's tests/test_routed_pack.py mixed_width_pack
MIXED_WIDTHS = (("gelu", "int8"), ("tanh", "int16"), ("log", "int16"),
                ("sigmoid", "int8"))


@pytest.fixture(scope="module")
def routed_packs(cuda, pack, quant, poly, mixed):
    mixed_w = from_quant_layout(quant_pack_layout(
        [plan_quant_member(n, 1e-4, dtype=d) for n, d in MIXED_WIDTHS]), cuda)
    fine = build_quant_pack(NAMES, 1e-6, omega=0.2, device=cuda)
    # the mixed poly pack at e_a 1e-8: past the 48 KB a block stages whole
    # (the per-member restage)
    big = from_poly_layout(poly_pack_layout(
        [design.poly_member(n, 1e-8, degree=d, bits=b) for n, d, b in MIXED]), cuda)
    # stablelm's members at e_a 3e-7: a quant image past the 48 KB (the
    # per-member restage), and an f32 image past it too (61,400 bytes with
    # the per-member scalars: the row restaged per member); at e_a 1e-6 the
    # f32 image (34,088 bytes) is staged whole, in several batches of loads
    finer = build_quant_pack(NAMES, 3e-7, omega=0.2, device=cuda)
    return {"f32": pack, "f32_1e-6": build_pack(NAMES, 1e-6, omega=0.2, device=cuda),
            "f32_past_budget": build_pack(NAMES, 3e-7, omega=0.2, device=cuda),
            "quant": quant, "mixed": mixed_w, "quant_1e-6": fine,
            "quant_past_budget": finer, "poly": poly, "mixed_poly": mixed,
            "poly_past_budget": big}


SMEM_BUDGET = 48 * 1024  # the kernels' dynamic shared memory (kSmemBytes)


def test_routed_poly_staging_paths(routed_packs):
    """stablelm's and the mixed poly packs fit a block's budget whole (image
    and flags), so their routed launches stage the whole pack; the pack at
    e_a 1e-8 does not, so its launches restage per member."""
    for kind, whole in (("poly", True), ("mixed_poly", True), ("poly_past_budget", False)):
        pk = routed_packs[kind]
        assert (4 * (pk.image.numel() + pk.n_functions) <= SMEM_BUDGET) == whole, kind


def test_routed_quant_staging_paths(routed_packs):
    """stablelm's, the mixed-width and the e_a 1e-6 quant packs fit a
    block's budget whole (image and flags), so their routed launches stage
    the whole pack; the pack at e_a 3e-7 does not, so its launches restage
    per member."""
    for kind, whole in (("quant", True), ("mixed", True), ("quant_1e-6", True),
                        ("quant_past_budget", False)):
        pk = routed_packs[kind]
        assert (4 * (pk.image.numel() + pk.n_functions) <= SMEM_BUDGET) == whole, kind


def test_routed_f32_staging_paths(routed_packs):
    """stablelm's f32 pack and the one at e_a 1e-6 fit a block's budget
    whole (image, interval counts, row starts and flags), so their routed
    launches stage the whole pack (routed_pack_image_kernel); the pack at
    e_a 3e-7 does not, so its launches restage a row per member
    (routed_kernel)."""
    for kind, whole in (("f32", True), ("f32_1e-6", True), ("f32_past_budget", False)):
        pk = routed_packs[kind]
        image, m_img = pk.image
        assert image.numel() == (4 * sum(pk.n_intervals) + pk.n_functions + m_img + 3) // 4 * 4
        assert (4 * (image.numel() + 3 * pk.n_functions) <= SMEM_BUDGET) == whole, kind
    assert routed_packs["f32"].image[0].numel() == 1020  # one batch of 4 loads a thread


def test_static_poly_staging_paths(routed_packs):
    """stablelm's and the mixed poly packs' staging images fit a block's
    budget, so a static poly launch stages the image (poly_image_kernel);
    the mixed pack at e_a 1e-8 does not, so it stages the member's lanes and
    code group as the budget allows (poly_kernel)."""
    for kind, fits in (("poly", True), ("mixed_poly", True), ("poly_past_budget", False)):
        assert (4 * routed_packs[kind].image.numel() <= SMEM_BUDGET) == fits, kind
    assert routed_packs["poly"].image.numel() == 554  # one batch of 4 loads a thread


@pytest.mark.parametrize("extrapolate", [False, True])
def test_poly_kernels_past_the_budget_bitwise(routed_packs, extrapolate):
    """The static poly kernels over a pack whose staging image is past the
    budget (the mixed pack at e_a 1e-8: degrees 1-3 at f32, int8 and int16):
    every member, value and slope, both dtypes, with NaN, +-inf, subnormal
    and out-of-domain lanes."""
    big = routed_packs["poly_past_budget"]
    for fid in range(big.n_functions):
        for dtype in (torch.float32, torch.bfloat16):
            _value_and_grad_bitwise(
                K.poly_pack_lookup, K.poly_pack_grad, K.poly_pack_lookup_plain,
                K.poly_pack_grad_plain, big, fid,
                ragged_edge_input(big, fid, 4093, dtype, seed=fid), extrapolate)



@pytest.fixture(scope="module")
def tables(cuda):
    """silu's table at stablelm's settings (848-byte staging image), at e_a
    3e-8 (41,712 bytes: staged, in several batches of loads) and at e_a 1e-8
    (72,064 bytes: past the budget)."""
    return {"silu": ApproxConfig(e_a=1e-4, omega=0.2).table_for("silu", cuda),
            "silu_3e-8": from_spec(cached_table("silu", 3e-8, omega=0.2), cuda),
            "silu_past_budget": from_spec(cached_table("silu", 1e-8, omega=0.2), cuda)}


def test_static_f32_quant_table_staging_paths(routed_packs, tables):
    """Where a static f32-pack, table or quant launch stages the staging
    image (the pack's, the table's; pack_image_kernel, quant_image_kernel)
    and where the image is past the budget (the member's row or lanes and
    its values or codes as the budget allows; pack_kernel, quant_kernel)."""
    for kind, fits in (("f32", True), ("f32_1e-6", True), ("f32_past_budget", False)):
        assert (4 * routed_packs[kind].image[0].numel() <= SMEM_BUDGET) == fits, kind
    for kind, fits in (("quant", True), ("mixed", True), ("quant_1e-6", True),
                       ("quant_past_budget", False)):
        assert (4 * routed_packs[kind].image.numel() <= SMEM_BUDGET) == fits, kind
    for kind, fits in (("silu", True), ("silu_3e-8", True), ("silu_past_budget", False)):
        assert (4 * tables[kind].image.numel() <= SMEM_BUDGET) == fits, kind
    # one batch of loads a thread: 4 of 256 threads, 8 for the quant image
    assert routed_packs["f32"].image[0].numel() == 1020
    assert routed_packs["quant"].image.numel() == 1161


def _table_fn(f):
    """A table kernel or plain version in the pack ones' form."""
    return lambda jt, _fid, x, extrapolate: f(jt, x, extrapolate=extrapolate)


@pytest.mark.parametrize("extrapolate", [False, True])
@pytest.mark.parametrize("kind", ["f32_1e-6", "f32_past_budget", "mixed", "quant_1e-6",
                                  "quant_past_budget", "silu_3e-8", "silu_past_budget"])
def test_static_kernels_on_both_staging_paths_bitwise(routed_packs, tables, kind,
                                                      extrapolate):
    """The static f32-pack, table and quant kernels (value, value + slope)
    over packs and tables whose staging image is staged and past the
    budget (stablelm's own: the tests above): every member, both dtypes,
    with NaN, +-inf, subnormal and out-of-domain lanes."""
    K.reset_launches()
    if kind.startswith("silu"):
        jt = tables[kind]
        for dtype in (torch.float32, torch.bfloat16):
            _value_and_grad_bitwise(
                _table_fn(TL.table_lookup), _table_fn(TG.table_lookup_grad),
                _table_fn(TL.table_lookup_plain), _table_fn(TG.table_lookup_grad_plain),
                jt, 0, _table_edges(jt, 4093, dtype, seed=3), extrapolate)
        assert K.launches["table_lookup"] == K.launches["table_lookup_grad"] == 2
        return
    pk = routed_packs[kind]
    f32 = kind.startswith("f32")
    fns = ((K.table_pack_lookup, K.table_pack_grad, K.table_pack_lookup_plain,
            K.table_pack_grad_plain) if f32 else
           (K.quant_pack_lookup, K.quant_pack_grad, K.quant_pack_lookup_plain,
            K.quant_pack_grad_plain))
    edges = edge_input if f32 else ragged_edge_input
    for fid in range(pk.n_functions):
        for dtype in (torch.float32, torch.bfloat16):
            _value_and_grad_bitwise(*fns, pk, fid, edges(pk, fid, 4093, dtype, seed=fid),
                                    extrapolate)
    count = "table_pack" if f32 else "quant_pack"
    assert (K.launches[f"{count}_lookup"] == K.launches[f"{count}_grad"]
            == 2 * pk.n_functions)


def _routed_fns(pack):
    """(routed value, routed grad, their plain versions, static value, static
    grad) of a pack's family."""
    if hasattr(pack, "owned"):
        return (R.sharded_routed_pack_lookup, R.sharded_routed_pack_grad,
                R.sharded_routed_pack_lookup_plain, R.sharded_routed_pack_grad_plain,
                K.sharded_pack_lookup, K.sharded_pack_grad)
    if hasattr(pack, "n_max"):
        return (R.routed_pack_lookup, R.routed_pack_grad, R.routed_pack_lookup_plain,
                R.routed_pack_grad_plain, K.table_pack_lookup, K.table_pack_grad)
    if hasattr(pack, "degrees"):
        return (R.routed_poly_pack_lookup, R.routed_poly_pack_grad,
                R.routed_poly_pack_lookup_plain, R.routed_poly_pack_grad_plain,
                K.poly_pack_lookup, K.poly_pack_grad)
    return (R.routed_quant_pack_lookup, R.routed_quant_pack_grad,
            R.routed_quant_pack_lookup_plain, R.routed_quant_pack_grad_plain,
            K.quant_pack_lookup, K.quant_pack_grad)


def _member_edges(pack, fid, n, dtype, seed):
    if hasattr(pack, "n_max"):
        return edge_input(pack, fid, n, dtype, seed)
    return ragged_edge_input(pack, fid, n, dtype, seed)


def _routed_check(pack, ids, x, ex):
    """Both routed kernels bitwise against their plain versions and, row by
    row, against the static kernels of the row's member."""
    val, grad, val_plain, grad_plain, static, static_grad = _routed_fns(pack)
    got = val(pack, ids, x, extrapolate=ex)
    y, s = grad(pack, ids, x, extrapolate=ex)
    torch.cuda.synchronize()
    want_y, want_s = grad_plain(pack, ids, x, extrapolate=ex)
    assert_bitwise(got, val_plain(pack, ids, x, extrapolate=ex))
    assert_bitwise(y, want_y)
    assert_bitwise(s, want_s)
    flags = [bool(f) for f in routed_extr_flags(pack, ex)]
    ids_host = torch.as_tensor(
        ids.tolist() if torch.is_tensor(ids) else [pack.member_id(i) for i in ids])
    ids_host = ids_host.clamp(0, pack.n_functions - 1)
    for f in range(pack.n_functions):  # the rows of member f, one static launch
        rows = torch.nonzero(ids_host == f).flatten().to("cuda")
        if not rows.numel():
            continue
        xs = x[rows]
        assert_bitwise(got[rows], static(pack, f, xs, extrapolate=flags[f]))
        sy, ss = static_grad(pack, f, xs, extrapolate=flags[f])
        assert_bitwise(y[rows], sy)
        assert_bitwise(s[rows], ss)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("flags", ["off", "on", "per_member"])
@pytest.mark.parametrize("kind", ["f32", "f32_1e-6", "f32_past_budget", "quant",
                                  "mixed", "quant_1e-6", "quant_past_budget", "poly",
                                  "mixed_poly", "poly_past_budget"])
def test_routed_kernels_bitwise(routed_packs, kind, flags, dtype):
    pk = routed_packs[kind]
    F = pk.n_functions
    ex = (tuple(f % 2 == 0 for f in range(F)) if flags == "per_member"
          else flags == "on")
    ids = [(3 * r + 1) % F for r in range(2 * F + 1)]
    x = torch.stack([_member_edges(pk, f, 4000, dtype, seed=r)[:4000]
                     for r, f in enumerate(ids)])
    _routed_check(pk, ids, x, ex)
    # the same rows as a device tensor of ids, out-of-range ones clamped
    raw = torch.tensor([ids[0], -5, 10_000] + ids[3:], device="cuda")
    _routed_check(pk, raw, x, ex)


@pytest.mark.parametrize("kind", ["f32", "f32_past_budget", "quant",
                                  "quant_past_budget", "poly", "poly_past_budget"])
def test_routed_rows_beyond_grid_limit(routed_packs, kind):
    """70,000 rows of 3 (more rows than a CUDA grid's y or z extent holds)."""
    pk = routed_packs[kind]
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((70_000, 3), generator=g, device="cuda") * 6
    ids = torch.arange(70_000, device="cuda") % pk.n_functions
    for ex in (False, True):
        _routed_check(pk, ids, x, ex)


@pytest.mark.parametrize("kind", ["f32", "f32_past_budget", "quant", "mixed",
                                  "quant_past_budget", "poly", "mixed_poly",
                                  "poly_past_budget"])
def test_routed_cuda_graph_reroute(routed_packs, kind):
    """A routed call captured in a CUDA graph reads the ids tensor at replay:
    rewriting it in place re-routes the replay, with no capture anew."""
    pk = routed_packs[kind]
    val, grad, val_plain, grad_plain, _, _ = _routed_fns(pk)
    F = pk.n_functions
    ids = torch.arange(8, device="cuda", dtype=torch.int32) % F
    x = torch.randn((8, 3000), device="cuda") * 5
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):  # warm up: builds and loads the kernels
        val(pk, ids, x)
        grad(pk, ids, x, extrapolate=True)
    torch.cuda.current_stream().wait_stream(s)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = val(pk, ids, x)
        y, d = grad(pk, ids, x, extrapolate=True)
    for new in ([F - 1 - (r % F) for r in range(8)], [2] * 8, [0, 99, -1, 3, 1, 1, 0, 4]):
        ids.copy_(torch.tensor(new, device="cuda", dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        assert_bitwise(out, val_plain(pk, ids, x))
        want_y, want_d = grad_plain(pk, ids, x, extrapolate=True)
        assert_bitwise(y, want_y)
        assert_bitwise(d, want_d)


def test_routed_device_ids_make_no_host_sync(routed_packs):
    """With the ids on the card, a routed call never synchronizes with the
    host (torch's sync debug mode turns any sync into an error)."""
    for kind in ("f32", "quant"):
        pk = routed_packs[kind]
        val, grad, *_ = _routed_fns(pk)
        ids = torch.arange(6, device="cuda") % pk.n_functions
        x = torch.randn((6, 512), device="cuda")
        val(pk, ids, x)
        grad(pk, ids, x)  # warm: kernels loaded, flag vector built
        unary = make_routed_unary_fn(pk, "silu", extrapolate=True)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            val(pk, ids, x)
            grad(pk, ids, x)
            unary(x)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()


def test_routed_wrappers_contract(routed_packs):
    K.reset_launches()
    pk, q = routed_packs["f32"], routed_packs["quant"]
    x = torch.randn(6, 5, 7, device="cuda").transpose(1, 2)  # not contiguous
    for val, grad, p in ((R.routed_pack_lookup, R.routed_pack_grad, pk),
                         (R.routed_quant_pack_lookup, R.routed_quant_pack_grad, q)):
        y = val(p, list(range(6)), x)
        yg, s = grad(p, "silu", x)
        assert y.shape == yg.shape == s.shape == x.shape and y.is_contiguous()
        val(p, [], torch.empty(0, 4, device="cuda"))  # no launch
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            val(p, "silu", x.half())
        with pytest.raises(ValueError, match="pack lives on"):
            grad(p, "silu", x.cpu())
        with pytest.raises(ValueError, match="fn_ids live on"):
            val(p, torch.zeros(6, dtype=torch.int32), x)
        with pytest.raises(KeyError):
            val(p, [0, 1, 2, 3, 4, 9], x)
    assert {k: v for k, v in K.launches.items() if v} == {
        "routed_pack_lookup": 1, "routed_pack_grad": 1,
        "routed_quant_pack_lookup": 1, "routed_quant_pack_grad": 1}


@pytest.mark.parametrize("mode", ["routed_pack", "routed_quant_pack",
                                  "routed_poly_pack"])
def test_reduced_routed_card_matches_cpu(cuda, mode):
    """Reduced stablelm, f32, in ``mode`` with TableFlash: serving on the card
    (the routed kernels and tableflash_exp) token-identical to the plain
    versions on the CPU, and 2 train steps with losses within 1e-4 relative
    (the card and the CPU sum the matrix products in other orders)."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import build_model, reduced
    from repro_torch.optim import adamw
    from repro_torch.serving.engine import ContinuousEngine, Request
    from repro_torch.train.loop import batch_to, init_state, make_train_step
    from repro_torch.tree import tree_map

    cfg = reduced("stablelm-3b").replace(compute_dtype="float32", approx=ApproxConfig(
        mode=mode, e_a=1e-4, omega=0.2, attn_table=True))
    rng = np.random.default_rng(2)
    reqs = [Request(prompt=rng.integers(0, 128, (int(n),)).astype(np.int32),
                    max_new_tokens=6) for n in rng.integers(3, 12, 5)]
    cpu_state = init_state(build_model(cfg, "cpu"))
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, global_batch=4, seq_len=16))
    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=2)
    served, losses = {}, {}
    for dev in ("cpu", "cuda"):
        model = build_model(cfg, dev)
        state = tree_map(lambda t: t.detach().clone().to(dev), cpu_state)
        K.reset_launches()
        served[dev] = ContinuousEngine(model, state["params"], 2, 64).serve(reqs)
        step = make_train_step(model, opt, accum=2)
        losses[dev] = []
        for s in range(2):
            state, m = step(state, batch_to(data.batch_at(s), dev))
            losses[dev].append(float(m["loss"]))
        if dev == "cuda":
            assert K.launches[f"{mode}_lookup"] > 0 and K.launches[f"{mode}_grad"] > 0
            assert K.launches["tableflash_exp"] > 0
    for a, b in zip(served["cuda"], served["cpu"]):
        np.testing.assert_array_equal(a.tokens, b.tokens)
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)


# --------------------------------------------------------------------------------------
# ShardedPack: one launch a call over the shards, summed on the card (the grads
# over the pack's staging image where it fits)
# --------------------------------------------------------------------------------------

SHARDS = (1, 2, 3, 4, 8)


@pytest.fixture(scope="module")
def spacks(cuda):
    return {s: build_sharded_pack(NAMES, 1e-4, s, omega=0.2, device=cuda)
            for s in SHARDS}


def assert_equal_values(got, want, x):
    """The shard sum against the replicated kernel: equal as values (a sum
    turns an owner's -0.0 into +0.0), NaN positions matched, except where
    x is NaN (the address is then 0: another entry in a slice than in the
    whole pack, so the meaningless extrapolated slope differs)."""
    keep = ~torch.isnan(x)
    g, w = got[keep].float(), want[keep].float()
    assert bool(((g == w) | (torch.isnan(g) & torch.isnan(w))).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("n_shards", SHARDS)
def test_sharded_kernels_bitwise(spacks, pack, n_shards, name, dtype):
    sp = spacks[n_shards]
    fid = sp.fn_id(name)
    x = edge_input(sp, fid, 4093, dtype, seed=n_shards)
    for ex in (False, True):
        K.reset_launches()
        y = K.sharded_pack_lookup(sp, fid, x, extrapolate=ex)
        d = K.sharded_pack_slope(sp, fid, x, extrapolate=ex)
        gy, gd = K.sharded_pack_grad(sp, fid, x, extrapolate=ex)
        cs = [K.sharded_shard_contrib(sp, fid, s, x, extrapolate=ex)
              for s in range(n_shards)]
        torch.cuda.synchronize()
        # one launch a call (lookup, slope, grad), one a shard's contribution
        assert K.launches["sharded_pack_lookup"] == 2 + n_shards
        assert K.launches["sharded_pack_grad"] == 1
        wy, wd = K.sharded_pack_grad_plain(sp, fid, x, extrapolate=ex)
        for got, want in ((y, wy), (gy, wy), (d, wd), (gd, wd)):
            assert_bitwise(got, want)
        for s, c in enumerate(cs):
            assert_bitwise(c, K.sharded_shard_contrib_plain(sp, fid, s, x,
                                                            extrapolate=ex))
        ry, rd = K.table_pack_grad(pack, fid, x, extrapolate=ex)
        assert_equal_values(y, ry, x)
        assert_equal_values(d, rd, x)


def _shard_launches_summed(contrib, n_shards):
    """The S single-shard launches added in shard order in x's dtype (the
    S-launch path the one-launch sum replaces)."""
    out = None
    for s in range(n_shards):
        c = contrib(s)
        out = c if out is None else out + c
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_shards", SHARDS + ("past budget",))
def test_sharded_fused_sum_equals_shard_launches(spacks, cuda, n_shards, dtype):
    """One launch over all the shards, static (value, slope and the grad's
    value + slope) and routed, bit for bit the S single-shard launches
    (value, slope) added in shard order in x's dtype, for every member: at
    the edge inputs (scalar path; NaN, +-inf, subnormal and out-of-domain
    lanes), the training gate and a ragged size past the capped grid
    (16-byte vectors and a scalar tail) and a view one element off 16-byte
    alignment (scalar path); the pack past the shared budget reads its
    slices from global memory (the grads' staging image does not fit)."""
    if n_shards == "past budget":
        sp = build_sharded_pack(("silu", "exp_neg"), 1e-8, 2, omega=0.2, device=cuda)
        assert sp.footprint_per_shard > 10240
    else:
        sp = spacks[n_shards]
    S, F = sp.n_shards, sp.n_functions
    g = torch.Generator(device="cuda").manual_seed(S)
    big = (torch.randn((4, 128, 6912), generator=g, device="cuda") * 6).to(dtype)
    ragged = (torch.randn(300_001, generator=g, device="cuda") * 6).to(dtype)
    for fid in range(F):
        e = edge_input(sp, fid, 4093, dtype, seed=fid)
        for x in (e, big, ragged, ragged[1:]):
            for ex in (False, True):
                K.reset_launches()
                grad = K.sharded_pack_grad(sp, fid, x, extrapolate=ex)
                assert K.launches["sharded_pack_grad"] == 1
                for slope in (False, True):
                    fused = (K.sharded_pack_slope if slope else K.sharded_pack_lookup)(
                        sp, fid, x, extrapolate=ex)
                    summed = _shard_launches_summed(
                        lambda s: K.sharded_shard_contrib(sp, fid, s, x, extrapolate=ex,
                                                          slope=slope), S)
                    assert_bitwise(fused, summed)
                    assert_bitwise(grad[slope], summed)
                    if x is e:
                        plain = (K.sharded_pack_slope_plain if slope
                                 else K.sharded_pack_lookup_plain)
                        assert_bitwise(fused, plain(sp, fid, x, extrapolate=ex))
                if x is e:
                    want = K.sharded_pack_grad_plain(sp, fid, x, extrapolate=ex)
                    assert_bitwise(grad[0], want[0])
                    assert_bitwise(grad[1], want[1])
    ids = [(3 * r + 1) % F for r in range(2 * F + 1)]
    x = torch.stack([edge_input(sp, f, 3000, dtype, seed=r)[:3000]
                     for r, f in enumerate(ids)])
    for ex in (False, True, tuple(f % 2 == 0 for f in range(F))):
        K.reset_launches()
        fused = R.sharded_routed_pack_lookup(sp, ids, x, extrapolate=ex)
        summed = _shard_launches_summed(
            lambda s: R.sharded_routed_shard_contrib(sp, ids, s, x, extrapolate=ex), S)
        assert K.launches["sharded_routed_pack_lookup"] == 1 + S
        assert_bitwise(fused, summed)
        assert_bitwise(fused, R.sharded_routed_pack_lookup_plain(sp, ids, x,
                                                                  extrapolate=ex))
        for s in range(S):
            assert_bitwise(R.sharded_routed_shard_contrib(sp, ids, s, x, extrapolate=ex),
                           R.sharded_routed_shard_contrib_plain(sp, ids, s, x,
                                                                extrapolate=ex))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_shards", SHARDS + ("past budget",))
def test_sharded_routed_grad_one_launch(spacks, cuda, n_shards, dtype):
    """The routed grad, one launch over all the shards, at the shapes where
    the grid is capped: the training gate as one row (16-byte chunks), a
    512 x 6912 batch routing every member (chunks of rows that change
    inside a block) and 300 x 1001 rows (capped, a row not whole chunks:
    one element a chunk), each against its plain version and, row by row,
    the static grad of the row's member; with extrapolation off, on and per
    member.  The pack past the budget restages rows per member."""
    if n_shards == "past budget":
        sp = build_sharded_pack(("silu", "exp_neg"), 1e-8, 2, omega=0.2, device=cuda)
    else:
        sp = spacks[n_shards]
    F = sp.n_functions
    g = torch.Generator(device="cuda").manual_seed(F)
    gate = (torch.randn((1, 4 * 128 * 6912), generator=g, device="cuda") * 6).to(dtype)
    wide = (torch.randn((512, 6912), generator=g, device="cuda") * 6).to(dtype)
    odd = (torch.randn((300, 1001), generator=g, device="cuda") * 6).to(dtype)
    wide[:, :4093] = torch.stack([_member_edges(sp, r % F, 4093, dtype, seed=r)[:4093]
                                  for r in range(512)])
    for x, ids in ((gate, [sp.fn_id("silu")]), (wide, [r % F for r in range(512)]),
                   (odd, [(7 * r) % F for r in range(300)])):
        for ex in (False, True, tuple(f % 2 == 0 for f in range(F))):
            K.reset_launches()
            _routed_check(sp, ids, x, ex)
            assert K.launches["sharded_routed_pack_grad"] == 1


def test_sharded_values_beyond_shared_memory(cuda):
    """A shard slice larger than the kernels' static shared budget (10,240
    f32 values) is read from global memory: same bits."""
    big = build_sharded_pack(("silu", "exp_neg"), 1e-8, 2, omega=0.2, device=cuda)
    assert big.footprint_per_shard > 10240
    for fid in range(2):
        x = edge_input(big, fid, 5000, torch.float32, seed=fid)
        assert_bitwise(K.sharded_pack_lookup(big, fid, x, extrapolate=True),
                       K.sharded_pack_lookup_plain(big, fid, x, extrapolate=True))
        for got, want in zip(K.sharded_pack_grad(big, fid, x, extrapolate=True),
                             K.sharded_pack_grad_plain(big, fid, x, extrapolate=True)):
            assert_bitwise(got, want)
    _routed_check(big, [0, 1, 1, 0], torch.randn((4, 3000), device="cuda") * 8, True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("flags", ["off", "on", "per_member"])
@pytest.mark.parametrize("n_shards", SHARDS)
def test_sharded_routed_kernels_bitwise(spacks, n_shards, flags, dtype):
    """Against the plain versions and, row by row, the static sharded
    kernels of the row's member."""
    sp = spacks[n_shards]
    F = sp.n_functions
    ex = (tuple(f % 2 == 0 for f in range(F)) if flags == "per_member"
          else flags == "on")
    ids = [(3 * r + 1) % F for r in range(2 * F + 1)]
    x = torch.stack([_member_edges(sp, f, 4000, dtype, seed=r)[:4000]
                     for r, f in enumerate(ids)])
    _routed_check(sp, ids, x, ex)
    raw = torch.tensor([ids[0], -5, 10_000] + ids[3:], device="cuda")
    _routed_check(sp, raw, x, ex)


def test_sharded_routed_cuda_graph_reroute(spacks):
    """A sharded routed call (one launch each, the grad's over the pack's
    staging image) captured in one CUDA graph follows an ids tensor
    rewritten in place."""
    pk = spacks[4]
    F = pk.n_functions
    ids = torch.arange(8, device="cuda", dtype=torch.int32) % F
    x = torch.randn((8, 3000), device="cuda") * 5
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        R.sharded_routed_pack_lookup(pk, ids, x)
        R.sharded_routed_pack_grad(pk, ids, x, extrapolate=True)
    torch.cuda.current_stream().wait_stream(s)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = R.sharded_routed_pack_lookup(pk, ids, x)
        y, d = R.sharded_routed_pack_grad(pk, ids, x, extrapolate=True)
    for new in ([F - 1 - (r % F) for r in range(8)], [1] * 8, [0, 99, -1, 3, 1, 1, 0, 4]):
        ids.copy_(torch.tensor(new, device="cuda", dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        assert_bitwise(out, R.sharded_routed_pack_lookup_plain(pk, ids, x))
        want_y, want_d = R.sharded_routed_pack_grad_plain(pk, ids, x, extrapolate=True)
        assert_bitwise(y, want_y)
        assert_bitwise(d, want_d)


def test_sharded_wrappers_contract(spacks):
    sp = spacks[4]
    x = torch.randn(6, 5, 7, device="cuda").transpose(1, 2)  # not contiguous
    K.reset_launches()
    y = K.sharded_pack_lookup(sp, "silu", x)
    yg, s = K.sharded_pack_grad(sp, "silu", x)
    ry = R.sharded_routed_pack_lookup(sp, list(range(6)), x)
    rg, rs = R.sharded_routed_pack_grad(sp, "silu", x)
    assert all(t.shape == x.shape for t in (y, yg, s, ry, rg, rs))
    # the static kernels keep x's layout, the routed ones (rows of ids) are contiguous
    assert all(t.stride() == x.stride() for t in (y, yg, s))
    assert all(t.is_contiguous() for t in (ry, rg, rs))
    K.sharded_pack_lookup(sp, "silu", torch.empty(0, device="cuda"))  # no launch
    assert {k: v for k, v in K.launches.items() if v} == {
        "sharded_pack_lookup": 1, "sharded_pack_grad": 1,
        "sharded_routed_pack_lookup": 1, "sharded_routed_pack_grad": 1}
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        K.sharded_pack_lookup(sp, "silu", x.half())
    with pytest.raises(ValueError, match="pack lives on"):
        K.sharded_pack_grad(sp, "silu", x.cpu())
    with pytest.raises(ValueError, match="fn_ids live on"):
        R.sharded_routed_pack_lookup(sp, torch.zeros(6, dtype=torch.int32), x)
    with pytest.raises(IndexError):
        K.sharded_shard_contrib(sp, "silu", 4, x)
    with pytest.raises(IndexError):
        R.sharded_routed_shard_contrib(sp, "silu", -1, x)


def test_reduced_sharded_card_matches_cpu(cuda):
    """Reduced stablelm, f32, in ``sharded_pack`` at 4 shards with
    TableFlash: serving on the card token-identical to the plain versions on
    the CPU, 2 train steps within 1e-4 relative (as the routed test)."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import build_model, reduced
    from repro_torch.optim import adamw
    from repro_torch.serving.engine import ContinuousEngine, Request
    from repro_torch.train.loop import batch_to, init_state, make_train_step
    from repro_torch.tree import tree_map

    cfg = reduced("stablelm-3b").replace(compute_dtype="float32", approx=ApproxConfig(
        mode="sharded_pack", e_a=1e-4, omega=0.2, attn_table=True, pack_shards=4))
    rng = np.random.default_rng(2)
    reqs = [Request(prompt=rng.integers(0, 128, (int(n),)).astype(np.int32),
                    max_new_tokens=6) for n in rng.integers(3, 12, 5)]
    cpu_state = init_state(build_model(cfg, "cpu"))
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, global_batch=4, seq_len=16))
    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=2)
    served, losses = {}, {}
    # the gate calls of the same serving in table_pack (one launch each)
    K.reset_launches()
    ContinuousEngine(build_model(cfg.replace(approx=dataclasses.replace(
        cfg.approx, mode="table_pack")), "cuda"),
        tree_map(lambda t: t.detach().clone().to("cuda"), cpu_state)["params"],
        2, 64).serve(reqs)
    gate_calls = K.launches["table_pack_lookup"]
    for dev in ("cpu", "cuda"):
        model = build_model(cfg, dev)
        state = tree_map(lambda t: t.detach().clone().to(dev), cpu_state)
        K.reset_launches()
        served[dev] = ContinuousEngine(model, state["params"], 2, 64).serve(reqs)
        lookups = K.launches["sharded_pack_lookup"]
        step = make_train_step(model, opt, accum=2)
        losses[dev] = []
        for s in range(2):
            state, m = step(state, batch_to(data.batch_at(s), dev))
            losses[dev].append(float(m["loss"]))
        if dev == "cuda":  # 1 launch a gate call; the grad 4
            assert lookups == gate_calls > 0
            assert K.launches["sharded_pack_grad"] > 0
            assert K.launches["sharded_pack_grad"] % 4 == 0
    for a, b in zip(served["cuda"], served["cpu"]):
        np.testing.assert_array_equal(a.tokens, b.tokens)
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)


# --------------------------------------------------------------------------------------
# RangeFold: the folded kernels
# --------------------------------------------------------------------------------------

FOLDED = ("sin", "cos", "exp", "log")
# the rotary angles of stablelm-3b (d_head 80): decode, prefill, training
# micro-batch; and a ragged size
ROPE_SHAPES = [(4, 1, 40), (4, 27, 40), (4, 128, 40), (12345,)]


@pytest.fixture(scope="module")
def fold_pack(cuda):
    return ApproxConfig(mode="folded_pack", e_a=1e-4, omega=0.2).pack(cuda)


@pytest.fixture(scope="module")
def fold_packs(fold_pack):
    """stablelm's folded pack (every kind's staging image fits a block's 48
    KB) and the cores at e_a 1e-10 (every image past it: the launches stage
    as the budget allows and read the rest from global memory)."""
    big = build_pack(("sin_core", "cos_core", "exp_core", "log_core"), 1e-10,
                     omega=0.2, device="cuda")
    for pk, fits in ((fold_pack, True), (big, False)):
        for name in FOLDED:
            assert (4 * pk.fold_images[name][0].numel() <= SMEM_BUDGET) == fits
    return {"image": fold_pack, "past_budget": big}


def payne_hanek_by_warp(n, seed):
    """n angles, warp by warp (32 lanes): all below 2048; Payne-Hanek lanes
    (|x| >= 2048) interleaved with small ones; all Payne-Hanek; one
    Payne-Hanek lane; and so on cyclically (a ragged n leaves a partial last
    warp)."""
    rng = np.random.default_rng(seed)
    small = rng.uniform(-2047.0, 2047.0, n)
    big = np.exp(rng.uniform(7.63, 87.0, n)) * rng.choice([-1.0, 1.0], n)
    lane, warp = np.arange(n) % 32, (np.arange(n) // 32) % 4
    take_big = np.select([warp == 0, warp == 1, warp == 2, warp == 3],
                         [False, lane % 2 == 1, True, lane == 17])
    return torch.from_numpy(np.where(take_big, big, small).astype(np.float32)).cuda()


def fullrange_input(shape, dtype, seed=0):
    """The full-range samples of tests/harness/fullrange.py (every decade,
    both signs, near-multiples of pi/2 in both reduction regimes, powers of
    two, subnormals, +-0), then inf, -inf and NaN, tiled to ``shape``."""
    from harness.fullrange import fullrange_samples

    x = np.concatenate([np.float32([np.inf, -np.inf, np.nan, 0.0, -0.0]),
                        fullrange_samples(fast=True, seed=seed)])
    n = int(np.prod(shape))
    x = np.resize(x, n).reshape(shape).astype(np.float32)
    return torch.from_numpy(x).to("cuda").to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", FOLDED)
@pytest.mark.parametrize("which", ["image", "past_budget"])
def test_folded_kernels_bitwise(fold_packs, which, name, dtype):
    """Value and value + slope kernels bitwise against their plain versions
    over the full f32 range (Payne-Hanek lanes and subnormals included), at
    the rotary shapes and a ragged size, staging the kind's image and past
    its budget."""
    fold_pack = fold_packs[which]
    for i, shape in enumerate(ROPE_SHAPES + [(70_000,)]):
        x = fullrange_input(shape, dtype, seed=i)
        got = K.folded_pack_lookup(fold_pack, name, x)
        y, s = K.folded_pack_grad(fold_pack, name, x)
        torch.cuda.synchronize()
        want_y, want_s = K.folded_pack_grad_plain(fold_pack, name, x)
        assert_bitwise(got, K.folded_pack_lookup_plain(fold_pack, name, x))
        assert_bitwise(y, want_y)
        assert_bitwise(s, want_s)
    # the Payne-Hanek regime, dense: |x| in [2048, 3e38)
    g = torch.Generator(device="cuda").manual_seed(3)
    big = torch.exp(torch.rand(200_000, generator=g, device="cuda") * 80 + 7.63)
    big = torch.where(torch.rand(200_000, generator=g, device="cuda") < 0.5, -big, big)
    y, s = K.folded_pack_grad(fold_pack, name, big)
    torch.cuda.synchronize()
    want_y, want_s = K.folded_pack_grad_plain(fold_pack, name, big)
    assert_bitwise(y, want_y)
    assert_bitwise(s, want_s)


@pytest.mark.parametrize("which", ["image", "past_budget"])
def test_folded_payne_hanek_lanes_by_warp(fold_packs, which):
    """sin and cos, value and value + slope, at the rotary shapes and a
    ragged size: warps with no Payne-Hanek lane (which skip it), warps
    mixing them with small lanes, warps of Payne-Hanek lanes alone and a
    partial last warp; bitwise the plain versions."""
    pk = fold_packs[which]
    for i, shape in enumerate(ROPE_SHAPES[:3] + [(32 * 37 + 13,)]):
        x = payne_hanek_by_warp(int(np.prod(shape)), seed=i).reshape(shape)
        for dtype in (torch.float32, torch.bfloat16):
            xd = x.to(dtype)
            for name in ("sin", "cos"):
                got = K.folded_pack_lookup(pk, name, xd)
                y, s = K.folded_pack_grad(pk, name, xd)
                torch.cuda.synchronize()
                want_y, want_s = K.folded_pack_grad_plain(pk, name, xd)
                assert_bitwise(got, K.folded_pack_lookup_plain(pk, name, xd))
                assert_bitwise(y, want_y)
                assert_bitwise(s, want_s)


def test_folded_wrappers_contract(fold_pack):
    K.reset_launches()
    x = torch.randn(6, 5, 7, device="cuda").transpose(1, 2) * 100  # not contiguous
    y = K.folded_pack_lookup(fold_pack, "sin", x)
    yg, s = K.folded_pack_grad(fold_pack, "log", x.abs())
    assert y.shape == yg.shape == s.shape == x.shape
    assert y.stride() == yg.stride() == s.stride() == x.stride()
    K.folded_pack_lookup(fold_pack, "cos", torch.empty(0, device="cuda"))  # no launch
    with pytest.raises(KeyError, match="folded kernel serves"):
        K.folded_pack_lookup(fold_pack, "gelu", x)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        K.folded_pack_lookup(fold_pack, "exp", x.half())
    with pytest.raises(ValueError, match="pack lives on"):
        K.folded_pack_grad(fold_pack, "exp", x.cpu())
    plain = ApproxConfig(mode="table_pack", e_a=1e-4, omega=0.2).pack("cuda")
    with pytest.raises(KeyError, match="sin_core"):  # a pack without the cores
        K.folded_pack_lookup(plain, "sin", x)
    assert {k: v for k, v in K.launches.items() if v} == {
        "folded_pack_lookup": 1, "folded_pack_grad": 1}


@pytest.mark.parametrize("name", FOLDED)
def test_folded_unary_gradient_through_kernel(cuda, name):
    """ApproxConfig(mode="folded_pack").unary(name) under autograd runs the
    fused grad kernel, and its gradient is the plain slope times dy."""
    a = ApproxConfig(mode="folded_pack", e_a=1e-4, omega=0.2)
    f = a.unary(name, cuda)
    x = fullrange_input((4, 27, 40), torch.float32, seed=9)
    x = torch.where(torch.isfinite(x), x, 1.0).requires_grad_(True)
    dy = torch.randn(x.shape, device="cuda")
    K.reset_launches()
    y = f(x)
    y.backward(dy)
    torch.cuda.synchronize()
    assert K.launches["folded_pack_grad"] == 1
    pack = a.pack(cuda)
    want_y, want_s = K.folded_pack_grad_plain(pack, name, x.detach())
    assert_bitwise(y.detach(), want_y)
    assert_bitwise(x.grad, want_s * dy)


@pytest.mark.parametrize("mode", ["folded_pack", "folded_routed_pack", "table_pack"])
def test_reduced_rope_table_card_matches_cpu(cuda, mode):
    """Reduced stablelm, f32, ``rope_table`` in ``mode``: serving on the card
    (the folded kernels for the rotary sin / cos) token-identical to the plain
    versions on the CPU."""
    from repro_torch.models import build_model, reduced
    from repro_torch.serving.engine import ContinuousEngine, Request
    from repro_torch.train.loop import init_state
    from repro_torch.tree import tree_map

    cfg = reduced("stablelm-3b").replace(compute_dtype="float32", approx=ApproxConfig(
        mode=mode, e_a=1e-4, omega=0.2, rope_table=True, attn_table=True))
    rng = np.random.default_rng(4)
    reqs = [Request(prompt=rng.integers(0, 128, (int(n),)).astype(np.int32),
                    max_new_tokens=6) for n in rng.integers(3, 12, 5)]
    cpu_params = init_state(build_model(cfg, "cpu"))["params"]
    served = {}
    for dev in ("cpu", "cuda"):
        model = build_model(cfg, dev)
        params = tree_map(lambda t: t.detach().clone().to(dev), cpu_params)
        K.reset_launches()
        served[dev] = ContinuousEngine(model, params, 2, 64).serve(reqs)
        if dev == "cuda":
            assert K.launches["folded_pack_lookup"] > 0
    for a, b in zip(served["cuda"], served["cpu"]):
        np.testing.assert_array_equal(a.tokens, b.tokens)


@pytest.mark.parametrize("mode,kernel", [("table_pack", "table_pack_lookup"),
                                         ("quant_pack", "quant_pack_lookup"),
                                         ("routed_pack", "routed_pack_lookup")])
def test_telemetry_counters_kernel_mode_equal_ref_mode(cuda, mode, kernel):
    """Device telemetry on the card: reduced stablelm (f32, TableFlash)
    serving through ``mode``'s kernels counts exactly what its ``_ref`` mode
    counts (the kernels are bitwise their plain versions, so the probes see
    the same inputs), with the same tokens; a routed_fn call counts its
    dispatch rows."""
    from repro_torch import obs
    from repro_torch.models import build_model, reduced
    from repro_torch.serving.engine import ContinuousEngine, Request
    from repro_torch.train.loop import init_state

    cfg = reduced("stablelm-3b").replace(compute_dtype="float32", approx=ApproxConfig(
        mode=mode, e_a=1e-4, omega=0.2, attn_table=True))
    rng = np.random.default_rng(5)
    reqs = [Request(prompt=rng.integers(0, 128, (int(n),)).astype(np.int32),
                    max_new_tokens=6) for n in rng.integers(3, 12, 5)]
    params = init_state(build_model(cfg, cuda))["params"]
    x = torch.randn((3, 64), generator=torch.Generator().manual_seed(0)).to(cuda) * 4
    served, counters = {}, {}
    obs.disable()
    obs.reset_registry()
    try:
        for m in (mode, mode + "_ref"):
            obs.configure(enabled=True, device_telemetry=True)
            model = build_model(cfg.replace(
                approx=dataclasses.replace(cfg.approx, mode=m)), cuda)
            routed = model.cfg.approx.routed_fn(["gelu", "tanh", "gelu"], cuda)
            obs.disable()
            K.reset_launches()
            served[m] = ContinuousEngine(model, params, 2, 64).serve(reqs)
            routed(x)
            torch.cuda.synchronize()
            if m == mode:
                assert K.launches[kernel] > 0 and K.launches["tableflash_exp"] > 0
            counters[m] = obs.get_registry().summary()["counters"]
            obs.reset_registry()
    finally:
        obs.disable()
        obs.reset_registry()
    assert counters[mode] == counters[mode + "_ref"]
    assert counters[mode]["approx.routed.gelu"] == 2
    assert counters[mode]["approx.lookups.attn_exp"] > 0
    for a, b in zip(served[mode], served[mode + "_ref"]):
        np.testing.assert_array_equal(a.tokens, b.tokens)


# --------------------------------------------------------------------------------------
# The kernel ops (torch.library) and PackLint's meta traces against the card
# --------------------------------------------------------------------------------------

OP_SHAPES = {"decode_gate_bf16": ((4, 1, 6912), torch.bfloat16, None),
             "f32_permuted": ((33, 8, 64), torch.float32, (1, 2, 0))}


@pytest.mark.parametrize("shape", list(OP_SHAPES))
def test_ops_pass_opcheck(cuda, shape):
    """Each of the 21 ops passes ``torch.library.opcheck``'s schema and fake
    tensor tests on the card, at the decode gate's shape in bf16 and at an
    f32 shape with a permuted x."""
    from repro_torch.analysis.contracts import op_samples
    from repro_torch.kernels import _lib, ops

    dims, dtype, perm = OP_SHAPES[shape]
    x = torch.randn(dims, device=cuda).to(dtype)
    if perm is not None:
        x = x.permute(perm)
    samples = op_samples(x)
    assert set(samples) == set(_lib._ENTRIES) == set(ops.OPS)
    for entry, (planes, ints) in samples.items():
        torch.library.opcheck(ops.OPS[entry], (x, list(planes), list(ints)),
                              test_utils=("test_schema", "test_faketensor"))


def test_gate_closure_card_trace_is_the_meta_trace(cuda):
    """``table_pack``'s gate closure (silu), traced by make_fx over CUDA
    tensors (the kernel runs) and over meta tensors (PackLint), has one
    fingerprint and the same kernel nodes with the same int arguments."""
    from repro_torch.analysis import contracts, graph_lint as gl

    card = contracts.LintContext(funcs=("silu", "tanh"), device=cuda)
    meta = contracts.LintContext(funcs=("silu", "tanh"))
    for kind in ("value", "grad"):
        fp = {}
        nodes = {}
        for ctx in (card, meta):
            f = (ctx.value_closure if kind == "value" else ctx.grad_closure)(
                "table_pack", "silu")
            gm = gl.trace(f, ctx.x("silu"))
            fp[ctx.device.type] = gl.graph_fingerprint(gm)
            nodes[ctx.device.type] = [(n.entry, n.ints) for n in gl.kernel_nodes(gm)]
        assert fp["cuda"] == fp["meta"], kind
        assert nodes["cuda"] == nodes["meta"] and nodes["meta"], kind
