"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``; every test skips without a card (decided inside the fixture,
never at import, so every pytest worker collects the same tests).  Run on the
machine with the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

Comparisons are bitwise (NaN positions matched): the kernels are built with
``-fmad=false`` and round every operation as the plain versions do.
"""

import numpy as np
import pytest
import torch

from repro_torch.approx import ApproxConfig
from repro_torch.approx.table_pack import build_pack
from repro_torch.approx.torch_table import TorchTable, from_spec
from repro_torch.core.flow import cached_table
from repro_torch.kernels import table_grad as TG
from repro_torch.kernels import table_lookup as TL
from repro_torch.kernels import table_pack_lookup as K

pytestmark = pytest.mark.gpu

NAMES = ("gelu", "silu", "tanh", "sigmoid_sym", "softplus", "exp_neg")


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
    fid = pack.fn_id("exp_neg")
    x = torch.cat([edge_input(pack, fid, 2000, dtype),
                   torch.linspace(-40, 0, 3001, device="cuda").to(dtype)])
    got = K.tableflash_exp(pack, x)
    torch.cuda.synchronize()
    assert_bitwise(got, K.tableflash_exp_plain(pack, x))
    assert (got[x < -16.0] == 0).all()


def test_values_beyond_shared_memory(cuda):
    """A pack larger than the kernel's static shared budget (10,240 f32
    values) is read from global memory: same bits."""
    big = build_pack(("silu", "exp_neg"), 3e-8, omega=0.2, device=cuda)
    assert big.footprint > 10240
    for fid in range(2):
        x = edge_input(big, fid, 5000, torch.float32, seed=fid)
        assert_bitwise(K.table_pack_lookup(big, fid, x, extrapolate=True),
                       K.table_pack_lookup_plain(big, fid, x, extrapolate=True))
    x = torch.linspace(-30, 0, 7777, device="cuda")
    assert_bitwise(K.tableflash_exp(big, x), K.tableflash_exp_plain(big, x))


def test_wrapper_contract(pack):
    K.reset_launches()
    x = torch.randn(3, 5, 7, device="cuda").transpose(0, 2)  # not contiguous
    y = K.table_pack_lookup(pack, "silu", x)
    assert y.shape == x.shape and y.is_contiguous()
    assert_bitwise(y, K.table_pack_lookup_plain(pack, "silu", x))
    K.tableflash_exp(pack, -x.abs())
    K.table_pack_lookup(pack, "silu", torch.empty(0, device="cuda"))  # no launch
    cpu_pack = build_pack(NAMES, 1e-4, omega=0.2, device="cpu")
    K.table_pack_lookup(cpu_pack, "silu", x.cpu())  # plain version, no launch
    assert K.launches == {"table_pack_lookup": 1, "tableflash_exp": 1,
                          "table_pack_grad": 0, "table_lookup": 0,
                          "table_lookup_grad": 0}
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


def test_grad_wrappers_contract(pack, cuda):
    K.reset_launches()
    jt = ApproxConfig(e_a=1e-4, omega=0.2).table_for("silu", cuda)
    x = torch.randn(3, 5, 7, device="cuda").transpose(0, 2)  # not contiguous
    for y, s in (K.table_pack_grad(pack, "silu", x), TG.table_lookup_grad(jt, x)):
        assert y.shape == s.shape == x.shape and y.is_contiguous()
    TL.table_lookup(jt, x)
    TL.table_lookup(jt, torch.empty(0, device="cuda"))  # no launch
    TG.table_lookup_grad(jt, torch.empty(0, device="cuda"))
    assert K.launches == {"table_pack_lookup": 0, "tableflash_exp": 0,
                          "table_pack_grad": 1, "table_lookup": 1,
                          "table_lookup_grad": 1}
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        TG.table_lookup_grad(jt, x.half())
    with pytest.raises(ValueError, match="table lives on"):
        TL.table_lookup(jt, x.cpu())
    with pytest.raises(ValueError, match="pack lives on"):
        K.table_pack_grad(pack, "silu", x.cpu())
    n = 65  # one more sub-interval than the kernel stages: refused, not run
    wide = TorchTable(
        boundaries=torch.linspace(0, 1, n + 1, device="cuda"),
        inv_delta=torch.full((n,), float(n), device="cuda"),
        delta=torch.full((n,), 1.0 / n, device="cuda"),
        base=torch.arange(n, dtype=torch.float32, device="cuda") * 2,
        seg_count=torch.ones(n, device="cuda"),
        values=torch.zeros(2 * n + 1, device="cuda"))
    for fn in (TL.table_lookup, TG.table_lookup_grad):
        with pytest.raises(RuntimeError, match="launch failed"):
            fn(wide, x)
    assert K.launches["table_lookup"] == 1 and K.launches["table_lookup_grad"] == 1


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
