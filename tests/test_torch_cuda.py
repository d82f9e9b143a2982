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
    assert K.launches == {"table_pack_lookup": 1, "tableflash_exp": 1}
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        K.table_pack_lookup(pack, "silu", x.half())
    for p, t in ((cpu_pack, x), (pack, x.cpu())):
        with pytest.raises(ValueError, match="pack lives on"):
            K.table_pack_lookup(p, "silu", t)
        with pytest.raises(ValueError, match="pack lives on"):
            K.tableflash_exp(p, t)


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
    assert all(v > 0 for v in K.launches.values())
    want = ContinuousEngine(cpu_model, params, 2, 64).serve(reqs)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.tokens, b.tokens)
