"""The port's dense family beyond stablelm-3b and its MoE family against the
JAX reference, on the CPU: starcoder2-3b (plain 2-matrix ``gelu`` MLP, 2 kv
heads), yi-34b (``rope_theta`` 5e6), gemma3-12b's local:global stack (period
6: 5 local layers and 1 global a group, qk-norm, ``gelu_tanh``, tied
embeddings), deepseek-moe-16b (top-2 of 4 experts and 2 shared, MHA) and
qwen3-moe-235b-a22b (top-2 of 4, no shared expert, GQA, qk-norm), each
``reduced`` (d=64; gemma3 2 groups, 12 layers; the MoE stacks 2 layers, d_ff
32) on weights made with numpy in the reference's tree and carried over by
``params_from_jax``.  An MoE loss includes ``AUX_WEIGHT * aux``.
``LOCAL_WINDOW`` is set to 4 on both modules, so 9-token prompts wrap the
local rings (at the real 1024, a window that never binds would pass
unchecked).

Tolerances, with their reasons (those of ``tests/test_torch_model.py`` and
``tests/test_torch_train.py``):

* f32 prefill and decode logits: 1e-4 absolute (the frameworks sum the
  matrix products in other orders; the lookups agree to 1 ULP);
* the bf16 k/v caches: within one bf16 rounding (relative 2**-7, and 1e-3
  absolute where f32 values that differ by ~1e-5 round apart near 0) of the
  reference's, the position buffers bit for bit;
* train logits 1e-4, the loss 1e-5 relative, each gradient leaf
  ``||g_t - g_j|| <= 1e-3 ||g_j||`` (the table slope is piecewise constant:
  a 1-ULP shift of an activation near a breakpoint picks the neighbouring
  segment's slope).  The table modes run at e_a 1e-6, as in
  ``tests/test_torch_model.py``: at 1e-4 the slope steps are larger, and
  through gemma3's 12 layers such flips moved a leaf by up to 2.7e-3
  relative, where ``exact`` agrees within 7e-6;
* ``prefill_chunked``: 1e-4 against the reference's; against the port's
  one-shot ``prefill`` the reference's own 2e-2 (chunks attend over the bf16
  cache, the one-shot prefill over its f32 k/v);
* the engines: identical greedy tokens.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.transformer as j_transformer
import repro_torch.models.transformer as t_transformer
from repro.approx import ApproxConfig as JApprox
from repro.models import build_model as j_build_model
from repro.optim import adamw as j_adamw
from repro_torch.approx import ApproxConfig
from repro_torch.convert import params_from_jax, train_state_from_jax
from repro_torch.models import build_model, reduced
from repro_torch.serving.engine import (ContinuousEngine, DecodeEngine, _trim_at_eos,
                                        cache_batch_axes, scatter_cache_slots)
from repro_torch.train import CheckpointManager
from repro_torch.train.loop import batch_to, value_and_grad
from repro_torch.tree import leaves, leaves_with_path
from tests.test_archs import reduced as j_reduced
from tests.test_serving import mixed_requests
from tests.test_torch_train import assert_grads_close, np_batch, rel

ARCHS = ("starcoder2-3b", "yi-34b", "gemma3-12b", "deepseek-moe-16b",
         "qwen3-moe-235b-a22b")
WINDOW = 4  # LOCAL_WINDOW on both sides
APPROX = {  # name -> (mode, attn_table, e_a)
    "exact": ("exact", False, 1e-4),
    "table_pack_attn": ("table_pack", True, 1e-6),
}


@pytest.fixture(autouse=True)
def small_window(monkeypatch):
    monkeypatch.setattr(j_transformer, "LOCAL_WINDOW", WINDOW)
    monkeypatch.setattr(t_transformer, "LOCAL_WINDOW", WINDOW)


def numpy_params(arch, seed=0):
    """A reference parameter tree of ``reduced(arch)`` (its shapes from
    ``jax.eval_shape`` of ``init``), filled from a numpy seed with the
    reference's init scales: tables and ``wo`` N(0, 0.02), the other weights
    N(0, 1/fan_in) (an expert's fan-in is the axis after the expert axis),
    and the norm gains 1 + N(0, 0.1) where the reference
    has ones, so that they count too.  (The reference's own ``init`` would
    spend ~14 s compiling its ops eagerly, once a process.)"""
    shapes = jax.eval_shape(j_build_model(j_reduced(arch)).init, jax.random.key(0))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        keys = [k.key for k in path]
        z = rng.standard_normal(leaf.shape).astype(np.float32)
        if keys[-1] == "g":
            return 1 + 0.1 * z
        if keys[-1] == "table" or keys[-2:] == ["wo", "w"]:
            return 0.02 * z
        stacked = {"layers": 1, "layers_glob": 1, "layers_loc": 2}.get(keys[0], 0)
        fan_in = stacked + int("experts" in keys)
        return z / np.float32(np.sqrt(leaf.shape[fan_in]))
    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def jax_params():
    """``numpy_params`` of each arch, made once; ``init`` reads neither the
    approx mode nor the compute dtype, so every mode shares them."""
    made = {}

    def get(arch):
        if arch not in made:
            made[arch] = numpy_params(arch)
        return made[arch]
    return get


def pair(jax_params, arch, approx="exact"):
    """(jax model, jax params, port model, port params) on the same weights,
    f32 compute."""
    mode, attn, e_a = APPROX[approx]
    jm = j_build_model(j_reduced(arch).replace(
        compute_dtype="float32",
        approx=JApprox(mode=mode, e_a=e_a, omega=0.2, attn_table=attn)))
    tm = build_model(reduced(arch).replace(
        compute_dtype="float32",
        approx=ApproxConfig(mode=mode, e_a=e_a, omega=0.2, attn_table=attn)),
        device="cpu")
    jp = jax_params(arch)
    return jm, jax.tree.map(jnp.asarray, jp), tm, params_from_jax(tm.cfg, jp, "cpu")


def assert_caches_equal(tc, jc):
    assert sorted(tc) == sorted(jc)
    for k, want in jc.items():
        got = tc[k]
        assert tuple(got.shape) == want.shape, k
        if k.endswith("pos"):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=k)
        else:
            np.testing.assert_allclose(got.float().numpy(),
                                       np.asarray(want.astype(jnp.float32)),
                                       rtol=2.0 ** -7, atol=1e-3, err_msg=k)


@pytest.mark.parametrize("approx", sorted(APPROX))
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode(jax_params, arch, approx):
    """A 9-token prefill and 3 decode steps on per-slot clocks: logits and
    every cache entry against the reference's (for gemma3 the local rings of
    4 slots have wrapped by the prefill and wrap again while decoding)."""
    jm, jp, tm, tp = pair(jax_params, arch, approx)
    V = tm.cfg.vocab
    toks = np.random.default_rng(0).integers(0, V, (2, 9)).astype(np.int32)
    jc, tc = jm.init_cache(2, 16), tm.init_cache(2, 16)
    outs = []
    with torch.inference_mode():
        jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)}, jc)
        tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks).long()}, tc)
        assert_caches_equal(tc, jc)
        outs.append((jl, tl))
        tok = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
        decode = jax.jit(jm.decode_step)
        for p in (9, 10, 11):
            pos = np.asarray([p, p], np.int32)
            jl, jc = decode(jp, jnp.asarray(tok), jnp.asarray(pos), jc)
            tl, tc = tm.decode_step(tp, torch.from_numpy(tok).long(),
                                    torch.from_numpy(pos), tc)
            outs.append((jl, tl))
            tok = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
    assert_caches_equal(tc, jc)
    if arch == "gemma3-12b":
        assert tuple(tc["loc_k"].shape[:4]) == (2, 5, 2, WINDOW)
        np.testing.assert_array_equal(tc["loc_pos"].numpy(), [[8, 9, 10, 11]] * 2)
    for jl, tl in outs:
        got = tl.numpy()
        assert np.isfinite(got[:, :V]).all()
        err = np.abs(got[:, :V] - np.asarray(jl)[:, :V]).max()
        assert err <= 1e-4, err


@pytest.mark.parametrize("arch", ["starcoder2-3b", "gemma3-12b", "deepseek-moe-16b",
                                  "qwen3-moe-235b-a22b"])
def test_train_logits_loss_and_grads(jax_params, arch):
    """``train_logits``, the loss and every gradient leaf through
    ``table_pack`` + TableFlash: starcoder2's plain ``gelu`` MLP, gemma3's
    local:global stack (its tied embedding takes the grads of both its uses),
    the MoE stacks (router, experts and shared experts; the aux loss summed
    over the layers through the checkpointed blocks); yi-34b's ``silu`` GLU
    grads are stablelm's (``tests/test_torch_train.py``).  The port
    checkpoints each layer (``remat``)."""
    jm, jp, tm, tp = pair(jax_params, arch, "table_pack_attn")
    tm = build_model(tm.cfg.replace(remat=True), device="cpu")
    b = np_batch(tm.cfg.vocab, B=2, S=9, ignore=True)

    def j_loss(p, batch):
        logits, aux = jm.train_logits(p, batch)
        return (j_transformer.cross_entropy(logits, batch["targets"])
                + j_transformer.AUX_WEIGHT * aux), logits

    (jl, jlogits), jg = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in b.items()})
    tb = batch_to(b, "cpu")
    with torch.no_grad():
        tlogits, taux = tm.train_logits(tp, tb)
    V = tm.cfg.vocab
    err = np.abs(tlogits.numpy()[..., :V] - np.asarray(jlogits)[..., :V]).max()
    assert err <= 1e-4, err
    if tm.cfg.family == "moe":
        assert 0.5 < float(taux) < 4.0, float(taux)  # ~1 when balanced
    tl, tg = value_and_grad(tm, tp, tb)
    assert rel(tl, jl) <= 1e-5, (float(tl), float(jl))
    assert_grads_close(tm.cfg, jg, tg)


def test_prefill_chunked(jax_params):
    """``prefill_chunked`` (8-token chunks through the decode path) against the
    reference's and against the port's one-shot ``prefill``, and decoding on
    from either cache; a local:global stack refuses it, as in the reference."""
    jm, jp, tm, tp = pair(jax_params, "starcoder2-3b", "table_pack_attn")
    toks = np.random.default_rng(6).integers(0, tm.cfg.vocab, (2, 24)).astype(np.int32)
    jl, jc = jm.prefill_chunked(jp, {"tokens": jnp.asarray(toks)}, jm.init_cache(2, 32),
                                chunk=8)
    batch = {"tokens": torch.from_numpy(toks).long()}
    with torch.inference_mode():
        lc, cc = tm.prefill_chunked(tp, batch, tm.init_cache(2, 32), chunk=8)
        lf, cf = tm.prefill(tp, batch, tm.init_cache(2, 32))
        tok = torch.argmax(lf, -1)[:, None]
        pos = torch.tensor(24, dtype=torch.int32)
        dc, _ = tm.decode_step(tp, tok, pos, cc)
        df, _ = tm.decode_step(tp, tok, pos, cf)
    assert_caches_equal(cc, jc)
    np.testing.assert_array_equal(cc["pos"].numpy(), cf["pos"].numpy())
    np.testing.assert_allclose(lc.numpy(), np.asarray(jl), atol=1e-4)
    # chunks attend over the bf16 cache, one-shot prefill over its own f32
    # k/v: the reference's own bound for this pair (tests/test_archs.py)
    np.testing.assert_allclose(lc.numpy(), lf.numpy(), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(dc.numpy(), df.numpy(), rtol=2e-2, atol=2e-2)
    gemma = build_model(reduced("gemma3-12b"), device="cpu")
    with pytest.raises(NotImplementedError, match="single-period stacks only"):
        gemma.prefill_chunked({}, {"tokens": batch["tokens"]}, {}, chunk=8)


def test_params_and_train_state_convert(jax_params, tmp_path):
    """The local:global tree: ``layers_loc`` as 2 groups of 5 layers and
    ``layers_glob`` as 2, every leaf equal to the reference's slice; the
    train state converts alike and survives a checkpoint round trip."""
    cfg = reduced("gemma3-12b")
    jp = jax_params("gemma3-12b")
    tp = params_from_jax(cfg, jp, "cpu")
    assert sorted(tp) == ["embed", "final_norm", "layers_glob", "layers_loc"]
    assert [len(g) for g in tp["layers_loc"]] == [5, 5] and len(tp["layers_glob"]) == 2
    np.testing.assert_array_equal(tp["layers_loc"][1][3]["mlp"]["wi"]["w"].numpy(),
                                  jp["layers_loc"]["mlp"]["wi"]["w"][1, 3])
    np.testing.assert_array_equal(tp["layers_glob"][1]["attn"]["kn"]["g"].numpy(),
                                  jp["layers_glob"]["attn"]["kn"]["g"][1])
    assert sum(t.numel() for t in leaves(tp)) == sum(a.size for a in jax.tree.leaves(jp))
    own = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    assert ([(p, tuple(t.shape)) for p, t in leaves_with_path(own)]
            == [(p, tuple(t.shape)) for p, t in leaves_with_path(tp)])
    state = train_state_from_jax(cfg, jax.tree.map(np.asarray, {
        "params": jp, "opt": j_adamw.init(jp), "step": jnp.zeros((), jnp.int32)}), "cpu")
    assert len(leaves(state["opt"]["m"])) == len(leaves(tp))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, state)
    back = mgr.restore(1, state)
    for a, c in zip(leaves(state), leaves(back)):
        assert torch.equal(a, c)


@pytest.fixture(scope="module")
def gemma_model():
    mode, attn, e_a = APPROX["table_pack_attn"]  # the pack the parity tests built
    cfg = reduced("gemma3-12b").replace(approx=ApproxConfig(
        mode=mode, e_a=e_a, omega=0.2, attn_table=attn))
    model = build_model(cfg, device="cpu")
    return model, model.init(torch.Generator().manual_seed(0))


def test_continuous_engine_matches_sequential_oracle(gemma_model):
    """The windowed gemma3 stack through ContinuousEngine (refills scatter the
    local rings along their batch axis 2) against the fixed-batch engine
    serving each request alone; prompts of up to 8 tokens wrap the rings."""
    model, params = gemma_model
    reqs = mixed_requests(np.random.default_rng(4), 6, lo_len=3, hi_len=9,
                          lo_new=2, hi_new=6)
    S0 = max(len(r.prompt) for r in reqs)
    assert S0 > WINDOW
    eng = ContinuousEngine(model, params, batch_size=2, cache_len=32)
    out = eng.serve(reqs)
    assert eng.refills >= 2
    oracle = DecodeEngine(model, params, 2, 32)
    for i, r in enumerate(reqs):
        row = np.zeros((S0,), np.int32)
        row[S0 - len(r.prompt):] = r.prompt
        gen, _ = oracle.generate_batch(np.tile(row, (2, 1)), r.max_new_tokens, r.eos_id)
        want = _trim_at_eos(gen[0], r.max_new_tokens, r.eos_id)
        np.testing.assert_array_equal(out[i].tokens, want, err_msg=f"req {i}")


def test_cache_axes_and_scatter(gemma_model):
    model, _ = gemma_model
    axes = cache_batch_axes(model, 32)
    assert axes == {"loc_k": 2, "loc_v": 2, "loc_pos": 0,
                    "glob_k": 1, "glob_v": 1, "glob_pos": 0}
    dst = model.init_cache(3, 8)
    src = {k: v + 1 for k, v in model.init_cache(3, 8).items()}
    G = model.cfg.attn_geom.g_eff
    assert tuple(dst["loc_k"].shape) == (2, 5, 3, WINDOW, G, 16)
    assert tuple(dst["glob_k"].shape) == (2, 3, 8, G, 16)
    out = scatter_cache_slots(dst, src, [1], axes)
    assert (out["loc_k"][:, :, 1] == 1).all() and (out["loc_k"][:, :, 0] == 0).all()
    assert (out["glob_v"][:, 1] == 1).all() and (out["glob_v"][:, 2] == 0).all()
    assert (out["loc_pos"][1] == 0).all() and (out["glob_pos"][0] == -1).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli(arch, tmp_path, capsys):
    """Traced, so the refill's scatter span syncs on the arch's own cache."""
    from repro_torch.launch.serve import main

    trace = tmp_path / "trace.json"
    res = main(["--arch", arch, "--reduced", "--device", "cpu", "--requests", "3",
                "--batch", "2", "--max-new", "3", "--approx-mode", "table_pack",
                "--approx-ea", "1e-6", "--attn-table", "--trace", str(trace)])
    assert [r.steps for r in res] == [3, 3, 3]
    assert "served 3 requests, 9 tokens on cpu" in capsys.readouterr().out
    assert "refill.scatter" in trace.read_text()


@pytest.mark.parametrize("arch", ["gemma3-12b", "deepseek-moe-16b"])
def test_train_cli(arch, tmp_path, capsys):
    from repro_torch.launch.train import main

    out = main(["--arch", arch, "--reduced", "--device", "cpu",
                "--steps", "2", "--batch", "4", "--seq", "16", "--accum", "2",
                "--approx-mode", "table_pack", "--approx-ea", "1e-6",
                "--ckpt-dir", str(tmp_path)])
    assert "done: step=2 loss" in capsys.readouterr().out
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
