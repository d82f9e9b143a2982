"""The port's encoder-decoder (``EncDecLM``, whisper-small) and vision-prefix
model (``VLM``, internvl2-1b) against the JAX reference, on the CPU: each
``reduced`` (whisper: 2 encoder + 2 decoder layers, d=64, enc_len 12;
internvl: 2 layers, 4 patches of width 16), on weights made with numpy in
the reference's tree and carried over by ``params_from_jax``; with
``sinusoidal_positions`` and ``layernorm`` of ``models/common.py``, the
engines' ``extra_inputs``, ``serve_continuous`` and the ``serve`` alias.

The reference side is compiled once a configuration: one ``DecodeEngine``
(its jitted prefill and decode step serve the logit checks and the engine's
tokens) and one ``value_and_grad`` (in bf16 the loss alone) a (model, mode,
dtype), shared by the module-scoped fixtures.

Tolerances, with their reasons (those of ``tests/test_torch_archs.py``):

* ``sinusoidal_positions`` bit for bit (both build it in float64 numpy and
  round once); ``layernorm`` within 1e-6 (float32 means and variances
  summed in other orders);
* ``encode`` f32 within 1e-5 (``rtol=1e-4``): the matrix products' sums;
* f32 logits within 1e-4 absolute, the loss 1e-5 relative, each gradient
  leaf ``||g_t - g_j|| <= 1e-3 ||g_j||``; greedy tokens identical;
* bf16 compute: logits within 5e-2 of the largest logit (bf16 rounds at
  other places in the two frameworks: XLA keeps excess precision inside a
  fusion, eager PyTorch rounds every op), the loss 1e-2 relative;
* caches: positions bit for bit, the bf16 k/v and ``memory`` within one
  bf16 rounding of the reference's (relative 2**-7, 1e-3 absolute) in f32,
  within 5e-2 of its norm in bf16.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.common as j_common
from repro.approx import ApproxConfig as JApprox
from repro.models import build_model as j_build_model
from repro.optim import adamw as j_adamw
from repro.serving.engine import DecodeEngine as JDecodeEngine
from repro.serving.engine import serve_continuous as j_serve_continuous
from repro_torch.approx import ApproxConfig
from repro_torch.convert import params_from_jax, train_state_from_jax
from repro_torch.models import VLM, EncDecLM, build_model, reduced
from repro_torch.models import common as t_common
from repro_torch.serving import (ContinuousEngine, DecodeEngine, cache_batch_axes, serve,
                                 serve_continuous, serve_static)
from repro_torch.train import CheckpointManager
from repro_torch.train.loop import batch_to, value_and_grad
from repro_torch.tree import leaves, leaves_with_path
from tests.test_archs import reduced as j_reduced
from tests.test_serving import mixed_requests
from tests.test_torch_train import assert_grads_close, rel

ARCHS = ("whisper-small", "internvl2-1b")
APPROX = {  # name -> (mode, attn_table, e_a)
    "exact": ("exact", False, 1e-4),
    "table_pack_ref": ("table_pack_ref", False, 1e-6),
    "table_pack_attn": ("table_pack", True, 1e-6),
}
# (approx, compute dtype): every mode in f32, TableFlash's in bf16 too; the
# training checks leave table_pack_ref out (on the CPU the port's table_pack
# runs the same plain versions)
CASES = (("exact", "float32"), ("table_pack_ref", "float32"),
         ("table_pack_attn", "float32"), ("table_pack_attn", "bfloat16"))
TRAIN_CASES = tuple(c for c in CASES if c[0] != "table_pack_ref")
B, PROMPT, CACHE, N_DECODE = 2, 9, 16, 4
STACKED = ("enc_layers", "dec_layers", "layers")  # one leading layer axis


def numpy_params(arch, seed=0):
    """A reference parameter tree of ``reduced(arch)`` (its shapes from
    ``jax.eval_shape`` of ``init``), filled from a numpy seed: tables and
    ``wo`` N(0, 0.02), the norm gains 1 + N(0, 0.1), the other weights
    N(0, 1/fan_in)."""
    shapes = jax.eval_shape(j_build_model(j_reduced(arch)).init, jax.random.key(0))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        keys = [k.key for k in path]
        z = rng.standard_normal(leaf.shape).astype(np.float32)
        if keys[-1] == "g":
            return 1 + 0.1 * z
        if keys[-1] == "table" or keys[-2:] == ["wo", "w"]:
            return 0.02 * z
        return z / np.float32(np.sqrt(leaf.shape[int(keys[0] in STACKED)]))
    return jax.tree_util.tree_map_with_path(fill, shapes)


def extra(cfg, seed=1, batch=B):
    """The prefill's extra input of ``cfg``'s family, from a numpy seed."""
    rng = np.random.default_rng(seed)
    if cfg.family == "encdec":
        return {"frames": rng.standard_normal((batch, cfg.enc_len, cfg.d_model)
                                              ).astype(np.float32)}
    return {"patches": rng.standard_normal((batch, cfg.n_vis_tokens, cfg.d_vis)
                                           ).astype(np.float32)}


def np_batch(cfg, seed=0, S=PROMPT):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
         "targets": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    b["targets"][:, :2] = -1
    return {**b, **extra(cfg, seed + 1)}


class Pair:
    """The reference and the port on the same weights in one (mode, dtype),
    with the reference's jitted prefill / decode step (inside its
    DecodeEngine) and value_and_grad compiled once."""

    def __init__(self, arch, jp_np, approx, dtype):
        mode, attn, e_a = APPROX[approx]
        self.jm = j_build_model(j_reduced(arch).replace(
            compute_dtype=dtype,
            approx=JApprox(mode=mode, e_a=e_a, omega=0.2, attn_table=attn)))
        self.tm = build_model(reduced(arch).replace(
            compute_dtype=dtype,
            approx=ApproxConfig(mode=mode, e_a=e_a, omega=0.2, attn_table=attn)),
            device="cpu")
        self.jp = jax.tree.map(jnp.asarray, jp_np)
        self.tp = params_from_jax(self.tm.cfg, jp_np, "cpu")
        self.engine = JDecodeEngine(self.jm, self.jp, B, CACHE)
        jm = self.jm

        def j_loss(p, batch):
            logits, _ = jm.train_logits(p, batch)
            return jm.loss(p, batch), logits
        self.j_loss = jax.jit(j_loss)
        self.j_grad = jax.jit(jax.value_and_grad(j_loss, has_aux=True))


@pytest.fixture(scope="module")
def pairs():
    made, weights = {}, {}

    def get(arch, approx="table_pack_attn", dtype="float32"):
        if arch not in weights:
            weights[arch] = numpy_params(arch)
        key = (arch, approx, dtype)
        if key not in made:
            made[key] = Pair(arch, weights[arch], approx, dtype)
        return made[key]
    return get


def as_np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def assert_logits_close(got, want, V, dtype, tag):
    got, want = as_np(got)[..., :V], as_np(want)[..., :V]
    assert got.shape == want.shape and np.isfinite(got).all(), tag
    err = np.abs(got - want).max()
    bound = 1e-4 if dtype == "float32" else 5e-2 * np.abs(want).max()
    assert err <= bound, (tag, err, bound)


def assert_caches_close(tc, jc, dtype):
    assert sorted(tc) == sorted(jc)
    for k, want in jc.items():
        got, want = tc[k], np.asarray(want.astype(jnp.float32)) if k != "pos" else want
        assert tuple(got.shape) == want.shape, k
        if k == "pos":
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=k)
        elif dtype == "float32":
            np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0 ** -7,
                                       atol=1e-3, err_msg=k)
        else:
            err = np.linalg.norm(got.float().numpy() - want)
            assert err <= 5e-2 * np.linalg.norm(want) + 1e-12, (k, err)


# --------------------------------------------------------------------------------------
# models/common.py
# --------------------------------------------------------------------------------------


@pytest.mark.parametrize("n,d", [(12, 64), (1500, 768), (7, 10)])
def test_sinusoidal_positions_bitwise(n, d):
    got = t_common.sinusoidal_positions(n, d)
    want = np.asarray(j_common.sinusoidal_positions(n, d))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm(dtype):
    """``init_layernorm``'s tree, and ``layernorm`` over shifted rows with
    random gains and biases, within 1e-6 (f32) or one bf16 rounding."""
    rng = np.random.default_rng(0)
    x = (3.0 + 2.0 * rng.standard_normal((3, 5, 48))).astype(np.float32)
    p = {"g": (1 + 0.1 * rng.standard_normal(48)).astype(np.float32),
         "b": (0.1 * rng.standard_normal(48)).astype(np.float32)}
    init = t_common.init_layernorm(48, "cpu")
    ref_init = j_common.init_layernorm(48)
    for k in ("g", "b"):
        np.testing.assert_array_equal(init[k].numpy(), np.asarray(ref_init[k]))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = as_np(j_common.layernorm(jax.tree.map(jnp.asarray, p),
                                    jnp.asarray(x).astype(jd)))
    got = t_common.layernorm(jax.tree.map(torch.from_numpy, p),
                             torch.from_numpy(x).to(td))
    assert got.dtype == td
    tol = dict(rtol=0, atol=1e-6) if dtype == "float32" else dict(rtol=2.0 ** -7, atol=0)
    np.testing.assert_allclose(as_np(got), want, **tol)


# --------------------------------------------------------------------------------------
# the models
# --------------------------------------------------------------------------------------


def test_encode(pairs):
    """whisper's bidirectional encoder over 12 frames (non-causal flash,
    no rope, the sinusoidal positions), the reference run eagerly: f32
    within 1e-5 (the table modes' encoder reaches the logits of
    ``test_prefill_then_decode``)."""
    mp = pairs("whisper-small", "exact")
    frames = extra(mp.tm.cfg)["frames"]
    want = mp.jm.encode(mp.jp, jnp.asarray(frames))
    with torch.inference_mode():
        got = mp.tm.encode(mp.tp, torch.from_numpy(frames))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("approx,dtype", CASES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode(pairs, arch, approx, dtype):
    """A 9-token prefill (with frames or patches) and 4 decode steps at the
    engine's scalar positions S + i, fed the reference's greedy tokens:
    logits and every cache entry (whisper's ``memory``, internvl's cache at
    cache_len + 4 patches) against the reference's; the port's greedy
    tokens identical in f32."""
    mp = pairs(arch, approx, dtype)
    cfg = mp.tm.cfg
    b = np_batch(cfg)
    jb = {k: jnp.asarray(v) for k, v in b.items() if k != "targets"}
    tb = {k: v for k, v in batch_to(b, "cpu").items() if k != "targets"}
    jc, tc = mp.jm.init_cache(B, CACHE), mp.tm.init_cache(B, CACHE)
    assert_caches_close(tc, jc, dtype)
    with torch.inference_mode():
        jl, jc = mp.engine._prefill(mp.jp, jb, jc)
        tl, tc = mp.tm.prefill(mp.tp, tb, tc)
        for i in range(N_DECODE + 1):
            assert_logits_close(tl, jl, cfg.vocab, dtype, f"step {i}")
            assert (tl.numpy()[:, cfg.vocab:] == -1e30).all()  # padded vocab masked
            assert_caches_close(tc, jc, dtype)
            tok = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
            if dtype == "float32":
                np.testing.assert_array_equal(tl.argmax(-1).numpy(), tok[:, 0])
            if i == N_DECODE:
                break
            pos = np.int32(PROMPT + i)
            jl, jc = mp.engine._step(mp.jp, jnp.asarray(tok), jnp.asarray(pos), jc)
            tl, tc = mp.tm.decode_step(mp.tp, torch.from_numpy(tok).long(),
                                       torch.as_tensor(pos), tc)
    if arch == "internvl2-1b":
        # the engine's positions count tokens only: the decode steps at
        # 9..12 rewrote the k/v of prefix positions 9..12 (4 patches + 9
        # tokens fill slots 0..12) instead of taking slots 13..16, as in the
        # reference
        W = CACHE + cfg.n_vis_tokens
        n = cfg.n_vis_tokens + PROMPT
        assert tc["pos"][0].tolist() == list(range(n)) + [-1] * (W - n)


@pytest.mark.parametrize("approx", ["exact", "table_pack_ref", "table_pack_attn"])
@pytest.mark.parametrize("arch", ARCHS)
def test_generate_batch_extra_inputs(pairs, arch, approx):
    """``DecodeEngine.generate_batch(..., extra_inputs=...)``: greedy tokens
    of a left-padded batch with per-slot budgets and an EOS equal to the
    reference engine's, in f32 (internvl: the reference's token-count decode
    positions included)."""
    mp = pairs(arch, approx)
    b = np_batch(mp.tm.cfg, seed=4)
    prompts = b["tokens"]
    prompts[1, :3] = 0  # a shorter, left-padded prompt
    ex = extra(mp.tm.cfg, seed=5)
    want, wsteps = mp.engine.generate_batch(prompts, np.asarray([5, 3]),
                                            extra_inputs=ex)
    got, steps = DecodeEngine(mp.tm, mp.tp, B, CACHE).generate_batch(
        prompts, np.asarray([5, 3]), extra_inputs=ex)
    assert steps == wsteps == 5
    np.testing.assert_array_equal(got, np.asarray(want))
    eos = int(np.asarray(want)[0, 1])  # slot 0 stops at its second token
    want, _ = mp.engine.generate_batch(prompts, 5, eos_id=[eos, -1], extra_inputs=ex)
    got, _ = DecodeEngine(mp.tm, mp.tp, B, CACHE).generate_batch(
        prompts, 5, eos_id=[eos, -1],
        extra_inputs={k: torch.from_numpy(v) for k, v in ex.items()})
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("approx,dtype", TRAIN_CASES)
@pytest.mark.parametrize("arch", ARCHS)
def test_train_logits_loss_and_grads(pairs, arch, approx, dtype):
    """``train_logits`` (internvl: the text positions only), the loss with
    ignored targets and, in f32, every gradient leaf, the port
    checkpointing each encoder and decoder layer (``remat``)."""
    mp = pairs(arch, approx, dtype)
    tm = build_model(mp.tm.cfg.replace(remat=True), device="cpu")
    b = np_batch(tm.cfg, seed=6)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    if dtype == "float32":
        (jl, jlogits), jg = mp.j_grad(mp.jp, jb)
    else:
        jl, jlogits = mp.j_loss(mp.jp, jb)
    tb = batch_to(b, "cpu")
    assert tb["tokens"].dtype == torch.int64
    assert tb[tm.extra_inputs[0]].dtype == torch.float32
    with torch.no_grad():
        tlogits, taux = tm.train_logits(mp.tp, tb)
    assert tlogits.shape == (B, PROMPT, tm.cfg.vocab_pad) and float(taux) == 0.0
    assert_logits_close(tlogits, jlogits, tm.cfg.vocab, dtype, "train logits")
    tl, tg = value_and_grad(tm, mp.tp, tb)
    assert rel(tl, jl) <= (1e-5 if dtype == "float32" else 1e-2), (float(tl), float(jl))
    if dtype == "float32":
        assert_grads_close(tm.cfg, jg, tg)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_and_train_state_convert(pairs, arch, tmp_path):
    """The trees: whisper's ``enc_layers`` / ``dec_layers`` as lists with
    every attention block's ``wo`` (``attn``, ``self``, ``cross``) in the
    port's layout, internvl's ``layers`` and ``vis_proj``; every leaf equal
    to the reference's slice; the port's own ``init`` makes the same paths
    and shapes; the train state converts alike and survives a checkpoint
    round trip."""
    cfg = reduced(arch)
    jp = pairs(arch).jp
    tp = params_from_jax(cfg, jax.tree.map(np.asarray, jp), "cpu")
    g = cfg.attn_geom
    wo = (g.g_eff, g.q_per_group, g.d_head, cfg.d_model)
    if arch == "whisper-small":
        assert sorted(tp) == ["dec_layers", "embed", "enc_layers", "enc_norm",
                              "final_norm", "unembed"]
        assert len(tp["enc_layers"]) == cfg.n_enc_layers and len(tp["dec_layers"]) == 2
        for lp, blocks in ((tp["enc_layers"][1], ("attn",)),
                           (tp["dec_layers"][1], ("self", "cross"))):
            for name in blocks:
                assert tuple(lp[name]["wo"]["w"].shape) == wo, name
        np.testing.assert_array_equal(
            tp["dec_layers"][1]["cross"]["wo"]["w"].numpy().reshape(-1),
            np.asarray(jp["dec_layers"]["cross"]["wo"]["w"][1]).reshape(-1))
        np.testing.assert_array_equal(tp["enc_layers"][0]["mlp"]["wi"]["w"].numpy(),
                                      np.asarray(jp["enc_layers"]["mlp"]["wi"]["w"][0]))
    else:
        assert sorted(tp) == ["embed", "final_norm", "layers", "unembed", "vis_proj"]
        assert tuple(tp["layers"][0]["attn"]["wo"]["w"].shape) == wo
        np.testing.assert_array_equal(tp["vis_proj"]["w"].numpy(),
                                      np.asarray(jp["vis_proj"]["w"]))
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


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_axes_and_continuous_refusal(arch):
    """Every cache entry has one batch axis (whisper's ``memory`` too);
    ContinuousEngine and the serve CLI refuse a family whose prefill needs
    extra inputs, with a message that names them."""
    model = build_model(reduced(arch), device="cpu")
    assert isinstance(model, EncDecLM if arch == "whisper-small" else VLM)
    axes = cache_batch_axes(model, 16)
    assert axes == ({"k": 1, "v": 1, "pos": 0, "memory": 0}
                    if arch == "whisper-small" else {"k": 1, "v": 1, "pos": 0})
    with pytest.raises(ValueError, match=model.extra_inputs[0]):
        ContinuousEngine(model, None, 2, 16)
    from repro_torch.launch.serve import main

    with pytest.raises(SystemExit):
        main(["--arch", arch, "--reduced", "--device", "cpu"])


def test_serve_continuous_and_serve_alias(pairs):
    """``serve_continuous`` on reduced stablelm (f32, exact): the
    reference's tokens on a mixed-EOS queue, with a fresh
    engine and with a passed one (whose batch size must agree); ``serve``
    is ``serve_static``."""
    assert serve is serve_static
    jcfg = j_reduced("stablelm-3b").replace(compute_dtype="float32",
                                            approx=JApprox(mode="exact"))
    tcfg = reduced("stablelm-3b").replace(compute_dtype="float32",
                                          approx=ApproxConfig(mode="exact"))
    jm, tm = j_build_model(jcfg), build_model(tcfg, device="cpu")
    jp = jm.init(jax.random.key(0))
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    reqs = lambda: mixed_requests(np.random.default_rng(3), 7)
    want = j_serve_continuous(jm, jp, reqs(), batch_size=2, cache_len=32)
    eng = ContinuousEngine(tm, tp, batch_size=2, cache_len=32)
    for got in (serve_continuous(tm, tp, reqs(), batch_size=2, cache_len=32),
                serve_continuous(tm, tp, reqs(), batch_size=2, cache_len=999,
                                 engine=eng)):
        for i, (a, c) in enumerate(zip(want, got)):
            np.testing.assert_array_equal(c.tokens, a.tokens, err_msg=f"req {i}")
            assert (c.steps, c.prompt_len) == (a.steps, a.prompt_len)
    assert eng.refills >= 2
    with pytest.raises(ValueError, match="batch size"):
        serve_continuous(tm, tp, reqs(), batch_size=3, cache_len=32, engine=eng)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli(arch, tmp_path, capsys):
    """The train CLI on the CPU: the synthetic batches carry ``frames`` /
    ``patches`` (f32 on the device) and 2 steps at accum 2 run finite."""
    from repro_torch.launch.train import main

    out = main(["--arch", arch, "--reduced", "--device", "cpu",
                "--steps", "2", "--batch", "4", "--seq", "16", "--accum", "2",
                "--approx-mode", "table_pack", "--approx-ea", "1e-6", "--attn-table",
                "--ckpt-dir", str(tmp_path)])
    assert "done: step=2 loss" in capsys.readouterr().out
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))


def test_full_size_geometry():
    """The full configurations the card serves: whisper's 12 + 12 layers and
    its zero-padded kv groups (12 heads -> 16), internvl's 14 q / 2 kv heads
    at g_eff 16 and its cache 256 + 256, on the meta device (shapes only)."""
    from repro_torch.models import get_config

    w = get_config("whisper-small")
    g = w.attn_geom
    assert (w.n_enc_layers, w.n_layers, w.enc_len, g.h_eff, g.g_eff, g.g_zero_pad) == (
        12, 12, 1500, 16, 16, 4)
    model = build_model(w, device="cpu")
    c = model.init_cache(4, 256, device="meta")
    assert tuple(c["memory"].shape) == (4, 1500, 768)
    assert tuple(c["k"].shape) == (12, 4, 256, 16, 64)
    v = get_config("internvl2-1b")
    g = v.attn_geom
    assert (g.h_eff, g.g_eff, g.repeat, v.vocab_pad) == (16, 16, 8, 153600)
    c = build_model(v, device="cpu").init_cache(4, 256, device="meta")
    assert tuple(c["k"].shape) == (24, 4, 512, 16, 64)
    assert dataclasses.asdict(v.approx) == dataclasses.asdict(
        get_config("stablelm-3b").approx)
