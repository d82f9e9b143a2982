"""The port's recurrent families against the JAX reference, on the CPU:
zamba2-1.2b's Mamba2 + shared-attention stack (``HybridLM``) and xlstm-125m's
mLSTM/sLSTM stack (``XLSTMLM``), each ``reduced`` (zamba2: d=64, 5 layers in
2 groups of 2 and 1 trailing, chunk 8; xlstm: d=64, 2 heads, one pair), on
weights made with numpy in the reference's tree and carried over by
``params_from_jax``; and their blocks (``gated_outer_scan``,
``_causal_conv``, ``mamba2_block``, ``mlstm_block``, ``slstm_block``) on
numpy inputs.  13-token prompts cross zamba2's chunk of 8 (the pad to a
multiple of the chunk and the carried state), and ``mlstm_block`` runs at
``chunk=4`` over 11 tokens from a nonzero cache (its ``-1e30`` input-gate
padding and the carry across chunks), which the reduced xlstm at its fixed
chunk of 128 never reaches.  The reference's caches (nested NamedTuples) are
compared through ``flat_ref_cache``, the map to the port's flat dict.

Tolerances, with their reasons (those of ``tests/test_torch_archs.py``):

* f32 logits: 1e-4 absolute (the frameworks sum the matrix products and the
  cumulative sums in other orders; the lookups agree to 1 ULP);
* f32 block outputs and states: ``rtol=1e-4, atol=1e-5`` of the
  reference's (the same sums); a model's states ``atol=1e-4``, the logits'
  bound (the residual stream's differences through the layers); the
  position buffers bit for bit, the bf16 k/v caches within one bf16
  rounding (relative 2**-7, and 1e-3 absolute);
* bf16 compute: logits within 5e-2 of the largest logit (bf16 rounds at
  other places in the two frameworks: XLA keeps excess precision inside a
  fusion, eager PyTorch rounds every op; the reduced zamba2's logits are
  small, max ~0.4, and the reference's own bf16 prefill logits differ from
  its f32 ones by 3.0e-2 of the largest, the port's from the reference's
  bf16 ones by 2.9e-2), and every state within 5e-2 of the reference's in
  norm (a state integrates the prompt's bf16-rounded
  inputs through every layer: 3.1e-2 at worst, the trailing Mamba2 state
  after the decode steps), the stabilizers' -1e30 start bit for bit;
* train logits 1e-4, the loss 1e-5 relative, each gradient leaf
  ``||g_t - g_j|| <= 1e-3 ||g_j||`` (the table slope is piecewise constant;
  ``torch.cummax`` routes a tie's gradient to another index than
  ``lax.cummax``, and ``torch.minimum``/``maximum`` split ties as JAX does);
  the table modes at e_a 1e-6;
* exact softplus: the port writes ``jax.nn.softplus``'s formula
  (``logaddexp(x, 0)``), not ``F.softplus``; it is held by the tolerances
  above, not to the bit;
* the engines: identical greedy tokens to the reference's engines on the
  same left-padded queue (the pad tokens run through the recurrent state on
  both sides).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.ssm as j_ssm
import repro.models.xlstm as j_xlstm
from repro.approx import ApproxConfig as JApprox
from repro.models import build_model as j_build_model
from repro.optim import adamw as j_adamw
from repro.serving.engine import ContinuousEngine as JContinuousEngine
from repro.serving.engine import DecodeEngine as JDecodeEngine
from repro_torch.approx import ApproxConfig
from repro_torch.convert import params_from_jax, train_state_from_jax
from repro_torch.models import build_model, reduced
from repro_torch.models import ssm as t_ssm
from repro_torch.models import xlstm as t_xlstm
from repro_torch.serving.engine import (ContinuousEngine, DecodeEngine, cache_batch_axes,
                                        scatter_cache_slots)
from repro_torch.train import CheckpointManager
from repro_torch.train.loop import batch_to, value_and_grad
from repro_torch.tree import leaves, leaves_with_path
from tests.test_archs import reduced as j_reduced
from tests.test_serving import mixed_requests
from tests.test_torch_train import assert_grads_close, np_batch, rel

ARCHS = ("zamba2-1.2b", "xlstm-125m")
APPROX = {  # name -> (mode, attn_table, e_a): tests/test_torch_archs.py's
    "exact": ("exact", False, 1e-4),
    "table_pack_attn": ("table_pack", True, 1e-6),
}
DTYPES = ("float32", "bfloat16")
STACKED = {"mamba": 2, "mamba_tail": 1, "mlstm": 1, "slstm": 1}  # leading axes
# the reference's cache subtrees (NamedTuples) -> the port's flat prefixes
REF_CACHE_PREFIX = {"mamba": "mamba_", "mamba_tail": "mamba_tail_", "m": "m_", "s": "s_"}
PROMPT = 13  # crosses the reduced zamba2's chunk of 8


def flat_ref_cache(jc):
    """The reference's cache as the port's flat dict: a NamedTuple of stacked
    state fields becomes one entry a field, under its subtree's prefix."""
    out = {}
    for k, v in jc.items():
        if hasattr(v, "_fields"):
            out.update({REF_CACHE_PREFIX[k] + f: getattr(v, f) for f in v._fields})
        else:
            out[k] = v
    return out


def numpy_params(arch, seed=0):
    """A reference parameter tree of ``reduced(arch)`` (its shapes from
    ``jax.eval_shape`` of ``init``), filled from a numpy seed: tables and
    ``wo`` N(0, 0.02), the other weights N(0, 1/fan_in), the norm gains
    1 + N(0, 0.1); the Mamba2 ``a_log`` the reference's log(linspace(1, 16))
    + N(0, 0.1), ``dt_bias`` N(0, 0.25), ``d_skip`` 1 + N(0, 0.1); the
    xLSTM forget biases 3 + N(0, 0.25) (the reference's open-forget init)."""
    shapes = jax.eval_shape(j_build_model(j_reduced(arch)).init, jax.random.key(0))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        keys = [k.key for k in path]
        z = rng.standard_normal(leaf.shape).astype(np.float32)
        if keys[-1] == "g":
            return 1 + 0.1 * z
        if keys[-1] == "a_log":
            return np.log(np.linspace(1, 16, leaf.shape[-1], dtype=np.float32)) + 0.1 * z
        if keys[-1] == "dt_bias":
            return 0.5 * z
        if keys[-1] == "d_skip":
            return 1 + 0.1 * z
        if keys[-1] == "f_bias":
            return 3 + 0.5 * z
        if keys[-1] == "table" or keys[-2:] == ["wo", "w"] and keys[0] == "shared":
            return 0.02 * z
        return z / np.float32(np.sqrt(leaf.shape[STACKED.get(keys[0], 0)]))
    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def jax_params():
    made = {}

    def get(arch):
        if arch not in made:
            made[arch] = numpy_params(arch)
        return made[arch]
    return get


def pair(jax_params, arch, approx="exact", dtype="float32"):
    """(jax model, jax params, port model, port params) on the same weights."""
    mode, attn, e_a = APPROX[approx]
    jm = j_build_model(j_reduced(arch).replace(
        compute_dtype=dtype,
        approx=JApprox(mode=mode, e_a=e_a, omega=0.2, attn_table=attn)))
    tm = build_model(reduced(arch).replace(
        compute_dtype=dtype,
        approx=ApproxConfig(mode=mode, e_a=e_a, omega=0.2, attn_table=attn)),
        device="cpu")
    jp = jax_params(arch)
    return jm, jax.tree.map(jnp.asarray, jp), tm, params_from_jax(tm.cfg, jp, "cpu")


def close(got, want, tag, dtype="float32", atol=1e-5):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape, tag
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=atol, err_msg=tag)
    else:
        fin = np.abs(want) < 1e29  # the stabilizers' -1e30 start
        np.testing.assert_array_equal(got[~fin], want[~fin], err_msg=tag)
        err = np.linalg.norm(got[fin] - want[fin])
        assert err <= 5e-2 * np.linalg.norm(want[fin]) + 1e-12, (tag, err)


def assert_caches_close(tc, jc, dtype="float32"):
    jc = flat_ref_cache(jc)
    assert sorted(tc) == sorted(jc)
    for k, want in jc.items():
        got = tc[k]
        assert tuple(got.shape) == want.shape, k
        if k.endswith("pos"):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=k)
        elif k.startswith("attn_") and dtype == "float32":
            np.testing.assert_allclose(got.float().numpy(),
                                       np.asarray(want.astype(jnp.float32)),
                                       rtol=2.0 ** -7, atol=1e-3, err_msg=k)
        else:
            close(got, want, k, dtype, atol=1e-4)


# --------------------------------------------------------------------------------------
# the blocks
# --------------------------------------------------------------------------------------


def acts(mode, names, e_a=1e-6):
    """The reference's and the port's unaries ``names`` in ``mode``."""
    j = JApprox(mode=mode, e_a=e_a, omega=0.2)
    t = ApproxConfig(mode=mode, e_a=e_a, omega=0.2)
    return [j.unary(n) for n in names], [t.unary(n, "cpu") for n in names]


def randn(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def test_gated_outer_scan():
    """Two chunks of 8 from a nonzero state: outputs and the final state."""
    rng = np.random.default_rng(0)
    B, H, S, P, N = 2, 3, 16, 4, 5
    log_a = -np.abs(randn(rng, B, H, S, scale=0.3))
    u, w, r = randn(rng, B, H, S, P), randn(rng, B, H, S, N), randn(rng, B, H, S, N)
    s0 = randn(rng, B, H, P, N)
    jy, js = jax.jit(j_ssm.gated_outer_scan, static_argnames="chunk")(
        *map(jnp.asarray, (log_a, u, w, r, s0)), chunk=8)
    ty, ts = t_ssm.gated_outer_scan(*map(torch.from_numpy, (log_a, u, w, r, s0)), chunk=8)
    close(ty, jy, "y")
    close(ts, js, "state")


@pytest.mark.parametrize("carry", [False, True])
def test_causal_conv(carry):
    rng = np.random.default_rng(1)
    x, w = randn(rng, 2, 7, 6), randn(rng, 4, 6, scale=0.2)
    c = randn(rng, 2, 3, 6) if carry else None
    jo, jc = j_ssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                None if c is None else jnp.asarray(c))
    to, tc = t_ssm._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                                None if c is None else torch.from_numpy(c))
    close(to, jo, "out")
    close(tc, jc, "carry")


@pytest.mark.parametrize("mode", ["exact", "table_pack"])
def test_mamba2_block_prefill_then_decode(jax_params, mode):
    """A 13-token prefill (padded to 16: two chunks of 8) from no cache,
    then 2 single-token steps (the S == 1 path) from its cache: outputs and
    every cache field."""
    cfg = reduced("zamba2-1.2b")
    s = cfg.ssm
    lp = jax_params("zamba2-1.2b")["mamba"]["m"]
    jp = jax.tree.map(lambda a: jnp.asarray(a[0, 1]), lp)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.asarray(a[0, 1])), lp)
    (jsilu, jsoftplus), (tsilu, tsoftplus) = acts(mode, ("silu", "softplus"))
    kw = dict(expand=s.expand, head_dim=s.head_dim, state_dim=s.state_dim,
              conv_width=s.conv_width, chunk=s.chunk)
    jblock = jax.jit(lambda p, x, c: j_ssm.mamba2_block(
        p, x, act_silu=jsilu, act_softplus=jsoftplus, cache=c, **kw))
    rng = np.random.default_rng(2)
    jc = tc = None
    for S in (PROMPT, 1, 1):
        x = randn(rng, 2, S, cfg.d_model)
        jy, jc = jblock(jp, jnp.asarray(x), jc)
        ty, tc = t_ssm.mamba2_block(tp, torch.from_numpy(x), act_silu=tsilu,
                                    act_softplus=tsoftplus, cache=tc, **kw)
        close(ty, jy, f"y S={S}")
        for f in jc._fields:
            close(getattr(tc, f), getattr(jc, f), f"{f} S={S}")


@pytest.mark.parametrize("mode", ["exact", "table_pack"])
@pytest.mark.parametrize("with_cache", [False, True])
def test_mlstm_block_across_chunks(mode, with_cache):
    """``chunk=4`` over 11 tokens (3 chunks, the last padded by 1 with the
    -1e30 input gate), from a fresh or a nonzero cache: the output and the
    carried (C, n, m)."""
    rng = np.random.default_rng(3)
    B, S, d, H = 2, 11, 16, 2
    D = d // H
    p = {"wq": {"w": randn(rng, d, d, scale=d ** -0.5)},
         "wk": {"w": randn(rng, d, d, scale=d ** -0.5)},
         "wv": {"w": randn(rng, d, d, scale=d ** -0.5)},
         "wi": {"w": randn(rng, d, H, scale=d ** -0.5)},
         "wf": {"w": randn(rng, d, H, scale=d ** -0.5)},
         "wog": {"w": randn(rng, d, d, scale=d ** -0.5)},
         "norm": {"g": 1 + randn(rng, d, scale=0.1)},
         "wo": {"w": randn(rng, d, d, scale=d ** -0.5)},
         "f_bias": 3 + randn(rng, H, scale=0.5)}
    x = randn(rng, B, S, d)
    cache = None
    if with_cache:
        cache = (randn(rng, B, H, D, D), np.abs(randn(rng, B, H, D)),
                 randn(rng, B, H, scale=2.0))
    (jsig, jexp), (tsig, texp) = acts(mode, ("sigmoid", "exp"))
    jy, jc = jax.jit(lambda p, x, c: j_xlstm.mlstm_block(
        p, x, n_heads=H, act_sigmoid=jsig, act_exp=jexp, cache=c, chunk=4))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x),
        None if cache is None else j_xlstm.MLSTMCache(*map(jnp.asarray, cache)))
    ty, tc = t_xlstm.mlstm_block(
        jax.tree.map(torch.from_numpy, p), torch.from_numpy(x), n_heads=H,
        act_sigmoid=tsig, act_exp=texp, chunk=4,
        cache=None if cache is None else t_xlstm.MLSTMCache(*map(torch.from_numpy,
                                                                  cache)))
    close(ty, jy, "y")
    for f in jc._fields:
        close(getattr(tc, f), getattr(jc, f), f)


@pytest.mark.parametrize("mode", ["exact", "table_pack"])
def test_slstm_block(mode):
    """5 steps from a nonzero cache: the output and (h, c, n, m)."""
    rng = np.random.default_rng(4)
    B, S, d = 2, 5, 16
    p = {k: {"w": randn(rng, d, d, scale=d ** -0.5)}
         for k in ("wz", "wi", "wf", "wo", "rz", "ri", "rf", "ro", "wd")}
    p["f_bias"] = 3 + randn(rng, d, scale=0.5)
    p["norm"] = {"g": 1 + randn(rng, d, scale=0.1)}
    x = randn(rng, B, S, d)
    cache = (randn(rng, B, d), randn(rng, B, d), np.abs(randn(rng, B, d)) + 0.5,
             randn(rng, B, d))
    (jsig, jtanh, jexp), (tsig, ttanh, texp) = acts(mode, ("sigmoid", "tanh", "exp"))
    jy, jc = jax.jit(lambda p, x, c: j_xlstm.slstm_block(
        p, x, act_sigmoid=jsig, act_tanh=jtanh, act_exp=jexp, cache=c))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x),
        j_xlstm.SLSTMCache(*map(jnp.asarray, cache)))
    ty, tc = t_xlstm.slstm_block(
        jax.tree.map(torch.from_numpy, p), torch.from_numpy(x), act_sigmoid=tsig,
        act_tanh=ttanh, act_exp=texp,
        cache=t_xlstm.SLSTMCache(*map(torch.from_numpy, cache)))
    close(ty, jy, "y")
    for f in jc._fields:
        close(getattr(tc, f), getattr(jc, f), f)


def test_exact_softplus_is_the_references():
    """``jax.nn.softplus``'s formula, past F.softplus's threshold of 20 too,
    and its gradient (sigmoid, 0.5 at the tie at 0)."""
    x = np.concatenate([np.linspace(-40, 40, 801), [0.0, -1e30, 1e30]]).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = t_xlstm.softplus(xt)
    (g,) = torch.autograd.grad(y.sum(), xt)
    jy, jg = jax.value_and_grad(lambda v: jax.nn.softplus(v).sum())(jnp.asarray(x))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jax.nn.softplus(x)),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-6, atol=1e-7)
    assert float(g[-3]) == 0.5


# --------------------------------------------------------------------------------------
# the models
# --------------------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("approx", sorted(APPROX))
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode(jax_params, arch, approx, dtype):
    """A 13-token prefill and 3 decode steps: logits and every cache entry
    against the reference's."""
    jm, jp, tm, tp = pair(jax_params, arch, approx, dtype)
    V = tm.cfg.vocab
    toks = np.random.default_rng(0).integers(0, V, (2, PROMPT)).astype(np.int32)
    jc, tc = jm.init_cache(2, 16), tm.init_cache(2, 16)
    assert_caches_close(tc, jc, dtype)
    outs = []
    with torch.inference_mode():
        jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)}, jc)
        tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks).long()}, tc)
        assert_caches_close(tc, jc, dtype)
        outs.append((jl, tl))
        tok = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
        decode = jax.jit(jm.decode_step)
        # per-slot clocks, then a shared scalar one (zamba2's shared block;
        # the xLSTM states carry no position, so it would only recompile)
        last = np.int32(15) if arch == "zamba2-1.2b" else np.asarray([15, 15], np.int32)
        for pos in (np.asarray([13, 13], np.int32), np.asarray([14, 14], np.int32), last):
            jl, jc = decode(jp, jnp.asarray(tok), jnp.asarray(pos), jc)
            tl, tc = tm.decode_step(tp, torch.from_numpy(tok).long(),
                                    torch.as_tensor(pos), tc)
            outs.append((jl, tl))
            tok = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
    assert_caches_close(tc, jc, dtype)
    for jl, tl in outs:
        want, got = np.asarray(jl.astype(jnp.float32))[:, :V], tl.float().numpy()[:, :V]
        assert np.isfinite(got).all()
        err = np.abs(got - want).max()
        if dtype == "float32":
            assert err <= 1e-4, err
        else:
            assert err <= 5e-2 * np.abs(want).max(), err
        assert (tl.numpy()[:, V:] == -1e30).all()  # padded vocab masked


@pytest.mark.parametrize("arch", ARCHS)
def test_train_logits_loss_and_grads(jax_params, arch):
    """``train_logits``, the loss and every gradient leaf through
    ``table_pack`` + TableFlash, the port checkpointing each hybrid group
    and trailing layer, and each xLSTM pair (``remat``): the shared block's
    gradient sums over its uses."""
    jm, jp, tm, tp = pair(jax_params, arch, "table_pack_attn")
    tm = build_model(tm.cfg.replace(remat=True), device="cpu")
    b = np_batch(tm.cfg.vocab, B=2, S=PROMPT, ignore=True)

    def j_loss(p, batch):
        logits, aux = jm.train_logits(p, batch)
        return jm.loss(p, batch), logits

    (jl, jlogits), jg = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in b.items()})
    tb = batch_to(b, "cpu")
    with torch.no_grad():
        tlogits, taux = tm.train_logits(tp, tb)
    V = tm.cfg.vocab
    err = np.abs(tlogits.numpy()[..., :V] - np.asarray(jlogits)[..., :V]).max()
    assert err <= 1e-4, err
    assert float(taux) == 0.0
    tl, tg = value_and_grad(tm, tp, tb)
    assert rel(tl, jl) <= 1e-5, (float(tl), float(jl))
    assert_grads_close(tm.cfg, jg, tg)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_and_train_state_convert(jax_params, arch, tmp_path):
    """The hybrid tree (``mamba`` as 2 groups of 2, ``mamba_tail`` as 1,
    ``shared`` whole) and the xLSTM tree (``mlstm``/``slstm`` as lists), every
    leaf equal to the reference's slice; the port's own ``init`` makes the
    same paths and shapes; the train state converts alike and survives a
    checkpoint round trip."""
    cfg = reduced(arch)
    jp = jax_params(arch)
    tp = params_from_jax(cfg, jp, "cpu")
    if arch == "zamba2-1.2b":
        assert sorted(tp) == ["embed", "final_norm", "mamba", "mamba_tail", "shared",
                              "unembed"]
        assert [len(g) for g in tp["mamba"]] == [2, 2] and len(tp["mamba_tail"]) == 1
        np.testing.assert_array_equal(tp["mamba"][1][0]["m"]["in_x"]["w"].numpy(),
                                      jp["mamba"]["m"]["in_x"]["w"][1, 0])
        np.testing.assert_array_equal(tp["mamba_tail"][0]["m"]["a_log"].numpy(),
                                      jp["mamba_tail"]["m"]["a_log"][0])
        g = cfg.attn_geom
        assert tuple(tp["shared"]["attn"]["wo"]["w"].shape) == (
            g.g_eff, g.q_per_group, g.d_head, cfg.d_model)
    else:
        assert sorted(tp) == ["embed", "final_norm", "mlstm", "slstm", "unembed"]
        assert len(tp["mlstm"]) == len(tp["slstm"]) == 1
        np.testing.assert_array_equal(tp["slstm"][0]["b"]["rf"]["w"].numpy(),
                                      jp["slstm"]["b"]["rf"]["w"][0])
        np.testing.assert_array_equal(tp["mlstm"][0]["b"]["f_bias"].numpy(),
                                      jp["mlstm"]["b"]["f_bias"][0])
    assert sum(t.numel() for t in leaves(tp)) == sum(a.size for a in jax.tree.leaves(jp))
    own = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    assert ([(p, tuple(t.shape)) for p, t in leaves_with_path(own)]
            == [(p, tuple(t.shape)) for p, t in leaves_with_path(tp)])
    state = train_state_from_jax(cfg, jax.tree.map(np.asarray, {
        "params": jp, "opt": j_adamw.init(jp), "step": jnp.zeros((), jnp.int32)}), "cpu")
    assert len(leaves(state["opt"]["v"])) == len(leaves(tp))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, state)
    back = mgr.restore(1, state)
    for a, c in zip(leaves(state), leaves(back)):
        assert torch.equal(a, c)


@pytest.mark.parametrize("arch", ARCHS)
def test_engines_match_reference_engines(jax_params, arch):
    """Greedy tokens of the port's DecodeEngine (one left-padded batch) and
    ContinuousEngine (a mixed-EOS queue, at least 2 refills, each refill
    scattering the fresh recurrent state and, for zamba2, the shared block's
    k/v rows) equal the reference engines' on the same queue."""
    jm, jp, tm, tp = pair(jax_params, arch, "table_pack_attn")
    rng = np.random.default_rng(5)
    prompts = rng.integers(0, tm.cfg.vocab, (2, 9)).astype(np.int32)
    want, _ = JDecodeEngine(jm, jp, 2, 32).generate_batch(prompts, 5)
    got, _ = DecodeEngine(tm, tp, 2, 32).generate_batch(prompts, 5)
    np.testing.assert_array_equal(got, np.asarray(want))
    reqs = lambda: mixed_requests(np.random.default_rng(3), 7, lo_new=2, hi_new=6)
    want = JContinuousEngine(jm, jp, batch_size=2, cache_len=32).serve(reqs())
    eng = ContinuousEngine(tm, tp, batch_size=2, cache_len=32)
    got = eng.serve(reqs())
    assert eng.refills >= 2
    for i, (a, b) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(b.tokens, a.tokens, err_msg=f"req {i}")
        assert (b.steps, b.prompt_len) == (a.steps, a.prompt_len)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_axes_and_scatter(arch):
    """Every flat cache entry has one batch axis; a refill moves only the
    refilled slot's rows of the states (and of the k/v and positions)."""
    model = build_model(reduced(arch), device="cpu")
    axes = cache_batch_axes(model, 16)
    if arch == "zamba2-1.2b":
        assert axes == {"mamba_state": 2, "mamba_conv_x": 2, "mamba_conv_b": 2,
                        "mamba_conv_c": 2, "attn_k": 1, "attn_v": 1, "attn_pos": 0,
                        "mamba_tail_state": 1, "mamba_tail_conv_x": 1,
                        "mamba_tail_conv_b": 1, "mamba_tail_conv_c": 1}
    else:
        assert axes == {"m_c": 1, "m_n": 1, "m_m": 1, "s_h": 1, "s_c": 1, "s_n": 1,
                        "s_m": 1}
        assert (model.init_cache(3, 8)["m_m"] == -1e30).all()
    dst = model.init_cache(3, 8)
    src = {k: v + 1 for k, v in dst.items()}
    out = scatter_cache_slots(dst, src, [1], axes)
    for k, ax in axes.items():
        moved = out[k].movedim(ax, 0)
        assert torch.equal(moved[1], src[k].movedim(ax, 0)[1]), k
        assert torch.equal(moved[0], dst[k].movedim(ax, 0)[0]), k


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli(arch, tmp_path, capsys):
    from repro_torch.launch.serve import main

    trace = tmp_path / "trace.json"
    res = main(["--arch", arch, "--reduced", "--device", "cpu", "--requests", "3",
                "--batch", "2", "--max-new", "3", "--approx-mode", "table_pack",
                "--approx-ea", "1e-6", "--attn-table", "--trace", str(trace)])
    assert [r.steps for r in res] == [3, 3, 3]
    assert "served 3 requests, 9 tokens on cpu" in capsys.readouterr().out
    assert "refill.scatter" in trace.read_text()


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli(arch, tmp_path, capsys):
    from repro_torch.launch.train import main

    out = main(["--arch", arch, "--reduced", "--device", "cpu",
                "--steps", "2", "--batch", "4", "--seq", "16", "--accum", "2",
                "--approx-mode", "table_pack", "--approx-ea", "1e-6",
                "--ckpt-dir", str(tmp_path)])
    assert "done: step=2 loss" in capsys.readouterr().out
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))


def test_full_depth_layout():
    """The full depths' layouts: zamba2's 38 Mamba2 layers as 6 groups of 6
    and 2 trailing, xlstm's 12 layers as 6 pairs; an odd xLSTM depth is
    refused, as in the reference."""
    z = build_model(reduced("zamba2-1.2b").replace(n_layers=38, shared_attn_every=6),
                    device="cpu")
    assert (z.n_groups, z.per_group, z.trailing) == (6, 6, 2)
    x = build_model(reduced("xlstm-125m").replace(n_layers=12), device="cpu")
    assert x.n_pairs == 6
    with pytest.raises(ValueError, match="even layers"):
        build_model(reduced("xlstm-125m").replace(n_layers=3), device="cpu")
