"""The port's MoE block (``repro_torch.models.mlp.moe``) against the JAX
reference's (``repro.models.mlp.moe``), on the CPU, on the same weights and
tokens made with numpy.

The reference returns only the output and the aux loss, so its routing and
dispatch are read two ways: ``j_route`` / ``j_dispatch`` below are the
reference's own lines (``src/repro/models/mlp.py:93-127``) in jnp, and the
reference's ``moe`` itself, run with identity experts and an identity ``act``,
hands its (E, C, d) dispatch buffer to ``act``, where the test reads it.

Tolerances, with their reasons:

* expert ids, ``order``, ``dest`` and ``keep`` (``dest`` below the scratch
  row): bit for bit (ties, which
  ``jax.lax.top_k`` breaks toward the lower id, are broken alike);
* probabilities and gates: 1e-6 absolute (both softmaxes in f32, summed in
  other orders);
* the dispatch buffer: bit for bit (a product by an identity is exact);
* the aux loss: 1e-6 absolute;
* the output in f32: 1e-4 absolute (the products sum in other orders);
* the combine in bf16: bit for bit against a sequential scatter-add over the
  expert-sorted slots, the reference's op order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.mlp import moe as j_moe
from repro_torch.models import build_model, reduced
from repro_torch.models.mlp import (moe, moe_capacity, moe_combine, moe_dispatch,
                                   moe_route)
from tests.test_torch_train import np_batch

D, F, E, K = 16, 8, 8, 2


def np_moe_params(rng, d=D, f=F, e=E, n_shared=0):
    """A reference MoE tree of numpy f32 arrays, N(0, 1/fan_in) weights."""
    n = lambda *s: (rng.standard_normal(s) / np.sqrt(s[-2])).astype(np.float32)
    p = {"router": {"w": n(d, e)},
         "experts": {"wi": n(e, d, f), "wu": n(e, d, f), "wd": n(e, f, d)}}
    if n_shared:
        p["shared"] = {"wi": {"w": n(d, n_shared * f)}, "wu": {"w": n(d, n_shared * f)},
                       "wd": {"w": n(n_shared * f, d)}}
    return p


def as_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def as_torch(tree):
    if isinstance(tree, dict):
        return {k: as_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def j_route(w, xt, top_k, device_groups=0, max_groups=0):
    """The reference's routing lines (mlp.py:93-110)."""
    logits = jnp.einsum("td,de->te", xt.astype(jnp.float32), w.astype(jnp.float32))
    probs = jax.nn.softmax(logits, axis=-1)
    T, n_e = probs.shape
    if device_groups and max_groups and max_groups < device_groups:
        per = n_e // device_groups
        group_score = probs.reshape(T, device_groups, per).max(-1)
        _, top_g = jax.lax.top_k(group_score, max_groups)
        allowed = jnp.zeros((T, device_groups), bool).at[
            jnp.arange(T)[:, None], top_g].set(True)
        probs = jnp.where(jnp.repeat(allowed, per, axis=1), probs, 0.0)
    gate, eidx = jax.lax.top_k(probs, top_k)
    gate = gate / jnp.maximum(gate.sum(-1, keepdims=True), 1e-9)
    return probs, gate, eidx


def j_dispatch(eidx, n_e, C):
    """The reference's dispatch lines (mlp.py:118-127)."""
    flat_e = eidx.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    ranks = (jnp.arange(flat_e.shape[0])
             - jnp.searchsorted(sorted_e, sorted_e, side="left"))
    keep = ranks < C
    dest = jnp.where(keep, sorted_e * C + ranks, n_e * C)
    return order, dest, keep


def capacity(T, k=K, e=E, cf=1.25):
    return int(cf * T * k / e) + 1


ROUTING = {"free": (0, 0), "device_limited": (2, 1)}


@pytest.mark.parametrize("routing", sorted(ROUTING))
@pytest.mark.parametrize("T", [6, 64])
def test_routing_and_dispatch_match_reference(routing, T):
    """Probabilities, gates and expert ids, then ``order``, ``dest`` and
    ``keep``, against the reference's lines on the same f32 tokens; at T=64
    several experts overflow their capacity."""
    groups, max_groups = ROUTING[routing]
    rng = np.random.default_rng(T)
    w = np_moe_params(rng)["router"]["w"]
    xt = rng.standard_normal((T, D)).astype(np.float32)
    jp, jg, je = j_route(jnp.asarray(w), jnp.asarray(xt), K, groups, max_groups)
    tp, tg, te = moe_route(torch.from_numpy(w), torch.from_numpy(xt), top_k=K,
                           device_groups=groups, max_groups=max_groups)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=0, atol=1e-6)
    if groups:  # each token routes within one group of E // groups experts
        assert (te // (E // groups)).eq(te[:, :1] // (E // groups)).all()
    C = capacity(T)
    assert moe_capacity(T, K, E, 1.25) == C
    jo, jd, jk = j_dispatch(je, E, C)
    to, td = moe_dispatch(te, E, C)
    tk = td < E * C
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    if T == 64:
        assert not tk.all(), "slots drop at T=64"


def test_top_k_ties_break_to_the_lower_id():
    """Equal probabilities (a zero router): the experts 0..k-1, as
    ``jax.lax.top_k`` picks them."""
    xt = np.ones((3, D), np.float32)
    w = np.zeros((D, E), np.float32)
    _, _, je = j_route(jnp.asarray(w), jnp.asarray(xt), K)
    _, gate, te = moe_route(torch.from_numpy(w), torch.from_numpy(xt), top_k=K)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(te.numpy(), [[0, 1]] * 3)
    assert (gate == 0.5).all()


def test_dispatch_buffer_matches_reference_moe():
    """The reference's ``moe`` itself, with identity experts (d_ff = d) and
    an identity ``act``: the (E, C, d) buffer it hands to ``act`` equals the
    port's bit for bit, drops included."""
    rng = np.random.default_rng(1)
    T = 48
    p = np_moe_params(rng, f=D)
    eye = np.broadcast_to(np.eye(D, dtype=np.float32), (E, D, D)).copy()
    p["experts"] = {"wi": eye, "wu": np.ones_like(eye), "wd": eye}
    x = rng.standard_normal((2, T // 2, D)).astype(np.float32)
    seen = {}

    def j_spy(h):
        seen["j"] = h
        return h

    def t_spy(h):
        seen["t"] = h
        return h

    j_moe(as_jax(p), jnp.asarray(x), j_spy, top_k=K)
    moe(as_torch(p), torch.from_numpy(x), t_spy, top_k=K)
    assert tuple(seen["t"].shape) == (E, capacity(T), D)
    np.testing.assert_array_equal(seen["t"].numpy(), np.asarray(seen["j"]))
    assert int((seen["t"].abs().sum(-1) > 0).sum()) < T * K, "some slots dropped"


@pytest.mark.parametrize("routing", sorted(ROUTING))
@pytest.mark.parametrize("n_shared", [0, 2])
@pytest.mark.parametrize("T", [4, 64])
def test_moe_output_and_aux_match_reference(routing, n_shared, T):
    """Output (f32) within 1e-4 and aux within 1e-6 of the reference's, with
    and without shared experts, at a decode-sized T (C = 2) and at T=64,
    where slots drop."""
    groups, max_groups = ROUTING[routing]
    rng = np.random.default_rng(10 + T)  # the same tokens and router either way
    # tokens with a common mean: the router favours some experts, which overflow
    x = (rng.standard_normal((2, T // 2, D)) + 1).astype(np.float32)
    p = np_moe_params(rng, n_shared=n_shared)
    kw = dict(top_k=K, device_groups=groups, max_groups=max_groups)
    if T == 64:
        _, _, eidx = moe_route(torch.from_numpy(p["router"]["w"]),
                               torch.from_numpy(x.reshape(T, D)), **kw)
        assert (moe_dispatch(eidx, E, capacity(T))[1] == E * capacity(T)).any(), \
            "slots drop"
    jy, jaux = j_moe(as_jax(p), jnp.asarray(x), jax.nn.silu, **kw)
    ty, taux = moe(as_torch(p), torch.from_numpy(x), torch.nn.functional.silu, **kw)
    assert tuple(ty.shape) == x.shape
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0, atol=1e-4)
    assert abs(float(taux) - float(jaux)) <= 1e-6, (float(taux), float(jaux))


def test_combine_is_the_sorted_scatter_add():
    """``moe_combine`` in bf16 equals, bit for bit, a sequential scatter-add of
    the expert-sorted slots' weighted rows into their tokens (the
    reference's ``y.at[slot_token[order]].add``), dropped slots reading
    zeros."""
    rng = np.random.default_rng(2)
    T = 16
    w = torch.from_numpy(np_moe_params(rng)["router"]["w"])
    xt = torch.from_numpy(rng.standard_normal((T, D)).astype(np.float32))
    _, gate, eidx = moe_route(w, xt, top_k=K)
    C = capacity(T)
    order, dest = moe_dispatch(eidx, E, C)
    assert (dest == E * C).any(), "slots drop"
    ye = torch.from_numpy(rng.standard_normal((E, C, D)).astype(np.float32)).bfloat16()
    got = moe_combine(ye, order, dest, gate, eidx)
    ye_flat = torch.cat([ye.reshape(E * C, D), torch.zeros((1, D), dtype=ye.dtype)])
    slot_gate = gate.reshape(-1)[order].bfloat16()
    want = torch.zeros((T, D), dtype=torch.bfloat16)
    for i in range(T * K):
        t = int(order[i]) // K
        want[t] = want[t] + ye_flat[dest[i]] * slot_gate[i]
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)


def test_moe_capacity_drops_are_bounded():
    """The reference's ``tests/test_archs.py`` bound on the reduced
    deepseek-moe-16b's aux loss (~1 when balanced), through the port's model."""
    cfg = reduced("deepseek-moe-16b")
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    b = np_batch(cfg.vocab, B=4, S=32)
    with torch.no_grad():
        logits, aux = model.train_logits(params,
                                         {"tokens": torch.from_numpy(b["tokens"])})
    assert tuple(logits.shape) == (4, 32, cfg.vocab_pad)
    assert torch.isfinite(logits).all()
    assert 0.5 < float(aux) < 4.0
