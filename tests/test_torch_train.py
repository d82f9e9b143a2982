"""The port's training path against the JAX reference, on the CPU, on
``reduced("stablelm-3b")`` (2 layers, d=64) with the reference's weights
carried over by ``params_from_jax`` / ``train_state_from_jax``.  All inputs
are made with numpy from a seed and go to both packages.

Tolerances, with their reasons:

* AdamW ``update`` / ``schedule``: 1e-6 relative in f32, each leaf as
  ``||a - b|| <= 1e-6 ||b||`` (the same op order, but the global norm sums in
  another order, so the clip scale can differ by an ULP, and ``0.9 m + 0.1 g``
  cancels in places, where one element's relative error is far larger);
* ``SyntheticLM.batch_at``: bit for bit (the same numpy Philox stream);
* ``loss`` in ``compute_dtype="float32"``: 1e-5 relative; each gradient
  leaf ``||g_t - g_j|| <= 1e-3 ||g_j||``.  The bound is loose because the
  table slope is piecewise constant: a 1-ULP shift of an activation near a
  breakpoint (the two frameworks sum the matrix products in other orders)
  picks the neighbouring segment's slope;
* 4 train steps (accum 2): losses within 1e-4 relative, for the same reason
  compounded over the AdamW updates;
* accum=2 against accum=1: loss 1e-5 relative, parameters 1e-5 absolute
  (the reference's own ``tests/test_train.py`` bounds);
* a restart resumes bit for bit (same process, same data stream, f32
  checkpoint).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.approx import ApproxConfig as JApprox
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models import build_model as j_build_model
from repro.models.config import ShapeSpec as JShapeSpec
from repro.models.transformer import cross_entropy as j_cross_entropy
from repro.optim import adamw as j_adamw
from repro.train.loop import make_train_step as j_make_train_step
from repro_torch.approx import ApproxConfig
from repro_torch.convert import params_from_jax, train_state_from_jax
from repro_torch.data.pipeline import DataConfig, SyntheticLM, data_config_for
from repro_torch.models import ShapeSpec, build_model, cross_entropy, reduced
from repro_torch.optim import adamw
from repro_torch.train import CheckpointManager, TrainConfig, make_train_step, run
from repro_torch.train.loop import batch_to, value_and_grad
from repro_torch.tree import leaves, leaves_with_path
from tests.test_archs import reduced as j_reduced

MODES = {  # name -> (mode, attn_table)
    "exact": ("exact", False),
    "table_ref": ("table_ref", False),
    "table_pallas": ("table_pallas", False),
    "table_pack": ("table_pack", False),
    "table_pack_attn": ("table_pack", True),
}


def pair(name: str, **cfg_kw):
    """(jax model, jax params, port model, port params) on the same weights,
    f32 compute."""
    mode, attn = MODES[name]
    kw = dict(compute_dtype="float32", **cfg_kw)
    jm = j_build_model(j_reduced("stablelm-3b").replace(
        approx=JApprox(mode=mode, e_a=1e-4, omega=0.2, attn_table=attn), **kw))
    tm = build_model(reduced("stablelm-3b").replace(
        approx=ApproxConfig(mode=mode, e_a=1e-4, omega=0.2, attn_table=attn), **kw),
        device="cpu")
    jp = jm.init(jax.random.key(0))
    return jm, jp, tm, params_from_jax(tm.cfg, jax.tree.map(np.asarray, jp), "cpu")


def np_batch(vocab, B=4, S=16, seed=0, ignore=False):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, vocab, (B, S)).astype(np.int32),
         "targets": rng.integers(0, vocab, (B, S)).astype(np.int32)}
    if ignore:
        b["targets"][:, :3] = -1
    return b


def rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def assert_grads_close(cfg, jgrads, tgrads, tol=1e-3):
    want = dict(leaves_with_path(params_from_jax(
        cfg, jax.tree.map(np.asarray, jgrads), "cpu")))
    got = dict(leaves_with_path(tgrads))
    assert want.keys() == got.keys()
    for k, w in want.items():
        assert torch.isfinite(got[k]).all(), k
        err = float(torch.linalg.vector_norm(got[k] - w))
        assert err <= tol * float(torch.linalg.vector_norm(w)) + 1e-12, (k, err)


# --------------------------------------------------------------------------------------
# data, shapes, optimizer
# --------------------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_batches_bit_for_bit(seed):
    j = JSyntheticLM(JDataConfig(vocab=128, global_batch=4, seq_len=16, seed=seed))
    t = SyntheticLM(DataConfig(vocab=128, global_batch=4, seq_len=16, seed=seed))
    for step in (0, 1, 7, 1000):
        a, b = j.batch_at(step), t.batch_at(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_shape_spec_and_data_config_match_reference():
    assert ([f.name for f in dataclasses.fields(ShapeSpec)]
            == [f.name for f in dataclasses.fields(JShapeSpec)])
    shape = ShapeSpec("cli", seq_len=16, global_batch=4, kind="train")
    assert dataclasses.asdict(shape) == dataclasses.asdict(
        JShapeSpec("cli", seq_len=16, global_batch=4, kind="train"))
    from repro.data.pipeline import data_config_for as j_data_config_for

    assert (dataclasses.asdict(data_config_for(reduced("stablelm-3b"), shape))
            == dataclasses.asdict(j_data_config_for(j_reduced("stablelm-3b"), shape)))


def _opt_tree(rng):
    return {"w": rng.normal(0, 1, (8, 4)).astype(np.float32),
            "b": rng.normal(0, 1, (4,)).astype(np.float32),
            "layers": {"g": rng.normal(0, 1, (3, 5, 2)).astype(np.float32)}}


@pytest.mark.parametrize("clip_norm", [1.0, 0.0])
def test_adamw_update_matches_reference(clip_norm):
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=6, clip_norm=clip_norm)
    jcfg, tcfg = j_adamw.AdamWConfig(**cfg), adamw.AdamWConfig(**cfg)
    rng = np.random.default_rng(0)
    p0 = _opt_tree(rng)
    jp, jst = jax.tree.map(jnp.asarray, p0), j_adamw.init(jax.tree.map(jnp.asarray, p0))
    tp = {k: (torch.tensor(v) if not isinstance(v, dict) else
              {kk: torch.tensor(vv) for kk, vv in v.items()}) for k, v in p0.items()}
    tst = adamw.init(tp)
    for _ in range(5):
        g = jax.tree.map(lambda a: (a * 3).astype(np.float32), _opt_tree(rng))
        jp, jst, jm = j_adamw.update(jcfg, jp, jax.tree.map(jnp.asarray, g), jst)
        tg = {k: (torch.tensor(v) if not isinstance(v, dict) else
                  {kk: torch.tensor(vv) for kk, vv in v.items()}) for k, v in g.items()}
        out_p, tst, tm = adamw.update(tcfg, tp, tg, tst)
        assert out_p is tp  # in place
        assert rel(tm["grad_norm"], jm["grad_norm"]) <= 1e-6
        assert rel(tm["lr"], jm["lr"]) <= 1e-6
        for a, b in zip(leaves(tp) + leaves(tst["m"]) + leaves(tst["v"]),
                        jax.tree.leaves(jp) + jax.tree.leaves(jst["m"])
                        + jax.tree.leaves(jst["v"])):
            b = np.asarray(b)
            assert np.linalg.norm(a.numpy() - b) <= 1e-6 * np.linalg.norm(b)
        assert int(tst["count"]) == int(jst["count"])


def test_schedule_matches_reference():
    for cfg in (dict(warmup_steps=10, total_steps=100), dict(warmup_steps=0, total_steps=5),
                dict(warmup_steps=3, total_steps=3, min_lr_ratio=0.0)):
        jc, tc = j_adamw.AdamWConfig(**cfg), adamw.AdamWConfig(**cfg)
        steps = np.arange(0, 120, 7, dtype=np.int32)
        want = np.asarray(j_adamw.schedule(jc, jnp.asarray(steps)))
        got = adamw.schedule(tc, torch.from_numpy(steps)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6)


# --------------------------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------------------------


class TestCheckpoint:
    def _tree(self):
        return {"params": {"w": torch.randn(3, 4), "h": torch.randn(2).to(torch.bfloat16),
                           "layers": [{"a": torch.randn(5)}, {"a": torch.randn(5)}]},
                "step": torch.tensor(7, dtype=torch.int32)}

    def test_round_trip_no_tmp(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        t = self._tree()
        mgr.save(7, t, extra={"loss": 1.5})
        assert [p.name for p in tmp_path.iterdir()] == ["step_0000000007"]
        back = mgr.restore(7, t)
        for (pa, a), (pb, b) in zip(leaves_with_path(t), leaves_with_path(back)):
            assert pa == pb and a.dtype == b.dtype and torch.equal(a, b)
        assert back["params"]["h"].dtype == torch.bfloat16  # stored as f32

    def test_keep_k_and_async(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep=2)
        t = self._tree()
        for s in (1, 2, 3, 4):
            mgr.save_async(s, t)
        mgr.wait()
        assert mgr.all_steps() == [3, 4] and mgr.latest_step() == 4
        assert not list(tmp_path.glob("*.tmp"))
        step, back = mgr.restore_latest(t)
        assert step == 4 and torch.equal(back["params"]["w"], t["params"]["w"])

    def test_missing_leaf_and_shape_mismatch_raise(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(1, {"x": torch.ones(2)})
        with pytest.raises(KeyError):
            mgr.restore(1, {"y": torch.ones(2)})
        with pytest.raises(ValueError, match="shape mismatch"):
            mgr.restore(1, {"x": torch.ones(3)})
        assert CheckpointManager(str(tmp_path / "empty")).restore_latest({}) == (None, None)


# --------------------------------------------------------------------------------------
# loss and gradients against jax.value_and_grad
# --------------------------------------------------------------------------------------


def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(1)
    logits = rng.normal(0, 3, (2, 5, 11)).astype(np.float32)
    logits[..., 9:] = -1e30  # padded vocab rows, as the model masks them
    targets = rng.integers(0, 9, (2, 5)).astype(np.int32)
    targets[0, :2] = -1
    want = float(j_cross_entropy(jnp.asarray(logits), jnp.asarray(targets)))
    got = float(cross_entropy(torch.from_numpy(logits), torch.from_numpy(targets).long()))
    assert rel(got, want) <= 1e-6
    assert float(cross_entropy(torch.from_numpy(logits),
                               torch.full((2, 5), -1))) == 0.0  # all ignored


@pytest.mark.parametrize("name", sorted(MODES))
def test_loss_and_grads_match_reference(name):
    jm, jp, tm, tp = pair(name)
    b = np_batch(tm.cfg.vocab, ignore=True)
    jl, jg = jax.jit(jax.value_and_grad(jm.loss))(
        jp, {k: jnp.asarray(v) for k, v in b.items()})
    tl, tg = value_and_grad(tm, tp, batch_to(b, "cpu"))
    assert rel(tl, jl) <= 1e-5, (float(tl), float(jl))
    assert_grads_close(tm.cfg, jg, tg)


@pytest.mark.parametrize("name", ["table_pallas", "table_pack_attn"])
def test_exact_grad_matches_reference(name):
    jm, jp, tm, tp = pair(name)
    jm = j_build_model(jm.cfg.replace(approx=dataclasses.replace(
        jm.cfg.approx, exact_grad=True)))
    tm = build_model(tm.cfg.replace(approx=dataclasses.replace(
        tm.cfg.approx, exact_grad=True)), device="cpu")
    b = np_batch(tm.cfg.vocab, seed=2)
    jl, jg = jax.jit(jax.value_and_grad(jm.loss))(
        jp, {k: jnp.asarray(v) for k, v in b.items()})
    tl, tg = value_and_grad(tm, tp, batch_to(b, "cpu"))
    assert rel(tl, jl) <= 1e-5
    assert_grads_close(tm.cfg, jg, tg)


def test_param_dtype_leaves_are_f32_as_in_reference():
    """The reference's ``init`` never reads ``param_dtype``: with
    ``"bfloat16"`` every leaf is still f32 on both sides, and the port's
    accumulated grads (scaled and summed in the leaves' dtype) are f32."""
    from repro_torch.train.loop import accumulated_grads

    jm = j_build_model(j_reduced("stablelm-3b").replace(param_dtype="bfloat16"))
    tm = build_model(reduced("stablelm-3b").replace(param_dtype="bfloat16"),
                     device="cpu")
    jp = jm.init(jax.random.key(0))
    tp = tm.init(torch.Generator().manual_seed(0))
    assert {np.asarray(a).dtype for a in jax.tree.leaves(jp)} == {np.dtype("float32")}
    assert {t.dtype for t in leaves(tp)} == {torch.float32}
    conv = params_from_jax(tm.cfg, jax.tree.map(np.asarray, jp), "cpu")
    assert [k for k, _ in leaves_with_path(tp)] == [k for k, _ in leaves_with_path(conv)]
    tp = conv
    loss, grads = accumulated_grads(tm, tp, batch_to(np_batch(tm.cfg.vocab), "cpu"), 2)
    assert loss.dtype == torch.float32 and torch.isfinite(loss)
    assert {g.dtype for g in leaves(grads)} == {torch.float32}


def test_remat_equals_no_remat():
    _, _, tm, tp = pair("table_pack_attn")
    rm = build_model(tm.cfg.replace(remat=True), device="cpu")
    b = batch_to(np_batch(tm.cfg.vocab, seed=4), "cpu")
    l0, g0 = value_and_grad(tm, tp, b)
    l1, g1 = value_and_grad(rm, tp, b)
    assert torch.equal(l0, l1)
    for a, c in zip(leaves(g0), leaves(g1)):
        assert torch.equal(a, c)


# --------------------------------------------------------------------------------------
# train step, accumulation, loop, CLI
# --------------------------------------------------------------------------------------


def test_four_steps_match_reference():
    jm, jp, tm, _ = pair("table_pack_attn")
    opt = dict(lr=1e-3, warmup_steps=1, total_steps=4)
    jstate = {"params": jp, "opt": j_adamw.init(jp), "step": jnp.zeros((), jnp.int32)}
    tstate = train_state_from_jax(tm.cfg, jax.tree.map(np.asarray, jstate), "cpu")
    jstep = jax.jit(j_make_train_step(jm, j_adamw.AdamWConfig(**opt), accum=2))
    tstep = make_train_step(tm, adamw.AdamWConfig(**opt), accum=2)
    data = SyntheticLM(DataConfig(vocab=tm.cfg.vocab, global_batch=4, seq_len=16))
    jl, tl = [], []
    for s in range(4):
        b = data.batch_at(s)
        jstate, jmet = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tmet = tstep(tstate, batch_to(b, "cpu"))
        jl.append(float(jmet["loss"]))
        tl.append(float(tmet["loss"]))
        assert rel(tmet["grad_norm"], jmet["grad_norm"]) <= 1e-3
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert int(tstate["step"]) == 4 and int(tstate["opt"]["count"]) == 4
    assert tl[-1] < tl[0]


def test_grad_accum_equivalence():
    """accum=2 matches accum=1 on the same global batch (up to fp)."""
    _, jp, tm, _ = pair("table_pack")
    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10, clip_norm=0.0)
    b = batch_to(np_batch(tm.cfg.vocab), "cpu")
    out = []
    for accum in (1, 2):
        state = train_state_from_jax(tm.cfg, jax.tree.map(np.asarray, {
            "params": jp, "opt": j_adamw.init(jp),
            "step": jnp.zeros((), jnp.int32)}), "cpu")
        out.append(make_train_step(tm, opt, accum=accum)(state, b))
    (s1, m1), (s2, m2) = out
    assert rel(m2["loss"], m1["loss"]) <= 1e-5
    for a, c in zip(leaves(s1["params"]), leaves(s2["params"])):
        np.testing.assert_allclose(a.detach().numpy(), c.detach().numpy(), atol=1e-5)


def test_run_restart_resumes_the_stream(tmp_path):
    model = build_model(reduced("stablelm-3b").replace(approx=ApproxConfig(
        mode="table_pack", e_a=1e-4, omega=0.2, attn_table=True)), device="cpu")
    shape = ShapeSpec("tiny", seq_len=16, global_batch=4, kind="train")
    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=6)
    quiet = lambda s: None
    straight = run(model, shape, TrainConfig(steps=5, ckpt_every=100, accum=2,
                                             ckpt_dir=str(tmp_path / "a"), opt=opt),
                   log=quiet)
    first = run(model, shape, TrainConfig(steps=3, ckpt_every=2, accum=2,
                                          ckpt_dir=str(tmp_path / "b"), opt=opt), log=quiet)
    logs = []
    second = run(model, shape, TrainConfig(steps=5, ckpt_every=2, accum=2,
                                           ckpt_dir=str(tmp_path / "b"), opt=opt),
                 log=logs.append)
    assert (straight["final_step"], first["final_step"], second["final_step"]) == (5, 3, 5)
    assert "restored checkpoint at step 3" in logs
    assert len(second["losses"]) == 2  # only the new steps ran
    assert first["losses"] + second["losses"] == straight["losses"]
    assert not list((tmp_path / "b").glob("*.tmp"))
    # over a mesh the port trains table_pack and the sharded modes (item 12b,
    # tests/test_torch_mesh.py); another mode is refused before anything runs
    table_ref = build_model(reduced("stablelm-3b"), device="cpu")
    assert table_ref.cfg.approx.mode == "table_ref"
    with pytest.raises(NotImplementedError, match="queue 1, item 12"):
        run(table_ref, shape, TrainConfig(steps=1, ckpt_dir=str(tmp_path / "c")),
            mesh=object(), log=quiet)


def test_cli_trains_on_cpu(tmp_path, capsys):
    from repro_torch.launch.train import main

    out = main(["--arch", "stablelm-3b", "--reduced", "--device", "cpu",
                "--steps", "4", "--batch", "4", "--seq", "16", "--accum", "2",
                "--approx-mode", "table_pack", "--ckpt-dir", str(tmp_path)])
    text = capsys.readouterr().out
    assert "done: step=4 loss" in text and "on cpu" in text
    assert out["losses"][-1] < out["losses"][0]
    assert all(np.isfinite(out["losses"]))
