"""The MoE family on a mesh (expert parallelism, ``models.mlp.moe_on_mesh``)
against the JAX reference's MoE and the port's unmeshed one, on the CPU.

The reference runs ``moe`` under pjit with a global view: the capacity counts
the whole batch's tokens, the dropped slots follow one stable sort of every
slot by expert, and the aux loss takes global means.  The port runs the block
on each rank's shards and keeps that view:

* one MoE block (reduced deepseek-moe-16b's, with shared experts, and
  qwen3-moe-235b-a22b's, without; E 4, k 2) forward and backward on the
  (2, 2) ('data', 'model'), (1, 4) and (2, 1, 2) ('pod', 'data', 'model')
  meshes, at the default capacity factor, at 0.5 (slots drop) and with
  device-limited routing (2 groups, 1 allowed), in f32 and bf16: every
  slot's ``dest`` equal to the unmeshed dispatch's and to the reference's
  dispatch lines exactly, the aux loss within 1e-6 relative, the output and
  grads within 1e-5 (f32) or the bf16 tolerance of tests/test_torch_mesh.py
  (bf16) of the unmeshed block's; each rank holding E / n_expert_ranks
  experts and computing ceil(C / n_rows) rows of each, n_rows being the
  batch ranks that hold one expert (the 'data' axis: 'pod' carries experts
  too), and no all-gather producing a stack of expert matrices;
* reduced deepseek's WUS step on (2, 2) in every mode that trains on a mesh,
  at accum 1 and 2, against the reference's step and the port's unmeshed
  one (the gates of tests/test_torch_mesh.py);
* prefill and decode over DTensor params and caches against the reference's
  logits, with its greedy tokens, for both architectures;
* the dry run's collectives of a decode step and a training step traced on a
  fake (2, 2) world equal ``CommDebugMode``'s over the real steps on the
  pool's four gloo ranks.

The multi-rank cases run on this module's own pool of 4 gloo ranks
(``tests/harness/mesh_pool.py``).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harness.mesh_pool import Pool
from repro.models.mlp import moe as j_moe
from repro_torch.models import build_model, reduced
from tests.test_torch_mesh import (GRAD_RTOL, MESH_MODES, REF_MODE, _reference_step,
                                   _serve_against_reference, _train_on_mesh)
from tests.test_torch_moe import as_jax, j_dispatch, j_route, np_moe_params

MOE_ARCHS = ("deepseek-moe-16b", "qwen3-moe-235b-a22b")
MOE_MESHES = {"2x2": (2, 2), "1x4": (1, 4), "2x1x2": (2, 1, 2)}
ROUTINGS = {"cf1.25": (1.25, 0, 0), "cf0.5": (0.5, 0, 0), "limit": (1.25, 2, 1)}
DTYPES = ("float32", "bfloat16")
B, S = 4, 8


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = Pool(4, str(tmp_path_factory.mktemp("moe_mesh_store") / "store"))
    yield p
    p.close()


def _layer_inputs(arch):
    cfg = reduced(arch)
    rng = np.random.default_rng(11)
    params = np_moe_params(rng, cfg.d_model, cfg.d_ff, cfg.moe.n_experts, cfg.moe.n_shared)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    r = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    return cfg, params, x, r


@pytest.fixture(scope="module")
def layer_runs(pool):
    """Each (mesh, arch)'s pool run of every routing and dtype, made once."""
    made = {}

    def get(mesh, arch):
        if (mesh, arch) not in made:
            _, params, x, r = _layer_inputs(arch)
            cases = [(dt, *ROUTINGS[k]) for k in ROUTINGS for dt in DTYPES]
            res = pool.run("moe_layer_on_mesh", shape=MOE_MESHES[mesh], params=params,
                           x=x, r=r, cases=cases)
            made[mesh, arch] = {(k, dt): [rk[i] for rk in res] for i, (k, dt) in
                                enumerate((k, dt) for k in ROUTINGS for dt in DTYPES)}
        return made[mesh, arch]

    return get


def _close(got, want, rtol):
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    assert np.linalg.norm(got - want) <= rtol * np.linalg.norm(want), (
        np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("routing", list(ROUTINGS))
@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("mesh", list(MOE_MESHES))
def test_moe_layer_on_mesh_matches_unmeshed(mesh, arch, routing, layer_runs):
    shape = MOE_MESHES[mesh]
    names = ("pod", "data", "model")[-len(shape):]
    cfg, params, x, _ = _layer_inputs(arch)
    E, k, d, f = cfg.moe.n_experts, cfg.moe.top_k, cfg.d_model, cfg.d_ff
    cf, groups, best = ROUTINGS[routing]
    # the batch over ('pod', 'data'), the experts over ('pod', 'model')
    batch_dims = [i for i, n in enumerate(names) if n in ("pod", "data")]
    n_expert = int(np.prod([s for s, n in zip(shape, names) if n in ("pod", "model")]))
    n_rows = dict(zip(names, shape))["data"]  # batch ranks that hold one expert
    n_chunks = int(np.prod([shape[i] for i in batch_dims]))
    T = B * S
    # the reference's routing and dispatch lines on the same tokens
    xt = jnp.asarray(x.reshape(T, d))
    _, _, jeidx = j_route(jnp.asarray(params["router"]["w"]), xt, k, groups, best)
    for dt in DTYPES:
        runs = layer_runs(mesh, arch)[routing, dt]
        C = runs[0]["capacity"]
        assert C == int(cf * T * k / E) + 1  # the GLOBAL token count
        if dt == "float32":
            order, dest = (np.asarray(a) for a in j_dispatch(jeidx, E, C)[:2])
            want = np.empty_like(dest)
            want[order] = dest
            want = want.reshape(T, k)
            np.testing.assert_array_equal(runs[0]["dest"], want)
            if routing == "cf0.5":
                assert (want == E * C).sum() > 0  # slots really drop
            y, aux = j_moe(as_jax(params), jnp.asarray(x), jax_silu, top_k=k,
                           capacity_factor=cf, device_groups=groups, max_groups=best)
            np.testing.assert_allclose(runs[0]["y"], np.asarray(y), rtol=0, atol=1e-4)
            assert abs(runs[0]["aux"] - float(aux)) < 1e-6
        tol = 1e-5 if dt == "float32" else GRAD_RTOL
        for rank, r in enumerate(runs):
            coords = np.unravel_index(rank, shape)
            chunk = int(np.ravel_multi_index([coords[i] for i in batch_dims],
                                             [shape[i] for i in batch_dims]))
            rows = slice(chunk * T // n_chunks, (chunk + 1) * T // n_chunks)
            # the global capacity and drop order, slot for slot
            np.testing.assert_array_equal(r["mesh_dest"], r["dest"][rows])
            assert abs(r["mesh_aux"] / r["aux"] - 1) <= 1e-6
            _close(r["mesh_y"], r["y"], tol)
            assert len(r["mesh_grads"]) == len(r["grads"])
            for g, og in zip(r["mesh_grads"], r["grads"]):
                _close(g, og, tol)
            # E / n_expert_ranks experts a rank; ceil(C / n_rows) rows of each
            assert r["experts_local"] == {"wi": (E // n_expert, d, f),
                                          "wu": (E // n_expert, d, f),
                                          "wd": (E // n_expert, f, d)}
            assert r["gate_local"] == (1, E // n_expert, -(-C // n_rows), f)
            # no rank gathers expert matrices
            assert not [s for s in r["gathered"] if len(s) == 3 and s[1:] in ((d, f), (f, d))]


def jax_silu(v):
    import jax

    return jax.nn.silu(v)


# --------------------------------------------------------------------------------------
# training, serving and the dry run's collectives on (2, 2)
# --------------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def moe_reference_steps():
    """The reference's reduced MoE step of a port mode, made once a module:
    computing in f32 from weights rounded to bf16 values (``f32`` True, the
    training steps), or as configured (bf16 compute; serving, which
    ``_serve_against_reference`` runs in f32 itself)."""
    made = {}

    def get(mode, arch="deepseek-moe-16b", f32=False):
        ref_mode = REF_MODE.get(mode, "table_pack_ref")
        if (ref_mode, arch, f32) not in made:
            made[ref_mode, arch, f32] = _reference_step(ref_mode, arch,
                                                        "float32" if f32 else None)
        return made[ref_mode, arch, f32]

    return get


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("mode", MESH_MODES)
def test_moe_training_on_mesh_matches_reference(mode, accum, moe_reference_steps, pool):
    """Reduced deepseek's WUS step on (2, 2): the loss within 1e-3 of the
    reference's, the step's within 0.05 of its step's, the grads within
    GRAD_RTOL of the port's unmeshed step's and the master's change bitwise
    AdamW on the step's own grads (``_train_on_mesh``).  The batch enters
    replicated and each micro-batch is the reference's rows [a*b, (a+1)*b).

    Both compute in f32 from weights that are bf16 values (the work copy
    holds them exactly), as the serving tests compute in f32: the routing
    is a discontinuity, and in bf16 the mesh's other summation order moved
    one near-tie token of layer 1 to another expert in exact mode, its
    experts' grads then 7-9% from the unmeshed step's."""
    ref = moe_reference_steps(mode, f32=True)
    res = _train_on_mesh(mode, accum, ref, pool, arch="deepseek-moe-16b")
    for r in res:
        assert abs(r["step_loss"] - ref["step_loss"]) < 0.05
        np.testing.assert_allclose(r["first"], ref["first"], atol=5e-3)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_prefill_and_decode_over_dtensors_match_reference(arch, moe_reference_steps,
                                                              pool):
    _serve_against_reference(moe_reference_steps("table_pack", arch), pool, arch=arch)


@pytest.mark.parametrize("kind", ["decode", "train"])
def test_moe_dryrun_collectives_equal_real_step(kind, moe_reference_steps, pool):
    """The dry run's collectives (counts and bytes) of reduced deepseek's
    decode step and training step traced on a fake (2, 2) world equal
    ``CommDebugMode``'s over the same steps on the pool: the counts'
    all-gather, the buffer's reduce-scatter and the rows' all-gather are
    among them."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import init_fake_process_group
    from repro_torch.models import ShapeSpec

    arch = "deepseek-moe-16b"
    ref = moe_reference_steps("table_pack", arch)
    rng = np.random.default_rng(7)
    if kind == "decode":
        Bd, T = 4, 16
        batch = {"tok": rng.integers(0, 128, (Bd, 1)).astype(np.int32), "pos": np.int32(5)}
        shape = ShapeSpec("decode", T, Bd, "decode")
    else:
        Bd, T = 4, 8
        batch = {"tokens": rng.integers(0, 128, (Bd, T)).astype(np.int32),
                 "targets": rng.integers(0, 128, (Bd, T)).astype(np.int32)}
        shape = ShapeSpec("train", T, Bd, "train")
    real = pool.run("step_collectives", params=ref["params"], batch=batch, cache_len=T,
                    arch=arch)
    cfg = reduced(arch)
    model = build_model(cfg.replace(approx=dataclasses.replace(cfg.approx, mode="table_pack")),
                        "cpu")
    init_fake_process_group(4)
    try:
        mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                          mesh_dim_names=("data", "model"))
        rec = dryrun.trace_on_mesh(model, shape, mesh, accum=1)
    finally:
        dist.destroy_process_group()
    counts = rec["collectives"]["counts"]
    assert counts["reduce-scatter"] >= cfg.n_layers and counts["all-gather"] >= 2 * cfg.n_layers
    for r in real:
        assert r == rec["collectives"]


def test_moe_train_cli_mesh_debug_alone(tmp_path, capsys, monkeypatch):
    """``launch/train.py --arch deepseek-moe-16b --reduced --mesh debug`` run
    alone: a 1 x 1 gloo mesh, two steps through the MoE block on the mesh
    (its dispatch takes the chunk offset), finite losses, a checkpoint."""
    import torch.distributed as dist

    from repro_torch.launch import train
    from repro_torch.models import mlp

    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    offsets = []
    dispatch = mlp.moe_dispatch
    monkeypatch.setattr(mlp, "moe_dispatch", lambda e, n, c, offset=None: offsets.append(
        offset is not None) or dispatch(e, n, c, offset))
    assert not dist.is_initialized()
    try:
        out = train.main(["--arch", "deepseek-moe-16b", "--reduced", "--device", "cpu",
                          "--mesh", "debug", "--steps", "2", "--batch", "4", "--seq", "8",
                          "--approx-mode", "table_pack", "--ckpt-dir", str(tmp_path / "ck")])
        assert dist.get_world_size() == 1
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert "done: step=2 loss" in capsys.readouterr().out
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    assert offsets and all(offsets)  # every layer's dispatch ran on the mesh
    assert (tmp_path / "ck").is_dir()
