"""The port's mesh path (``repro_torch.parallel``, ``launch.mesh``, the
sharded pack on a mesh, training with weight-update sharding and ZeRO-1)
against the JAX reference, on the CPU.

The reference's own mesh tests cannot run on this box (its sharded tests need
``with_sharding_constraint`` on Explicit axes), so the port is held to what
the reference defines and runs here:

* the spec functions (``param_pspecs``, ``zero1_pspecs``, ``fsdp_pspecs``,
  ``cache_pspecs``), pure Python over a duck-typed mesh as in the
  reference's ``tests/test_parallel.py``: equal, path by path, for all ten
  architectures on the (16, 16) and (2, 16, 16) meshes (the port's trees read
  in the reference's stacked layout, ``parallel.params.stacked_view``);
* the sharded pack on a mesh: on gloo ranks sharing one process group (a
  'model' axis 2 and 4 wide), each rank holds one slice and
  ``eval_sharded_mesh``'s value and slope are BITWISE the reference's eager
  ``eval_sharded_ref`` / ``eval_sharded_slope`` (the contract its docstring
  states: a psum of one owner value and S-1 zeros), for every member,
  extrapolation off and on, f32 and bf16;
* training: reduced stablelm (d_model 64, d_ff 128, 4 heads, the reference's
  PREAMBLE) on a (2, 2) mesh with the reference's weights: the sharded loss
  within 1e-3 of the reference's unsharded ``model.loss`` and the WUS step's
  loss within 0.05 of its unsharded step, its first parameter leaf within
  atol 5e-3 (the reference's own bounds, tests/test_parallel.py:72-75,127:
  the work copy computes in bf16);
* serving: the engines' ``mesh=`` places the pack, and a model built over
  the mesh serves the greedy tokens it serves off the mesh;
* a checkpoint saved on (2, 2) restores bitwise onto (4, 1) and off the mesh,
  and only rank 0 writes;
* the launcher's ``--mesh debug`` run alone (a 1 x 1 gloo mesh), and the
  mesh constructors over the pool's world (the production meshes' errors name
  the world they need);
* ``host_shard`` and ``compress_grads_bf16`` equal the reference's.

Every multi-rank case runs on ONE module-scoped pool of 4 gloo ranks
(``tests/harness/mesh_pool.py``; rendezvous through a file in a temporary
directory).  The reference's oracles run here, in the test process.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

from harness.mesh_pool import Pool
from repro.approx import table_pack as tp_ref
from repro.core import packing as j_packing
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models import build_model as j_build_model
from repro.models import get_config as j_get_config
from repro.optim import adamw as j_adamw
from repro.parallel import cache_specs as j_cache_specs
from repro.parallel import params as j_params
from repro.parallel import sharding as j_sharding
from repro.train.loop import make_train_step as j_make_train_step
from repro_torch.approx import table_pack
from repro_torch.convert import params_from_jax
from repro_torch.core import packing
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models import build_model, get_config, reduced
from repro_torch.models.registry import ARCH_IDS
from repro_torch.optim import adamw
from repro_torch.parallel import cache_specs, params, sharding
from repro_torch.train import loop
from repro_torch.tree import leaves_with_path, subtree
from tests.test_archs import make_batch
from tests.test_archs import reduced as j_reduced
from tests.test_torch_pack import assert_bitwise, inputs

NAMES = ("gelu", "silu", "tanh", "sigmoid_sym", "softplus", "exp_neg")
GRAD_RTOL = 5e-2  # the bf16 work copy's grads against f32 (2% seen)
EA, OMEGA = 1e-4, 0.2  # stablelm-3b's approx settings


class FakeMesh:
    """The reference tests' duck-typed mesh: axis names and a devices array."""

    def __init__(self, names, shape):
        self.axis_names = names
        self.devices = np.empty(shape)


MESHES = {"16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16))}


def _ref_specs(tree, path_str):
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
    return {path_str(p): tuple(s) for p, s in leaves}


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = Pool(4, str(tmp_path_factory.mktemp("mesh_store") / "store"))
    yield p
    p.close()


# --------------------------------------------------------------------------------------
# (a) the spec functions, path by path
# --------------------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_equal_reference(arch):
    jm = j_build_model(j_get_config(arch))
    abstract = jm.abstract_params()
    tm = build_model(get_config(arch), "cpu")
    meta = tm.abstract_params()
    assert {t.device.type for _, t in leaves_with_path(meta)} == {"meta"}
    for names, shape in MESHES.values():
        mesh = FakeMesh(names, shape)
        for name in ("param_pspecs", "zero1_pspecs", "fsdp_pspecs"):
            want = _ref_specs(getattr(j_params, name)(abstract, mesh), j_params._path_str)
            got = {k: tuple(v) for k, v in
                   params._flat(getattr(params, name)(meta, mesh)).items()}
            assert got == want, (arch, names, name)
        want = _ref_specs(j_cache_specs.cache_pspecs(jm.abstract_cache(128, 1024), mesh),
                          j_cache_specs._path_str)
        got = {cache_specs.path_str(k): tuple(v) for k, v in cache_specs.cache_pspecs(
            tm.init_cache(128, 1024, device="meta"), mesh).items()}
        assert got == want, (arch, names, "cache_pspecs")


def test_port_specs_map_onto_per_layer_tensors():
    """A stacked spec on the port's per-layer tensors: the prefix dropped, a
    layer axis ZeRO-1 shards moved onto the leaf's first free dim, and wo's
    heads on its group dim; every sharded dim divides."""
    tm = build_model(get_config("stablelm-3b"), "cpu")
    meta = tm.abstract_params()
    mesh = FakeMesh(("data", "model"), (16, 16))
    z = params.port_specs(params.zero1_pspecs(meta, mesh), meta, mesh)
    lp = z["layers"][0]
    # reference: wq (L, d, h, D) ('data', None, 'model', None): the layer
    # axis goes to d; wo (L, h, D, d) ('data', 'model', None, None): heads on
    # the port's (g, q_per_group=1, D=80, d) group dim, the layer axis on D
    assert tuple(lp["attn"]["wq"]["w"]) == ("data", "model", None)
    assert tuple(lp["attn"]["wo"]["w"]) == ("model", None, "data", None)
    assert tuple(params.port_specs(params.param_pspecs(meta, mesh), meta, mesh)
                 ["layers"][3]["mlp"]["wd"]["w"]) == ("model", None)
    sizes = {"data": 16, "model": 16}
    for path, t in leaves_with_path(meta):
        spec = subtree(z, path)
        assert len(spec) == t.dim()
        for dim, ax in zip(t.shape, spec):
            if ax is not None:
                n = int(np.prod([sizes[a] for a in (ax if isinstance(ax, tuple) else (ax,))]))
                assert dim % n == 0, (path, t.shape, spec)


def test_rules_and_placements():
    from torch.distributed.tensor import Replicate, Shard

    mesh = FakeMesh(("pod", "data", "model"), (2, 16, 16))
    assert sharding.default_rules(mesh) == j_sharding.default_rules(mesh)
    with sharding.use_sharding(mesh), j_sharding.use_sharding(mesh):
        for logical in (("batch", None, "vocab"), ("expert", "ff"), (None, "heads")):
            assert tuple(sharding.logical_to_spec(*logical)) == tuple(
                j_sharding.logical_to_spec(*logical))
        assert sharding.current_mesh() is mesh
    assert sharding.current_mesh() is None
    pl = sharding.to_placements(sharding.P(("pod", "data"), None, "model"), mesh)
    assert pl == [Shard(0), Shard(0), Shard(2)]
    assert sharding.to_placements(sharding.P(), mesh) == [Replicate()] * 3
    with pytest.raises(ValueError, match="order"):
        sharding.to_placements(sharding.P(("model", "data")), mesh)
    assert tuple(sharding.P(("data",), None)) == ("data", None)
    x = torch.ones(2)
    assert sharding.shard_activation(x, "batch") is x  # off a binding


def test_sharded_pack_pspecs_match_reference():
    for names, shape in MESHES.values():
        mesh = FakeMesh(names, shape)
        want = {k: tuple(v) for k, v in j_sharding.sharded_pack_pspecs(mesh).items()}
        assert {k: tuple(v) for k, v in sharding.sharded_pack_pspecs(mesh).items()} == want


def test_mesh_training_scope_is_refused_beyond_this_slice():
    for arch, mode in (("stablelm-3b", "quant_pack"), ("zamba2-1.2b", "table_pack")):
        cfg = reduced(arch)
        cfg = cfg.replace(approx=dataclasses.replace(cfg.approx, mode=mode))
        with pytest.raises(NotImplementedError, match="item 12c"):
            loop.check_mesh_training(build_model(cfg, "cpu"))


# --------------------------------------------------------------------------------------
# (b) the sharded pack on the mesh, bitwise
# --------------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def layouts():
    from repro.core.flow import cached_table as j_cached
    from repro_torch.core.flow import cached_table

    j = j_packing.pack_layout([j_cached(n, EA, omega=OMEGA) for n in NAMES])
    t = packing.pack_layout([cached_table(n, EA, omega=OMEGA) for n in NAMES])
    return j, t


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)], ids=["model2", "model4"])
def test_pack_on_mesh_bitwise_reference(shape, layouts, pool):
    j, t = layouts
    S = shape[1]
    jp = tp_ref.from_sharded_layout(j_packing.shard_pack_layout(j, S))
    tp = table_pack.from_sharded_layout(packing.shard_pack_layout(t, S), "cpu")
    xs = {}
    for fid, name in enumerate(NAMES):
        lo, hi = tp.domains[fid]
        x = inputs(lo, hi, tp.boundaries[fid, : tp.n_intervals[fid] + 1].numpy(), seed=fid)
        xs[name] = x[np.isfinite(x)]  # normal inputs and the edges
    res = pool.run("pack_on_mesh", shape=shape, e_a=EA, omega=OMEGA, xs=xs)
    m = tp.footprint_per_shard
    for rank, r in enumerate(res):
        # one slice a rank: its shard is its 'model' coordinate
        assert r["shard"] == rank % S == r["first_shard"]
        assert r["whole_values"] == (S, m)
        assert r["held"]["values"] == (1, m)
        assert r["held"]["local_base"] == r["held"]["owned"] == (1,) + tuple(tp.owner.shape)
        assert r["image"] is None and r["owner_set"] == [-1.0, 0.0]
        # closures built under the mesh's binding take the placed pack; off
        # it the config serves the whole one
        assert r["bound_is_placed"] and r["off_is_whole"]
        # every evaluation took the rank's own shard's contribution
        assert r["calls"] == [r["shard"]] and r["n_calls"] > 0
    for name, x in xs.items():
        for jdt, tdt in ((jnp.float32, "torch.float32"), (jnp.bfloat16, "torch.bfloat16")):
            xj = jnp.asarray(x).astype(jdt)
            for ex in (False, True):
                want = (np.asarray(tp_ref.eval_sharded_ref(jp, name, xj, extrapolate=ex)
                                   .astype(jnp.float32)),
                        np.asarray(tp_ref.eval_sharded_slope(jp, name, xj, extrapolate=ex)
                                   .astype(jnp.float32)))
                for r in res:
                    assert_bitwise(r["out"][name, tdt, ex, False], want[0])
                    assert_bitwise(r["out"][name, tdt, ex, True], want[1])
        n = len(x) // shape[0] * shape[0]
        want = np.asarray(tp_ref.eval_sharded_ref(jp, name, jnp.asarray(x[:n])))
        for r in res:
            assert_bitwise(r["out"][name, "dtensor"], want)
    xj = jnp.asarray(xs["silu"])
    for r in res:  # silu extrapolates; its gradient is the slope
        assert_bitwise(r["out"]["closure"][0],
                       np.asarray(tp_ref.eval_sharded_ref(jp, "silu", xj, extrapolate=True)))
        assert_bitwise(r["out"]["closure"][1],
                       np.asarray(tp_ref.eval_sharded_slope(jp, "silu", xj, extrapolate=True)))


# --------------------------------------------------------------------------------------
# (c) training on a (2, 2) mesh against the reference's unsharded step
# --------------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def reference_step():
    """The reference's reduced stablelm (its PREAMBLE's config, in
    ``table_pack_ref``: the same pack values as the port's three mesh modes),
    its loss and one unsharded step, eagerly."""
    jcfg = j_reduced("stablelm-3b").replace(d_model=64, d_ff=128, n_heads=4, n_kv_heads=4)
    jcfg = jcfg.replace(approx=dataclasses.replace(jcfg.approx, mode="table_pack_ref"))
    jm = j_build_model(jcfg)
    batch = make_batch(jcfg, B=8, S=16)
    jparams = jm.init(jax.random.key(0))
    opt = j_adamw.AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10, clip_norm=0.0)
    state = {"params": jparams, "opt": j_adamw.init(jparams),
             "step": jnp.zeros((), jnp.int32)}
    new_state, metrics = jax.jit(j_make_train_step(jm, opt))(state, batch)
    tcfg = reduced("stablelm-3b").replace(d_model=64, d_ff=128, n_heads=4, n_kv_heads=4)
    port_params = params_from_jax(tcfg, jax.tree.map(np.asarray, jparams), "cpu")
    return {"loss": float(jax.jit(jm.loss)(jparams, batch)),
            "step_loss": float(metrics["loss"]),
            "first": np.asarray(jax.tree.leaves(new_state["params"])[0]),
            "params": jax.tree.map(lambda t: t.numpy(), port_params,
                                   is_leaf=lambda t: isinstance(t, torch.Tensor)),
            "batch": {k: np.asarray(v) for k, v in batch.items()}}


MESH_MODES = ["sharded_pack", "table_pack", "sharded_pack_ref"]


@pytest.mark.parametrize("mode", MESH_MODES)
def test_training_on_mesh_matches_reference(mode, reference_step, pool):
    ref = reference_step
    res = _train_on_mesh(mode, 1, ref, pool)
    for r in res:
        assert abs(r["step_loss"] - ref["step_loss"]) < 0.05  # bf16 work copy
        np.testing.assert_allclose(r["first"], ref["first"], atol=5e-3)


@pytest.mark.parametrize("mode", MESH_MODES)
def test_training_on_mesh_accumulates_as_unmeshed(mode, reference_step, pool):
    """Two micro-batches: each one's grads resharded into the master layout
    and added there, against the port's unmeshed accumulation."""
    _train_on_mesh(mode, 2, reference_step, pool)


def _train_on_mesh(mode, accum, ref, pool):
    """One WUS step on a (2, 2) mesh against the reference's loss and the
    port's unmeshed step; every rank's result."""
    res = pool.run("train_on_mesh", shape=(2, 2), mode=mode, shards=2,
                   params=ref["params"], batch=ref["batch"], lr=1e-3, accum=accum)
    for r in res:
        assert abs(r["loss"] - ref["loss"]) < 1e-3  # sharded reductions reorder sums
        # the f32 master is spread over the whole mesh (ZeRO-1): embed/table
        # (V, d) is ('model', 'data')
        assert r["layout"][0] == ("S1", "S0")
        assert r["master_local"] == (ref["first"].shape[0] // 2, ref["first"].shape[1] // 2)
        if mode.startswith("sharded_pack"):
            # the gate ran on the mesh: each rank's own shard, never the
            # off-mesh sum
            assert r["counts"]["mesh"] > 0 and r["counts"]["off"] == 0
        else:
            assert r["counts"] == {"mesh": 0, "off": 0}
        # the step against the port's unmeshed step (f32, off the mesh) on
        # the same weights and batch.  The grads: within the bf16 work copy's
        # error (2% seen), so a zero, sign-flipped, misplaced or scaled
        # gradient fails.  The master's change: bitwise AdamW applied off
        # the mesh to the step's own grads (the update on local shards), and
        # within 1e-4 of the unmeshed step's change (lr is 1e-3; Adam's first
        # step moves an element by lr * g / (|g| + eps) plus the decay, so
        # it may differ only where the two grads differ in sign or one lies
        # within 100 eps of 0)
        assert abs(r["step_loss"] - r["off_step_loss"]) < 0.05  # bf16 work copy
        assert abs(r["grad_norm"] / r["off_grad_norm"] - 1) < GRAD_RTOL
        for g, og, d, own, od in zip(r["grads"], r["off_grads"], r["delta"], r["own_delta"],
                                     r["off_delta"]):
            assert g.shape == og.shape == d.shape == od.shape
            assert np.linalg.norm(g - og) <= GRAD_RTOL * np.linalg.norm(og)
            assert_bitwise(d, own)
            free = (np.sign(g) != np.sign(og)) | (np.minimum(abs(g), abs(og)) < 1e-6)
            np.testing.assert_allclose(d[~free], od[~free], rtol=0, atol=1e-4)
            assert (np.abs(d - od) > 1e-4).mean() < 0.02  # where bf16 flips a sign
    assert len({r["step_loss"] for r in res}) == 1  # every rank, one loss
    return res


def test_engine_serves_on_mesh_as_off(reference_step, pool):
    """The engines' ``mesh=`` places the pack; a model built over the mesh
    serves the same greedy tokens as off it, its gate on the mesh."""
    res = pool.run("serve_on_mesh", params=reference_step["params"])
    for rank, r in enumerate(res):
        assert r["placed"] and r["on"] == r["off"]
        assert r["calls"] == [rank % 2] and r["n_calls"] > 0


# --------------------------------------------------------------------------------------
# (d) checkpoints across meshes
# --------------------------------------------------------------------------------------


def test_checkpoint_restores_across_meshes(reference_step, pool, tmp_path):
    res = pool.run("checkpoint_across_meshes", root=str(tmp_path),
                   params=reference_step["params"])
    for r in res:
        assert r["written"][0] == ["step_0000000003"]
        assert all(r["written"][k] == [] for k in (1, 2, 3))  # rank 0 alone writes
        assert r["steps"] == (3, 3)
        assert r["bitwise_41"] and r["bitwise_off"]
        # on (4, 1) the master of embed/table (V, d) is ('model', 'data') as
        # on (2, 2): its d split 4 ways, V over the 1-wide 'model' axis
        assert r["layouts41"][0] == ("S1", "S0")


@pytest.mark.parametrize("how", ["raise", "signal"])
def test_ranks_stop_together(how, pool, tmp_path):
    """One rank of a (2, 2) run fails to make its batch at step 1, or is
    signalled there: every rank stops at that step boundary, promptly, and
    the checkpoint (a gather, so a collective) is saved by all of them
    together: the emergency one, or the final one of a preemption."""
    res = pool.run("fault_on_one_rank", root=str(tmp_path), how=how, timeout=120.0)
    for rank, r in enumerate(res):
        assert r["seconds"] < 60
        assert r["ckpts"] == ["step_0000000001"]
        if how == "signal":
            assert r["out"] == {"final_step": 1, "preempted": True}
        elif rank == 1:
            assert r["raised"] == "ValueError: injected batch fault"
        else:
            assert r["raised"] == "PeerFailed: another rank failed before step 1"


# --------------------------------------------------------------------------------------
# the launcher and the meshes
# --------------------------------------------------------------------------------------


def test_train_cli_mesh_debug_alone(tmp_path, capsys, monkeypatch):
    """``--mesh debug`` run alone: a 1 x 1 gloo mesh (the reference's
    launcher on one device), sharded_pack at 1 shard placed on it."""
    import torch.distributed as dist

    from repro_torch.kernels import table_pack_lookup as K
    from repro_torch.launch import train

    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    calls = []
    contrib = K.sharded_shard_contrib_plain
    monkeypatch.setattr(K, "sharded_shard_contrib_plain",
                        lambda *a, **k: calls.append(a[2]) or contrib(*a, **k))
    assert not dist.is_initialized()
    try:
        out = train.main(["--arch", "stablelm-3b", "--reduced", "--device", "cpu",
                          "--mesh", "debug", "--steps", "2", "--batch", "4", "--seq",
                          "8", "--approx-mode", "sharded_pack_ref", "--pack-shards", "1",
                          "--ckpt-dir", str(tmp_path / "ck")])
        assert dist.get_world_size() == 1
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert "done: step=2 loss" in capsys.readouterr().out
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    assert calls and set(calls) == {0}  # the gate on the mesh, its one shard
    assert os.listdir(tmp_path / "ck")


def test_train_cli_help_names_torchrun(capsys):
    from repro_torch.launch import train

    with pytest.raises(SystemExit) as e:
        train.main(["--help"])
    out = capsys.readouterr().out
    assert e.value.code == 0 and "torchrun" in out and "--mesh" in out


def test_mesh_constructors(pool):
    res = pool.run("mesh_constructors")
    for r in res:
        assert r["debug"] == ((2, 2), ("data", "model"))
        assert r["pack"] == ((1, 4), ("data", "model"))
        assert "256" in r["prod_error"] and "512" in r["multipod_error"]


# --------------------------------------------------------------------------------------
# (e) data and optimizer helpers
# --------------------------------------------------------------------------------------


def test_host_shard_matches_reference():
    cfg = dict(vocab=97, global_batch=8, seq_len=5, seed=3)
    t, j = SyntheticLM(DataConfig(**cfg)), JSyntheticLM(JDataConfig(**cfg))
    batch = t.batch_at(7)
    for n_hosts in (1, 2, 4, 8):
        for h in range(n_hosts):
            got, want = t.host_shard(batch, h, n_hosts), j.host_shard(j.batch_at(7), h,
                                                                      n_hosts)
            assert sorted(got) == sorted(want)
            for k in got:
                np.testing.assert_array_equal(got[k], np.asarray(want[k]))


def test_compress_grads_bf16_matches_reference():
    rng = np.random.default_rng(0)
    tree = {"a": rng.normal(size=(3, 5)).astype(np.float32),
            "b": [rng.normal(size=7).astype(np.float32) * 1e3]}
    got = adamw.compress_grads_bf16({"a": torch.from_numpy(tree["a"]),
                                     "b": [torch.from_numpy(tree["b"][0])]})
    want = j_adamw.compress_grads_bf16({"a": jnp.asarray(tree["a"]),
                                        "b": [jnp.asarray(tree["b"][0])]})
    assert got["a"].dtype == torch.bfloat16
    assert_bitwise(got["a"].float().numpy(), np.asarray(want["a"].astype(jnp.float32)))
    assert_bitwise(got["b"][0].float().numpy(),
                   np.asarray(want["b"][0].astype(jnp.float32)))
