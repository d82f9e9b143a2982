"""The port's dry run (``repro_torch.launch.dryrun``), the shape registry and
``input_specs`` / ``abstract_cache`` it reads, and the H100 cost model and
roofline (``repro_torch.analysis``) against the JAX reference, on the CPU.

* the shape registry and ``input_specs`` equal the reference's for all ten
  architectures, and ``abstract_cache`` equals its leaf by leaf;
* the per-device argument bytes of every dense cell on both production
  meshes, in the variants base, fsdp, ddp, accum4, no_remat and exact: the
  port's arguments placed by the dry run (on ``meta``, over a fake world of
  256 or 512 ranks) equal what the reference's own spec functions
  (``param_pspecs``, ``zero1_pspecs``, ``fsdp_pspecs``, ``cache_pspecs``)
  and ``input_specs`` give, reckoned here by arithmetic; among them
  5,720,052,772 B for stablelm-3b|decode_32k|16x16|base, the reference's
  recorded ``argument_size_in_bytes``;
* ``cell_costs`` equal to the reference's ``benchmarks.cost_model`` term for
  term (imported read-only, as tests/test_dryrun_tools.py does), and the
  reference's own invariants on the port's model and roofline;
* the collective-bytes convention on a fake world of 4;
* the trace against a real run: reduced stablelm on a gloo world of one,
  the dry run's FLOPs and peak (traced whole, and carried from depths 1
  and 2) equal ``FlopCounterMode`` and ``MemTracker`` over the real step;
* the CLI: one full-width cell written to ``--out``, a cell of another
  family recorded ``not_ported``, nothing written under ``benchmarks/``.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec

from benchmarks import cost_model as j_cost_model
from repro.models import ALL_SHAPES as J_ALL_SHAPES
from repro.models import SHAPES_BY_NAME as J_SHAPES_BY_NAME
from repro.models import build_model as j_build_model
from repro.models import get_config as j_get_config
from repro.models import input_specs as j_input_specs
from repro.models import shapes_for as j_shapes_for
from repro.models.config import LONG_CONTEXT_ARCHS as J_LONG_CONTEXT_ARCHS
from repro.parallel import cache_specs as j_cache_specs
from repro.parallel import params as j_params
from repro.parallel import sharding as j_sharding
from repro_torch.analysis import cost_model, roofline
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import init_fake_process_group, make_production_mesh
from repro_torch.models import (ALL_SHAPES, SHAPES_BY_NAME, ShapeSpec, build_model, get_config,
                                input_specs, reduced, shapes_for)
from repro_torch.models.config import LONG_CONTEXT_ARCHS
from repro_torch.models.registry import ARCH_IDS
from repro_torch.parallel import cache_specs, params

DENSE = [a for a in ARCH_IDS if get_config(a).family == "dense"]
MOE = [a for a in ARCH_IDS if get_config(a).family == "moe"]
VARIANTS = ("base", "fsdp", "ddp", "accum4", "no_remat", "exact")
# the families whose cells the dry run records ``not_ported`` (item 12c)
NOT_PORTED_FAMILIES = ("hybrid", "xlstm", "encdec", "vlm")
MESHES = {"16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16))}
# the reference's committed record of stablelm-3b|decode_32k|16x16|base
STABLELM_DECODE_32K_ARGS = 5_720_052_772


class FakeMesh:
    """The reference tests' duck-typed mesh: axis names and a devices array."""

    def __init__(self, names, shape):
        self.axis_names = names
        self.devices = np.empty(shape)


def _key(s):
    return (s.name, s.seq_len, s.global_batch, s.kind)


@pytest.fixture
def fake_world():
    """Rank 0 of a fake world of the given size, taken down after."""
    yield init_fake_process_group
    if dist.is_initialized():
        dist.destroy_process_group()


# --------------------------------------------------------------------------------------
# the shape registry, input_specs, abstract_cache
# --------------------------------------------------------------------------------------


def test_shape_registry_equals_reference():
    assert [_key(s) for s in ALL_SHAPES] == [_key(s) for s in J_ALL_SHAPES]
    assert {k: _key(v) for k, v in SHAPES_BY_NAME.items()} == \
        {k: _key(v) for k, v in J_SHAPES_BY_NAME.items()}
    assert LONG_CONTEXT_ARCHS == J_LONG_CONTEXT_ARCHS
    for arch in ARCH_IDS:
        assert [_key(s) for s in shapes_for(get_config(arch))] == \
            [_key(s) for s in j_shapes_for(j_get_config(arch))], arch


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_equal_reference(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    for shape in shapes_for(cfg):
        got = input_specs(cfg, shape)
        want = j_input_specs(jcfg, J_SHAPES_BY_NAME[shape.name])
        assert sorted(got) == sorted(want), (arch, shape.name)
        for k, t in got.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(want[k].shape), (arch, shape.name, k)
            assert str(t.dtype) == f"torch.{want[k].dtype}", (arch, shape.name, k)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_cache_equals_reference(arch):
    tm, jm = build_model(get_config(arch), "cpu"), j_build_model(j_get_config(arch))
    cache = tm.abstract_cache(128, 1024)
    assert {t.device.type for t in cache.values()} == {"meta"}
    got = {cache_specs.path_str(p): (leaf.shape, leaf.itemsize, str(cache[p].dtype))
           for p, leaf in params.stacked_view(cache).items()}
    want = {j_cache_specs._path_str(p): (tuple(leaf.shape), leaf.dtype.itemsize,
                                         f"torch.{leaf.dtype}")
            for p, leaf in jax.tree_util.tree_flatten_with_path(jm.abstract_cache(128, 1024))[0]}
    assert got == want


# --------------------------------------------------------------------------------------
# per-device argument bytes, against the reference's spec functions
# --------------------------------------------------------------------------------------


def _leaf_bytes(shape, itemsize, spec, sizes):
    n = int(np.prod(shape, dtype=np.int64))
    for ax in spec:
        for a in (() if ax is None else ax if isinstance(ax, tuple) else (ax,)):
            n //= sizes[a]
    return n * itemsize


def _tree_bytes(tree, specs, sizes, itemsize=None):
    return sum(jax.tree.leaves(jax.tree.map(
        lambda leaf, spec: _leaf_bytes(leaf.shape, itemsize or leaf.dtype.itemsize, spec,
                                       sizes), tree, specs)))


def reckon_argument_bytes(jm, abstract, shape, mesh, variant):
    """The reference dry run's per-device argument bytes of a cell, from its
    own spec functions and ``input_specs`` (its ``launch/dryrun.py``
    placement: the WUS / fsdp / ddp train state, bf16 serving params, the
    batch over its batch axes, the cache over ``cache_pspecs``);
    ``abstract`` is ``jm.abstract_params()``."""
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    rules = j_sharding.default_rules(mesh)
    if variant in ("fsdp", "ddp"):
        rules = {**rules, "batch": tuple(mesh.axis_names), "model": None, "expert": None,
                 "vocab": None, "heads": None, "ff": None}
    if variant == "fsdp":
        pspecs = j_params.fsdp_pspecs(abstract, mesh)
    elif variant == "ddp":
        pspecs = jax.tree.map(lambda _: PartitionSpec(), abstract)
    else:
        pspecs = j_params.param_pspecs(abstract, mesh, rules)
    B = shape.global_batch
    bax = rules["batch"]
    if B % int(np.prod([sizes[a] for a in bax])):
        bax = None
    io = j_input_specs(jm.cfg, shape)
    batch = sum(_leaf_bytes(v.shape, v.dtype.itemsize,
                            (bax,) + (None,) * (len(v.shape) - 1) if v.shape else (), sizes)
                for v in io.values())
    if shape.kind == "train":
        if variant == "fsdp":
            state, moments = pspecs, pspecs
        elif variant == "ddp":
            state = pspecs
            moments = j_params.zero1_pspecs(abstract, mesh,
                                            {**rules, "batch": tuple(mesh.axis_names)})
        else:
            state = moments = j_params.zero1_pspecs(abstract, mesh, rules)
        return (_tree_bytes(abstract, state, sizes, 4) + 2 * _tree_bytes(abstract, moments,
                                                                          sizes, 4)
                + 4 + 4 + batch)  # + the AdamW count and the step
    cache = jm.abstract_cache(B, shape.seq_len)
    cspecs = j_cache_specs.cache_pspecs(cache, mesh, rules)
    return _tree_bytes(abstract, pspecs, sizes, 2) + batch + _tree_bytes(cache, cspecs, sizes)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", DENSE + MOE)
def test_argument_bytes_equal_reference(arch, mesh_name, fake_world):
    names, shape_ = MESHES[mesh_name]
    jm = j_build_model(j_get_config(arch))
    abstract = jm.abstract_params()
    fake_world(int(np.prod(shape_)))
    mesh = make_production_mesh(multi_pod=mesh_name == "2x16x16", device="cpu")
    models = {}
    for variant in VARIANTS + (dryrun.MOE_VARIANTS if arch in MOE else ()):
        cfg = dryrun.apply_variant(get_config(arch), variant)
        if repr(cfg) not in models:  # base, fsdp, ddp and accum4 share one
            models[repr(cfg)] = build_model(cfg, "cpu")
        model = models[repr(cfg)]
        for shape in shapes_for(model.cfg):
            got = dryrun.argument_bytes(model, shape, mesh, variant)["total"]
            want = reckon_argument_bytes(jm, abstract, J_SHAPES_BY_NAME[shape.name],
                                         FakeMesh(names, shape_), variant)
            assert got == want, (arch, shape.name, mesh_name, variant, got, want)
            if (arch, shape.name, mesh_name, variant) == ("stablelm-3b", "decode_32k",
                                                          "16x16", "base"):
                assert got == STABLELM_DECODE_32K_ARGS


# --------------------------------------------------------------------------------------
# the cost model and the roofline
# --------------------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cell_costs_equal_reference(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    for shape in shapes_for(cfg):
        jshape = J_SHAPES_BY_NAME[shape.name]
        for pods in (1, 2):
            for variant in ("base", "fsdp", "ddp", "cf10", "limit4", "accum4"):
                kw = dict(n_chips=256 * pods, data_shards=16, model_shards=16, pods=pods,
                          variant=variant)
                got = cost_model.cell_costs(cfg, shape, **kw).as_dict()
                want = j_cost_model.cell_costs(jcfg, jshape, **kw).as_dict()
                assert got == want, (arch, shape.name, pods, variant)
        assert cost_model.forward_flops(cfg, 1024.0, shape.seq_len) == \
            j_cost_model.forward_flops(jcfg, 1024.0, shape.seq_len)
        assert cost_model.decode_attn_read_bytes(cfg, 8.0, shape.seq_len) == \
            j_cost_model.decode_attn_read_bytes(jcfg, 8.0, shape.seq_len)


def _costs(arch, shape_name, **kw):
    return cost_model.cell_costs(get_config(arch), SHAPES_BY_NAME[shape_name], **kw)


def test_cost_model_invariants():
    """The reference's own invariants (tests/test_dryrun_tools.py), on the
    port's model."""
    for arch in ("yi-34b", "qwen3-moe-235b-a22b", "xlstm-125m", "zamba2-1.2b",
                 "whisper-small", "gemma3-12b"):
        cfg = get_config(arch)
        for shape in shapes_for(cfg):
            c = cost_model.cell_costs(cfg, shape)
            assert c.flops_dev > 0 and c.hbm_bytes_dev > 0 and c.ideal_flops_dev > 0
    c = _costs("stablelm-3b", "train_4k")
    assert 1.0 < c.flops_dev / c.ideal_flops_dev < 2.0  # within (1, 2)x of 6ND
    c = _costs("qwen3-moe-235b-a22b", "train_4k")
    dense_equiv = 6.0 * get_config("qwen3-moe-235b-a22b").param_count() * 256 * 4096 / 256
    assert c.flops_dev < 0.5 * dense_equiv  # MoE on its ACTIVE params
    c = _costs("yi-34b", "decode_32k")
    assert 0 < c.ideal_bytes_dev <= c.hbm_bytes_dev  # the decode byte floor
    assert (_costs("yi-34b", "train_4k", variant="fsdp").coll_bytes_dev
            < _costs("yi-34b", "train_4k").coll_bytes_dev)
    assert (_costs("qwen3-moe-235b-a22b", "train_4k", variant="limit4").coll_bytes_dev
            < _costs("qwen3-moe-235b-a22b", "train_4k").coll_bytes_dev)
    assert (_costs("xlstm-125m", "train_4k", variant="ddp").coll_bytes_dev
            < 0.1 * _costs("xlstm-125m", "train_4k").coll_bytes_dev)
    gemma = get_config("gemma3-12b")
    from repro_torch.models.config import AttnConfig

    all_global = gemma.replace(attn=AttnConfig(qk_norm=True))
    tok = 32 * 32768.0
    assert (cost_model.forward_flops(gemma, tok, 32768)
            < cost_model.forward_flops(all_global, tok, 32768))  # gemma3's local window


def test_roofline_terms():
    """Fraction in [0, 1.05] and a named bound (the reference's invariant),
    on the card's datasheet peaks; both production meshes cross nodes."""
    assert roofline.link_bw("16x16") == roofline.link_bw("2x16x16") == roofline.NDR_BW
    assert roofline.link_bw("2x4") == roofline.NVLINK_BW
    for arch in ("stablelm-3b", "zamba2-1.2b"):
        for shape in shapes_for(get_config(arch)):
            for mesh in MESHES:
                a = roofline.analyze(arch, shape.name, mesh)
                assert 0 <= a["roofline_fraction"] <= 1.05, (arch, shape.name, a)
                assert a["dominant"] in ("compute", "memory", "collective")
                c = _costs(arch, shape.name, n_chips=256 * (2 if mesh == "2x16x16" else 1),
                           pods=2 if mesh == "2x16x16" else 1)
                assert a["t_compute_s"] == c.flops_dev / roofline.PEAK_FLOPS
                assert a["t_memory_s"] == c.hbm_bytes_dev / roofline.HBM_BW
                assert a["t_bound_s"] == max(a["t_compute_s"], a["t_memory_s"],
                                             a["t_collective_s"])


# --------------------------------------------------------------------------------------
# collectives, and the trace against a real run
# --------------------------------------------------------------------------------------


def test_collective_bytes_convention(fake_world):
    """On a fake world of 4 (one mesh axis): an all-gather counts its
    gathered result, a reduce-scatter its shard, an all-reduce and an
    all-to-all their result; every other operator counts nothing.  (A CPU
    group has no all-to-all of its own: DTensor's Shard(0) -> Shard(1) on
    it is an all-gather and a chunk, so the all-to-all is called
    directly.)"""
    import torch.distributed._functional_collectives as funcol
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    fake_world(4)
    mesh = DeviceMesh("cpu", torch.arange(4), mesh_dim_names=("x",))
    with FakeTensorMode():
        whole = torch.empty(8, 16)
        s0 = dryrun.place(whole, mesh, [Shard(0)])
        part = DTensor.from_local(torch.empty(8, 16), mesh, [Partial()], run_check=False)
        rec = dryrun.collective_bytes(lambda: (
            s0.redistribute(mesh, [Replicate()]),  # all-gather: the (8, 16) result
            part.redistribute(mesh, [Replicate()]),  # all-reduce: the (8, 16) result
            part.redistribute(mesh, [Shard(0)]),  # reduce-scatter: the (2, 16) shard
            funcol.all_to_all_single(torch.empty(8, 4), None, None, mesh),  # (8, 4)
            s0 * 2, whole.permute(1, 0)))
    f32 = 4
    assert rec == {"all-gather": 8 * 16 * f32, "all-reduce": 8 * 16 * f32,
                   "reduce-scatter": 2 * 16 * f32, "all-to-all": 8 * 4 * f32,
                   "collective-permute": 0,
                   "counts": {"all-gather": 1, "all-reduce": 1, "reduce-scatter": 1,
                              "all-to-all": 1, "collective-permute": 0}}


def test_batch_that_does_not_divide_stays_replicated(fake_world):
    """``long_500k``'s single sequence: a batch the batch axes do not divide
    stays replicated in the inputs (``batch_axes``) and in the activations
    (``shard_activation``), so the decode step traces on a fake (2, 2) world
    with the heads still over 'model'."""
    from torch.distributed.device_mesh import DeviceMesh

    fake_world(4)
    mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 2), mesh_dim_names=("data", "model"))
    cfg = reduced("stablelm-3b").replace(n_layers=2)
    shape = ShapeSpec("d", 64, 1, "decode")
    assert dryrun.batch_axes(dryrun.variant_rules(mesh, "base"), mesh, 1) is None
    rec = dryrun.trace_on_mesh(build_model(cfg, "cpu"), shape, mesh)
    # the 4 heads over 'model': each rank attends 2 of them over the whole cache
    assert rec["flops_per_device"] > 0
    assert rec["collectives"]["counts"]["all-reduce"] > 0


def _real_cell(model, shape, mesh, accum):
    """The cell placed with real tensors: weights from seed 0, tokens from
    numpy seed 1, the serving cache fresh."""
    rng = np.random.default_rng(1)
    ints = lambda *s: torch.from_numpy(rng.integers(0, model.cfg.vocab, s).astype(np.int32))
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        batch = {"tokens": ints(B, S), "targets": ints(B, S)}
    elif shape.kind == "prefill":
        batch = {"tokens": ints(B, S)}
    else:
        batch = {"tok": ints(B, 1), "pos": torch.tensor(3, dtype=torch.int32)}
    cache = None if shape.kind == "train" else model.init_cache(B, S)
    return dryrun.place_cell(model, shape, mesh, "base", model.init(torch.Generator().manual_seed(0)),
                             batch, cache, accum)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_trace_equals_real_step(kind):
    """Reduced stablelm at 4 layers (remat on, exact mode) on a gloo world of one: the
    dry run's FLOPs, collectives and argument bytes, carried from depths 1
    and 2 (training, with 1 and 2 micro-batches) or 2 and 3 (serving; also
    traced whole, ``trace_once``), equal
    ``FlopCounterMode``'s and ``MemTracker``'s over the same step run on
    real tensors (the same meters, ``trace_cell``), and so does the peak
    within 4 KiB: the real run keeps a few scalars alive a little longer
    (600 B seen), though it makes no allocation the trace lacks."""
    _trace_against_real("stablelm-3b", kind)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_moe_trace_equals_real_step(kind):
    """:func:`test_trace_equals_real_step` for reduced deepseek-moe-16b (E 4,
    k 2, shared experts) at 4 layers: the MoE block on the mesh
    (``models.mlp.moe_on_mesh``) traced and run for real."""
    _trace_against_real("deepseek-moe-16b", kind)


def _trace_against_real(arch, kind):
    from repro_torch.launch.mesh import make_debug_mesh

    cfg = reduced(arch).replace(n_layers=4, remat=True)
    cfg = cfg.replace(approx=dataclasses.replace(cfg.approx, mode="exact"))
    model = build_model(cfg, "cpu")
    shape, accum = {"train": (ShapeSpec("t", 8, 4, "train"), 2),
                    "prefill": (ShapeSpec("p", 16, 2, "prefill"), None),
                    "decode": (ShapeSpec("d", 32, 2, "decode"), None)}[kind]
    assert not dist.is_initialized()
    mesh = make_debug_mesh(1, 1, "cpu")
    try:
        real = dryrun.trace_cell(_real_cell(model, shape, mesh, accum))
        recs = [dryrun.trace_on_mesh(model, shape, mesh, accum=accum)]
        if kind != "train":
            recs.append(dryrun.trace_once(model, shape, mesh, "base", "cpu", accum))
    finally:
        dist.destroy_process_group()
    assert recs[0]["trace"]["depths"] == ([1, 2] if kind == "train" else [2, 3])
    mem = real["memory"]
    for rec in recs:
        assert rec["flops_per_device"] == real["flops_per_device"] > 0
        assert rec["collectives"] == real["collectives"]
        assert rec["memory"]["argument_size_in_bytes"] == mem["argument_size_in_bytes"]
        assert abs(rec["memory"]["peak_size_in_bytes"] - mem["peak_size_in_bytes"]) <= 4096


# --------------------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------------------


def _listing(root):
    return sorted((os.path.relpath(os.path.join(d, f), root),
                   os.path.getmtime(os.path.join(d, f)))
                  for d, _, fs in os.walk(root) for f in fs)


def test_cli_writes_its_out_file_only(tmp_path, capsys):
    """One full-width cell (stablelm-3b's decode_32k on (16, 16), its
    arguments the reference's figure) and a cell of the hybrid family
    (``not_ported``, citing item 12c) written to ``--out``, merged; nothing
    under ``benchmarks/``; the fake world taken down."""
    bench = os.path.join(os.path.dirname(__file__), "..", "benchmarks")
    before = _listing(bench)
    out = str(tmp_path / "dry.json")
    dryrun.main(["--arch", "stablelm-3b", "--shape", "decode_32k", "--out", out])
    res = dryrun.main(["--arch", "zamba2-1.2b", "--shape", "decode_32k", "--out", out])
    assert not dist.is_initialized()
    assert _listing(bench) == before
    assert sorted(res) == ["stablelm-3b|decode_32k|16x16|base",
                           "zamba2-1.2b|decode_32k|16x16|base"]
    assert res == dryrun.load_results(out)
    hybrid = res["zamba2-1.2b|decode_32k|16x16|base"]
    assert hybrid["status"] == "not_ported" and "item 12c" in hybrid["reason"]
    rec = res["stablelm-3b|decode_32k|16x16|base"]
    assert rec["status"] == "ok" and rec["n_chips"] == 256 and rec["kind"] == "decode"
    assert rec["memory"]["argument_size_in_bytes"] == STABLELM_DECODE_32K_ARGS
    assert rec["memory"]["peak_size_in_bytes"] > STABLELM_DECODE_32K_ARGS
    # 32 layers x (attention out, MLP down) + the vocab-sharded embedding's
    # partial rows: all-reduces of the rank's (8, 1, d_model) bf16 rows
    colls = rec["collectives"]
    assert colls["counts"] == {"all-gather": 0, "all-reduce": 65, "reduce-scatter": 0,
                               "all-to-all": 0, "collective-permute": 0}
    assert colls["all-reduce"] == 65 * 8 * 2560 * 2
    # the traced FLOPs are the analytic model's terms, with its decode
    # attention term (reads of the whole (8, 32768) cache of the rank's rows,
    # as the reference counts it) over the 16 'model' shards of the heads
    cfg = get_config("stablelm-3b")
    assert rec["flops_per_device"] == (cost_model.forward_flops(cfg, 128.0, 1) / 256
                                       + cost_model.decode_attn_read_bytes(cfg, 8.0, 32768)
                                       / 16)
    assert "[run] stablelm-3b|decode_32k|16x16|base" in capsys.readouterr().out
    dryrun.main(["--arch", "stablelm-3b", "--shape", "decode_32k", "--out", out])
    assert "[cached]" in capsys.readouterr().out


def test_not_ported_names_the_remaining_families():
    """The dense and MoE families' cells trace, the MoE variants cf10 and
    limit4 included; only the hybrid, xLSTM, encoder-decoder and VLM
    families' cells are ``not_ported``."""
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for variant in ("base",) + dryrun.MOE_VARIANTS:
            why = dryrun.not_ported(cfg, variant)
            if cfg.family in NOT_PORTED_FAMILIES:
                assert why and "item 12c" in why and cfg.family in why, (arch, variant)
            else:
                assert why is None, (arch, variant)
    assert {get_config(a).family for a in ARCH_IDS} - set(NOT_PORTED_FAMILIES) == \
        {"dense", "moe"}
