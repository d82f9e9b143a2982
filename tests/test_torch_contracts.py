"""PackLint of the port (``repro_torch.analysis``) and the kernel ops under it.

* The real registry passes on the fast tier (gelu, tanh, log): one case a
  (mode, closure kind) for the per-closure rules, a mode for the obs-off
  identity (beside the reference's), a routed flavor for the reroute
  signatures, and the engine's stationarity.
* Every rule FIRES on a seeded violation, as the reference's do
  (tests/test_analysis.py): an f64 constant and an f64 pack leaf; a kernel
  op with no row and a ``.item()`` (and a data-dependent shape) in a
  closure; a reroute that changes a launch int; a 4x inflated staging image;
  the telemetry on.
* Parity with the reference: ``ALL_MODES`` and ``matrix()`` enumerate its
  (mode, function) pairs, ``KERNEL_ALLOWED`` holds its 19 rows and the two
  routed sharded kernels its table leaves out, one-to-one with the 21 ops,
  the report has its schema, and the ``f64_leak`` and ``obs_off_identity``
  subjects on the fast tier are its own (checked a mode at a time), all
  passing on both sides.
* The ops: on ``meta`` each op's fake outputs are exactly what
  ``_lib.operands`` allocates (contiguous, permuted and gapped x); ``run``
  on ``meta`` reaches the op and counts no launch, on the CPU it never
  reaches it.

Nothing here runs a kernel: the graphs are traced on ``meta``.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.analysis import contracts as jc
from repro.analysis.report import Finding as JFinding
from repro.analysis.report import Report as JReport
from repro_torch import obs
from repro_torch.analysis import contracts, graph_lint as gl
from repro_torch.analysis.report import Finding, Report
from repro_torch.approx import ApproxConfig, table_pack
from repro_torch.core.bram import SMEM_BYTES
from repro_torch.kernels import _lib, ops
from repro_torch.kernels.routed_pack_lookup import routed_pack_lookup
from repro_torch.kernels.table_pack_lookup import table_pack_lookup
from repro_torch.models import build_model  # noqa: F401  (imported once, up front)

FAST = contracts.FAST_FUNCS
# the rules checked a (mode, kind) at a time; obs_off_identity is checked a
# mode at a time beside the reference's (test_obs_subjects_equal_reference)
PER_CLOSURE = ["f64_leak", "kernel_primitives", "smem_budget"]


@pytest.fixture(scope="module")
def ctx():
    c = contracts.LintContext(funcs=FAST)
    for build in (c.pack, c.qpack, c.ppack, c.spack):
        build()
    return c


@pytest.fixture(scope="module")
def actx():
    # a pack that holds the exp_neg member TableFlash serves
    return contracts.LintContext(funcs=("tanh", "exp_neg"), modes=("table_pack",))


def x_meta(n=512):
    return torch.empty(n, device="meta")


# --------------------------------------------------------------------------------------
# The real registry passes on the fast tier
# --------------------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["value", "grad"])
@pytest.mark.parametrize("mode", contracts.ALL_MODES)
def test_fast_registry_green(ctx, mode, kind):
    rep = contracts.run(ctx.view(modes=(mode,), kinds=(kind,)), rules=PER_CLOSURE)
    assert rep.ok, rep.summary()
    subjects = {f.subject for f in rep.findings}
    # every function was checked, by every per-closure rule
    assert all(f"{mode}/{n}/{kind}" in subjects for n in FAST)
    assert all(f"closure:{mode}/{n}/{kind}" in subjects for n in FAST)


@pytest.mark.parametrize("label", ["routed_pack", "routed_quant_pack", "routed_poly_pack"])
@pytest.mark.parametrize("grad", [False, True])
def test_reroutes_keep_one_launch_signature(ctx, label, grad):
    from repro_torch.kernels import routed_pack_lookup as R

    entry = getattr(R, label + ("_grad" if grad else "_lookup"))
    pack = {"routed_pack": ctx.pack, "routed_quant_pack": ctx.qpack,
            "routed_poly_pack": ctx.ppack}[label]()
    x2d = ctx.x("tanh").reshape(contracts.ROWS, -1)
    sigs = contracts.reroute_signatures(
        entry, [(pack, "tanh", x2d), (pack, "log", x2d),
                (pack, ["tanh", "log"] * (contracts.ROWS // 2), x2d)])
    assert all(len(s) == 1 for s in sigs) and len({tuple(s) for s in sigs}) == 1


def test_engine_is_stationary():
    findings = contracts.engine_stationarity_findings()
    assert [f.subject.split(":")[-1] for f in findings] == [
        "entry-points", "tick-stationary", "prefill-stationary", "refill-scatter"]
    assert all(f.ok for f in findings), [f.detail for f in findings if not f.ok]


def test_recompile_rule_green(ctx):
    rep = contracts.run(ctx, rules=["recompile_hazard"])
    assert rep.ok, rep.summary()
    assert len([f for f in rep.findings if f.subject.startswith("reroute:")]) == 6


def test_registry_agrees_with_the_cuda_source():
    (f,) = contracts.registry_findings()
    assert f.ok, f.detail
    assert contracts.cuda_entries() == set(_lib._ENTRIES) == set(ops.OPS)
    assert contracts.cuda_smem_budget() == SMEM_BYTES == 48 * 1024


# --------------------------------------------------------------------------------------
# Rule 1 — f64 leakage: seeded violations fire
# --------------------------------------------------------------------------------------


def test_seeded_f64_constant_fires():
    table = torch.from_numpy(np.linspace(0.0, 1.0, 8))  # f64, like a design table
    gm = gl.trace(lambda v: v + table.sum().to(v.dtype), x_meta())
    hits = gl.find_wide_dtypes(gm)
    assert hits and any("float64" in h for h in hits)
    assert gl.find_wide_dtypes(gl.trace(torch.tanh, x_meta())) == []


def test_seeded_f64_pack_leaf_fires(ctx):
    pk = ctx.pack()
    fat = dataclasses.replace(pk, values=pk.values.to(torch.float64))
    hits = gl.leaf_wide_dtypes(fat)
    assert len(hits) == 1 and ".values" in hits[0]
    assert gl.leaf_wide_dtypes(pk) == []
    # and the f64 plane reaches the launch: the kernel check names it
    (node,) = gl.kernel_nodes(gl.trace(lambda v: table_pack_lookup(fat, "tanh", v),
                                       ctx.x("tanh")))
    assert "plane[4] of torch.float64" in contracts.check_kernel(node)


# --------------------------------------------------------------------------------------
# Rule 2 — the kernel registry and sync-free closures: seeded violations fire
# --------------------------------------------------------------------------------------


def test_seeded_unregistered_entry_fires(ctx, monkeypatch):
    monkeypatch.delitem(contracts._ROW_OF_OP, "tp_pack_lookup")
    gm = ctx.traced("table_pack", "tanh", "value")
    (node,) = gl.kernel_nodes(gm)
    assert contracts.check_kernel(node) == ["unregistered kernel entry"]
    rep = contracts.run(ctx.view(modes=("table_pack",), kinds=("value",)),
                        rules=["kernel_primitives"])
    bad = {f.subject: f.detail for f in rep.failures()}
    assert "kernel:tp_pack_lookup" in bad and "unregistered" in bad["kernel:tp_pack_lookup"]
    assert "registry:entries" in bad  # the rows no longer cover the entries


def test_seeded_item_fires(ctx):
    pk = ctx.pack()

    def leaky(v):
        return table_pack_lookup(pk, "tanh", v) * v.sum().item()

    gm = gl.trace(leaky, ctx.x("tanh"))
    assert ("call_function", "aten::_local_scalar_dense") in gl.nodes(gm)
    bad = contracts.closure_hazards(gm)
    assert "aten::_local_scalar_dense" in bad
    assert contracts.closure_hazards(ctx.traced("table_pack", "tanh", "value")) == []


def test_seeded_data_dependent_shape_fires():
    bad = contracts.closure_hazards(gl.trace(lambda v: v[v > 0].sum(), x_meta()))
    assert any(b.startswith("symbolic") for b in bad)
    assert "aten::nonzero" in contracts.closure_hazards(
        gl.trace(lambda v: torch.nonzero(v), x_meta()))


# --------------------------------------------------------------------------------------
# Rule 3 — recompile hazards: a seeded reroute drift fires
# --------------------------------------------------------------------------------------


def test_seeded_reroute_int_drift_fires(ctx):
    pack = ctx.pack()

    def drifting(p, fns, v):
        # a named routing sent as twice the rows: another launch int (rows)
        rows = v.reshape(2 * contracts.ROWS, -1) if isinstance(fns, str) else v
        return routed_pack_lookup(p, fns, rows)

    x2d = ctx.x("tanh").reshape(contracts.ROWS, -1)
    sigs = contracts.reroute_signatures(
        drifting, [(pack, "tanh", x2d), (pack, "log", x2d),
                   (pack, ["tanh", "log"] * (contracts.ROWS // 2), x2d)])
    assert len({tuple(s) for s in sigs}) == 2
    ints = [s[0][3] for s in sigs]
    assert ints[0][-1] == 2 * contracts.ROWS and ints[2][-1] == contracts.ROWS


# --------------------------------------------------------------------------------------
# Rule 4 — shared-memory staging: a seeded inflation fires
# --------------------------------------------------------------------------------------


def test_real_pack_stages_its_report(ctx):
    (node,) = gl.kernel_nodes(ctx.traced("table_pack", "tanh", "value"))
    report = ctx.layout().smem()
    f = contracts.check_budget(node, report, "s")
    assert f.ok and f.data["staged_bytes"] == report.image_bytes
    assert f.data["staging"] == "image"


def test_seeded_inflated_image_fires(ctx):
    pk = ctx.pack()
    image, m_img = pk.image
    fat = dataclasses.replace(pk, image=(torch.cat([image] * 4), m_img))
    (node,) = gl.kernel_nodes(gl.trace(lambda v: table_pack_lookup(fat, "tanh", v),
                                       ctx.x("tanh")))
    f = contracts.check_budget(node, ctx.layout().smem(), "seeded")
    assert not f.ok and f.data["staged_bytes"] == 4 * f.data["report_bytes"]


def test_routed_allowance_is_named():
    assert contracts.routed_dispatch_allowance("f32", 6) == 72
    assert contracts.routed_dispatch_allowance("quant", 6) == 24


def test_tableflash_stages_its_image(actx):
    rep = contracts.run(actx, rules=["kernel_primitives", "smem_budget"])
    assert rep.ok, rep.summary()
    subjects = {f.subject for f in rep.findings}
    # the grad launches the TableFlash value and the pack's value + slope
    for s in ("closure:attn_exp/value", "closure:attn_exp/grad",
              "kernel:_tableflash_kernel[attn_exp/value]",
              "kernel:_pack_grad_kernel[attn_exp/grad]", "attn_exp/value",
              "attn_exp/grad[0]", "attn_exp/grad[1]"):
        assert s in subjects, s
    flash = [f for f in rep.findings if f.subject == "attn_exp/value"][0]
    assert flash.data["staged_bytes"] == actx.layout().smem(("exp_neg",)).image_bytes


# --------------------------------------------------------------------------------------
# Rule 5 — obs-off identity: the telemetry on fires
# --------------------------------------------------------------------------------------


@pytest.mark.parametrize("what", ["unary", "attn_exp"])
def test_telemetry_on_closure_differs(ctx, actx, what):
    if what == "unary":
        build = lambda: ApproxConfig(mode="table_pack", e_a=ctx.e_a,  # noqa: E731
                                     pack_functions=ctx.pack_names).unary("tanh", "meta")
        x = ctx.x("tanh")
    else:
        build = lambda: ApproxConfig(mode="table_pack", e_a=actx.e_a,  # noqa: E731
                                     pack_functions=actx.pack_names,
                                     attn_table=True).attn_exp("meta")
        x = actx.attn_x()
    try:
        obs.disable()
        fp_never = gl.fingerprint(build(), x)
        obs.configure(enabled=True, device_telemetry=True)
        fp_on = gl.fingerprint(build(), x)
    finally:
        obs.disable()
        obs.reset_registry()
    assert fp_never != fp_on
    assert "torch.ops.aten.lt" not in fp_never and "torch.ops.aten.lt" in fp_on


def test_disabled_closure_identical_and_fingerprint_deterministic(ctx):
    build = lambda: ApproxConfig(mode="table_pack", e_a=ctx.e_a,  # noqa: E731
                                 pack_functions=ctx.pack_names).unary("tanh", "meta")
    never, disabled = contracts.obs_identity_fingerprints(build, ctx.x("tanh"))
    assert never == disabled
    assert gl.fingerprint(ctx.unary_fn("table_pack", "tanh"), ctx.x("tanh")) == \
        gl.fingerprint(ctx.unary_fn("table_pack", "tanh"), ctx.x("tanh"))


def test_fingerprint_masks_constants_and_devices():
    code = ("_tensor_constant7 = self._tensor_constant7\n"
            "full = torch.ops.aten.full.default([2], 1.0, device = device(type='cuda', "
            "index=0))")

    class G:
        pass

    g = G()
    g.code = code
    other = G()
    other.code = code.replace("7", "3").replace("type='cuda', index=0", "type='meta'")
    assert gl.graph_fingerprint(g) == gl.graph_fingerprint(other)


# --------------------------------------------------------------------------------------
# Parity with the reference
# --------------------------------------------------------------------------------------


def test_modes_and_matrix_equal_reference():
    assert contracts.ALL_MODES == jc.ALL_MODES
    assert list(contracts.LintContext().matrix()) == list(jc.LintContext().matrix())
    assert list(contracts.LintContext(funcs=FAST).matrix()) == \
        list(jc.LintContext(funcs=jc.FAST_FUNCS).matrix())
    assert (contracts.EA, contracts.ROWS, contracts.N_GRID, contracts.N_SHARDS,
            contracts.FAST_FUNCS) == (jc.EA, jc.ROWS, jc.N_GRID, jc.N_SHARDS,
                                      jc.FAST_FUNCS)


def test_kernel_rows_are_the_references_and_the_ops():
    extra = {"_sharded_routed_kernel", "_sharded_routed_grad_kernel"}
    assert len(jc.KERNEL_ALLOWED) == 19
    assert set(contracts.KERNEL_ALLOWED) == set(jc.KERNEL_ALLOWED) | extra
    assert len(contracts.KERNEL_ALLOWED) == 21
    rows_ops = [row.op for row in contracts.KERNEL_ALLOWED.values()]
    assert sorted(rows_ops) == sorted(set(rows_ops)) == sorted(ops.OPS)


def test_report_schema_is_the_references():
    fs = [("r", "s", True, "", {}), ("r", "t", False, "boom", {"n": 1}),
          ("q", "u", True, "", {})]
    mine = Report(findings=[Finding(*f) for f in fs], meta={"k": 1})
    ref = JReport(findings=[JFinding(*f) for f in fs], meta={"k": 1})
    assert mine.to_dict() == ref.to_dict()
    assert mine.to_json() == ref.to_json() and mine.summary() == ref.summary()
    assert json.loads(mine.to_json())["schema"] == "packlint-report-v1"


class _OneModeRef(jc.LintContext):
    """The reference's context with its matrix cut to ``only`` (its rules
    read ``ctx.matrix()``)."""

    only = None

    def matrix(self, modes=None):
        return super().matrix(modes if modes is not None else self.only)


@pytest.fixture(scope="module")
def jctx():
    return _OneModeRef(funcs=jc.FAST_FUNCS)


@pytest.mark.parametrize("mode", contracts.ALL_MODES)
def test_f64_subjects_equal_reference(ctx, jctx, mode):
    jctx.only = (mode,)
    ref = jc.rule_f64_leak(jctx)
    mine = contracts.rule_f64_leak(ctx.view(modes=(mode,)))
    assert [f.subject for f in mine] == [f.subject for f in ref]
    assert all(f.ok for f in ref) and all(f.ok for f in mine)


@pytest.mark.parametrize("mode", contracts.ALL_MODES)
def test_obs_subjects_equal_reference(ctx, jctx, mode, monkeypatch):
    monkeypatch.setattr(jc, "ALL_MODES", (mode,))
    ref = [f for f in jc.rule_obs_off_identity(jctx)
           if f.subject.startswith("unary:") or mode == "routed_pack"]
    mine = contracts.rule_obs_off_identity(ctx.view(modes=(mode,)))
    assert [f.subject for f in mine] == [f.subject for f in ref]
    assert all(f.ok for f in ref) and all(f.ok for f in mine)


# --------------------------------------------------------------------------------------
# The ops
# --------------------------------------------------------------------------------------

_BASE = torch.empty(6, 8, 34, device="meta")
LAYOUTS = {"contiguous": _BASE, "permuted": _BASE.permute(1, 2, 0),
           "gapped": _BASE[:, :, ::2]}


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("entry", list(_lib._ENTRIES))
def test_op_fake_outputs_are_the_launch_operands(entry, layout):
    x = LAYOUTS[layout]
    planes, ints = contracts.op_samples(x)[entry]
    op = ops.OPS[entry]
    assert op.namespace == "repro_torch" and str(op._schema) == \
        "repro_torch::" + ops.schema(entry)
    outs = _lib.launch(entry, x, planes, ints)
    _, want = _lib.operands(entry, x, _lib._ENTRIES[entry][0])
    assert [(o.shape, o.dtype, o.stride(), o.device.type) for o in outs] == \
        [(w.shape, w.dtype, w.stride(), "meta") for w in want]
    if layout == "permuted" and not entry.startswith(("tp_routed", "tp_sharded_routed")):
        assert outs[0].stride() == x.stride()
    with pytest.raises(ValueError, match=f"{entry} takes"):
        op(x, list(planes)[:-1], list(ints))


def test_run_on_meta_reaches_the_op_and_counts_nothing(ctx, monkeypatch):
    seen = []
    real = ops.OPS["tp_pack_lookup"]

    def spy(*args):
        seen.append(args[0].device.type)
        return real(*args)

    monkeypatch.setitem(ops.OPS, "tp_pack_lookup", spy)
    _lib.reset_launches()
    y = table_pack_lookup(ctx.pack(), "tanh", ctx.x("tanh"))
    assert y.device.type == "meta" and seen == ["meta"]
    assert not any(_lib.launches.values())


def test_run_on_cpu_never_reaches_the_op(monkeypatch):
    def refuse(*args):
        raise AssertionError("a CPU tensor reached a kernel op")

    for entry in _lib._ENTRIES:
        monkeypatch.setitem(ops.OPS, entry, refuse)
    pk = table_pack.build_pack(("silu", "tanh"), 1e-4, device="cpu")
    x = torch.linspace(-4, 4, 257)
    _lib.reset_launches()
    assert torch.equal(table_pack_lookup(pk, "silu", x),
                       table_pack.eval_pack_ref(pk, "silu", x))
    assert torch.equal(routed_pack_lookup(pk, "tanh", x.reshape(1, -1)).reshape(-1),
                       table_pack.eval_pack_ref(pk, "tanh", x))
    assert not any(_lib.launches.values())
    monkeypatch.undo()
    with pytest.raises(NotImplementedError):  # the op has no CPU implementation
        ops.OPS["tp_pack_lookup"](x, [torch.zeros(1)] * 6, [0] * 8)


# --------------------------------------------------------------------------------------
# The SASS scan's classes (the scan itself runs on the card)
# --------------------------------------------------------------------------------------

_DIV64 = [(0x10, "MOV R8, 0x30"), (0x20, "CALL.REL.NOINC 0x40"), (0x30, "EXIT"),
          (0x40, "I2F.U64.RP R24, R24"), (0x50, "MUFU.RCP R20, R24"),
          (0x60, "F2I.U64.TRUNC R20, R20"), (0x70, "RET.REL.NODEC R20 0x0")]


@pytest.mark.parametrize("text,cls", [
    ("DFMA R2, R4, R6, R2", "f64"), ("@!P0 DADD R2, R2, R4", "f64"),
    ("F2F.F64.F32 R2, R5", "f64"), ("I2F.F64.S32 R2, R5", "f64"),
    ("MUFU.RCP64H R3, R5", "f64"), ("STL [R1], R2", "local"),
    ("LDL.64 R2, [R1+0x8]", "local"), ("CALL.ABS.NOINC 0x0", "call"),
    ("FFMA R2, R4, R6, R2", None), ("DEPBAR.LE SB0, 0x0", None),
    ("F2I.U64.TRUNC R20, R20", None), ("LDS.128 R4, [R2]", None)])
def test_sass_classes(text, cls):
    from repro_torch.analysis import sass

    found = sass.forbidden([(0, text)])
    assert [k for k, v in found.items() if v] == ([cls] if cls else [])


def test_sass_compiler_subroutines_counted_apart():
    from repro_torch.analysis import sass

    found = sass.forbidden(_DIV64)
    assert len(found["div64"]) == 1 and not found["call"]
    fdiv = _DIV64[:3] + [(0x40, "MUFU.RCP R2, R7"), (0x50, "FFMA.RZ R3, R2, R4, R5"),
                         (0x60, "RET.REL.NODEC R10 0x0")]
    assert len(sass.forbidden(fdiv)["fdiv"]) == 1 and not sass.forbidden(fdiv)["call"]
    # a relative call to another subroutine, or to one that stacks, is a call
    other = _DIV64[:3] + [(0x40, "FADD R2, R2, R4"), (0x50, "RET.REL.NODEC R20 0x0")]
    assert len(sass.forbidden(other)["call"]) == 1
    stacked = _DIV64[:4] + [(0x48, "STL [R1], R2")] + _DIV64[4:]
    assert len(sass.forbidden(stacked)["call"]) == 1
    known = {k for row in contracts.KERNEL_ALLOWED.values() for k in row.kernels}
    assert len(known) == 17
    pre = "_ZN53_GLOBAL__N__91234ca7_20_table_pack_lookup_cu_6a4849a9"
    assert sass.kernel_name(pre + "11pack_kernelIfLi0EEEvPKT_", known) == "pack_kernel"
    assert sass.kernel_name(pre + "24routed_quant_pack_kernelIfLi0EEEv",
                            known) == "routed_quant_pack_kernel"
    assert sass.kernel_name(pre + "9my_kernelIfEEv", known) == pre + "9my_kernelIfEEv"


# --------------------------------------------------------------------------------------
# The CLI
# --------------------------------------------------------------------------------------


def test_cli(tmp_path, capsys):
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
    import torch_check_contracts as cli

    assert cli.main(["--list-rules"]) == 0
    listed = capsys.readouterr().out
    assert all(r in listed for r in contracts.RULES)
    assert cli.main(["--rules", "bogus"]) == 2
    out = tmp_path / "r.json"
    assert cli.main(["--funcs", "tanh,log", "--rules", "smem_budget",
                     "--out", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert doc["schema"] == "packlint-report-v1" and doc["ok"]
    assert doc["meta"]["tier"] == "fast" and doc["rules"]["smem_budget"]["failed"] == 0
    if not _toolkit():
        assert cli.main(["--fast", "--sass"]) == 2  # the card-only scan


def _toolkit():
    import shutil

    return shutil.which("nvcc") and shutil.which("cuobjdump")
