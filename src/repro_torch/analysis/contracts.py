"""PackLint — the port's standing contracts, checked on graphs (the
reference's ``analysis/contracts.py``).

Five rules, each registered in :data:`RULES` and enrolled over the live mode
registry (``repro_torch.approx.TABLE_MODES`` plus ``"exact"``), as a new mode
joins the conformance matrix.  Every closure of the (mode x function x
{value, grad}) matrix is traced to a ``make_fx`` graph over ``meta`` tensors
(:func:`graph_lint.trace`); no kernel runs.  A kernel launch is a node of a
``repro_torch`` op (:mod:`repro_torch.kernels.ops`), the counterpart of a
``pallas_call`` equation.  The rules are listed in the package's docstring.
TableFlash's closure (``make_attn_exp_fn``) joins rules 2, 4 and 5 whenever
the lint pack holds ``exp_neg``.
"""

from __future__ import annotations

import copy
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.approx import (FOLDABLE, FOLDED_MODES, TABLE_MODES, ApproxConfig,
                                build_poly_pack, eval_folded_ref, eval_folded_routed,
                                eval_pack_ref, eval_poly_pack_ref, eval_quant_pack_ref,
                                eval_routed_poly_ref, eval_routed_quant_ref,
                                eval_routed_ref, eval_sharded_ref, eval_table_ref,
                                from_quant_layout, from_spec, make_attn_exp_fn,
                                make_folded_fn, make_folded_routed_unary_fn,
                                make_pack_fn, make_poly_pack_fn, make_quant_pack_fn,
                                make_routed_unary_fn, make_sharded_pack_fn, make_table_fn,
                                pack_specs, shard_pack)
from repro_torch.approx.activations import _EXACT
from repro_torch.approx.range_fold import folded_lookup
from repro_torch.core import (cached_table, design, function_names, get_function,
                              pack_layout, plan_quant_member, quant_pack_layout,
                              shard_pack_layout)
from repro_torch.core.bram import SMEM_BYTES
from repro_torch.kernels import _lib, ops
from repro_torch.kernels.routed_pack_lookup import (routed_pack_grad,
                                                    routed_pack_lookup,
                                                    routed_poly_pack_grad,
                                                    routed_poly_pack_lookup,
                                                    routed_quant_pack_grad,
                                                    routed_quant_pack_lookup)
from repro_torch.kernels.table_lookup import table_lookup
from repro_torch.kernels.table_pack_lookup import (poly_pack_lookup, quant_pack_lookup,
                                                   sharded_pack_lookup,
                                                   table_pack_lookup)

from . import graph_lint as gl
from .report import Finding, Report

EA = 1e-4
ROWS = 16  # routed modes reshape the grid into (ROWS, -1) rows
N_GRID = 2048
N_SHARDS = 2
# the fast-tier subsample (the reference's tests/test_conformance.FAST_FUNCS)
FAST_FUNCS = ("gelu", "tanh", "log")
ALL_MODES = tuple(TABLE_MODES) + ("exact",)
CUDA_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "table_pack_lookup.cu"


# --------------------------------------------------------------------------------------
# The kernel registry (rule 2): one row per TPU kernel of the reference, keyed
# by its Pallas kernel's name.  A kernel node whose op has no row FAILS the
# lint: enrolling a kernel means adding its row, the moment to review what it
# launches on the card.
# --------------------------------------------------------------------------------------


@dataclass(frozen=True)
class KernelRow:
    """The port's op for one reference Pallas kernel and the ``__global__``
    kernels of ``csrc/table_pack_lookup.cu`` that the op launches (the
    image-staging kernel where the staging image fits, the fallback past
    it)."""

    op: str
    kernels: Tuple[str, ...]


KERNEL_ALLOWED: Dict[str, KernelRow] = {
    "_table_kernel": KernelRow("tp_table_lookup", ("pack_image_kernel", "pack_kernel")),
    "_table_grad_kernel": KernelRow("tp_table_grad", ("pack_image_kernel", "pack_kernel")),
    "_pack_kernel": KernelRow("tp_pack_lookup", ("pack_image_kernel", "pack_kernel")),
    "_pack_grad_kernel": KernelRow("tp_pack_grad", ("pack_image_kernel", "pack_kernel")),
    "_quant_kernel": KernelRow("tp_quant_lookup", ("quant_image_kernel", "quant_kernel")),
    "_quant_grad_kernel": KernelRow("tp_quant_grad",
                                    ("quant_image_kernel", "quant_kernel")),
    "_poly_kernel": KernelRow("tp_poly_lookup", ("poly_image_kernel", "poly_kernel")),
    "_poly_grad_kernel": KernelRow("tp_poly_grad", ("poly_image_kernel", "poly_kernel")),
    "_spack_kernel": KernelRow("tp_spack_lookup", ("spack_kernel",)),
    "_spack_grad_kernel": KernelRow("tp_spack_grad",
                                    ("spack_image_kernel", "spack_kernel")),
    "_folded_kernel": KernelRow("tp_folded_lookup",
                                ("folded_image_kernel", "folded_kernel")),
    "_folded_grad_kernel": KernelRow("tp_folded_grad",
                                     ("folded_image_kernel", "folded_kernel")),
    "_routed_kernel": KernelRow("tp_routed_lookup",
                                ("routed_pack_image_kernel", "routed_kernel")),
    "_routed_grad_kernel": KernelRow("tp_routed_grad",
                                     ("routed_pack_image_kernel", "routed_kernel")),
    "_routed_quant_kernel": KernelRow("tp_routed_quant_lookup",
                                      ("routed_quant_pack_kernel", "routed_quant_kernel")),
    "_routed_quant_grad_kernel": KernelRow(
        "tp_routed_quant_grad", ("routed_quant_pack_kernel", "routed_quant_kernel")),
    "_routed_poly_kernel": KernelRow("tp_routed_poly_lookup",
                                     ("routed_poly_pack_kernel", "routed_poly_kernel")),
    "_routed_poly_grad_kernel": KernelRow(
        "tp_routed_poly_grad", ("routed_poly_pack_kernel", "routed_poly_kernel")),
    # TableFlash: the fused exp_neg lookup with the underflow-to-zero tail
    "_tableflash_kernel": KernelRow("tp_tableflash_exp",
                                    ("flash_image_kernel", "pack_kernel")),
    # the routed sharded kernels, which the reference's table leaves out
    "_sharded_routed_kernel": KernelRow("tp_sharded_routed_lookup", ("routed_kernel",)),
    "_sharded_routed_grad_kernel": KernelRow("tp_sharded_routed_grad",
                                             ("spack_image_kernel", "routed_kernel")),
}
# op -> its row's key
_ROW_OF_OP = {row.op: name for name, row in KERNEL_ALLOWED.items()}


def cuda_entries(source: Path = CUDA_SOURCE) -> set:
    """The ``extern "C" ... tp_*(`` entry points of the CUDA source (its
    error-string helper aside)."""
    found = set(re.findall(r'extern "C"[^(]*?\b(tp_\w+)\s*\(', source.read_text()))
    return found - {"tp_error_string"}


def cuda_smem_budget(source: Path = CUDA_SOURCE) -> int:
    """``kSmemBytes`` of the CUDA source: the bytes a block stages."""
    m = re.search(r"kSmemBytes\s*=\s*(\d+)\s*\*\s*(\d+)", source.read_text())
    return int(m.group(1)) * int(m.group(2))


# --------------------------------------------------------------------------------------
# The lint context: one cached build of every pack flavor and one cached graph
# per (mode, function, value|grad) closure, shared by all rules.
# --------------------------------------------------------------------------------------


class LintContext:
    """Shared pack builds, closures and trace cache of one PackLint run.
    The packs are built from the design flow on the host and their tensors
    placed on ``device``: ``meta`` (the CPU lint: nothing runs) or a CUDA
    device (the card's trace of the same closures)."""

    def __init__(self, e_a: float = EA, funcs: Optional[Sequence[str]] = None,
                 n_shards: int = N_SHARDS, device="meta",
                 modes: Sequence[str] = ALL_MODES,
                 kinds: Sequence[str] = ("value", "grad"), sass: bool = False):
        self.e_a = float(e_a)
        # the subjects the rules check: the matrix's modes and closure kinds
        # (every mode's and both by default), and the built library's SASS
        self.modes, self.kinds, self.sass = tuple(modes), tuple(kinds), sass
        self.funcs = tuple(funcs) if funcs is not None else tuple(function_names())
        if len(self.funcs) < 2:
            raise ValueError("PackLint needs >= 2 functions (reroute checks)")
        # folded modes read the canonical-interval core members of the pack
        cores = [c for n in self.funcs for c in FOLDABLE.get(n, ())
                 if c not in self.funcs]
        self.pack_names = self.funcs + tuple(dict.fromkeys(cores))
        self.n_shards = int(n_shards)
        self.device = torch.device(device)
        self._cache: dict = {}

    def view(self, modes: Optional[Sequence[str]] = None,
             kinds: Optional[Sequence[str]] = None) -> "LintContext":
        """The same context (its packs and graphs shared) checking only
        ``modes`` and ``kinds``."""
        v = copy.copy(self)
        v.modes = self.modes if modes is None else tuple(modes)
        v.kinds = self.kinds if kinds is None else tuple(kinds)
        return v

    # ---------------------------- pack builds -----------------------------

    def _memo(self, key, build):
        if key not in self._cache:
            self._cache[key] = build()
        return self._cache[key]

    def spec(self, name: str):
        return cached_table(name, self.e_a)

    def pack(self):
        return self._memo("pack", lambda: pack_specs(
            [self.spec(n) for n in self.pack_names], self.device))

    def layout(self):
        return self._memo("layout", lambda: pack_layout(
            [self.spec(n) for n in self.pack_names]))

    def qpack(self):
        return self._memo("qpack", lambda: from_quant_layout(self.qlayout(), self.device))

    def qlayout(self):
        return self._memo("qlayout", lambda: quant_pack_layout(
            [plan_quant_member(n, self.e_a) for n in self.funcs]))

    def ppack(self):
        return self._memo("ppack", lambda: build_poly_pack(self.funcs, self.e_a,
                                                           device=self.device))

    def pplan(self):
        # build_poly_pack's own plan() call (rho=0.9, every dtype)
        return self._memo("pplan", lambda: design.plan(
            list(self.funcs), self.e_a, None, dtypes=design.POLY_DTYPES,
            algorithm="hierarchical", omega=0.3, rho=0.9))

    def spack(self):
        return self._memo("spack", lambda: shard_pack(self.layout(), self.n_shards,
                                                      self.device))

    def slayout(self):
        return self._memo("slayout",
                          lambda: shard_pack_layout(self.layout(), self.n_shards))

    # ----------------------------- closures -------------------------------

    def x(self, name: str) -> torch.Tensor:
        lo, hi = get_function(name).interval
        grid = np.linspace(lo, hi, N_GRID + 1)[:-1].astype(np.float32)
        return torch.from_numpy(grid).to(self.device)

    def matrix(self, modes: Optional[Sequence[str]] = None
               ) -> Iterator[Tuple[str, str]]:
        for m in (modes if modes is not None else self.modes):
            for f in self.funcs:
                if m == "exact" and f not in _EXACT:
                    continue  # the canonical-interval core members are
                    # table-only: exact mode has no closure for them
                yield m, f

    def value_closure(self, mode: str, name: str) -> Callable:
        """``f(x)`` for one (mode, function): the runtime the conformance
        matrix evaluates, as an un-evaluated closure."""
        pk, rows = self.pack(), (lambda v: v.reshape(ROWS, -1))
        if mode == "exact":
            return _EXACT[name]
        if mode in ("table_ref", "table_pallas"):
            jt = from_spec(self.spec(name), self.device)
            run = eval_table_ref if mode == "table_ref" else table_lookup
            return lambda v: run(jt, v)
        static = {
            "table_pack_ref": (eval_pack_ref, self.pack),
            "table_pack": (table_pack_lookup, self.pack),
            "quant_pack_ref": (eval_quant_pack_ref, self.qpack),
            "quant_pack": (quant_pack_lookup, self.qpack),
            "poly_pack_ref": (eval_poly_pack_ref, self.ppack),
            "poly_pack": (poly_pack_lookup, self.ppack),
            "sharded_pack_ref": (eval_sharded_ref, self.spack),
            "sharded_pack": (sharded_pack_lookup, self.spack),
            "folded_pack_ref": (eval_folded_ref, self.pack),
            "folded_pack": (folded_lookup, self.pack),
        }
        if mode in static:
            run, packer = static[mode]
            p = packer()
            return lambda v: run(p, name, v)
        routed = {
            "routed_pack_ref": (eval_routed_ref, self.pack),
            "routed_pack": (routed_pack_lookup, self.pack),
            "routed_quant_pack_ref": (eval_routed_quant_ref, self.qpack),
            "routed_quant_pack": (routed_quant_pack_lookup, self.qpack),
            "routed_poly_pack_ref": (eval_routed_poly_ref, self.ppack),
            "routed_poly_pack": (routed_poly_pack_lookup, self.ppack),
        }
        if mode in routed:
            run, packer = routed[mode]
            p = packer()
            return lambda v: run(p, name, rows(v)).reshape(v.shape)
        if mode in ("folded_routed_pack_ref", "folded_routed_pack"):
            kernel = mode == "folded_routed_pack"
            return lambda v: eval_folded_routed(pk, name, v, use_kernel=kernel)
        raise ValueError(f"unknown mode {mode!r}")

    def unary_fn(self, mode: str, name: str) -> Callable:
        """The mode's differentiable unary (the conformance ``approx_fn``)."""
        if mode == "exact":
            return _EXACT[name]
        if mode in ("table_ref", "table_pallas"):
            return make_table_fn(from_spec(self.spec(name), self.device),
                                 use_kernel=(mode == "table_pallas"))
        kernel = not mode.endswith("_ref")
        if mode in FOLDED_MODES:
            make = (make_folded_routed_unary_fn if "routed" in mode else make_folded_fn)
            return make(self.pack(), name, use_kernel=kernel)
        if mode.startswith("routed"):
            pack = (self.ppack() if "poly" in mode
                    else self.qpack() if "quant" in mode else self.pack())
            return make_routed_unary_fn(pack, name, use_kernel=kernel)
        if mode.startswith("sharded"):
            return make_sharded_pack_fn(self.spack(), name, use_kernel=kernel)
        if mode.startswith("poly"):
            return make_poly_pack_fn(self.ppack(), name, use_kernel=kernel)
        if mode.startswith("quant"):
            return make_quant_pack_fn(self.qpack(), name, use_kernel=kernel)
        return make_pack_fn(self.pack(), name, use_kernel=kernel)

    def grad_closure(self, mode: str, name: str) -> Callable:
        return grad_of(self.unary_fn(mode, name))

    def traced(self, mode: str, name: str, kind: str) -> torch.fx.GraphModule:
        """Cached graph of one (mode, function, value|grad) closure."""
        def build():
            f = (self.value_closure(mode, name) if kind == "value"
                 else self.grad_closure(mode, name))
            return gl.trace(f, self.x(name))

        return self._memo(("trace", mode, name, kind), build)

    # ----------------------------- TableFlash -----------------------------

    def flash(self) -> bool:
        """Whether TableFlash's closure joins the checks: the pack holds
        ``exp_neg`` and ``table_pack`` (whose attn_exp it is) is checked."""
        return "exp_neg" in self.pack_names and "table_pack" in self.modes

    def attn_x(self) -> torch.Tensor:
        # flash attention feeds s - m_new <= 0; a below-domain tail keeps the
        # zero-tail path in the traced closure
        grid = np.linspace(-20.0, 0.0, N_GRID).astype(np.float32)
        return torch.from_numpy(grid).to(self.device)

    def attn_traced(self, kind: str) -> torch.fx.GraphModule:
        """Cached graph of the TableFlash exp closure (value|grad)."""
        def build():
            fn = make_attn_exp_fn(self.pack(), use_kernel=True)
            return gl.trace(fn if kind == "value" else grad_of(fn), self.attn_x())

        return self._memo(("attn_trace", kind), build)


def grad_of(fn: Callable) -> Callable:
    """``x -> d(sum fn(x))/dx``, the closure a training step runs."""
    def g(v):
        u = v.detach().requires_grad_(True)
        with torch.enable_grad():
            return torch.autograd.grad(fn(u).sum(), u)[0]

    return g


# --------------------------------------------------------------------------------------
# Rule registry
# --------------------------------------------------------------------------------------

RULES: Dict[str, Callable[[LintContext], List[Finding]]] = {}


def rule(name: str):
    def deco(fn):
        RULES[name] = fn
        return fn
    return deco


def run(ctx: Optional[LintContext] = None,
        rules: Optional[Sequence[str]] = None) -> Report:
    """Run the registered rules and collect a :class:`Report`."""
    ctx = ctx or LintContext()
    names = list(rules) if rules is not None else list(RULES)
    rep = Report(meta={
        "e_a": ctx.e_a, "funcs": list(ctx.funcs),
        "modes": list(ctx.modes), "n_shards": ctx.n_shards,
        "rules": names, "torch": torch.__version__, "device": str(ctx.device),
    })
    for name in names:
        rep.extend(RULES[name](ctx))
    return rep


# --------------------------------------------------------------------------------------
# Rule 1 — f64 leakage
# --------------------------------------------------------------------------------------

@rule("f64_leak")
def rule_f64_leak(ctx: LintContext) -> List[Finding]:
    """No float64/complex128 in any closure's graph or any pack leaf."""
    out: List[Finding] = []
    artifacts = [("pack", ctx.pack()), ("quant_pack", ctx.qpack()),
                 ("poly_pack", ctx.ppack()), ("sharded_pack", ctx.spack())]
    for label, art in artifacts:
        hits = gl.leaf_wide_dtypes(art)
        out.append(Finding("f64_leak", f"artifact:{label}", not hits,
                           "; ".join(hits[:4])))
    for mode, name in ctx.matrix():
        for kind in ctx.kinds:
            hits = gl.find_wide_dtypes(ctx.traced(mode, name, kind))
            out.append(Finding("f64_leak", f"{mode}/{name}/{kind}", not hits,
                               "; ".join(hits[:4])))
    return out


# --------------------------------------------------------------------------------------
# Rule 2 — registered kernel entries + sync-free closures (+ the SASS on the card)
# --------------------------------------------------------------------------------------

def check_kernel(node: gl.KernelNode) -> List[str]:
    """Violations of one kernel node: an op with no row, an arity other
    than the entry's, an x neither f32 nor bf16, or a plane of a wide
    dtype."""
    if node.entry not in _ROW_OF_OP:
        return ["unregistered kernel entry"]
    _, n_planes, n_int = _lib._ENTRIES[node.entry]
    bad = []
    if len(node.planes) != n_planes or len(node.ints) != n_int:
        bad.append(f"arity {len(node.planes)} planes / {len(node.ints)} ints, "
                   f"the entry takes {n_planes} / {n_int}")
    if node.x[1] not in _lib.DTYPE_CODE:
        bad.append(f"x of {node.x[1]}")
    bad += [f"plane[{i}] of {p[1]}" for i, p in enumerate(node.planes)
            if p[1] in gl.WIDE_DTYPES]
    return bad


def closure_hazards(gm: torch.fx.GraphModule) -> List[str]:
    """Host syncs, data-dependent ops and symbolic shapes of a closure's
    graph: an obs-off serving closure holds none."""
    return gl.host_syncs(gm) + [f"symbolic {s}" for s in gl.symbolic_shapes(gm)]


def _kernel_findings(gm, where: str, seen: set) -> List[Finding]:
    out = []
    for node in gl.kernel_nodes(gm):
        key = _ROW_OF_OP.get(node.entry, node.entry)
        if (key, where) in seen:
            continue  # one verdict per kernel per closure kind
        seen.add((key, where))
        bad = check_kernel(node)
        subject = (f"kernel:{node.entry}" if node.entry not in _ROW_OF_OP
                   else f"kernel:{key}[{where}]")
        out.append(Finding("kernel_primitives", subject, not bad,
                           "; ".join(bad[:6]) + (f" ({where})" if bad else "")))
    return out


def registry_findings(source: Path = CUDA_SOURCE) -> List[Finding]:
    """The CUDA source's entry points, the registered ops, ``_ENTRIES`` and
    the rows of :data:`KERNEL_ALLOWED` are one set."""
    prefix = ops.NAMESPACE + "::"
    sets = {"cuda": cuda_entries(source),
            "ops": {n[len(prefix):] for n in torch._C._dispatch_get_all_op_names()
                    if n.startswith(prefix)},
            "entries": set(_lib._ENTRIES), "rows": set(_ROW_OF_OP)}
    ref = sets["entries"]
    diff = {k: sorted(v ^ ref) for k, v in sets.items() if v != ref}
    return [Finding("kernel_primitives", "registry:entries", not diff,
                    f"differ from _ENTRIES: {diff}" if diff else "",
                    {"n_entries": len(ref)})]


# What a kernel's SASS may hold of the classes the scan forbids, frozen from
# the built library when the scan was enrolled (the counterpart of the
# reference's per-kernel allowlists): a kernel that gains a class, or more of
# it than its row allows, fails.  poly_kernel (the static poly pack past the
# 48 KB budget) keeps its Horner coefficients cs[4] on a 16-byte stack
# (ptxas: 16 bytes stack frame, no spills): 30-31 LDL / STL an
# instantiation; poly_image_kernel, which serves the packs that fit, holds
# none.
SASS_ALLOWED: Dict[str, Dict[str, int]] = {"poly_kernel": {"local": 31}}


def sass_findings(lib_path: Optional[str] = None) -> List[Finding]:
    """The built library's SASS (``cuobjdump -sass``): no ``__global__``
    kernel holds an f64 instruction, local-memory traffic (LDL / STL) or a
    call, beyond what :data:`SASS_ALLOWED` freezes for it (a call to one of
    the compiler's arithmetic subroutines, ``sass.SUBROUTINES``, is counted
    apart), and every kernel belongs to a row of :data:`KERNEL_ALLOWED`.  Builds
    ``csrc/table_pack_lookup.cu`` (``nvcc``) unless given the library;
    needs the CUDA toolkit."""
    from repro_torch.kernels import _build

    from . import sass

    if lib_path is None:
        _build.build([_lib.SOURCE])
        lib_path = str(_build._lib_path(_lib.SOURCE))
    known = {k for row in KERNEL_ALLOWED.values() for k in row.kernels}
    out: List[Finding] = []
    seen = set()
    funcs = sass.functions(lib_path)
    for mangled, instrs in sorted(funcs.items()):
        name = sass.kernel_name(mangled, known)
        seen.add(name)
        found = sass.forbidden(instrs)
        allowed = SASS_ALLOWED.get(name, {})
        bad = [f"{k}: {sorted(set(v))[:4]} x{len(v)}" for k, v in found.items()
               if k not in sass.SUBROUTINES and len(v) > allowed.get(k, 0)]
        if name not in known:
            bad.insert(0, "a kernel of no KERNEL_ALLOWED row")
        out.append(Finding("kernel_primitives", f"sass:{mangled}", not bad,
                           "; ".join(bad), {"kernel": name, "instructions": len(instrs),
                                            **{k: len(v) for k, v in found.items()}}))
    missing = sorted(known - seen)
    out.append(Finding("kernel_primitives", "sass:rows", not missing,
                       f"row kernels not in the library: {missing}" if missing else "",
                       {"functions": len(funcs), "kernels": len(seen & known)}))
    return out


@rule("kernel_primitives")
def rule_kernel_primitives(ctx: LintContext) -> List[Finding]:
    """Every kernel node is a registered op with a KERNEL_ALLOWED row; the
    CUDA entries, ops and rows agree; obs-off closures hold no host sync,
    data-dependent op or symbolic shape (and, with ``ctx.sass``, the SASS
    holds no f64, local-memory or CALL instruction)."""
    out: List[Finding] = []
    seen: set = set()
    for mode, name in ctx.matrix():
        for kind in ctx.kinds:
            gm = ctx.traced(mode, name, kind)
            # the closures are built with observability off (the runtime
            # serving path), so any host read is a leak
            bad = closure_hazards(gm)
            out.append(Finding(
                "kernel_primitives", f"closure:{mode}/{name}/{kind}", not bad,
                f"on the obs-off path: {bad[:6]}" if bad else ""))
            out += _kernel_findings(gm, f"{mode}/{name}/{kind}", seen)
    # TableFlash: the attn_exp closure is its own runtime entry (a kernel the
    # mode matrix never launches), under the same contract
    if ctx.flash():
        for kind in ctx.kinds:
            gm = ctx.attn_traced(kind)
            bad = closure_hazards(gm)
            out.append(Finding(
                "kernel_primitives", f"closure:attn_exp/{kind}", not bad,
                f"on the obs-off path: {bad[:6]}" if bad else ""))
            out += _kernel_findings(gm, f"attn_exp/{kind}", seen)
    out += registry_findings()
    if ctx.sass:
        out += sass_findings()
    return out


# --------------------------------------------------------------------------------------
# Rule 3 — recompile hazards: routed reroutes + the serving tick
# --------------------------------------------------------------------------------------

def reroute_signatures(entry: Callable, calls: Sequence[tuple]) -> List[list]:
    """The kernel nodes' launch signatures (``KernelNode.signature``) of
    ``entry(*call)`` traced for each call: equal over reroutes means one
    compiled kernel and one CUDA graph serve every routing."""
    sigs = []
    for pack, fns, x in calls:
        gm = gl.trace(lambda v: entry(pack, fns, v), x)
        sigs.append([n.signature for n in gl.kernel_nodes(gm)])
    return sigs


def _sig(tree):
    if isinstance(tree, torch.Tensor):
        return (tuple(tree.shape), tree.dtype)
    if isinstance(tree, dict):
        return tuple((k, _sig(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return tuple(_sig(v) for v in tree)
    return tree


def engine_stationarity_findings(batch: int = 2, cache_len: int = 32,
                                 prefill_len: int = 8) -> List[Finding]:
    """ContinuousEngine's two-entry-point invariant, on ``meta`` tensors
    alone (the reference's reduced dense configuration, abstract params):
    the tick's outputs re-feed it with the same shapes and dtypes, prefill
    returns the cache's signature and the refill scatter keeps it."""
    from repro_torch.models import ARCH_IDS, build_model, get_config
    from repro_torch.serving.engine import (ContinuousEngine, cache_batch_axes,
                                            scatter_cache_slots)

    out: List[Finding] = []
    aid = next(a for a in ARCH_IDS if get_config(a).family == "dense")
    cfg = get_config(aid)
    period = max(1, cfg.attn.global_every)
    cfg = cfg.replace(d_model=64, vocab=128, remat=False, n_layers=2 * period,
                      n_heads=4, n_kv_heads=2, d_head=16, d_ff=128)
    model = build_model(cfg, device="meta")
    params = model.abstract_params()
    eng = ContinuousEngine(model, params, batch, cache_len)
    entries = tuple(eng.ENTRY_POINTS)
    out.append(Finding("recompile_hazard", f"engine:{aid}:entry-points",
                       entries == ("prefill", "decode_step"), f"entry points {entries}"))

    cache = model.init_cache(batch, cache_len, device="meta")
    tok = torch.empty((batch, 1), dtype=torch.int64, device="meta")
    pos = torch.empty((batch,), dtype=torch.int32, device="meta")
    sig = _sig(cache)
    # tick stationarity: (nxt, logits, pos', cache') re-feed the tick with
    # the same shapes and dtypes: one signature forever
    nxt, _, pos2, cache2 = eng._tick(tok, pos, cache)
    stationary = (_sig(nxt) == _sig(tok) and _sig(pos2) == _sig(pos)
                  and _sig(cache2) == sig)
    out.append(Finding("recompile_hazard", f"engine:{aid}:tick-stationary", stationary,
                       "" if stationary else
                       f"tick outputs drift: tok {_sig(nxt)}, pos {_sig(pos2)}"))
    # one prefill signature: a refill reuses the same (B, S0) and must
    # return a cache of the original signature (the scatter's source)
    toks = torch.empty((batch, prefill_len), dtype=torch.int64, device="meta")
    _, pcache = model.prefill(params, {"tokens": toks}, cache)
    out.append(Finding("recompile_hazard", f"engine:{aid}:prefill-stationary",
                       _sig(pcache) == sig,
                       "" if _sig(pcache) == sig else "prefill cache drifts"))
    axes = cache_batch_axes(model, cache_len)
    src = model.init_cache(1, cache_len, device="meta")
    scat = scatter_cache_slots(cache, src, [0], axes)
    out.append(Finding("recompile_hazard", f"engine:{aid}:refill-scatter",
                       _sig(scat) == sig,
                       "" if _sig(scat) == sig else "scattered cache drifts"))
    return out


@rule("recompile_hazard")
def rule_recompile_hazard(ctx: LintContext) -> List[Finding]:
    """Routed kernel launches keep one signature over reroutes; the
    engine's tick, prefill and refill are stationary."""
    out: List[Finding] = []
    a, b = ctx.funcs[0], ctx.funcs[1]
    x2d = ctx.x(a).reshape(ROWS, -1)
    mixed = [a, b] * (ROWS // 2)
    variants = [
        ("routed_pack", routed_pack_lookup, ctx.pack),
        ("routed_pack.grad", routed_pack_grad, ctx.pack),
        ("routed_quant_pack", routed_quant_pack_lookup, ctx.qpack),
        ("routed_quant_pack.grad", routed_quant_pack_grad, ctx.qpack),
        ("routed_poly_pack", routed_poly_pack_lookup, ctx.ppack),
        ("routed_poly_pack.grad", routed_poly_pack_grad, ctx.ppack),
    ]
    for label, entry, packer in variants:
        pack = packer()
        sigs = reroute_signatures(entry, [(pack, a, x2d), (pack, b, x2d),
                                          (pack, mixed, x2d)])
        n_keys = len({tuple(s) for s in sigs})
        ok = n_keys == 1 and all(len(s) == 1 for s in sigs)
        out.append(Finding(
            "recompile_hazard", f"reroute:{label}", ok,
            "" if ok else f"{n_keys} distinct launch signatures over 3 routings "
                          f"(expected 1 launch of 1 signature)",
            {"n_calls": len(sigs), "n_keys": n_keys}))
    out.extend(engine_stationarity_findings())
    return out


# --------------------------------------------------------------------------------------
# Rule 4 — shared-memory staging vs the packs' smem() reports
# --------------------------------------------------------------------------------------

def routed_dispatch_allowance(kind: str, n_functions: int) -> int:
    """What a routed launch stages beside its pack's staging image, which
    the static launch does not: the f32 pack's members' interval counts,
    row starts and extrapolate flags (3 int32 a member,
    ``launch_routed_image``), the quantized and polynomial packs' and the
    sharded grad's extrapolate flags (1 a member).  The report prices the
    image, which both launches stage; this allowance is the routed
    launch's own, named here rather than folded into ``smem()``.  (The
    reference's other allowance, ``poly_lane_padding_allowance``, has no
    counterpart: ``PackPlan.smem()`` prices the lane-padded image the
    device pack holds.)"""
    return 4 * n_functions * (3 if kind == "f32" else 1)


# entry -> (flavor, the staging-image plane's index, routed); the sharded
# value entries stage no image: their staged operand is the values slab
_STAGED_PLANE = {
    "tp_pack_lookup": ("f32", 5, False), "tp_pack_grad": ("f32", 5, False),
    "tp_tableflash_exp": ("flash", 5, False),
    "tp_folded_lookup": ("fold", 5, False), "tp_folded_grad": ("fold", 5, False),
    "tp_quant_lookup": ("quant", 8, False), "tp_quant_grad": ("quant", 8, False),
    "tp_poly_lookup": ("poly", 8, False), "tp_poly_grad": ("poly", 8, False),
    "tp_routed_lookup": ("f32", 9, True), "tp_routed_grad": ("f32", 9, True),
    "tp_routed_quant_lookup": ("quant", 15, True),
    "tp_routed_quant_grad": ("quant", 15, True),
    "tp_routed_poly_lookup": ("poly", 17, True), "tp_routed_poly_grad": ("poly", 17, True),
    "tp_spack_grad": ("sharded", 6, False), "tp_sharded_routed_grad": ("sharded", 9, True),
    "tp_spack_lookup": ("slab", 5, False), "tp_sharded_routed_lookup": ("slab", 8, True),
}


def check_budget(node: gl.KernelNode, report, subject: str,
                 allowance: int = 0, budget: int = SMEM_BYTES) -> Finding:
    """The node's staged operand against its flavor's ``smem()`` report:
    the staging image's bytes equal the report's (the values slab's, for
    the sharded value kernels), and the report stages the image exactly
    where it and the launch's ``allowance`` fit ``budget``."""
    flavor, plane, _ = _STAGED_PLANE[node.entry]
    got = node.plane_bytes(plane)
    want = report.table_bytes if flavor == "slab" else report.image_bytes
    stages = report.image_bytes + allowance <= budget
    agrees = report.budget_bytes == budget and report.fits == (report.image_bytes <= budget)
    ok = got == want and agrees
    detail = ""
    if got != want:
        detail = (f"the launch stages {got} B where the {flavor} report says "
                  f"{want} B")
    elif not agrees:
        detail = f"the report's budget {report.budget_bytes} B is not {budget} B"
    return Finding("smem_budget", subject, ok, detail, {
        "staged_bytes": got, "report_bytes": want, "budget_bytes": budget,
        "allowance_bytes": allowance,
        "staging": ("image" if stages else report.fallback) if flavor != "slab"
        else report.fallback})


def _report_for(ctx: LintContext, node: gl.KernelNode, name: str):
    flavor = _STAGED_PLANE[node.entry][0]
    if flavor == "f32":
        return ctx.layout().smem()
    if flavor == "flash":
        return ctx.layout().smem(("exp_neg",))
    if flavor == "fold":
        return ctx.layout().smem(FOLDABLE[name])
    if flavor == "quant":
        return ctx.qlayout().smem()
    if flavor == "poly":
        return ctx.pplan().smem()
    return ctx.slayout().smem()


def _n_functions(ctx: LintContext, node: gl.KernelNode) -> int:
    flavor = _STAGED_PLANE[node.entry][0]
    return len(ctx.funcs) if flavor in ("quant", "poly") else len(ctx.pack_names)


def _budget_findings(ctx, gm, name: str, where: str) -> List[Finding]:
    nodes = gl.kernel_nodes(gm)
    if not nodes:
        return [Finding("smem_budget", where, False, "no kernel node in a kernel mode")]
    out = []
    for i, node in enumerate(nodes):
        flavor, _, routed = _STAGED_PLANE[node.entry]
        kind = "f32" if flavor == "f32" else "other"
        allowance = routed_dispatch_allowance(kind, _n_functions(ctx, node)) if routed else 0
        suffix = f"[{i}]" if len(nodes) > 1 else ""
        out.append(check_budget(node, _report_for(ctx, node, name), where + suffix,
                                allowance))
    return out


@rule("smem_budget")
def rule_smem_budget(ctx: LintContext) -> List[Finding]:
    """What each launch stages is its flavor's smem() report, and the
    report's staging agrees with the 48 KB a block stages (the reference's
    ``vmem_budget``)."""
    out: List[Finding] = []
    kernel_budget = cuda_smem_budget()
    out.append(Finding("smem_budget", "budget:kSmemBytes", kernel_budget == SMEM_BYTES,
                       f"core SMEM_BYTES {SMEM_BYTES} B, the kernels' {kernel_budget} B"))
    for mode, name in ctx.matrix(modes=[m for m in ctx.modes if m in TABLE_MODES]):
        if mode.endswith("_ref") or mode in ("table_ref", "table_pallas"):
            continue
        for kind in ctx.kinds:
            out += _budget_findings(ctx, ctx.traced(mode, name, kind), name,
                                    f"{mode}/{name}/{kind}")
    if ctx.flash():
        for kind in ctx.kinds:
            out += _budget_findings(ctx, ctx.attn_traced(kind), "exp_neg",
                                    f"attn_exp/{kind}")
    return out


# --------------------------------------------------------------------------------------
# Rule 5 — obs-off structural identity
# --------------------------------------------------------------------------------------

def obs_identity_fingerprints(build: Callable[[], Callable], x) -> Tuple[str, str]:
    """(obs-never, obs-enabled-telemetry-off) fingerprints of one closure
    builder; the process's obs state is restored afterwards."""
    from repro_torch.obs import config as obs_config

    old = obs_config.get_config()
    try:
        obs.disable()
        fp_never = gl.fingerprint(build(), x)
        obs.configure(enabled=True, device_telemetry=False)
        fp_disabled = gl.fingerprint(build(), x)
    finally:
        obs.configure(enabled=old.enabled, device_telemetry=old.device_telemetry,
                      trace_path=old.trace_path)
    return fp_never, fp_disabled


@rule("obs_off_identity")
def rule_obs_off_identity(ctx: LintContext) -> List[Finding]:
    """Every mode's closure (and routed_fn's, attn_exp's) built with the
    telemetry off is the closure built with observability never
    configured."""
    out: List[Finding] = []
    dev = ctx.device
    foldable = [n for n in ctx.funcs if n in FOLDABLE]
    if "value" not in ctx.kinds:
        return out  # the identity is checked once a mode, with the values
    for mode in ctx.modes:
        # a member the mode can serve: folded modes run the fold only on
        # foldable names
        name = (foldable[0] if mode in FOLDED_MODES and foldable
                else ("tanh" if "tanh" in ctx.funcs else ctx.funcs[0]))
        kw = dict(mode=mode, e_a=ctx.e_a, pack_functions=ctx.pack_names,
                  pack_shards=ctx.n_shards)
        fp_never, fp_disabled = obs_identity_fingerprints(
            lambda: ApproxConfig(**kw).unary(name, dev), ctx.x(name))
        ok = fp_never == fp_disabled
        out.append(Finding(
            "obs_off_identity", f"unary:{mode}/{name}", ok,
            "" if ok else "the obs-on (telemetry off) closure differs from the "
                          "obs-never closure (the zero-overhead contract)"))
    # the routed dispatch API has its own instrumenting wrapper
    if "routed_pack" in ctx.modes:
        fns = [ctx.funcs[0], ctx.funcs[1]] * (ROWS // 2)
        xr = ctx.x(ctx.funcs[0]).reshape(ROWS, -1)
        fp_never, fp_disabled = obs_identity_fingerprints(
            lambda: ApproxConfig(mode="routed_pack", e_a=ctx.e_a,
                                 pack_functions=ctx.pack_names).routed_fn(fns, dev), xr)
        out.append(Finding("obs_off_identity", "routed_fn:routed_pack",
                           fp_never == fp_disabled,
                           "" if fp_never == fp_disabled else
                           "routed_fn's obs-off closure differs"))
    # TableFlash's attn_exp has its own telemetry wrapper
    if ctx.flash():
        fp_never, fp_disabled = obs_identity_fingerprints(
            lambda: ApproxConfig(mode="table_pack", e_a=ctx.e_a,
                                 pack_functions=ctx.pack_names,
                                 attn_table=True).attn_exp(dev), ctx.attn_x())
        out.append(Finding("obs_off_identity", "attn_exp:table_pack",
                           fp_never == fp_disabled,
                           "" if fp_never == fp_disabled else
                           "attn_exp's obs-off closure differs"))
    return out


# --------------------------------------------------------------------------------------
# One launch of every op (the ops' own checks: opcheck on the card, fake
# outputs on meta)
# --------------------------------------------------------------------------------------

# the packs op_samples builds its launches over: an f32 pack with the
# TableFlash member and RangeFold's cores, and two-member quantized,
# polynomial and sharded packs
SAMPLE_F32 = ("silu", "tanh", "exp_neg", "sin_core", "cos_core", "exp_core", "log_core")
SAMPLE_MEMBERS = ("silu", "tanh")
_SAMPLE_PACKS: Dict[tuple, tuple] = {}


def _sample_packs(device: torch.device, e_a: float):
    from repro_torch.approx import (build_pack, build_quant_pack,
                                    build_sharded_pack)

    key = (str(device), e_a)
    if key not in _SAMPLE_PACKS:
        _SAMPLE_PACKS[key] = (
            build_pack(SAMPLE_F32, e_a, device=device),
            from_spec(cached_table("silu", e_a), device),
            build_quant_pack(SAMPLE_MEMBERS, e_a, device=device),
            build_poly_pack(SAMPLE_MEMBERS, e_a, device=device),
            build_sharded_pack(SAMPLE_MEMBERS, e_a, N_SHARDS, device=device))
    return _SAMPLE_PACKS[key]


def op_samples(x: torch.Tensor, e_a: float = EA) -> Dict[str, tuple]:
    """``{entry: (planes, ints)}``: one valid launch of every op over x (its
    leading axis the routed entries' rows), from the kernel wrappers' own
    argument builders over packs built on x's device (member ``silu``,
    RangeFold's ``sin``, the routed entries' every row ``silu``)."""
    from repro_torch.kernels import routed_pack_lookup as R
    from repro_torch.kernels import table_pack_lookup as K
    from repro_torch.kernels.table_lookup import table_planes

    pk, jt, qp, pp, sp = _sample_packs(x.device, e_a)
    table = (table_planes(jt), (jt.n_intervals, jt.footprint, 0))
    S = sp.n_shards
    return {
        "tp_pack_lookup": K._pack_image_args(pk, 0, False),
        "tp_tableflash_exp": K._flash_args(pk),
        "tp_pack_grad": K._pack_image_args(pk, 0, False),
        "tp_table_lookup": table,
        "tp_table_grad": table,
        "tp_quant_lookup": K._quant_args(qp, 0, False),
        "tp_quant_grad": K._quant_args(qp, 0, False),
        "tp_poly_lookup": K._poly_args(pp, 0, False),
        "tp_poly_grad": K._poly_args(pp, 0, False),
        "tp_routed_lookup": R._routed_args(pk, "silu", x, False),
        "tp_routed_grad": R._routed_args(pk, "silu", x, False),
        "tp_routed_quant_lookup": R._routed_quant_args(qp, "silu", x, False),
        "tp_routed_quant_grad": R._routed_quant_args(qp, "silu", x, False),
        "tp_folded_lookup": K._folded_args(pk, "sin"),
        "tp_folded_grad": K._folded_args(pk, "sin"),
        "tp_routed_poly_lookup": R._routed_poly_args(pp, "silu", x, False),
        "tp_routed_poly_grad": R._routed_poly_args(pp, "silu", x, False),
        "tp_spack_lookup": K._sharded_args(sp, 0, 0, S, 0, 0),
        "tp_spack_grad": K._sharded_grad_args(sp, 0, False),
        "tp_sharded_routed_lookup": R._sharded_routed_args(sp, "silu", x, False, 0, S),
        "tp_sharded_routed_grad": R._sharded_routed_grad_args(sp, "silu", x, False),
    }
