"""Graph-level lint primitives of PackLint (see ``repro_torch.analysis.contracts``),
the counterpart of the reference's ``jaxpr_lint``.

Everything here works on ``make_fx`` graphs and never runs a kernel.  A
closure is traced over ``meta`` tensors (:func:`trace`): the packs' planes
live on ``meta`` too, each kernel launch is one node of a ``repro_torch`` op
(:mod:`repro_torch.kernels.ops`), and every node's ``meta["val"]`` carries
its dtype and shape.  The meta trace runs under a fake-tensor mode with a
shape environment, so that a read of a device scalar or an op whose output
shape depends on the data shows up as a node (``aten._local_scalar_dense``,
an unbacked symbolic size) instead of stopping the trace.  On the card the
same closures trace over real CUDA tensors, and their fingerprints, devices
masked, are the meta ones.

The helpers answer structural questions about a graph:

- which nodes and targets appear, and which dtypes (nodes' values and the
  graph's tensor constants): the f64 lint;
- where the kernel nodes are, with their operands' (shape, dtype, stride)
  and their int arguments: the kernel, recompile-hazard and shared-memory
  lints;
- which nodes read the device on the host or have data-dependent or
  symbolic shapes: the kernel lint's closure clause;
- a fingerprint of the graph's code: the obs-off identity lint.
"""

from __future__ import annotations

import operator
import re
from dataclasses import dataclass
from typing import Any, Callable, Iterator, List, Tuple

import numpy as np
import torch
from torch.fx.experimental.proxy_tensor import make_fx

from repro_torch.kernels import ops

# Dtypes that must never appear in a runtime graph: the design layer
# (core/design.py, core/quantize.py) works in f64 on purpose, and one leaked
# f64 plane doubles the bytes a kernel stages and moves, or makes a kernel
# argument of a type no kernel takes.
WIDE_DTYPES = frozenset({torch.float64, torch.complex128})

# ops that read the device on the host or whose output shape depends on
# the data (an obs-off serving closure must hold none)
_SYNC_OPS = frozenset({
    "aten::_local_scalar_dense", "aten::item", "aten::nonzero", "aten::nonzero_static",
    "aten::masked_select", "aten::_assert_async", "aten::_assert_scalar",
    "aten::equal", "aten::is_nonzero",
})


# --------------------------------------------------------------------------------------
# Tracing
# --------------------------------------------------------------------------------------


def _tensors(args) -> Iterator[torch.Tensor]:
    for a in args:
        if isinstance(a, torch.Tensor):
            yield a
        elif isinstance(a, (list, tuple)):
            yield from _tensors(a)
        elif isinstance(a, dict):
            yield from _tensors(a.values())


def trace(fn: Callable, *args) -> torch.fx.GraphModule:
    """``make_fx`` graph of ``fn(*args)``: over ``meta`` tensors under a
    fake-tensor mode with a shape environment (nothing runs; a host read or
    a data-dependent shape becomes a node), otherwise over the real tensors
    (on the card: the kernels run)."""
    ts = list(_tensors(args))
    call = lambda *a: fn(*a)  # noqa: E731  (make_fx reads fn's signature)
    if not ts or any(t.device.type != "meta" for t in ts):
        return make_fx(call)(*args)
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.symbolic_shapes import ShapeEnv

    mode = FakeTensorMode(shape_env=ShapeEnv(), allow_non_fake_inputs=True)

    def fake(a):
        if isinstance(a, torch.Tensor):
            return mode.from_tensor(a, static_shapes=True)
        if isinstance(a, (list, tuple)):
            return type(a)(fake(v) for v in a)
        if isinstance(a, dict):
            return {k: fake(v) for k, v in a.items()}
        return a

    with mode:
        return make_fx(call)(*(fake(a) for a in args))


# --------------------------------------------------------------------------------------
# Walkers
# --------------------------------------------------------------------------------------


def target_name(target) -> str:
    """``aten::mul`` for an op overload, the qualified name of anything else."""
    if isinstance(target, torch._ops.OpOverload):
        return target._schema.name
    if isinstance(target, str):
        return target
    return getattr(target, "__qualname__", None) or repr(target)


def nodes(gm: torch.fx.GraphModule) -> List[Tuple[str, str]]:
    """Every node as (op, target name), in graph order."""
    return [(n.op, target_name(n.target)) for n in gm.graph.nodes]


def _vals(v) -> Iterator[Any]:
    if isinstance(v, (list, tuple)):
        for u in v:
            yield from _vals(u)
    elif v is not None:
        yield v


def constants(gm: torch.fx.GraphModule) -> List[Tuple[str, torch.Tensor]]:
    """The graph's tensor constants (its ``get_attr`` nodes): the packs'
    planes a closure captured."""
    out = []
    for n in gm.graph.nodes:
        if n.op == "get_attr":
            c = getattr(gm, n.target)
            if isinstance(c, torch.Tensor):
                out.append((n.target, c))
    return out


def dtypes(gm: torch.fx.GraphModule) -> List[Tuple[str, torch.dtype]]:
    """(where, dtype) of every tensor value of every node and every tensor
    constant of the graph."""
    out = []
    for n in gm.graph.nodes:
        for v in _vals(n.meta.get("val")):
            if isinstance(v, torch.Tensor):
                out.append((f"{n.op}:{target_name(n.target)}", v.dtype))
    out += [(f"const:{name}", c.dtype) for name, c in constants(gm)]
    return out


def find_wide_dtypes(gm: torch.fx.GraphModule,
                     wide: frozenset = WIDE_DTYPES) -> List[str]:
    """Every place a forbidden-width dtype appears in the graph
    (``"call_function:aten::mul: torch.float64"``); empty means clean."""
    return [f"{where}: {dt}" for where, dt in dtypes(gm) if dt in wide]


def leaf_wide_dtypes(obj, wide: frozenset = WIDE_DTYPES, path: str = "") -> List[str]:
    """Wide-dtype tensor or array leaves of a pack (a dataclass of tensors,
    tuples and dicts), by path."""
    if isinstance(obj, torch.Tensor):
        return [f"{path}: {obj.dtype}"] if obj.dtype in wide else []
    if isinstance(obj, np.ndarray):
        return [f"{path}: {obj.dtype}"] if obj.dtype in (np.float64, np.complex128) else []
    if isinstance(obj, dict):
        return [h for k, v in obj.items() for h in leaf_wide_dtypes(v, wide, f"{path}[{k!r}]")]
    if isinstance(obj, (list, tuple)):
        return [h for i, v in enumerate(obj)
                for h in leaf_wide_dtypes(v, wide, f"{path}[{i}]")]
    fields = getattr(obj, "__dataclass_fields__", None)
    if fields:
        return [h for f in fields
                for h in leaf_wide_dtypes(getattr(obj, f), wide, f"{path}.{f}")]
    return []


@dataclass(frozen=True)
class KernelNode:
    """One kernel launch in a graph: its entry (``_ENTRIES`` name), x's and
    each plane's (shape, dtype, stride), and its int arguments: the launch's
    signature (one compiled kernel and one CUDA graph serve equal ones)."""

    entry: str
    x: Tuple[Tuple[int, ...], torch.dtype, Tuple[int, ...]]
    planes: Tuple[Tuple[Tuple[int, ...], torch.dtype, Tuple[int, ...]], ...]
    ints: Tuple[int, ...]

    @property
    def signature(self) -> tuple:
        return (self.entry, self.x, self.planes, self.ints)

    def plane_bytes(self, i: int) -> int:
        shape, dt, _ = self.planes[i]
        return int(np.prod(shape, dtype=np.int64)) * torch.empty((), dtype=dt).element_size()


def _meta_of(node) -> Tuple[Tuple[int, ...], torch.dtype, Tuple[int, ...]]:
    v = node.meta["val"]
    return (tuple(int(d) for d in v.shape), v.dtype, tuple(int(s) for s in v.stride()))


def kernel_nodes(gm: torch.fx.GraphModule) -> List[KernelNode]:
    """Every ``repro_torch`` op node of the graph, in graph order."""
    out = []
    for n in gm.graph.nodes:
        if n.op == "call_function" and ops.is_kernel_op(n.target):
            x, planes, ints = n.args
            out.append(KernelNode(ops.entry_of(n.target), _meta_of(x),
                                  tuple(_meta_of(p) for p in planes),
                                  tuple(int(i) for i in ints)))
    return out


def host_syncs(gm: torch.fx.GraphModule) -> List[str]:
    """Nodes that read the device on the host, have a data-dependent output
    (``nonzero``, ``masked_select``, ``unique``) or call back into Python
    (a call target that is no op)."""
    bad = []
    for n in gm.graph.nodes:
        if n.op != "call_function":
            continue
        if isinstance(n.target, torch._ops.OpOverload):
            name = n.target._schema.name
            if name in _SYNC_OPS or name.startswith(("aten::unique", "aten::_unique")):
                bad.append(name)
        elif n.target is not operator.getitem:
            bad.append(f"python:{target_name(n.target)}")
    return bad


def symbolic_shapes(gm: torch.fx.GraphModule) -> List[str]:
    """Node values whose shape (or which themselves) are symbolic: a
    data-dependent size or a dynamic dimension."""
    bad = []
    for n in gm.graph.nodes:
        for v in _vals(n.meta.get("val")):
            if isinstance(v, (torch.SymInt, torch.SymFloat, torch.SymBool)):
                bad.append(f"{target_name(n.target)}: {v}")
            elif isinstance(v, torch.Tensor) and not all(
                    isinstance(d, int) for d in v.shape):
                bad.append(f"{target_name(n.target)}: {tuple(v.shape)}")
    return bad


# --------------------------------------------------------------------------------------
# Fingerprints
# --------------------------------------------------------------------------------------

_CONST_RE = re.compile(r"_tensor_constant\d+")
_DEVICE_RE = re.compile(r"device\(type='[a-z]+'(?:, index=\d+)?\)|'(?:cuda|meta|cpu)(?::\d+)?'")
_ADDR_RE = re.compile(r"0x[0-9a-f]+")


def graph_fingerprint(gm: torch.fx.GraphModule) -> str:
    """The graph's code with its constants' names, its devices and object
    addresses masked: two closures print the same iff they trace to the
    same ops on the same kinds of operands, on any device."""
    code = _CONST_RE.sub("_tensor_constant_", gm.code)
    return _ADDR_RE.sub("0x_", _DEVICE_RE.sub("device(_)", code))


def fingerprint(fn: Callable, *args) -> str:
    """The fingerprint of ``fn``'s steady graph: a closure's first call may
    build operands its pack caches (the routed extrapolate flags), so it is
    traced once first and fingerprinted on its second trace, the graph
    every later call runs."""
    trace(fn, *args)
    return graph_fingerprint(trace(fn, *args))
