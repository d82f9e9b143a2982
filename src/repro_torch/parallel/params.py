"""Parameter / optimizer-state partition specs (the JAX package's
``parallel/params.py``).

Specs are inferred from leaf *paths* (regex rules over the tree path) with the
logical->physical binding of ``sharding.default_rules``.  A dim is only sharded
if its size divides by the axis size; a rule may list fallback templates (the
first whose sharded dims all divide wins).

The port keeps a stacked layer as a list of per-layer dicts where the
reference stacks it on leading axes.  The spec functions read the port's tree in
the reference's layout (:func:`stacked_view`): a list of layers is one leaf
with the list lengths as leading dims, the list indices leave the path, and
an attention ``wo`` (g_eff, q_per_group, D, d) reads as the reference's
(h_eff, D, d).  So the spec trees are the reference's, path for path; rules
match the TRAILING dims and the stacked prefix is replicated, except where
ZeRO-1 / FSDP shard a leading layer axis.  :func:`shardings_from_specs` maps
a spec back onto the port's per-layer tensors (:func:`port_spec`).

ZeRO-1 (``zero1_pspecs``): optimizer moments additionally shard their first
still-unsharded, large-enough dim over the data axis, so AdamW state is spread
over the whole mesh instead of only the model axis.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np

from repro_torch.tree import leaves_with_path, subtree, unflatten

from .sharding import P, axis_names, axis_sizes, default_rules, to_placements

# (path regex, trailing-dims logical template OR list of fallback templates —
# first template whose sharded dims all divide evenly wins)
_RULES: Tuple[Tuple[str, Any], ...] = (
    # vocab-sharded embeddings; odd vocabs (whisper 51865, internvl 151655) fall
    # back to sharding d_model
    (r"(embed|unembed)/table$", [("vocab", None), (None, "model")]),
    (r"vis_proj/w$", (None, None)),
    # attention
    (r"(attn|self|cross)/wq/w$", (None, "heads", None)),
    (r"(attn|self|cross)/wk/w$", (None, "heads", None)),
    (r"(attn|self|cross)/wv/w$", (None, "heads", None)),
    (r"(attn|self|cross)/wo/w$", ("heads", None, None)),
    (r"(attn|self|cross)/[qk]n/g$", (None,)),
    # dense FFN (GLU or plain)
    (r"(mlp|shared)/w[iu]/w$", (None, "ff")),
    (r"(mlp|shared)/wd/w$", ("ff", None)),
    # MoE
    (r"experts/w[iu]$", ("expert", None, None)),
    (r"experts/wd$", ("expert", None, None)),
    (r"router/w$", (None, None)),
    # Mamba2
    (r"m/in_[zx]/w$", (None, "ff")),
    (r"m/in_[bc]/w$", (None, None)),  # state projections are tiny: replicate
    (r"m/in_dt/w$", (None, "ff")),
    (r"m/conv_x/w$", (None, "ff")),
    (r"m/conv_[bc]/w$", (None, None)),
    (r"m/(dt_bias|a_log|d_skip)$", ("ff",)),
    (r"m/norm/g$", ("ff",)),
    (r"m/out/w$", ("ff", None)),
    # xLSTM
    (r"b/w[qkv]/w$", (None, "model")),
    (r"b/wog/w$", (None, "model")),
    (r"b/w[if]/w$", (None, None)),
    (r"b/wo/w$", ("model", None)),
    (r"b/wd/w$", ("model", None)),
    (r"b/[rw][zifo]/w$", (None, "model")),
)

# an attention block's output projection: (g_eff, q_per_group, D, d) in the
# port, (h_eff, D, d) in the reference
_WO = re.compile(r"(attn|self|cross)/wo/w$")


@dataclass(frozen=True)
class Leaf:
    """A leaf as the reference sees it: its shape with the stacked-layer
    dims in front (``n_prefix`` of them), and its element size."""

    shape: Tuple[int, ...]
    itemsize: int
    n_prefix: int = 0

    @property
    def ndim(self) -> int:
        return len(self.shape)


def _is_index(k: str) -> bool:
    return k.isdigit()


def path_str(path) -> str:
    """A port tree path as the reference's: list indices (stacked-layer
    positions) left out."""
    return "/".join(k for k in path if not _is_index(k))


def stacked_view(tree) -> Dict[str, Leaf]:
    """The port's tree as the reference's stacked tree: reference path ->
    :class:`Leaf`.  Every layer of a stack must have the same leaf shapes."""
    out: Dict[str, Leaf] = {}
    for path, t in leaves_with_path(tree):
        ps = path_str(path)
        shape = tuple(int(d) for d in t.shape)
        if _WO.search(ps) and len(shape) == 4:
            shape = (shape[0] * shape[1],) + shape[2:]
        prefix = []
        node = tree
        for k in path:
            if _is_index(k):
                prefix.append(len(node))
            node = node[int(k)] if _is_index(k) else node[k]
        leaf = Leaf(tuple(prefix) + shape, t.element_size(), len(prefix))
        if out.setdefault(ps, leaf) != leaf:
            raise ValueError(f"layers of {ps} differ: {out[ps]} vs {leaf}")
    return out


def _nest(flat: Dict[str, Any]) -> Dict[str, Any]:
    """Reference path -> value, as nested dicts."""
    root: Dict[str, Any] = {}
    for ps, v in flat.items():
        *heads, last = ps.split("/")
        node = root
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = v
    return root


def _flat(tree, prefix: str = "") -> Dict[str, Any]:
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, p))
        else:
            out[p] = v
    return out


def _axis_size(ax, sizes) -> int:
    return int(np.prod([sizes[a] for a in (ax if isinstance(ax, tuple) else (ax,))]))


def _try_template(template, shape, rules, sizes):
    """Returns (spec, clean): clean=True iff every templated axis divided evenly."""
    n_extra = len(shape) - len(template)
    if n_extra < 0:
        return None, False
    spec = [None] * n_extra
    clean = True
    for dim, logical in zip(shape[n_extra:], template):
        ax = rules.get(logical) if logical else None
        if ax is not None and dim % _axis_size(ax, sizes) != 0:
            ax = None
            clean = False
        spec.append(ax)
    return P(*spec), clean


def _spec_for(ps: str, shape, rules, sizes) -> P:
    for pat, templates in _RULES:
        if re.search(pat, ps):
            if isinstance(templates, tuple):
                templates = [templates]
            first = None
            for template in templates:
                spec, clean = _try_template(template, shape, rules, sizes)
                if spec is None:
                    continue
                if first is None:
                    first = spec
                if clean:
                    return spec
            return first if first is not None else P()
    return P()  # replicate


# Optional FSDP-at-use, as the reference: leaves whose per-device footprint
# (after model sharding) exceeds the threshold get a second dim sharded over
# the data axis.  Disabled by default (0): large models use weight-update
# sharding instead (train.loop: the f32 master fully 2D-sharded, one cast and
# redistribute to the TP work layout a step).
FSDP_THRESHOLD_BYTES = 0


def param_pspecs(params, mesh, rules: Optional[Dict[str, Any]] = None,
                 fsdp_threshold: int = FSDP_THRESHOLD_BYTES):
    """Spec tree (the reference's layout, :func:`stacked_view`) of the
    parameter tree ``params`` (tensors of any device, ``"meta"`` included).

    Primary axis assignment is rule-based (TP); any leaf still larger than
    ``fsdp_threshold`` per device additionally shards its largest free dim
    over the data axis."""
    rules = rules or default_rules(mesh)
    sizes = axis_sizes(mesh)
    data_axes = rules.get("batch")
    dsize = _axis_size(data_axes, sizes) if data_axes is not None else 1

    def assign(ps, leaf: Leaf):
        spec = _spec_for(ps, leaf.shape, rules, sizes)
        if data_axes is None or fsdp_threshold <= 0:
            return spec
        spec_t = tuple(spec) + (None,) * (leaf.ndim - len(spec))
        shards = int(np.prod([_axis_size(s, sizes) for s in spec_t
                              if s is not None] or [1]))
        per_dev = int(np.prod(leaf.shape)) * leaf.itemsize / shards
        if per_dev <= fsdp_threshold:
            return spec
        free = [(leaf.shape[i], i) for i in range(leaf.ndim)
                if spec_t[i] is None and leaf.shape[i] % dsize == 0]
        if not free:
            return spec
        _, dim = max(free)
        out = list(spec_t)
        out[dim] = data_axes
        return P(*out)

    return _nest({ps: assign(ps, leaf) for ps, leaf in stacked_view(params).items()})


def fsdp_pspecs(params, mesh):
    """Pure-FSDP (ZeRO-3) specs: every leaf's largest divisible dim shards
    over the FLAT device mesh (all axes); no tensor parallelism."""
    sizes = axis_sizes(mesh)
    all_axes = axis_names(mesh)
    total = int(np.prod(list(sizes.values())))

    def assign(leaf: Leaf):
        dims = sorted(range(leaf.ndim), key=lambda i: -leaf.shape[i])
        for i in dims:
            if leaf.shape[i] % total == 0:
                spec = [None] * leaf.ndim
                spec[i] = all_axes
                return P(*spec)
        for ax in all_axes:  # fall back to a single-axis shard
            for i in dims:
                if leaf.shape[i] % sizes[ax] == 0:
                    spec = [None] * leaf.ndim
                    spec[i] = ax
                    return P(*spec)
        return P()

    return _nest({ps: assign(leaf) for ps, leaf in stacked_view(params).items()})


def zero1_pspecs(params, mesh, rules: Optional[Dict[str, Any]] = None):
    """Optimizer-moment specs: param spec + first free dim sharded over data."""
    rules = rules or default_rules(mesh)
    sizes = axis_sizes(mesh)
    data_axes = rules.get("batch")
    base = param_pspecs(params, mesh, rules)
    if data_axes is None:
        return base
    d_axes = data_axes if isinstance(data_axes, tuple) else (data_axes,)
    dsize = _axis_size(data_axes, sizes)
    base_flat = _flat(base)

    def extend(ps, leaf: Leaf):
        spec = base_flat[ps]
        spec_t = tuple(spec) + (None,) * (leaf.ndim - len(spec))
        flat = [a for s in spec_t if s is not None
                for a in (s if isinstance(s, tuple) else (s,))]
        if any(a in flat for a in d_axes):
            return P(*spec_t)  # FSDP'd leaf: data axis already in use
        out = list(spec_t)
        for i, (dim, s) in enumerate(zip(leaf.shape, spec_t)):
            if s is None and dim % dsize == 0 and dim >= dsize:
                out[i] = data_axes
                break
        return P(*out)

    return _nest({ps: extend(ps, leaf) for ps, leaf in stacked_view(params).items()})


def port_spec(spec, leaf: Leaf, shape, sizes) -> P:
    """The spec of one of the port's per-layer tensors (``shape``) from the
    stacked ``spec`` of its reference leaf: the stacked prefix dropped, a
    ``wo``'s heads entry on its group dim (the reference's (h_eff, D, d) is
    the port's (g_eff, q_per_group, D, d)), and an axis that sharded the
    layer axis (ZeRO-1 / FSDP: whole layers to a rank, which a per-layer
    tensor cannot express) moved to the tensor's first unsharded dim that it
    divides, or dropped if none does."""
    spec_t = tuple(spec) + (None,) * (leaf.ndim - len(spec))
    prefix, trail = spec_t[:leaf.n_prefix], list(spec_t[leaf.n_prefix:])
    if len(shape) == len(trail) + 1:  # wo: heads -> groups
        ax = trail[0]
        if ax is not None and shape[0] % _axis_size(ax, sizes):
            ax = None
        trail = [ax, None] + trail[1:]
    for ax in prefix:
        if ax is None:
            continue
        for i, (dim, s) in enumerate(zip(shape, trail)):
            if s is None and dim % _axis_size(ax, sizes) == 0:
                trail[i] = ax
                break
    return P(*trail)


def port_specs(spec_tree, like, mesh):
    """:func:`port_spec` of every tensor of the port's tree ``like``, in its
    structure, from a spec tree in the reference's layout."""
    sizes = axis_sizes(mesh)
    view = stacked_view(like)
    flat = _flat(spec_tree)
    return unflatten(like, [port_spec(flat[path_str(p)], view[path_str(p)],
                                      tuple(t.shape), sizes)
                            for p, t in leaves_with_path(like)])


def shardings_from_specs(mesh, spec_tree, like):
    """DTensor placements for every tensor of the port's tree ``like`` (its
    structure), from a spec tree in the reference's layout."""
    specs = port_specs(spec_tree, like, mesh)
    return unflatten(like, [to_placements(subtree(specs, p), mesh)
                            for p, _ in leaves_with_path(like)])


__all__ = ["FSDP_THRESHOLD_BYTES", "Leaf", "fsdp_pspecs", "param_pspecs", "path_str",
           "port_spec", "port_specs", "shardings_from_specs", "stacked_view",
           "zero1_pspecs"]
