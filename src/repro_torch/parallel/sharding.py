"""Logical-axis sharding on PyTorch: models annotate activations with
*logical* axis names; the launcher binds them to the named dims of a
``torch.distributed.device_mesh.DeviceMesh``.  Without an active binding the
annotations are no-ops, so the models run un-meshed (the JAX package's
``parallel/sharding.py``).

    with use_sharding(mesh):
        loss = model.loss(params, batch)   # params and batch DTensors

Rules map logical names -> mesh axis (or tuple of axes, or None).  The defaults
are the reference's layout: batch over ('pod', 'data'), feature / expert /
vocab / head dims over 'model', sequence unsharded.  A spec is a :class:`P`
(the port's own ``PartitionSpec``: one entry a tensor dim) and
:func:`to_placements` turns it into DTensor placements on a mesh.

The spec functions read only a mesh's axis names and sizes, so they also take
a duck-typed mesh with ``axis_names`` and ``devices`` (an array of the mesh's
shape), as the reference's do.
"""

from __future__ import annotations

import math
import sys
import threading
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Sequence

import torch

_ctx = threading.local()


class P(tuple):
    """A partition spec: one entry a tensor dim, each a mesh axis name, a
    tuple of names (major first) or None (not sharded).  A tuple of one name
    reads as the name, as in JAX's ``PartitionSpec``."""

    def __new__(cls, *axes):
        return super().__new__(cls, (a[0] if isinstance(a, tuple) and len(a) == 1
                                     else a for a in axes))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def axis_names(mesh) -> tuple:
    """A mesh's axis names: a ``DeviceMesh``'s ``mesh_dim_names`` or a duck
    mesh's ``axis_names``."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def axis_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size."""
    shape = mesh.shape if hasattr(mesh, "mesh_dim_names") else mesh.devices.shape
    return dict(zip(axis_names(mesh), (int(s) for s in shape)))


def default_rules(mesh) -> Dict[str, Any]:
    axes = axis_names(mesh)
    batch = tuple(a for a in ("pod", "data") if a in axes) or None
    model = "model" if "model" in axes else None
    # experts also shard over the pod axis on multi-pod meshes (EP=32)
    expert = (("pod", "model") if ("pod" in axes and model) else model)
    return {
        "batch": batch,
        "model": model,
        "expert": expert,
        "vocab": model,
        "heads": model,
        "ff": model,
    }


@contextmanager
def use_sharding(mesh, rules: Optional[Dict[str, Any]] = None):
    prev = getattr(_ctx, "binding", None)
    _ctx.binding = (mesh, rules or (default_rules(mesh) if mesh is not None else {}))
    try:
        yield
    finally:
        _ctx.binding = prev


def current_mesh():
    b = getattr(_ctx, "binding", None)
    return b[0] if b else None


def logical_to_spec(*logical) -> P:
    b = getattr(_ctx, "binding", None)
    rules = b[1] if b else {}
    return P(*(rules.get(l) if l is not None else None for l in logical))


def to_placements(spec: Sequence, mesh) -> List:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(i)`` on each mesh
    dim that tensor dim i names, ``Replicate()`` on the others.  A tuple of
    axes shards dim i over all of them, major first, which DTensor does in
    mesh-dim order: the tuple must follow the mesh's axis order."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    out = [Replicate() for _ in names]
    for i, ax in enumerate(spec):
        if ax is None:
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"axes {axes} of dim {i} are not in the mesh's order {names}")
        for d in dims:
            if not isinstance(out[d], Replicate):
                raise ValueError(f"mesh axis {names[d]!r} shards two dims of {spec}")
            out[d] = Shard(i)
    return out


def is_dtensor(x) -> bool:
    # no DTensor exists before its module is imported: an un-meshed run
    # never pays that import (~1 s)
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def vocab_lookup(table, tokens):
    """``table[tokens]``: a DTensor table sharded over its rows (the
    vocab) looks up on each rank's rows and the ranks' masked rows add up
    (``Partial``; one real row and zeros, exact); sharded over d, each rank
    its columns.  The tokens are replicated or batch-sharded."""
    if not is_dtensor(table):
        return table[tokens]
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = table.device_mesh
    if not is_dtensor(tokens):
        tokens = replicate_like(tokens, table)
    tp = [Replicate() if p.is_partial() else p for p in tokens.placements]
    tokens = tokens.redistribute(mesh, tp)
    rows_dims = [i for i, p in enumerate(table.placements) if p.is_shard(0)]
    chunk = chunk_index(mesh, rows_dims)
    rows = table.shape[0] // math.prod(mesh.size(i) for i in rows_dims)
    out = []
    for i, p in enumerate(table.placements):
        if i in rows_dims:
            out.append(Partial())
        elif p.is_shard():
            out.append(Shard(tokens.ndim))
        else:
            out.append(tp[i])

    def local(t, ids):
        idx = ids - chunk * rows
        ok = (idx >= 0) & (idx < rows)
        return torch.where(ok[..., None], t[torch.clamp(idx, 0, rows - 1)], 0.0)

    return on_local_shards(local, out, table, tokens)


def replicate_like(t: torch.Tensor, x):
    """``t`` as a replicated DTensor on the mesh of the DTensor ``x`` (a
    plain tensor that meets a DTensor in one operator); ``t`` itself when x
    is a plain tensor."""
    if not is_dtensor(x):
        return t
    from torch.distributed.tensor import DTensor, Replicate

    mesh = x.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def einsum(eq: str, a, b):
    """``torch.einsum(eq, a, b)``; with a DTensor operand, on the local
    shards (:func:`on_local_shards`), laid out by the letters each mesh dim
    shards: a letter both operands shard is contracted (the output
    ``Partial``) or kept (the output sharded on it), a letter one operand
    shards is kept if the other lacks it, else the other is cut to match (a
    local chunk).  A partial operand is summed first; two different letters
    on one mesh dim gather ``b``'s.  The projections of the model take this
    path, so no operator's sharding rule is needed."""
    if not (is_dtensor(a) or is_dtensor(b)):
        return torch.einsum(eq, a, b)
    from torch.distributed.tensor import Partial, Replicate, Shard

    a = a if is_dtensor(a) else replicate_like(a, b)
    b = b if is_dtensor(b) else replicate_like(b, a)
    ins, out = eq.replace(" ", "").split("->")
    la, lb = ins.split(",")
    if "..." in la:  # name the leading dims
        ell = "".join(chr(ord("A") + k) for k in range(a.ndim - len(la) + 3))
        la, out = la.replace("...", ell), out.replace("...", ell)
    mesh = a.device_mesh
    pa, pb, po = list(a.placements), list(b.placements), []
    for i in range(mesh.ndim):
        if pa[i].is_partial():
            pa[i] = Replicate()
        if pb[i].is_partial():
            pb[i] = Replicate()
        ca = la[pa[i].dim] if pa[i].is_shard() else None
        cb = lb[pb[i].dim] if pb[i].is_shard() else None
        if ca and cb and ca != cb:
            pb[i], cb = Replicate(), None
        if ca and not cb and ca in lb:
            pb[i], cb = Shard(lb.index(ca)), ca
        if cb and not ca and cb in la:
            pa[i], ca = Shard(la.index(cb)), cb
        c = ca or cb
        po.append(Replicate() if c is None else Shard(out.index(c)) if c in out
                  else Partial())
    a, b = a.redistribute(mesh, pa), b.redistribute(mesh, pb)
    return on_local_shards(lambda x, y: torch.einsum(eq, x, y), po, a, b)


def distribute(t: torch.Tensor, mesh, placements):
    """The DTensor of the whole tensor ``t`` (the same on every rank) with
    ``placements``: each rank keeps its chunk of its own copy, no traffic."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t, mesh, placements, src_data_rank=None)


def unary_on(f, x):
    """The activation ``f`` ready for ``x``: itself on a plain tensor or when
    it takes a DTensor whole (the sharded pack's mesh closure gathers it),
    else run over x's local shards (the pack closures are elementwise)."""
    if not is_dtensor(x) or getattr(f, "takes_dtensor", False):
        return f
    return lambda v: elementwise(f, v)


def axes_size(ax, mesh) -> int:
    """The product of the sizes of the mesh axes ``ax`` (a name, a tuple of
    names, or None: 1)."""
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in (ax if isinstance(ax, tuple) else (ax,))) if ax else 1


def divisible_axes(ax, mesh, n: int):
    """The mesh axes ``ax`` if their sizes' product divides ``n``, else None:
    a batch they do not divide stays replicated, as the reference's
    ``_batch_axes`` leaves ``long_500k``'s single sequence."""
    return ax if n % axes_size(ax, mesh) == 0 else None


def shard_activation(x, *logical):
    """Redistribute the DTensor ``x`` to the placements the logical axes name
    under the active binding (values never change); the identity off a
    binding and on a plain tensor.  A batch dim its axes do not divide stays
    replicated (:func:`divisible_axes`)."""
    b = getattr(_ctx, "binding", None)
    if not b or b[0] is None or not is_dtensor(x):
        return x
    mesh, rules = b

    def axes(dim, name):
        ax = rules.get(name) if name is not None else None
        return divisible_axes(ax, mesh, dim) if name == "batch" else ax

    spec = P(*(axes(d, name) for d, name in zip(x.shape, logical)))
    return x.redistribute(mesh, to_placements(spec, mesh))


def local_rank(mesh, axis: str) -> int:
    """This process's coordinate along ``axis`` (0 where the mesh lacks it)."""
    return mesh.get_local_rank(axis) if axis in axis_names(mesh) else 0


def grad_placements(in_pl, out_pl) -> tuple:
    """Where a local function's input gradient lies: an input replicated
    over a mesh dim on which the output is sharded or partial was used
    differently on each rank of that dim, so its gradient there is the sum
    of the ranks' (``Partial``); an input that is a pending sum (``Partial``)
    takes the whole gradient on every rank (``Replicate``); elsewhere the
    input's own placement."""
    from torch.distributed.tensor import Partial, Replicate

    return tuple(Partial() if isinstance(i, Replicate) and not isinstance(o, Replicate)
                 else Replicate() if isinstance(i, Partial) else i
                 for i, o in zip(in_pl, out_pl))


def on_local_shards(fn, out_placements, *args):
    """``fn(*local shards)`` through ``local_map``: every DTensor in
    ``args`` enters as its local shard, the output leaves as a DTensor with
    ``out_placements`` (a tuple of them for several outputs; the first one
    sets the input gradients' placements, :func:`grad_placements`).  For the
    operators DTensor has no propagation rule for on this path (the pack
    kernels, rotary, flash attention, the loss's one-hot): each is local to
    a shard."""
    from torch.distributed.tensor.experimental import local_map

    multi = isinstance(out_placements[0], (list, tuple))
    first = out_placements[0] if multi else out_placements
    in_pl = tuple(tuple(a.placements) if is_dtensor(a) else None for a in args)
    grad_pl = tuple(None if p is None else grad_placements(p, first) for p in in_pl)
    out_pl = (tuple(tuple(o) for o in out_placements) if multi
              else (tuple(out_placements),))
    return local_map(fn, out_placements=out_pl, in_placements=in_pl,
                     in_grad_placements=grad_pl)(*args)


def elementwise(fn, x, *rows):
    """An elementwise ``fn`` over the DTensor ``x``'s local shards (output
    placed as x); ``fn(x, *rows)`` on a plain tensor.  ``rows`` are per-row
    operands of x (dim 0 is x's dim 0, e.g. per-slot positions), each laid
    out along x's dim 0 (:func:`batch_like`), so a rank's local rows meet
    their own operand rows."""
    if not is_dtensor(x):
        return fn(x, *rows)
    if any(p.is_partial() for p in x.placements):  # a sum not yet taken
        from torch.distributed.tensor import Replicate

        x = x.redistribute(x.device_mesh, [Replicate() if p.is_partial() else p
                                           for p in x.placements])
    return on_local_shards(fn, tuple(x.placements), x, *(batch_like(r, x) for r in rows))


def chunk_index(mesh, dims) -> int:
    """This rank's chunk of a tensor dim sharded over the mesh dims ``dims``
    (indices in mesh order): its coordinates read as one mixed-radix
    number, the first dim major, which is how DTensor orders the chunks
    (the batch over ('pod', 'data') is pod-major)."""
    c = 0
    for i in dims:
        c = c * mesh.size(i) + mesh.get_local_rank(i)
    return c


class ExpertLayout:
    """Where the MoE block's tokens, experts and (E, C, d) dispatch buffer
    lie on a mesh (expert parallelism; ``models.mlp.moe`` on DTensors).

    The tokens lie over the *batch* dims (those that shard x's rows), the
    experts over the *expert* dims (the 'expert' rule's axes, where they
    divide E; E_loc experts a rank).  A dim in both (the 'pod' axis of
    2x16x16) is *shared*; the expert dims outside the batch make a rank's
    *column*, the batch dims outside the experts its *rows*.  The ranks of
    one batch chunk hold the same tokens, and a rank takes the slots of
    its column's E_col = E_loc x n_shared experts.  The buffer is handled
    in a 4-D view (n_shared, n_column x E_loc, C_pad, d), C_pad being the
    capacity rounded up to a multiple of the rows' ranks:

      * ``partial``: each rank's own slots written into its column's zero
        buffer, a sum over the batch dims (disjoint rows: x + 0 = x);
      * ``rows``: after the reduce-scatter over the batch dims, the rank's
        own experts (its shared block) and C_pad / n_rows of their rows;
      * ``column``: after the all-gather over the batch dims, every row of
        the column's experts, for the combine, whose output is a sum over
        the column dims (``combined``).

    Expert weights lie as ``weights``: the expert dims shard E, in mesh
    order (``param_pspecs``' ('pod', 'model')).  Dims in neither set (a
    batch that does not divide them) repeat the same work."""

    def __init__(self, mesh, batch, n_experts: int, capacity: int,
                 rules: Optional[Dict[str, Any]] = None):
        """``batch``: the indices of the mesh dims that shard the tokens;
        ``rules``: the logical rules (the active binding's by default)."""
        from torch.distributed.tensor import Partial, Replicate, Shard

        self.mesh = mesh
        names = axis_names(mesh)
        if rules is None:
            b = getattr(_ctx, "binding", None)
            rules = b[1] if b and b[0] is not None else default_rules(mesh)
        ex = divisible_axes(rules.get("expert"), mesh, n_experts)
        ex = () if ex is None else ex if isinstance(ex, tuple) else (ex,)
        batch = tuple(batch)
        expert = tuple(i for i, n in enumerate(names) if n in ex)
        self.batch, self.expert = batch, expert
        shared = tuple(i for i in expert if i in batch)
        column = tuple(i for i in expert if i not in batch)
        rows = tuple(i for i in batch if i not in expert)
        size = lambda dims: math.prod(mesh.size(i) for i in dims)
        self.n_shared, self.n_rows = size(shared), size(rows)
        self.e_loc = n_experts // size(expert)
        self.e_col = self.e_loc * self.n_shared
        self.c_pad = -(-capacity // self.n_rows) * self.n_rows
        self.chunk = chunk_index(mesh, batch)
        self._column = column
        ndim = mesh.ndim
        R = Replicate()
        self.replicated = [R] * ndim
        self.tokens = [Shard(0) if i in batch else R for i in range(ndim)]
        self.weights = [Shard(0) if i in expert else R for i in range(ndim)]
        self.partial_sum = [Partial() if i in batch else R for i in range(ndim)]
        self.partial = [Partial() if i in batch else Shard(1) if i in column else R
                        for i in range(ndim)]
        self.rows = [Shard(0) if i in shared else Shard(2) if i in rows
                     else Shard(1) if i in column else R for i in range(ndim)]
        self.column = [Shard(1) if i in column else R for i in range(ndim)]
        self.combined = [Shard(0) if i in batch else Partial() if i in column else R
                         for i in range(ndim)]

    @classmethod
    def of(cls, x, n_experts: int, capacity: int) -> "ExpertLayout":
        """The layout of the MoE block's input ``x`` (a DTensor: its rows
        lie over the mesh dims that shard its dim 0)."""
        return cls(x.device_mesh, (i for i, p in enumerate(x.placements) if p.is_shard(0)),
                   n_experts, capacity)

    def column_slots(self, n_experts: int, device) -> torch.Tensor:
        """(E,) int64: each expert's slot among this rank's column's E_col
        experts (shared block major, then the expert within its block), -1
        for the experts of other columns."""
        mesh = self.mesh
        e = torch.arange(n_experts, device=device)
        block = torch.div(e, self.e_loc, rounding_mode="floor")
        mine = torch.ones_like(e, dtype=torch.bool)
        shared = torch.zeros_like(e)
        stride = math.prod(mesh.size(i) for i in self.expert)
        for i in self.expert:  # the block's coordinate on each expert dim
            stride //= mesh.size(i)
            coord = torch.div(block, stride, rounding_mode="floor") % mesh.size(i)
            if i in self._column:
                mine &= coord == mesh.get_local_rank(i)
            else:
                shared = shared * mesh.size(i) + coord
        return torch.where(mine, shared * self.e_loc + e % self.e_loc, -1)


def batch_like(t, x):
    """``t``, whose dim 0 runs along the DTensor ``x``'s dim 0 (a batch of
    per-slot positions (B, S) against activations (B, S, ...)), as a DTensor
    on x's mesh sharded on dim 0 where x's dim 0 is and replicated
    elsewhere.  A plain ``t`` (the same on every rank) is cut without
    traffic; a DTensor one is redistributed."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = x.device_mesh
    pl = [Shard(0) if p.is_shard(0) else Replicate() for p in x.placements]
    if is_dtensor(t):
        return t.redistribute(mesh, pl)
    return distribute(t, mesh, pl)


# ---------------- ShardedTablePack operand rules -------------------------------
#
# The sharded pack stacks one values slice (and one local_base / owned plane
# pair) per shard on a leading axis that lays over the mesh 'model' axis; the
# selector metadata is replicated.  Placed with these specs each rank holds ONE
# slice, not S.


def sharded_pack_pspecs(mesh) -> Dict[str, P]:
    """Partition specs of the :class:`repro_torch.approx.ShardedTablePack`
    planes the reference's pack has: the leading (shard) axis of
    ``local_base`` / ``owned`` / ``values`` maps to 'model';
    ``boundaries`` / ``inv_delta`` / ``seg_count`` replicate."""
    model = "model" if "model" in axis_names(mesh) else None
    return {
        "boundaries": P(None, None),
        "inv_delta": P(None, None),
        "seg_count": P(None, None),
        "local_base": P(model, None, None),
        "owned": P(model, None, None),
        "values": P(model, None),
    }


def mesh_device(mesh) -> torch.device:
    """The device this rank's shards of ``mesh`` live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def place_sharded_pack(pack, mesh):
    """The ShardedTablePack as this rank holds it on ``mesh``: ONE shard's
    values slice and plane pair (its shard is the rank's 'model'
    coordinate), the replicated selector planes, and the owner plane
    remapped to the one local slice (0 where this shard owns the
    sub-interval, -1 elsewhere).  The whole-pack owner planes and the grads'
    staging image are not kept.  Requires ``mesh``'s 'model' axis to be
    ``pack.n_shards`` wide.  The placed pack evaluates on its mesh
    (``approx.table_pack.eval_sharded_mesh``) whether or not a binding is
    active: the rank lacks the other slices."""
    import dataclasses

    if "model" not in axis_names(mesh):
        raise ValueError(f"mesh {axis_names(mesh)} has no 'model' axis")
    width = axis_sizes(mesh)["model"]
    if width != pack.n_shards:
        raise ValueError(f"mesh 'model' axis is {width} wide but the pack has "
                         f"{pack.n_shards} shards")
    if pack.mesh is not None:
        if pack.mesh is mesh:
            return pack
        raise ValueError("the pack is placed on another mesh already")
    s = local_rank(mesh, "model")
    dev = mesh_device(mesh)
    own = pack.owned[s: s + 1].to(dev).contiguous()
    base = pack.local_base[s: s + 1].to(dev).contiguous()
    return dataclasses.replace(
        pack,
        boundaries=pack.boundaries.to(dev), inv_delta=pack.inv_delta.to(dev),
        seg_count=pack.seg_count.to(dev), local_base=base, owned=own,
        values=pack.values[s: s + 1].to(dev).contiguous(),
        owner=torch.where(own[0] > 0, 0.0, -1.0).contiguous(),
        owner_base=base[0].clone(),
        routing=tuple(t.to(dev) for t in pack.routing),
        image=None, mesh=mesh, first_shard=s, _extr_operands={})
