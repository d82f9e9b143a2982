"""Feed-forward blocks: gated-linear-unit MLP, the plain 2-matrix MLP and the
fine-grained MoE.

The MoE is the JAX package's sort-based capacity dispatch (no custom kernel):
top-k routing -> stable sort of (token, expert) slots by expert -> scatter into
a static (E, C, d) buffer -> grouped products -> each token's weighted slot
outputs gathered and summed back.  All nonlinearities route through the
paper's table backend via ``act``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.parallel.sharding import (ExpertLayout, distribute, is_dtensor,
                                           on_local_shards, unary_on)

from .common import Params, init_linear, linear


def init_glu(gen: torch.Generator, d_model: int, d_ff: int,
             dtype=torch.float32) -> Params:
    return {
        "wi": init_linear(gen, d_model, d_ff, dtype=dtype),  # gate branch
        "wu": init_linear(gen, d_model, d_ff, dtype=dtype),  # linear branch
        "wd": init_linear(gen, d_ff, d_model, dtype=dtype),
    }


def glu(p: Params, x: torch.Tensor, act: Callable) -> torch.Tensor:
    return linear(p["wd"], act(linear(p["wi"], x)) * linear(p["wu"], x))


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int,
             dtype=torch.float32) -> Params:
    """Plain 2-matrix MLP (whisper/starcoder style)."""
    return {
        "wi": init_linear(gen, d_model, d_ff, dtype=dtype),
        "wd": init_linear(gen, d_ff, d_model, dtype=dtype),
    }


def mlp(p: Params, x: torch.Tensor, act: Callable) -> torch.Tensor:
    return linear(p["wd"], act(linear(p["wi"], x)))


# ----------------------------------- MoE --------------------------------------


def init_moe(gen: torch.Generator, d_model: int, d_ff: int, n_experts: int,
             n_shared: int, dtype=torch.float32) -> Params:
    """Router (d, E) f32 and experts ``wi``/``wu`` (E, d, f), ``wd`` (E, f, d),
    N(0, 0.02), and ``n_shared`` always-on experts as one GLU of width
    ``n_shared * d_ff`` — the reference's tree and scales."""
    normal = lambda shape, dt: torch.randn(shape, generator=gen, device=gen.device,
                                           dtype=dt).mul_(0.02)
    p = {
        "router": {"w": normal((d_model, n_experts), torch.float32)},
        "experts": {
            "wi": normal((n_experts, d_model, d_ff), dtype),
            "wu": normal((n_experts, d_model, d_ff), dtype),
            "wd": normal((n_experts, d_ff, d_model), dtype),
        },
    }
    if n_shared:
        p["shared"] = init_glu(gen, d_model, n_shared * d_ff, dtype)
    return p


def moe_route(router_w: torch.Tensor, xt: torch.Tensor, *, top_k: int,
              device_groups: int = 0, max_groups: int = 0):
    """Routing of the (T, d) tokens ``xt`` in f32: the softmax probabilities
    (T, E) (zero outside each token's ``max_groups`` best of ``device_groups``
    contiguous expert groups, when that restriction is on), the top-k
    expert ids (T, k) in descending probability, ties to the lower id as
    ``jax.lax.top_k`` breaks them, and their gates normalised to sum 1."""
    logits = torch.einsum("td,de->te", xt.to(torch.float32),
                          router_w.to(torch.float32))
    probs = torch.softmax(logits, dim=-1)
    T, E = probs.shape
    if device_groups and max_groups and max_groups < device_groups:
        per = E // device_groups
        group_score = probs.reshape(T, device_groups, per).amax(-1)  # (T, G)
        top_g = _top_k(group_score, max_groups)[1]
        allowed = torch.zeros((T, device_groups), dtype=torch.bool,
                              device=probs.device).scatter(1, top_g, True)
        probs = torch.where(allowed.repeat_interleave(per, dim=1), probs, 0.0)
    gate, eidx = _top_k(probs, top_k)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    return probs, gate, eidx


def _top_k(x: torch.Tensor, k: int):
    """The k largest along the last axis, descending, equal values in
    ascending index order (``jax.lax.top_k``'s order; ``torch.topk``
    promises none): a stable descending sort."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_capacity(n_tokens: int, top_k: int, n_experts: int,
                 capacity_factor: float) -> int:
    """Slots each expert takes of ``n_tokens`` tokens' top-k routing."""
    return int(capacity_factor * n_tokens * top_k / n_experts) + 1


def moe_dispatch(eidx: torch.Tensor, n_experts: int, capacity: int,
                 offset: Optional[torch.Tensor] = None):
    """Sort-based dispatch of the T*k (token, expert) slots of ``eidx`` (T, k):
    ``order`` (stable argsort of the slots by expert) and ``dest`` (each
    sorted slot's row of the (E*C) buffer; slots past an expert's
    ``capacity`` are dropped to the scratch row E*C).  ``offset`` (E,): the
    slots that earlier tokens hold of each expert, when ``eidx`` is one
    chunk of a batch (a data rank's), so that ``dest`` is the whole batch's."""
    flat_e = eidx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    # rank of each sorted slot within its expert group
    ranks = (torch.arange(flat_e.numel(), device=eidx.device)
             - torch.searchsorted(sorted_e, sorted_e))
    if offset is not None:
        ranks = ranks + offset[sorted_e]
    dest = torch.where(ranks < capacity, sorted_e * capacity + ranks,
                       n_experts * capacity)
    return order, dest


def moe_combine(ye: torch.Tensor, order: torch.Tensor, dest: torch.Tensor,
                gate: torch.Tensor, eidx: torch.Tensor) -> torch.Tensor:
    """The (T, d) sum over each token's k slots of its gate times its expert's
    output row of ``ye`` (E, C, d), read through the sorted slots' ``dest``
    (the scratch row E*C, a dropped slot's, reads zeros), in ``ye``'s dtype.

    The reference adds the expert-sorted slots into the tokens with one
    scatter-add, so a token's slots land in ascending expert order.  Here
    each token gathers its k products in that order into a (T, k, d) tensor
    and sums them one at a time from zero: the same op order, and no atomics,
    so the result is the same on every run and device."""
    E, C, d = ye.shape
    T, k = eidx.shape
    ye_flat = torch.cat([ye.reshape(E * C, d), ye.new_zeros((1, d))])
    dest_tok = torch.empty_like(dest).scatter_(0, order, dest).reshape(T, k)
    by_expert = torch.argsort(eidx, dim=-1)  # a token's k experts are distinct
    dest_tok = dest_tok.gather(1, by_expert)
    gate_tok = gate.gather(1, by_expert).to(ye.dtype)
    slot_out = ye_flat[dest_tok] * gate_tok[..., None]  # (T, k, d)
    y = torch.zeros((T, d), dtype=ye.dtype, device=ye.device)
    for j in range(k):
        y = y + slot_out[:, j]
    return y


def moe(
    p: Params,
    x: torch.Tensor,  # (B, S, d)
    act: Callable,
    *,
    top_k: int,
    capacity_factor: float = 1.25,
    device_groups: int = 0,
    max_groups: int = 0,
):
    """Returns (output, aux_loss), as the reference's ``moe``.  Dropped slots
    (over an expert's capacity, ``moe_capacity``) contribute zero; the shared
    experts, where present, see every token.  The reference's ``softmax_fn``
    hook, which none of its callers sets, is not carried over.

    The combine (``moe_combine``) adds each token's slots in the reference's
    order, without atomics.  A DTensor ``x`` (a mesh) runs
    :func:`moe_on_mesh`."""
    if is_dtensor(x):
        return moe_on_mesh(p, x, act, top_k=top_k, capacity_factor=capacity_factor,
                           device_groups=device_groups, max_groups=max_groups)
    B, S, d = x.shape
    we = p["experts"]
    E = we["wi"].shape[0]
    T = B * S
    xt = x.reshape(T, d)

    probs, gate, eidx = moe_route(p["router"]["w"], xt, top_k=top_k,
                                  device_groups=device_groups, max_groups=max_groups)

    # load-balancing aux loss (Switch): E * sum_e f_e * p_e; the counts are
    # integer adds (exact in any order), and unlike torch.bincount, which
    # reads the ids' max on the host, they need no device sync on the card
    me = probs.mean(dim=0)  # (E,)
    flat_e = eidx.reshape(-1)
    counts = torch.zeros(E, dtype=flat_e.dtype, device=flat_e.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    ce = counts.to(torch.float32) / (T * top_k)
    aux = E * torch.sum(me * ce)

    # --- sort-based dispatch ----------------------------------------------------
    C = moe_capacity(T, top_k, E, capacity_factor)
    order, dest = moe_dispatch(eidx, E, C)
    slot_token = torch.div(order, top_k, rounding_mode="floor")  # a sorted slot's token
    buf = torch.zeros((E * C + 1, d), dtype=x.dtype, device=x.device)
    xe = buf.index_put((dest,), xt[slot_token])[:-1].reshape(E, C, d)

    # --- grouped expert GLU ------------------------------------------------------
    h = act(torch.bmm(xe, we["wi"].to(x.dtype))) * torch.bmm(xe, we["wu"].to(x.dtype))
    ye = torch.bmm(h, we["wd"].to(x.dtype))  # (E, C, d)

    y = moe_combine(ye, order, dest, gate, eidx)
    if "shared" in p:
        y = y + glu(p["shared"], xt, act)
    return y.reshape(B, S, d), aux


def moe_on_mesh(p: Params, x, act: Callable, *, top_k: int, capacity_factor: float,
                device_groups: int, max_groups: int):
    """:func:`moe` with expert parallelism over DTensors: x (B, S, d) over the
    batch dims, each rank holding E_loc experts (``ExpertLayout``), never
    gathered across the expert dims.  The reference runs ``moe`` under pjit
    with a global view, and so does this: the capacity counts the whole
    batch's tokens, a kept slot's rank within its expert is its rank in the
    global stable sort (the per-expert counts of the lower batch chunks,
    all-gathered, plus its local rank: ``moe_dispatch``'s ``offset``), and
    the aux loss takes global means (sums over the batch dims).  So ``dest``
    equals the unmeshed dispatch's slot for slot.

    The exchange: each rank writes its own kept slots into its column's zero
    buffer; a reduce-scatter over the batch dims leaves it C_pad / n_rows
    rows of each of its experts, on which it runs the GLU (the gate through
    ``unary_on``, on the buffer as a DTensor); an all-gather over the batch
    dims returns the column's rows, and each rank combines its tokens' slots
    of its column (``moe_combine``), a sum over the column dims that the
    caller's ``shard(ff, "batch", None, None)`` all-reduces.  The shared
    experts take the dense GLU path.  Returns (output, aux loss): the
    output a DTensor, the aux a plain scalar, the same on every rank."""
    B, S, d = x.shape
    we = p["experts"]
    E = we["wi"].shape[0]
    T = B * S
    C = moe_capacity(T, top_k, E, capacity_factor)
    lay = ExpertLayout.of(x, E, C)
    mesh = lay.mesh
    x = x.redistribute(mesh, lay.tokens)
    place = lambda w, pl: (w.redistribute(mesh, pl) if is_dtensor(w)
                           else distribute(w, mesh, pl))
    router = place(p["router"]["w"], lay.replicated)
    wi, wu, wd = (place(we[k], lay.weights) for k in ("wi", "wu", "wd"))

    def route(xl, w):
        probs, gate, eidx = moe_route(w, xl.reshape(-1, d), top_k=top_k,
                                      device_groups=device_groups, max_groups=max_groups)
        flat_e = eidx.reshape(-1)
        counts = torch.zeros(E, dtype=flat_e.dtype, device=flat_e.device).scatter_add_(
            0, flat_e, torch.ones_like(flat_e))
        return gate, eidx, counts[None], probs.sum(dim=0)

    gate, eidx, counts, psum = on_local_shards(
        route, (lay.tokens, lay.tokens, lay.tokens, lay.partial_sum), x, router)
    every = counts.redistribute(mesh, lay.replicated).to_local()  # (chunks, E), in order
    offset = every[:lay.chunk].sum(dim=0)
    me = psum.redistribute(mesh, lay.replicated).to_local() / T
    aux = E * torch.sum(me * (every.sum(dim=0).to(torch.float32) / (T * top_k)))

    columns = lay.column_slots(E, every.device)
    Cp, scratch = lay.c_pad, lay.e_col * lay.c_pad

    def dispatch(xl, el):
        order, dest = moe_dispatch(el, E, C, offset)
        sorted_e = el.reshape(-1)[order]
        col = columns[sorted_e]
        row = torch.where((dest < E * C) & (col >= 0), col * Cp + dest - sorted_e * C,
                          scratch)
        slot_token = torch.div(order, top_k, rounding_mode="floor")
        buf = torch.zeros((scratch + 1, d), dtype=xl.dtype, device=xl.device)
        xe = buf.index_put((row,), xl.reshape(-1, d)[slot_token])[:-1]
        return xe.reshape(lay.n_shared, lay.e_loc, Cp, d), order, row

    xe, order, row = on_local_shards(dispatch, (lay.partial, lay.tokens, lay.tokens),
                                     x, eidx)
    xe = xe.redistribute(mesh, lay.rows)  # reduce-scatter over the batch dims

    def up(xl, wil, wul):
        return (torch.bmm(xl[0], wil.to(xl.dtype))[None],
                torch.bmm(xl[0], wul.to(xl.dtype))[None])

    g, u = on_local_shards(up, (lay.rows, lay.rows), xe, wi, wu)
    h = unary_on(act, g)(g) * u
    ye = on_local_shards(lambda hl, wdl: torch.bmm(hl[0], wdl.to(hl.dtype))[None],
                         lay.rows, h, wd)
    ye = ye.redistribute(mesh, lay.column)  # all-gather over the batch dims

    def combine(yl, ol, rl, gl, el):
        y = moe_combine(yl.reshape(lay.e_col, Cp, d), ol, rl, gl, el)
        return y.reshape(-1, S, d)

    y = on_local_shards(combine, lay.combined, ye, order, row, gate, eidx)
    if "shared" in p:  # on the (T, d) rows, as off the mesh
        xt = on_local_shards(lambda v: v.reshape(-1, d), lay.tokens, x)
        sh = glu(p["shared"], xt, unary_on(act, xt))
        y = y + on_local_shards(lambda v: v.reshape(-1, S, d), tuple(sh.placements), sh)
    return y, aux
