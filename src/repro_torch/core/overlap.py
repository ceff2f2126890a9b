"""Chunked collective/compute overlap and the MoE dispatch variants, PyTorch
port of ``repro.core.overlap``.

* :func:`ragged_moe_apply`: the ragged (sort-based) dispatch, the one
  serving takes for every MoE config: each token's own top-k experts, with
  no capacity and no interaction between tokens, so a row's output does
  not depend on its batch mates.  On a mesh it is expert-parallel under
  tensor parallelism (:func:`_ragged_on_mesh`).
* :func:`collective_matmul_allgather`: the full product of a row-sharded
  x and a replicated w, the next shard fetched while the resident one is
  multiplied (the reference's ``ppermute`` ring as point-to-point steps).
* :func:`overlap_efficiency`: the analytical masking ratio of a chunked
  schedule.
* :func:`ep_moe_shardmap`: expert-parallel MoE through a fixed-capacity
  all-to-all.
* :func:`moe_dp_local`: data-local MoE: the expert weights gathered, each
  token shard dispatched on its own rank.

The reference's ``shard_map`` regions are DTensor's ``local_map`` here:
each rank runs plain PyTorch on its local shards, and the collectives
inside are ``torch.distributed`` calls on the mesh dim's process group
(those on a gradient's path from ``torch.distributed.nn``, which are
differentiable).
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.core.meshctx import as_dtensor, is_dtensor, mesh_axis_size
from repro_torch.kernels import ops


# ---------------------------------------------------------------------------
# collective matmul: all-gather overlapped with compute (Wang et al. style)
# ---------------------------------------------------------------------------
def collective_matmul_allgather(x, w, *, axis_name: str):
    """``full_x @ w`` where the DTensor ``x`` (S, D) is row-sharded over
    the mesh axis ``axis_name`` and ``w`` (D, F) is replicated.

    Under ``local_map`` each rank multiplies its resident shard while the
    next one arrives from its ring neighbour (``batch_isend_irecv``), n
    steps for n ranks, then orders the n products by their shard of
    origin.  Returns (S, F), the full product on every rank."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    dim = tuple(mesh.mesh_dim_names).index(axis_name)
    rep = [Replicate()] * mesh.ndim
    xp = [Shard(0) if i == dim else Replicate() for i in range(mesh.ndim)]
    fn = functools.partial(_ring_matmul, group=mesh.get_group(dim),
                           n=mesh.shape[dim], idx=mesh.get_local_rank(dim))
    return local_map(fn, out_placements=rep, in_placements=(xp, rep),
                     device_mesh=mesh, redistribute_inputs=True)(x, w)


def _ring_matmul(xl, wl, *, group, n, idx):
    import torch.distributed as dist
    ranks = dist.get_process_group_ranks(group)
    nxt, prv = ranks[(idx + 1) % n], ranks[(idx - 1) % n]
    blk = xl.contiguous()
    parts = [None] * n
    for i in range(n):
        part = blk @ wl                          # compute the current chunk
        if i + 1 < n:                            # overlap: fetch the next
            recv = torch.empty_like(blk)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, blk, nxt, group),
                dist.P2POp(dist.irecv, recv, prv, group)])
        parts[(idx - i) % n] = part              # who produced this chunk
        if i + 1 < n:
            for r in reqs:
                r.wait()
            blk = recv
    return torch.cat(parts, dim=0)


def overlap_efficiency(compute_s: float, comm_s: float, chunks: int,
                       *, masking_floor: float = 0.0) -> float:
    """Analytical masking ratio of the chunked schedule.

    With the monolithic schedule, comm is fully exposed (masking ratio =
    ``masking_floor``, ~0.6 in the paper's baseline from coarse-grained
    double buffering).  With ``chunks`` chunks, every chunk's transfer
    overlaps the previous chunk's compute; exposed time is one chunk of
    whichever resource dominates.
    """
    if comm_s <= 0:
        return 1.0
    per_comp, per_comm = compute_s / chunks, comm_s / chunks
    exposed = per_comm + max(0.0, comm_s - per_comm - compute_s + per_comp)
    exposed = min(exposed, comm_s)
    masked = 1.0 - exposed / comm_s
    return max(masked, masking_floor)


# ---------------------------------------------------------------------------
# ragged (sort-based) MoE dispatch
# ---------------------------------------------------------------------------
def ragged_moe_apply(p, xf, idx, gate_vals, cfg):
    """Routed-expert sum via sort -> three grouped matmuls -> unsort.

    xf: (T, D); idx: (T, k) expert ids; gate_vals: (T, k) gate weights.
    Returns (T, D) in the experts' output type.

    Differentiable: under autograd each grouped matmul runs through
    ``GroupedMatmulFn`` (its backward kernel computes dx and dW), and the
    sort, gather and unsort are plain indexing, so the train step and the
    GRPO learner take this dispatch as serving does.

    The group sizes are counted on the device (``scatter_add_`` of ones:
    no read-back, unlike ``bincount``), and the rows are sorted by expert
    with a stable sort.  Where the reference scatter-adds each weighted
    expert output into its token (``.at[tok].add``), which on the card
    would be float atomics summing in no fixed order, the port unsorts
    through the inverse permutation and sums each token's k outputs in a
    fixed order, ascending expert id: the order in which the reference's
    scatter meets them, so the float32 sums round alike.

    DTensor inputs (a mesh) take :func:`_ragged_on_mesh`.
    """
    if is_dtensor(xf) or is_dtensor(p["w_gate"]):
        return _ragged_on_mesh(p, xf, idx, gate_vals, cfg)
    mo = cfg.moe
    E, k = mo.num_experts, mo.top_k
    xs, order, valid, sizes = _dispatch(xf, idx, E=E, k=k)
    h = ops.grouped_matmul(xs, p["w_gate"], sizes)
    h = F.silu(h) * ops.grouped_matmul(xs, p["w_up"], sizes)
    out = ops.grouped_matmul(h, p["w_down"], sizes)      # (T*k, D)
    return _combine(out, order, valid, idx, gate_vals, k=k)


def _dispatch(xf, idx, *, E: int, k: int, first: int = 0, local=None):
    """The rows of xf (T, D), one per (token, choice), sorted by expert
    with experts ``first .. first + local - 1`` first (the key is the
    expert id rotated by ``first``), and those experts' row counts.
    Returns (xs (T k, D), the sort order, the valid-row mask (True on
    the local experts' rows; None when every expert is local), sizes
    (local,) int32).  The rows past the local ones are zeros, so nothing
    of them reaches a product or, in the backward, xf."""
    local = E if local is None else local
    flat = torch.sort(idx, dim=-1)[0].reshape(-1)   # token-major, ascending
    key = flat if first == 0 else (flat - first) % E
    order = torch.argsort(key, stable=True)
    counts = torch.zeros(E, dtype=torch.int32, device=xf.device).scatter_add_(
        0, key, torch.ones_like(key, dtype=torch.int32))
    xs = xf[order // k]                             # (T*k, D) sorted
    if local == E:
        return xs, order, None, counts
    sizes = counts[:local]
    valid = (torch.arange(xs.shape[0], device=xf.device)
             < sizes.sum())[:, None]
    return torch.where(valid, xs, torch.zeros_like(xs)), order, valid, sizes


def _combine(out, order, valid, idx, gate_vals, *, k: int):
    """Each token's weighted expert outputs, summed in ascending expert id:
    ``out`` (T k, D) in the order of :func:`_dispatch`, the rows past the
    local experts' (``valid`` False) taken as zeros."""
    T = idx.shape[0]
    D = out.shape[-1]
    gate_vals = gate_vals.gather(-1, torch.sort(idx, dim=-1)[1])
    if valid is not None:
        out = torch.where(valid, out, torch.zeros_like(out))
    unsorted = torch.empty_like(out)
    unsorted[order] = out                     # back to token-major order
    contrib = (unsorted * gate_vals.reshape(-1, 1).to(out.dtype)).view(T, k, D)
    y = contrib[:, 0]
    for j in range(1, k):
        y = y + contrib[:, j]
    return y


def _ragged_on_mesh(p, xf, idx, gate_vals, cfg, *, ep_axis: str = "model"):
    """The ragged dispatch on a mesh, expert-parallel under tensor
    parallelism.

    The tokens keep their data-parallel sharding and are replicated over
    ``ep_axis``.  Where E divides that axis (the ``ep`` rule places w's
    experts there), rank r holds experts [r E/n, (r + 1) E/n): every rank
    sorts the same routing, by the expert id rotated by r E/n so that its
    own experts' rows come first (no host read-back of the row count),
    runs the three grouped matmuls on those rows alone (the rows past them
    masked to zero), and its combine is a ``Partial`` sum over
    ``ep_axis``, which the next operator reduces.  The gradients of xf and
    of the gates are parts likewise, summed over ``ep_axis`` in the
    backward (:class:`_SumGrad`).  Where E does not divide
    (or there is no such axis), each rank runs the one-device dispatch on
    all the experts, gathered.
    """
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mo = cfg.moe
    E, k = mo.num_experts, mo.top_k
    mesh = (xf if is_dtensor(xf) else p["w_gate"]).device_mesh
    xf, idx, gate_vals = (as_dtensor(t, mesh) for t in (xf, idx, gate_vals))
    names = tuple(mesh.mesh_dim_names)
    n = mesh_axis_size(mesh, ep_axis)
    ep = names.index(ep_axis) if n > 1 and E % n == 0 else None
    # the tokens: their rows sharded where xf's are, except over ep_axis
    tok = [Shard(0) if isinstance(pl, Shard) and pl.dim == 0
           and names[i] != ep_axis else Replicate()
           for i, pl in enumerate(xf.placements)]
    rows, part, sizes_pl = list(tok), list(tok), [
        Partial() if isinstance(pl, Shard) else Replicate() for pl in tok]
    first, local, group = 0, E, None
    if ep is not None:
        rows[ep], part[ep], sizes_pl[ep] = Shard(0), Partial(), Shard(0)
        local = E // n
        first = mesh.get_local_rank(ep) * local
        group = mesh.get_group(ep)
    dispatch = local_map(
        functools.partial(_dispatch_rows, E=E, k=k, first=first,
                          local=local, group=group),
        out_placements=(rows, rows, rows, sizes_pl),
        in_placements=(tok, tok), device_mesh=mesh, redistribute_inputs=True)
    xs, order, valid, sizes = dispatch(xf, idx)
    h = ops.grouped_matmul(xs, p["w_gate"], sizes)
    h = F.silu(h) * ops.grouped_matmul(xs, p["w_up"], sizes)
    out = ops.grouped_matmul(h, p["w_down"], sizes)
    combine = local_map(
        functools.partial(_combine_rows, k=k, group=group),
        out_placements=part, in_placements=(rows, rows, rows, tok, tok),
        device_mesh=mesh, redistribute_inputs=True)
    return combine(out, order, valid, idx, gate_vals)


class _SumGrad(torch.autograd.Function):
    """The identity, whose backward sums the gradient over ``group`` (the
    expert-parallel ranks): each rank's experts give a part of the
    gradient of the tokens and gates that every rank holds whole, so the
    parts are reduced where they arise and the input's gradient keeps its
    placements."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def _sum_grad(t, group):
    return t if group is None else _SumGrad.apply(t, group)


def _combine_rows(out, order, valid, idx, gate_vals, *, k, group):
    return _combine(out, order, valid, idx, _sum_grad(gate_vals, group), k=k)


def _dispatch_rows(xf, idx, *, E, k, first, local, group):
    """:func:`_dispatch` with the valid-row mask always a tensor (an
    output of ``local_map`` cannot be None)."""
    xs, order, valid, sizes = _dispatch(_sum_grad(xf, group), idx, E=E,
                                        k=k, first=first, local=local)
    if valid is None:
        valid = torch.ones(xs.shape[0], 1, dtype=torch.bool,
                           device=xs.device)
    return xs, order, valid, sizes


# ---------------------------------------------------------------------------
# expert-parallel MoE via an explicit all-to-all
# ---------------------------------------------------------------------------
def ep_moe_shardmap(p, x, cfg, mesh, *, ep_axis: str = "model",
                    chunks: int = 4):
    """Expert-parallel MoE with an explicit all-to-all, the reference's.

    x: (B, S, D) sharded over dp on B, replicated over ``ep_axis``; the
    expert weights sharded over ``ep_axis`` on their experts.  Each rank
    routes its tokens, sends each (token, choice) to the rank of its expert
    in a fixed-capacity block (``cap`` rows a destination; a choice past
    the capacity is dropped), runs its resident experts on what it
    receives, and sends the results back, where they are added into their
    tokens.  The blocks travel by ``all_to_all_single`` of
    ``torch.distributed.nn``, so the input's gradient flows back through
    both exchanges.  ``chunks`` is accepted as the reference accepts it,
    and, as there, not read.  Returns (B, S, D) placed as x."""
    del chunks
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.core.meshctx import dp_entry
    from repro_torch.core.layout import placements_on
    names = tuple(mesh.mesh_dim_names)
    dim = names.index(ep_axis)
    n_ep = mesh.shape[dim]
    xp = list(placements_on((dp_entry(mesh), None, None), mesh))
    wp = [Shard(0) if i == dim else Replicate() for i in range(mesh.ndim)]
    rp = [Replicate()] * mesh.ndim
    fn = functools.partial(
        _ep_local, cfg=cfg, group=mesh.get_group(dim), n_ep=n_ep,
        shard=mesh.get_local_rank(dim))
    args = [as_dtensor(t, mesh) for t in (
        p["w_gate"], p["w_up"], p["w_down"], p["router"], x)]
    return local_map(fn, out_placements=xp,
                     in_placements=(wp, wp, wp, rp, xp), device_mesh=mesh,
                     redistribute_inputs=True)(*args)


def _ep_local(w_g, w_u, w_d, router, xx, *, cfg, group, n_ep, shard):
    from torch.distributed.nn.functional import all_to_all_single

    from repro_torch.models.moe import router_probs
    mo = cfg.moe
    E, k = mo.num_experts, mo.top_k
    e_local = E // n_ep
    B, S, D = xx.shape
    T = B * S
    xf = xx.reshape(T, D)
    probs, _ = router_probs({"router": router}, xf, cfg)
    gate_vals, idx = torch.topk(probs, k, dim=-1)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    # capacity per (src shard, dst shard): fixed so the exchange is static
    cap = max(1, int(T * k / E * mo.capacity_factor) * e_local)
    flat_e = idx.reshape(-1)
    flat_t = torch.arange(T, device=xx.device).repeat_interleave(k)
    flat_g = gate_vals.reshape(-1)
    dst = flat_e // e_local                          # target shard
    order = torch.argsort(dst, stable=True)
    dst_s, tok_s, e_s, g_s = (dst[order], flat_t[order], flat_e[order],
                              flat_g[order])
    # position within the destination bucket
    onehot = F.one_hot(dst_s, n_ep)
    pos = ((onehot.cumsum(0) - onehot) * onehot).sum(-1)
    keep = pos < cap
    slot = dst_s * cap + torch.where(keep, pos, cap - 1)
    # the reference scatters every (token, choice) into its slot, dropped
    # ones as zeros at the bucket's last slot, the later write winning (XLA
    # applies a scatter's updates in order): each slot takes its last writer
    n_rows = n_ep * cap
    seq = torch.arange(slot.shape[0], device=xx.device)
    last = torch.full((n_rows,), -1, dtype=torch.long,
                      device=xx.device).scatter_reduce_(0, slot, seq, "amax")
    won = last >= 0
    src = last.clamp_min(0)
    kept = won & keep[src]
    send_x = torch.where(kept[:, None], xf[tok_s[src]],
                         torch.zeros((), dtype=xx.dtype, device=xx.device))
    send_e = torch.where(kept, e_s[src], -1)
    send_t = torch.where(kept, tok_s[src], 0)
    send_g = torch.where(kept, g_s[src], 0.0)

    def a2a(t):
        return all_to_all_single(torch.empty_like(t), t.contiguous(),
                                 group=group)
    rx = a2a(send_x)
    re = a2a(send_e.float()).long()
    rg = a2a(send_g)

    e_rel = torch.where(re >= 0, re - shard * e_local, 0)
    valid = re >= 0
    sel = F.one_hot(e_rel, e_local).to(rx.dtype) * valid[:, None].to(rx.dtype)
    wg = torch.einsum("te,edf->tdf", sel, w_g)
    wu = torch.einsum("te,edf->tdf", sel, w_u)
    wd = torch.einsum("te,efd->tfd", sel, w_d)
    h = F.silu(torch.einsum("td,tdf->tf", rx, wg))
    h = h * torch.einsum("td,tdf->tf", rx, wu)
    yo = torch.einsum("tf,tfd->td", h, wd) * rg[:, None].to(rx.dtype)

    ys = a2a(yo)                                  # back to the source shards
    y = torch.zeros(T, D, dtype=xx.dtype, device=xx.device).index_add(
        0, send_t, torch.where(send_e[:, None] >= 0, ys,
                               torch.zeros_like(ys)))
    return y.reshape(B, S, D)


# ---------------------------------------------------------------------------
# data-local MoE: gathered experts, zero token movement
# ---------------------------------------------------------------------------
def moe_dp_local(p, x3, idx3, gates3, cfg, mesh, *, tp_axis: str = "model"):
    """Compute the routed experts locally on each token shard.

    Instead of moving tokens to the expert shards, move the weights: the
    expert weights are redistributed to replicated (an all-gather, whose
    backward is the reduce-scatter of their gradients), and every rank
    runs the reference's shard-local capacity dispatch on its own token
    slice under ``local_map``: x3 (B, S, D), idx3 and gates3 (B, S, k)
    with the batch over the dp axes and the sequence over ``tp_axis``.
    Groups of ``G = 512`` tokens when 512 divides the rank's T, else one
    group of T; an expert takes at most ``C = max(1, int(G k / E
    capacity_factor))`` tokens a group.  Returns (B, S, D) placed as the
    tokens."""
    from torch.distributed.tensor import Partial, Replicate

    from repro_torch.core.layout import placements_on
    from repro_torch.core.meshctx import dp_entry
    from torch.distributed.tensor.experimental import local_map
    names = tuple(mesh.mesh_dim_names)
    has_tp = tp_axis in names
    x3, idx3, gates3 = (as_dtensor(t, mesh) for t in (x3, idx3, gates3))
    w = [as_dtensor(p[k], mesh) for k in ("w_gate", "w_up", "w_down")]
    tok = list(placements_on(
        (dp_entry(mesh), tp_axis if has_tp else None, None), mesh))
    rep = [Replicate()] * mesh.ndim
    # every rank's tokens add to every expert's gradient
    wgrad = [Partial() if n > 1 else Replicate() for n in mesh.shape]
    fn = functools.partial(_dp_local, E=cfg.moe.num_experts,
                           capacity_factor=cfg.moe.capacity_factor)
    return local_map(fn, out_placements=tok,
                     in_placements=(rep, rep, rep, tok, tok, tok),
                     in_grad_placements=(wgrad, wgrad, wgrad, tok, tok,
                                         tok),
                     device_mesh=mesh, redistribute_inputs=True)(
        *w, x3, idx3, gates3)


def _dp_local(wg, wu, wd, xl, il, gl, *, E, capacity_factor):
    Bl, Sl, D = xl.shape
    T = Bl * Sl
    k = il.shape[-1]
    xf = xl.reshape(T, D)
    dt = xf.dtype
    G = 512 if T % 512 == 0 else T
    Gn = T // G
    C = max(1, int(G * k / E * capacity_factor))
    idx_g = il.reshape(Gn, G, k)
    gates_g = gl.reshape(Gn, G, k).float()
    x_g = xf.reshape(Gn, G, D)
    counts = torch.zeros(Gn, E, dtype=torch.long, device=xf.device)
    dispatch = xf.new_zeros(Gn, G, E, C)
    combine = xf.new_zeros(Gn, G, E, C)
    for j in range(k):
        oh = F.one_hot(idx_g[:, :, j], E)
        pos = counts[:, None, :] + oh.cumsum(1) - oh
        counts = counts + oh.sum(1)
        keep = (pos < C) & (oh > 0)
        pos_oh = F.one_hot(torch.where(keep, pos, C), C + 1)[..., :C]
        d_j = pos_oh.to(dt) * keep.to(dt)[..., None]
        dispatch = dispatch + d_j
        combine = combine + d_j * gates_g[:, :, j][..., None, None].to(dt)
    expert_in = torch.einsum("gsec,gsd->egcd", dispatch, x_g)
    h = F.silu(torch.einsum("egcd,edf->egcf", expert_in, wg))
    h = h * torch.einsum("egcd,edf->egcf", expert_in, wu)
    expert_out = torch.einsum("egcf,efd->egcd", h, wd)
    y = torch.einsum("egcd,gsec->gsd", expert_out, combine)
    return y.reshape(Bl, Sl, D)
