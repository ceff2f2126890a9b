"""Mixture-of-Experts FFN: shared + routed experts (DeepSeekMoE family).

The port of ``repro.models.moe``, with the reference's three dispatches:

* ``"gshard"``, the reference's default and its train step's: the
  capacity-based one-hot dispatch of GShard / Mesh-TF.  Tokens go in
  groups of up to :data:`GROUP_SIZE`; each expert takes at most ``C =
  max(1, int(G k / E capacity_factor))`` tokens a group, the slot-0
  choices first, and the rest are dropped; the experts run as dense
  einsums over the (E, groups, C) slots, as the reference leaves them to
  XLA (no kernel on either side).  It is differentiable, so training
  takes it;
* ``"ragged"``: the sort-based dispatch (:mod:`repro_torch.core.overlap`,
  three ``grouped_matmul`` launches a layer), the one serving takes for
  every MoE config.  It is differentiable too, through the grouped
  matmul's backward kernel (``grouped_matmul.GroupedMatmulFn``): the GRPO
  learner trains an MoE policy under the dispatch its actor samples with,
  and the train step takes it on request.

* ``"dp_local"``: the reference's data-local dispatch
  (:func:`~repro_torch.core.overlap.moe_dp_local`: the expert weights
  gathered, each token shard dispatched with capacity on its own rank),
  under a mesh whose dp and ``model`` sizes divide B and S; otherwise,
  with no mesh among them, the ragged dispatch, exactly as the reference
  falls back.

On a mesh (DTensor params and activations) gshard's dispatch tensor is
constrained to its experts over ``model``, as the reference's; the ragged
dispatch runs expert-parallel (:mod:`repro_torch.core.overlap`); and the
shared experts' column- and row-sharded SwiGLU gives a ``Partial`` sum
over ``model``, as the routed experts' combine does, which the residual
add reduces.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.meshctx import (as_dtensor, constrain, current_mesh,
                                      full_tensor, is_dtensor, mesh_axis_size)
from repro_torch.core.overlap import moe_dp_local, ragged_moe_apply
from repro_torch.models.common import dense_init, dtype_of, swiglu

DISPATCHES = ("gshard", "ragged", "dp_local")
GROUP_SIZE = 512   # tokens per GShard dispatch group


def _expert_init(gen: torch.Generator, E: int, d_in: int, d_out: int,
                 d_model: int, d_ff: int, dtype, lead=()) -> torch.Tensor:
    """Normal ``(*lead, E, d_in, d_out)`` expert stacks scaled by
    ``(2 / (d_model + d_ff)) ** 0.5``, as the reference's.  Drawn one layer
    at a time in float32 and cast into the stack, so the largest float32
    temporary is one layer's experts, not the whole stack's (at
    deepseek-v2-lite's width a stack of 26 layers would be 19 GB in
    float32)."""
    scale = (2.0 / (d_model + d_ff)) ** 0.5
    out = torch.empty(*lead, E, d_in, d_out, dtype=dtype, device=gen.device)
    flat = out.view(-1, E, d_in, d_out)
    for i in range(flat.shape[0]):
        flat[i] = (scale * torch.randn(E, d_in, d_out, generator=gen,
                                       device=gen.device,
                                       dtype=torch.float32)).to(dtype)
    return out


def init_moe(cfg, gen: torch.Generator, *, lead=()):
    """MoE params; ``lead`` stacks layers on leading axes.  The router
    stays float32 whatever ``cfg.dtype`` is, as in the reference."""
    mo = cfg.moe
    d, F = cfg.d_model, mo.d_ff_expert
    dt = dtype_of(cfg)
    E = mo.num_experts
    Fs = F * mo.num_shared_experts
    return {
        "router": dense_init(gen, d, E, torch.float32, lead=lead),
        "w_gate": _expert_init(gen, E, d, F, d, F, dt, lead),
        "w_up": _expert_init(gen, E, d, F, d, F, dt, lead),
        "w_down": _expert_init(gen, E, F, d, d, F, dt, lead),
        "ws_gate": dense_init(gen, d, Fs, dt, lead=lead),
        "ws_up": dense_init(gen, d, Fs, dt, lead=lead),
        "ws_down": dense_init(gen, Fs, d, dt, lead=lead),
    }


def router_probs(p, x, cfg):
    """Router in f32.  x: (T, D) -> (probs (T, E), logits (T, E))."""
    logits = x.float() @ p["router"]
    return torch.softmax(logits, dim=-1), logits


def moe_forward(p, x, cfg, *, dispatch: str = "ragged",
                metrics: bool = True):
    """x: (B, S, D) -> (y (B, S, D), aux metrics dict).

    ``metrics=False`` skips the router's loss terms (the serving steps
    discard them; the reference's compiler drops them there) and returns
    an empty dict."""
    if dispatch not in DISPATCHES:
        raise ValueError(f"moe dispatch {dispatch!r}: must be one of "
                         f"{DISPATCHES}")
    mo = cfg.moe
    B, S, D = x.shape
    T = B * S
    xf = x.reshape(T, D)
    if is_dtensor(xf):
        # pin the tokens' layout for the backward too: the gradient that
        # reaches the reshape is redistributed to it first (DTensor's view
        # rule misplaces a row gradient sharded over two mesh dims)
        xf = xf.redistribute(xf.device_mesh, xf.placements)

    probs, logits = router_probs(p, xf, cfg)
    gate_vals, idx = torch.topk(probs, mo.top_k, dim=-1)        # (T, k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    mesh = current_mesh()
    if dispatch == "dp_local" and _dp_local_fits(mesh, B, S):
        y = moe_dp_local(p, x, idx.reshape(B, S, -1),
                         gate_vals.reshape(B, S, -1), cfg, mesh).reshape(T, D)
    else:
        apply = gshard_apply if dispatch == "gshard" else ragged_moe_apply
        y = apply(p, xf, idx, gate_vals, cfg)
    # shared experts: dense SwiGLU over all tokens
    y = y + swiglu(xf, p["ws_gate"], p["ws_up"], p["ws_down"])
    y = y.reshape(B, S, D)
    if not metrics:
        return y, {}

    E = mo.num_experts
    me = probs.mean(dim=0)                                      # mean prob
    # each expert's count of choices, as the reference's one-hot mean (a
    # comparison and a sum, which DTensor shards as it shards idx)
    ce = (idx.reshape(-1, 1) == torch.arange(E, device=x.device)).sum(
        0).float() / T
    return y, {
        "moe_aux_loss": E * torch.sum(me * ce) / mo.top_k,
        "moe_z_loss": torch.mean(torch.logsumexp(logits, dim=-1) ** 2),
        "router_entropy": -torch.mean(
            torch.sum(probs * torch.log(probs + 1e-9), dim=-1)),
    }


def _dp_local_fits(mesh, B: int, S: int) -> bool:
    """Whether ``dp_local`` runs: a mesh whose dp axes' size divides B and
    whose ``model`` size divides S (the reference's test)."""
    if mesh is None:
        return False
    dpn = mesh_axis_size(mesh, "pod") * mesh_axis_size(mesh, "data")
    return B % dpn == 0 and S % mesh_axis_size(mesh, "model") == 0


def _group(T: int) -> int:
    """Tokens a GShard group: the largest power-of-two fraction of
    :data:`GROUP_SIZE` (or T) that divides T, as the reference's."""
    g = min(GROUP_SIZE, T)
    while T % g:
        g //= 2
    return max(g, 1)


def gshard_apply(p, xf, idx, gate_vals, cfg):
    """Capacity-based one-hot dispatch (the reference's ``_gshard_apply``).
    xf (T, D); idx, gate_vals (T, k) from the router.  Returns the routed
    experts' weighted sum (T, D) in xf.dtype; a token an expert has no room
    for gets nothing from it."""
    mo = cfg.moe
    T, D = xf.shape
    E, k = mo.num_experts, mo.top_k
    G = _group(T)
    Gn = T // G
    C = max(1, int(G * k / E * mo.capacity_factor))
    dt = xf.dtype

    # the slots come from the routing alone (integers, no gradient), which
    # a mesh gathers whole: every rank computes the same slots, and only
    # the gates carry a gradient into the combine
    idx_g = full_tensor(idx).reshape(Gn, G, k)
    gates_g = gate_vals.reshape(Gn, G, k).float()
    x_g = xf.reshape(Gn, G, D)

    # position-in-expert with k-slot priority (slot 0 first); a token past
    # the capacity gets the one-hot of C, which the slice drops (the
    # reference's one_hot of an out-of-range index is all zeros)
    counts = torch.zeros(Gn, E, dtype=torch.long, device=idx_g.device)
    dispatch = torch.zeros(Gn, G, E, C, dtype=dt, device=idx_g.device)
    combine = 0
    for j in range(k):
        oh = F.one_hot(idx_g[:, :, j], E)                       # (Gn, G, E)
        pos = counts[:, None, :] + oh.cumsum(1) - oh            # before self
        counts = counts + oh.sum(1)
        keep = (pos < C) & (oh > 0)
        pos_oh = F.one_hot(torch.where(keep, pos, C), C + 1)[..., :C]
        d_j = pos_oh.to(dt) * keep.to(dt)[..., None]            # (Gn,G,E,C)
        dispatch = dispatch + d_j
        combine = combine + d_j * gates_g[:, :, j][..., None, None].to(dt)

    # the reference's sharding hints: the experts over model
    if is_dtensor(gate_vals):
        dispatch = as_dtensor(dispatch, gate_vals.device_mesh)
    dispatch = constrain(dispatch, ("pod", "data"), None, "model", None)
    expert_in = torch.einsum("gsec,gsd->egcd", dispatch, x_g)
    expert_in = constrain(expert_in, "model", ("pod", "data"), None, None)
    h = F.silu(torch.einsum("egcd,edf->egcf", expert_in, p["w_gate"]))
    h = h * torch.einsum("egcd,edf->egcf", expert_in, p["w_up"])
    expert_out = torch.einsum("egcf,efd->egcd", h, p["w_down"])
    expert_out = constrain(expert_out, "model", ("pod", "data"), None, None)
    y = torch.einsum("egcd,gsec->gsd", expert_out, combine)
    return y.reshape(T, D)
