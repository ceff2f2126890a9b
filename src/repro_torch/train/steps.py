"""Train-step construction: loss, grad, update, offload, on one device
or on a HyperShard mesh.

The port of ``repro.train.steps``.  ``make_train_step`` returns a step
that runs the remat'd train forward (flash attention through its autograd
Function: forward and backward kernels on the card), the cross entropy,
``torch.autograd.grad`` over every param leaf and the reference's AdamW.

With ``mesh=`` (a ``DeviceMesh`` with the reference's axis names) and
``plan=`` (a :class:`~repro_torch.core.hypershard.ShardingPlan`), the
params and the optimizer's moments are DTensors placed by
:func:`~repro_torch.core.hypershard.make_param_shardings`, the batch is
sharded over the dp axes, and the step runs under
:func:`~repro_torch.core.meshctx.use_mesh`: DTensor's sharding
propagation stands for GSPMD over the same strategy-free model code, the
model's ``constrain`` points redistribute, and every kernel runs on the
local shards under ``local_map``.  The step carries the reference's
``shardings`` dict as ``step.shardings``.  Every family shards: the
dense GQA, MLA and MoE families (``ATTN`` or ``MLA`` mixers, dense or MoE
FFNs: MLA trains through flash at its own (Dk, Dv) under ``local_map``,
the MoE FFN under every ``moe_dispatch``: gshard's dispatch constrained
to the experts over ``model``, the ragged one expert-parallel with the
grouped matmul and its backward under ``local_map``, ``dp_local`` by
:func:`~repro_torch.core.overlap.moe_dp_local`), SSD and RG-LRU (both
scans and their backwards under ``local_map`` on each rank's rows and
heads or channels, the gradients of their shared inputs summed over the
ranks), and the multimodal prefix (``batch["prefix_embeds"]`` its rows
over the dp axes, :func:`~repro_torch.data.pipeline.place_prefix`).

HyperOffload's legs between steps are :func:`fetch_state` (host -> card)
and :func:`offload_state` (card -> pinned host memory), and
:func:`init_state` places the state as ``offload_cfg`` says.  They
host-place exactly the leaves the reference host-places: those whose
spec is fully sharded (:func:`repro_torch.core.offload.host_placeable`);
with no mesh the port's one card stands for a one-device mesh, on which
every leaf of rank >= 2 is fully sharded.
"""
from __future__ import annotations

import torch

from repro_torch.api.errors import PlanError
from repro_torch.core import hypershard as hs, offload as off
from repro_torch.core.meshctx import full_tensor, is_dtensor, use_mesh
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.models import model as M
from repro_torch.optim import adamw as opt_mod

FACADE = ("HyperPlan, its presets and Supernode are the facade: ROADMAP.md "
          "section 1 item 8h")


def check_mesh_plan(mesh, plan):
    """The plan a step or a trainer runs under: ``plan`` (a
    :class:`ShardingPlan`, or None for the default) once ``mesh`` is a
    ``DeviceMesh`` (every family, with or without the multimodal prefix,
    trains on one).  Raises :class:`PlanError` for a plan that is not a
    ``ShardingPlan`` (the facade's, naming its ROADMAP item) and for a
    mesh that is not a ``DeviceMesh``."""
    from torch.distributed.device_mesh import DeviceMesh

    if plan is not None and not isinstance(plan, hs.ShardingPlan):
        raise PlanError(f"plan={type(plan).__name__}: the port takes a "
                        f"ShardingPlan; {FACADE}")
    if mesh is None:
        return plan
    if not isinstance(mesh, DeviceMesh):
        raise PlanError(f"mesh={type(mesh).__name__}: not a torch "
                        "DeviceMesh (build one with repro_torch.launch.mesh."
                        "make_host_mesh; ROADMAP.md section 1 item 8)")
    return plan or hs.ShardingPlan()


def train_shardings(cfg, mesh, plan, *, multimodal: bool = False):
    """The reference's ``shardings`` dict: ``params`` (a tree of
    :class:`~repro_torch.core.hypershard.NamedSharding` per leaf),
    ``opt_in`` (the AdamW state's: the moments follow the params, the
    count is replicated) and ``batch`` (``inputs``, ``targets``, ``mask``
    sharded over the dp axes; with ``multimodal`` also ``prefix_embeds``,
    its rows over them: :func:`~repro_torch.data.pipeline.
    prefix_sharding`)."""
    from repro_torch.data.pipeline import batch_sharding, prefix_sharding
    from repro_torch.mem.planner import param_shapes
    param_sh = hs.make_param_shardings(mesh, param_shapes(cfg), plan)
    bsh = batch_sharding(mesh)
    batch = {k: bsh for k in ("inputs", "targets", "mask")}
    if multimodal:
        batch["prefix_embeds"] = prefix_sharding(mesh)
    return {"params": param_sh,
            "opt_in": opt_mod.AdamWState(mu=param_sh, nu=param_sh,
                                         count=hs.NamedSharding(mesh, ())),
            "batch": batch}


def cross_entropy_parts(logits, targets, mask, vocab_size: int):
    """(masked NLL sum, mask sum): the unreduced halves of the mean CE.

    The logits go to f32 and a padded vocab is masked to -1e30, as in the
    reference; the target's logit is picked with a gather, where the
    reference contracts a one-hot: in f32 the one-hot contraction adds
    exact zeros to the picked value, so both give the same number, and the
    one-hot would be a (B, S, V) tensor (10 GB at qwen2's train shape on
    the card).  On DTensor logits (a mesh's train step, the vocab sharded
    over ``model``) the log-sum-exp is reduced over the shards and each
    rank picks within its own vocab range (:func:`pick_targets`), so the
    logits are never gathered, which is what the reference's one-hot
    contraction buys it."""
    lf = vocab_logits(logits, vocab_size)
    if is_dtensor(lf):
        m = lf.detach().amax(dim=-1, keepdim=True)
        lse = (m + torch.log(torch.exp(lf - m).sum(dim=-1,
                                                   keepdim=True)))[..., 0]
        picked = pick_targets(lf, targets)
    else:
        lse = torch.logsumexp(lf, dim=-1)
        picked = lf.gather(-1, targets.long()[..., None])[..., 0]
    nll = (lse - picked) * mask
    return nll.sum(), mask.sum()


def pick_targets(lf, targets):
    """``lf[b, s, targets[b, s]]`` of DTensor logits ``lf`` (B, S, V),
    under ``local_map``: a rank whose vocab shard holds the target picks
    it, the others give zero, and the result is ``Partial`` (summed) over
    the mesh dims that shard the vocab.  The batch keeps ``lf``'s
    placements; ``targets`` is redistributed to them."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from torch.distributed.tensor.experimental import local_map
    mesh = lf.device_mesh
    vdim = lf.dim() - 1
    lp, tp, op = [], [], []
    for p in lf.placements:
        if isinstance(p, Shard) and p.dim % lf.dim() == vdim:
            lp.append(Shard(vdim))
            tp.append(Replicate())
            op.append(Partial())
        elif isinstance(p, Shard) and p.dim % lf.dim() == 0:
            lp.append(Shard(0))
            tp.append(Shard(0))
            op.append(Shard(0))
        else:
            lp.append(Replicate())
            tp.append(Replicate())
            op.append(Replicate())
    local, offset = compute_local_shape_and_global_offset(
        lf.shape, mesh, lp)
    lo, n = offset[vdim], local[vdim]

    def pick(lf_l, t_l):
        t = t_l.long() - lo
        inside = (t >= 0) & (t < n)
        val = lf_l.gather(-1, t.clamp(0, max(n - 1, 0))[..., None])[..., 0]
        return torch.where(inside, val, torch.zeros_like(val))
    return local_map(pick, out_placements=op, in_placements=(lp, tp),
                     device_mesh=mesh, redistribute_inputs=True)(lf, targets)


def vocab_logits(logits, vocab_size: int):
    """The logits in f32 with a padded vocab's entries masked to -1e30, as
    the reference's CE and GRPO logprobs take them."""
    V_pad = logits.shape[-1]
    lf = logits.float()
    if V_pad > vocab_size:
        valid = torch.arange(V_pad, device=lf.device) < vocab_size
        lf = lf.masked_fill(~valid, -1e30)
    return lf


def cross_entropy(logits, targets, mask, vocab_size: int):
    """Mean CE over masked tokens; logits may be vocab-padded."""
    nll_sum, mask_sum = cross_entropy_parts(logits, targets, mask, vocab_size)
    return nll_sum / torch.clamp(mask_sum, min=1.0)


def loss_fn(params, batch, cfg, *, moe_dispatch="gshard", remat=True,
            prefix_embeds=None):
    logits, _, metrics = M.forward(params, batch["inputs"], cfg,
                                   prefix_embeds=prefix_embeds, mode="train",
                                   moe_dispatch=moe_dispatch, remat=remat)
    ce = cross_entropy(logits, batch["targets"], batch["mask"],
                       cfg.vocab_size)
    aux = torch.zeros((), dtype=torch.float32, device=ce.device)
    if cfg.moe is not None:
        aux = (cfg.moe.router_aux_coef * metrics["moe_aux_loss"]
               + cfg.moe.router_z_coef * metrics["moe_z_loss"])
    loss = ce + aux
    return loss, {"ce": ce, "aux": aux, **metrics}


def grad_of(fn, params):
    """((loss, metrics), grads) of ``fn(params) -> (loss, metrics)``: the
    gradient with respect to every param leaf, a tree shaped like
    ``params`` (a leaf the loss does not reach gets zeros; on a mesh each
    placed as its param, :func:`_placed_as`).  The leaves record a
    gradient only during the call."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss, metrics = fn(params)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    grads = iter(torch.zeros_like(p) if g is None else _placed_as(g, p)
                 for p, g in zip(leaves, grads))
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), tree_map(lambda _: next(grads), params)


def _placed_as(g, p):
    """The gradient ``g`` placed as its param ``p`` on a mesh, as the
    reference's step gives each gradient its param's sharding: a gradient
    that comes back ``Partial`` (an input shared by the ranks' rows or
    heads) is summed, and one that comes back sharded otherwise (the
    gated norm's scale over d_inner) is placed as the param is, so that
    the update keeps every param's placements."""
    if is_dtensor(g) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def value_and_grad(params, batch, cfg, *, moe_dispatch="gshard",
                   remat=True, prefix_embeds=None):
    """((loss, metrics), grads) of :func:`loss_fn` (:func:`grad_of`).
    ``prefix_embeds`` goes to :func:`loss_fn` as an input, not
    differentiated."""
    return grad_of(lambda p: loss_fn(
        p, batch, cfg, moe_dispatch=moe_dispatch, remat=remat,
        prefix_embeds=prefix_embeds), params)


def make_train_step(cfg, adamw_cfg: opt_mod.AdamWConfig, *,
                    moe_dispatch: str = "gshard", remat: bool = True,
                    multimodal: bool = False, mesh=None, plan=None,
                    offload_cfg=None):
    """step(params, opt_state, batch) -> (params, opt_state, metrics): the
    gradient of :func:`loss_fn`, then :func:`adamw_update`.  ``metrics``
    holds the loss, its parts, the MoE terms, ``grad_norm`` and ``lr``, all
    0-dim tensors on the device (read them at log time: reading one waits
    for the card).  With ``multimodal`` the step takes the batch's
    ``"prefix_embeds"`` (B, P, frontend_dim) as the model's prefix, as the
    reference's step does; without it the key is ignored.

    With ``mesh`` the state and the batch are DTensors placed as
    ``step.shardings`` says (:func:`init_state`, the loader's
    ``make_loader(..., mesh=)``), the step runs under the mesh, and its
    metrics come back as plain replicated tensors.  Without one
    ``step.shardings`` is ``{}``, as the reference's."""
    plan = check_mesh_plan(mesh, plan)

    def step(params, opt_state, batch):
        with use_mesh(mesh):
            pe = batch.get("prefix_embeds") if multimodal else None
            (loss, metrics), grads = value_and_grad(
                params, batch, cfg, moe_dispatch=moe_dispatch, remat=remat,
                prefix_embeds=pe)
            new_params, new_opt, om = opt_mod.adamw_update(
                grads, opt_state, params, adamw_cfg)
            metrics = {"loss": loss, **metrics, **om}
        if mesh is not None:
            metrics = {k: full_tensor(v) for k, v in metrics.items()}
        return new_params, new_opt, metrics
    step.shardings = ({} if mesh is None else train_shardings(
        cfg, mesh, plan, multimodal=multimodal))
    return step


def _place(tree, fn):
    """``fn`` on every host-placeable leaf of ``tree``; the others pass."""
    return tree_map(lambda t: fn(t) if off.host_placeable(t) else t, tree)


def _move(params, opt_state, offload_cfg, fn):
    if offload_cfg.params_on_host:
        params = _place(params, fn)
    if offload_cfg.opt_state_on_host:
        opt_state = opt_mod.AdamWState(mu=_place(opt_state.mu, fn),
                                       nu=_place(opt_state.nu, fn),
                                       count=opt_state.count)
    return params, opt_state


def fetch_state(params, opt_state, offload_cfg, device):
    """Host -> card leg of the HyperOffload cycle: asynchronous copies
    from pinned memory on the current stream, queued ahead of the step.
    A host-placed shard of a DTensor (:class:`~repro_torch.core.offload.
    HostShard`) comes back as the DTensor it was."""
    return _move(params, opt_state, offload_cfg,
                 lambda t: off.to_device_leaf(t, device))


def offload_state(params, opt_state, offload_cfg):
    """Card -> host leg of the HyperOffload cycle: each host-placeable
    leaf copied into pinned host memory by an asynchronous copy on the
    current stream (the card's copy is freed with the step's old state;
    the next :func:`fetch_state` is ordered after it on the stream, and a
    host read of the state synchronises first).  A DTensor leaf leaves
    its local shard there, as a :class:`~repro_torch.core.offload.
    HostShard`."""
    return _move(params, opt_state, offload_cfg, off.to_host_async)


def state_nbytes(params, opt_state, offload_cfg) -> int:
    """Bytes one leg moves on this rank: the local shards of the
    host-placeable leaves it covers."""
    trees = ([params] if offload_cfg.params_on_host else []) + (
        [opt_state.mu, opt_state.nu] if offload_cfg.opt_state_on_host
        else [])
    return sum(off.local_nbytes(t) for tree in trees
               for t in tree_leaves(tree) if off.host_placeable(t))


def init_state(cfg, *, seed: int = 0, device=None, mesh=None, plan=None,
               offload_cfg=None):
    """(params, opt_state) drawn from ``seed`` on ``device`` (the card
    unless the caller names another); with ``offload_cfg`` the params
    and/or the optimizer's moments start in host memory.  With ``mesh``
    every rank draws the full params from the seed, as today, and keeps
    its shard of each leaf as :func:`~repro_torch.core.hypershard.
    derive_param` places it, so the sharded state equals the unsharded one
    from the same seed; the moments follow the params."""
    from repro_torch.serve.runtime import resolve_device
    plan = check_mesh_plan(mesh, plan)
    device = resolve_device(device)
    params = M.init_model(cfg, torch.Generator(device=device)
                          .manual_seed(seed))
    if mesh is not None:
        params = hs.shard_tree(params, hs.make_param_shardings(
            mesh, params, plan))
    opt = opt_mod.init_adamw(params)
    if offload_cfg is not None:
        params, opt = offload_state(params, opt, offload_cfg)
    return params, opt
