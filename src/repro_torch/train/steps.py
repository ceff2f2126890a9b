"""Train-step construction on one device: loss, grad, update, offload.

The port of ``repro.train.steps``.  ``make_train_step`` returns a step
that runs the remat'd train forward (flash attention through its autograd
Function: forward and backward kernels on the card), the cross entropy,
``torch.autograd.grad`` over every param leaf and the reference's AdamW.

HyperOffload's legs between steps are :func:`fetch_state` (host -> card)
and :func:`offload_state` (card -> pinned host memory), and
:func:`init_state` places the state as ``offload_cfg`` says.  The
reference runs them under a mesh; the port's one card stands for a
one-device mesh, on which every leaf of rank >= 2 is fully sharded and
so host-placed, and 1-D leaves stay on the card
(:func:`repro_torch.core.offload.host_placeable`).  A mesh or a plan
(HyperShard layouts, the HyperPlan facade) raises
:class:`~repro_torch.api.errors.PlanError` naming ROADMAP.md's item 8.
"""
from __future__ import annotations

import torch

from repro_torch.api.errors import PlanError
from repro_torch.core import offload as off
from repro_torch.core.kvcache import to_device
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.models import model as M
from repro_torch.optim import adamw as opt_mod

NOT_PORTED = ("the port trains on one device: meshes and plans (HyperShard, "
              "the HyperPlan facade) are ROADMAP.md section 1 item 8")


def refuse_plan(**kw) -> None:
    """Raise :class:`PlanError` for any multi-device argument that is not
    None (``mesh=``, ``plan=``)."""
    given = sorted(k for k, v in kw.items() if v is not None)
    if given:
        raise PlanError(f"{', '.join(given)}: not ported yet; {NOT_PORTED}")


def cross_entropy_parts(logits, targets, mask, vocab_size: int):
    """(masked NLL sum, mask sum): the unreduced halves of the mean CE.

    The logits go to f32 and a padded vocab is masked to -1e30, as in the
    reference; the target's logit is picked with a gather, where the
    reference contracts a one-hot: in f32 the one-hot contraction adds
    exact zeros to the picked value, so both give the same number, and the
    one-hot would be a (B, S, V) tensor (10 GB at qwen2's train shape on
    the card)."""
    lf = vocab_logits(logits, vocab_size)
    lse = torch.logsumexp(lf, dim=-1)
    picked = lf.gather(-1, targets.long()[..., None])[..., 0]
    nll = (lse - picked) * mask
    return nll.sum(), mask.sum()


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
    ``params`` (a leaf the loss does not reach gets zeros).  The leaves
    record a gradient only during the call."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss, metrics = fn(params)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    grads = iter(torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads))
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), tree_map(lambda _: next(grads), params)


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
                    multimodal: bool = False, mesh=None, offload_cfg=None):
    """step(params, opt_state, batch) -> (params, opt_state, metrics): the
    gradient of :func:`loss_fn`, then :func:`adamw_update`.  ``metrics``
    holds the loss, its parts, the MoE terms, ``grad_norm`` and ``lr``, all
    0-dim tensors on the device (read them at log time: reading one waits
    for the card).  With ``multimodal`` the step takes the batch's
    ``"prefix_embeds"`` (B, P, frontend_dim) as the model's prefix, as the
    reference's step does; without it the key is ignored."""
    refuse_plan(mesh=mesh)

    def step(params, opt_state, batch):
        pe = batch.get("prefix_embeds") if multimodal else None
        (loss, metrics), grads = value_and_grad(
            params, batch, cfg, moe_dispatch=moe_dispatch, remat=remat,
            prefix_embeds=pe)
        new_params, new_opt, om = opt_mod.adamw_update(grads, opt_state,
                                                       params, adamw_cfg)
        return new_params, new_opt, {"loss": loss, **metrics, **om}
    return step


def _place(tree, fn):
    """``fn`` on every host-placeable leaf of ``tree``; 1-D leaves pass."""
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
    from pinned memory on the current stream, queued ahead of the step."""
    return _move(params, opt_state, offload_cfg,
                 lambda t: to_device(t, device))


def offload_state(params, opt_state, offload_cfg):
    """Card -> host leg of the HyperOffload cycle: each host-placeable
    leaf copied into pinned host memory by an asynchronous copy on the
    current stream (the card's copy is freed with the step's old state;
    the next :func:`fetch_state` is ordered after it on the stream, and a
    host read of the state synchronises first)."""
    return _move(params, opt_state, offload_cfg, off.to_host_async)


def state_nbytes(params, opt_state, offload_cfg) -> int:
    """Bytes one leg moves: the host-placeable leaves it covers."""
    trees = ([params] if offload_cfg.params_on_host else []) + (
        [opt_state.mu, opt_state.nu] if offload_cfg.opt_state_on_host
        else [])
    return sum(t.numel() * t.element_size() for tree in trees
               for t in tree_leaves(tree) if off.host_placeable(t))


def init_state(cfg, *, seed: int = 0, device=None, mesh=None,
               offload_cfg=None):
    """(params, opt_state) drawn from ``seed`` on ``device`` (the card
    unless the caller names another); with ``offload_cfg`` the params
    and/or the optimizer's moments start in host memory."""
    from repro_torch.serve.runtime import resolve_device
    refuse_plan(mesh=mesh)
    device = resolve_device(device)
    params = M.init_model(cfg, torch.Generator(device=device)
                          .manual_seed(seed))
    opt = opt_mod.init_adamw(params)
    if offload_cfg is not None:
        params, opt = offload_state(params, opt, offload_cfg)
    return params, opt
