"""GRPO learner on one device: masked clipped policy-gradient update.

The port of ``repro.rl.learner``, built on the port's train step
(:mod:`repro_torch.train.steps`): the same remat'd train forward (flash
through its autograd Function, the grouped matmul through its own under
the ragged dispatch), ``torch.autograd.grad`` over every param leaf and the
reference's functional AdamW, with the RL objective in place of
cross-entropy.  The logits are temperature-scaled to the SAME distribution
the actor sampled from, so the PPO-style importance ratio

    ratio = exp(logp_learner - logp_behaviour)

starts at ~1 on on-policy data.  Loss per masked response token:

    -min(ratio * A, clip(ratio, 1-eps, 1+eps) * A)

with A the group-relative advantage broadcast over the sample's response.
MoE configs keep their router aux/z losses (same coefficients as
pre-training) so expert balance does not collapse during post-training.

The update is functional: every step returns new param tensors and writes
none of the old ones, so weights the actor was handed keep serving the
rollouts that started on them (:mod:`repro_torch.rl.publish`).

On a mesh (``mesh=`` a ``DeviceMesh``, ``plan=`` a
:class:`~repro_torch.core.hypershard.ShardingPlan`, fsdp_tp by default)
the params and the AdamW moments are DTensors placed by ``hypershard``,
the batch's rows go over the dp axes, and the step runs under
:func:`~repro_torch.core.meshctx.use_mesh` through ``steps.grad_of``, as
the mesh train step does (every family shards; the kernels run on each
rank's shards under ``local_map``).  A facade's ``HyperPlan`` lowers
to its ``ShardingPlan`` (``steps.check_mesh_plan``); what is no plan
raises :class:`~repro_torch.api.errors.PlanError`.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import RLConfig
from repro_torch.core import hypershard as hs
from repro_torch.core.meshctx import full_tensor, is_dtensor, use_mesh
from repro_torch.core.tree import tree_map
from repro_torch.models import model as M
from repro_torch.optim import adamw as opt_mod
from repro_torch.serve.runtime import resolve_device
from repro_torch.train import steps as steps_mod


def token_logprobs(logits, targets, vocab_size: int, *,
                   temperature: float = 1.0):
    """Per-token logprob of ``targets`` under temperature-scaled logits,
    in f32; padded vocab entries are masked to -1e30 before the
    logsumexp.  The target's logit is picked with a gather where the
    reference contracts a one-hot (the same number in f32, as in the
    port's cross entropy; the one-hot would be logits-sized)."""
    lf = steps_mod.vocab_logits(logits, vocab_size) / max(temperature, 1e-6)
    if is_dtensor(lf):
        # the learner on a mesh, the vocab over ``model``: the log-sum-exp
        # reduced over the shards, each rank picking within its own vocab
        # range (``steps.pick_targets``), as the mesh's cross entropy does
        m = lf.detach().amax(dim=-1, keepdim=True)
        lse = (m + torch.log(torch.exp(lf - m).sum(dim=-1,
                                                   keepdim=True)))[..., 0]
        return steps_mod.pick_targets(lf, targets) - lse
    lse = torch.logsumexp(lf, dim=-1)
    picked = lf.gather(-1, targets.long()[..., None])[..., 0]
    return picked - lse


def grpo_loss(params, batch, cfg, *, rl_cfg: RLConfig,
              moe_dispatch: str = "gshard", remat: bool = True):
    """(loss, metrics) of one GRPO batch (:meth:`RolloutBuffer.batch`'s
    arrays as tensors on the params' device)."""
    logits, _, metrics = M.forward(params, batch["inputs"], cfg,
                                   mode="train", moe_dispatch=moe_dispatch,
                                   remat=remat)
    logp = token_logprobs(logits, batch["targets"], cfg.vocab_size,
                          temperature=rl_cfg.temperature)
    mask = batch["mask"]
    n_tok = torch.clamp(mask.sum(), min=1.0)
    ratio = torch.exp(logp - batch["behaviour_logp"]) * mask
    adv = batch["advantages"][:, None]
    clipped = torch.clamp(ratio, 1.0 - rl_cfg.clip_eps, 1.0 + rl_cfg.clip_eps)
    pg = -torch.minimum(ratio * adv, clipped * adv)
    pg_loss = (pg * mask).sum() / n_tok
    aux = torch.zeros((), dtype=torch.float32, device=logp.device)
    if cfg.moe is not None:
        aux = (cfg.moe.router_aux_coef * metrics["moe_aux_loss"]
               + cfg.moe.router_z_coef * metrics["moe_z_loss"])
    loss = pg_loss + aux
    clip_frac = ((torch.abs(ratio - clipped) > 0) * mask).sum() / n_tok
    return loss, {"pg_loss": pg_loss, "aux": aux,
                  "ratio_mean": (ratio * mask).sum() / n_tok,
                  "clip_fraction": clip_frac,
                  "logp_mean": (logp * mask).sum() / n_tok, **metrics}


def make_rl_step(cfg, adamw_cfg: opt_mod.AdamWConfig, *, rl_cfg: RLConfig,
                 moe_dispatch: str = "gshard", remat: bool = True,
                 mesh=None, plan=None):
    """step(params, opt_state, batch) -> (params, opt_state, metrics): the
    twin of :func:`repro_torch.train.steps.make_train_step` with the GRPO
    batch contract: inputs/targets (B, S) int32, mask/behaviour_logp (B, S)
    float32, advantages (B,) float32, all on the params' device.  The
    metrics are 0-dim tensors on the device.

    With ``mesh`` the state and the batch are DTensors placed as
    ``step.shardings`` says (:func:`rl_shardings`), the step runs under the
    mesh and its metrics come back as plain replicated tensors.  Without
    one ``step.shardings`` is ``{}``, as the reference's."""
    plan = steps_mod.check_mesh_plan(mesh, plan)

    def step(params, opt_state, batch):
        with use_mesh(mesh):
            (loss, metrics), grads = steps_mod.grad_of(
                lambda p: grpo_loss(p, batch, cfg, rl_cfg=rl_cfg,
                                    moe_dispatch=moe_dispatch, remat=remat),
                params)
            new_params, new_opt, om = opt_mod.adamw_update(
                grads, opt_state, params, adamw_cfg)
            metrics = {"loss": loss, **metrics, **om}
        if mesh is not None:
            metrics = {k: full_tensor(v) for k, v in metrics.items()}
        return new_params, new_opt, metrics
    step.shardings = {} if mesh is None else rl_shardings(cfg, mesh, plan)
    return step


def rl_shardings(cfg, mesh, plan):
    """The reference's ``shardings`` of the GRPO step: the train step's
    ``params`` and ``opt_in``, and the batch's rows over the dp axes
    (``inputs``, ``targets``, ``mask``, ``behaviour_logp`` by rows,
    ``advantages`` (B,) by its one dim)."""
    from repro_torch.core.meshctx import dp_entry
    from repro_torch.data.pipeline import batch_sharding
    out = steps_mod.train_shardings(cfg, mesh, plan)
    rows = batch_sharding(mesh)
    out["batch"] = {k: rows for k in ("inputs", "targets", "mask",
                                      "behaviour_logp")}
    out["batch"]["advantages"] = hs.NamedSharding(mesh, (dp_entry(mesh),))
    return out


def dp_size(mesh) -> int:
    """Row-divisibility a learner batch on ``mesh`` must satisfy: the
    product of its ``pod`` and ``data`` axes (1 with no mesh)."""
    if mesh is None:
        return 1
    n = 1
    for a, k in zip(mesh.mesh_dim_names, mesh.shape):
        if a in ("pod", "data"):
            n *= int(k)
    return n


class GRPOLearner:
    """Owns the policy being trained: params + AdamW state + the step.

    ``params=None`` initialises fresh from ``seed`` on ``device`` (the card
    unless the caller names another); given params (the full tensors) are
    moved there.  With ``mesh`` every rank keeps its shard of each leaf as
    ``plan`` places it (the full params the same on every rank).
    """

    def __init__(self, cfg, *, rl_cfg: Optional[RLConfig] = None,
                 params=None, adamw: Optional[opt_mod.AdamWConfig] = None,
                 seed: int = 0, moe_dispatch: str = "gshard", obs=None,
                 device=None, mesh=None, plan=None):
        from repro_torch.obs import Observability
        self.plan = steps_mod.check_mesh_plan(mesh, plan)
        self.cfg = cfg
        self.mesh = mesh
        self.device = resolve_device(device)
        self.obs = obs if obs is not None else Observability()
        self.rl_cfg = rl_cfg or RLConfig()
        adamw = adamw or opt_mod.AdamWConfig(lr=self.rl_cfg.lr,
                                             warmup_steps=0)
        self.step_fn = make_rl_step(cfg, adamw, rl_cfg=self.rl_cfg,
                                    moe_dispatch=moe_dispatch, mesh=mesh,
                                    plan=self.plan)
        self.shardings = self.step_fn.shardings
        if params is None:
            self.params, self.opt = steps_mod.init_state(
                cfg, seed=seed, device=self.device, mesh=mesh,
                plan=self.plan)
        else:
            self.params = tree_map(lambda t: t.to(self.device), params)
            if mesh is not None:
                self.params = hs.shard_tree(self.params,
                                            self.shardings["params"])
            self.opt = opt_mod.init_adamw(self.params)
        self.updates = 0

    def update(self, batch) -> dict:
        """One GRPO step over a :meth:`RolloutBuffer.batch` dict."""
        # the batch shape is pad_len_to-bucketed upstream; a NEW shape key
        # here is the reference's genuine retrace of the GRPO step
        self.obs.record_compile(
            "rl_step", tuple(tuple(v.shape) for _, v in sorted(batch.items())))
        with self.obs.trace.span("rl.update", track="learner",
                                 rows=len(batch["advantages"])):
            batch = {k: torch.from_numpy(np.asarray(v)).to(self.device)
                     for k, v in batch.items()}
            if self.mesh is not None:
                sh = self.shardings["batch"]
                batch = {k: hs.distribute(v, sh[k].mesh, sh[k].placements)
                         for k, v in batch.items()}
            self.params, self.opt, metrics = self.step_fn(
                self.params, self.opt, batch)
            metrics = {k: float(v) for k, v in metrics.items()}
        self.updates += 1
        self.obs.metrics.counter("rl.updates").inc()
        self.obs.metrics.gauge("rl.loss").set(metrics.get("loss", 0.0))
        return metrics

    def dp_size(self) -> int:
        """Row-divisibility the learner batch must satisfy (dp axes)."""
        return dp_size(self.mesh)
