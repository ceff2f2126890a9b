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
rollouts that started on them (:mod:`repro_torch.rl.publish`).  A mesh or a
plan (HyperShard's fsdp/tp layouts) raises
:class:`~repro_torch.api.errors.PlanError`: the learner on a mesh is
ROADMAP.md section 1 item 8d.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.api.errors import PlanError
from repro_torch.configs.base import RLConfig
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
    metrics are 0-dim tensors on the device."""
    refuse_plan(mesh=mesh, plan=plan)

    def step(params, opt_state, batch):
        (loss, metrics), grads = steps_mod.grad_of(
            lambda p: grpo_loss(p, batch, cfg, rl_cfg=rl_cfg,
                                moe_dispatch=moe_dispatch, remat=remat),
            params)
        new_params, new_opt, om = opt_mod.adamw_update(grads, opt_state,
                                                       params, adamw_cfg)
        return new_params, new_opt, {"loss": loss, **metrics, **om}
    return step


def refuse_plan(**kw) -> None:
    """Raise :class:`PlanError` for any multi-device argument that is not
    None (``mesh=``, ``plan=``)."""
    given = sorted(k for k, v in kw.items() if v is not None)
    if given:
        raise PlanError(f"{', '.join(given)}: not ported yet; the RL "
                        "learner on a mesh is ROADMAP.md section 1 item 8d")


class GRPOLearner:
    """Owns the policy being trained: params + AdamW state + the step.

    ``params=None`` initialises fresh from ``seed`` on ``device`` (the card
    unless the caller names another); given params are moved there.
    """

    def __init__(self, cfg, *, rl_cfg: Optional[RLConfig] = None,
                 params=None, adamw: Optional[opt_mod.AdamWConfig] = None,
                 seed: int = 0, moe_dispatch: str = "gshard", obs=None,
                 device=None, mesh=None, plan=None):
        from repro_torch.obs import Observability
        refuse_plan(mesh=mesh, plan=plan)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.obs = obs if obs is not None else Observability()
        self.rl_cfg = rl_cfg or RLConfig()
        adamw = adamw or opt_mod.AdamWConfig(lr=self.rl_cfg.lr,
                                             warmup_steps=0)
        self.step_fn = make_rl_step(cfg, adamw, rl_cfg=self.rl_cfg,
                                    moe_dispatch=moe_dispatch)
        if params is None:
            self.params, self.opt = steps_mod.init_state(cfg, seed=seed,
                                                         device=self.device)
        else:
            self.params = tree_map(lambda t: t.to(self.device), params)
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
            self.params, self.opt, metrics = self.step_fn(
                self.params, self.opt, batch)
            metrics = {k: float(v) for k, v in metrics.items()}
        self.updates += 1
        self.obs.metrics.counter("rl.updates").inc()
        self.obs.metrics.gauge("rl.loss").set(metrics.get("loss", 0.0))
        return metrics

    def dp_size(self) -> int:
        """Row-divisibility the learner batch must satisfy: one device."""
        return 1
