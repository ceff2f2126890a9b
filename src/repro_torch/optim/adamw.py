"""AdamW with f32 moments, pure-functional: the reference's
``repro.optim.adamw`` over the port's param trees.

Not ``torch.optim.AdamW``: its bias correction and eps placement round
differently.  Here every step is the reference's arithmetic, in its order:
the moments in f32, ``count`` an int32 scalar tensor, bias corrections
``b ** count`` taken in f32, the update computed in f32 and cast back to
the param's dtype, weight decay on every leaf of two or more dims (judged
on the stacked leaf, so a ``seg{i}`` norm scale of shape (L, d) decays, as
in the reference), and the clip ``min(1, grad_clip / (gnorm + 1e-9))``
against the global norm over all leaves.  Each call returns new tensors
and leaves its inputs as they were (the reference donates them; dropping
the old trees frees them here).
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch.core.tree import tree_flatten_with_path, tree_leaves, \
    tree_map


class AdamWState(NamedTuple):
    mu: dict
    nu: dict
    count: torch.Tensor


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1
    grad_clip: float = 1.0


def init_adamw(params) -> AdamWState:
    zeros = lambda p: tree_map(  # noqa: E731
        lambda x: torch.zeros_like(x, dtype=torch.float32), p)
    dev = tree_leaves(params)[0].device
    return AdamWState(mu=zeros(params), nu=zeros(params),
                      count=torch.zeros((), dtype=torch.int32, device=dev))


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine to ``min_lr_ratio`` of ``lr``, in f32."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf in f32, the leaves summed
    in the order JAX flattens the tree.  Over DTensor leaves each square
    sum is a partial sum over the shards and the norm is the full one,
    reduced over every shard before the root (a replicated DTensor)."""
    total = 0
    for _, x in tree_flatten_with_path(tree):
        total = total + torch.sum(torch.square(x.float()))
    return torch.sqrt(total)


def adamw_update(grads, state: AdamWState, params, cfg: AdamWConfig):
    """Returns (new_params, new_state, metrics)."""
    return adamw_update_with_norm(grads, state, params, cfg,
                                  global_norm(grads))


@torch.no_grad()
def adamw_update_with_norm(grads, state: AdamWState, params,
                           cfg: AdamWConfig, gnorm):
    """AdamW step with a caller-supplied global grad norm (the pipeline
    trainer's norm over every stage, in the reference)."""
    count = state.count + 1
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = schedule(cfg, count)
    bc1 = 1 - cfg.b1 ** count.float()
    bc2 = 1 - cfg.b2 ** count.float()

    def upd(g, m, v, p):
        g = g.float() * clip
        m2 = cfg.b1 * m + (1 - cfg.b1) * g
        v2 = cfg.b2 * v + (1 - cfg.b2) * g * g
        mhat = m2 / bc1
        vhat = v2 / bc2
        step_ = mhat / (torch.sqrt(vhat) + cfg.eps)
        if p.dim() >= 2:
            step_ = step_ + cfg.weight_decay * p.float()
        p2 = p.float() - lr * step_
        return p2.to(p.dtype), m2, v2

    out = tree_map(upd, grads, state.mu, state.nu, params)
    new_params, new_mu, new_nu = (_unzip(out, params, i) for i in range(3))
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_params, AdamWState(new_mu, new_nu, count), metrics


def _unzip(out, like, i):
    """Item ``i`` of each (param, mu, nu) triple of ``out``, shaped like the
    tree ``like`` (whose leaves ``out``'s triples replaced)."""
    if isinstance(like, dict):
        return {k: _unzip(out[k], v, i) for k, v in like.items()}
    if isinstance(like, (tuple, list)):
        return type(like)(_unzip(o, v, i) for o, v in zip(out, like))
    return out[i]
