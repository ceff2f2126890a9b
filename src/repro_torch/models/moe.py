"""Mixture-of-Experts FFN: shared + routed experts (DeepSeekMoE family).

The port of ``repro.models.moe`` on one device.  The routed experts run
through the sort-based ragged dispatch (:mod:`repro_torch.core.overlap`,
three ``grouped_matmul`` launches a layer), the one that serving takes for
every MoE config.  The reference's GShard capacity dispatch and its
data-parallel ``dp_local`` variant are training and multi-device paths:
they come with the train step (ROADMAP.md, item 4 of "Modules to port").
"""
from __future__ import annotations

import torch

from repro_torch.core.overlap import ragged_moe_apply
from repro_torch.models.common import dense_init, dtype_of, swiglu

DISPATCHES = ("ragged",)


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
    if dispatch in ("gshard", "dp_local"):
        raise NotImplementedError(
            f"moe dispatch {dispatch!r} is a training/multi-device path, "
            "not ported yet (ROADMAP.md, 'Modules to port' item 4: the "
            "train step); use dispatch='ragged'")
    if dispatch not in DISPATCHES:
        raise ValueError(f"moe dispatch {dispatch!r}: must be one of "
                         f"{DISPATCHES + ('gshard', 'dp_local')}")
    mo = cfg.moe
    B, S, D = x.shape
    T = B * S
    xf = x.reshape(T, D)

    probs, logits = router_probs(p, xf, cfg)
    gate_vals, idx = torch.topk(probs, mo.top_k, dim=-1)        # (T, k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    y = ragged_moe_apply(p, xf, idx, gate_vals, cfg)
    # shared experts: dense SwiGLU over all tokens
    y = y + swiglu(xf, p["ws_gate"], p["ws_up"], p["ws_down"])
    y = y.reshape(B, S, D)
    if not metrics:
        return y, {}

    E = mo.num_experts
    me = probs.mean(dim=0)                                      # mean prob
    ce = torch.zeros(E, dtype=torch.float32, device=x.device).scatter_add_(
        0, idx.reshape(-1), torch.ones(idx.numel(), device=x.device)) / T
    return y, {
        "moe_aux_loss": E * torch.sum(me * ce) / mo.top_k,
        "moe_z_loss": torch.mean(torch.logsumexp(logits, dim=-1) ** 2),
        "router_entropy": -torch.mean(
            torch.sum(probs * torch.log(probs + 1e-9), dim=-1)),
    }
