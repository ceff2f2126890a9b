"""RecurrentGemma temporal block (RG-LRU recurrence, arXiv:2402.19427),
PyTorch port of ``repro.models.rglru``.

The block: (x-branch: linear -> causal conv -> RG-LRU) * (gate-branch:
linear -> GeLU, tanh form as ``jax.nn.gelu``) -> out projection.  The
local-attention layers of the 1:2 pattern are the attention module with a
sliding window (the ``LOCAL_ATTN`` mixer).  ``lambda`` is float32 whatever
the model's dtype, as in the reference; the gates and the recurrence are
computed in float32 (the scan and its decode step), x stays in the model
dtype.

Under HyperServe the state (the recurrence's (W,) carry and the conv's
K-1 trailing inputs) lives in a decode seat of the pool, one row per seat
plus the null seat that filler prefill rows read and write, as Mamba-2's
does (:mod:`repro_torch.models.mamba2`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.meshctx import constrain
from repro_torch.kernels import ops
from repro_torch.models.common import (causal_conv1d, conv1d_decode_step,
                                       dense_init, dtype_of)
from repro_torch.models.mamba2 import (_softplus, conv_tail,
                                       gather_slot_rows, scatter_slot_rows)


def init_rglru(cfg, gen: torch.Generator, *, lead=()):
    """RG-LRU params; ``lead`` stacks layers on leading axes."""
    r = cfg.rglru
    d = cfg.d_model
    w = r.lru_width or d
    dt = dtype_of(cfg)
    dev = gen.device
    conv_w = torch.randn(*lead, r.conv_width, w, generator=gen, device=dev,
                         dtype=torch.float32)
    # a = sigmoid(lambda) in (0, 1); a^c ~ 0.9..0.999
    lam = torch.linspace(2.0, 6.0, w, dtype=torch.float32, device=dev)
    return {
        "w_x": dense_init(gen, d, w, dt, lead=lead),
        "w_gate": dense_init(gen, d, w, dt, lead=lead),
        "conv_w": (conv_w * (1.0 / r.conv_width)).to(dt),
        "w_input_gate": dense_init(gen, w, w, dt, lead=lead),
        "w_a_gate": dense_init(gen, w, w, dt, lead=lead),
        "lambda": lam.expand(*lead, w).clone(),
        "w_out": dense_init(gen, w, d, dt, lead=lead),
    }


def _log_a(p):
    """log a = log sigmoid(lambda) = -softplus(-lambda) (<= 0), float32."""
    return -_softplus(-p["lambda"])


def _channels(t):
    """On a mesh: ``t`` (B, S, W) or (B, W) with its channels over
    ``model`` and its rows where the batch is, so that the conv and the
    scan (both channelwise) run on each rank's channels of its own rows,
    whole rows (the train step's residual comes sharded over the
    sequence); the identity with no mesh."""
    return constrain(t, ("pod", "data"), *([None] * (t.dim() - 2)), "model")


def _gates(p, xb):
    return (_channels(torch.sigmoid(xb @ p["w_input_gate"])),
            _channels(torch.sigmoid(xb @ p["w_a_gate"])))


def rglru_forward(p, x, cfg, *, return_cache=False):
    """x: (B, S, D) -> (B, S, D).  With ``return_cache`` also the decode
    cache {"state": (B, W), "conv": (B, K-1, W)}.  Under grad
    (``mode="train"``) ``rglru_scan`` runs ``RGLRUScanFn``: the forward
    kernel, and the backward kernel in the backward pass; serving runs
    under no_grad and launches the forward only."""
    gate = _channels(F.gelu(x @ p["w_gate"], approximate="tanh"))
    xb, conv_cache = causal_conv1d(_channels(x @ p["w_x"]), p["conv_w"])
    ig, ag = _gates(p, xb)
    h, state = ops.rglru_scan(xb, ig, ag, _log_a(p))
    y = (h * gate) @ p["w_out"]
    if return_cache:
        return y, {"state": state, "conv": conv_cache}
    return y


def init_rglru_cache(cfg, batch: int, dtype, device):
    w = cfg.rglru.lru_width or cfg.d_model
    return {
        "state": torch.zeros(batch, w, dtype=dtype, device=device),
        "conv": torch.zeros(batch, cfg.rglru.conv_width - 1, w, dtype=dtype,
                            device=device),
    }


def rglru_prefill_chunk(p, x, starts, limits, slots, cfg, cache):
    """One batched chunked-prefill step over per-seat RG-LRU state.

    x: (P, C, D), row ``r``'s first token at absolute position
    ``starts[r]``; positions at or past ``limits[r]`` are padding: their
    recurrence gate is zeroed, which makes a_t = exp(0) = 1 and beta = 0,
    so the state passes through untouched.  ``slots[r]`` picks the row of
    the per-seat ``cache`` leaves ((num_slots + 1, ...), written in place)
    that seeds the scan and takes the final state (filler rows the null
    seat); each row's conv tail is sliced at its limit so padding inputs
    never leak into the next chunk.  Returns the block output (P, C, D).
    """
    C = x.shape[1]
    st, idx = gather_slot_rows(cache, slots)
    gate = _channels(F.gelu(x @ p["w_gate"], approximate="tanh"))
    xb = _channels(x @ p["w_x"])
    K = p["conv_w"].shape[0]
    xp = torch.cat([st["conv"].to(xb.dtype), xb], dim=1)     # (P, C+K-1, W)
    # the tail covering [limit-(K-1), limit) starts at index limit - start
    # of xp, clamped to [0, C] as the reference's dynamic_slice clamps
    tail = conv_tail(xp, (limits - starts).long().clamp(0, C), K)
    xb, _ = causal_conv1d(xb, p["conv_w"], cache=st["conv"])
    ig, ag = _gates(p, xb)
    pos = starts[:, None] + torch.arange(C, device=x.device)[None, :]
    ag = ag * (pos < limits[:, None])[..., None]
    h, fin = ops.rglru_scan(xb, ig, ag, _log_a(p), init_state=st["state"])
    y = (h * gate) @ p["w_out"]
    scatter_slot_rows(cache, idx, {"state": fin, "conv": tail})
    return y


def rglru_decode(p, x, cfg, cache):
    """One-token step.  x: (B, 1, D); cache leaves (B, ...).  Returns
    (y (B, 1, D), new cache) and writes nothing: the caller writes the new
    cache, gated per seat under serving."""
    x0 = x[:, 0]
    gate = F.gelu(x0 @ p["w_gate"], approximate="tanh")
    xb, conv_cache = conv1d_decode_step(x0 @ p["w_x"], p["conv_w"],
                                        cache["conv"])
    ig, ag = _gates(p, xb)
    h, state = ops.rglru_decode_step(xb, ig, ag, _log_a(p), cache["state"])
    y = ((h * gate) @ p["w_out"])[:, None, :]
    return y, {"state": state, "conv": conv_cache}
