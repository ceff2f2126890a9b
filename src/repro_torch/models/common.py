"""Shared model building blocks: norms, RoPE, initialisers.

The port of ``repro.models.common``.  Parameters are nested dicts of
tensors; every random draw comes from an explicit ``torch.Generator`` and
lands on that generator's device.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.meshctx import whole_dims


def dtype_of(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype, *,
               lead=()) -> torch.Tensor:
    """Glorot-scaled normal ``(*lead, d_in, d_out)``; ``lead`` stacks layers."""
    scale = (2.0 / (d_in + d_out)) ** 0.5
    w = torch.randn(*lead, d_in, d_out, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (scale * w).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype) -> torch.Tensor:
    w = torch.randn(vocab, d, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * d ** -0.5).to(dtype)


# ---------------------------------------------------------------------------
# norms / activations
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMS norm scaled by ``1 + scale`` (norm weights are stored as offsets
    from one and initialised to zero, as in the reference)."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


# ---------------------------------------------------------------------------
# RoPE (half-split form, not interleaved)
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    half = head_dim // 2
    return 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half))


@functools.lru_cache(maxsize=None)
def _rope_freqs_on(device: torch.device, head_dim: int,
                   theta: float) -> torch.Tensor:
    """:func:`rope_freqs` on ``device``, copied there once: a blocking
    host-to-device copy synchronises the stream, and a decode step would
    otherwise make two such copies per layer."""
    return torch.from_numpy(rope_freqs(head_dim, theta)).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, D) with D even; positions: (S,) or (B, S)."""
    D = x.shape[-1]
    inv = _rope_freqs_on(x.device, D, theta)                       # (D/2,)
    if positions.ndim == 1:
        ang = positions[None, :, None].float() * inv
    else:
        ang = positions[..., None].float() * inv                   # (B, S, D/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# causal depthwise conv (Mamba / RG-LRU front conv)
# ---------------------------------------------------------------------------
# Written as the reference writes it, K shifted multiply-adds in float32
# rounded once, and not as F.conv1d: on the card a float32 convolution goes
# through cuDNN in TF32 by default, which would break f32 token identity.
def causal_conv1d(x: torch.Tensor, w: torch.Tensor, *, cache=None):
    """Depthwise causal conv.  x: (B, S, C), w: (K, C).

    cache: (B, K-1, C) trailing context from the previous segment (or None).
    Returns (y (B, S, C), new_cache (B, K-1, C)).  On a DTensor (a mesh's
    train step, whose residual is sharded over the sequence) each row is
    made whole first (:func:`~repro_torch.core.meshctx.whole_dims`): the
    shifted slices need every position of a row on one rank; the rows and
    the channels keep their shards.
    """
    x = whole_dims(x, 1)
    cache = None if cache is None else whole_dims(cache, 1)
    B, S, C = x.shape
    K = w.shape[0]
    if cache is None:
        cache = x.new_zeros(B, K - 1, C)
    xp = torch.cat([cache.to(x.dtype), x], dim=1)            # (B, S+K-1, C)
    wf = w.float()
    y = torch.zeros(B, S, C, dtype=torch.float32, device=x.device)
    for i in range(K):
        y = y + xp[:, i:i + S].float() * wf[i]
    new_cache = xp[:, S:] if K > 1 else x.new_zeros(B, 0, C)
    return y.to(x.dtype), new_cache


def conv1d_decode_step(x: torch.Tensor, w: torch.Tensor, cache: torch.Tensor):
    """One-token conv step.  x: (B, C), cache: (B, K-1, C).  Returns
    (y (B, C), new_cache (B, K-1, C)); on a mesh the cache's K-1 steps
    whole on every rank, as :func:`causal_conv1d` takes its rows."""
    cache = whole_dims(cache, 1)
    K = w.shape[0]
    full = torch.cat([cache.to(x.dtype), x[:, None, :]], dim=1)  # (B, K, C)
    wf = w.float()
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(K):
        y = y + full[:, i].float() * wf[i]
    return y.to(x.dtype), full[:, 1:]
