"""Mamba-2 block (SSD, state-space duality, arXiv:2405.21060), PyTorch port
of ``repro.models.mamba2``.

The block: in_proj -> (z, x, B, C, dt) -> causal conv on (x, B, C) -> SiLU
-> chunked SSD scan -> gated RMSNorm -> out_proj, one group (B and C shared
by the heads).  Decode keeps a constant-size recurrent state per row.
``A_log``, ``D`` and ``dt_bias`` are float32 whatever the model's dtype,
as in the reference; dt and A are computed in float32, x, B and C stay in
the model dtype.

Under HyperServe the state lives in a decode seat of the pool
(:class:`~repro_torch.serve.paged_kv.StatePool`), one row per seat plus the
**null seat** (row ``num_slots``): filler rows of a batched prefill carry
that seat, read it and write it, so their writes are dropped from every
live seat without a host sync (torch has no drop mode for an out-of-range
index, and a boolean mask would read the mask back to the host every
layer); the null seat plays the part of the paged pool's null block.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.meshctx import (constrain, local_index,
                                      local_index_put, split_heads)
from repro_torch.kernels import ops
from repro_torch.models.common import (causal_conv1d, conv1d_decode_step,
                                       dense_init, dtype_of, rms_norm)


def init_mamba2(cfg, gen: torch.Generator, *, lead=()):
    """Mamba-2 params; ``lead`` stacks layers on leading axes."""
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    nh = s.num_heads(d)
    dt = dtype_of(cfg)
    dev = gen.device
    conv_ch = di + 2 * s.d_state
    conv_w = torch.randn(*lead, s.conv_width, conv_ch, generator=gen,
                         device=dev, dtype=torch.float32)
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "in_proj": dense_init(gen, d, 2 * di + 2 * s.d_state + nh, dt,
                              lead=lead),
        "conv_w": (conv_w * (1.0 / s.conv_width)).to(dt),
        "A_log": torch.zeros(*lead, nh, **f32),        # A = -exp(A_log) = -1
        "D": torch.ones(*lead, nh, **f32),
        "dt_bias": torch.zeros(*lead, nh, **f32),
        "norm": torch.zeros(*lead, di, dtype=dt, device=dev),
        "out_proj": dense_init(gen, di, d, dt, lead=lead),
    }


def _softplus(v: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(v, 0)."""
    return torch.logaddexp(v, v.new_zeros(()))


def _chunk(chunk_size: int, S: int) -> int:
    """The reference's chunk: min(chunk_size, S), halved while it does not
    divide S (S = 100 gives 100, 1000 gives 8, an odd S gives 1)."""
    chunk = min(chunk_size, S)
    while S % chunk:
        chunk //= 2
    return max(chunk, 1)


DP = ("pod", "data")      # the batch rows' mesh axes


def _split_proj(p, x, cfg):
    """in_proj's output split into z | x B C | dt.  On a mesh its columns
    come sharded over ``model`` (rule ("fsdp", "tp")), and a shard
    boundary falls inside a part (1072 columns over 2 ranks split x B C at
    536), so the output is gathered over every mesh dim but the rows'
    before the split, as the reference's partitioner reshards: each part
    whole on every rank, the rows (and, in training, the whole sequence of
    each row) where the batch is."""
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    nh = s.num_heads(cfg.d_model)
    zxbcdt = x @ p["in_proj"]
    zxbcdt = constrain(zxbcdt, DP, *([None] * (zxbcdt.dim() - 1)))
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:2 * di + 2 * s.d_state]
    dt = zxbcdt[..., 2 * di + 2 * s.d_state:]
    return z, xbc, dt, di, nh


def _scan_inputs(p, xbc, dt, cfg, di):
    """SiLU'd conv output split into x, B, C; dt = softplus(dt + dt_bias)
    and A = -exp(A_log) in float32."""
    N = cfg.ssm.d_state
    xbc = F.silu(xbc)
    xs, Bm, Cm = xbc[..., :di], xbc[..., di:di + N], xbc[..., di + N:]
    dt = _softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    return xs, Bm, Cm, dt, A


def _heads(xs, dt, nh):
    """x split into its ``nh`` heads (:func:`~repro_torch.core.meshctx.
    split_heads`), x and dt with the heads over ``model`` and the rows
    where the batch is: each rank scans its own heads of its own rows (the
    scan's B and C stay whole over the heads)."""
    xh = split_heads(xs, nh)
    lead = (DP,) + (None,) * (xh.dim() - 3)
    return (constrain(xh, *lead, "model", None),
            constrain(dt, *lead, "model"))


def _out(p, y, xh, z, cfg):
    """Skip term (D rounded to x's dtype first, as the reference), gated
    RMSNorm rms_norm(y * silu(z)), out_proj.  On a mesh y comes with its
    heads over ``model``, and z is placed as y's d_inner is (a local slice
    of the gathered projection), so the gate is elementwise on each rank
    and the norm's mean over d_inner a sum over the ranks' parts."""
    D = p["D"].to(xh.dtype)
    y = y + xh * D.reshape((1,) * (xh.ndim - 2) + (-1, 1))
    y = y.reshape(*z.shape)
    z = constrain(z, DP, *([None] * (z.dim() - 2)), "model")
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    return y @ p["out_proj"]


def mamba2_forward(p, x, cfg, *, return_cache=False):
    """x: (B, S, D) -> (B, S, D), full-sequence chunked SSD.  With
    ``return_cache`` also the decode cache {"state": (B, H, P, N), "conv":
    (B, K-1, C)}.  Under grad (``mode="train"``) the scan's inputs require
    grad, so ``ssd_scan`` runs ``SSDScanFn``: the forward kernel, and the
    backward kernel in the backward pass; serving runs under no_grad and
    launches the forward only."""
    s = cfg.ssm
    S = x.shape[1]
    z, xbc, dt, di, nh = _split_proj(p, x, cfg)
    xbc, conv_cache = causal_conv1d(xbc, p["conv_w"])
    xs, Bm, Cm, dt, A = _scan_inputs(p, xbc, dt, cfg, di)
    xh, dt = _heads(xs, dt, nh)
    y, state = ops.ssd_scan(xh, dt, A, Bm, Cm, chunk=_chunk(s.chunk_size, S))
    out = _out(p, y, xh, z, cfg)
    if return_cache:
        return out, {"state": state, "conv": conv_cache}
    return out


def init_mamba2_cache(cfg, batch: int, dtype, device):
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    nh = s.num_heads(cfg.d_model)
    return {
        "state": torch.zeros(batch, nh, s.head_dim, s.d_state, dtype=dtype,
                             device=device),
        "conv": torch.zeros(batch, s.conv_width - 1, di + 2 * s.d_state,
                            dtype=dtype, device=device),
    }


def gather_slot_rows(cache, slots):
    """Per-row copy of the per-seat state for a prefill chunk batch;
    ``slots`` (P,) holds each row's seat, filler rows the null seat (the
    last row of every leaf; the index is clamped to it).  On a mesh each
    rank gathers from its own shard of the seat leaves."""
    idx = slots.long().clamp(0, cache["state"].shape[0] - 1)
    return {k: local_index(v, (idx,)) for k, v in cache.items()}, idx


def scatter_slot_rows(cache, idx, new) -> None:
    """Write each row's new state into its seat, in place.  Live rows hold
    distinct seats; filler rows all write the null seat, which no request
    owns, so their writes are dropped from every live seat.  On a mesh
    each rank writes its own shard of the seat leaves."""
    for k, v in new.items():
        local_index_put(cache[k], (idx,), v)


def conv_tail(xp, off, K: int):
    """Each row's K-1 conv inputs from index ``off`` of ``xp`` (P, T, ch):
    the trailing context a chunk leaves for the next (its channels keep
    ``xp``'s placement on a mesh)."""
    P = xp.shape[0]
    rows = off[:, None] + torch.arange(K - 1, device=off.device)[None, :]
    return local_index(xp, (torch.arange(P, device=off.device)[:, None],
                            rows))


def mamba2_prefill_chunk(p, x, starts, limits, slots, cfg, cache):
    """One batched chunked-prefill step over per-seat state (HyperServe).

    x: (P, C, D), row ``r``'s first token at absolute position
    ``starts[r]``; ``limits[r]`` its prompt length: positions at or past it
    are padding and must not advance the state, so their dt is zeroed
    (decay exp(0) = 1, no input).  ``slots[r]`` picks the row of the
    per-seat ``cache`` leaves ((num_slots + 1, ...), written in place) that
    seeds the scan and takes the final state; each row's conv tail is the
    last K-1 valid inputs, sliced at its ``limit`` so padding never leaks
    into the next chunk.  Returns the block output (P, C, D).
    """
    s = cfg.ssm
    C = x.shape[1]
    st, idx = gather_slot_rows(cache, slots)
    z, xbc, dt, di, nh = _split_proj(p, x, cfg)
    K = p["conv_w"].shape[0]
    xp = torch.cat([st["conv"].to(xbc.dtype), xbc], dim=1)   # (P, C+K-1, ch)
    # xp[r, i] sits at position starts[r] - (K-1) + i, so the tail covering
    # [limit-(K-1), limit) starts at index limit - start, clamped to [0, C]
    # as the reference's dynamic_slice clamps (a non-final chunk keeps its
    # own last K-1 inputs)
    tail = conv_tail(xp, (limits - starts).long().clamp(0, C), K)
    xbc, _ = causal_conv1d(xbc, p["conv_w"], cache=st["conv"])
    xs, Bm, Cm, dt, A = _scan_inputs(p, xbc, dt, cfg, di)
    pos = starts[:, None] + torch.arange(C, device=x.device)[None, :]
    dt = dt * (pos < limits[:, None])[..., None]
    xh, dt = _heads(xs, dt, nh)
    y, fin = ops.ssd_scan(xh, dt, A, Bm, Cm, chunk=_chunk(s.chunk_size, C),
                          init_state=st["state"])
    out = _out(p, y, xh, z, cfg)
    scatter_slot_rows(cache, idx, {"state": fin, "conv": tail})
    return out


def mamba2_decode(p, x, cfg, cache):
    """One-token step.  x: (B, 1, D); cache leaves (B, ...).  Returns
    (out (B, 1, D), new cache) and writes nothing: the caller writes the
    new cache, gated per seat under serving."""
    s = cfg.ssm
    B = x.shape[0]
    z, xbc, dt, di, nh = _split_proj(p, x[:, 0], cfg)
    xbc, conv_cache = conv1d_decode_step(xbc, p["conv_w"], cache["conv"])
    xs, Bm, Cm, dt, A = _scan_inputs(p, xbc, dt, cfg, di)
    xh = xs.reshape(B, nh, s.head_dim)
    y, state = ops.ssd_decode_step(xh, dt, A, Bm, Cm, cache["state"])
    out = _out(p, y, xh, z, cfg)[:, None, :]
    return out, {"state": state, "conv": conv_cache}
