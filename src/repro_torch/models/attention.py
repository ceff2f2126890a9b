"""GQA / MHA attention over the paged KV pool (HyperServe steps).

The port of the paged, fused branches of ``repro.models.attention``.  The
pool leaves are written in place: the reference donates the pool to its
jitted step and returns the rewritten array (``.at[bidx, off].set``), so
an in-place ``index_put_`` keeps the same memory and the same result
without a copy.  The dense (training / ``Generator``) paths come with the
``flash_attention``/``decode_attention`` kernels.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops
from repro_torch.models.common import apply_rope, dense_init, dtype_of


def init_attention(cfg, gen: torch.Generator, *, lead=()):
    """Attention params; ``lead`` stacks layers on leading axes."""
    d, H, KV = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd = cfg.resolved_head_dim
    dt = dtype_of(cfg)
    p = {
        "wq": dense_init(gen, d, H * hd, dt, lead=lead),
        "wk": dense_init(gen, d, KV * hd, dt, lead=lead),
        "wv": dense_init(gen, d, KV * hd, dt, lead=lead),
        "wo": dense_init(gen, H * hd, d, dt, lead=lead),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", H * hd), ("bk", KV * hd), ("bv", KV * hd)):
            p[name] = torch.zeros(*lead, width, dtype=dt, device=gen.device)
    return p


def _qkv(p, x, cfg, positions):
    B, S, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, KV, hd)
    v = v.reshape(B, S, KV, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_decode_paged(p, x, positions, cfg, kv, block_tables, *,
                      block_size: int, window: Optional[int] = None):
    """One-token decode against the paged KV pool (HyperServe).

    x: (B, 1, D) — one token per batch slot; ``positions``: (B,) absolute
    write position of each slot's token.  ``kv``: {"k","v"} one-layer pool
    views (N_blocks, block, KV, hd), written in place.  ``block_tables``:
    (B, W) int32; padding entries point at the null block and are never
    unmasked.  ``window`` (LOCAL_ATTN) masks keys below ``pos + 1 -
    window``.  Returns y (B, 1, D).
    """
    B = x.shape[0]
    H, hd = cfg.num_heads, cfg.resolved_head_dim
    q, k, v = _qkv(p, x, cfg, positions[:, None])
    bidx = block_tables.gather(
        1, (positions // block_size)[:, None].long())[:, 0].long()
    off = (positions % block_size).long()
    kv["k"][bidx, off] = k[:, 0]
    kv["v"][bidx, off] = v[:, 0]
    lengths = (positions + 1).to(torch.int32)
    out = ops.paged_decode_attention(q, kv["k"], kv["v"], block_tables,
                                     lengths, block_size=block_size,
                                     window=window)
    return out.reshape(B, 1, H * hd) @ p["wo"]


def paged_chunk_indices(positions, limits, block_tables, *, block_size: int):
    """Per-row (block, offset) write targets for a prefill chunk batch.

    positions: (P, C) absolute token positions; limits: (P,) each row's
    true prompt length; block_tables: (P, W).  Positions >= the row's limit
    are padding — their writes go to the null block (block 0), whose
    contents are never read unmasked.  Returns ``(bidx, off, valid)``, each
    (P, C).
    """
    valid = positions < limits[:, None]
    page = torch.where(valid, positions // block_size, 0).long()
    bidx = torch.where(valid, block_tables.gather(1, page), 0)
    off = torch.where(valid, positions % block_size, 0)
    return bidx, off, valid


def attn_prefill_paged(p, x, starts, limits, cfg, kv, block_tables, *,
                       block_size: int, window: Optional[int] = None):
    """One batched chunked-prefill step against the paged KV pool.

    x: (P, C, D) — one prompt chunk per row, row ``r``'s first token at
    absolute position ``starts[r]``.  Writes every row's K/V into its own
    pages (in place), then attends each row's chunk queries over that
    row's table (history + chunk) with causal masking from ``starts``.
    ``limits``: (P,) true prompt lengths — positions >= the limit are
    padding; rows with limit 0 are scheduler filler.  Returns y (P, C, D).
    """
    P, C, _ = x.shape
    H, hd = cfg.num_heads, cfg.resolved_head_dim
    positions = starts[:, None] + torch.arange(C, device=x.device)[None, :]
    q, k, v = _qkv(p, x, cfg, positions)
    bidx, off, _ = paged_chunk_indices(positions, limits, block_tables,
                                       block_size=block_size)
    bidx, off = bidx.long(), off.long()
    kv["k"][bidx, off] = k
    kv["v"][bidx, off] = v
    out = ops.ragged_prefill_attention(
        q, kv["k"], kv["v"], block_tables, starts.to(torch.int32),
        limits.to(torch.int32), block_size=block_size, window=window)
    return out.reshape(P, C, H * hd) @ p["wo"]
