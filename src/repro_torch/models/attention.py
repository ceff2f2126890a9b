"""GQA / MHA / sliding-window attention with KV cache.

The port of ``repro.models.attention``.  Entry modes share
one parameter set:
  - ``attn_forward``       : full-sequence (training)
  - ``attn_prefill``       : full-sequence, returns the populated KV cache
  - ``attn_decode``        : one token against a dense cache
  - ``attn_decode_paged`` / ``attn_prefill_paged`` : HyperServe steps over
    the paged pool, lowered ``"fused"`` (block-table-walking kernels) or
    ``"composed"`` (gather ``pool[block_tables]``, then dense attention)

Caches and pool leaves are written in place: the reference returns the
rewritten array (``dynamic_update_slice`` / ``.at[bidx, off].set``) from
a step that donates it, so an in-place write keeps the same memory and the
same result without a copy.  Under a mesh, ``full_attention`` takes the
reference's ring or head-sharded modes (:func:`set_attention_mode`); the
paged steps take DTensor params and pool leaves (HyperServe on a mesh):
q, k and v come out of the column-sharded projections, each rank writes
its own KV heads into its shard of the pool (:func:`write_pages`), the
fused kernels (and, composed, each rank's gathered pages through
``decode_attention`` or flash) run on each rank's heads under
``local_map``, and the row-sharded ``wo`` leaves a partial sum that
DTensor reduces.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.meshctx import (constrain, current_mesh, is_dtensor,
                                      local_index, local_placed,
                                      mesh_axis_size, split_heads)
from repro_torch.kernels import ops, sharded_on
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
    # on a mesh whose model axis does not divide the heads (2 KV heads
    # over 4 ranks) the column shard is gathered before the heads split
    q, k, v = split_heads(q, H), split_heads(k, KV), split_heads(v, KV)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


_ATTN_MODE = "ring"      # "ring" | "head" | "plain": see set_attention_mode


def set_attention_mode(mode: str) -> None:
    """Select the distributed attention strategy, as the reference does.

    ``head``: Megatron-style head-sharded TP (requires KV heads and heads
    divisible by the model axis); q/k/v are redistributed to heads over
    ``model`` and flash runs on each rank's heads under ``local_map``.
    ``ring`` (default): q/k/v stay sequence-sharded over the model axis,
    matching the residual layout; K/V chunks rotate around the ring
    (:mod:`repro_torch.core.ring_attention`).  ``plain``: flash on the
    batch shard, every head and key local.
    """
    global _ATTN_MODE
    if mode not in ("ring", "head", "plain"):
        raise ValueError(f"attention mode {mode!r}: must be 'ring', 'head' "
                         "or 'plain'")
    _ATTN_MODE = mode


def full_attention(q, k, v, *, window=None, scale=None):
    """Strategy-dispatching full-sequence attention (HyperShard-governed):
    with no mesh (or a ``model`` axis of 1) one ``flash_attention``
    launch; under a mesh the reference's dispatch, head mode when
    selected and the heads divide, else ring when applicable, else plain
    (flash under ``local_map`` on the batch shard)."""
    mesh = current_mesh()
    B, S, H, _ = q.shape
    KV = k.shape[2]
    tp = mesh_axis_size(mesh, "model") if mesh is not None else 1
    if (_ATTN_MODE == "head" and mesh is not None and tp > 1
            and KV % tp == 0 and H % tp == 0):
        q = constrain(q, ("pod", "data"), None, "model", None)
        k = constrain(k, ("pod", "data"), None, "model", None)
        v = constrain(v, ("pod", "data"), None, "model", None)
        out = ops.flash_attention(q, k, v, causal=True, window=window,
                                  scale=scale)
        return constrain(out, ("pod", "data"), None, "model", None)
    from repro_torch.core.ring_attention import ring_applicable, \
        ring_attention
    if _ATTN_MODE != "plain" and ring_applicable(mesh, S):
        return ring_attention(q, k, v, mesh, window=window, scale=scale)
    return ops.flash_attention(q, k, v, causal=True, window=window,
                               scale=scale)


def attn_forward(p, x, positions, cfg, *, window: Optional[int] = None):
    """(B, S, D) -> (B, S, D); full-sequence causal attention."""
    B, S, _ = x.shape
    q, k, v = _qkv(p, x, cfg, positions)
    out = full_attention(q, k, v, window=window)
    return out.reshape(B, S, -1) @ p["wo"]


def init_kv_cache(cfg, batch: int, cache_len: int, dtype, device):
    KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    shape = (batch, cache_len, KV, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attn_prefill(p, x, positions, cfg, *, window: Optional[int] = None):
    """Full-sequence forward that also returns the KV cache.

    When ``window`` is set and smaller than S the cache holds only the last
    ``window`` keys (ring layout with slot = pos % window).
    """
    B, S, _ = x.shape
    q, k, v = _qkv(p, x, cfg, positions)
    out = full_attention(q, k, v, window=window)
    if window is not None and window < S:
        # keep last `window` entries, arranged so slot = pos % window
        shift = S % window
        cache = {"k": torch.roll(k[:, -window:], shift, dims=1),
                 "v": torch.roll(v[:, -window:], shift, dims=1)}
    else:
        cache = {"k": k, "v": v}
    return out.reshape(B, S, -1) @ p["wo"], cache


class DecodePosition:
    """One dense decode step's absolute position: ``pos`` as a Python int
    (so that nothing is read back from the card) and its device tensors,
    made once per step and shared by every layer: the (B, 1) ``positions``
    and, per cache length, the (B,) valid lengths."""

    def __init__(self, pos: int, batch: int, device):
        self.pos = pos
        self.positions = torch.full((batch, 1), pos, dtype=torch.int32,
                                    device=device)
        self._lengths: dict = {}

    def lengths(self, cache_len: int) -> torch.Tensor:
        n = min(self.pos + 1, cache_len)
        if n not in self._lengths:
            self._lengths[n] = torch.full(
                self.positions.shape[:1], n, dtype=torch.int32,
                device=self.positions.device)
        return self._lengths[n]


def attn_decode(p, x, pos: DecodePosition, cfg, cache, *,
                window: Optional[int] = None):
    """One-token decode.  x: (B, 1, D); pos: the step's position.

    The cache is a ring buffer when ``window`` is set (slot = pos %
    cache_len), else a linear buffer indexed by absolute position; it is
    written in place.  The ring holds exactly the window, so the kernel
    gets no window: it attends over all ``min(pos + 1, cache_len)`` valid
    entries in any order.  Returns y (B, 1, D).
    """
    B = x.shape[0]
    H, hd = cfg.num_heads, cfg.resolved_head_dim
    cache_len = cache["k"].shape[1]
    q, k, v = _qkv(p, x, cfg, pos.positions)
    slot = (pos.pos % cache_len) if window is not None else pos.pos
    cache["k"][:, slot:slot + 1] = k
    cache["v"][:, slot:slot + 1] = v
    out = ops.decode_attention(q, cache["k"], cache["v"],
                               pos.lengths(cache_len))
    return out.reshape(B, 1, H * hd) @ p["wo"]


def write_pages(pool, bidx, off, val) -> None:
    """``pool[bidx, off] = val`` in place: a one-layer pool view (N, bs, KV,
    hd), (block, offset) index tensors and ``val`` (*idx, KV, hd).  On a
    DTensor pool each rank writes its own KV heads (all of them where the
    pool replicates) from ``val`` placed to match, into its local shard:
    DTensor has no sharding rule for an index_put into a tensor sharded on
    a dim it does not index, and the shard is a view of the pool's own
    storage."""
    if is_dtensor(pool):
        val = local_placed(val, pool.device_mesh,
                           sharded_on(pool, 2, val.dim() - 2))
        pool = pool.to_local()
    pool[bidx, off] = val


def _gather_pages(pool, block_tables):
    """Dense (B, W * block, KV, hd) copy of each row's pages.  On a DTensor
    pool each rank gathers from its own shard of the KV heads
    (:func:`~repro_torch.core.meshctx.local_index`: DTensor has no rule for
    this index), and the copy keeps the pool's placements."""
    B, W = block_tables.shape
    pages = local_index(pool, (block_tables.reshape(-1).long(),))
    return pages.reshape(B, W * pool.shape[1], *pool.shape[2:])


def attn_decode_paged(p, x, positions, cfg, kv, block_tables, *,
                      block_size: int, window: Optional[int] = None,
                      kernels: str = "fused"):
    """One-token decode against the paged KV pool (HyperServe).

    x: (B, 1, D) — one token per batch slot; ``positions``: (B,) absolute
    write position of each slot's token.  ``kv``: {"k","v"} one-layer pool
    views (N_blocks, block, KV, hd), written in place.  ``block_tables``:
    (B, W) int32; padding entries point at the null block and are never
    unmasked.  ``window`` (LOCAL_ATTN) masks keys below ``pos + 1 -
    window``.  ``kernels="fused"`` walks the tables in the kernel;
    ``"composed"`` gathers them into dense K/V and runs
    ``decode_attention``.  Returns y (B, 1, D).
    """
    B = x.shape[0]
    H, hd = cfg.num_heads, cfg.resolved_head_dim
    q, k, v = _qkv(p, x, cfg, positions[:, None])
    bidx = block_tables.gather(
        1, (positions // block_size)[:, None].long())[:, 0].long()
    off = (positions % block_size).long()
    write_pages(kv["k"], bidx, off, k[:, 0])
    write_pages(kv["v"], bidx, off, v[:, 0])
    lengths = (positions + 1).to(torch.int32)
    if kernels == "fused":
        out = ops.paged_decode_attention(q, kv["k"], kv["v"], block_tables,
                                         lengths, block_size=block_size,
                                         window=window)
    else:
        out = ops.decode_attention(q, _gather_pages(kv["k"], block_tables),
                                   _gather_pages(kv["v"], block_tables),
                                   lengths, window=window)
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


def flash_rows(q, k, v, starts, *, window=None, scale=None):
    """Row-wise flash attention with a per-row query offset.

    q: (P, C, H, d); k/v: (P, S, KV, d); starts: (P,) — row ``r``'s
    queries occupy absolute positions ``starts[r] + [0, C)`` over that
    row's own keys.  ONE ``flash_attention`` launch takes the (P,) offset
    tensor, where the reference vmaps a static-offset call per row.
    """
    return ops.flash_attention(q, k, v, causal=True,
                               q_offset=starts.to(torch.int32),
                               window=window, scale=scale)


def attn_prefill_paged(p, x, starts, limits, cfg, kv, block_tables, *,
                       block_size: int, window: Optional[int] = None,
                       kernels: str = "fused"):
    """One batched chunked-prefill step against the paged KV pool.

    x: (P, C, D) — one prompt chunk per row, row ``r``'s first token at
    absolute position ``starts[r]``.  Writes every row's K/V into its own
    pages (in place), then attends each row's chunk queries over that
    row's table (history + chunk) with causal masking from ``starts``.
    ``limits``: (P,) true prompt lengths — positions >= the limit are
    padding; rows with limit 0 are scheduler filler (zeros from the fused
    kernel; the composed path attends them over the null block, and their
    outputs are discarded).  ``kernels`` as in :func:`attn_decode_paged`,
    with ``flash_rows`` on the gathered K/V.  Returns y (P, C, D).
    """
    P, C, _ = x.shape
    H, hd = cfg.num_heads, cfg.resolved_head_dim
    positions = starts[:, None] + torch.arange(C, device=x.device)[None, :]
    q, k, v = _qkv(p, x, cfg, positions)
    bidx, off, _ = paged_chunk_indices(positions, limits, block_tables,
                                       block_size=block_size)
    bidx, off = bidx.long(), off.long()
    write_pages(kv["k"], bidx, off, k)
    write_pages(kv["v"], bidx, off, v)
    if kernels == "fused":
        out = ops.ragged_prefill_attention(
            q, kv["k"], kv["v"], block_tables, starts.to(torch.int32),
            limits.to(torch.int32), block_size=block_size, window=window)
    else:
        out = flash_rows(q, _gather_pages(kv["k"], block_tables),
                         _gather_pages(kv["v"], block_tables), starts,
                         window=window)
    return out.reshape(P, C, H * hd) @ p["wo"]
