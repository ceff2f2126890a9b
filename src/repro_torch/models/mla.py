"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434).

The port of ``repro.models.mla``.  Prefill and train use the
decompressed form through the port's ``full_attention`` / ``flash_rows``
(one ``flash_attention`` launch with key and value head dims
``nope + rope`` and ``v_head_dim``).  Decode uses the absorbed form: the
cache holds only the compressed latent ``c_kv`` (kv_lora_rank) and the
shared RoPE key, and ``W_uk``/``W_uv`` are absorbed into the query and
output projections.  Under paged serving the fused decode walks the latent
pages in ``paged_mla_decode_attention``; the composed one gathers them
and runs the reference's plain einsum form, as the dense decode does.

Caches and pool leaves are written in place, as in
:mod:`repro_torch.models.attention`.

On a mesh (DTensor params, HyperShard's rules) the query, ``w_uk`` and
``w_uv`` projections are column-sharded over ``model``, so the heads
shard there; ``w_dkv``'s output is taken whole before it is split into
the latents and normalised (its shard boundary need not fall on the
c_kv | k_rope one); ``wo`` is row-sharded, its product a ``Partial`` sum.
The latent pool replicates (``derive_pool``: it has no head dim), so
every rank writes the same latents into its own full copy and reads its
pages locally, and the fused decode runs on each rank's heads under
``local_map``.
"""
from __future__ import annotations

import torch

from repro_torch.core.meshctx import (local_index, local_index_put,
                                      replicated, split_heads)
from repro_torch.kernels import ops
from repro_torch.models.attention import (flash_rows, full_attention,
                                          paged_chunk_indices)
from repro_torch.models.common import apply_rope, dense_init, dtype_of, \
    rms_norm


def init_mla(cfg, gen: torch.Generator, *, lead=()):
    """MLA params; ``lead`` stacks layers on leading axes."""
    m = cfg.mla
    d, H = cfg.d_model, cfg.num_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    dt = dtype_of(cfg)
    return {
        "wq": dense_init(gen, d, H * qk, dt, lead=lead),
        "w_dkv": dense_init(gen, d, m.kv_lora_rank + m.qk_rope_head_dim, dt,
                            lead=lead),
        "kv_norm": torch.zeros(*lead, m.kv_lora_rank, dtype=dt,
                               device=gen.device),
        "w_uk": dense_init(gen, m.kv_lora_rank, H * m.qk_nope_head_dim, dt,
                           lead=lead),
        "w_uv": dense_init(gen, m.kv_lora_rank, H * m.v_head_dim, dt,
                           lead=lead),
        "wo": dense_init(gen, H * m.v_head_dim, d, dt, lead=lead),
    }


def _scale(m) -> float:
    return (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5


def _latents(p, x, positions, cfg):
    """Shared query/latent computation.  Returns q_nope, q_rope, c_kv,
    k_rope."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.num_heads
    q = split_heads(x @ p["wq"], H)
    q_nope, q_rope = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim], -1)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    # on a mesh w_dkv is column-sharded, its output split over the ranks
    # across the c_kv | k_rope boundary, and kv_norm reduces over all of
    # c_kv: both are taken whole (an all-gather), the latents replicated
    dkv = replicated(x @ p["w_dkv"])
    c_kv, k_rope = dkv.split([m.kv_lora_rank, m.qk_rope_head_dim], -1)
    c_kv = rms_norm(c_kv, p["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)
    return q_nope, q_rope, c_kv, k_rope[:, :, 0, :]


def _decompress(p, c_kv, k_rope, cfg):
    """Per-head keys (B, S, H, nope + rope) and values (B, S, H, v_dim)
    from the latents (B, S, R) and the shared rope keys (B, S, rope)."""
    m = cfg.mla
    B, S, _ = c_kv.shape
    H = cfg.num_heads
    k_nope = split_heads(c_kv @ p["w_uk"], H)
    v = split_heads(c_kv @ p["w_uv"], H)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        B, S, H, m.qk_rope_head_dim)], dim=-1)
    return k, v


def mla_forward(p, x, positions, cfg, *, window=None, return_cache=False):
    """Full-sequence MLA (decompressed form): (B, S, D) -> (B, S, D), and
    with ``return_cache`` the latent cache {"ckv", "krope"}."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.num_heads
    q_nope, q_rope, c_kv, k_rope = _latents(p, x, positions, cfg)
    k, v = _decompress(p, c_kv, k_rope, cfg)
    q = torch.cat([q_nope, q_rope], dim=-1)
    out = full_attention(q, k, v, window=window, scale=_scale(m))
    y = out.reshape(B, S, H * m.v_head_dim) @ p["wo"]
    if return_cache:
        return y, {"ckv": c_kv, "krope": k_rope}
    return y


def init_mla_cache(cfg, batch: int, cache_len: int, dtype, device):
    m = cfg.mla
    return {"ckv": torch.zeros(batch, cache_len, m.kv_lora_rank, dtype=dtype,
                               device=device),
            "krope": torch.zeros(batch, cache_len, m.qk_rope_head_dim,
                                 dtype=dtype, device=device)}


def init_mla_pool(cfg, *, layers: int, num_blocks: int, block_size: int,
                  dtype, device):
    """Paged serving state: the compressed latents page like KV, one
    (L, N_blocks, block, R) pool per leaf — pages hold rank-R latents, not
    per-head K/V."""
    m = cfg.mla
    return {"ckv": torch.zeros(layers, num_blocks, block_size,
                               m.kv_lora_rank, dtype=dtype, device=device),
            "krope": torch.zeros(layers, num_blocks, block_size,
                                 m.qk_rope_head_dim, dtype=dtype,
                                 device=device)}


def _absorbed_q(p, q_nope, cfg):
    """W_uk absorbed into the query: (B, H, nope) -> (B, H, R)."""
    m = cfg.mla
    w_uk = split_heads(p["w_uk"], cfg.num_heads)
    return torch.einsum("bhd,rhd->bhr", q_nope, w_uk)


def _latent_attention(q_lat, q_rope, ckv, krope, lengths, scale):
    """The reference's plain absorbed attention over dense latents:
    ckv (B, S, R), krope (B, S, rope), keys below ``lengths`` (B,)
    visible.  Returns the f32 latent read-out (B, H, R)."""
    S = ckv.shape[1]
    ckv = ckv.float()
    s = (torch.einsum("bhr,bsr->bhs", q_lat.float(), ckv)
         + torch.einsum("bhd,bsd->bhs", q_rope.float(), krope.float())) \
        * scale
    mask = (torch.arange(S, device=ckv.device)[None, None, :]
            < lengths[:, None, None])
    pr = torch.softmax(s.masked_fill(~mask, -1e30), dim=-1)
    return torch.einsum("bhs,bsr->bhr", pr, ckv)


def _readout(p, o_lat, x, cfg):
    """W_uv absorbed on the way out, then the output projection."""
    m = cfg.mla
    B, H = o_lat.shape[0], cfg.num_heads
    w_uv = split_heads(p["w_uv"], H)
    o = torch.einsum("bhr,rhd->bhd", o_lat, w_uv.float())
    return o.reshape(B, 1, H * m.v_head_dim).to(x.dtype) @ p["wo"]


def mla_decode(p, x, pos, cfg, cache, *, window=None):
    """Absorbed-matmul decode against a dense latent cache.  x: (B, 1, D);
    pos: the step's :class:`~repro_torch.models.attention.DecodePosition`.
    The cache is a ring when ``window`` is set (slot = pos % cache_len);
    it is written in place.  Returns y (B, 1, D)."""
    q_nope, q_rope, c_new, kr_new = _latents(p, x, pos.positions, cfg)
    cache_len = cache["ckv"].shape[1]
    slot = (pos.pos % cache_len) if window is not None else pos.pos
    cache["ckv"][:, slot:slot + 1] = c_new
    cache["krope"][:, slot:slot + 1] = kr_new
    o_lat = _latent_attention(_absorbed_q(p, q_nope[:, 0], cfg),
                              q_rope[:, 0], cache["ckv"], cache["krope"],
                              pos.lengths(cache_len), _scale(cfg.mla))
    return _readout(p, o_lat, x, cfg)


def mla_decode_paged(p, x, positions, cfg, kv, block_tables, *,
                     block_size: int, kernels: str = "fused"):
    """Absorbed-matmul decode against the paged latent pool (HyperServe).

    x: (B, 1, D) one token per slot; ``positions``: (B,) absolute write
    positions; ``kv``: {"ckv", "krope"} one-layer pool views (N_blocks,
    block, R) / (N_blocks, block, rope), written in place;
    ``block_tables``: (B, W).  ``kernels="fused"`` walks the tables in
    ``paged_mla_decode_attention`` (W_uk absorbed into the query before,
    W_uv applied after: the kernel works in the rank-R latent space);
    ``"composed"`` gathers the pages and runs the plain absorbed form.
    Returns y (B, 1, D).
    """
    m = cfg.mla
    B = x.shape[0]
    q_nope, q_rope, c_new, kr_new = _latents(p, x, positions[:, None], cfg)
    bidx = block_tables.gather(
        1, (positions // block_size)[:, None].long())[:, 0].long()
    off = (positions % block_size).long()
    local_index_put(kv["ckv"], (bidx, off), c_new[:, 0])
    local_index_put(kv["krope"], (bidx, off), kr_new[:, 0])
    q_lat = _absorbed_q(p, q_nope[:, 0], cfg)                    # (B, H, R)
    lengths = (positions + 1).to(torch.int32)
    if kernels == "fused":
        o_lat = ops.paged_mla_decode_attention(
            q_lat, q_rope[:, 0], kv["ckv"], kv["krope"], block_tables,
            lengths, block_size=block_size, scale=_scale(m))
    else:
        W = block_tables.shape[1]
        idx = (block_tables.long(),)
        o_lat = _latent_attention(
            q_lat, q_rope[:, 0],
            local_index(kv["ckv"], idx).reshape(B, W * block_size,
                                                m.kv_lora_rank),
            local_index(kv["krope"], idx).reshape(B, W * block_size,
                                                  m.qk_rope_head_dim),
            lengths, _scale(m))
    return _readout(p, o_lat, x, cfg)


def mla_prefill_chunk_paged(p, x, starts, limits, cfg, kv, block_tables, *,
                            block_size: int, kernels: str = "fused"):
    """One batched chunked-prefill step against the paged latent pool.

    Every row's latents are written to its pages in one scatter (padding
    positions at or past the row's ``limit`` go to the null block), then
    each row's chunk queries attend its gathered table in decompressed
    form: one ``flash_rows`` launch with per-row offsets ``starts``.
    ``kernels`` is accepted for hook-signature uniformity: MLA prefill
    always takes this composed path, as in the reference (a fused variant
    would decompress inside the kernel).  Returns y (P, C, D).
    """
    del kernels
    m = cfg.mla
    P, C, _ = x.shape
    H = cfg.num_heads
    positions = starts[:, None] + torch.arange(C, device=x.device)[None, :]
    q_nope, q_rope, c_kv, k_rope = _latents(p, x, positions, cfg)
    bidx, off, _ = paged_chunk_indices(positions, limits, block_tables,
                                       block_size=block_size)
    bidx, off = bidx.long(), off.long()
    local_index_put(kv["ckv"], (bidx, off), c_kv)
    local_index_put(kv["krope"], (bidx, off), k_rope)
    W = block_tables.shape[1]
    idx = (block_tables.long(),)
    ckv_seq = local_index(kv["ckv"], idx).reshape(P, W * block_size,
                                                  m.kv_lora_rank)
    krope_seq = local_index(kv["krope"], idx).reshape(P, W * block_size,
                                                      m.qk_rope_head_dim)
    k, v = _decompress(p, ckv_seq, krope_seq, cfg)
    q = torch.cat([q_nope, q_rope], dim=-1)
    out = flash_rows(q, k, v, starts, scale=_scale(m))
    return out.reshape(P, C, H * m.v_head_dim) @ p["wo"]
