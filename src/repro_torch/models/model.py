"""The causal LM's paged serving steps (HyperServe), PyTorch port.

Parameters keep the reference's stacked layout (``repro.models.model``):
``params["seg{i}"]`` is a tuple of per-sublayer dicts whose leaves carry a
leading ``repeat`` axis, with the reference's leaf names, so the weight
bridge (:mod:`repro_torch.models.bridge`) maps leaf to leaf.  The
reference's ``lax.scan`` over the stacked layers becomes a Python loop
over ``repeat``; slicing a stacked leaf is a view, so the loop copies no
weights and writes each layer's pool pages in place.

The dense ``forward``/``decode_step`` (training and ``Generator``) come in
a later slice with their kernels.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import DENSE_FFN
from repro_torch.core.tree import tree_map
from repro_torch.models import mixers as MX
from repro_torch.models.common import (dense_init, dtype_of, embed_init,
                                       rms_norm, swiglu)
from repro_torch.models.mixers import segments


def _init_sublayer(cfg, kind, gen: torch.Generator, repeat: int):
    mixer, ffn = kind
    d = cfg.d_model
    dt = dtype_of(cfg)
    lead = (repeat,)
    p: dict = {"norm1": torch.zeros(repeat, d, dtype=dt, device=gen.device)}
    spec = MX.get_mixer(mixer)
    p[spec.param_key] = spec.init(cfg, gen, lead=lead)
    if ffn != DENSE_FFN:
        raise NotImplementedError(
            f"{cfg.name}: FFN kind {ffn!r} is not ported yet (ROADMAP.md, "
            "'Modules to port')")
    p["norm2"] = torch.zeros(repeat, d, dtype=dt, device=gen.device)
    p["ffn"] = {
        "w_gate": dense_init(gen, d, cfg.d_ff, dt, lead=lead),
        "w_up": dense_init(gen, d, cfg.d_ff, dt, lead=lead),
        "w_down": dense_init(gen, cfg.d_ff, d, dt, lead=lead),
    }
    return p


def init_model(cfg, gen: torch.Generator):
    """Random params from ``gen``, on ``gen.device``, in ``cfg.dtype``."""
    if cfg.frontend_dim:
        raise NotImplementedError(
            f"{cfg.name}: multimodal frontends are not ported yet")
    dt = dtype_of(cfg)
    params: dict = {
        "embed": embed_init(gen, cfg.padded_vocab, cfg.d_model, dt),
        "final_norm": torch.zeros(cfg.d_model, dtype=dt, device=gen.device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = embed_init(gen, cfg.padded_vocab, cfg.d_model, dt)
    for si, seg in enumerate(segments(cfg)):
        params[f"seg{si}"] = tuple(_init_sublayer(cfg, kd, gen, seg.repeat)
                                   for kd in seg.kinds)
    return params


def _paged_ffn(p, x, cfg):
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    return x + swiglu(h, p["ffn"]["w_gate"], p["ffn"]["w_up"],
                      p["ffn"]["w_down"])


def _layers(params, kv_pools, cfg):
    """Yield (mixer spec, sublayer params, sublayer pool state) in stack
    order, each a view into the stacked leaves of its layer."""
    for si, seg in enumerate(segments(cfg)):
        seg_p, seg_kv = params[f"seg{si}"], kv_pools[f"seg{si}"]
        for li in range(seg.repeat):
            for j, (mixer, _) in enumerate(seg.kinds):
                yield (MX.get_mixer(mixer),
                       tree_map(lambda a: a[li], seg_p[j]),
                       tree_map(lambda a: a[li], seg_kv[j]))


def _unembed(params, cfg):
    return params["embed"] if cfg.tie_embeddings else params["unembed"]


def decode_step_paged(params, tokens, positions, cfg, kv_pools, block_tables,
                      *, block_size: int):
    """Continuous-batching decode: one token per slot at per-slot positions.

    tokens: (B, 1) int; positions: (B,) absolute write positions; kv_pools:
    :class:`~repro_torch.serve.paged_kv.StatePool` state, paged leaves
    (L, N_blocks, block, KV, hd), written in place; block_tables: (B, W)
    int32.  Returns logits (B, 1, V_pad).
    """
    x = F.embedding(tokens.long(), params["embed"])
    for spec, sub_p, kv in _layers(params, kv_pools, cfg):
        x = x + spec.decode_paged(
            sub_p, rms_norm(x, sub_p["norm1"], cfg.norm_eps), positions, cfg,
            kv, block_tables, block_size=block_size, window=spec.window(cfg))
        x = _paged_ffn(sub_p, x, cfg)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x @ _unembed(params, cfg).T


def prefill_chunk_paged(params, tokens, starts, limits, slots, cfg, kv_pools,
                        block_tables, *, block_size: int):
    """One batched chunked-prefill step (HyperServe).

    tokens: (P, C) — every prompt chunk the scheduler admitted this
    iteration, row ``r``'s first token at absolute position ``starts[r]``;
    ``limits``: (P,) true prompt lengths (0 = filler row); ``slots``: (P,)
    decode seats (read by slot-state mixers); block_tables: (P, W).  Writes
    every row's K/V into the pool pages in place and returns the logits of
    each row's last in-chunk prompt token, (P, V_pad) — the only position
    any caller reads, so the unembedding runs over P rows, not P*C.
    """
    P, C = tokens.shape
    x = F.embedding(tokens.long(), params["embed"])
    for spec, sub_p, kv in _layers(params, kv_pools, cfg):
        x = x + spec.prefill_paged(
            sub_p, rms_norm(x, sub_p["norm1"], cfg.norm_eps), starts, limits,
            slots, cfg, kv, block_tables, block_size=block_size,
            window=spec.window(cfg))
        x = _paged_ffn(sub_p, x, cfg)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    # row r's last in-chunk prompt token sits at chunk index
    # min(limit, start + C) - 1 - start (clamped for filler rows)
    last = (torch.minimum(limits, starts + C) - 1 - starts).clamp(0, C - 1)
    x_last = x[torch.arange(P, device=x.device), last.long()]    # (P, D)
    return x_last @ _unembed(params, cfg).T
