"""The causal LM, PyTorch port of ``repro.models.model``.

Parameters keep the reference's stacked layout: ``params["seg{i}"]`` is a
tuple of per-sublayer dicts whose leaves carry a leading ``repeat`` axis,
with the reference's leaf names, so the weight bridge
(:mod:`repro_torch.models.bridge`) maps leaf to leaf.  The reference's
``lax.scan`` over the stacked layers becomes a Python loop over
``repeat``; slicing a stacked leaf is a view, so the loop copies no
weights, and the decode steps write each layer's cache or pool pages in
place (where the reference returns the updated arrays).

Modes:
  forward(..., mode="train")    -> logits, None, metrics
  forward(..., mode="prefill")  -> logits, caches, metrics
  decode_step(...)              -> logits (caches written in place)
  decode_step_paged / prefill_chunk_paged -> logits (pool written in place)

The serving steps' MoE FFN takes the sort-based ragged dispatch (sort,
grouped matmuls, unsort), the one the reference's serving resolves every
MoE config to.  ``forward`` takes the reference's ``moe_dispatch`` (default
``"gshard"``, the train step's; ``"dp_local"`` runs on a mesh and falls
back to ``"ragged"`` without one, as the reference's; the Generator passes
``"ragged"``), and the reference's multimodal prefix
(``prefix_embeds`` through ``frontend_proj``, internvl2-26b's and
musicgen-large's stubbed frontends).

``forward(..., mode="train", remat=True)`` runs each repeat of a segment
under ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` of
the scan body), so a layer's activations are recomputed in the backward
pass; the layer returns its MoE loss terms as values, which the
recompute then drops instead of adding twice.  Unrolling, which shapes
the reference's compiled programs, has no counterpart in eager PyTorch.

The paged steps take the same code on a mesh (HyperServe tensor-parallel,
its params and pool leaves DTensors, the step under ``use_mesh``): DTensor
propagates the projections and reductions, and the mixers do their pool
writes, seat gathers and kernel calls on local shards.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import DENSE_FFN, MOE_FFN, NO_FFN
from repro_torch.core.meshctx import constrain, is_dtensor, replicated
from repro_torch.core.tree import tree_map
from repro_torch.models import mixers as MX, moe as moe_mod
from repro_torch.models.attention import DecodePosition
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
    if ffn not in (DENSE_FFN, MOE_FFN, NO_FFN):
        raise NotImplementedError(
            f"{cfg.name}: FFN kind {ffn!r} is not ported yet (ROADMAP.md, "
            "'Modules to port')")
    if ffn == NO_FFN:              # mamba2 blocks: no norm2, no FFN
        return p
    p["norm2"] = torch.zeros(repeat, d, dtype=dt, device=gen.device)
    if ffn == MOE_FFN:
        p["ffn"] = moe_mod.init_moe(cfg, gen, lead=lead)
        return p
    p["ffn"] = {
        "w_gate": dense_init(gen, d, cfg.d_ff, dt, lead=lead),
        "w_up": dense_init(gen, d, cfg.d_ff, dt, lead=lead),
        "w_down": dense_init(gen, cfg.d_ff, d, dt, lead=lead),
    }
    return p


def init_model(cfg, gen: torch.Generator):
    """Random params from ``gen``, on ``gen.device``, in ``cfg.dtype``.  An
    arch with a multimodal prefix (``cfg.frontend_dim``) also gets the
    reference's ``frontend_proj`` (frontend_dim, d_model), which projects
    its stubbed frontend's embeddings into the model."""
    dt = dtype_of(cfg)
    params: dict = {
        "embed": embed_init(gen, cfg.padded_vocab, cfg.d_model, dt),
        "final_norm": torch.zeros(cfg.d_model, dtype=dt, device=gen.device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = embed_init(gen, cfg.padded_vocab, cfg.d_model, dt)
    if cfg.frontend_dim:
        params["frontend_proj"] = dense_init(gen, cfg.frontend_dim,
                                             cfg.d_model, dt)
    for si, seg in enumerate(segments(cfg)):
        params[f"seg{si}"] = tuple(_init_sublayer(cfg, kd, gen, seg.repeat)
                                   for kd in seg.kinds)
    return params


def _ffn(p, x, cfg, ffn, metrics=None, dispatch="ragged"):
    """The FFN leg: x + FFN(norm2(x)), or x for a block without one.  For
    the MoE FFN, ``metrics`` (a dict) accumulates the router's loss terms;
    None skips computing them."""
    if ffn == NO_FFN:
        return x
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    if ffn == MOE_FFN:
        y, mm = moe_mod.moe_forward(p["ffn"], h, cfg, dispatch=dispatch,
                                    metrics=metrics is not None)
        if metrics is not None:
            for name in ("moe_aux_loss", "moe_z_loss"):
                metrics[name] = metrics[name] + mm[name]
        return x + y
    return x + swiglu(h, p["ffn"]["w_gate"], p["ffn"]["w_up"],
                      p["ffn"]["w_down"])


def _layers(params, cfg, states=None):
    """Yield (mixer kind, ffn kind, sublayer params, sublayer state) in
    stack order, each a view into the stacked leaves of its layer (state
    None when ``states`` is None)."""
    for si, seg in enumerate(segments(cfg)):
        seg_p = params[f"seg{si}"]
        for li in range(seg.repeat):
            for j, (mixer, ffn) in enumerate(seg.kinds):
                yield (mixer, ffn, tree_map(lambda a: a[li], seg_p[j]),
                       None if states is None else
                       tree_map(lambda a: a[li], states[f"seg{si}"][j]))


# ---------------------------------------------------------------------------
# per-sublayer forward / decode / cache — mixer dispatch is one registry
# lookup; only the FFN leg lives here
# ---------------------------------------------------------------------------
def _layer_forward(layer_p, kinds, x, positions, cfg, *, mode,
                   window_override, moe_dispatch):
    """One repeat of a segment: (x, the sublayers' caches, MoE aux loss,
    MoE z loss), the loss terms as values (not written to a dict outside),
    so a checkpointed recompute cannot add them twice."""
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    metrics = {"moe_aux_loss": zero, "moe_z_loss": zero}
    caches = []
    x = constrain(x, ("pod", "data"), "model", None)
    for p, (mixer, ffn) in zip(layer_p, kinds):
        h = rms_norm(x, p["norm1"], cfg.norm_eps)
        w = MX.resolve_window(cfg, mixer, window_override)
        y, cache = MX.get_mixer(mixer).forward(p, h, positions, cfg, window=w,
                                               want_cache=mode == "prefill")
        x = _ffn(p, x + y, cfg, ffn, metrics, moe_dispatch)
        caches.append(cache)
    return x, tuple(caches), metrics["moe_aux_loss"], metrics["moe_z_loss"]


def _sublayer_decode(p, x, pos, cfg, kind, cache, *, window_override):
    mixer, ffn = kind
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    w = MX.resolve_window(cfg, mixer, window_override)
    y = MX.get_mixer(mixer).decode(p, h, pos, cfg, cache, window=w)
    return _ffn(p, x + y, cfg, ffn)


def _init_sublayer_cache(cfg, kind, batch, cache_len, dtype, window_override,
                         device):
    mixer, _ = kind
    w = MX.resolve_window(cfg, mixer, window_override)
    eff_len = min(cache_len, w) if w is not None else cache_len
    return MX.get_mixer(mixer).init_cache(cfg, batch, eff_len, dtype, device)


# ---------------------------------------------------------------------------
# forward (train / prefill)
# ---------------------------------------------------------------------------
def forward(params, tokens, cfg, *, prefix_embeds=None, mode="train",
            window_override=None, moe_dispatch="gshard", remat=True):
    """tokens: (B, S) int.  Returns (logits (B, S, V_pad), caches | None,
    metrics).  ``mode="prefill"`` also returns each layer's KV cache,
    stacked per segment like the params (windowed caches in ring layout).
    The metrics are the reference's MoE loss terms summed over the MoE
    layers (zero without any).  ``remat`` checkpoints each layer in train
    mode when a gradient is being recorded.

    ``prefix_embeds`` (B, P, frontend_dim), for an arch with a multimodal
    prefix: projected by ``frontend_proj`` and put before the tokens, so
    the layers see P + S positions (and the prefill caches hold them); the
    logits are the tokens' alone, (B, S, V_pad), as the reference's."""
    if mode not in ("train", "prefill"):
        raise ValueError(f"mode={mode!r}: must be 'train' or 'prefill'")
    x = F.embedding(tokens.long(), replicated(params["embed"]))
    P_len = 0
    if prefix_embeds is not None:
        # on a mesh frontend_proj's columns come over ``model`` (rule
        # ("none", "tp")): the projected prefix is placed as the tokens'
        # embeddings are, its rows where the batch is, before the two are
        # joined along the sequence
        pe = prefix_embeds.to(x.dtype) @ params["frontend_proj"]
        pe = constrain(pe, ("pod", "data"), None, None)
        x = torch.cat([pe, constrain(x, ("pod", "data"), None, None)], dim=1)
        P_len = pe.shape[1]
    x = constrain(x, ("pod", "data"), None, None)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    aux, z = zero, zero
    remat = remat and mode == "train" and torch.is_grad_enabled()
    per_layer: dict = {}
    for si, seg in enumerate(segments(cfg)):
        seg_p = params[f"seg{si}"]
        for li in range(seg.repeat):
            body = functools.partial(
                _layer_forward, tree_map(lambda a: a[li], seg_p), seg.kinds,
                positions=positions, cfg=cfg, mode=mode,
                window_override=window_override, moe_dispatch=moe_dispatch)
            if remat:
                x, la, lz = checkpoint(lambda h, f=body: _drop_caches(f(h)),
                                       x, use_reentrant=False)
            else:
                x, caches, la, lz = body(x)
                per_layer.setdefault(f"seg{si}", []).append(caches)
            aux, z = aux + la, z + lz
    metrics = {"moe_aux_loss": aux, "moe_z_loss": z}
    x = constrain(x, ("pod", "data"), "model", None)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = x[:, P_len:] @ _unembed(params, cfg).T
    logits = constrain(logits, ("pod", "data"), None, "model")
    if mode != "prefill":
        return logits, None, metrics
    # a segment of no layers (the reduced 2-layer hybrid's pattern) stacks
    # empty caches of the shapes the reference's scan gives it
    caches = {f"seg{si}": tree_map(lambda *xs: torch.stack(xs),
                                   *per_layer[f"seg{si}"]) if seg.repeat
              else _stack_caches(cfg, seg, tokens.shape[0], S, x.dtype,
                                 window_override, x.device)
              for si, seg in enumerate(segments(cfg))}
    return logits, caches, metrics


def _drop_caches(out):
    x, _, aux, z = out
    return x, aux, z


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
def init_caches(cfg, batch, cache_len, *, dtype=None, window_override=None,
                device=None):
    """Zero caches matching :func:`decode_step` (stacked per segment)."""
    dt = dtype or dtype_of(cfg)
    return {f"seg{si}": _stack_caches(cfg, seg, batch, cache_len, dt,
                                      window_override, device)
            for si, seg in enumerate(segments(cfg))}


def _stack_caches(cfg, seg, batch, cache_len, dtype, window_override,
                  device):
    """Zero caches of one segment, each leaf (repeat, ...)."""
    one = tuple(_init_sublayer_cache(cfg, kd, batch, cache_len, dtype,
                                     window_override, device)
                for kd in seg.kinds)
    return tree_map(lambda a: a[None].repeat(seg.repeat, *([1] * a.ndim)),
                    one)


def decode_step(params, token, pos: int, cfg, caches, *,
                window_override=None):
    """token: (B, 1) int; pos: absolute position (a Python int).  Writes
    every layer's cache in place and returns logits (B, 1, V_pad).  The
    step's position tensors are made once and shared by every layer."""
    x = F.embedding(token.long(), params["embed"])
    step = DecodePosition(pos, token.shape[0], x.device)
    for mixer, ffn, sub_p, cache in _layers(params, cfg, caches):
        x = _sublayer_decode(sub_p, x, step, cfg, (mixer, ffn), cache,
                             window_override=window_override)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x @ _unembed(params, cfg).T


def _embed_tokens(params, tokens):
    """The serving steps' embedding lookup.  On a mesh the table's rows
    are sharded over ``model``: each rank looks up the tokens its rows
    hold and the masked partial sums are reduced at once (an all-reduce
    of the (B, S, D) activations, not a gather of the table), before
    anything else reads them twice."""
    return replicated(F.embedding(tokens.long(), params["embed"]))


def _unembed(params, cfg):
    return params["embed"] if cfg.tie_embeddings else params["unembed"]


def decode_step_paged(params, tokens, positions, cfg, kv_pools, block_tables,
                      *, block_size: int, slot_mask=None,
                      kernels: str = "fused"):
    """Continuous-batching decode: one token per slot at per-slot positions.

    tokens: (B, 1) int; positions: (B,) absolute write positions; kv_pools:
    :class:`~repro_torch.serve.paged_kv.StatePool` state, paged leaves
    (L, N_blocks, block, ...), written in place; block_tables: (B, W)
    int32; slot_mask: (B,) bool, True where the seat holds a RUNNING
    request: inactive seats' dummy decode must not advance slot-state
    recurrences (None advances every seat).  ``kernels``: ``"fused"`` or
    ``"composed"`` lowering (``ops.resolve_paged_path``; a mixer without a
    fused decode hook takes its composed path).  Returns logits
    (B, 1, V_pad).
    """
    x = _embed_tokens(params, tokens)
    for mixer, ffn, sub_p, kv in _layers(params, cfg, kv_pools):
        spec = MX.get_mixer(mixer)
        x = x + spec.decode_paged(
            sub_p, rms_norm(x, sub_p["norm1"], cfg.norm_eps), positions, cfg,
            kv, block_tables, block_size=block_size, window=spec.window(cfg),
            kernels=kernels, slot_mask=slot_mask)
        x = _ffn(sub_p, x, cfg, ffn)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x @ _unembed(params, cfg).T


def prefill_chunk_paged(params, tokens, starts, limits, slots, cfg, kv_pools,
                        block_tables, *, block_size: int,
                        kernels: str = "fused"):
    """One batched chunked-prefill step (HyperServe).

    tokens: (P, C) — every prompt chunk the scheduler admitted this
    iteration, row ``r``'s first token at absolute position ``starts[r]``;
    ``limits``: (P,) true prompt lengths (0 = filler row); ``slots``: (P,)
    decode seats, read and written by slot-state mixers (filler rows carry
    the null seat, ``max_slots``); block_tables: (P, W).  Writes
    every row's K/V into the pool pages in place and returns the logits of
    each row's last in-chunk prompt token, (P, V_pad) — the only position
    any caller reads, so the unembedding runs over P rows, not P*C.
    ``kernels`` as in :func:`decode_step_paged`.
    """
    P, C = tokens.shape
    x = _embed_tokens(params, tokens)
    for mixer, ffn, sub_p, kv in _layers(params, cfg, kv_pools):
        spec = MX.get_mixer(mixer)
        x = x + spec.prefill_paged(
            sub_p, rms_norm(x, sub_p["norm1"], cfg.norm_eps), starts, limits,
            slots, cfg, kv, block_tables, block_size=block_size,
            window=spec.window(cfg), kernels=kernels)
        x = _ffn(sub_p, x, cfg, ffn)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    # row r's last in-chunk prompt token sits at chunk index
    # min(limit, start + C) - 1 - start (clamped for filler rows)
    last = (torch.minimum(limits, starts + C) - 1 - starts).clamp(0, C - 1)
    # on a mesh the rows are picked from the replicated activations' local
    # copy (DTensor has no rule for this advanced index), the same on every
    # rank, which the unembedding then takes as replicated
    x = replicated(x).to_local() if is_dtensor(x) else x
    x_last = x[torch.arange(P, device=x.device), last.long()]    # (P, D)
    return x_last @ _unembed(params, cfg).T
