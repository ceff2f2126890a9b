"""Dense batched generation: the ``Generator`` (PyTorch port).

The port of ``repro.serve.engine``'s ``GenerateConfig``/``Generator``/
``_seat`` on one device.  A batch of equal-length prompts is prefilled in
one ``forward(mode="prefill")`` (one ``flash_attention`` launch per
attention layer, one ``ssd_scan`` per SSD layer), its caches are seated
into decode caches of ``max_len`` entries (an SSD layer's constant-size
state whole), and ``decode_step`` then advances every row one token per
step (one ``decode_attention`` launch per attention layer; the SSD
recurrence step is plain PyTorch, as in the reference).  This is the fixed-batch mode of
``launch/serve.py`` and the sequential baseline HyperServe is held to.

The step positions stay Python ints and the sampled tokens stay on the
device, so a step reads nothing back to the host.  Greedy decoding is
argmax over ``[:vocab_size]``; temperature sampling draws from a
``torch.Generator`` on the device seeded from ``GenerateConfig.seed``: it
replays within the port, not JAX's random bits.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.tree import tree_map
from repro_torch.models import model as M
from repro_torch.obs import Observability
from repro_torch.serve.runtime import resolve_device


@dataclasses.dataclass
class GenerateConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0            # 0 => greedy
    seed: int = 0


class Generator:
    """Host-side prefill+decode loop.

    ``device=None`` serves on the card and raises without one (pass
    ``device="cpu"`` to run the kernels' plain versions there); params are
    moved to that device.  ``window_override`` gives the decode steps a
    ring cache of that many entries; the prompt's prefill runs without it
    and its last entries are seated into the ring, as in the reference
    (ROADMAP.md section 3 records what that does when the prompt length is
    no multiple of the window).
    """

    def __init__(self, cfg, params, *, max_len: int = 512,
                 window_override: Optional[int] = None,
                 obs: Optional[Observability] = None, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = tree_map(lambda t: t.to(self.device), params)
        self.obs = obs if obs is not None else Observability()
        self.max_len = max_len
        self.window_override = window_override

    @torch.no_grad()
    def prefill(self, tokens):
        """Prompt forward: (logits (B, S, V_pad), per-layer prompt caches)."""
        B, S = tokens.shape
        self.obs.record_compile("dense_prefill", (B, S))
        with self.obs.trace.span("gen.prefill", track="engine", batch=B,
                                 seq=S):
            logits, caches, _ = M.forward(self.params, tokens, self.cfg,
                                          mode="prefill",
                                          moe_dispatch="ragged")
        return logits, caches

    def init_caches(self, batch: int, prompt_caches):
        """Decode caches of ``max_len`` (the window when overridden) with
        the prompt caches seated in them."""
        caches = M.init_caches(self.cfg, batch, self.max_len,
                               window_override=self.window_override,
                               device=self.device)
        return _seat(caches, prompt_caches)

    @torch.no_grad()
    def decode(self, token, pos: int, caches):
        """One decode step for every row at position ``pos``; writes the
        caches in place.  Returns logits (B, 1, V_pad)."""
        with self.obs.trace.span("gen.decode", track="engine", pos=pos):
            return M.decode_step(self.params, token, pos, self.cfg, caches,
                                 window_override=self.window_override)

    @torch.no_grad()
    def generate(self, tokens, gen: GenerateConfig = GenerateConfig()):
        """tokens: (B, S) prompt. Returns (B, S + max_new) tokens on the
        generator's device."""
        tokens = tokens.to(self.device)
        B, S = tokens.shape
        vocab = self.cfg.vocab_size
        logits, pcaches = self.prefill(tokens)
        caches = self.init_caches(B, pcaches)
        del pcaches
        out = [tokens.long()]
        rng = torch.Generator(device=self.device).manual_seed(gen.seed)
        cur = torch.argmax(logits[:, -1:, :vocab], dim=-1)
        out.append(cur)
        self.obs.record_compile("dense_serve", (B, self.max_len))
        for i in range(gen.max_new_tokens - 1):
            lg = self.decode(cur, S + i, caches)[:, -1, :vocab]
            if gen.temperature > 0:
                probs = torch.softmax(lg.float() / gen.temperature, dim=-1)
                cur = torch.multinomial(probs, 1, generator=rng)
            else:
                cur = torch.argmax(lg, dim=-1)[:, None]
            out.append(cur)
        return torch.cat(out, dim=1)


def _seat(dcaches, pcaches):
    """Copy prefill caches into the decode cache buffers, in place, as the
    reference's ``_seat`` does: a leaf of the prefill's shape (the SSD
    state (L, B, H, P, N) and conv tail (L, B, K-1, C)) is copied whole;
    else an (L, B, S, ...) KV leaf takes the last ``min(S_prompt,
    S_decode)`` prompt entries at its start; any other leaf is left
    as it is."""
    def seat_leaf(d, p):
        if d.shape == p.shape:
            d.copy_(p)
        elif d.ndim >= 4 and p.ndim == d.ndim:
            n = min(p.shape[2], d.shape[2])
            d[:, :, :n] = p[:, :, p.shape[2] - n:].to(d.dtype)
        return d
    return tree_map(seat_leaf, dcaches, pcaches)


def make_prefill_step(cfg, mesh=None):
    """The dense prefill of a disaggregated engine's prefill group, the
    counterpart of the reference's ``make_prefill_step`` as its
    ``_dense_prefill_fn`` uses it: ``step(params, tokens (Pb, padded)) ->
    (logits (Pb, padded, V_pad), caches)``, the caches stacked per segment
    as ``model.forward(mode="prefill")`` gives them (one ``flash_attention``
    launch an attention layer).  On ``mesh`` it runs under
    :func:`~repro_torch.core.meshctx.use_mesh` on params placed by the
    serving plan, the logits and caches DTensors.  The MoE FFN takes the
    dropless ``ragged`` dispatch, as the ``Generator``'s prefill does, so a
    row's output does not depend on its batch mates."""
    from repro_torch.core.meshctx import use_mesh

    @torch.no_grad()
    def prefill(params, tokens):
        with use_mesh(mesh):
            logits, caches, _ = M.forward(params, tokens, cfg,
                                          mode="prefill",
                                          moe_dispatch="ragged")
        return logits, caches
    return prefill


# ---------------------------------------------------------------------------
# HyperServe on a mesh: the data-axis guard, the pool's shardings and the
# logits' vocab axis (the reference's serve/engine.py helpers)
# ---------------------------------------------------------------------------
def check_data_axis_serving(mesh) -> None:
    """Refuse paged serving on a mesh with a non-trivial axis other than
    ``model``.  Serving is tensor-parallel only: the decode batch is one
    grid of seats shared by every rank and the paged pool replicates over
    the data axes, so a data axis of more than one rank holds a second copy
    of everything and serves nothing more.  Raises
    :class:`~repro_torch.api.errors.ServePlanError` naming the flat
    ``(1, n)`` view of the same ranks that serves instead
    (:func:`repro_torch.rl.session.serving_mesh_for`)."""
    from repro_torch.api.errors import ServePlanError
    bad = {a: int(n) for a, n in zip(mesh.mesh_dim_names, mesh.shape)
           if a != "model" and int(n) > 1}
    if bad:
        raise ServePlanError(
            f"paged serving is tensor-parallel only, but the mesh carries "
            f"non-trivial non-model ax{'es' if len(bad) > 1 else 'is'} "
            f"{bad} (a data axis): every rank of a data group would hold "
            "the same pool and run the same seats.  Serve on the flat "
            f"(1, {mesh.size()}) model-only view of the same ranks "
            "(repro_torch.rl.session.serving_mesh_for builds it).")


def make_pool_shardings(mesh, pool_tree, plan):
    """A :class:`~repro_torch.core.hypershard.NamedSharding` per
    ``StatePool`` leaf (None without a mesh), each derived by
    :func:`~repro_torch.core.hypershard.derive_pool` from the leaf's path
    and shape: KV heads over tp when they divide it, MLA latents
    replicated, seat state over heads or channels, conv tails over
    channels; every axis that cannot bind replicates (``derive_pool``
    records the fallback)."""
    if mesh is None:
        return None
    from repro_torch.core import hypershard as hs
    from repro_torch.core.layout import layout_for_mesh
    from repro_torch.core.tree import tree_map_with_path
    layout = layout_for_mesh(mesh)
    return tree_map_with_path(
        lambda p, l: hs.NamedSharding(mesh, hs.derive_pool(
            p, tuple(l.shape), layout, plan)[0].partition_spec()), pool_tree)


def _vocab_axis(cfg, mesh) -> Optional[str]:
    """The logits' vocab axis: ``"model"`` when it divides the padded
    vocabulary, else None (the logits replicate, as the reference falls
    back on an odd ``model`` axis, e.g. 1024 entries over 3 ranks; the
    unembedding's table then replicates by the same fallback)."""
    from repro_torch.core.meshctx import mesh_axis_size
    if mesh is None or "model" not in tuple(mesh.mesh_dim_names or ()):
        return None
    n = mesh_axis_size(mesh, "model")
    return "model" if cfg.padded_vocab % n == 0 else None


def full_logits(cfg, mesh, logits):
    """DTensor ``logits`` (..., V_pad) as a plain tensor of every vocab
    entry on every rank: placed over :func:`_vocab_axis` (the vocab dim
    sharded over ``model`` where it divides, else replicated), then
    gathered."""
    from repro_torch.core.meshctx import constrain, full_tensor
    spec = (None,) * (logits.dim() - 1) + (_vocab_axis(cfg, mesh),)
    return full_tensor(constrain(logits, *spec))
