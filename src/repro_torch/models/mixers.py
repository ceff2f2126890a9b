"""Mixer registry: one table from mixer kind to its init and serving hooks.

The port of ``repro.models.mixers``.  Every sequence-mixing block family
registers a :class:`MixerSpec` (dense hooks for ``forward``/``decode_step``
and serving hooks for the paged steps); the model stack and the serving runtime
dispatch through this table instead of per-call-site ``if mixer == ...``
chains.  Each spec also declares how its decode state lives under paged
serving:

  - ``PAGED``     per-layer KV pages indexed through block tables;
  - ``SLOT``      O(1) per-request dense state in a fixed decode seat;
  - ``WINDOWED``  paged, with out-of-window blocks freed.

Every mixer kind of the reference is registered: ``ATTN``, ``LOCAL_ATTN``
(the attention hooks under a sliding window), ``MLA``, and the two slot
mixers ``SSD`` and ``RGLRU``.  :func:`model_state_layout` still refuses a
config whose kind has no spec with a typed ``ServePlanError``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from repro_torch.configs.base import ATTN, LOCAL_ATTN, MLA, RGLRU, SSD
from repro_torch.core.meshctx import is_dtensor, local_placed
from repro_torch.models import attention, mamba2 as m2, mla as mla_mod, \
    rglru as rg_mod

# decode-state kinds under paged serving ------------------------------------
PAGED = "paged"
SLOT = "slot"
WINDOWED = "windowed"

STATE_KINDS = (PAGED, SLOT, WINDOWED)


@dataclasses.dataclass(frozen=True)
class MixerSpec:
    """Everything the stack and the serving runtime need for one mixer kind.

    Hooks receive the whole sublayer param dict and index their own
    ``param_key`` entry.  Dense hooks (``forward``/``decode``/
    ``init_cache``) serve ``model.forward`` and ``model.decode_step``;
    serving hooks (``init_state``/``decode_paged``/``prefill_paged``)
    define the mixer's :data:`state` layout under the paged pool.  Decode
    hooks write their cache or state in place and return the sublayer
    output.
    """
    kind: str                  # configs.base mixer constant
    state: str                 # PAGED | SLOT | WINDOWED
    param_key: str             # sublayer dict entry the params live under
    init: Callable             # (cfg, gen, *, lead) -> param subtree
    forward: Callable          # (p, h, positions, cfg, *, window,
    #                             want_cache) -> (y, cache | None)
    decode: Callable           # (p, h, pos, cfg, cache, *, window) -> y
    #                             pos: attention.DecodePosition
    init_cache: Callable       # (cfg, batch, eff_len, dtype, device)
    #                             -> one-layer cache leaves
    init_state: Callable       # (cfg, *, layers, num_blocks, block_size,
    #                             num_slots, dtype, device) -> stacked
    #                             state leaves (slot leaves carry
    #                             num_slots + 1 rows: the last is the null
    #                             seat of filler rows)
    decode_paged: Callable     # (p, h, positions, cfg, state, tables, *,
    #                             block_size, window, kernels, slot_mask)
    #                             -> y; slot_mask (B,) bool gates slot state
    prefill_paged: Callable    # (p, h, starts, limits, slots, cfg, state,
    #                             tables, *, block_size, window, kernels) -> y
    #   batched: h (P, C, D); starts/limits/slots (P,); tables (P, W) — all
    #   scheduled prompt chunks in ONE call, filler rows at limit 0
    # the serving hooks that run a block-table-walking kernel under
    # ``kernels="fused"`` (the facade's explain() reports the rest as
    # composed): ATTN and LOCAL_ATTN both, MLA its decode
    fused_hooks: Tuple[str, ...] = ()

    def window(self, cfg) -> Optional[int]:
        """Static sliding window this mixer serves under (None = unbounded)."""
        return cfg.sliding_window if self.state == WINDOWED else None


_REGISTRY: dict = {}


def register_mixer(spec: MixerSpec) -> MixerSpec:
    assert spec.state in STATE_KINDS, spec.state
    _REGISTRY[spec.kind] = spec
    return spec


def get_mixer(kind: str) -> MixerSpec:
    try:
        return _REGISTRY[kind]
    except KeyError:
        raise ValueError(
            f"unknown mixer kind {kind!r}: no MixerSpec registered "
            f"(registered: {sorted(_REGISTRY)}); its family is not ported "
            "yet (ROADMAP.md, 'Modules to port')") from None


def resolve_window(cfg, kind: str, window_override: Optional[int]):
    """Dense-path window: WINDOWED mixers pin their registry window (the
    same one the paged serving path uses, so dense/served parity holds by
    construction); other mixers accept the caller's override (the
    windowed-decode mode of long contexts)."""
    spec = get_mixer(kind)
    if spec.state == WINDOWED:
        return spec.window(cfg)
    return window_override


# ---------------------------------------------------------------------------
# stack segmentation (shared by model.py and the serving state layout)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Segment:
    kinds: Tuple[Tuple[str, str], ...]   # (mixer, ffn) per sub-layer
    repeat: int


def segments(cfg) -> Tuple[Segment, ...]:
    kinds = cfg.block_kinds()
    if cfg.family == "hybrid":
        pat = len(cfg.rglru.block_pattern)
        n_macro, tail = cfg.num_layers // pat, cfg.num_layers % pat
        segs = [Segment(tuple(kinds[:pat]), n_macro)]
        if tail:
            segs.append(Segment(tuple(kinds[n_macro * pat:]), 1))
        return tuple(segs)
    # otherwise: group maximal runs of identical (mixer, ffn)
    segs = []
    run_kind, run_len = kinds[0], 0
    for kd in kinds:
        if kd == run_kind:
            run_len += 1
        else:
            segs.append(Segment((run_kind,), run_len))
            run_kind, run_len = kd, 1
    segs.append(Segment((run_kind,), run_len))
    return tuple(segs)


# ---------------------------------------------------------------------------
# serving state layout: the whole-model resolution of the registry
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SegmentStates:
    name: str                             # "seg0", "seg1", ...
    repeat: int
    kinds: Tuple[Tuple[str, str], ...]    # (mixer, ffn) per sub-layer
    specs: Tuple[MixerSpec, ...]          # one per sub-layer


@dataclasses.dataclass(frozen=True)
class ModelStateLayout:
    """How one model's decode state lives under the paged serving pool."""
    segments: Tuple[SegmentStates, ...]
    has_slot_state: bool                  # any SLOT mixer in the stack
    has_paged_state: bool                 # any PAGED/WINDOWED mixer
    has_windowed_state: bool              # any WINDOWED mixer
    free_window: Optional[int]            # out-of-window block freeing is
    #   sound only when EVERY paged mixer is windowed; then this is the
    #   largest window any layer still needs (None otherwise)

    @property
    def pure_paged(self) -> bool:
        """Only full (unwindowed) paged state: CoW prefix forks and the
        dense-prefill disagg handoff are sound.  A WINDOWED mixer
        disqualifies even when mixed with full attention (its dense
        prefill cache is a ring of ``window`` positions, not the
        absolute-position pages the handoff seats)."""
        return not self.has_slot_state and not self.has_windowed_state


def check_disagg_supported(cfg, layout: "ModelStateLayout") -> None:
    """Disaggregated prefill hands the dense prefill cache over as pages —
    sound only for pure (unwindowed) paged layouts.  The reference's rule
    and message, enforced by the serving engine's constructor."""
    if layout.pure_paged:
        return
    from repro_torch.api.errors import ServePlanError
    offending = sorted({(sp.kind, sp.state) for seg in layout.segments
                        for sp in seg.specs if sp.state != PAGED})
    raise ServePlanError(
        "prefill/decode disaggregation needs pure paged decode state "
        "(rule: the dense prefill cache is handed over as pages); "
        f"{cfg.name} has "
        + ", ".join(f"mixer {k!r} with state rule {s!r}"
                    for k, s in offending)
        + " — serve it aggregated (chunked prefill on one mesh).")


def model_state_layout(cfg) -> ModelStateLayout:
    """Resolve ``cfg`` against the mixer registry; typed error if unservable."""
    segs = []
    windows: list = []
    has_slot = has_paged = has_windowed = False
    all_paged_windowed = True
    for si, seg in enumerate(segments(cfg)):
        specs = []
        for mixer, _ in seg.kinds:
            try:
                spec = get_mixer(mixer)
            except ValueError as e:
                from repro_torch.api.errors import ServePlanError
                raise ServePlanError(
                    f"{cfg.name} is not servable: segment {si} uses mixer "
                    f"{mixer!r}, which has no registered MixerSpec (rule: "
                    "every mixer kind must register init/decode/prefill "
                    "hooks plus a paged/slot/windowed StateSpec in "
                    "repro_torch.models.mixers).") from e
            specs.append(spec)
            if spec.state == SLOT:
                has_slot = True
            else:
                has_paged = True
                if spec.state == WINDOWED:
                    has_windowed = True
                    windows.append(spec.window(cfg))
                else:
                    all_paged_windowed = False
        segs.append(SegmentStates(f"seg{si}", seg.repeat, seg.kinds,
                                  tuple(specs)))
    free_window = (max(windows) if has_paged and all_paged_windowed and windows
                   else None)
    return ModelStateLayout(tuple(segs), has_slot, has_paged, has_windowed,
                            free_window)


# ---------------------------------------------------------------------------
# registrations
# ---------------------------------------------------------------------------
def _attn_init_state(cfg, *, layers, num_blocks, block_size, num_slots,
                     dtype, device):
    shape = (layers, num_blocks, block_size, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _attn_forward(p, h, positions, cfg, *, window, want_cache):
    if want_cache:
        return attention.attn_prefill(p["attn"], h, positions, cfg,
                                      window=window)
    return attention.attn_forward(p["attn"], h, positions, cfg,
                                  window=window), None


# full attention pages every key; sliding-window attention (LOCAL_ATTN)
# runs the same hooks under cfg.sliding_window and frees out-of-window blocks
for _kind, _state in ((ATTN, PAGED), (LOCAL_ATTN, WINDOWED)):
    register_mixer(MixerSpec(
        kind=_kind, state=_state, param_key="attn",
        init=attention.init_attention,
        forward=_attn_forward,
        decode=lambda p, h, pos, cfg, cache, *, window: attention.attn_decode(
            p["attn"], h, pos, cfg, cache, window=window),
        init_cache=attention.init_kv_cache,
        init_state=_attn_init_state,
        decode_paged=lambda p, h, positions, cfg, state, tables, *,
            block_size, window, kernels, slot_mask=None:
            attention.attn_decode_paged(
                p["attn"], h, positions, cfg, state, tables,
                block_size=block_size, window=window, kernels=kernels),
        prefill_paged=lambda p, h, starts, limits, slots, cfg, state, tables,
            *, block_size, window, kernels: attention.attn_prefill_paged(
                p["attn"], h, starts, limits, cfg, state, tables,
                block_size=block_size, window=window, kernels=kernels),
        fused_hooks=("decode", "prefill"),
    ))


def _mla_forward(p, h, positions, cfg, *, window, want_cache):
    if want_cache:
        return mla_mod.mla_forward(p["attn"], h, positions, cfg,
                                   window=window, return_cache=True)
    return mla_mod.mla_forward(p["attn"], h, positions, cfg,
                               window=window), None


register_mixer(MixerSpec(
    kind=MLA, state=PAGED, param_key="attn",
    init=mla_mod.init_mla,
    forward=_mla_forward,
    decode=lambda p, h, pos, cfg, cache, *, window: mla_mod.mla_decode(
        p["attn"], h, pos, cfg, cache, window=window),
    init_cache=mla_mod.init_mla_cache,
    init_state=lambda cfg, *, layers, num_blocks, block_size, num_slots,
        dtype, device: mla_mod.init_mla_pool(
            cfg, layers=layers, num_blocks=num_blocks, block_size=block_size,
            dtype=dtype, device=device),
    decode_paged=lambda p, h, positions, cfg, state, tables, *, block_size,
        window, kernels, slot_mask=None: mla_mod.mla_decode_paged(
            p["attn"], h, positions, cfg, state, tables,
            block_size=block_size, kernels=kernels),
    prefill_paged=lambda p, h, starts, limits, slots, cfg, state, tables, *,
        block_size, window, kernels: mla_mod.mla_prefill_chunk_paged(
            p["attn"], h, starts, limits, cfg, state, tables,
            block_size=block_size, kernels=kernels),
    fused_hooks=("decode",),
))


def _gate_slot_update(state, new, slot_mask) -> None:
    """Write a slot mixer's new decode state in place, keeping inactive
    seats' state untouched.

    The batched decode step advances EVERY seat (empty or prefilling seats
    run a dummy token).  Paged mixers are safe by construction (dummy
    writes land in the null block), but a slot mixer's recurrence would
    absorb the dummy, so the write is gated per seat: ``slot_mask`` (B,)
    bool, True where the seat holds a RUNNING request (None: write all).
    """
    for k, v in new.items():
        old = state[k]
        if is_dtensor(old):         # a mesh: this rank's shard of the seats
            v = local_placed(v, old.device_mesh, old.placements)
            old = old.to_local()
        v = v.to(old.dtype)
        if slot_mask is not None:
            m = slot_mask.reshape((-1,) + (1,) * (v.ndim - 1))
            v = torch.where(m, v, old)
        old.copy_(v)


def register_slot_mixer(kind, *, init, forward, decode, init_cache,
                        prefill_chunk) -> MixerSpec:
    """Register a mixer whose decode state is one dense row per seat
    (``SLOT``): its params live under ``"mixer"``; ``forward(p, h, cfg, *,
    return_cache)``, ``decode(p, h, cfg, cache) -> (y, new cache)`` (which
    writes nothing), ``init_cache(cfg, batch, dtype, device)`` and
    ``prefill_chunk(p, h, starts, limits, slots, cfg, state)`` take the
    sublayer's own params.  The serving state is the cache of
    ``num_slots + 1`` rows (the seats, then the null seat of filler
    prefill rows) stacked over the layers.  The dense decode writes its
    whole cache; the serving decode writes only running seats
    (:func:`_gate_slot_update`)."""
    def fwd(p, h, positions, cfg, *, window, want_cache):
        if want_cache:
            return forward(p["mixer"], h, cfg, return_cache=True)
        return forward(p["mixer"], h, cfg), None

    def dec(p, h, pos, cfg, cache, *, window):
        y, new = decode(p["mixer"], h, cfg, cache)
        _gate_slot_update(cache, new, None)
        return y

    def dec_paged(p, h, positions, cfg, state, tables, *, block_size,
                  window, kernels, slot_mask=None):
        B = h.shape[0]                  # the seats; the null seat is last
        seats = {k: v[:B] for k, v in state.items()}
        y, new = decode(p["mixer"], h, cfg, seats)
        _gate_slot_update(seats, new, slot_mask)
        return y

    return register_mixer(MixerSpec(
        kind=kind, state=SLOT, param_key="mixer", init=init, forward=fwd,
        decode=dec,
        init_cache=lambda cfg, batch, eff_len, dtype, device:
            init_cache(cfg, batch, dtype, device),
        init_state=lambda cfg, *, layers, num_blocks, block_size, num_slots,
            dtype, device: {k: v[None].repeat(layers, *([1] * v.ndim))
                            for k, v in init_cache(cfg, num_slots + 1, dtype,
                                                   device).items()},
        decode_paged=dec_paged,
        prefill_paged=lambda p, h, starts, limits, slots, cfg, state, tables,
            *, block_size, window, kernels: prefill_chunk(
                p["mixer"], h, starts, limits, slots, cfg, state),
    ))


register_slot_mixer(SSD, init=m2.init_mamba2, forward=m2.mamba2_forward,
                    decode=m2.mamba2_decode,
                    init_cache=m2.init_mamba2_cache,
                    prefill_chunk=m2.mamba2_prefill_chunk)
register_slot_mixer(RGLRU, init=rg_mod.init_rglru,
                    forward=rg_mod.rglru_forward,
                    decode=rg_mod.rglru_decode,
                    init_cache=rg_mod.init_rglru_cache,
                    prefill_chunk=rg_mod.rglru_prefill_chunk)
