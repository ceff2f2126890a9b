"""Public kernel API of the port.

Every op picks an implementation:
  - ``auto`` (default): the kernel wrapper, which launches the CUDA kernel
    for a CUDA tensor and runs the plain PyTorch version for a CPU tensor;
  - ``ref``: the plain PyTorch version on any device.  It exists so that
    ``chip_smoke.py`` can run the plain versions on the card and hold the
    kernels against them; nothing switches to it by itself.
"""
from __future__ import annotations

from repro_torch.kernels import paged_decode_attention as pda
from repro_torch.kernels import ragged_prefill_attention as rpa

_MODES = ("auto", "ref")
_MODE = "auto"


def set_mode(mode: str) -> None:
    global _MODE
    if mode not in _MODES:
        raise ValueError(f"kernel mode {mode!r}: must be one of {_MODES}")
    _MODE = mode


def resolve_paged_path(kernels: str) -> str:
    """Resolve the plan-level ``kernels`` toggle to a lowering path.

    ``"auto"`` and ``"fused"`` give the block-table-walking kernels.  The
    composed lowering (gather the tables, then dense attention) needs the
    ``decode_attention``/``flash_attention`` kernels, which the port does
    not have yet.
    """
    if kernels in ("auto", "fused"):
        return "fused"
    if kernels == "composed":
        raise NotImplementedError(
            "kernels='composed' is not ported yet: it needs the "
            "decode_attention and flash_attention kernels (ROADMAP.md, "
            "'TPU kernels to port', items 1-2, and the composed lowering "
            "under 'Modules to port'); use kernels='fused' or 'auto'")
    raise ValueError(f"kernels={kernels!r}: must be 'auto', 'fused' or "
                     "'composed'")


def paged_decode_attention(q, k_pool, v_pool, block_tables, lengths, *,
                           block_size, window=None, scale=None):
    """Fused paged decode: block table walked in-kernel, no pool gather."""
    fn = pda.paged_decode_attention_ref if _MODE == "ref" \
        else pda.paged_decode_attention
    return fn(q, k_pool, v_pool, block_tables, lengths,
              block_size=block_size, window=window, scale=scale)


def ragged_prefill_attention(q, k_pool, v_pool, block_tables, starts, limits,
                             *, block_size, window=None, scale=None):
    """Fused ragged batched prefill: (start, limit) consumed in-kernel."""
    fn = rpa.ragged_prefill_attention_ref if _MODE == "ref" \
        else rpa.ragged_prefill_attention
    return fn(q, k_pool, v_pool, block_tables, starts, limits,
              block_size=block_size, window=window, scale=scale)
