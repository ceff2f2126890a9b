"""Public kernel API of the port.

Every op picks an implementation:
  - ``auto`` (default): the kernel wrapper, which launches the CUDA kernel
    for a CUDA tensor and runs the plain PyTorch version for a CPU tensor;
  - ``ref``: the plain PyTorch version on any device.  It exists so that
    ``chip_smoke.py`` can run the plain versions on the card and hold the
    kernels against them; nothing switches to it by itself.
"""
from __future__ import annotations

from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import grouped_matmul as gm
from repro_torch.kernels import paged_decode_attention as pda
from repro_torch.kernels import ragged_prefill_attention as rpa
from repro_torch.kernels import rglru_scan as rs
from repro_torch.kernels import ssd_scan as ss

_MODES = ("auto", "ref")
_MODE = "auto"


def set_mode(mode: str) -> None:
    global _MODE
    if mode not in _MODES:
        raise ValueError(f"kernel mode {mode!r}: must be one of {_MODES}")
    _MODE = mode


def resolve_paged_path(kernels: str) -> str:
    """Resolve the plan-level ``kernels`` toggle to a lowering path.

    ``"auto"`` and ``"fused"`` give the block-table-walking kernels;
    ``"composed"`` gathers ``pool[block_tables]`` into dense K/V and runs
    the dense ``decode_attention``/``flash_attention`` kernels on it.
    """
    if kernels in ("auto", "fused"):
        return "fused"
    if kernels == "composed":
        return "composed"
    raise ValueError(f"kernels={kernels!r}: must be 'auto', 'fused' or "
                     "'composed'")


def flash_attention(q, k, v, *, causal=True, window=None, q_offset=0,
                    scale=None):
    """Dense blockwise flash attention; ``q_offset`` int or (B,) tensor.
    Differentiable: in ``auto`` mode through the kernels' autograd
    Function (forward and backward kernels), in ``ref`` mode through
    autograd over the plain version's dense ops."""
    fn = fa.flash_attention_ref if _MODE == "ref" else fa.flash_attention
    return fn(q, k, v, causal=causal, window=window, q_offset=q_offset,
              scale=scale)


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, causal=True,
                            window=None, scale=None):
    """Plain backward of flash attention from the saved output and row
    log-sum-exp: (dq, dk, dv).  For comparisons; the train path takes the
    kernel through :func:`flash_attention`'s autograd Function."""
    return fa.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                      window=window, scale=scale)


def decode_attention(q, k_cache, v_cache, length, *, scale=None,
                     window=None):
    """Flash decode against a dense cache, with an optional window."""
    fn = da.decode_attention_ref if _MODE == "ref" else da.decode_attention
    return fn(q, k_cache, v_cache, length, scale=scale, window=window)


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


def paged_mla_decode_attention(q_lat, q_rope, ckv_pool, krope_pool,
                               block_tables, lengths, *, block_size, scale):
    """Fused MLA absorbed paged decode over the latent pools (f32 out)."""
    fn = pda.paged_mla_decode_attention_ref if _MODE == "ref" \
        else pda.paged_mla_decode_attention
    return fn(q_lat, q_rope, ckv_pool, krope_pool, block_tables, lengths,
              block_size=block_size, scale=scale)


def grouped_matmul(x, w, group_sizes):
    """Ragged grouped matmul over expert-sorted rows."""
    fn = gm.grouped_matmul_ref if _MODE == "ref" else gm.grouped_matmul
    return fn(x, w, group_sizes)


def ssd_scan(x, dt, A, Bm, Cm, *, chunk=64, init_state=None):
    """Mamba-2 SSD chunked scan; returns (y, final state)."""
    fn = ss.ssd_scan_ref if _MODE == "ref" else ss.ssd_scan
    return fn(x, dt, A, Bm, Cm, chunk=chunk, init_state=init_state)


def ssd_decode_step(x, dt, A, Bm, Cm, state):
    """One SSD recurrence step: plain PyTorch in both modes, as the
    reference runs its oracle in every mode."""
    return ss.ssd_decode_step(x, dt, A, Bm, Cm, state)


def rglru_scan(x, input_gate, a_gate, log_a, *, init_state=None, c=8.0):
    """RG-LRU gated linear recurrence; returns (h, final state)."""
    fn = rs.rglru_scan_ref if _MODE == "ref" else rs.rglru_scan
    return fn(x, input_gate, a_gate, log_a, init_state=init_state, c=c)


def rglru_decode_step(x, input_gate, a_gate, log_a, state, *, c=8.0):
    """One RG-LRU recurrence step: plain PyTorch in both modes, as the
    reference runs its oracle in every mode."""
    return rs.rglru_decode_step(x, input_gate, a_gate, log_a, state, c=c)
