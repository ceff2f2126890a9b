"""Analytic bytes/FLOPs model of the attention kernels.

Two work definitions, both computed from the same ``lengths`` /
``starts, limits`` vectors the kernels consume:

- the reference's (``repro/kernels/perf_model.py``, copied): pages
  visited, each live page's K and V read once and every one of its keys
  charged against every query of the row.  It is what the kernels' page
  skips save, and it overcounts the work at page granularity;
- the visible work (:func:`decode_visible_cost`,
  :func:`prefill_visible_cost`): only the (query, key) pairs that pass
  the causal and window masks, for queries below the row's limit, and only
  the keys some such query sees.  This is the least the function needs,
  so the H100 bound is computed from it.

:func:`paged_mla_decode_cost` and :func:`grouped_matmul_cost` count the
work of the two MoE/MLA kernels the same way: the keys below each row's
length, the rows each expert takes, nothing for an empty expert
(:func:`grouped_matmul_bwd_cost` the backward's dx and dw products);
:func:`ssd_scan_cost` counts the SSD scan's causal pairs per chunk, and
:func:`rglru_scan_cost` the RG-LRU recurrence's elements,
:func:`flash_attention_bwd_cost` the flash backward's visible pairs, and
:func:`ssd_scan_bwd_cost` and :func:`rglru_scan_bwd_cost` the two scans'
backwards.

The dense kernels reuse the visible-work costs: a ``decode_attention``
call is ``decode_visible_cost(lengths, window=...)`` (``min(length,
window)`` keys per row), and a causal ``flash_attention`` call is
``prefill_visible_cost(starts=q_offset, limits=q_offset + Sq, chunk=Sq)``
(every row live, every query below its limit).

:meth:`KernelCost.bound_seconds` turns a cost into the least time an H100
SXM could take for it: the larger of bytes over the memory rate and FLOPs
over the peak rate for the operand type (NVIDIA's data sheet, dense rates,
at the full 700 W power limit).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

H100_HBM_BYTES_PER_S = 3.35e12
H100_PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


@dataclasses.dataclass(frozen=True)
class KernelCost:
    """Pure-work resource counts for one kernel invocation."""
    name: str
    flops: float              # 2 * M * N * K per matmul
    hbm_bytes: float          # each input byte read once, output written once

    def bound_seconds(self, dtype: str) -> float:
        return max(self.flops / H100_PEAK_FLOPS[dtype],
                   self.hbm_bytes / H100_HBM_BYTES_PER_S)

    def bound_by(self, dtype: str) -> str:
        t_ops = self.flops / H100_PEAK_FLOPS[dtype]
        return "operations" if t_ops > self.hbm_bytes / H100_HBM_BYTES_PER_S \
            else "bytes"


# ---------------------------------------------------------------------------
# pages-visited: the shared work definition (mirrors the kernels' skips)
# ---------------------------------------------------------------------------
def decode_pages_visited(lengths: Sequence[int], *, block_size: int,
                         window: Optional[int] = None) -> int:
    """Pages the fused decode kernel computes on, summed over rows: page
    ``w`` is live iff ``w*bs < length`` and (windowed)
    ``(w+1)*bs > length - window``."""
    total = 0
    for length in lengths:
        for w in range((int(length) + block_size - 1) // block_size):
            if window is not None and (w + 1) * block_size <= length - window:
                continue
            total += 1
    return total


def prefill_pages_visited(starts: Sequence[int], limits: Sequence[int],
                          chunk: int, *, block_size: int, table_width: int,
                          window: Optional[int] = None) -> int:
    """Pages the fused ragged-prefill kernel computes on, summed over rows:
    dead rows contribute 0; live rows visit pages up to the causal bound
    ``start + C - 1`` (and above the window bound when windowed)."""
    total = 0
    for start, limit in zip(starts, limits):
        if limit <= 0:
            continue
        for w in range(table_width):
            if w * block_size > start + chunk - 1:
                continue
            if window is not None and (w + 1) * block_size <= start - window + 1:
                continue
            total += 1
    return total


# ---------------------------------------------------------------------------
# per-kernel costs (the fused variants of the reference's model)
# ---------------------------------------------------------------------------
def paged_decode_cost(*, batch: int, num_heads: int, kv_heads: int,
                      head_dim: int, block_size: int, pages_visited: int,
                      itemsize: int) -> KernelCost:
    """One paged decode step: each live page's K and V stream from the pool
    once; FLOPs cover only live pages (scores + read-out)."""
    page_flops = 4 * num_heads * block_size * head_dim
    page_bytes = 2 * block_size * kv_heads * head_dim * itemsize
    q_bytes = batch * num_heads * head_dim * itemsize
    return KernelCost("paged_decode", float(pages_visited * page_flops),
                      float(pages_visited * page_bytes + 2 * q_bytes))


def ragged_prefill_cost(*, rows_live: int, chunk: int, num_heads: int,
                        kv_heads: int, head_dim: int, block_size: int,
                        pages_visited: int, itemsize: int) -> KernelCost:
    """One batched ragged-prefill step: live rows' causally reachable pages
    only, C queries per live row."""
    page_flops = 4 * chunk * num_heads * block_size * head_dim
    page_bytes = 2 * block_size * kv_heads * head_dim * itemsize
    q_bytes = rows_live * chunk * num_heads * head_dim * itemsize
    return KernelCost("ragged_prefill", float(pages_visited * page_flops),
                      float(pages_visited * page_bytes + 2 * q_bytes))


# ---------------------------------------------------------------------------
# visible work: what the masks let through (the bound's work definition)
# ---------------------------------------------------------------------------
def decode_visible_cost(lengths: Sequence[int], *, num_heads: int,
                        kv_heads: int, head_dim: int, itemsize: int,
                        window: Optional[int] = None) -> KernelCost:
    """One decode step counted over visible keys: row ``b`` sees
    ``min(length, window)`` keys, each read once per kv head and scored
    against every query head (4*D FLOPs per head and key); q and the
    lengths read once, the output written once.  The table entries (4
    bytes a page) are left out, which can only lower the bound."""
    keys = sum(min(int(n), window) if window is not None else int(n)
               for n in lengths)
    batch = len(lengths)
    item = num_heads * head_dim * itemsize
    kv_bytes = keys * 2 * kv_heads * head_dim * itemsize
    return KernelCost("paged_decode", float(4 * head_dim * num_heads * keys),
                      float(kv_bytes + 2 * batch * item + 4 * batch))


def prefill_visible_cost(starts: Sequence[int], limits: Sequence[int],
                         chunk: int, *, num_heads: int, kv_heads: int,
                         head_dim: int, itemsize: int,
                         window: Optional[int] = None) -> KernelCost:
    """One batched ragged-prefill step counted over visible pairs: query
    ``c`` of a live row (``start + c < limit``) sees the keys ``kp <= qp``
    (and ``qp - kp < window``), ``qp = start + c``; 4*D FLOPs per pair and
    head.  Bytes: the live queries and every key some query sees read
    once, the whole (P, C, H, D) output written once (filler rows and the
    positions past a row's limit included), starts and limits read once."""
    pairs = queries = keys = 0
    for start, limit in zip(starts, limits):
        start, limit = int(start), int(limit)
        if limit <= 0:
            continue
        n_q = max(0, min(chunk, limit - start))
        for c in range(n_q):
            qp = start + c
            pairs += min(qp + 1, window) if window is not None else qp + 1
        if n_q:
            hi = start + n_q                  # last query position + 1
            lo = max(0, start - window + 1) if window is not None else 0
            keys += hi - lo
        queries += n_q
    item = head_dim * itemsize
    return KernelCost(
        "ragged_prefill", float(4 * head_dim * num_heads * pairs),
        float(queries * num_heads * item + keys * 2 * kv_heads * item
              + len(starts) * chunk * num_heads * item + 8 * len(starts)))


def flash_attention_bwd_cost(*, batch: int, seq_q: int, seq_k: int,
                             num_heads: int, kv_heads: int, dk: int, dv: int,
                             itemsize: int, causal: bool = True,
                             window: Optional[int] = None) -> KernelCost:
    """The visible work of one flash backward call (q_offset 0): query
    ``qp`` sees the keys ``kp < seq_k`` with ``kp <= qp`` when causal and
    ``qp - kp < window`` when windowed.  Per visible pair and query head,
    five products: S = Q K^T (2 Dk flops), dP = dO V^T (2 Dv), dV += P^T dO
    (2 Dv), dK += dS^T Q (2 Dk) and dQ += dS K (2 Dk), so 2 (3 Dk + 2 Dv)
    flops; the kernels' recompute of S and dP in the dQ pass is not work
    the function needs and is not counted.  Bytes: q, k, v, o and dO read
    once, lse and the row dot D (f32) read once, dq, dk and dv written
    once."""
    pairs = 0
    for qp in range(seq_q):
        hi = min(seq_k, qp + 1) if causal else seq_k
        lo = max(0, qp - window + 1) if window is not None else 0
        pairs += max(0, hi - lo)
    q_elems = batch * seq_q * num_heads
    kv_elems = batch * seq_k * kv_heads
    return KernelCost(
        "flash_attention_bwd",
        float(2 * (3 * dk + 2 * dv) * batch * num_heads * pairs),
        float(itemsize * (2 * q_elems * dk + 2 * q_elems * dv
                          + 2 * kv_elems * (dk + dv))
              + 2 * 4 * q_elems))


# ---------------------------------------------------------------------------
# MLA decode and the MoE grouped matmul
# ---------------------------------------------------------------------------
def paged_mla_decode_cost(lengths: Sequence[int], *, num_heads: int,
                          kv_lora_rank: int, rope_dim: int,
                          itemsize: int) -> KernelCost:
    """One absorbed-MLA decode step: row ``b`` reads its ``length_b``
    latent and rope entries once for all heads ((R + r) values a key) and
    scores and reads them out for every head (2 H (2R + r) FLOPs a key);
    q_lat and q_rope read once, the f32 (B, H, R) read-out written once,
    the lengths read once.  Table entries are left out, as in
    :func:`decode_visible_cost`."""
    keys = sum(int(n) for n in lengths)
    B, H, R, r = len(lengths), num_heads, kv_lora_rank, rope_dim
    return KernelCost(
        "paged_mla_decode", float(2 * H * (2 * R + r) * keys),
        float(keys * (R + r) * itemsize + B * H * (R + r) * itemsize
              + B * H * R * 4 + 4 * B))


def grouped_matmul_cost(group_sizes: Sequence[int], *, d_in: int,
                        d_out: int, itemsize: int) -> KernelCost:
    """One grouped matmul: 2 D F FLOPs a row; bytes: every row of x read
    once, every non-empty expert's (D, F) weight read once, every output
    row written once, the sizes read once.  An empty expert costs
    nothing."""
    rows = sum(int(n) for n in group_sizes)
    live = sum(1 for n in group_sizes if int(n) > 0)
    return KernelCost(
        "grouped_matmul", float(2 * rows * d_in * d_out),
        float((rows * d_in + live * d_in * d_out + rows * d_out) * itemsize
              + 4 * len(group_sizes)))


def grouped_matmul_bwd_cost(group_sizes: Sequence[int], *, d_in: int,
                            d_out: int, itemsize: int,
                            part: str) -> KernelCost:
    """One of the two products of the grouped matmul's backward, each 2 D
    F FLOPs a row.  ``part="dx"``: dy's rows read once, every non-empty
    expert's (D, F) weight read once, dx's rows written once.
    ``part="dw"``: x's and dy's rows read once, every expert's (D, F)
    gradient written once (an empty expert's zeros too).  The sizes are
    read once by each."""
    rows = sum(int(n) for n in group_sizes)
    E = len(group_sizes)
    live = sum(1 for n in group_sizes if int(n) > 0)
    weights = (live if part == "dx" else E) * d_in * d_out
    if part == "dx":
        elems = rows * d_out + weights + rows * d_in
    elif part == "dw":
        elems = rows * d_in + rows * d_out + weights
    else:
        raise ValueError(f"part={part!r}: must be 'dx' or 'dw'")
    return KernelCost(f"grouped_matmul_bwd_{part}",
                      float(2 * rows * d_in * d_out),
                      float(elems * itemsize + 4 * E))


# ---------------------------------------------------------------------------
# Mamba-2 SSD scan
# ---------------------------------------------------------------------------
def ssd_scan_cost(*, batch: int, seq: int, heads: int, head_dim: int,
                  d_state: int, chunk: int, itemsize: int,
                  init_state: bool) -> KernelCost:
    """One chunked SSD scan over (batch, seq) positions in chunks of
    ``chunk``.  FLOPs per (row, chunk): the scores C B^T over the chunk's
    Q (Q + 1) / 2 causal pairs once for all heads (B and C are shared,
    2 N a pair); per head, the scores times x (2 P a pair), the read-out of
    the carried state (2 Q P N, skipped for a row's first chunk when it
    starts from zeros) and the state update (2 Q P N).  Decays and
    exponentials are not counted.  Bytes: x, dt (float32), A (float32),
    Bm and Cm read once, the initial state read once when given, y and the
    final state written once."""
    nc, Q = seq // chunk, chunk
    pairs = Q * (Q + 1) // 2
    P, N, H = head_dim, d_state, heads
    readouts = nc if init_state else nc - 1
    flops = batch * (nc * (2 * N * pairs + H * (2 * P * pairs + 2 * Q * P * N))
                     + readouts * H * 2 * Q * P * N)
    state = batch * H * P * N * itemsize
    hbm = (2 * batch * seq * H * P * itemsize          # x in, y out
           + batch * seq * H * 4 + H * 4               # dt, A
           + 2 * batch * seq * N * itemsize            # Bm, Cm
           + state * (2 if init_state else 1))         # init, final
    return KernelCost("ssd_scan", float(flops), float(hbm))


def ssd_scan_bwd_cost(*, batch: int, seq: int, heads: int, head_dim: int,
                      d_state: int, chunk: int, itemsize: int,
                      init_state: bool, dfin: bool) -> KernelCost:
    """One backward of the chunked SSD scan.  FLOPs per (row, chunk): the
    scores C B^T again (2 N a causal pair) and their gradient's products dG
    B and dG^T C (2 x 2 N a pair), once for all heads; per head, the
    decayed scores' two products M^T dy and dy (x dt)^T (2 x 2 P a pair),
    and the state products of 2 Q P N each: the chunk's own state, R_c,
    g_c B_k and dB's state term every chunk, the read-out's dy S_c (dC's
    state term and d cs) skipped for a row's first chunk when it starts
    from zeros.  Decays, exponentials and the elementwise d cs terms are not
    counted.  Bytes: x, dy, Bm and Cm read once and dx, dBm and dCm written
    once in the working type, dt read and ddt written (float32), A read and
    dA written, the initial state read and its gradient written when given,
    dfin read when given."""
    nc, Q = seq // chunk, chunk
    pairs = Q * (Q + 1) // 2
    P, N, H = head_dim, d_state, heads
    readouts = nc if init_state else nc - 1
    flops = batch * (nc * (3 * 2 * N * pairs
                           + H * (2 * 2 * P * pairs + 4 * 2 * Q * P * N))
                     + readouts * H * 2 * Q * P * N)
    state = batch * H * P * N * itemsize
    hbm = (3 * batch * seq * H * P * itemsize          # x, dy in; dx out
           + 2 * batch * seq * H * 4 + 2 * H * 4       # dt, ddt; A, dA
           + 4 * batch * seq * N * itemsize            # Bm, Cm; dBm, dCm
           + state * ((2 if init_state else 0) + (1 if dfin else 0)))
    return KernelCost("ssd_scan_bwd", float(flops), float(hbm))


def rglru_scan_bwd_cost(*, batch: int, seq: int, width: int, itemsize: int,
                        init_state: bool, dfin: bool) -> KernelCost:
    """One backward of the RG-LRU scan over (batch, seq, width) elements.
    FLOPs: about 28 an element (the gates and h again, 12; the adjoint's
    multiply-add, 2; d log_at, 6; dx and d input_gate, 4; d a_gate and d
    log_a, 4), each transcendental counted as one.  Bytes: x, input_gate,
    a_gate and dh read once, dx, d input_gate and d a_gate written once,
    log_a (float32) read and d log_a written once, the initial state read
    and its gradient written when given, dfin read when given."""
    n = batch * seq * width
    state = batch * width * itemsize
    hbm = (7 * n * itemsize + 2 * width * 4
           + state * ((2 if init_state else 0) + (1 if dfin else 0)))
    return KernelCost("rglru_scan_bwd", float(28 * n), float(hbm))


def rglru_scan_cost(*, batch: int, seq: int, width: int, itemsize: int,
                    init_state: bool) -> KernelCost:
    """One RG-LRU scan over (batch, seq, width) elements.  FLOPs: about 10
    an element (the gate product c log_a a_gate, exp, 2 log_at, expm1 and
    its negation, sqrt, input_gate x, beta times it, and the recurrence's
    multiply-add), each transcendental counted as one.  Bytes: x,
    input_gate and a_gate read once, h written once, log_a (float32) read
    once, the initial state read once when given and the final state
    written once."""
    n = batch * seq * width
    state = batch * width * itemsize
    hbm = (4 * n * itemsize + width * 4
           + state * (2 if init_state else 1))
    return KernelCost("rglru_scan", float(10 * n), float(hbm))
