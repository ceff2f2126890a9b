"""The ragged (sort-based) MoE dispatch, PyTorch port of
``repro.core.overlap.ragged_moe_apply``.

The reference module also holds the chunked collective/compute overlap of
the multi-device paths; those come with multi-device (ROADMAP.md).  The
dispatch here is the one serving takes for every MoE config: each token's
own top-k experts, with no capacity and no interaction between tokens, so
a row's output does not depend on its batch mates.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops


def ragged_moe_apply(p, xf, idx, gate_vals, cfg):
    """Routed-expert sum via sort -> three grouped matmuls -> unsort.

    xf: (T, D); idx: (T, k) expert ids; gate_vals: (T, k) gate weights.
    Returns (T, D) in the experts' output type.

    Differentiable: under autograd each grouped matmul runs through
    ``GroupedMatmulFn`` (its backward kernel computes dx and dW), and the
    sort, gather and unsort are plain indexing, so the train step and the
    GRPO learner take this dispatch as serving does.

    The group sizes are counted on the device (``scatter_add_`` of ones:
    no read-back, unlike ``bincount``), and the rows are sorted by expert
    with a stable sort.  Where the reference scatter-adds each weighted
    expert output into its token (``.at[tok].add``), which on the card
    would be float atomics summing in no fixed order, the port unsorts
    through the inverse permutation and sums each token's k outputs in a
    fixed order, ascending expert id: the order in which the reference's
    scatter meets them, so the float32 sums round alike.
    """
    mo = cfg.moe
    T, D = xf.shape
    E, k = mo.num_experts, mo.top_k
    idx, pick = torch.sort(idx, dim=-1)       # each token's experts ascending
    gate_vals = gate_vals.gather(-1, pick)
    flat_expert = idx.reshape(-1)             # (T*k,), token-major
    order = torch.argsort(flat_expert, stable=True)
    xs = xf[order // k]                       # (T*k, D) sorted by expert
    sizes = torch.zeros(E, dtype=torch.int32, device=xf.device).scatter_add_(
        0, flat_expert, torch.ones_like(flat_expert, dtype=torch.int32))

    h = ops.grouped_matmul(xs, p["w_gate"], sizes)
    h = F.silu(h) * ops.grouped_matmul(xs, p["w_up"], sizes)
    out = ops.grouped_matmul(h, p["w_down"], sizes)      # (T*k, D)

    unsorted = torch.empty_like(out)
    unsorted[order] = out                     # back to token-major order
    contrib = (unsorted * gate_vals.reshape(-1, 1).to(out.dtype)).view(T, k, D)
    y = contrib[:, 0]
    for j in range(1, k):
        y = y + contrib[:, j]
    return y
