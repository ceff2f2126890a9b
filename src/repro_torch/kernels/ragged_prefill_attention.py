"""Fused ragged chunked-prefill attention: CUDA kernel, plain version,
launch count.

Replaces the TPU kernel ``repro/kernels/ragged_prefill_attention.py``,
function ``ragged_prefill_attention``.  The kernel
(``csrc/ragged_prefill_attention.cu``) consumes the scheduler's per-row
``(start, limit)`` vectors directly: filler rows (``limit == 0``) read
nothing and write exact zeros, and only keys within a query tile's causal
and window reach are read from the pool.  Its header says what bounds it
on the H100 and how the TPU's sequential page grid became a key loop
inside one thread block per (query tile, kv head, row).

:func:`ragged_prefill_attention` launches the kernel for CUDA tensors and
runs :func:`ragged_prefill_attention_ref` for CPU tensors.
``ragged_prefill_attention.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.core.meshctx import is_dtensor
from repro_torch.kernels import (DTYPE_CODES, NEG_INF, PLAIN_DEVICES,
                                 attention_problems, build, count_launch,
                                 on_local_shards, raise_problems,
                                 refuse_grad, sharded_on,
                                 side_input_problems)


def ragged_prefill_attention_ref(q, k_pool, v_pool, block_tables, starts,
                                 limits, *, block_size: int,
                                 window: Optional[int] = None,
                                 scale: Optional[float] = None
                                 ) -> torch.Tensor:
    """Plain version: gather ``pool[block_tables]``, dense causal attention
    with per-row query offset ``starts`` in f32; filler rows (limit 0) are
    zeros (the reference's ``ref.ragged_prefill_attention``).
    Returns (P, C, H, Dv) in q.dtype."""
    P, C, H, D = q.shape
    W = block_tables.shape[1]
    KV, Dv = k_pool.shape[2], v_pool.shape[3]
    G = H // KV
    S = W * block_size
    scale = scale if scale is not None else D ** -0.5
    idx = block_tables.long()
    k = k_pool[idx].reshape(P, S, KV, D).float()
    v = v_pool[idx].reshape(P, S, KV, Dv).float()
    qh = q.reshape(P, C, KV, G, D).float() * scale
    s = torch.einsum("pckgd,pskd->pkgcs", qh, k)
    qp = starts.long()[:, None, None] + torch.arange(C, device=q.device)[
        None, :, None]                                        # (P, C, 1)
    kp = torch.arange(S, device=q.device)[None, None, :]      # (1, 1, S)
    mask = kp <= qp
    if window is not None:
        mask &= qp - kp < window
    s = s.masked_fill(~mask[:, None, None], NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("pkgcs,pskd->pckgd", p, v).reshape(P, C, H, Dv)
    live = (limits > 0)[:, None, None, None]
    return torch.where(live, out, torch.zeros_like(out)).to(q.dtype)


@functools.cache
def _lib():
    lib = build.load("ragged_prefill_attention")
    fn = lib.ragged_prefill_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(q, k_pool, v_pool, block_tables=None, starts=None, limits=None,
           block_size=None):
    # the side inputs are optional: kernel_ab.py times this check beside
    # older checkouts', which take (q, k_pool, v_pool) only
    problems = attention_problems(q, k_pool, v_pool, vector_loads=True)
    if block_tables is not None:
        problems += side_input_problems(
            q, q.shape[0], pools=(k_pool, v_pool), block_size=block_size,
            tables=block_tables, starts=starts, limits=limits)
    raise_problems("ragged_prefill_attention", problems)


def ragged_prefill_attention(q, k_pool, v_pool, block_tables, starts, limits,
                             *, block_size: int, window: Optional[int] = None,
                             scale: Optional[float] = None) -> torch.Tensor:
    """Fused ragged chunked-prefill flash.  q (P, C, H, D); pools
    (N, bs, KV, D); block_tables (P, W); starts/limits (P,).
    Returns (P, C, H, D).

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    DTensor q and pools run this wrapper on each rank's shards under
    ``local_map``, as :func:`~repro_torch.kernels.paged_decode_attention.
    paged_decode_attention` does.
    """
    if is_dtensor(q) or is_dtensor(k_pool):
        hp = sharded_on(k_pool if is_dtensor(k_pool) else q, 2)
        mesh = (k_pool if is_dtensor(k_pool) else q).device_mesh
        return on_local_shards(functools.partial(
            ragged_prefill_attention, block_size=block_size, window=window,
            scale=scale), mesh, list(hp), (hp, hp, hp, None, None, None), q,
            k_pool, v_pool, block_tables, starts, limits)
    refuse_grad("ragged_prefill_attention", q, k_pool, v_pool)
    if q.device.type in PLAIN_DEVICES:
        return ragged_prefill_attention_ref(
            q, k_pool, v_pool, block_tables, starts, limits,
            block_size=block_size, window=window, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"ragged_prefill_attention: no kernel for device "
                         f"{q.device}")
    _check(q, k_pool, v_pool, block_tables, starts, limits, block_size)
    P, C, H, D = q.shape
    KV = k_pool.shape[2]
    W = block_tables.shape[1]
    q = q.contiguous()
    if q.data_ptr() % 16:        # the kernel reads q in 16-byte chunks
        q = q.clone()
    tables = block_tables.to(torch.int32).contiguous()
    st = starts.to(torch.int32).contiguous()
    lim = limits.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    scale = scale if scale is not None else D ** -0.5
    rc = _lib()(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                tables.data_ptr(), st.data_ptr(), lim.data_ptr(),
                out.data_ptr(), P, C, H, KV, D, W, block_size,
                window if window is not None else 0, scale,
                DTYPE_CODES[q.dtype],
                torch.cuda.current_stream(q.device).cuda_stream)
    count_launch(ragged_prefill_attention, rc)
    return out


ragged_prefill_attention.launches = 0
