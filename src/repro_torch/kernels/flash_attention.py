"""Dense blockwise GQA flash attention (forward): CUDA kernel, plain
version, launch count.

Replaces the TPU kernel ``repro/kernels/flash_attention.py``, function
``flash_attention``.  The kernel (``csrc/flash_attention.cu``) loops over
the keys inside one thread block per (query-row tile, kv head, row),
reading only keys within the tile's causal and window reach, on the tensor
cores in bf16; its header says what bounds it on the H100 (operations)
and how the TPU's sequential key grid became that loop.  ``q_offset`` is
an int or an int32 (B,) tensor: the tensor form gives every row its own
query position, so the composed paged prefill
(``models.attention.flash_rows``) runs P rows in one launch.  Key and
value head dims may differ (:data:`DIM_PAIRS`): MLA's decompressed keys
carry the rope dims beside the value's.

:func:`flash_attention` launches the kernel for CUDA tensors and runs
:func:`flash_attention_ref` for CPU tensors — the device of the input
decides, never a fallback.  ``flash_attention.launches`` counts kernel
launches.  There is no backward yet: the wrapper refuses inputs that
require a gradient.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Union

import torch

from repro_torch.kernels import (DTYPE_CODES, NEG_INF, SAME_DIMS,
                                 attention_problems, build, count_launch,
                                 raise_problems, refuse_grad,
                                 side_input_problems)

QOffset = Union[int, torch.Tensor]
# (Dk, Dv) pairs the kernel is built for: the GQA heads, deepseek-v2-lite's
# MLA heads (128 nope + 64 rope key dims, 128 value dims) and those of its
# reduced test config
DIM_PAIRS = SAME_DIMS + ((192, 128), (96, 64))


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None, q_offset: QOffset = 0,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Plain version: dense masked attention in f32, rounded once to
    q.dtype (the reference's ``ref.flash_attention``; the oracle also
    rounds p to the input type before the PV product, so in bf16 the two
    differ by that rounding).  q (B, Sq, H, Dk); k/v (B, Sk, KV, D*);
    ``q_offset`` int or (B,) tensor.  Returns (B, Sq, H, Dv)."""
    B, Sq, H, D = q.shape
    Sk, KV, Dv = k.shape[1], k.shape[2], v.shape[3]
    G = H // KV
    scale = scale if scale is not None else D ** -0.5
    qh = q.reshape(B, Sq, KV, G, D).float() * scale
    s = torch.einsum("bqkgd,bskd->bkgqs", qh, k.float())
    off = (q_offset.long().reshape(B, 1) if torch.is_tensor(q_offset)
           else torch.full((B, 1), int(q_offset), device=q.device))
    qp = (off + torch.arange(Sq, device=q.device))[:, :, None]   # (B, Sq, 1)
    kp = torch.arange(Sk, device=q.device)[None, None, :]         # (1, 1, Sk)
    mask = torch.ones(B, Sq, Sk, dtype=torch.bool, device=q.device)
    if causal:
        mask &= qp >= kp
    if window is not None:
        mask &= qp - kp < window
    s = s.masked_fill(~mask[:, None, None], NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(B, Sq, H, Dv).to(q.dtype)


@functools.cache
def _lib():
    lib = build.load("flash_attention")
    fn = lib.flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
                   + [ctypes.c_int] * 9
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, q_offset):
    B = q.shape[0]
    problems = attention_problems(q, k, v, vector_loads=True,
                                  pairs=DIM_PAIRS)
    problems += side_input_problems(q, B, dense=(k, v))
    if k.shape[0] != B or v.shape[:3] != k.shape[:3]:
        problems.append(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                        f"match q {tuple(q.shape)}")
    if torch.is_tensor(q_offset) and (q_offset.shape != (B,)
                                      or q_offset.device != q.device):
        problems.append(f"q_offset tensor {tuple(q_offset.shape)} on "
                        f"{q_offset.device}: need ({B},) on {q.device}")
    raise_problems("flash_attention", problems)


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None, q_offset: QOffset = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Blockwise causal GQA flash attention.  q (B, Sq, H, Dk); k (B, Sk,
    KV, Dk); v (B, Sk, KV, Dv), (Dk, Dv) one of :data:`DIM_PAIRS`;
    ``q_offset`` int or int32 (B,) tensor (row ``b``'s queries at absolute
    positions ``q_offset[b] + [0, Sq)``).  Returns (B, Sq, H, Dv).

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    refuse_grad("flash_attention", q, k, v)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    _check(q, k, v, q_offset)
    B, Sq, H, D = q.shape
    Sk, KV, Dv = k.shape[1], k.shape[2], v.shape[3]
    q = q.contiguous()
    if q.data_ptr() % 16:        # the kernel reads q in 16-byte chunks
        q = q.clone()
    offs = (q_offset.to(torch.int32).contiguous()
            if torch.is_tensor(q_offset) else None)
    out = q.new_empty(B, Sq, H, Dv)
    scale = scale if scale is not None else D ** -0.5
    rc = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                offs.data_ptr() if offs is not None else None,
                0 if offs is not None else int(q_offset), out.data_ptr(),
                B, Sq, Sk, H, KV, D, Dv, int(bool(causal)),
                window if window is not None else 0, scale,
                DTYPE_CODES[q.dtype],
                torch.cuda.current_stream(q.device).cuda_stream)
    count_launch(flash_attention, rc)
    return out


flash_attention.launches = 0
