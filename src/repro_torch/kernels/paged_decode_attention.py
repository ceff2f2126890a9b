"""Fused paged decode attention, GQA and absorbed MLA: CUDA kernels, plain
versions, launch counts.

Replaces the TPU kernel ``repro/kernels/paged_decode_attention.py``,
function ``paged_decode_attention``.  The kernel
(``csrc/paged_decode_attention.cu``) walks each row's block table inside
the kernel, so the pool is read once per visible key and no dense
``pool[block_tables]`` copy exists; its header says what bounds it on the
H100 (bytes) and how the TPU's sequential page grid became, in bf16, key
splits planned on the host (``decode_attention.paged_decode_splits``,
from the shapes alone), each placed from its row's lower bound on the
card, all G heads of a kv head on the tensor cores, the splits' partials
merged by a second kernel in the same call.

:func:`paged_decode_attention` launches the kernel for CUDA tensors and
runs :func:`paged_decode_attention_ref` for CPU tensors — the device of
the input decides, never a fallback.  ``paged_decode_attention.launches``
counts wrapper calls that launched.

:func:`paged_mla_decode_attention` (kernel
``csrc/paged_mla_decode_attention.cu``) replaces the same file's
``paged_mla_decode_attention``: MLA's absorbed decode in the rank-R latent
space, an f32 (B, H, R) read-out.  In bf16 each row's table is cut into
key splits planned on the host (``decode_attention.mla_decode_splits``),
one thread block a (row, split) walking its keys once for every head, the
splits' partials merged by a second kernel in the same call;
``paged_mla_decode_attention.launches`` counts wrapper calls that
launched.  On DTensors (a mesh) both wrappers run on each rank's heads
under ``local_map``, one launch a rank a call.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.core.meshctx import is_dtensor
from repro_torch.kernels import (DTYPE_CODES, NEG_INF, PLAIN_DEVICES,
                                 attention_problems, build, count_launch,
                                 on_local_shards, raise_problems,
                                 refuse_grad, sharded_on,
                                 side_input_problems)
from repro_torch.kernels.decode_attention import (_sm_count, _workspace,
                                                  decode_workspace_shape,
                                                  mla_decode_splits,
                                                  mla_workspace_shape,
                                                  paged_decode_splits)


def paged_decode_attention_ref(q, k_pool, v_pool, block_tables, lengths, *,
                               block_size: int, window: Optional[int] = None,
                               scale: Optional[float] = None) -> torch.Tensor:
    """Plain version: gather ``pool[block_tables]``, dense masked attention
    in f32 (the reference's ``ref.paged_decode_attention``).
    Returns (B, 1, H, Dv) in q.dtype."""
    B, _, H, D = q.shape
    W = block_tables.shape[1]
    KV, Dv = k_pool.shape[2], v_pool.shape[3]
    G = H // KV
    S = W * block_size
    scale = scale if scale is not None else D ** -0.5
    idx = block_tables.long()
    k = k_pool[idx].reshape(B, S, KV, D).float()
    v = v_pool[idx].reshape(B, S, KV, Dv).float()
    qh = q.reshape(B, KV, G, D).float() * scale
    s = torch.einsum("bkgd,bskd->bkgs", qh, k)
    pos = torch.arange(S, device=q.device)[None, :]
    lens = lengths.long()[:, None]
    mask = pos < lens
    if window is not None:
        mask &= pos >= lens - window
    s = s.masked_fill(~mask[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v)
    return out.reshape(B, 1, H, Dv).to(q.dtype)


@functools.cache
def _lib():
    lib = build.load("paged_decode_attention")
    fn = lib.paged_decode_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                   + [ctypes.c_float] + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(q, k_pool, v_pool, block_tables=None, lengths=None,
           block_size=None):
    # the side inputs are optional: kernel_ab.py times this check beside
    # older checkouts', which take (q, k_pool, v_pool) only
    problems = attention_problems(q, k_pool, v_pool, vector_loads=True)
    if q.shape[1] != 1:
        problems.append(f"q must be (B, 1, H, D), got {tuple(q.shape)}")
    if block_tables is not None:
        problems += side_input_problems(
            q, q.shape[0], pools=(k_pool, v_pool), block_size=block_size,
            tables=block_tables, lengths=lengths)
    raise_problems("paged_decode_attention", problems)


def paged_decode_attention(q, k_pool, v_pool, block_tables, lengths, *,
                           block_size: int, window: Optional[int] = None,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Fused paged flash decode.  q (B, 1, H, D); pools (N, bs, KV, D);
    block_tables (B, W); lengths (B,) valid positions.  Returns (B, 1, H, D).

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    DTensor q and pools (HyperServe on a mesh) run this wrapper on each
    rank's shards under ``local_map``: the heads of q and of the output
    sharded where the pools' KV heads are (dim 2), else every head on
    every rank; the tables and lengths are plain tensors, the same on
    every rank.
    """
    if is_dtensor(q) or is_dtensor(k_pool):
        hp = sharded_on(k_pool if is_dtensor(k_pool) else q, 2)
        mesh = (k_pool if is_dtensor(k_pool) else q).device_mesh
        return on_local_shards(functools.partial(
            paged_decode_attention, block_size=block_size, window=window,
            scale=scale), mesh, list(hp), (hp, hp, hp, None, None), q, k_pool,
            v_pool, block_tables, lengths)
    refuse_grad("paged_decode_attention", q, k_pool, v_pool)
    if q.device.type in PLAIN_DEVICES:
        return paged_decode_attention_ref(
            q, k_pool, v_pool, block_tables, lengths, block_size=block_size,
            window=window, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: no kernel for device "
                         f"{q.device}")
    _check(q, k_pool, v_pool, block_tables, lengths, block_size)
    B, _, H, D = q.shape
    KV = k_pool.shape[2]
    W = block_tables.shape[1]
    q = q.contiguous()
    tables = block_tables.to(torch.int32).contiguous()
    lens = lengths.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    scale = scale if scale is not None else D ** -0.5
    stream = torch.cuda.current_stream(q.device).cuda_stream
    splits, keys, part = 1, W * block_size, None
    if q.dtype == torch.bfloat16:
        splits, keys = paged_decode_splits(B, KV, H // KV, D,
                                           W * block_size, window,
                                           _sm_count(q.device.index))
        shape = decode_workspace_shape(B, H, D, splits)
        if shape is not None:
            part = _workspace(q.device, stream, math.prod(shape)).data_ptr()
    rc = _lib()(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                tables.data_ptr(), lens.data_ptr(), out.data_ptr(), part,
                B, H, KV, D, W, block_size,
                window if window is not None else 0, scale, splits, keys,
                DTYPE_CODES[q.dtype], stream)
    count_launch(paged_decode_attention, rc)
    return out


paged_decode_attention.launches = 0


# ---------------------------------------------------------------------------
# absorbed-MLA paged decode
# ---------------------------------------------------------------------------
# (R, r) pairs the MLA kernel is built for: deepseek-v2-lite's latent rank
# and rope dims, and its reduced test config's
MLA_DIMS = ((512, 64), (64, 32))
_MLA_HMAX = 16


def paged_mla_decode_attention_ref(q_lat, q_rope, ckv_pool, krope_pool,
                                   block_tables, lengths, *, block_size: int,
                                   scale: float) -> torch.Tensor:
    """Plain version: gather ``pool[block_tables]``, masked softmax over
    the latent scores in f32 (the reference's
    ``ref.paged_mla_decode_attention``).  Returns (B, H, R) f32."""
    B, W = block_tables.shape
    S = W * block_size
    R, r = ckv_pool.shape[-1], krope_pool.shape[-1]
    idx = block_tables.long()
    ckv = ckv_pool[idx].reshape(B, S, R).float()
    kr = krope_pool[idx].reshape(B, S, r).float()
    s = (torch.einsum("bhr,bsr->bhs", q_lat.float(), ckv)
         + torch.einsum("bhr,bsr->bhs", q_rope.float(), kr)) * scale
    mask = (torch.arange(S, device=q_lat.device)[None, None, :]
            < lengths.long()[:, None, None])
    p = torch.softmax(s.masked_fill(~mask, NEG_INF), dim=-1)
    return torch.einsum("bhs,bsr->bhr", p, ckv)


@functools.cache
def _mla_lib():
    lib = build.load("paged_mla_decode_attention")
    fn = lib.paged_mla_decode_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                   + [ctypes.c_float] + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _mla_check(q_lat, q_rope, ckv_pool, krope_pool, block_tables, lengths,
               block_size):
    B, H, R = q_lat.shape
    r = q_rope.shape[-1]
    problems = []
    dts = {t.dtype for t in (q_lat, q_rope, ckv_pool, krope_pool)}
    if len(dts) != 1 or q_lat.dtype not in DTYPE_CODES:
        problems.append(f"dtypes {sorted(map(str, dts))}: need one of "
                        "float32/bfloat16 for all four")
    if (R, r) not in MLA_DIMS or ckv_pool.shape[-1] != R \
            or krope_pool.shape[-1] != r or q_rope.shape[:2] != (B, H):
        problems.append(f"latent dims q_lat {R}, q_rope {r}, ckv "
                        f"{ckv_pool.shape[-1]}, krope {krope_pool.shape[-1]}: "
                        f"kernel built for (R, r) in {MLA_DIMS}")
    if H > _MLA_HMAX:
        problems.append(f"H={H}: the kernel takes at most {_MLA_HMAX} heads")
    if not (ckv_pool.is_contiguous() and krope_pool.is_contiguous()) or \
            (ckv_pool.data_ptr() | krope_pool.data_ptr()) % 16:
        problems.append("the pools must be contiguous and 16-byte aligned")
    if q_rope.device != q_lat.device:
        problems.append(f"q_rope on {q_rope.device}, q_lat on "
                        f"{q_lat.device}: need one device")
    problems += side_input_problems(
        q_lat, B, pools=(ckv_pool, krope_pool), block_size=block_size,
        tables=block_tables, lengths=lengths)
    raise_problems("paged_mla_decode_attention", problems)


def paged_mla_decode_attention(q_lat, q_rope, ckv_pool, krope_pool,
                               block_tables, lengths, *, block_size: int,
                               scale: float) -> torch.Tensor:
    """Fused absorbed-MLA paged decode.  q_lat (B, H, R) (``W_uk``
    absorbed); q_rope (B, H, r); pools (N, bs, R) / (N, bs, r);
    block_tables (B, W); lengths (B,) valid positions.  Returns the latent
    read-out (B, H, R) in f32 (the caller applies ``W_uv``).

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    DTensor inputs (HyperServe on a mesh) run this wrapper on each rank's
    shards under ``local_map``: q_lat, q_rope and the output with their
    heads (dim 1) sharded where q_lat's are, the latent pools whole on
    every rank (``derive_pool`` replicates them: they have no head dim),
    the tables and lengths plain tensors, the same on every rank.
    """
    if is_dtensor(q_lat) or is_dtensor(ckv_pool):
        from torch.distributed.tensor import Replicate
        mesh = (q_lat if is_dtensor(q_lat) else ckv_pool).device_mesh
        hp = (sharded_on(q_lat, 1) if is_dtensor(q_lat)
              else (Replicate(),) * mesh.ndim)
        rep = (Replicate(),) * mesh.ndim
        return on_local_shards(functools.partial(
            paged_mla_decode_attention, block_size=block_size, scale=scale),
            mesh, list(hp), (hp, hp, rep, rep, None, None), q_lat, q_rope,
            ckv_pool, krope_pool, block_tables, lengths)
    refuse_grad("paged_mla_decode_attention", q_lat, q_rope, ckv_pool,
                krope_pool)
    if q_lat.device.type in PLAIN_DEVICES:
        return paged_mla_decode_attention_ref(
            q_lat, q_rope, ckv_pool, krope_pool, block_tables, lengths,
            block_size=block_size, scale=scale)
    if q_lat.device.type != "cuda":
        raise ValueError(f"paged_mla_decode_attention: no kernel for device "
                         f"{q_lat.device}")
    _mla_check(q_lat, q_rope, ckv_pool, krope_pool, block_tables, lengths,
               block_size)
    B, H, R = q_lat.shape
    W = block_tables.shape[1]
    q_lat, q_rope = q_lat.contiguous(), q_rope.contiguous()
    tables = block_tables.to(torch.int32).contiguous()
    lens = lengths.to(torch.int32).contiguous()
    out = torch.empty(B, H, R, dtype=torch.float32, device=q_lat.device)
    stream = torch.cuda.current_stream(q_lat.device).cuda_stream
    splits, keys, part = 1, W * block_size, None
    if q_lat.dtype == torch.bfloat16:
        splits, keys = mla_decode_splits(B, W * block_size,
                                         _sm_count(q_lat.device.index))
        shape = mla_workspace_shape(B, H, R, splits)
        if shape is not None:
            part = _workspace(q_lat.device, stream,
                              math.prod(shape)).data_ptr()
    rc = _mla_lib()(q_lat.data_ptr(), q_rope.data_ptr(), ckv_pool.data_ptr(),
                    krope_pool.data_ptr(), tables.data_ptr(), lens.data_ptr(),
                    out.data_ptr(), part, B, H, R, q_rope.shape[-1], W,
                    block_size, float(scale), splits, keys,
                    DTYPE_CODES[q_lat.dtype], stream)
    count_launch(paged_mla_decode_attention, rc)
    return out


paged_mla_decode_attention.launches = 0
