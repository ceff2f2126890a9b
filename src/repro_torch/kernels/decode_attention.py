"""Dense GQA flash-decode attention: CUDA kernel, plain version, launch
count.

Replaces the TPU kernel ``repro/kernels/decode_attention.py``, function
``decode_attention``, and adds the sliding window the Pallas kernel lacks
(the reference sends a windowed call to its oracle; the port sends it to
the kernel).  The kernel (``csrc/decode_attention.cu``) shares its body
with the fused paged decode kernel and differs only in how a key's address
is found; its header says what bounds it on the H100 (bytes) and how the
TPU's sequential cache grid became a loop inside one thread block per
(kv head, row).

:func:`decode_attention` launches the kernel for CUDA tensors and runs
:func:`decode_attention_ref` for CPU tensors.  ``decode_attention.launches``
counts kernel launches.
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
                                 refuse_grad, sharded_on)


def decode_attention_ref(q, k_cache, v_cache, length, *,
                         scale: Optional[float] = None,
                         window: Optional[int] = None) -> torch.Tensor:
    """Plain version: dense masked attention in f32 (the reference's
    ``ref.decode_attention``): keys ``pos < length`` and, windowed,
    ``pos >= length - window``.  q (B, 1, H, Dk); caches (B, S, KV, D*);
    length (B,).  Returns (B, 1, H, Dv) in q.dtype."""
    B, _, H, D = q.shape
    S, KV, Dv = k_cache.shape[1], k_cache.shape[2], v_cache.shape[3]
    G = H // KV
    scale = scale if scale is not None else D ** -0.5
    qh = q.reshape(B, KV, G, D).float() * scale
    s = torch.einsum("bkgd,bskd->bkgs", qh, k_cache.float())
    pos = torch.arange(S, device=q.device)[None, :]
    lens = length.long()[:, None]
    mask = pos < lens
    if window is not None:
        mask &= pos >= lens - window
    s = s.masked_fill(~mask[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    return out.reshape(B, 1, H, Dv).to(q.dtype)


MIN_SPLIT = 16         # keys: a split is at least one warp's tile
MAX_SPLITS = 4096      # DS_MAX_SPLITS of csrc/common.cuh
HEAD_CHUNK = 16        # query heads a block takes: the mma's 16 rows


def decode_splits(S: int, blocks: int, sm_count: int):
    """(splits, keys a split) of a bf16 launch over an S-entry cache with
    ``blocks`` (row, kv head, head chunk) blocks a split: as many splits as
    give every SM one block, each at least MIN_SPLIT keys, together covering
    S; one split when the blocks alone fill the card.  One block an SM and
    not more: every further split adds a partial for the combine to read,
    and on an H100 one an SM measured faster than two at both Generator
    shapes (PERF.md section 6)."""
    want = min(MAX_SPLITS, max(1, sm_count // max(1, blocks)))
    keys = max(MIN_SPLIT, -(-S // want))
    if keys >= S:
        return 1, max(1, S)
    return -(-S // keys), keys


def decode_workspace_shape(B: int, H: int, D: int, splits: int):
    """Shape of the f32 partials of a bf16 launch: per (row, head, split)
    the unnormalised output, then the running max and the denominator; None
    when the keys are one split and the kernel writes the output itself."""
    return None if splits == 1 else (B, H, splits, D + 2)


SPLIT_TILE = 64        # keys a tile of the bf16 split body (DS_KT)


def paged_decode_splits(B: int, KV: int, G: int, D: int, keys: int,
                        window: Optional[int], sm_count: int):
    """(splits, keys a split) of a bf16 paged decode launch over B rows of
    a table of ``keys`` = W * block_size keys, KV kv heads of G query heads
    of head dim D: whole SPLIT_TILE tiles a split, together covering the
    most keys a row can see (min(keys, window) when windowed, else keys),
    as many splits as give every SM ``paged_blocks_an_sm(D)`` (row, kv
    head, head chunk, split) blocks and not more; one split when the
    blocks alone fill the card.  Each block places its split at the row's
    lower bound max(0, length - window) + z * split_len on the card, so
    the plan needs no length: it reads nothing back from the card and
    costs no wait.  At the serving decodes on 132 SMs: qwen2's 16 rows x 2
    kv heads of 7 at D = 64 over 128 x 16 keys, (16, 128) (512 blocks);
    recurrentgemma's 16 x 1 kv head of 10 at D = 256 over 194 x 16 keys,
    window 2048, (8, 256) (128 blocks); phi4-mini's 16 x 8 kv heads of 3
    at D = 128 over 128 x 16 keys, (4, 512) (512 blocks)."""
    cover = min(keys, window) if window is not None and window > 0 else keys
    blocks = B * KV * -(-G // HEAD_CHUNK)
    tiles = max(1, -(-cover // SPLIT_TILE))
    want = min(MAX_SPLITS,
               max(1, paged_blocks_an_sm(D) * sm_count // max(1, blocks)))
    per = -(-tiles // want)
    return -(-tiles // per), per * SPLIT_TILE


def paged_blocks_an_sm(D: int) -> int:
    """Blocks of the split body the plan gives an SM: four below D = 256
    (at qwen2-0.5b's serving decode, D = 64, four read faster than two and
    two faster than one on an H100; D = 128 takes the same, unmeasured),
    one at D = 256, whose two 67 KB key stages take 143 KB of shared
    memory (two an SM read slower there: a second wave)."""
    return 1 if D >= 256 else 4


MLA_TILE = 64          # keys a tile of the bf16 MLA decode kernel (ML_KT)
MLA_MIN_SPLIT = 128    # keys: a split's partial (H (R + 2) floats, 32.9 KB
                       # at deepseek-v2-lite's H = 16, R = 512) stays at most
                       # 22% of its keys' bytes (1152 a key)


def mla_decode_splits(B: int, S: int, sm_count: int):
    """(splits, keys a split) of a bf16 MLA decode launch over B rows of a
    table of S = W * block_size keys: whole MLA_TILE tiles a split, at least
    MLA_MIN_SPLIT keys, together covering S, as many splits as give every
    SM one (row, split) block and not more.  Made on the host from the
    shapes alone: no row's length is read back from the card, so the plan
    costs no wait and a CUDA graph could capture the call; a split past a
    row's length exits at once on the card."""
    tiles = max(1, -(-S // MLA_TILE))
    want = max(1, sm_count // max(1, B))
    per = max(MLA_MIN_SPLIT // MLA_TILE, -(-tiles // want))
    return -(-tiles // per), per * MLA_TILE


def mla_workspace_shape(B: int, H: int, R: int, splits: int):
    """Shape of the f32 partials of a bf16 MLA decode launch: per (row,
    head, split) the unnormalised read-out, then the running max and the
    denominator; None for one split, where the kernel writes the output."""
    return None if splits == 1 else (B, H, splits, R + 2)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_WORKSPACE = {}   # (device index, stream) -> the f32 partials' buffer


def _workspace(device, stream: int, numel: int) -> torch.Tensor:
    """A buffer of at least ``numel`` floats for the split partials, kept
    per device and stream: a call's kernels use it in stream order, so the
    next call on the same stream may reuse it, and no allocation is made
    on the host's hot path once it is large enough."""
    key = (device.index, stream)
    buf = _WORKSPACE.get(key)
    if buf is None or buf.numel() < numel:
        buf = _WORKSPACE[key] = torch.empty(numel, dtype=torch.float32,
                                            device=device)
    return buf


@functools.cache
def _lib():
    lib = build.load("decode_attention")
    fn = lib.decode_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                   + [ctypes.c_float] + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(q, k_cache, v_cache, length):
    B = q.shape[0]
    problems = attention_problems(q, k_cache, v_cache, vector_loads=True)
    if q.shape[1] != 1:
        problems.append(f"q must be (B, 1, H, D), got {tuple(q.shape)}")
    if k_cache.shape[0] != B or v_cache.shape[:3] != k_cache.shape[:3]:
        problems.append(f"caches {tuple(k_cache.shape)} / "
                        f"{tuple(v_cache.shape)} do not match q "
                        f"{tuple(q.shape)}")
    if length.shape != (B,) or length.device != q.device:
        problems.append(f"length {tuple(length.shape)} on {length.device}: "
                        f"need ({B},) on {q.device}")
    raise_problems("decode_attention", problems)


def decode_attention(q, k_cache, v_cache, length, *,
                     scale: Optional[float] = None,
                     window: Optional[int] = None) -> torch.Tensor:
    """Flash decode of one query per row against a dense cache.  q
    (B, 1, H, D); caches (B, S, KV, D); length (B,) valid entries; keys
    below ``length - window`` masked when windowed.  Returns (B, 1, H, D).

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    DTensor q and caches (HyperServe's composed decode on a mesh: the
    caches are each rank's gathered pages) run this wrapper on each rank's
    shards under ``local_map``: the heads of q and of the output sharded
    where the caches' KV heads are (dim 2), else every head on every rank
    (a replicated pool: recurrentgemma's single KV head); ``length`` is a
    side input, the same on every rank.  One launch a rank a call.
    """
    refuse_grad("decode_attention", q, k_cache, v_cache)
    if is_dtensor(q) or is_dtensor(k_cache):
        ref = k_cache if is_dtensor(k_cache) else q
        hp = sharded_on(ref, 2)
        return on_local_shards(functools.partial(
            decode_attention, scale=scale, window=window), ref.device_mesh,
            list(hp), (hp, hp, hp, None), q, k_cache, v_cache, length)
    if q.device.type in PLAIN_DEVICES:
        return decode_attention_ref(q, k_cache, v_cache, length, scale=scale,
                                    window=window)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for device {q.device}")
    _check(q, k_cache, v_cache, length)
    B, _, H, D = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    q = q.contiguous()
    lens = length.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    scale = scale if scale is not None else D ** -0.5
    stream = torch.cuda.current_stream(q.device).cuda_stream
    splits, keys, part = 1, max(1, S), None
    if q.dtype == torch.bfloat16:
        blocks = B * KV * -(-(H // KV) // HEAD_CHUNK)
        splits, keys = decode_splits(S, blocks, _sm_count(q.device.index))
        shape = decode_workspace_shape(B, H, D, splits)
        if shape is not None:
            part = _workspace(q.device, stream, math.prod(shape)).data_ptr()
    rc = _lib()(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                lens.data_ptr(), out.data_ptr(), part, B, S, H, KV, D,
                window if window is not None else 0, scale, splits, keys,
                DTYPE_CODES[q.dtype], stream)
    count_launch(decode_attention, rc)
    return out


decode_attention.launches = 0
