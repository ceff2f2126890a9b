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
launches.

Gradients: when q, k or v requires grad, the wrapper runs
:class:`FlashAttentionFn`, whose forward launches the same kernel with
its ``lse`` output (each query row's log-sum-exp of the scaled scores,
(B, H, Sq) f32, natural log; +inf for a row with no visible key) and
whose backward is :func:`flash_attention_bwd`, the hand-written
``csrc/flash_attention_bwd.cu`` (no ``pallas_call`` counterpart: the
reference differentiates its oracle).  It takes q_offset 0 and (Dk, Dv)
in :data:`BWD_PAIRS`; anything else raises ``ValueError`` before any
launch.  :func:`flash_bwd_body` picks its body from the dtype and head
dims before the launch: one fused wgmma pass for bf16 (dq through an f32
workspace filled by atomics, so bf16 dq may differ by one rounding between
runs; dk and dv replay bit for bit; at (192, 128) the warpgroups split the
columns instead of the keys), at (256, 256) a dK/dV pass and a dQ pass on
wgmma (no atomics: all three replay bit for bit), the FMA body for f32 (at
(256, 256) with the head dims in 64-wide chunks) and for bf16 at (96, 64).
On CPU tensors the same Function runs the plain forward and
:func:`flash_attention_bwd_ref`.  ``flash_attention_bwd.launches`` counts
backward calls (each launches its body's three kernels).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Union

import torch

from repro_torch.core.meshctx import full_tensor, is_dtensor
from repro_torch.kernels import (DTYPE_CODES, NEG_INF, PLAIN_DEVICES,
                                 SAME_DIMS, attention_problems, build,
                                 count_launch, raise_problems,
                                 side_input_problems)

QOffset = Union[int, torch.Tensor]
# (Dk, Dv) pairs the kernel is built for: the GQA heads, deepseek-v2-lite's
# MLA heads (128 nope + 64 rope key dims, 128 value dims) and those of its
# reduced test config
DIM_PAIRS = SAME_DIMS + ((192, 128), (96, 64))
# (Dk, Dv) pairs the backward is built for: qwen2's heads, the 128-wide
# heads of phi4-mini, llama3-8b and granite, deepseek-v2-lite's MLA heads
# and those of its reduced config, and recurrentgemma-2b's 256-wide heads
BWD_PAIRS = ((64, 64), (128, 128), (192, 128), (96, 64), (256, 256))
# the pairs of the tensor-core body (fb_pair in csrc/flash_attention_bwd.cu);
# 96 is no multiple of its 64-value column blocks
WGMMA_PAIRS = ((64, 64), (128, 128), (192, 128))
BWD_QT = 64                  # query rows of a tile of the tensor-core body
BWD_BODIES = {"fma": 0, "wgmma": 1, "wide": 2}   # the launcher's body codes


def flash_bwd_body(dtype, dk: int, dv: int) -> str:
    """Which body of the backward a launch runs, from the dtype and head
    dims alone and before the launch: "wgmma" (one fused pass on the
    tensor cores) for bf16 at :data:`WGMMA_PAIRS`; "wide" for bf16 at
    (256, 256) (a dK/dV pass and a dQ pass on wgmma, the warpgroups
    splitting the head dims: no fused pass fits 256 dK and dV accumulators
    a thread); else "fma" (FMAs in float32, never TF32: the f32 identity
    runs must stay f32; bf16 at (96, 64) widened to f32 on load).  Never a
    choice made after a failure: a launch that fails raises."""
    if dtype == torch.bfloat16 and (dk, dv) in WGMMA_PAIRS:
        return "wgmma"
    if dtype == torch.bfloat16 and (dk, dv) == (256, 256):
        return "wide"
    return "fma"


def flash_bwd_workspace(body: str, B: int, Sq: int, H: int, dk: int,
                        Sk: int = 0, KV: int = 1) -> int:
    """f32 values of the backward's workspace.  The tensor-core bodies
    ("wgmma", "wide") start with each (row, head, 64-row query tile)'s lse
    and row dot D (2 x 64 values, padded rows included); then "wgmma" holds
    the (B, Sq, H, Dk) f32 dQ sums, and "wide" each query head's (B, Sk,
    KV, 2 x 256) partial dK and dV (the (256, 256) bodies give every query
    head its own dK/dV block, and a second kernel sums a kv head's G
    partials in order).  "fma" holds the (B, H, Sq) row dots, and at Dk =
    256 these padded to a multiple of 4 (16 bytes) and then the same
    partials."""
    partials = H * B * Sk * 2 * dk
    if body in ("wgmma", "wide"):
        rows = B * H * -(-Sq // BWD_QT) * 2 * BWD_QT
        return rows + (B * Sq * H * dk if body == "wgmma" else partials)
    if dk != 256:
        return B * H * Sq
    return -(-B * H * Sq // 4) * 4 + partials


def _masked_scores(q, k, *, causal, window, q_offset, scale):
    """Scaled scores (B, KV, G, Sq, Sk) in f32, NEG_INF where masked, and
    the visibility mask (B, Sq, Sk)."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    qh = q.reshape(B, Sq, KV, H // KV, D).float() * scale
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
    return s.masked_fill(~mask[:, None, None], NEG_INF), mask


def flash_attention_lse_ref(q, k, v, *, causal: bool = True,
                            window: Optional[int] = None,
                            q_offset: QOffset = 0,
                            scale: Optional[float] = None):
    """Plain version with the row log-sum-exp: (out (B, Sq, H, Dv) in
    q.dtype, lse (B, H, Sq) f32, natural log of the sum of exp(scaled
    score) over the visible keys, +inf for a row with none)."""
    B, Sq, H, D = q.shape
    Sk, KV, Dv = k.shape[1], k.shape[2], v.shape[3]
    scale = scale if scale is not None else D ** -0.5
    s, mask = _masked_scores(q, k, causal=causal, window=window,
                             q_offset=q_offset, scale=scale)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    lse = torch.logsumexp(s, dim=-1).reshape(B, H, Sq)
    seen = mask.any(-1)[:, None, :].expand(B, H, Sq)
    lse = lse.masked_fill(~seen, float("inf"))
    return out.reshape(B, Sq, H, Dv).to(q.dtype), lse


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None, q_offset: QOffset = 0,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Plain version: dense masked attention in f32, rounded once to
    q.dtype (the reference's ``ref.flash_attention``; the oracle also
    rounds p to the input type before the PV product, so in bf16 the two
    differ by that rounding).  q (B, Sq, H, Dk); k/v (B, Sk, KV, D*);
    ``q_offset`` int or (B,) tensor.  Returns (B, Sq, H, Dv)."""
    return flash_attention_lse_ref(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, scale=scale)[0]


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, causal: bool = True,
                            window: Optional[int] = None,
                            scale: Optional[float] = None):
    """Plain backward, dense in f32 with the kernel's recompute-from-lse
    formulas: P = exp(S - lse) on the visible pairs, D = rowsum(dO o),
    dS = P (dO V^T - D); dQ = scale dS K, dK = scale dS^T Q, dV = P^T dO,
    the G query heads of a kv head summed.  q_offset 0.  Returns (dq, dk,
    dv) in the dtypes of q, k and v."""
    B, Sq, H, D = q.shape
    Sk, KV, Dv = k.shape[1], k.shape[2], v.shape[3]
    G = H // KV
    scale = scale if scale is not None else D ** -0.5
    s, _ = _masked_scores(q, k, causal=causal, window=window, q_offset=0,
                          scale=scale)
    p = torch.exp(s - lse.float().reshape(B, KV, G, Sq, 1))
    do_ = do.float().reshape(B, Sq, KV, G, Dv)
    dd = (do_ * o.float().reshape(B, Sq, KV, G, Dv)).sum(-1)
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, do_)
    dp = torch.einsum("bqkgd,bskd->bkgqs", do_, v.float())
    ds = p * (dp - dd.permute(0, 2, 3, 1)[..., None]) * scale
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, k.float())
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds,
                      q.float().reshape(B, Sq, KV, G, D))
    return (dq.reshape(B, Sq, H, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


@functools.cache
def _lib():
    lib = build.load("flash_attention")
    fn = lib.flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 9
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_lib():
    lib = build.load("flash_attention_bwd")
    fn = lib.flash_attention_bwd_launch
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 9
                   + [ctypes.c_float] + [ctypes.c_int] * 2
                   + [ctypes.c_void_p])
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


def _grad_problems(q, v, q_offset):
    """Why no gradient can be taken through the kernels for these inputs
    (none: an empty list)."""
    problems = []
    if torch.is_tensor(q_offset) or q_offset != 0:
        problems.append("a gradient needs q_offset = 0 (training passes "
                        "no other; the per-row offsets are serving's)")
    dims = (q.shape[-1], v.shape[-1])
    if dims not in BWD_PAIRS:
        problems.append(f"head dims (Dk, Dv) = {dims}: the backward is built "
                        f"for {BWD_PAIRS}")
    return problems


def mesh_placements(q, k=None):
    """The placements flash runs under on ``q``'s mesh: (those of q, k, v,
    the output and its gradient; those of the (B, H, Sq) lse).  The batch
    is ``Shard(0)`` over the dp axes (``pod``, ``data``) when it divides
    them, the heads ``Shard(2)`` (the lse's ``Shard(1)``) over ``model``
    when q arrives head-sharded there (the head mode) and k's KV heads
    divide it too (recurrentgemma's single KV head does not: its queries'
    heads are gathered and every rank attends them all), and every other
    mesh dim is ``Replicate`` (a dim of size 1 always): each rank's call
    sees whole sequences and whole heads, and no kernel ever takes a
    DTensor."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = q.device_mesh
    dp = [i for i, a in enumerate(mesh.mesh_dim_names) if a in ("pod", "data")]
    batch_ok = q.shape[0] % math.prod(mesh.shape[i] for i in dp) == 0
    qp, lp = [], []
    for i, (name, p) in enumerate(zip(mesh.mesh_dim_names, q.placements)):
        if mesh.shape[i] == 1:
            qp.append(Replicate())
            lp.append(Replicate())
        elif i in dp and batch_ok:
            qp.append(Shard(0))
            lp.append(Shard(0))
        elif (name == "model" and isinstance(p, Shard) and p.dim == 2
              and (k is None or k.shape[2] % mesh.shape[i] == 0)):
            qp.append(Shard(2))
            lp.append(Shard(1))
        else:
            qp.append(Replicate())
            lp.append(Replicate())
    return qp, lp


def _local_map(fn, out_placements, in_placements, q):
    """``fn`` under ``local_map`` on q's mesh, the inputs redistributed
    to ``in_placements`` first.  One output's placements are a list, those
    of several a tuple of lists."""
    from torch.distributed.tensor.experimental import local_map
    return local_map(fn, out_placements=out_placements,
                     in_placements=in_placements, device_mesh=q.device_mesh,
                     redistribute_inputs=True)


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None, q_offset: QOffset = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Blockwise causal GQA flash attention.  q (B, Sq, H, Dk); k (B, Sk,
    KV, Dk); v (B, Sk, KV, Dv), (Dk, Dv) one of :data:`DIM_PAIRS`;
    ``q_offset`` int or int32 (B,) tensor (row ``b``'s queries at absolute
    positions ``q_offset[b] + [0, Sq)``).  Returns (B, Sq, H, Dv).

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    When an input requires grad, :class:`FlashAttentionFn` runs instead
    (q_offset 0, (Dk, Dv) in :data:`BWD_PAIRS`, else ``ValueError``).
    DTensor inputs (a mesh's train forward, MLA's paged prefill on a
    mesh) run this wrapper on each rank's shards under ``local_map``
    (:func:`mesh_placements`); a ``q_offset`` tensor is a side input,
    whole on every rank.
    """
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if is_dtensor(q):
        # a q_offset tensor (MLA's paged prefill) is a side input, the same
        # on every rank: each rank's call takes it whole
        q_offset = full_tensor(q_offset) if is_dtensor(q_offset) else q_offset
        qp, _ = mesh_placements(q, k)
        return _local_map(functools.partial(
            flash_attention, causal=causal, window=window,
            q_offset=q_offset, scale=scale), qp, (qp, qp, qp), q)(q, k, v)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise_problems("flash_attention backward",
                       _grad_problems(q, v, q_offset))
        return FlashAttentionFn.apply(q, k, v, causal, window, scale)
    if q.device.type in PLAIN_DEVICES:
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, scale=scale)
    return _forward(q, k, v, causal, window, q_offset, scale, False)[0]


def _forward(q, k, v, causal, window, q_offset, scale, with_lse):
    """One kernel launch: (out, lse or None) for CUDA tensors (never a
    DTensor: those run this on their local shards under ``local_map``)."""
    if q.device.type != "cuda" or is_dtensor(q):
        raise ValueError(f"flash_attention: no kernel for a "
                         f"{type(q).__name__} on {q.device}")
    _check(q, k, v, q_offset)
    B, Sq, H, D = q.shape
    Sk, KV, Dv = k.shape[1], k.shape[2], v.shape[3]
    q = q.contiguous()
    if q.data_ptr() % 16:        # the kernel reads q in 16-byte chunks
        q = q.clone()
    offs = (q_offset.to(torch.int32).contiguous()
            if torch.is_tensor(q_offset) else None)
    out = q.new_empty(B, Sq, H, Dv)
    lse = (torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
           if with_lse else None)
    rc = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                offs.data_ptr() if offs is not None else None,
                0 if offs is not None else int(q_offset), out.data_ptr(),
                lse.data_ptr() if lse is not None else None,
                B, Sq, Sk, H, KV, D, Dv, int(bool(causal)),
                window if window is not None else 0, scale,
                DTYPE_CODES[q.dtype],
                torch.cuda.current_stream(q.device).cuda_stream)
    count_launch(flash_attention, rc)
    return out, lse


flash_attention.launches = 0


def flash_attention_lse(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None,
                        scale: Optional[float] = None):
    """The forward that :class:`FlashAttentionFn` runs: (out, lse (B, H,
    Sq) f32, natural log), q_offset 0.  CPU tensors take
    :func:`flash_attention_lse_ref`; CUDA tensors launch the kernel with
    its lse output (counted on ``flash_attention.launches``); DTensors run
    it on each rank's shards under ``local_map``."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if is_dtensor(q):
        qp, lp = mesh_placements(q, k)
        return _local_map(functools.partial(
            flash_attention_lse, causal=causal, window=window, scale=scale),
            (qp, lp), (qp, qp, qp), q)(q, k, v)
    if q.device.type in PLAIN_DEVICES:
        return flash_attention_lse_ref(q, k, v, causal=causal, window=window,
                                       scale=scale)
    return _forward(q, k, v, causal, window, 0, scale, True)


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention with a gradient: the forward kernel (or, on CPU
    tensors, the plain forward) also returns the row log-sum-exp, which is
    saved with q, k, v and the output; the backward is
    :func:`flash_attention_bwd`.  Under ``torch.utils.checkpoint`` the
    forward runs again in the backward pass, so each remat'd layer
    launches the forward kernel twice and the backward once."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        out, lse = flash_attention_lse(q, k, v, causal=causal, window=window,
                                       scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window, ctx.scale = causal, window, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do,
                                         causal=ctx.causal,
                                         window=ctx.window, scale=ctx.scale)
        return dq, dk, dv, None, None, None


def _bwd_check(q, k, v, o, lse, do):
    """Refuses, before any launch, what the backward's launcher refuses:
    the dtypes, a (Dk, Dv) pair outside :data:`BWD_PAIRS`, misshapen side
    inputs, and for the tensor-core body (its tiles come by TMA) q, k, v or
    do off a 16-byte boundary or not contiguous."""
    B, Sq, H, D = q.shape
    problems = attention_problems(q, k, v, pairs=BWD_PAIRS)
    problems += side_input_problems(q, B, dense=(k, v))
    if k.shape[0] != B or v.shape[:3] != k.shape[:3]:
        problems.append(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                        f"match q {tuple(q.shape)}")
    want = (B, Sq, H, v.shape[-1])
    for name, t in (("o", o), ("do", do)):
        if tuple(t.shape) != want or t.dtype != q.dtype \
                or t.device != q.device:
            problems.append(f"{name} {tuple(t.shape)} {t.dtype} on "
                            f"{t.device}: need {want} {q.dtype} on "
                            f"{q.device}")
    if tuple(lse.shape) != (B, H, Sq) or lse.dtype != torch.float32 \
            or lse.device != q.device:
        problems.append(f"lse {tuple(lse.shape)} {lse.dtype}: need "
                        f"({B}, {H}, {Sq}) float32 on {q.device}")
    if flash_bwd_body(q.dtype, D, v.shape[-1]) in ("wgmma", "wide"):
        for name, t in (("q", q), ("k", k), ("v", v), ("do", do)):
            if t.data_ptr() % 16 or not t.is_contiguous():
                problems.append(f"{name} at {t.data_ptr() % 16} bytes past "
                                "a 16-byte boundary or not contiguous: the "
                                "tensor-core bodies load their tiles in "
                                "16-byte pieces")
    raise_problems("flash_attention_bwd", problems)


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: Optional[int] = None,
                        scale: Optional[float] = None):
    """Gradients (dq, dk, dv) of :func:`flash_attention` at q_offset 0
    from the saved forward output ``o`` and row log-sum-exp ``lse`` (B, H,
    Sq) f32, and the output's gradient ``do``.  (Dk, Dv) in
    :data:`BWD_PAIRS`.

    CPU tensors take :func:`flash_attention_bwd_ref`; CUDA tensors launch
    the three kernels of :func:`flash_bwd_body`'s body in
    ``csrc/flash_attention_bwd.cu`` in one call, counted once on
    ``flash_attention_bwd.launches``.  DTensor inputs run it on each
    rank's shards under ``local_map`` (:func:`mesh_placements`)."""
    if is_dtensor(q):
        qp, lp = mesh_placements(q, k)
        return _local_map(functools.partial(
            flash_attention_bwd, causal=causal, window=window, scale=scale),
            (qp, qp, qp), (qp, qp, qp, qp, lp, qp), q)(q, k, v, o, lse, do)
    if q.device.type in PLAIN_DEVICES:
        return flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                       window=window, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: no kernel for device "
                         f"{q.device}")
    # contiguous, and on 16-byte boundaries (the tensor-core body's TMA)
    q, k, v, o, do = (t.contiguous() for t in (q, k, v, o, do))
    q, k, v, o, do = (t if t.data_ptr() % 16 == 0 else t.clone()
                      for t in (q, k, v, o, do))
    lse = lse.contiguous()
    _bwd_check(q, k, v, o, lse, do)
    B, Sq, H, D = q.shape
    Sk, KV, Dv = k.shape[1], k.shape[2], v.shape[3]
    scale = scale if scale is not None else D ** -0.5
    body = flash_bwd_body(q.dtype, D, Dv)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    ws = torch.empty(flash_bwd_workspace(body, B, Sq, H, D, Sk, KV),
                     dtype=torch.float32, device=q.device)
    rc = _bwd_lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    do.data_ptr(), lse.data_ptr(), ws.data_ptr(),
                    dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                    B, Sq, Sk, H, KV, D, Dv, int(bool(causal)),
                    window if window is not None else 0, scale,
                    DTYPE_CODES[q.dtype], BWD_BODIES[body],
                    torch.cuda.current_stream(q.device).cuda_stream)
    count_launch(flash_attention_bwd, rc)
    return dq, dk, dv


flash_attention_bwd.launches = 0
