"""Ring attention: exact context-parallel attention over a mesh axis.

The port of ``repro.core.ring_attention``.  Used when the mesh's
``model`` axis is above 1 and head sharding does not apply (GQA with few
KV heads, e.g. qwen2-0.5b's 2 on a ``model`` axis of 4): the sequence dim
of q/k/v shards over ``model``, and each rank computes its local queries
against the full key space by rotating K/V chunks around the ring, with
running log-sum-exp statistics (exact flash semantics, absolute-position
causal masks).

Each rank's work runs under DTensor's ``local_map`` on its local shards,
the counterpart of the reference's ``shard_map``.  A chunk is computed by
:func:`flash_chunk`, the plain counterpart of the reference oracle's
``ref.flash_chunk`` (the reference runs no Pallas kernel here either),
and the K/V chunks rotate by :func:`rotate`, an ``all_to_all_single`` of
``torch.distributed.nn`` used as a permutation: it is autograd-aware, so
the backward is autograd through the ring (a raw ``isend``/``irecv`` has
no gradient).
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.core.layout import placements_on
from repro_torch.core.meshctx import dp_entry, mesh_axis_size
from repro_torch.kernels import NEG_INF


def flash_chunk(q, k, v, carry, *, causal: bool = True,
                window: Optional[int] = None, q_offset: int = 0,
                k_offset: int = 0, scale: Optional[float] = None):
    """Unnormalised attention of q (B, Sq, H, Dk) over one K/V chunk (B,
    Sk, KV, D*), whose first key sits at absolute position ``k_offset``
    (the queries' at ``q_offset``).  ``carry`` is the running ``(acc (B,
    Sq, H, Dv), m (B, Sq, H), l (B, Sq, H))`` in f32, or None; returns it
    updated.  The oracle's arithmetic: masked scores at -1e30, scores and
    P V in f32."""
    B, Sq, H, Dk = q.shape
    Sk, KV, Dv = k.shape[1], k.shape[2], v.shape[3]
    G = H // KV
    scale = scale if scale is not None else Dk ** -0.5
    qh = q.reshape(B, Sq, KV, G, Dk).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qh, k.float()) * scale
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    k_pos = k_offset + torch.arange(Sk, device=q.device)
    mask = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        mask &= q_pos[:, None] - k_pos[None, :] < window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    if carry is None:
        acc = q.new_zeros(B, KV, G, Sq, Dv, dtype=torch.float32)
        m = q.new_full((B, KV, G, Sq), NEG_INF, dtype=torch.float32)
        l = q.new_zeros(B, KV, G, Sq, dtype=torch.float32)
    else:
        acc, m, l = (_to_heads(t, KV, G) for t in carry)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(dim=-1)
    acc = acc * corr[..., None] + torch.einsum("bkgqs,bskd->bkgqd", p,
                                               v.float())
    return tuple(_from_heads(t) for t in (acc, m_new, l))


def _to_heads(t, KV, G):
    """(B, Sq, H, ...) -> (B, KV, G, Sq, ...)."""
    B, Sq = t.shape[:2]
    t = t.reshape(B, Sq, KV, G, *t.shape[3:])
    return t.permute(0, 2, 3, 1, *range(4, t.dim()))


def _from_heads(t):
    """(B, KV, G, Sq, ...) -> (B, Sq, H, ...)."""
    B, KV, G, Sq = t.shape[:4]
    t = t.permute(0, 3, 1, 2, *range(4, t.dim()))
    return t.reshape(B, Sq, KV * G, *t.shape[4:])


def flash_finalize(acc, l, dtype):
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(dtype)


def rotate(t, group, n: int, idx: int):
    """``t`` sent one step along the ring of ``group`` (n ranks, this one
    at ``idx``): returns the tensor of rank ``idx - 1``.  Differentiable:
    the gradient goes back one step."""
    from torch.distributed.nn.functional import all_to_all_single
    flat = t.reshape(1, -1)
    send = [1 if j == (idx + 1) % n else 0 for j in range(n)]
    recv = [1 if j == (idx - 1) % n else 0 for j in range(n)]
    out = all_to_all_single(torch.empty_like(flat), flat,
                            output_split_sizes=recv,
                            input_split_sizes=send, group=group)
    return out.reshape(t.shape)


def _ring_local(ql, kl, vl, *, mesh, axis, causal, window, scale):
    n = mesh_axis_size(mesh, axis)
    names = tuple(mesh.mesh_dim_names)
    idx = mesh.get_local_rank(names.index(axis))
    group = mesh.get_group(names.index(axis))
    S_local = ql.shape[1]
    carry = None
    kc, vc = kl, vl
    for r in range(n):
        src = (idx - r) % n                      # origin shard of this chunk
        carry = flash_chunk(ql, kc, vc, carry, causal=causal, window=window,
                            q_offset=idx * S_local, k_offset=src * S_local,
                            scale=scale)
        if r + 1 < n:
            kc = rotate(kc, group, n, idx)
            vc = rotate(vc, group, n, idx)
    acc, _, l = carry
    return flash_finalize(acc, l, ql.dtype)


def ring_attention(q, k, v, mesh, *, axis: str = "model",
                   causal: bool = True, window: Optional[int] = None,
                   scale: Optional[float] = None):
    """q: (B, S, H, Dk), k/v: (B, S, KV, D*) DTensors on ``mesh``,
    redistributed to S sharded over ``axis`` and B over the dp axes.
    Returns (B, S, H, Dv) with the same placements."""
    from torch.distributed.tensor.experimental import local_map
    spec = list(placements_on((dp_entry(mesh), axis, None, None), mesh))
    fn = local_map(functools.partial(_ring_local, mesh=mesh, axis=axis,
                                     causal=causal, window=window,
                                     scale=scale),
                   out_placements=spec, in_placements=(spec, spec, spec),
                   device_mesh=mesh, redistribute_inputs=True)
    return fn(q, k, v)


def ring_applicable(mesh, S: int, axis: str = "model") -> bool:
    if mesh is None or axis not in tuple(mesh.mesh_dim_names or ()):
        return False
    n = mesh_axis_size(mesh, axis)
    return n > 1 and S % n == 0 and S // n >= 1
