"""HyperOffload for serving: the host archive and the hierarchical KV pool.

The port of ``repro.core.kvcache``.

:class:`HostArchive` is where a preempted request's pages and seat rows
wait (HyperServe).  ``put`` copies a tree off the card into pinned
(page-locked) CPU tensors, synchronously, so that a spill to disk never
reads a copy still in flight; ``fetch`` brings it back with asynchronous
copies (``non_blocking``) that overlap the card's work, which is what
predictive restore relies on.  Storage is a bounded
:class:`~repro_torch.mem.tiers.TierStack`: the host tier spills LRU
entries to disk at ``host_budget_bytes``, and a disk tier full of pinned
entries raises a typed :class:`~repro_torch.mem.tiers.MemCapacityError`
instead of growing host memory without bound.  An entry that comes back
from disk is pageable memory: correct, only slower to copy.  On a mesh
(HyperServe's pool as DTensors) each rank archives its own shard of every
DTensor leaf and the archive keeps the leaf's mesh, placements, global
shape and stride beside it, so that ``fetch`` rebuilds the DTensor exactly
as it was spilled: no collective on a spill or a restore, and host memory
is each rank's own.  The byte counters, the budgets and so the evictions
and each key's tier count every leaf's global bytes, as the reference's
do, so they are the same on every rank and the same as with no mesh.

:class:`KVCachePool` is the paper's hierarchical KV cache for one
attention layer: a **hot window** of the most recent ``hot_window``
tokens on the device, updated in place every decode step, and a **cold
archive** of older blocks in pinned host memory, streamed to the device a
block at a time and merged by log-sum-exp (flash-decode recombination).
The reference computes its partial attention in ``jnp`` outside any
Pallas kernel, so the port's is plain PyTorch.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from repro_torch.core.meshctx import is_dtensor
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.mem.tiers import DISK, HOST, TierStack, tree_nbytes


@dataclasses.dataclass
class KVPoolConfig:
    hot_window: int = 8192          # tokens kept on the device
    block: int = 2048               # archive streaming granularity
    dtype: str = "bfloat16"


def to_host(t: torch.Tensor) -> torch.Tensor:
    """A CPU copy of ``t`` that nothing else aliases, finished when this
    returns: pinned when ``t`` lies on the card (so the copy back can be
    asynchronous), a clone when it already lies on the CPU."""
    if t.device.type == "cpu":
        return t.clone()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


def to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device``; asynchronous from pinned memory."""
    return t.to(device, non_blocking=t.is_pinned())


class HostArchive:
    """The pooled host-memory tier as a keyed store of tensor trees.

    Evictions increment the exact ``mem.evict.{host,disk}`` counters on
    ``obs`` when given.  Budgets of 0 keep the archive unbounded.
    """

    def __init__(self, device, *, host_budget_bytes: int = 0,
                 disk_budget_bytes: int = 0, obs=None):
        self.device = torch.device(device)
        self._tiers = TierStack(host_budget_bytes, disk_budget_bytes)
        self._obs = obs
        self._seen = dict(self._tiers.counters)
        # key -> the tree's DTensor layouts ((mesh, placements, shape) a
        # DTensor leaf, None a plain one), for the keys that hold any
        self._layouts: dict = {}

    def _sync_obs(self) -> None:
        """Forward tier eviction deltas to the metrics registry."""
        if self._obs is None:
            return
        for which, metric in (("evict_host", "mem.evict.host"),
                              ("evict_disk", "mem.evict.disk")):
            d = self._tiers.counters[which] - self._seen[which]
            if d:
                self._obs.metrics.counter(metric).inc(d)
                self._seen[which] = self._tiers.counters[which]

    def put(self, key, value, *, pinned: bool = True) -> None:
        """Archive the tree ``value`` under ``key``; a DTensor leaf as this
        rank's shard, its layout kept for :meth:`fetch` and its global
        bytes counted (the reference's ``tree_nbytes`` of the global
        arrays)."""
        layouts = tree_map(lambda t: _Layout(t) if is_dtensor(t) else None,
                           value)
        if any(v is not None for v in tree_leaves(layouts)):
            self._layouts[key] = layouts
        try:
            self._tiers.put(key, tree_map(
                lambda t: to_host(t.to_local() if is_dtensor(t) else t),
                value), pinned=pinned, nbytes=tree_nbytes(value))
        finally:
            self._sync_obs()

    def fetch(self, key, *, pop: bool = True, promote: bool = False):
        """The tree under ``key`` on the archive's device (a spilled
        DTensor leaf rebuilt on its mesh with its placements); ``pop=False``
        keeps the entry.  ``promote=False``: a peek is the predictive
        restore's staging path, which keeps its own device copy, so
        re-seating a disk entry in the host tier would only churn the LRU
        (the evict counters must show real pressure, not peeks)."""
        value, _ = self._tiers.get(key, pop=pop, promote=promote)
        self._sync_obs()
        value = tree_map(lambda t: to_device(t, self.device), value)
        layouts = (self._layouts.pop(key, None) if pop
                   else self._layouts.get(key))
        if layouts is None:
            return value
        return tree_map(lambda t, lay: t if lay is None else lay.rebuild(t),
                        value, layouts)

    def __contains__(self, key) -> bool:
        return key in self._tiers

    def discard(self, key) -> None:
        self._tiers.discard(key)
        self._layouts.pop(key, None)

    def keys(self):
        return self._tiers.keys()

    def tier_of(self, key) -> Optional[str]:
        return self._tiers.tier_of(key)

    @property
    def counters(self) -> dict:
        return self._tiers.counters

    def nbytes(self) -> int:
        return self._tiers.nbytes()

    def nbytes_host(self) -> int:
        return self._tiers.nbytes(HOST)

    def nbytes_disk(self) -> int:
        return self._tiers.nbytes(DISK)


class _Layout:
    """What rebuilds an archived DTensor leaf from its local shard: its
    mesh, placements, global shape and stride (so that a leaf whose shards
    are uneven rebuilds right too)."""

    def __init__(self, t):
        self.mesh, self.placements = t.device_mesh, tuple(t.placements)
        self.shape, self.stride = tuple(t.shape), tuple(t.stride())

    def rebuild(self, local):
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(local, self.mesh, self.placements,
                                  run_check=False, shape=self.shape,
                                  stride=self.stride)


def _partial_attn(q, k, v):
    """Normalised partial attention over one block + its log-sum-exp.

    q: (B, H, D); k, v: (B, S, KV, D).  Returns (o (B, H, Dv), lse (B, H))
    in f32, ``o`` softmax-normalised WITHIN the block; blocks are merged
    by :func:`combine_partials` with weights ``exp(lse_i - LSE_total)``.
    """
    B, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    qh = q.reshape(B, KV, G, D).float() * (D ** -0.5)
    s = torch.einsum("bkgd,bskd->bkgs", qh, k.float())
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgs,bskd->bkgd", p, v.float())
    o = acc / torch.clamp(l, min=1e-30)[..., None]
    lse = m[..., 0] + torch.log(torch.clamp(l, min=1e-30))
    return o.reshape(B, H, v.shape[-1]), lse.reshape(B, H)


def combine_partials(os_, lses):
    """Flash-decode recombination of per-block normalised outputs."""
    m = functools.reduce(torch.maximum, lses)
    ws = [torch.exp(l - m) for l in lses]
    den = sum(ws)
    num = sum(o * w[..., None] for o, w in zip(os_, ws))
    return num / torch.clamp(den, min=1e-30)[..., None]


class KVCachePool:
    """Host-orchestrated hierarchical KV cache for one attention layer, on
    ``device`` (the card unless the caller names another)."""

    def __init__(self, cfg, batch: int, max_len: int, pool: KVPoolConfig,
                 device=None):
        from repro_torch.serve.runtime import resolve_device
        self.device = resolve_device(device)
        self.pool = pool
        self.batch = batch
        self.max_len = max_len
        kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
        dt = getattr(torch, pool.dtype)
        hot = min(pool.hot_window, max_len)
        self.hot_k = torch.zeros(batch, hot, kv, hd, dtype=dt,
                                 device=self.device)
        self.hot_v = torch.zeros_like(self.hot_k)
        self.archive_k: list = []        # host-resident blocks
        self.archive_v: list = []
        self.length = 0

    def append(self, k_new, v_new):
        """Append one token (B, 1, KV, hd); archives a full hot window to
        host memory first, in ``block``-sized chunks."""
        hot = self.hot_k.shape[1]
        slot = self.length % hot
        if self.length and slot == 0:
            for s in range(0, hot, self.pool.block):
                self.archive_k.append(
                    to_host(self.hot_k[:, s:s + self.pool.block]))
                self.archive_v.append(
                    to_host(self.hot_v[:, s:s + self.pool.block]))
        self.hot_k[:, slot:slot + 1] = k_new
        self.hot_v[:, slot:slot + 1] = v_new
        self.length += 1

    def attend(self, q):
        """q: (B, H, D) -> (B, H, Dv) attention over hot + archived blocks,
        each archived block copied to the device as it is reached."""
        hot = self.hot_k.shape[1]
        n_hot = ((self.length - 1) % hot) + 1 if self.length else 0
        accs, lses = [], []
        a, l = _partial_attn(q, self.hot_k[:, :n_hot], self.hot_v[:, :n_hot])
        accs.append(a)
        lses.append(l)
        for kb, vb in zip(self.archive_k, self.archive_v):
            a, l = _partial_attn(q, to_device(kb, self.device),
                                 to_device(vb, self.device))
            accs.append(a)
            lses.append(l)
        return combine_partials(accs, lses).to(q.dtype)

    def hbm_bytes(self) -> int:
        """Bytes of the hot window on the device (the reference's name)."""
        return sum(t.numel() * t.element_size()
                   for t in (self.hot_k, self.hot_v))

    def host_bytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in self.archive_k) * 2
