"""Paged decode state: fixed-size pool blocks + block tables (HyperServe).

The port of ``repro.serve.paged_kv``.  Two pieces:

  - :class:`BlockManager` — pure host-side bookkeeping: a free list,
    per-block reference counts (copy-on-write prefix sharing), admission
    queries, and spill/restore of a request's pages into the shared
    :class:`~repro_torch.core.kvcache.HostArchive`.
  - :class:`StatePool` — the device tensors themselves, one leaf dict per
    (segment, sublayer) with the layout the mixer registry declares:
    paged leaves ``(L, N_blocks, block, ...)`` indexed through block
    tables, slot leaves ``(L, num_slots + 1, ...)`` one row per decode
    seat plus the null seat.  Host-driven page and seat extract/insert
    serve spill/restore.  On a mesh every leaf is a DTensor placed as
    ``serve.engine.make_pool_shardings`` derives it, and every page and
    seat operation acts on each rank's local rows (the block and seat
    dims are never sharded, so a row index means the same on every rank).

Block id 0 is the **null block**: never allocated, the write target for
inactive batch slots, the padding entry of every block table.  Reads
through it are always masked, so its contents are don't-care.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.kvcache import HostArchive
from repro_torch.core.meshctx import is_dtensor, local_index, local_index_put
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.models import mixers as MX


class NoFreeBlocks(RuntimeError):
    """Raised when an allocation cannot be satisfied from the free list."""


def blocks_for(num_tokens: int, block_size: int) -> int:
    return -(-num_tokens // block_size)          # ceil div


@dataclasses.dataclass(frozen=True)
class PagedKVConfig:
    block_size: int = 16          # tokens per pool block
    num_blocks: int = 128         # pool size, including the null block
    max_blocks_per_req: int = 16  # block-table width
    dtype: str = "bfloat16"

    @property
    def max_context(self) -> int:
        return self.block_size * self.max_blocks_per_req


class BlockManager:
    """Free-list allocator with refcounts, CoW forking and host spill."""

    NULL = 0

    def __init__(self, cfg: PagedKVConfig, archive: HostArchive):
        self.cfg = cfg
        self.archive = archive
        self._free: List[int] = list(range(cfg.num_blocks - 1, 0, -1))
        self._ref = np.zeros((cfg.num_blocks,), np.int32)
        self._ref[self.NULL] = 1                 # never allocatable
        # CoW accounting: blocks shared by fork vs pages physically
        # duplicated on a write fault
        self.forked_blocks = 0
        self.cow_faults = 0

    # -- queries -----------------------------------------------------------
    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_total(self) -> int:
        return self.cfg.num_blocks - 1           # null block excluded

    def occupancy(self) -> float:
        return 1.0 - self.num_free / max(self.num_total, 1)

    def can_alloc(self, n: int) -> bool:
        return n <= self.num_free

    def refcount(self, bid: int) -> int:
        return int(self._ref[bid])

    # -- alloc / free ------------------------------------------------------
    def alloc(self, n: int) -> List[int]:
        if n > self.num_free:
            raise NoFreeBlocks(f"need {n} blocks, have {self.num_free}")
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            assert self._ref[b] == 0, (b, self._ref[b])
            self._ref[b] = 1
        return out

    def free(self, blocks: Sequence[int]) -> None:
        for b in blocks:
            if b == self.NULL:
                continue
            assert self._ref[b] > 0, f"double free of block {b}"
            self._ref[b] -= 1
            if self._ref[b] == 0:
                self._free.append(b)

    # -- copy-on-write -----------------------------------------------------
    def fork(self, table: Sequence[int]) -> List[int]:
        """Share ``table``'s blocks with a new owner (prefix sharing)."""
        for b in table:
            if b != self.NULL:
                self._ref[b] += 1
                self.forked_blocks += 1
        return list(table)

    def is_shared(self, bid: int) -> bool:
        return bid != self.NULL and self._ref[bid] > 1

    def ensure_writable(self, table: List[int], idx: int,
                        copy_page) -> Tuple[List[int], int]:
        """Make ``table[idx]`` exclusively owned before a write: a shared
        block is copied into a fresh one (``copy_page(src, dst)``) and the
        entry repointed (the classic CoW fault)."""
        bid = table[idx]
        if not self.is_shared(bid):
            return table, bid
        [new] = self.alloc(1)
        copy_page(bid, new)
        self._ref[bid] -= 1                      # old ref released, >=1 remain
        self.cow_faults += 1
        table = list(table)
        table[idx] = new
        return table, new

    # -- spill / restore (cold tier) ---------------------------------------
    def spill(self, key, table: Sequence[int], extract_pages) -> None:
        """Move a request's page contents to the host archive, free blocks.

        ``extract_pages(bids) -> tree`` pulls the page contents out of the
        device pool *before* the blocks return to the free list (they may be
        reallocated in the same scheduler step).
        """
        real = [b for b in table if b != self.NULL]
        self.archive.put(key, extract_pages(real))
        self.free(real)

    def restore(self, key, insert_pages) -> List[int]:
        """Re-seat spilled pages into freshly allocated blocks; raises
        :class:`NoFreeBlocks` (archive entry intact) when they don't fit."""
        pages = self.archive.fetch(key, pop=False)
        leaves = tree_leaves(pages)
        n = leaves[0].shape[1] if leaves else 0
        bids = self.alloc(n)                     # may raise NoFreeBlocks
        self.archive.discard(key)
        insert_pages(pages, bids)
        return bids

    def spilled(self, key) -> bool:
        return key in self.archive

    def stats(self) -> dict:
        """Pool occupancy + CoW accounting snapshot."""
        return {
            "num_total": self.num_total,
            "num_free": self.num_free,
            "occupancy": self.occupancy(),
            "shared_blocks": int((self._ref[1:] > 1).sum()),
            "forked_blocks": self.forked_blocks,
            "cow_faults": self.cow_faults,
            "archive_entries": len(self.archive.keys()),
            # per-tier split (HyperMem): host memory vs the disk tier the
            # bounded archive spills into; "archive_bytes" stays the total
            "archive_bytes": self.archive.nbytes(),
            "archive_host_bytes": self.archive.nbytes_host(),
            "archive_disk_bytes": self.archive.nbytes_disk(),
        }


class StatePool:
    """The pooled decode-state tensors for every layer of one model.

    Per segment a tuple of per-sublayer leaf dicts, with the layout the
    mixer registry declares for the sublayer:

      - **paged** sublayers (ATTN, MLA): leaves ``(L, N_blocks, block,
        ...)`` — the per-request sequence dim is replaced by the shared
        (block, offset) pool that block tables index;
      - **slot** sublayers (SSD): leaves ``(L, num_slots + 1, ...)`` — O(1)
        dense recurrent state, one row per decode seat, and last the null
        seat that filler prefill rows write (never read by a request).

    The leading stacked-layer axis is what the model's layer loop slices.
    Construction resolves the config against the mixer registry
    (:func:`repro_torch.models.mixers.model_state_layout`) — an
    unregistered mixer kind raises a typed ``ServePlanError`` here.

    With ``mesh`` (and the serving ``plan``) every leaf is a DTensor of
    zeros placed by :func:`~repro_torch.serve.engine.make_pool_shardings`,
    each rank allocating only its own shard.
    """

    def __init__(self, cfg, pcfg: PagedKVConfig, *, num_slots: int = 1,
                 device, mesh=None, plan=None):
        self.cfg = cfg
        self.pcfg = pcfg
        self.num_slots = num_slots
        self.layout = MX.model_state_layout(cfg)
        self.mesh = mesh
        dt = getattr(torch, pcfg.dtype)

        def init(dev):
            return {seg.name: tuple(spec.init_state(
                cfg, layers=seg.repeat, num_blocks=pcfg.num_blocks,
                block_size=pcfg.block_size, num_slots=num_slots, dtype=dt,
                device=dev)
                for spec in seg.specs)
                for seg in self.layout.segments}
        if mesh is None:
            self.state: dict = init(device)
            return
        from repro_torch.serve.engine import make_pool_shardings
        shapes = init("meta")
        self.state = tree_map(
            lambda t, s: _zeros_on(t, s.mesh, s.placements, device), shapes,
            make_pool_shardings(mesh, shapes, plan))

    def hbm_bytes(self) -> int:
        """Bytes of the pool on this rank (its local shards on a mesh)."""
        return sum(a.numel() * a.element_size()
                   for a in map(_local, tree_leaves(self.state)))

    # -- structural helpers ------------------------------------------------
    # Every pool operation below targets one side of the paged/slot split;
    # these two visitors are the one place the segment/sublayer walk (and
    # the split itself) is written.
    def _collect(self, want_slot: bool, fn):
        """Structure-preserving gather: ``fn(leaf)`` on every leaf of the
        matching sublayers, ``{}`` placeholders elsewhere (so an insert can
        realign)."""
        return {seg.name: tuple(
            tree_map(fn, self.state[seg.name][j])
            if (spec.state == MX.SLOT) == want_slot else {}
            for j, spec in enumerate(seg.specs))
            for seg in self.layout.segments}

    def _rewrite(self, want_slot: bool, fn, values=None) -> None:
        """``fn(leaf[, value])`` in place on every leaf of the matching
        sublayers (``values`` aligned as :meth:`_collect` returns them)."""
        for seg in self.layout.segments:
            for j, spec in enumerate(seg.specs):
                if (spec.state == MX.SLOT) != want_slot:
                    continue
                sub = self.state[seg.name][j]
                if values is None:
                    tree_map(fn, sub)
                else:
                    tree_map(fn, sub, values[seg.name][j])

    # -- host-driven page movement (spill / restore / CoW copy) ------------
    def _idx(self, bids: Sequence[int]) -> torch.Tensor:
        device = _local(tree_leaves(self.state)[0]).device
        return torch.tensor(list(bids), dtype=torch.long, device=device)

    def extract_pages(self, bids: Sequence[int]):
        """Copy blocks ``bids`` out of every paged leaf: (L, n, bs, ...);
        slot sublayers contribute an empty dict.  On a mesh each leaf is a
        DTensor of this rank's rows, with its pool leaf's placements."""
        idx = self._idx(bids)
        return self._collect(False, lambda a: _rows(a, (slice(None), idx)))

    def insert_pages(self, pages, bids: Sequence[int]) -> None:
        idx = self._idx(bids)
        self._rewrite(False, lambda a, p: _put_rows(a, (slice(None), idx), p),
                      pages)

    def copy_page(self, src: int, dst: int) -> None:
        def cp(a):
            a = _local(a)
            a[:, dst] = a[:, src]
        self._rewrite(False, cp)

    # -- per-seat dense state (seating / eviction) -------------------------
    def extract_slot(self, slot: int):
        """Copy one decode seat's dense state rows out: leaf (L, 1, ...);
        paged sublayers contribute an empty dict."""
        return self._collect(True, lambda a: _rows(
            a, (slice(None), slice(slot, slot + 1))))

    def insert_slot(self, slot: int, values) -> None:
        self._rewrite(True, lambda a, v: _put_rows(
            a, (slice(None), slice(slot, slot + 1)), v), values)

    def zero_slot(self, slot: int) -> None:
        """Reset one seat's dense state (a newly admitted request must not
        inherit the previous occupant's recurrence)."""
        self._rewrite(True, lambda a: _local(a)[:, slot].zero_())

    def seat_prefill_caches(self, pcaches, bids: Sequence[int],
                            seq_len: int, row: int = 0) -> None:
        """Scatter a dense prefill cache (one request) into pages.

        ``pcaches`` is the ``model.forward(..., mode="prefill")`` cache
        tree with leaves (L, B, S, ...); ``row`` selects the request within
        it.  Used by the disaggregated path, where a prefill worker
        produces the dense cache and hands it to the decode worker's pool;
        only sound for pure-paged layouts (the engine guards this).  On a
        mesh each rank writes its own pool shard from the cache's local
        shard, which must carry the pool leaf's placements (as
        ``models.attention.write_pages`` writes its shard)."""
        bs = self.pcfg.block_size
        n = blocks_for(seq_len, bs)
        assert n <= len(bids), (seq_len, len(bids))
        idx = self._idx(list(bids)[:n])
        pad = n * bs - seq_len

        def seat(pool, pc):
            if is_dtensor(pool) and tuple(pc.placements) != tuple(
                    pool.placements):
                raise ValueError(f"prefill cache placed {pc.placements}, "
                                 f"the pool leaf {pool.placements}")
            dst, src = _local(pool), _local(pc)[:, row, :seq_len]
            if pad:
                src = torch.cat([src, src.new_zeros(
                    (src.shape[0], pad) + tuple(src.shape[2:]))], dim=1)
            dst[:, idx] = src.reshape(src.shape[0], n, bs,
                                      *src.shape[2:]).to(dst.dtype)
        self._rewrite(False, seat, pcaches)


def _local(a):
    """A pool leaf's storage on this rank: a DTensor's local shard (a view
    of it: writes land in the DTensor), a plain tensor as it is."""
    return a.to_local() if is_dtensor(a) else a


def _zeros_on(like, mesh, placements, device):
    """A DTensor of zeros shaped as ``like`` (a meta tensor) placed by
    ``placements`` on ``mesh``, each rank allocating only its own shard."""
    from torch.distributed.tensor import DTensor, Shard
    shape = list(like.shape)
    for n, p in zip(mesh.shape, placements):
        if isinstance(p, Shard):
            assert shape[p.dim] % n == 0, (like.shape, placements)
            shape[p.dim] //= n
    return DTensor.from_local(
        torch.zeros(shape, dtype=like.dtype, device=device), mesh,
        placements, run_check=False, shape=like.shape,
        stride=like.stride())


def _rows(a, index):
    """A copy of ``a[index]`` (rows of the block or seat dim, which no
    placement shards); on a DTensor the rows of this rank's shard, as a
    DTensor with ``a``'s placements."""
    out = local_index(a, index)
    # a slice is a view of the pool: copy it; a tensor index copies already
    return out if any(torch.is_tensor(i) for i in index) else out.clone()


def _put_rows(a, index, v) -> None:
    """``a[index] = v`` in place; on a mesh into this rank's shard, from
    ``v``'s local shard, which must carry ``a``'s placements (a restore
    puts back exactly the layout that was spilled)."""
    if is_dtensor(a) and tuple(v.placements) != tuple(a.placements):
        raise ValueError(f"restored rows placed {v.placements}, the pool "
                         f"leaf {a.placements}")
    local_index_put(a, index, v)
