"""Typed hierarchical memory tiers: device -> host memory -> disk.

The port's copy of ``repro.mem.tiers``.  :class:`TierStack` is the
storage engine behind the serving runtime's
:class:`~repro_torch.core.kvcache.HostArchive`.  It keys trees of tensors
(the port's dict/tuple/list containers), accounts bytes per tier, and
moves entries between tiers with a **deterministic** LRU: recency is a
monotonic access counter, never the wall clock, so the exact sequence of
evictions, and so the ``mem.evict.{host,disk}`` counters, depends only on
the call history.

Tier semantics:

- **host**: entries live as CPU tensors in a dict (pinned when the
  archive copied them off the card); bounded by ``host_bytes``.  Overflow
  spills the least-recently-used entry to disk.
- **disk**: entries live as one ``.npz`` file a key under a private
  ``hypermem-`` temp directory; bounded by ``disk_bytes``.  Overflow drops
  the LRU *unpinned* entry (reconstructable data, such as staged prefetch
  copies); if every resident entry is pinned (correctness-critical spill
  state) the stack raises :class:`MemCapacityError` instead of corrupting
  it.  A leaf is written as its raw bytes (a bfloat16 leaf as its 16-bit
  view, which numpy can hold) with its dtype recorded beside, so a round
  trip through disk is bit-exact in every dtype.

Budgets of ``0`` / ``None`` mean unbounded.
"""
from __future__ import annotations

import os
import shutil
import tempfile
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.tree import tree_leaves, tree_map

HOST = "host"
DISK = "disk"

# dtypes numpy cannot hold, written as the integer view of the same width
_RAW_VIEW = {torch.bfloat16: torch.int16}


class MemCapacityError(RuntimeError):
    """Every tier (host AND disk) is exhausted by pinned entries."""


class _Entry:
    __slots__ = ("value", "nbytes", "pinned", "seq", "path", "skeleton",
                 "dtypes")

    def __init__(self, value, nbytes: int, pinned: bool, seq: int):
        self.value = value          # tensor tree (host tier) | None (disk)
        self.nbytes = nbytes
        self.pinned = pinned
        self.seq = seq              # monotonic LRU clock, not wall-clock
        self.path = None            # .npz path (disk tier)
        self.skeleton = None        # the tree with None leaves (disk tier)
        self.dtypes = None          # each leaf's torch dtype (disk tier)


def tree_nbytes(value) -> int:
    """Total bytes over the tensor leaves of a tree."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(value))


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().contiguous()
    raw = _RAW_VIEW.get(t.dtype)
    return (t.view(raw) if raw is not None else t).numpy()


def _from_numpy(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    t = torch.from_numpy(a)
    return t.view(dtype) if dtype in _RAW_VIEW else t


class TierStack:
    """Host -> disk keyed store with capacity accounting + deterministic LRU.

    Not thread-safe by design: every caller (BlockManager, ServeEngine)
    serialises archive access on the scheduler thread, and a lock would
    hide ordering faults the deterministic counters exist to catch.
    Leaves must be CPU tensors whose data is final (an archive copies off
    the card synchronously before it puts), since a spill to disk reads
    them.
    """

    def __init__(self, host_bytes: Optional[int] = None,
                 disk_bytes: Optional[int] = None, *,
                 spill_dir: Optional[str] = None):
        self.host_bytes = host_bytes or None    # 0 -> unbounded
        self.disk_bytes = disk_bytes or None
        self._spill_dir = spill_dir
        self._tmpdir: Optional[str] = None      # lazily created
        self._host: Dict[object, _Entry] = {}
        self._disk: Dict[object, _Entry] = {}
        self._seq = 0
        self.counters = {"evict_host": 0, "evict_disk": 0, "disk_loads": 0}

    # -- internals ----------------------------------------------------------
    def _tick(self) -> int:
        self._seq += 1
        return self._seq

    def _dir(self) -> str:
        if self._tmpdir is None:
            self._tmpdir = self._spill_dir or tempfile.mkdtemp(
                prefix="hypermem-")
            os.makedirs(self._tmpdir, exist_ok=True)
        return self._tmpdir

    def _lru_key(self, tier: Dict[object, _Entry], *,
                 unpinned_only: bool = False):
        best = None
        for k, e in tier.items():
            if unpinned_only and e.pinned:
                continue
            if best is None or e.seq < tier[best].seq:
                best = k
        return best

    def _write_disk(self, key, entry: _Entry) -> None:
        leaves = tree_leaves(entry.value)
        path = os.path.join(self._dir(), f"e{self._tick()}.npz")
        np.savez(path, *[_to_numpy(t) for t in leaves])
        entry.path = path
        entry.dtypes = [t.dtype for t in leaves]
        entry.skeleton = tree_map(lambda _: None, entry.value)
        entry.value = None
        self._disk[key] = entry
        self._shrink_disk()

    def _read_disk(self, entry: _Entry):
        with np.load(entry.path) as z:
            leaves = iter([_from_numpy(z[f"arr_{i}"], dt)
                           for i, dt in enumerate(entry.dtypes)])
        self.counters["disk_loads"] += 1
        return tree_map(lambda _: next(leaves), entry.skeleton)

    def _drop_disk(self, key) -> None:
        e = self._disk.pop(key)
        if e.path and os.path.exists(e.path):
            os.remove(e.path)

    def _shrink_host(self) -> None:
        if self.host_bytes is None:
            return
        while self.nbytes(HOST) > self.host_bytes and self._host:
            k = self._lru_key(self._host)
            self.counters["evict_host"] += 1
            self._write_disk(k, self._host.pop(k))

    def _shrink_disk(self) -> None:
        if self.disk_bytes is None:
            return
        while self.nbytes(DISK) > self.disk_bytes:
            k = self._lru_key(self._disk, unpinned_only=True)
            if k is None:
                used = self.nbytes(DISK)
                raise MemCapacityError(
                    f"disk tier exhausted: {used} bytes of pinned entries "
                    f"exceed the {self.disk_bytes}-byte budget (host budget "
                    f"{self.host_bytes or 'unbounded'}); raise "
                    "archive_disk_bytes or reduce preemption pressure")
            self.counters["evict_disk"] += 1
            self._drop_disk(k)

    # -- public API ---------------------------------------------------------
    def put(self, key, value, *, pinned: bool = True,
            nbytes: Optional[int] = None) -> None:
        """Insert/replace ``key`` in the host tier; rebalance budgets.
        ``nbytes`` is what the entry counts against the budgets (default:
        its leaves' bytes; the archive passes a mesh's global bytes)."""
        self.discard(key)
        self._host[key] = _Entry(value, tree_nbytes(value) if nbytes is None
                                 else nbytes, pinned, self._tick())
        self._shrink_host()

    def get(self, key, *, pop: bool = False,
            promote: bool = True) -> Tuple[object, str]:
        """Return ``(value, tier_it_came_from)``; touch LRU recency.

        A disk hit with ``promote=True`` (and not ``pop``) re-seats the
        entry in the host tier: the restore path warms what it touches.
        """
        if key in self._host:
            e = self._host[key]
            e.seq = self._tick()
            if pop:
                del self._host[key]
            return e.value, HOST
        if key in self._disk:
            e = self._disk[key]
            value = self._read_disk(e)
            if pop:
                self._drop_disk(key)
            elif promote:
                self._drop_disk(key)
                self._host[key] = _Entry(value, e.nbytes, e.pinned,
                                         self._tick())
                self._shrink_host()
            else:
                e.seq = self._tick()
            return value, DISK
        raise KeyError(key)

    def __contains__(self, key) -> bool:
        return key in self._host or key in self._disk

    def discard(self, key) -> None:
        if key in self._host:
            del self._host[key]
        elif key in self._disk:
            self._drop_disk(key)

    def keys(self) -> Iterable:
        return list(self._host) + list(self._disk)

    def tier_of(self, key) -> Optional[str]:
        if key in self._host:
            return HOST
        if key in self._disk:
            return DISK
        return None

    def nbytes(self, tier: Optional[str] = None) -> int:
        if tier == HOST:
            return sum(e.nbytes for e in self._host.values())
        if tier == DISK:
            return sum(e.nbytes for e in self._disk.values())
        return self.nbytes(HOST) + self.nbytes(DISK)

    def entries(self, tier: Optional[str] = None) -> int:
        if tier == HOST:
            return len(self._host)
        if tier == DISK:
            return len(self._disk)
        return len(self._host) + len(self._disk)

    def close(self) -> None:
        if self._tmpdir and self._spill_dir is None:
            shutil.rmtree(self._tmpdir, ignore_errors=True)
        self._tmpdir = None
        self._host.clear()
        self._disk.clear()

    def __del__(self):  # best-effort temp cleanup
        try:
            self.close()
        except Exception:
            pass
