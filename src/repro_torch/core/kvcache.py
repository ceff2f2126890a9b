"""The host archive: where a preempted request's KV pages wait (HyperServe).

The port of ``repro.core.kvcache.HostArchive``: a keyed store of tensor
trees in host memory.  ``put`` copies a tree off the card into pinned
(page-locked) CPU tensors, so ``fetch`` can bring it back with
asynchronous copies (``non_blocking``) that overlap the card's work —
which is what predictive restore relies on.

The archive is unbounded.  The reference's byte-budgeted host and disk
tiers (``mem/tiers.py``) wait for the HyperMem item in ``ROADMAP.md``;
the serving runtime refuses nonzero budgets until then.
"""
from __future__ import annotations

from typing import Dict, Hashable

import torch

from repro_torch.core.tree import tree_leaves, tree_map


def _to_host(t: torch.Tensor) -> torch.Tensor:
    if t.device.type == "cpu":
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


class HostArchive:
    """Keyed store of tensor trees in (pinned) host memory."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._store: Dict[Hashable, object] = {}

    def put(self, key, value) -> None:
        self._store[key] = tree_map(_to_host, value)

    def fetch(self, key, *, pop: bool = True):
        """The tree under ``key`` on the archive's device (copies started
        asynchronously from pinned memory); ``pop=False`` keeps the entry."""
        value = self._store.pop(key) if pop else self._store[key]
        return tree_map(lambda t: t.to(self.device, non_blocking=True), value)

    def __contains__(self, key) -> bool:
        return key in self._store

    def discard(self, key) -> None:
        self._store.pop(key, None)

    def keys(self):
        return list(self._store)

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for v in self._store.values() for t in tree_leaves(v))
