"""Deterministic lookahead prefetcher: stage fetches ahead of use.

The port's copy of ``repro.mem.prefetcher.Prefetcher``.  Host->device
copies from pinned memory (``HostArchive.fetch``, ``non_blocking=True``)
are **asynchronous** — calling them returns immediately and the copy
overlaps whatever work is already queued on the card.  So a prefetcher
does not need threads: *staging* an entry one step before it is consumed
is the double-buffer idiom (start transfer k+1, compute on k), applied to
archive restores.

What must be deterministic is the **decision sequence** — which keys get
staged, in what order, and whether a consume was a hit or a miss.  None
of those read wall-clock, so ``mem.prefetch.{hit,miss}`` are exact
bench-gate counters.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Optional


class Prefetcher:
    """Bounded staging buffer over a ``fetch(key) -> value`` callable.

    - :meth:`stage` starts the (async) fetch for a key, subject to
      ``depth`` in-flight entries; re-staging a staged key is a no-op.
    - :meth:`take` consumes a key: staged -> pop + ``<name>.hit``;
      otherwise fetch synchronously-in-sequence + ``<name>.miss``.
    - :meth:`prune` drops staged entries whose source disappeared
      (cancelled requests), keeping buffer and archive consistent.
    """

    def __init__(self, fetch: Callable[[object], object], *,
                 depth: int = 2, obs=None, name: str = "mem.prefetch"):
        assert depth >= 0, depth
        self._fetch = fetch
        self.depth = depth
        self._staged: "OrderedDict[object, object]" = OrderedDict()
        self._obs = obs
        self._name = name
        self.counters = {"hit": 0, "miss": 0, "staged": 0, "dropped": 0}

    def _count(self, which: str) -> None:
        self.counters[which] += 1
        if self._obs is not None:
            self._obs.metrics.counter(f"{self._name}.{which}").inc()

    # -- staging ------------------------------------------------------------
    def stage(self, key) -> bool:
        """Begin fetching ``key`` ahead of use; False if full/already in."""
        if key in self._staged or (self.depth and
                                   len(self._staged) >= self.depth):
            return False
        self._staged[key] = self._fetch(key)
        self._count("staged")
        return True

    def staged(self, key) -> bool:
        return key in self._staged

    @property
    def entries(self) -> int:
        return len(self._staged)

    # -- consumption --------------------------------------------------------
    def take(self, key):
        """Consume ``key``: returns ``(value, was_staged)`` and counts
        ``hit`` / ``miss`` accordingly."""
        if key in self._staged:
            self._count("hit")
            return self._staged.pop(key), True
        self._count("miss")
        return self._fetch(key), False

    def drop(self, key) -> None:
        if self._staged.pop(key, None) is not None:
            self._count("dropped")

    def prune(self, alive: Callable[[object], bool]) -> None:
        """Drop staged entries whose backing store entry vanished."""
        for key in [k for k in self._staged if not alive(k)]:
            self.drop(key)


def run_schedule(schedule, step: int, prefetcher: Prefetcher,
                 consume: Optional[Callable[[object], None]] = None) -> int:
    """Drive a planner prefetch schedule at ``step``: stage every key the
    :class:`~repro_torch.mem.planner.ResidencyPlan` maps to this step;
    returns how many were newly staged.  ``consume(key)`` (if given) is
    called for keys whose fetch step IS the use step (depth-0 plans)."""
    n = 0
    for key in schedule.get(step, ()):
        if prefetcher.stage(key):
            n += 1
        if consume is not None:
            consume(key)
    return n
