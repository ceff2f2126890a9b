"""HyperMem: graph-driven hierarchical memory (device -> host -> disk).

The port of ``repro.mem``:

- :mod:`repro_torch.mem.tiers`: :class:`TierStack`, the capacity-accounted
  host/disk store with deterministic LRU and typed
  :class:`MemCapacityError`; backs ``core/kvcache.HostArchive``.
- :mod:`repro_torch.mem.planner`: :func:`plan_residency`, the graph walk
  that assigns every parameter leaf a tier and a layer-keyed prefetch
  slot under per-tier byte budgets (``OffloadConfig(policy="graph")``).
- :mod:`repro_torch.mem.prefetcher`: :class:`Prefetcher`, the
  deterministic lookahead staging buffer behind the serving runtime's
  predictive restore (``mem.prefetch.{hit,miss}`` /
  ``mem.restore_ahead.hit`` counters).
"""
from repro_torch.mem.planner import HBM, MemLeaf, ResidencyPlan, \
    plan_residency
from repro_torch.mem.prefetcher import Prefetcher, run_schedule
from repro_torch.mem.tiers import DISK, HOST, MemCapacityError, TierStack, \
    tree_nbytes

__all__ = [
    "HBM",
    "HOST",
    "DISK",
    "MemCapacityError",
    "TierStack",
    "tree_nbytes",
    "MemLeaf",
    "ResidencyPlan",
    "plan_residency",
    "Prefetcher",
    "run_schedule",
]
