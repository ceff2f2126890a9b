"""HyperMem pieces of the port: the lookahead :class:`Prefetcher` behind
predictive restore.  Tier budgets, the disk tier and the residency
planner wait for the HyperMem item in ROADMAP.md."""
from repro_torch.mem.prefetcher import Prefetcher

__all__ = ["Prefetcher"]
