"""Graph-driven residency planner: walk the program, place every leaf.

The port of ``repro.mem.planner``.  ``plan_residency(cfg, offload)``
derives, from the model's **program graph** rather than from hand config,
(a) the memory tier each parameter leaf should live in (device / host
memory / disk) under per-tier byte budgets, and (b) a prefetch schedule
keyed to layer index, so a :class:`~repro_torch.mem.prefetcher.Prefetcher`
can double-buffer host->device copies ``prefetch_depth`` layers ahead of
use.

The graph walk runs the port's ``forward(mode="train", remat=False)`` on
(1, 8) tokens over meta tensors (shapes and dtypes, no data, so nothing is
computed and nothing is allocated; every kernel wrapper takes its plain
version on them) under a ``TorchDispatchMode`` that records the first
operator taking each leaf as an input.  The reference runs each
``seg{i}`` as one ``lax.scan``, whose one equation consumes all of that
segment's leaves; the port's forward walks the layers one by one, so a
segment's leaves are collapsed to the segment's earliest rank, and ties
are broken by path as in the reference.  If the walk fails, the plan
falls back to path order with the rule noted.

The reference's ``with_hlo=True`` summarises XLA's HLO of the lowered
step, which has no counterpart here: it raises :class:`PlanError`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from repro_torch.mem.tiers import DISK, HOST, MemCapacityError

HBM = "hbm"


@dataclasses.dataclass(frozen=True)
class MemLeaf:
    """One parameter leaf's planned residency."""
    path: str
    shape: Tuple[int, ...]
    nbytes: int
    tier: str                     # "hbm" | "host" | "disk"
    rule: str                     # which planner rule fired
    first_use: int                # layer index of first consumption
    layers: int                   # stacked layer count (1 if unstacked)
    prefetch_step: Optional[int]  # layer step the first fetch is issued
    #                               (None when resident on the device)


@dataclasses.dataclass(frozen=True)
class ResidencyPlan:
    """Frozen residency + prefetch plan for one (cfg, OffloadConfig)."""
    model: str
    policy: str
    budgets: Dict[str, Optional[int]]          # tier -> bytes (None = inf)
    leaves: Tuple[MemLeaf, ...]
    schedule: Tuple[Tuple[int, Tuple[str, ...]], ...]  # (step, keys) pairs
    prefetch_depth: int
    graph_order: bool                          # graph walk succeeded
    hlo: Optional[dict] = None                 # always None in the port

    def bytes_in(self, tier: str) -> int:
        return sum(l.nbytes for l in self.leaves if l.tier == tier)

    def count_in(self, tier: str) -> int:
        return sum(1 for l in self.leaves if l.tier == tier)

    def schedule_dict(self) -> Dict[int, Tuple[str, ...]]:
        return dict(self.schedule)

    def leaf(self, path: str) -> MemLeaf:
        for l in self.leaves:
            if l.path == path:
                return l
        raise KeyError(path)


def param_shapes(cfg):
    """``init_model(cfg)``'s tree with each leaf a meta tensor of its shape
    and dtype: the init runs under ``FakeTensorMode`` (no memory)."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.core.tree import tree_map
    from repro_torch.models import model as M

    with FakeTensorMode():
        fake = M.init_model(cfg, torch.Generator().manual_seed(0))
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), fake)


def _param_leaves(cfg):
    """``[(path, meta tensor)]`` of :func:`param_shapes` in the reference's
    flatten order."""
    from repro_torch.core.tree import tree_flatten_with_path
    params = param_shapes(cfg)
    return params, tree_flatten_with_path(params)


def _first_use_order(cfg, params, flat):
    """Leaf index -> rank of the first operator consuming it, a segment's
    leaves collapsed to the segment's earliest rank."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves as pt_leaves

    from repro_torch.models import model as M

    index = {id(t): i for i, (_, t) in enumerate(flat)}
    first: Dict[int, int] = {}

    class _FirstUse(TorchDispatchMode):
        n_ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            for a in pt_leaves((args, kwargs or {})):
                i = index.get(id(a)) if isinstance(a, torch.Tensor) else None
                if i is not None and i not in first:
                    first[i] = self.n_ops
            self.n_ops += 1
            return func(*args, **(kwargs or {}))

    toks = torch.zeros(1, 8, dtype=torch.int32, device="meta")
    with torch.no_grad(), _FirstUse() as walk:
        M.forward(params, toks, cfg, mode="train", remat=False)
    # unconsumed leaves (e.g. a frontend projection with no prefix) last
    order = [first.get(i, walk.n_ops) for i in range(len(flat))]
    seg_rank: Dict[str, int] = {}
    for (path, _), r in zip(flat, order):
        seg = path.split("/", 1)[0]
        if seg.startswith("seg"):
            seg_rank[seg] = min(r, seg_rank.get(seg, r))
    return [seg_rank.get(path.split("/", 1)[0], r)
            for (path, _), r in zip(flat, order)]


def _segment_layer_spans(cfg) -> Dict[str, Tuple[int, int]]:
    """``seg{i}`` -> (first global layer index, stacked layer count)."""
    from repro_torch.models.mixers import segments

    spans, start = {}, 0
    for si, seg in enumerate(segments(cfg)):
        spans[f"seg{si}"] = (start, seg.repeat)
        start += seg.repeat
    return spans


def plan_residency(cfg, offload, *, with_hlo: bool = False) -> ResidencyPlan:
    """Derive per-leaf residency tiers + a layer-keyed prefetch schedule.

    Budgets come from ``offload`` (``hbm_budget_bytes`` etc.; 0 means
    unbounded).  Greedy assignment in first-use order: earliest-used
    leaves claim the device first, overflow cascades to host then disk,
    and a workload that does not fit even on disk is a plan-time
    :class:`~repro_torch.mem.tiers.MemCapacityError`, never a runtime
    out-of-memory.
    """
    if with_hlo:
        from repro_torch.api.errors import PlanError
        raise PlanError(
            "plan_residency(with_hlo=True): the reference summarises XLA's "
            "HLO of the lowered step, which the PyTorch port has no "
            "counterpart of yet (ROADMAP.md section 1 item 8h, the last "
            "slice)")
    params, flat = _param_leaves(cfg)
    graph_order, order_note = True, ""
    try:
        order = _first_use_order(cfg, params, flat)
    except Exception as e:  # pragma: no cover - trace fallback
        graph_order = False
        order_note = ("; path order (graph walk unavailable: "
                      f"{type(e).__name__})")
        order = list(range(len(flat)))

    spans = _segment_layer_spans(cfg)
    budgets = {HBM: offload.hbm_budget_bytes or None,
               HOST: offload.host_budget_bytes or None,
               DISK: offload.disk_budget_bytes or None}
    free = dict(budgets)
    depth = max(int(offload.prefetch_depth), 0)

    entries = []
    for i, (path, leaf) in enumerate(flat):
        seg = path.split("/", 1)[0]
        layer0, layers = spans.get(seg, (0, 1))
        nbytes = leaf.numel() * leaf.element_size()
        entries.append((order[i], path, tuple(leaf.shape), nbytes,
                        layer0, layers))
    entries.sort(key=lambda e: (e[0], e[1]))   # first-use rank, path tiebreak

    def take(tier, nbytes):
        if free[tier] is None:
            return True
        if free[tier] >= nbytes:
            free[tier] -= nbytes
            return True
        return False

    leaves = []
    for _, path, shape, nbytes, layer0, layers in entries:
        if len(shape) < 2:
            # 1-D leaves are not host-placeable (spec_fully_sharded
            # selectivity): pinned to the device regardless of pressure
            tier, rule = HBM, "pinned: 1-D leaf (not host-placeable)"
            if not take(HBM, nbytes):
                raise MemCapacityError(
                    f"hbm budget {budgets[HBM]} cannot hold pinned leaf "
                    f"{path} ({nbytes} bytes)")
        elif take(HBM, nbytes):
            tier = HBM
            rule = ("graph: hbm unbounded" if budgets[HBM] is None
                    else "graph: fits hbm budget")
        elif take(HOST, nbytes):
            tier, rule = HOST, "graph: hbm full -> host"
        elif take(DISK, nbytes):
            tier, rule = DISK, "graph: host full -> disk"
        else:
            raise MemCapacityError(
                f"leaf {path} ({nbytes} bytes) exceeds every tier budget "
                f"(hbm={budgets[HBM]}, host={budgets[HOST]}, "
                f"disk={budgets[DISK]})")
        prefetch = None if tier == HBM else max(0, layer0 - depth)
        leaves.append(MemLeaf(path, shape, nbytes, tier, rule + order_note,
                              layer0, layers, prefetch))

    # prefetch schedule: step -> keys fetched at that layer step.  Stacked
    # leaves are fetched once per layer slice ("path@layer"); unstacked
    # offloaded leaves once at their own slot.
    sched: Dict[int, list] = {}
    for l in leaves:
        if l.tier == HBM:
            continue
        for k in range(l.layers):
            step = max(0, l.first_use + k - depth)
            key = f"{l.path}@{l.first_use + k}" if l.layers > 1 else l.path
            sched.setdefault(step, []).append(key)
    schedule = tuple(sorted((s, tuple(sorted(ks)))
                            for s, ks in sched.items()))

    return ResidencyPlan(getattr(cfg, "name", str(cfg)),
                         getattr(offload, "policy", "graph"), budgets,
                         tuple(leaves), schedule, depth, graph_order)
