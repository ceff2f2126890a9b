"""HyperShard: declarative parallel-strategy derivation for whole models.

The port of ``repro.core.hypershard``.  Model code is written
single-device (paper Fig. 5b); this module owns the entire parallel
strategy.  A :class:`ShardingPlan` declares the intent (tensor-parallel
axis, FSDP axes, offload targets); :func:`derive_param` derives a
:class:`~repro_torch.core.layout.ShardStrategy` for every parameter from
its tree path and shape, with the reference's divisibility fallback (a
dim that does not divide drops axes, innermost first, until it does, or
stays replicated).  The same registry derives the decode caches' and the
serving pool's strategies (:func:`derive_cache`, :func:`derive_pool`).

The rule table, the roles, the fallback and its notes are the
reference's, verbatim.  Where the reference builds ``NamedSharding``
trees, :func:`make_param_shardings` and :func:`make_cache_shardings`
build trees of :class:`NamedSharding` (a ``DeviceMesh``, a spec and the
DTensor placements it becomes).  DTensor would
accept uneven shards, and JAX does not: every placement here comes from
the fallback, and :func:`distribute` asserts that each sharded dim divides,
so DTensor never chunks unevenly.

The user-facing declaration is the facade's
:class:`~repro_torch.api.plan.HyperPlan`, which lowers to a
:class:`ShardingPlan`.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Optional, Tuple

from repro_torch.core.layout import (Layout, LayoutError, ShardStrategy,
                                     layout_for_mesh, placements_on)
from repro_torch.core.tree import tree_map_with_path

Axes = Optional[Tuple[str, ...]]


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    """Declarative intent, decoupled from model code (paper §3.4)."""
    tp: Axes = ("model",)                  # tensor-parallel mesh axes
    fsdp: Axes = ("pod", "data")           # ZeRO-3-ish parameter sharding axes
    dp: Axes = ("pod", "data")             # batch axes
    # MoE expert-weight placement: "ep" = experts over tp axis (expert
    # parallelism, pairs with the GShard dispatch); "dp" = experts over the
    # fsdp axes + expert-FFN dim over tp (pairs with dispatch="dp_local")
    moe_weights: str = "ep"
    # HyperOffload knobs (paper §3.2)
    params_on_host: bool = False           # weights live in host memory
    opt_state_on_host: bool = False        # optimizer states live in host memory
    activation_offload: bool = False       # remat-offload layer residuals
    # serving
    kv_seq_axes: Axes = None               # shard cache sequence (flash-decode)

    def replace(self, **kw) -> "ShardingPlan":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# rule table: (regex over tree path, role)
# roles name the *last* dims of the parameter (leading stacked-layer dims are
# automatically replicated).
# ---------------------------------------------------------------------------
_RULES: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    (r"embed$",                    ("vocab", "residual")),
    (r"unembed$",                  ("vocab", "residual")),
    (r"frontend_proj$",            ("none", "tp")),
    (r"final_norm$|norm1$|norm2$|norm$|kv_norm$", ("none",)),
    (r"(wq|wk|wv|w_dkv|w_x|w_gate|w_up|w_input_gate|w_a_gate|in_proj)$",
                                   ("fsdp", "tp")),
    (r"(wo|w_out|w_down|out_proj)$", ("tp", "fsdp")),
    (r"(w_uk|w_uv)$",              ("fsdp", "tp")),
    (r"(ws_gate|ws_up)$",          ("fsdp", "tp")),
    (r"ws_down$",                  ("tp", "fsdp")),
    (r"(bq|bk|bv)$",               ("tp",)),
    (r"router$",                   ("none", "none")),
    (r"ffn/(w_gate|w_up)$",        ("expert", "fsdp", "none")),   # MoE stacked
    (r"ffn/w_down$",               ("expert", "none", "fsdp")),
    (r"conv_w$",                   ("none", "none")),
    (r"(A_log|D|dt_bias|lambda)$", ("none",)),
)

# MoE expert weights are 3D (E, D, F); they match the generic w_gate rule
# first unless we check the expert rule earlier — order fixed below.
_MOE_RULES = (
    (r"ffn/(w_gate|w_up)$",        ("expert", "fsdp", "none")),
    (r"ffn/w_down$",               ("expert", "none", "fsdp")),
)

_MOE_RULES_DP = (
    (r"ffn/(w_gate|w_up)$",        ("fsdp", "none", "tp")),
    (r"ffn/w_down$",               ("fsdp", "tp", "none")),
)


def _role_axes(role: str, plan: ShardingPlan) -> Axes:
    if role == "tp":
        return plan.tp
    if role == "fsdp":
        return plan.fsdp
    if role == "vocab":
        return plan.tp
    if role == "expert":
        return plan.tp                      # expert parallelism over the TP axis
    if role == "residual":
        return plan.fsdp
    return None


def match_rule(path: str, shape: Tuple[int, ...],
               moe_weights: str = "ep"):
    """The rule table lookup: returns ``(pattern, roles)``.

    ``pattern`` is the regex that fired (``None`` for the replicate-all
    default), so every derived spec is traceable to its rule.
    """
    moe_rules = _MOE_RULES_DP if moe_weights == "dp" else _MOE_RULES
    for pat, roles in moe_rules:
        if re.search(pat, path) and len(shape) >= 3:
            return pat, roles
    for pat, roles in _RULES:
        if re.search(pat, path):
            return pat, roles
    return None, ("none",) * len(shape)


def roles_for_path(path: str, shape: Tuple[int, ...],
                   moe_weights: str = "ep") -> Tuple[str, ...]:
    """Match the rule table; returns one role per *trailing* dim."""
    return match_rule(path, shape, moe_weights)[1]


def derive_param(path: str, shape: Tuple[int, ...], layout: Layout,
                 plan: ShardingPlan):
    """Full param derivation: ``(ShardStrategy, rule_pattern, notes)``.

    ``notes`` records every divisibility fallback (axes dropped because the
    dim does not divide), the raw material of the facade's explain and
    validate reports.  Plan axes absent from the layout are NOT noted:
    that is the sanctioned multi-pod -> single-pod degradation.
    """
    rule, roles = match_rule(path, shape, plan.moe_weights)
    # leading dims not covered by the role tuple (stacked layers) replicate
    lead = len(shape) - len(roles)
    if lead < 0:                            # param rank < rule rank (reduced cfg)
        roles = roles[-len(shape):]
        lead = 0
    entries: list = [None] * lead
    notes: list = []
    for i, (dim, role) in enumerate(zip(shape[lead:], roles), start=lead):
        axes = _role_axes(role, plan)
        if not axes:
            entries.append(None)
            continue
        kept = tuple(a for a in axes if a in layout.alias_name)
        requested = kept
        # divisibility fallback: drop axes (innermost first) until it divides
        while kept and dim % math.prod(layout.axis_size(a) for a in kept):
            kept = kept[1:]
        if kept != requested:
            dropped = requested[:len(requested) - len(kept)]
            n = math.prod(layout.axis_size(a) for a in requested)
            notes.append(f"dim{i}[{role}]: {dim} % {n} != 0, dropped "
                         f"{dropped} -> " + (f"{kept}" if kept else "replicated"))
        entries.append(kept if len(kept) > 1 else (kept[0] if kept else None))
    return layout(*entries), rule, tuple(notes)


def param_strategy(path: str, shape: Tuple[int, ...], layout: Layout,
                   plan: ShardingPlan) -> ShardStrategy:
    return derive_param(path, shape, layout, plan)[0]


@dataclasses.dataclass(frozen=True, eq=False)
class NamedSharding:
    """One leaf's sharding: the reference's ``NamedSharding`` (a mesh and
    a spec) with the DTensor placements the spec becomes on that mesh
    (:func:`~repro_torch.core.layout.placements_on`)."""
    mesh: object
    spec: tuple

    @property
    def placements(self) -> tuple:
        return placements_on(self.spec, self.mesh)


def make_param_shardings(mesh, params_shape, plan: ShardingPlan):
    """A :class:`NamedSharding` per leaf of ``params_shape`` (a tree of
    tensors, meta tensors or anything with ``.shape``), derived by
    :func:`derive_param`."""
    layout = layout_for_mesh(mesh)
    return tree_map_with_path(
        lambda p, l: NamedSharding(mesh, param_strategy(
            p, tuple(l.shape), layout, plan).partition_spec()), params_shape)


def spec_tree(mesh, params_shape, plan: ShardingPlan):
    """Like :func:`make_param_shardings` but returns the raw specs."""
    layout = layout_for_mesh(mesh)
    return tree_map_with_path(
        lambda p, l: param_strategy(p, tuple(l.shape), layout, plan)
        .partition_spec(), params_shape)


def shard_tree(tree, shardings):
    """Each full leaf of ``tree`` distributed by its :class:`NamedSharding`
    in ``shardings`` (a tree of the same shape; :func:`distribute`)."""
    from repro_torch.core.tree import tree_map
    return tree_map(lambda t, s: distribute(t, s.mesh, s.placements), tree,
                    shardings)


def distribute(t, mesh, placements):
    """``t`` (the full tensor, the same on every rank) as a DTensor with
    ``placements`` over ``mesh``: each rank keeps its chunk, no
    communication.  Raises :class:`LayoutError` where a sharded dim does
    not divide its mesh dims (DTensor would chunk it unevenly, where the
    reference's derivation never does)."""
    from torch.distributed.tensor import Shard, distribute_tensor
    n = [1] * t.dim()
    for size, p in zip(mesh.shape, placements):
        if isinstance(p, Shard):
            n[p.dim] *= size
    for d, (dim, k) in enumerate(zip(t.shape, n)):
        if dim % k:
            raise LayoutError(f"dim {d} of size {dim} not divisible by "
                              f"{k} shards ({placements})")
    return distribute_tensor(t, mesh, list(placements), src_data_rank=None)


# ---------------------------------------------------------------------------
# KV-cache / decode-state shardings
# ---------------------------------------------------------------------------
def _fit(entry: Tuple[str, ...]):
    return entry if len(entry) > 1 else (entry[0] if entry else None)


def derive_cache(path: str, shape: Tuple[int, ...], layout: Layout,
                 plan: ShardingPlan, *, batch: int):
    """Decode-state derivation: ``(ShardStrategy, branch_note, fallbacks)``.

    Decode-state tensors (dim0 is always the stacked-layer axis):

      k/v           (L, B, S, KV, hd)   attention KV cache
      ckv / krope   (L, B, S, R)        MLA compressed latent cache
      state         (L, B, H, P, N) or (L, B, W)   SSM / RG-LRU state
      conv          (L, B, K-1, C)      causal-conv tail

    Batch shards over dp when divisible; otherwise (long_500k, B=1) the
    sequence dim absorbs the dp axes — context-parallel flash-decode.  KV
    heads shard over tp when divisible, else the sequence dim absorbs tp.

    ``branch_note`` names the branches that fired; ``fallbacks`` records
    every plan axis group that ended up placed NOWHERE (silent
    replication) — the strict-validation signal for explain reports.
    """
    dp = tuple(a for a in (plan.dp or ()) if a in layout.alias_name)
    tp = tuple(a for a in (plan.tp or ()) if a in layout.alias_name)
    ndim = len(shape)
    entries: list = [None] * ndim
    notes: list = []
    fallbacks: list = []

    def size(axes):
        return math.prod(layout.axis_size(a) for a in axes) if axes else 1

    def seq_absorb(seq_axes, absorbing: str):
        """Place the absorbed axes on the seq dim; record silent failure."""
        if not seq_axes:
            return
        if shape[2] % size(seq_axes) == 0:
            entries[2] = _fit(seq_axes)
            notes.append(f"seq/{'+'.join(seq_axes)}")
        else:
            fallbacks.append(
                f"seq cannot absorb {absorbing} ({shape[2]} % "
                f"{size(seq_axes)} != 0) -> {seq_axes} unplaced, replicated")

    leaf = path.rsplit("/", 1)[-1]
    batch_ok = dp and shape[1] % size(dp) == 0
    if batch_ok:
        entries[1] = _fit(dp)
        notes.append("batch/dp")
    elif dp and leaf in ("k", "v", "ckv", "krope"):
        notes.append("batch indivisible, dp falls to seq")

    if leaf in ("k", "v"):
        seq_axes: Tuple[str, ...] = () if batch_ok else dp
        absorbing = "" if batch_ok else "dp"
        if tp and shape[3] % size(tp) == 0:
            entries[3] = _fit(tp)
            notes.append("kv-heads/tp")
        else:
            seq_axes = seq_axes + tp
            if tp:
                notes.append("kv-heads indivisible, tp falls to seq")
                absorbing = (absorbing + "+tp") if absorbing else "tp"
        seq_absorb(seq_axes, absorbing)
    elif leaf in ("ckv", "krope"):
        seq_axes = (() if batch_ok else dp) + tp
        seq_absorb(seq_axes, "tp" if batch_ok else "dp+tp")
    elif leaf == "state":
        # dim2 is heads (SSD) or channels (RG-LRU): shard over tp
        if ndim >= 3 and tp:
            if shape[2] % size(tp) == 0:
                entries[2] = _fit(tp)
                notes.append("state-heads/tp")
            else:
                fallbacks.append(f"state heads {shape[2]} % {size(tp)} != 0 "
                                 f"-> {tp} unplaced, replicated")
    elif leaf == "conv":
        if ndim >= 4 and tp:
            if shape[3] % size(tp) == 0:
                entries[3] = _fit(tp)
                notes.append("conv-channels/tp")
            else:
                fallbacks.append(f"conv channels {shape[3]} % {size(tp)} != 0 "
                                 f"-> {tp} unplaced, replicated")
    if not batch_ok and dp and leaf in ("state", "conv"):
        # constant-size decode state has no seq dim to absorb into
        fallbacks.append(f"batch {shape[1]} % {size(dp)} != 0 -> {dp} "
                         "unplaced, replicated")

    note = "cache[" + leaf + "]: " + (", ".join(notes) if notes
                                      else "replicated")
    return layout(*entries), note, tuple(fallbacks)


def cache_strategy(path: str, shape: Tuple[int, ...], layout: Layout,
                   plan: ShardingPlan, *, batch: int) -> ShardStrategy:
    return derive_cache(path, shape, layout, plan, batch=batch)[0]


def derive_pool(path: str, shape: Tuple[int, ...], layout: Layout,
                plan: ShardingPlan):
    """Serving StatePool leaf derivation: ``(ShardStrategy, note, fallbacks)``.

    StatePool leaves (dim0 is always the stacked-layer axis):

      k/v           (L, N_blocks, block, KV, hd)  paged attention pool
      ckv / krope   (L, N_blocks, block, R)       paged MLA latent pool
      state         (L, slots, H, P, N) or (L, slots, W)  per-slot SSD/RG-LRU
      conv          (L, slots, K-1, C)            per-slot causal-conv tail

    Paged pools are shared by every request, so they replicate over the
    data axes; the KV-head dim shards over tp when divisible (the
    ``cache_strategy`` rule, pool edition).  MLA latents have no head dim
    — they replicate.  Per-slot dense state shards its head/channel dim
    over tp when divisible, mirroring the dense decode-cache derivation.

    ``fallbacks`` records every tp placement that could not bind (the
    strict-validation signal, same contract as :func:`derive_cache`).
    """
    tp = tuple(a for a in (plan.tp or ()) if a in layout.alias_name)
    ndim = len(shape)
    entries: list = [None] * ndim
    notes: list = []
    fallbacks: list = []
    tp_n = math.prod(layout.axis_size(a) for a in tp) if tp else 1
    leaf = path.rsplit("/", 1)[-1]

    def try_tp(dim_idx: int, what: str):
        if not tp:
            return
        if shape[dim_idx] % tp_n == 0:
            entries[dim_idx] = _fit(tp)
            notes.append(f"{what}/tp")
        else:
            fallbacks.append(f"{what} {shape[dim_idx]} % {tp_n} != 0 -> "
                             f"{tp} unplaced, replicated")

    if leaf in ("k", "v"):
        try_tp(3, "kv-heads")
    elif leaf in ("ckv", "krope"):
        notes.append("latent pool replicated (rank shared across heads)")
    elif leaf == "state" and ndim >= 3:
        try_tp(2, "state-heads")
    elif leaf == "conv" and ndim >= 4:
        try_tp(3, "conv-channels")

    note = "pool[" + leaf + "]: " + (", ".join(notes) if notes
                                     else "replicated")
    return layout(*entries), note, tuple(fallbacks)


def make_cache_shardings(mesh, cache_shape, plan: ShardingPlan, *,
                         batch: int):
    """A :class:`NamedSharding` per decode-state leaf of ``cache_shape``
    (:func:`derive_cache`)."""
    layout = layout_for_mesh(mesh)
    return tree_map_with_path(
        lambda p, l: NamedSharding(mesh, cache_strategy(
            p, tuple(l.shape), layout, plan, batch=batch).partition_spec()),
        cache_shape)

