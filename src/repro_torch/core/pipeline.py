"""HyperParallel-Mpipe: stage partitioning + the synchronous 1F1B schedule.

The port of ``repro.core.pipeline``.  Pipeline parallelism is the third
MPMD tenant (after serve-disagg and the RL actor/learner): the layer stack
is split into ``S`` contiguous stages, each stage runs on a
:class:`~repro_torch.core.mpmd.ProcessGroup` of ranks (or, colocated, in
one process beside the others), and a global batch of ``M`` micro-batches
flows through the classic warmup -> steady 1F1B -> drain schedule
(PipeDream-flush: synchronous, one in-flight optimizer version, no stale
weights).

Two layers live here, both host-side arithmetic copied from the
reference, with its error texts:

  - :func:`partition_stages` — the stage partitioner.  Contiguous stages
    over the macro-layer stack (a macro-layer = one repeat of a
    :class:`~repro_torch.models.mixers.Segment`), even split by default,
    explicit ``stage_layers=(...)`` with a typed
    :class:`~repro_torch.api.errors.PipelinePlanError` on overclaim.
    Embeddings are pinned to the first stage and final-norm/unembed to
    the last — a property of the *assignment* (``first`` / ``last``
    flags), not of the layer counts.  :func:`stage_param_tree` cuts a
    stage's own copy of its params out of the full tree.

  - :func:`schedule_1f1b` — a dependency-exact simulation of the
    synchronous 1F1B schedule.  Returns the per-(stage, tick) table, the
    dispatch order every stage follows, and the EXACT bubble-slot count,
    which equals the closed form
    :func:`~repro_torch.core.mpmd.pipeline_bubble_steps`.

Analytic identities (uniform stage times):

    span          = 2 * (M + S - 1)            ticks
    bubble_steps  = 2 * S * (S - 1)            idle (stage, tick) slots
    bubble_frac   = bubble_steps / (S * span) = (S - 1) / (M + S - 1)
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple


def _err(msg: str):
    from repro_torch.api.errors import PipelinePlanError
    return PipelinePlanError(msg)


# ---------------------------------------------------------------------------
# stage partitioner
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class StageSlice:
    """A contiguous run of repeats inside one stacked segment."""
    seg: int                   # segment index (params key f"seg{seg}")
    start: int                 # first repeat owned (inclusive)
    stop: int                  # last repeat owned (exclusive)

    @property
    def count(self) -> int:
        return self.stop - self.start


@dataclasses.dataclass(frozen=True)
class StageAssignment:
    """One pipeline stage's share of the layer stack."""
    index: int                        # 0-based stage id
    num_stages: int
    layers: Tuple[int, ...]           # global macro-layer indices owned
    slices: Tuple[StageSlice, ...]    # per-segment contiguous slices
    rule: str                         # "even" | "explicit"

    @property
    def first(self) -> bool:
        """Owns the embedding (and any multimodal frontend projection)."""
        return self.index == 0

    @property
    def last(self) -> bool:
        """Owns final_norm + the unembedding readout."""
        return self.index == self.num_stages - 1


def num_macro_layers(cfg) -> int:
    """Macro-layer count: total segment repeats (the partitionable unit)."""
    from repro_torch.models.mixers import segments
    return sum(seg.repeat for seg in segments(cfg))


def even_stage_layers(n_layers: int, n_stages: int) -> Tuple[int, ...]:
    """Even split; earlier stages absorb the remainder (L//S + 0/1 each)."""
    base, rem = divmod(n_layers, n_stages)
    return tuple(base + (1 if s < rem else 0) for s in range(n_stages))


def partition_stages(cfg, num_stages: int,
                     stage_layers: Sequence[int] = (),
                     ) -> Tuple[StageAssignment, ...]:
    """Split ``cfg``'s macro-layer stack into contiguous pipeline stages.

    ``stage_layers`` pins explicit per-stage layer counts; empty means the
    even split.  Every malformed request is a typed
    :class:`~repro_torch.api.errors.PipelinePlanError` raised here, before
    any group is carved or any param is cut: too many stages for the stack
    (stage-overclaim), counts that do not sum to the stack, an empty
    stage.
    """
    from repro_torch.models.mixers import segments
    n_layers = num_macro_layers(cfg)
    if num_stages < 1:
        raise _err(f"pipeline.stages={num_stages}: need >= 1 stage")
    if num_stages > n_layers:
        raise _err(
            f"pipeline stage-overclaim: stages={num_stages} but "
            f"{cfg.name} has only {n_layers} macro-layers — every stage "
            "needs >= 1 layer; shrink stages or grow the model")
    rule = "even"
    counts = even_stage_layers(n_layers, num_stages)
    if stage_layers:
        rule = "explicit"
        counts = tuple(int(c) for c in stage_layers)
        if len(counts) != num_stages:
            raise _err(
                f"pipeline.stage_layers={counts} names {len(counts)} "
                f"stages but pipeline.stages={num_stages}; the two must "
                "agree (drop stage_layers for the even split)")
        if any(c < 1 for c in counts):
            raise _err(
                f"pipeline.stage_layers={counts}: every stage needs >= 1 "
                "macro-layer")
        if sum(counts) != n_layers:
            kind = ("stage-overclaim" if sum(counts) > n_layers
                    else "stage-underclaim")
            raise _err(
                f"pipeline {kind}: stage_layers={counts} claims "
                f"{sum(counts)} macro-layers but {cfg.name} has "
                f"{n_layers}")

    # segment boundaries in global macro-layer coordinates
    seg_bounds = []               # (seg index, global start, repeat)
    off = 0
    for si, seg in enumerate(segments(cfg)):
        seg_bounds.append((si, off, seg.repeat))
        off += seg.repeat

    out = []
    lo = 0
    for s, c in enumerate(counts):
        hi = lo + c
        slices = []
        for si, g0, rep in seg_bounds:
            a, b = max(lo, g0), min(hi, g0 + rep)
            if a < b:
                slices.append(StageSlice(si, a - g0, b - g0))
        out.append(StageAssignment(
            index=s, num_stages=num_stages,
            layers=tuple(range(lo, hi)), slices=tuple(slices), rule=rule))
        lo = hi
    return tuple(out)


def stage_param_tree(params: Dict, cfg, asn: StageAssignment) -> Dict:
    """One stage's own param tree, cut out of a full model tree.

    Stacked segment leaves keep their ``seg{i}`` keys and paths, so the
    HyperShard rule table fires unchanged on the subtree; each is a
    contiguous COPY of the stage's repeats (``[start:stop]``), so that the
    full tree can be dropped once every stage has its own.  The first
    stage owns ``embed`` (+ ``frontend_proj``); the last owns
    ``final_norm`` (+ ``unembed``).  Under tied embeddings a non-first
    last stage carries a COPY of ``embed`` for the readout — the trainer
    moves its gradient back to stage 0 and re-syncs the copy after each
    optimizer step (see train/pipeline_trainer.py).  Works on a tree of
    plain tensors (or meta tensors) of any device.
    """
    from repro_torch.core.tree import tree_map
    out: Dict = {}
    if asn.first:
        out["embed"] = params["embed"].clone()
        if "frontend_proj" in params:
            out["frontend_proj"] = params["frontend_proj"].clone()
    if asn.last:
        out["final_norm"] = params["final_norm"].clone()
        if "unembed" in params:
            out["unembed"] = params["unembed"].clone()
        elif not asn.first:
            out["embed"] = params["embed"].clone()     # tied readout copy
    for sl in asn.slices:
        out[f"seg{sl.seg}"] = tree_map(
            lambda a, _sl=sl: a[_sl.start:_sl.stop].clone(),
            params[f"seg{sl.seg}"])
    return out


# ---------------------------------------------------------------------------
# 1F1B schedule
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class PipelineOp:
    """One unit of stage work: a forward or backward of one micro-batch."""
    kind: str                  # "F" | "B"
    micro: int
    stage: int
    tick: int                  # start tick in the dependency-exact timeline

    def label(self) -> str:
        return f"{self.kind}{self.micro}@s{self.stage}"


@dataclasses.dataclass(frozen=True)
class PipelineSchedule:
    """The simulated synchronous 1F1B timeline for (S stages, M micros)."""
    n_stages: int
    n_micro: int
    ops: Tuple[PipelineOp, ...]        # dispatch order: sorted (tick, stage)
    span: int                          # total ticks, = 2 * (M + S - 1)
    bubble_steps: int                  # idle (stage, tick) slots in the span
    stage_windows: Tuple[Tuple[int, int], ...]  # (first tick, last tick+1)

    def dispatch_labels(self) -> Tuple[str, ...]:
        return tuple(op.label() for op in self.ops)

    def stage_phases(self, stage: int) -> Tuple[int, int, int]:
        """(fill, busy, drain) tick counts for one stage's swimlane."""
        lo, hi = self.stage_windows[stage]
        return lo, hi - lo, self.span - hi


def _stage_op_order(n_stages: int, n_micro: int, stage: int):
    """One stage's 1F1B op sequence: warmup forwards, then strict 1F1B."""
    warmup = min(n_micro, n_stages - 1 - stage)
    ops = [("F", m) for m in range(warmup)]
    nf, nb = warmup, 0
    while nb < n_micro:
        if nf < n_micro:
            ops.append(("F", nf))
            nf += 1
        ops.append(("B", nb))
        nb += 1
    return ops


def schedule_1f1b(n_stages: int, n_micro: int) -> PipelineSchedule:
    """Dependency-exact simulation of synchronous 1F1B (PipeDream-flush).

    Every op takes one tick (uniform stage times — the analytic regime of
    :func:`~repro_torch.core.mpmd.pipeline_bubble_fraction`).  F(m)@s
    depends on F(m)@s-1; B(m)@s depends on B(m)@s+1 (and on F(m)@s
    locally, implied by the per-stage order).  The resulting bubble count
    is EXACT and equals :func:`~repro_torch.core.mpmd.
    pipeline_bubble_steps`.
    """
    if n_stages < 1:
        raise _err(f"schedule_1f1b: n_stages={n_stages} must be >= 1")
    if n_micro < 1:
        raise _err(f"schedule_1f1b: n_micro={n_micro} must be >= 1")
    orders = [_stage_op_order(n_stages, n_micro, s) for s in range(n_stages)]
    ptr = [0] * n_stages
    free = [0] * n_stages                       # stage's next idle tick
    f_end: Dict[Tuple[int, int], int] = {}      # (stage, micro) -> end tick
    b_end: Dict[Tuple[int, int], int] = {}
    placed: list = []
    remaining = sum(len(o) for o in orders)
    while remaining:
        progressed = False
        for s in range(n_stages):
            while ptr[s] < len(orders[s]):
                kind, m = orders[s][ptr[s]]
                if kind == "F":
                    dep = 0 if s == 0 else f_end.get((s - 1, m))
                else:
                    dep = (f_end.get((s, m)) if s == n_stages - 1
                           else b_end.get((s + 1, m)))
                if dep is None:
                    break                       # blocked on a peer stage
                start = max(free[s], dep)
                end = start + 1
                (f_end if kind == "F" else b_end)[(s, m)] = end
                placed.append(PipelineOp(kind, m, s, start))
                free[s] = end
                ptr[s] += 1
                remaining -= 1
                progressed = True
        assert progressed, "1F1B dependency deadlock (schedule bug)"
    placed.sort(key=lambda op: (op.tick, op.stage, op.kind))
    span = max(op.tick for op in placed) + 1
    windows = []
    for s in range(n_stages):
        ticks = [op.tick for op in placed if op.stage == s]
        windows.append((min(ticks), max(ticks) + 1))
    busy = len(placed)                           # every op is one tick
    bubble = n_stages * span - busy
    return PipelineSchedule(n_stages, n_micro, tuple(placed), span, bubble,
                            tuple(windows))


def sequential_dispatch(n_stages: int, n_micro: int) -> Tuple[PipelineOp, ...]:
    """The no-overlap baseline order: each micro-batch runs its full
    forward and backward across every stage before the next starts
    (what a naive per-micro loop dispatches)."""
    ops = []
    t = 0
    for m in range(n_micro):
        for s in range(n_stages):
            ops.append(PipelineOp("F", m, s, t))
            t += 1
        for s in reversed(range(n_stages)):
            ops.append(PipelineOp("B", m, s, t))
            t += 1
    return tuple(ops)


def dispatch_digest(labels: Sequence[str]) -> int:
    """Stable integer digest of a dispatch order (a crc32 of the labels
    joined by commas, as the reference pins it)."""
    import zlib
    return zlib.crc32(",".join(labels).encode())


__all__ = [
    "StageSlice", "StageAssignment", "PipelineOp", "PipelineSchedule",
    "num_macro_layers", "even_stage_layers", "partition_stages",
    "stage_param_tree", "schedule_1f1b", "sequential_dispatch",
    "dispatch_digest",
]
