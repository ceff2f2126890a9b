"""1F1B pipeline-parallel training over MPMD stage groups (Mpipe leg).

The port of ``repro.train.pipeline_trainer``.  The layer stack is cut into
``S`` contiguous stages (:func:`~repro_torch.core.pipeline.
partition_stages`); each stage owns a copy of its params
(:func:`~repro_torch.core.pipeline.stage_param_tree`) and its AdamW state,
and a global batch of ``M`` micro-batches runs the dependency-exact
:func:`~repro_torch.core.pipeline.schedule_1f1b` order.  Two modes:

  - **colocated**, when the world has fewer ranks than stages (one process
    without a process group is a world of one): every stage runs in every
    process, one op after another in the schedule's order, on the
    world's ``(1, n)`` mesh where n > 1.  That is the one-card path, and
    the reference's fallback when there are fewer devices than stages;
  - **one group a stage** otherwise: stage ``s`` runs on its own ranks
    (one rank, or a ``stage_mesh`` ``(d, m)`` group of them, carved by
    :func:`~repro_torch.core.mpmd.groups_from_mapping`), every rank walks
    the schedule and runs only its own stage's ops, in order, and the
    activations and cotangents go between the stages by
    :class:`~repro_torch.core.mpmd.Handoff` (the send does not block and
    each direction has a process group of its own, so two stages sending
    to each other at once cannot deadlock).

Parity contract, as the reference's: on the SAME global batch, pipelined
training equals the non-pipelined trainer within dtype tolerance.

  - the whole-batch mean CE is ``sum_m nll_sum_m / N_total`` with
    ``N_total`` the global mask count (known upfront), so each
    micro-batch's backward objective is ``nll_sum_m * (1/N_total)``;
  - an F op keeps its autograd graph (each layer under
    ``torch.utils.checkpoint``, as the non-pipelined forward, so the graph
    holds each layer's input only); a stage s > 0 receives its input as a
    leaf that requires grad, and the B op runs one backward on that graph
    with the received cotangent.  The last stage's F runs its forward and
    backward at once (the reference's ``fb``) and its B hands the input's
    gradient on.  Each micro's gradients are taken by
    ``torch.autograd.grad`` and added into float32 accumulators;
  - grad clipping uses the GLOBAL norm: each stage's f32 sum of squares
    (its leaves in the reference's flatten order), summed as Python floats
    in stage order on every rank, so that the colocated run and the
    multi-process one give the same bits; each stage then calls
    :func:`~repro_torch.optim.adamw.adamw_update_with_norm` on the params
    it owns;
  - tied embeddings: the last stage carries a readout COPY of ``embed``;
    its gradient goes back to stage 0 and adds into the lookup gradient
    before the norm, and the copy re-syncs from stage 0 after every
    optimizer step (it is left out of the last stage's optimizer).

MoE aux losses are batch-composition-dependent (router load terms): each
micro's aux term enters multiplied by ``1/M``, as the reference's do, so
the exact-parity contract applies to dense stacks.

Observability, with the reference's names: the counters
``train.pipeline.bubble_steps`` (1F1B only), ``.handoffs``,
``.microbatches`` and ``.tied_embed_syncs``, per-stage ``pipeline.fill``
and ``pipeline.drain`` spans on ``pipeline:stage{s}`` tracks (on the
ranks that run the stage), and the compile key ``("pipeline_step", (S,
M, cfg.name, moe_dispatch))``.  ``step`` returns the same dict on every
rank.  HyperOffload composes: each stage's state is fetched before the
step and offloaded after it.  The port has no ``HyperPlan`` yet (ROADMAP
item 8h): the trainer takes a ``PipelineConfig`` and a ``ShardingPlan``
for the stage meshes.  Checkpointing is not wired, as in the reference.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import time
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import PipelineConfig
from repro_torch.core import hypershard as hs, mpmd
from repro_torch.core.meshctx import (constrain, dp_entry, full_tensor,
                                      is_dtensor, mesh_axis_size, replicated,
                                      use_mesh)
from repro_torch.core.pipeline import (PipelineSchedule, StageAssignment,
                                       partition_stages, schedule_1f1b,
                                       sequential_dispatch, stage_param_tree)
from repro_torch.core.tree import (tree_flatten_with_path, tree_leaves,
                                   tree_map)
from repro_torch.models import model as M
from repro_torch.models.common import dtype_of, rms_norm
from repro_torch.models.mixers import segments
from repro_torch.optim import adamw as opt_mod
from repro_torch.serve.runtime import resolve_device
from repro_torch.train import steps as steps_mod
from repro_torch.train.trainer import TrainConfig, resolve_train_plan


def _err(msg: str):
    from repro_torch.api.errors import PipelinePlanError
    return PipelinePlanError(msg)


def _aux_of(metrics, cfg):
    if cfg.moe is None:
        return torch.zeros((), dtype=torch.float32,
                           device=metrics["moe_aux_loss"].device)
    return (cfg.moe.router_aux_coef * metrics["moe_aux_loss"]
            + cfg.moe.router_z_coef * metrics["moe_z_loss"])


def _stage_apply(params, inp, cfg, asn: StageAssignment, *, moe_dispatch):
    """Input -> output activations through one stage's layer slice.

    The first stage embeds tokens; every stage runs its contiguous
    macro-layers as ``models.model.forward`` runs them (each repeat under
    ``torch.utils.checkpoint`` while a gradient is recorded, the same
    ``constrain`` points), so the numerics match the plain trainer.
    Returns (x, {"moe_aux_loss", "moe_z_loss"} summed over the slice)."""
    if asn.first:
        x = F.embedding(inp.long(), replicated(params["embed"]))
        x = constrain(x, ("pod", "data"), None, None)
    else:
        x = inp
    positions = torch.arange(x.shape[1], device=x.device)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    aux, z = zero, zero
    remat = torch.is_grad_enabled()
    segs = segments(cfg)
    for sl in asn.slices:
        seg, seg_p = segs[sl.seg], params[f"seg{sl.seg}"]
        for li in range(sl.count):
            body = functools.partial(
                M._layer_forward, tree_map(lambda a: a[li], seg_p),
                seg.kinds, positions=positions, cfg=cfg, mode="train",
                window_override=None, moe_dispatch=moe_dispatch)
            if remat:
                x, la, lz = checkpoint(
                    lambda h, f=body: M._drop_caches(f(h)), x,
                    use_reentrant=False)
            else:
                x, _, la, lz = body(x)
            aux, z = aux + la, z + lz
    return x, {"moe_aux_loss": aux, "moe_z_loss": z}


def _stage_head(params, x, targets, mask, cfg, inv_total):
    """Last-stage readout: final norm + unembed + NLL-sum * (1/N_total)."""
    x = constrain(x, ("pod", "data"), "model", None)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    unembed = params["embed"] if cfg.tie_embeddings else params["unembed"]
    logits = x @ unembed.T
    logits = constrain(logits, ("pod", "data"), None, "model")
    nll_sum, _ = steps_mod.cross_entropy_parts(logits, targets, mask,
                                               cfg.vocab_size)
    return nll_sum * inv_total


def _sq_norm(tree) -> torch.Tensor:
    """The f32 sum of squares of ``tree``'s leaves, in the reference's
    flatten order (summed as its jitted ``_sqnorm`` sums them)."""
    total = 0
    for _, g in tree_flatten_with_path(tree):
        total = total + torch.sum(torch.square(g.float()))
    return full_tensor(total)


def _float(t) -> float:
    return float(full_tensor(t)) if isinstance(t, torch.Tensor) else float(t)


class PipelineTrainer:
    """A 1F1B runner bound to one (cfg, pipeline config, world).

    ``pipeline``: a :class:`~repro_torch.configs.base.PipelineConfig`
    (default: 2 stages, 4 micro-batches); ``plan``: the
    :class:`~repro_torch.core.hypershard.ShardingPlan` of the stage meshes
    (default fsdp_tp; ``params_on_host`` / ``opt_state_on_host`` fold into
    ``offload_cfg``).  The params are drawn from ``seed`` on ``device`` by
    :func:`~repro_torch.train.steps.init_state`, as the non-pipelined
    trainer's; ``device``: the card unless the caller names another."""

    def __init__(self, cfg, pipeline: Optional[PipelineConfig] = None, *,
                 plan=None, offload_cfg=None, adamw=None, seed: int = 0,
                 moe_dispatch: str = "gshard", obs=None, device=None):
        import torch.distributed as dist

        from repro_torch.obs import Observability
        self.cfg = cfg
        self.obs = obs if obs is not None else Observability()
        self.pcfg = (pipeline or PipelineConfig()).validate()
        plan, self.ocfg = resolve_train_plan(None, plan, offload_cfg)
        self.plan = plan or hs.ShardingPlan()
        self.adamw_cfg = adamw or opt_mod.AdamWConfig()
        self.moe_dispatch = moe_dispatch
        self.tied = bool(cfg.tie_embeddings)
        if cfg.frontend_dim:
            raise _err(
                f"{cfg.name}: the pipeline trainer is text-only for now "
                "(multimodal prefix_embeds need a frontend stage — ROADMAP "
                "follow-up); drop the pipeline leg or the frontend")
        self.device = resolve_device(device)

        S, Mi = self.pcfg.stages, self.pcfg.micro_batches
        self.n_stages, self.n_micro = S, Mi
        self.asns = partition_stages(cfg, S, self.pcfg.stage_layers)
        self.sched: PipelineSchedule = schedule_1f1b(S, Mi)
        self.seq_ops = sequential_dispatch(S, Mi)

        world = dist.get_world_size() if dist.is_initialized() else 1
        self.ranks = list(range(world))
        self.colocated = world < S
        if self.colocated:
            # every stage shares all ranks (the fabric's colocated
            # precedent): one process runs every stage
            base = mpmd.groups_from_mapping({"stage": world})["stage"]
            self.groups = [dataclasses.replace(base, name=f"stage{s}")
                           for s in range(S)]
        else:
            per = world // S
            shape = tuple(self.pcfg.stage_mesh) or (1, per)
            if math.prod(shape) != per:
                raise _err(
                    f"pipeline.stage_mesh={shape} needs "
                    f"{math.prod(shape)} devices per stage but the "
                    f"carve gives {per} ({world} devices / {S} "
                    "stages); fix stage_mesh or the topology")
            gmap = mpmd.groups_from_mapping(
                {f"stage{s}": per for s in range(S)},
                shapes={f"stage{s}": shape for s in range(S)})
            self.groups = [gmap[f"stage{s}"] for s in range(S)]
        self.mine = [g.has() for g in self.groups]
        # the hand-offs between processes (made by every rank at once)
        self.wire = (mpmd.Handoff() if not self.colocated and world > 1
                     else None)

        params = steps_mod.init_state(cfg, seed=seed, device=self.device)[0]
        self.params: list = [None] * S
        self.opt: list = [None] * S
        for s, asn in enumerate(self.asns):
            if not self.mine[s]:
                continue
            sub = tree_map(lambda t: t.to(self.device),
                           stage_param_tree(params, cfg, asn))
            mesh = self.groups[s].mesh
            if mesh is not None:
                sub = hs.shard_tree(sub, hs.make_param_shardings(
                    mesh, sub, self.plan))
            self.params[s] = sub
            self.opt[s] = opt_mod.init_adamw(self._own(sub, s))
        del params

        if self._offloads:
            for s in self._stages():
                self.params[s], self.opt[s] = steps_mod.offload_state(
                    self.params[s], self.opt[s], self.ocfg)

        self.obs.record_compile(
            "pipeline_step", (S, Mi, cfg.name, moe_dispatch))

    # ------------------------------------------------------------------
    @property
    def _offloads(self) -> bool:
        return self.ocfg is not None and (self.ocfg.params_on_host
                                          or self.ocfg.opt_state_on_host)

    def _stages(self):
        """The stages this rank runs."""
        return [s for s in range(self.n_stages) if self.mine[s]]

    def _own(self, tree: Dict, s: int) -> Dict:
        """A stage's OWNED subtree: the tied readout copy on the last
        stage belongs to stage 0's optimizer, not the last stage's."""
        if self.tied and self.n_stages > 1 and s == self.n_stages - 1:
            return {k: v for k, v in tree.items() if k != "embed"}
        return tree

    def _local(self, a: int, b: int) -> bool:
        """Whether stages ``a`` and ``b`` hand over inside this process
        (both run here: colocated), so that no bytes go over the wire."""
        return self.mine[a] and self.mine[b]

    def _rows(self, s: int, ndim: int):
        """The placements of a tensor whose rows (dim 0) go over stage
        ``s``'s dp axes (the reference's ``("data", None, ...)``), or None
        on a stage without a mesh."""
        mesh = self.groups[s].mesh
        return None if mesh is None else hs.NamedSharding(
            mesh, (dp_entry(mesh),) + (None,) * (ndim - 1)).placements

    def _place(self, t, s: int):
        """A micro-batch slice on stage ``s``'s ranks, its rows over the
        stage mesh's dp axes; as is on a stage without a mesh."""
        mesh = self.groups[s].mesh
        return t if mesh is None else hs.distribute(t, mesh,
                                                    self._rows(s, t.dim()))

    # ------------------------------------------------------------------
    def step(self, batch: Dict, *, dispatch: str = "1f1b") -> Dict:
        """One optimizer step over ``batch`` under the 1F1B schedule.

        ``dispatch="sequential"`` runs the same work in the no-overlap
        per-micro order (each op waits for the card before the next) — the
        baseline; results are identical, only the overlap differs."""
        cfg, S, Mi = self.cfg, self.n_stages, self.n_micro
        B = int(batch["inputs"].shape[0])
        if B % Mi:
            raise _err(
                f"global_batch={B} does not divide into "
                f"pipeline.micro_batches={Mi}; pick a micro count that "
                "divides the batch")
        b = B // Mi
        mesh0 = self.groups[0].mesh
        dsize = mesh_axis_size(mesh0, "data") if mesh0 is not None else 1
        if b % dsize:
            raise _err(
                f"micro-batch size {b} (global_batch={B} / "
                f"micro_batches={Mi}) does not divide the stage data axis "
                f"({dsize}); fix micro_batches or stage_mesh")
        if self._offloads:
            for s in self._stages():
                self.params[s], self.opt[s] = steps_mod.fetch_state(
                    self.params[s], self.opt[s], self.ocfg, self.device)

        total_mask = float(batch["mask"].sum())
        inv_total = torch.tensor(1.0 / max(total_mask, 1.0),
                                 dtype=torch.float32, device=self.device)
        micro = [slice(m * b, (m + 1) * b) for m in range(Mi)]
        act_shape = (b, int(batch["inputs"].shape[1]), cfg.d_model)
        act_dtype = dtype_of(cfg)
        ops = self.sched.ops if dispatch == "1f1b" else self.seq_ops
        wire = self.wire
        leaves = {s: tree_leaves(self.params[s]) for s in self._stages()}
        x_in: Dict = {}           # (stage, micro) -> input of the stage
        dy_in: Dict = {}          # (stage, micro) -> cotangent of its output
        graph: Dict = {}    # (stage, micro) -> (y, aux, input, metrics)
        gx_last: Dict = {}        # micro -> the last stage's input gradient
        acc = [None] * S
        events = {s: [] for s in range(S)}   # each stage's values, op order
        handoffs = 0
        dispatch_log = []
        t0 = time.perf_counter()
        first_t = [None] * S
        last_t = [t0] * S

        def accumulate(s, grads):
            g = [torch.zeros_like(p) if d is None else steps_mod._placed_as(
                d, p) for p, d in zip(leaves[s], grads)]
            it = iter(g)
            tree = tree_map(lambda _: next(it), self.params[s])
            acc[s] = (tree_map(lambda a, d: a + d.float(), acc[s], tree)
                      if acc[s] is not None
                      else tree_map(lambda d: d.float(), tree))

        for p in (p for s in self._stages() for p in leaves[s]):
            p.requires_grad_(True)
        try:
            for op in ops:
                s, m = op.stage, op.micro
                dispatch_log.append(op.label())
                if op.kind == "F" and s < S - 1 or op.kind == "B" and s > 0:
                    handoffs += 1
                if not self.mine[s]:
                    continue
                now = time.perf_counter()
                if first_t[s] is None:
                    first_t[s] = now
                asn, grp = self.asns[s], self.groups[s]
                with use_mesh(grp.mesh):
                    if op.kind == "F":
                        if s == 0:
                            inp = self._place(batch["inputs"][micro[m]], 0)
                        elif self._local(s - 1, s):
                            inp = x_in.pop((s, m))
                        else:
                            inp = wire.recv(
                                act_shape, act_dtype, self.groups[s - 1],
                                grp, self.device, self._rows(s, 3)
                            ).requires_grad_()
                        y, mm = _stage_apply(self.params[s], inp, cfg, asn,
                                             moe_dispatch=self.moe_dispatch)
                        if s == S - 1:
                            ce_m = _stage_head(
                                self.params[s], y,
                                self._place(batch["targets"][micro[m]], s),
                                self._place(batch["mask"][micro[m]], s),
                                cfg, inv_total)
                            aux = _aux_of(mm, cfg)
                            loss_m = ce_m + aux * (1.0 / Mi)
                            wrt = leaves[s] + ([] if s == 0 else [inp])
                            grads = torch.autograd.grad(loss_m, wrt,
                                                        allow_unused=True)
                            if s > 0:
                                gx_last[m] = grads[-1]
                            accumulate(s, grads[:len(leaves[s])])
                            events[s].append(
                                (loss_m.detach(), ce_m.detach(), 0.0,
                                 {k: v.detach() for k, v in mm.items()}))
                        else:
                            graph[(s, m)] = (y, _aux_of(mm, cfg), inp, mm)
                            if self._local(s, s + 1):
                                x_in[(s + 1, m)] = \
                                    y.detach().requires_grad_()
                            else:
                                wire.send(y.detach(), grp,
                                          self.groups[s + 1])
                    else:                                   # "B"
                        if s == S - 1:
                            gx = gx_last.pop(m, None)
                        else:
                            dy = (dy_in.pop((s, m)) if self._local(s, s + 1)
                                  else wire.recv(
                                      act_shape, act_dtype,
                                      self.groups[s + 1], grp, self.device,
                                      self._rows(s, 3)))
                            y, aux, inp, mm = graph.pop((s, m))
                            if is_dtensor(y) and tuple(dy.placements) != \
                                    tuple(y.placements):
                                dy = dy.redistribute(y.device_mesh,
                                                     y.placements)
                            outs, couts = [y], [dy]
                            if aux.requires_grad:
                                outs.append(aux)
                                couts.append(torch.full_like(aux, 1.0 / Mi))
                            wrt = leaves[s] + ([] if s == 0 else [inp])
                            grads = torch.autograd.grad(outs, wrt, couts,
                                                        allow_unused=True)
                            gx = grads[-1] if s > 0 else None
                            accumulate(s, grads[:len(leaves[s])])
                            events[s].append(
                                (None, None, aux.detach(),
                                 {k: v.detach() for k, v in mm.items()}))
                        if s > 0:
                            if self._local(s - 1, s):
                                dy_in[(s - 1, m)] = gx
                            else:
                                wire.send(gx, grp, self.groups[s - 1])
                if dispatch == "sequential" and self.device.type == "cuda":
                    # the no-overlap baseline: drain before the next op
                    torch.cuda.synchronize(self.device)
                last_t[s] = time.perf_counter()
        finally:
            for p in (p for s in self._stages() for p in leaves[s]):
                p.requires_grad_(False)
        t_end = time.perf_counter()

        # tied embeddings: merge the readout copy's grad into stage 0's
        tied_sync = self.tied and S > 1
        if tied_sync:
            if self._local(0, S - 1):
                acc[0]["embed"] = acc[0]["embed"] + acc[S - 1].pop("embed")
            elif self.mine[S - 1]:
                wire.send(acc[S - 1].pop("embed"), self.groups[S - 1],
                          self.groups[0])
            elif self.mine[0]:
                e = acc[0]["embed"]
                acc[0]["embed"] = e + wire.recv(
                    tuple(e.shape), torch.float32, self.groups[S - 1],
                    self.groups[0], self.device,
                    e.placements if self.groups[0].mesh is not None
                    else None)

        # the global grad norm: every stage's sum of squares and values, on
        # every rank, summed in stage order
        recs = [None] * S
        for s in range(S):
            rec = None
            if self.mine[s]:
                with use_mesh(self.groups[s].mesh):
                    rec = (_float(_sq_norm(acc[s])),
                           [tuple(_float(v) if v is not None else None
                                  for v in e[:3])
                            + ({k: _float(v) for k, v in e[3].items()},)
                            for e in events[s]])
            recs[s] = (rec if self.colocated or len(self.ranks) == 1
                       else mpmd.share(rec, self.groups[s].leader,
                                       self.ranks))
        gnorm = math.sqrt(sum(r[0] for r in recs))
        lr = None
        for s in self._stages():
            with use_mesh(self.groups[s].mesh):
                own_p = self._own(self.params[s], s)
                new_p, new_o, om = opt_mod.adamw_update_with_norm(
                    acc[s], self.opt[s], own_p, self.adamw_cfg,
                    torch.tensor(gnorm, dtype=torch.float32,
                                 device=self.device))
            lr = _float(om["lr"]) if lr is None else lr
            if self.tied and S > 1 and s == S - 1:
                new_p = dict(new_p)
                new_p["embed"] = self.params[s]["embed"]
            self.params[s] = new_p
            self.opt[s] = new_o
        del acc
        if tied_sync:
            if self._local(0, S - 1):
                self.params[S - 1]["embed"] = self.params[0]["embed"].clone()
            elif self.mine[0]:
                wire.send(self.params[0]["embed"], self.groups[0],
                          self.groups[S - 1])
            elif self.mine[S - 1]:
                e = self.params[S - 1]["embed"]
                self.params[S - 1]["embed"] = wire.recv(
                    tuple(e.shape), e.dtype, self.groups[0],
                    self.groups[S - 1], self.device,
                    e.placements if self.groups[S - 1].mesh is not None
                    else None)
            self.obs.metrics.counter(
                "train.pipeline.tied_embed_syncs").inc()
        if wire is not None:
            wire.wait()
        if not (self.colocated or len(self.ranks) == 1):
            lr = mpmd.share(lr, self.groups[-1].leader, self.ranks)

        if self._offloads:
            for s in self._stages():
                self.params[s], self.opt[s] = steps_mod.offload_state(
                    self.params[s], self.opt[s], self.ocfg)

        # obs: exact schedule counters + per-stage fill/drain spans
        sched = self.sched if dispatch == "1f1b" else None
        if sched is not None:
            self.obs.metrics.counter(
                "train.pipeline.bubble_steps").inc(sched.bubble_steps)
        self.obs.metrics.counter("train.pipeline.handoffs").inc(handoffs)
        self.obs.metrics.counter("train.pipeline.microbatches").inc(Mi)
        for s in self._stages():
            fill_ticks, _, drain_ticks = (
                self.sched.stage_phases(s) if sched is not None
                else (0, 0, 0))
            if first_t[s] is not None and first_t[s] > t0:
                self.obs.trace.complete(
                    "pipeline.fill", int(t0 * 1e9), int(first_t[s] * 1e9),
                    track=f"pipeline:stage{s}", stage=s, ticks=fill_ticks)
            if last_t[s] < t_end:
                self.obs.trace.complete(
                    "pipeline.drain", int(last_t[s] * 1e9),
                    int(t_end * 1e9), track=f"pipeline:stage{s}", stage=s,
                    ticks=drain_ticks)

        # the reference's sums, its values in its dispatch order
        pos = [0] * S
        loss_parts, aux_extra, mm_list = [], [], []
        for op in ops:
            s = op.stage
            if (op.kind == "F") != (s == S - 1):
                continue
            loss_m, ce_m, aux_m, mm = recs[s][1][pos[s]]
            pos[s] += 1
            if s == S - 1:
                loss_parts.append((loss_m, ce_m))
            else:
                aux_extra.append(aux_m)
            mm_list.append(mm)
        ce = sum(c for _, c in loss_parts)
        aux = (sum(l for l, _ in loss_parts) - ce
               + sum(a / Mi for a in aux_extra))
        mm_acc = {k: sum(mm[k] for mm in mm_list) / Mi
                  for k in ("moe_aux_loss", "moe_z_loss")}
        return {"loss": ce + aux, "ce": ce, "aux": aux, **mm_acc,
                "grad_norm": gnorm, "lr": lr,
                "handoffs": handoffs, "dispatch": tuple(dispatch_log)}

    # ------------------------------------------------------------------
    def merged_params(self) -> Dict:
        """The full param tree on every rank (on this trainer's device),
        the segment slices concatenated back in stage order; the tied
        readout copy is dropped.  One group a stage: each stage gathers
        its tree in full and its first rank sends it to every other rank,
        in stage order."""
        out: Dict = {}
        seg_parts: Dict = {}
        for s, asn in enumerate(self.asns):
            tree = None
            if self.mine[s]:
                tree = self.params[s]
                if self._offloads:
                    tree = steps_mod.fetch_state(
                        tree, self.opt[s], dataclasses.replace(
                            self.ocfg, opt_state_on_host=False),
                        self.device)[0]
                tree = tree_map(full_tensor, tree)
            if not self.colocated and len(self.ranks) > 1:
                grp = self.groups[s]
                if mpmd.my_rank() == grp.leader:
                    for r in self.ranks:
                        if not grp.has(r):
                            mpmd.send_tree(tree, r)
                elif not self.mine[s]:
                    tree = mpmd.recv_tree(grp.leader, self.device)
            for k, v in tree.items():
                if k.startswith("seg"):
                    seg_parts.setdefault(k, []).append((asn.layers[0], v))
                elif not (self.tied and self.n_stages > 1
                          and s == self.n_stages - 1 and k == "embed"):
                    out[k] = v
        for k, parts in seg_parts.items():
            parts.sort(key=lambda t: t[0])
            out[k] = tree_map(lambda *xs: torch.cat(xs, dim=0),
                              *[p for _, p in parts])
        if self.device.type == "cuda" and self._offloads:
            torch.cuda.current_stream(self.device).synchronize()
        return out


def train_pipeline(cfg, shape, *, pipeline: Optional[PipelineConfig] = None,
                   plan=None, offload_cfg=None, adamw=None,
                   train_cfg: Optional[TrainConfig] = None,
                   moe_dispatch: str = "gshard",
                   hook: Optional[Callable] = None, obs=None, device=None):
    """End-to-end pipelined training; returns (merged params, history).

    Mirrors :func:`repro_torch.train.trainer.train`'s loop contract
    (history cadence, metric keys, hook, the ``train.step`` span, the
    ``train.steps`` counter, the ``train.step_s`` histogram, the
    ``train.loss`` / ``train.grad_norm`` gauges).  Every rank of a
    multi-process run calls this alike and gets the same history.
    Checkpointing is not wired for the pipeline path yet, as in the
    reference."""
    from repro_torch.data.pipeline import DataConfig, make_loader
    from repro_torch.obs import Observability
    train_cfg = train_cfg or TrainConfig()
    obs = obs if obs is not None else Observability()
    adamw = adamw or opt_mod.AdamWConfig(total_steps=train_cfg.num_steps)
    trainer = PipelineTrainer(cfg, pipeline, plan=plan,
                              offload_cfg=offload_cfg, adamw=adamw,
                              seed=train_cfg.seed, moe_dispatch=moe_dispatch,
                              obs=obs, device=device)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=shape.seq_len,
                      global_batch=shape.global_batch, seed=train_cfg.seed)
    loader = make_loader(dcfg, trainer.device)
    history = []
    t0 = time.perf_counter()
    for i, batch in zip(range(train_cfg.num_steps), loader):
        t_step = time.perf_counter()
        with obs.trace.span("train.step", track="train", step=i + 1):
            metrics = trainer.step(batch)
        obs.metrics.counter("train.steps").inc()
        obs.metrics.histogram("train.step_s").observe(
            time.perf_counter() - t_step)
        if (i + 1) % train_cfg.log_every == 0 or i == 0:
            m = {k: float(v) for k, v in metrics.items()
                 if not isinstance(v, tuple)}
            m["step"] = i + 1
            m["wall_s"] = time.perf_counter() - t0
            history.append(m)
            for k in ("loss", "grad_norm"):
                obs.metrics.gauge(f"train.{k}").set(m[k])
            if hook:
                hook(m)
    return trainer.merged_params(), history


__all__ = ["PipelineTrainer", "train_pipeline"]
