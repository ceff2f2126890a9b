"""HyperFabric router: the multi-tenant front door over N HyperServe replicas.

The port of ``repro.fabric.router``.  One :class:`Router` fronts N
:class:`~repro_torch.serve.api.HyperServe` engines, each on its own group
of ranks carved from a single Supernode (see
:mod:`repro_torch.fabric.carve`), and makes every cross-replica decision
at a single point:

  - **admission** — bounded global queue (``max_pending``) and per-tenant
    in-flight quotas; refusals raise the same typed
    :class:`~repro_torch.serve.api.RequestRejected` the bare engine uses,
    with ``tenant`` and a ``retry_after_s`` backpressure hint filled in;
  - **SLO-class scheduling** — tenants declare ``interactive`` or
    ``batch``; dispatch is stride-based weighted-fair (virtual time
    advances by 1/weight per dispatch, interactive defaults to 4x the
    bandwidth of batch), deterministic given the submission order;
  - **prefix-affinity routing** — a request routes to the replica whose
    CoW prefix cache holds its longest matching prefix (read off the
    engine's cheap :meth:`~repro_torch.serve.runtime.ServeEngine.snapshot`),
    falling back to least-loaded;
  - **elastic scale** — idle replicas drain (finish in-flight work, take
    no new) and re-activate when the pending queue deepens, driven by
    queue depth and the replica's ``serve.block_occupancy`` gauge.

Determinism contract: wall-clock feeds *metrics only* (TTFT histograms,
deadline-miss counters).  Every routing / fairness / elastic decision
depends only on the submission history, so dispatch logs, affinity-hit
counters and step-indexed TTFT are exactly reproducible.

Replicas in processes: the reference is one controller over every
device; the port runs one process a rank.  With one rank (one card, or
the CPU) every replica lives in this process (the colocated carve).  With
more, each replica's engine is built only on the ranks of its group (a
``(1, n)`` mesh over them, or none for a group of one rank), and every
rank of the world makes the same :class:`Router` calls in the same order:
a value a replica's engine computes (its snapshot and occupancy, the
events of its step, a submit's request id or rejection, a result, its
stats) is computed on that group's ranks and sent by the group's first
rank to every other rank (:func:`repro_torch.core.mpmd.share`), so that
every rank makes the same decisions and returns the same values.

Engine queues are kept shallow on purpose (``dispatch_depth``): work held
at the front door can still be reordered between tenants; work inside an
engine's FCFS queue cannot.
"""
from __future__ import annotations

import time
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.configs.base import FabricConfig, TenantSpec
from repro_torch.core import mpmd
from repro_torch.fabric.carve import carve_counts
from repro_torch.obs import Observability
from repro_torch.serve.api import HyperServe, RequestRejected
from repro_torch.serve.scheduler import blocks_for

# SLO class policy: dispatch weight (stride fairness) and a TTFT deadline
# used for *metrics only* (fabric.deadline_miss.<class>) — deadlines never
# influence routing, so decisions stay deterministic.
SLO_POLICY = {
    "interactive": {"weight": 4, "ttft_deadline_s": 0.5},
    "batch": {"weight": 1, "ttft_deadline_s": None},
}
# dispatch tie-break when virtual times are equal: latency-sensitive first
_CLASS_RANK = {"interactive": 0, "batch": 1}

ACTIVE, DRAINING = "active", "draining"


@dataclass
class FabricRequest:
    """Front-door lifecycle record for one request."""
    fid: int
    tenant: str
    slo: str
    prompt: List[int]
    max_new_tokens: int
    temperature: float = 0.0
    eos_id: Optional[int] = None
    seed: Optional[int] = None
    t_enqueue: float = 0.0            # wall clock — metrics only
    enqueue_step: int = 0             # router step index — deterministic
    state: str = "pending"            # pending|dispatched|finished
    replica: Optional[int] = None
    rid: Optional[int] = None         # engine-local request id
    affinity_hit: bool = False
    first_token_step: Optional[int] = None
    t_first_token: Optional[float] = None


class Router:
    """Multi-tenant front door over N replica engines (see module doc).

    ``replicas``: one entry a replica, its :class:`HyperServe` (None on a
    rank outside the replica's group); ``groups``: the replicas'
    :class:`~repro_torch.core.mpmd.ProcessGroup` in the same order, or None
    when every replica lives in this process."""

    def __init__(self, replicas: Sequence[Optional[HyperServe]],
                 fcfg: FabricConfig, *, obs: Optional[Observability] = None,
                 groups: Optional[Sequence[mpmd.ProcessGroup]] = None):
        if not replicas:
            raise ValueError("Router needs >= 1 replica engine")
        fcfg.validate()
        self.replicas = list(replicas)
        self.groups = None if groups is None else list(groups)
        self.fcfg = fcfg
        # front-door hub: aggregated view over the replicas' private hubs
        self.obs = obs if obs is not None else Observability()
        self.tenants: Dict[str, TenantSpec] = {t.name: t for t in fcfg.tenants}
        self._pending: Dict[str, deque] = {t: deque() for t in self.tenants}
        self._vtime: Dict[str, float] = {t: 0.0 for t in self.tenants}
        self._inflight: Dict[str, int] = {t: 0 for t in self.tenants}
        self._requests: "OrderedDict[int, FabricRequest]" = OrderedDict()
        self._rid_map: Dict[Tuple[int, int], int] = {}   # (replica, rid)->fid
        self._replica_state = [ACTIVE] * len(self.replicas)
        self._next_fid = 0
        self._step = 0
        # deterministic audit trail: (fid, tenant, replica) per dispatch
        self.dispatch_log: List[Tuple[int, str, int]] = []

        # the replicas' scheduler limits (one ServeConfig: replica 0's)
        def limits(rep):
            s = rep.engine.scheduler
            return {"block_size": s.block_size, "needs_pages": s.needs_pages,
                    "max_blocks_per_req": s.max_blocks_per_req,
                    "watermark_blocks": s.cfg.watermark_blocks,
                    "num_total": s.blocks.num_total}
        self._limits = self._on(0, limits)
        self._block_size = self._limits["block_size"]

    # ------------------------------------------------------------------
    # one replica's value on every rank
    # ------------------------------------------------------------------
    def _on(self, i: int, fn: Callable):
        """``fn(replica i's engine)``: in this process when the replicas
        are colocated, else computed on the ranks of replica ``i``'s group
        and shared from its first rank with every rank of the world (a
        rejection or an error there is raised on every rank)."""
        if self.groups is None:
            return fn(self.replicas[i])
        group = self.groups[i]
        out = None
        if group.has():
            try:
                out = ("ok", fn(self.replicas[i]))
            except RequestRejected as e:
                out = ("rejected", str(e), e.tenant, e.reason,
                       e.retry_after_s)
            except Exception as e:  # noqa: BLE001 - re-raised on every rank
                out = ("raise", f"replica {i} raised {type(e).__name__}: "
                                f"{e}")
        out = mpmd.share(out, group.leader, mpmd._world_ranks())
        if out[0] == "rejected":
            raise RequestRejected(out[1], tenant=out[2], reason=out[3],
                                  retry_after_s=out[4])
        if out[0] == "raise":
            raise RuntimeError(out[1])
        return out[1]

    def _snapshot(self, i: int) -> Dict:
        return self._on(i, lambda rep: rep.snapshot())

    def _has_work(self, i: int) -> bool:
        return self._on(i, lambda rep: rep.engine.scheduler.has_work())

    # ------------------------------------------------------------------
    # admission (typed rejections, backpressure)
    # ------------------------------------------------------------------
    def _weight(self, tenant: TenantSpec) -> int:
        return tenant.weight or SLO_POLICY[tenant.slo]["weight"]

    def _pending_total(self) -> int:
        return sum(len(q) for q in self._pending.values())

    def _unservable(self, prompt: Sequence[int], max_new: int) -> bool:
        """Mirror of the engine scheduler's can-never-fit check, applied
        at the front door so hopeless requests never occupy the queue."""
        if not prompt or max_new < 1:
            return True
        lim = self._limits
        if not lim["needs_pages"]:
            return False
        need = blocks_for(len(prompt) + max_new, lim["block_size"])
        return (need > lim["max_blocks_per_req"]
                or need + lim["watermark_blocks"] > lim["num_total"])

    def submit(self, prompt: Sequence[int], max_new_tokens: int, *,
               tenant: str = "default", temperature: float = 0.0,
               eos_id: Optional[int] = None,
               seed: Optional[int] = None) -> int:
        """Admit a request into the front door; returns a fabric id.

        Raises :class:`RequestRejected` with ``reason`` ``"unservable"``
        (never retryable), ``"over_quota"`` (tenant in-flight cap) or
        ``"queue_full"`` (bounded global queue) — the latter two carry
        ``retry_after_s``.
        """
        if tenant not in self.tenants:
            raise KeyError(f"unknown tenant {tenant!r}; fabric tenants: "
                           f"{sorted(self.tenants)}")
        spec = self.tenants[tenant]
        prompt = list(prompt)
        if self._unservable(prompt, max_new_tokens):
            self._reject(tenant, "unservable")
            raise RequestRejected(
                f"request rejected (unservable): prompt_len={len(prompt)} "
                f"max_new={max_new_tokens} can never fit the replica pool",
                tenant=tenant, reason="unservable")
        if spec.max_inflight and self._inflight[tenant] >= spec.max_inflight:
            self._reject(tenant, "over_quota")
            raise RequestRejected(
                f"tenant {tenant!r} over quota: {self._inflight[tenant]} "
                f"in flight >= max_inflight={spec.max_inflight}",
                tenant=tenant, reason="over_quota",
                retry_after_s=self.fcfg.retry_after_s)
        if self._pending_total() >= self.fcfg.max_pending:
            self._reject(tenant, "queue_full")
            raise RequestRejected(
                f"fabric queue full: {self._pending_total()} pending >= "
                f"max_pending={self.fcfg.max_pending}",
                tenant=tenant, reason="queue_full",
                retry_after_s=self.fcfg.retry_after_s)
        fid = self._next_fid
        self._next_fid += 1
        fr = FabricRequest(fid=fid, tenant=tenant, slo=spec.slo,
                           prompt=prompt, max_new_tokens=max_new_tokens,
                           temperature=temperature, eos_id=eos_id, seed=seed,
                           t_enqueue=time.monotonic(),
                           enqueue_step=self._step)
        self._requests[fid] = fr
        self._pending[tenant].append(fr)
        self._inflight[tenant] += 1
        self.obs.metrics.counter("fabric.submitted").inc()
        self.obs.trace.instant("fabric.submit", track="fabric", fid=fid,
                               tenant=tenant, slo=spec.slo)
        return fid

    def _reject(self, tenant: str, reason: str) -> None:
        self.obs.metrics.counter("fabric.rejected").inc()
        self.obs.metrics.counter(f"fabric.rejected.{reason}").inc()
        self.obs.trace.instant("fabric.reject", track="fabric",
                               tenant=tenant, reason=reason)

    # ------------------------------------------------------------------
    # dispatch (weighted-fair + prefix affinity)
    # ------------------------------------------------------------------
    def _pick_tenant(self) -> Optional[str]:
        """Stride scheduling: min virtual time among tenants with work,
        tie-broken interactive-first then by name (fully deterministic)."""
        best = None
        for name, q in self._pending.items():
            if not q:
                continue
            key = (self._vtime[name], _CLASS_RANK[self.tenants[name].slo],
                   name)
            if best is None or key < best[0]:
                best = (key, name)
        return None if best is None else best[1]

    def _can_take(self, snap: Dict) -> bool:
        room = self.fcfg.dispatch_depth + max(0, snap["free_slots"])
        return (snap["queue_depth"] < min(room, snap["max_queue"]))

    def _affinity_target(self, prompt: List[int],
                         snaps: Dict[int, Dict]) -> Optional[int]:
        """Replica holding the longest cached prefix of ``prompt`` that can
        also take work; None when no replica caches any prefix."""
        bs = self._block_size
        for nb in range(len(prompt) // bs, 0, -1):
            key = tuple(prompt[:nb * bs])
            holders = [i for i, s in snaps.items() if key in s["prefix_keys"]]
            if holders:
                takers = [i for i in holders if self._can_take(snaps[i])]
                return min(takers) if takers else None
        return None

    def _dispatch(self) -> None:
        snaps = {i: self._snapshot(i) for i in range(len(self.replicas))
                 if self._replica_state[i] is ACTIVE}
        while True:
            tenant = self._pick_tenant()
            if tenant is None:
                return
            takers = [i for i, s in snaps.items() if self._can_take(s)]
            if not takers:
                return                       # every active replica is full
            fr = self._pending[tenant][0]
            target = None
            if self.fcfg.affinity and len(fr.prompt) >= self._block_size:
                target = self._affinity_target(fr.prompt, snaps)
            if target is not None:
                fr.affinity_hit = True
                self.obs.metrics.counter("fabric.affinity_hits").inc()
            else:
                if self.fcfg.affinity:
                    self.obs.metrics.counter("fabric.affinity_misses").inc()
                # least-loaded fallback: fewest requests anywhere in the
                # replica (queued or seated), lowest index on ties
                target = min(takers, key=lambda i: (
                    snaps[i]["queue_depth"] + snaps[i]["prefilling"]
                    + snaps[i]["running"], i))
            try:
                rid = self._on(target, lambda rep: rep.submit(
                    fr.prompt, fr.max_new_tokens, temperature=fr.temperature,
                    eos_id=fr.eos_id, seed=fr.seed, arrival=fr.t_enqueue))
            except RequestRejected as exc:
                if exc.reason == "unservable":   # front-door check missed it
                    self._pending[tenant].popleft()
                    self._inflight[tenant] -= 1
                    fr.state = "finished"
                    raise RequestRejected(str(exc), tenant=tenant,
                                          reason="unservable") from exc
                return                           # engine full; hold at door
            self._pending[tenant].popleft()
            fr.state = "dispatched"
            fr.replica, fr.rid = target, rid
            self._rid_map[(target, rid)] = fr.fid
            self._vtime[tenant] += 1.0 / self._weight(self.tenants[tenant])
            self.dispatch_log.append((fr.fid, tenant, target))
            self.obs.metrics.counter("fabric.dispatched").inc()
            self.obs.trace.instant("fabric.dispatch", track="fabric",
                                   fid=fr.fid, tenant=tenant, replica=target,
                                   affinity=fr.affinity_hit)
            snaps[target] = self._snapshot(target)   # refresh capacity view

    # ------------------------------------------------------------------
    # elastic scale (queue-depth up, occupancy-gauge down)
    # ------------------------------------------------------------------
    def _occupancy(self, i: int) -> float:
        return self._on(i, lambda rep: float(
            rep.obs().metrics.gauge("serve.block_occupancy").value))

    def _elastic(self) -> None:
        if not self.fcfg.elastic:
            return
        pending = self._pending_total()
        n_active = self._replica_state.count(ACTIVE)
        if pending > self.fcfg.scale_up_pending and DRAINING in self._replica_state:
            i = self._replica_state.index(DRAINING)
            self._replica_state[i] = ACTIVE
            self.obs.metrics.counter("fabric.scale_up").inc()
            self.obs.trace.instant("fabric.scale_up", track="fabric",
                                   replica=i, pending=pending)
            return
        if pending == 0 and n_active > self.fcfg.min_replicas:
            # drain the highest-index idle active replica under the
            # occupancy threshold (one per step keeps the policy smooth)
            for i in range(len(self.replicas) - 1, -1, -1):
                if self._replica_state[i] is not ACTIVE:
                    continue
                snap = self._snapshot(i)
                if (not snap["has_work"]
                        and self._occupancy(i)
                        <= self.fcfg.scale_down_occupancy):
                    self._replica_state[i] = DRAINING
                    self.obs.metrics.counter("fabric.scale_down").inc()
                    self.obs.trace.instant("fabric.scale_down",
                                           track="fabric", replica=i)
                    return

    # ------------------------------------------------------------------
    # progress
    # ------------------------------------------------------------------
    def step(self) -> List[Tuple[int, int]]:
        """One fabric iteration: elastic policy, dispatch, then step every
        replica that has work.  Returns ``[(fid, token), ...]``."""
        self._step += 1
        self._elastic()              # reads queue depth BEFORE dispatch so
        self._dispatch()             # a burst re-activates replicas first
        events: List[Tuple[int, int]] = []
        for i in range(len(self.replicas)):
            if not self._has_work(i):
                continue             # draining replicas still finish work
            for rid, tok, done in self._on(i, _step_replica):
                fid = self._rid_map[(i, rid)]
                fr = self._requests[fid]
                if fr.first_token_step is None:
                    self._observe_first_token(fr)
                events.append((fid, tok))
                if done:
                    self._finish(fr)
        self._set_gauges()
        return events

    def _observe_first_token(self, fr: FabricRequest) -> None:
        fr.first_token_step = self._step
        fr.t_first_token = time.monotonic()
        ttft = fr.t_first_token - fr.t_enqueue
        self.obs.metrics.histogram(f"fabric.ttft_s.{fr.slo}").observe(ttft)
        deadline = SLO_POLICY[fr.slo]["ttft_deadline_s"]
        if deadline is not None and ttft > deadline:
            self.obs.metrics.counter(f"fabric.deadline_miss.{fr.slo}").inc()

    def _finish(self, fr: FabricRequest) -> None:
        if fr.state != "finished":
            fr.state = "finished"
            self._inflight[fr.tenant] -= 1
            self.obs.metrics.counter("fabric.finished").inc()

    def _set_gauges(self) -> None:
        m = self.obs.metrics
        m.gauge("fabric.pending").set(self._pending_total())
        m.gauge("fabric.active_replicas").set(
            self._replica_state.count(ACTIVE))

    def join(self, max_steps: int = 100_000) -> Dict[int, List[int]]:
        """Drain everything; returns {fid: tokens}."""
        steps = 0
        while (self._pending_total()
               or any(self._has_work(i) for i in range(len(self.replicas)))):
            self.step()
            steps += 1
            if steps > max_steps:
                raise RuntimeError(f"fabric join stalled after {steps} steps")
        return {fid: self.result(fid) for fid, fr in self._requests.items()
                if fr.rid is not None}

    # ------------------------------------------------------------------
    # results / introspection
    # ------------------------------------------------------------------
    def result(self, fid: int) -> List[int]:
        fr = self._requests[fid]
        if fr.rid is None:
            return []
        return self._on(fr.replica, lambda rep: rep.result(fr.rid))

    def state(self, fid: int) -> str:
        fr = self._requests[fid]
        if fr.rid is None:
            return fr.state
        return self._on(fr.replica, lambda rep: rep.state(fr.rid))

    def request_meta(self, fid: int) -> Dict:
        """Router-level lifecycle record merged with the engine's (when the
        request has been dispatched)."""
        fr = self._requests[fid]
        meta = {
            "fid": fr.fid, "tenant": fr.tenant, "slo": fr.slo,
            "replica": fr.replica, "affinity_hit": fr.affinity_hit,
            "enqueue_step": fr.enqueue_step,
            "first_token_step": fr.first_token_step,
            "ttft_steps": (None if fr.first_token_step is None
                           else fr.first_token_step - fr.enqueue_step),
            "ttft_s": (None if fr.t_first_token is None
                       else fr.t_first_token - fr.t_enqueue),
        }
        if fr.rid is not None:
            meta["engine"] = self._on(fr.replica,
                                      lambda rep: rep.request_meta(fr.rid))
        return meta

    def stats(self) -> Dict:
        c = self.obs.metrics.counter
        return {
            "submitted": int(c("fabric.submitted").value),
            "dispatched": int(c("fabric.dispatched").value),
            "finished": int(c("fabric.finished").value),
            "rejected": int(c("fabric.rejected").value),
            "affinity_hits": int(c("fabric.affinity_hits").value),
            "affinity_misses": int(c("fabric.affinity_misses").value),
            "scale_up": int(c("fabric.scale_up").value),
            "scale_down": int(c("fabric.scale_down").value),
            "pending": self._pending_total(),
            "pending_by_tenant": {t: len(q)
                                  for t, q in self._pending.items()},
            "active_replicas": self._replica_state.count(ACTIVE),
            "replica_states": tuple(self._replica_state),
            "replicas": [self._on(i, lambda rep: rep.stats())
                         for i in range(len(self.replicas))],
        }

    # ------------------------------------------------------------------
    # construction (Supernode.fabric lands here)
    # ------------------------------------------------------------------
    @classmethod
    def build(cls, session, cfg, params, hp, *, seed: int = 0) -> "Router":
        """Carve the session's ranks into replica groups and build one
        HyperServe per replica (private obs hubs; the router's hub is the
        session's, so the front door aggregates into the session
        timeline).  Colocated (one rank, or no mesh): every replica in this
        process on the session's device.  Else every rank builds every
        group (a collective) and its own replica's engine: on the group's
        ``(1, n)`` mesh, or with none for a group of one rank."""
        fcfg = hp.fabric_config()
        n_dev = session.num_devices if session.mesh is not None else 1
        counts = carve_counts(n_dev, fcfg)
        serve_cfg, splan = hp.serve_config(), hp.sharding_plan()

        def replica(mesh):
            return HyperServe(cfg, params, serve_cfg=serve_cfg, mesh=mesh,
                              plan=splan, seed=seed, device=session.device)
        if not any(c > 0 for c in counts):
            return cls([replica(None) for _ in counts], fcfg,
                       obs=session.obs())
        groups = mpmd.groups_from_mapping(
            {f"replica{i}": c for i, c in enumerate(counts)})
        groups = [groups[f"replica{i}"] for i in range(len(counts))]
        replicas = [replica(g.mesh) if g.has() else None for g in groups]
        return cls(replicas, fcfg, obs=session.obs(), groups=groups)


def _step_replica(rep: HyperServe) -> List[Tuple[int, int, bool]]:
    """One engine iteration of a replica: ``[(rid, token, done)]``."""
    reqs = rep.engine.scheduler.requests
    return [(rid, tok, reqs[rid].done) for rid, tok in rep.step_once()]
