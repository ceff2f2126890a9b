"""Continuous-batching scheduler (HyperServe control plane).

The port's copy of ``repro.serve.scheduler``: host-only, unchanged but
for its imports.

Pure host-side decision logic in the spirit of HyperMPMD's heterogeneous
role orchestration (paper §3.3): given the block pool's state, decide
each engine iteration

  1. **admission** — strict FCFS from the wait queue while a batch slot is
     free and the pool can hold the request's prompt plus a watermark
     margin (requests whose prompt + budget can never fit the block-table
     width are rejected outright, and the queue itself is bounded);
  2. **chunked prefill** — at most ``prefill_chunks_per_step`` prompt
     chunks are scheduled per iteration, so long prompts never starve the
     decode batch (chunked-prefill interleaving);
  3. **decode** — every RUNNING request advances one token.  Before the
     step each runner is guaranteed a page for its next position; when the
     pool is exhausted the *youngest* runner is preempted — its pages
     spill to the host archive (HyperOffload's cold tier) and it re-enters
     the queue at the front, resuming later via page restore, never by
     recomputation.

Sliding-window models (``free_window``, from the mixer registry's
windowed StateSpec): blocks that fall wholly below every future query's
window are freed back to the pool after each prefill chunk / decode
token, their table entries repointed at the null block — once decoding,
a request holds at most ``ceil(window/block) + 1`` live blocks.  Freed
entries are always a *prefix* of the table (the window only moves
forward), which is what lets spill/restore keep table indices aligned
(``Request.null_prefix``).

The scheduler owns no device arrays: page movement is delegated to
callbacks the runtime injects (``spill``/``restore`` move pages across
memory tiers, ``reclaim`` evicts prefix-cache blocks under pressure,
``prefix`` looks up copy-on-write shared prompt blocks, ``retain`` lets
finished prompts enter the prefix cache before their refs drop).  This
keeps the module unit-testable without touching the card.

Archive-key convention shared with the runtime: request ``rid`` spills
its pages under ``("req", rid)`` and — for models with per-slot dense
recurrent state — its slot rows under ``("slotstate", rid)``.
"""
from __future__ import annotations

import dataclasses
import enum
import itertools
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional

from repro_torch.obs import Observability
from repro_torch.serve.paged_kv import BlockManager, NoFreeBlocks, blocks_for


class RequestState(enum.Enum):
    QUEUED = "queued"
    PREFILLING = "prefilling"
    RUNNING = "running"
    PREEMPTED = "preempted"
    FINISHED = "finished"
    CANCELLED = "cancelled"
    REJECTED = "rejected"


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int
    temperature: float = 0.0
    eos_id: Optional[int] = None
    arrival: float = 0.0
    # sampling PRNG seed; resolved at submit (never None afterwards) so a
    # temperature>0 rollout is bit-reproducible across runs and across
    # preemption spill/restore (the key depends only on seed + position)
    seed: Optional[int] = None
    capture_logprobs: bool = False            # record sampled-token logprobs
    # exact lifecycle clocks (HyperTrace): ``arrival`` is caller-overridable
    # for simulation/victim ordering, ``t_enqueue`` is ALWAYS the wall
    # instant the request entered the queue — TTFT and queue-wait are
    # measured, never inferred
    t_enqueue: float = 0.0
    t_admit: Optional[float] = None           # first seated (queue-wait end)
    state: RequestState = RequestState.QUEUED
    prefill_done: int = 0                     # prompt tokens already paged in
    generated: List[int] = dataclasses.field(default_factory=list)
    logprobs: List[float] = dataclasses.field(default_factory=list)
    table: List[int] = dataclasses.field(default_factory=list)
    slot: int = -1
    # why admission refused this request (None unless state is REJECTED):
    # "unservable" = the prompt/budget can never fit the pool or is empty,
    # "queue_full" = the bounded wait queue is at capacity (retryable)
    reject_reason: Optional[str] = None
    shared_blocks: int = 0                    # CoW prefix-cache blocks reused
    spilled_blocks: int = 0                   # pages parked in the cold tier
    null_prefix: int = 0                      # leading window-freed table slots
    t_first_token: Optional[float] = None
    t_finish: Optional[float] = None

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    @property
    def total_len(self) -> int:
        return self.prompt_len + len(self.generated)

    @property
    def done(self) -> bool:
        return self.state in (RequestState.FINISHED, RequestState.CANCELLED,
                              RequestState.REJECTED)

    @property
    def archive_key(self):
        return ("req", self.rid)

    @property
    def slot_archive_key(self):
        return ("slotstate", self.rid)

    @property
    def live_blocks(self) -> int:
        return sum(1 for b in self.table if b)


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    max_slots: int = 4                 # decode batch width (static for jit)
    max_queue: int = 64                # admission control: beyond this, reject
    prefill_chunk: int = 32            # tokens per chunked-prefill step
    # per-iteration chunk budget: every chunk scheduled here rides ONE
    # batched jit call in the runtime (StepPlan.prefill is a chunk
    # *batch*, not a list of per-request dispatches), so a budget > 1 is
    # the default — it buys device-level batching, not extra launches
    prefill_chunks_per_step: int = 4
    watermark_blocks: int = 1          # admission headroom for decode growth
    # predictive restore (HyperMem): preempted requests within this many
    # positions of the queue head are surfaced in StepPlan.near_head so
    # the runtime can start pulling their archived pages / slot rows back
    # BEFORE they are seated.  Queue-position proximity, never wall-clock,
    # so the mem.restore_ahead.hit counter is exact.  0 disables.
    restore_lookahead: int = 2


@dataclasses.dataclass
class StepPlan:
    """One engine iteration, as decided by :meth:`ContinuousScheduler.schedule`."""
    prefill: List[Request] = dataclasses.field(default_factory=list)
    decode: List[Request] = dataclasses.field(default_factory=list)
    admitted: List[Request] = dataclasses.field(default_factory=list)
    resumed: List[Request] = dataclasses.field(default_factory=list)
    preempted: List[Request] = dataclasses.field(default_factory=list)
    # PREEMPTED requests close enough to the queue head that their archived
    # state should start moving back now (predictive restore)
    near_head: List[Request] = dataclasses.field(default_factory=list)


class ContinuousScheduler:
    def __init__(self, cfg: SchedulerConfig, blocks: BlockManager,
                 block_size: int, max_blocks_per_req: int, *,
                 spill: Callable[[Request], None] = lambda r: None,
                 restore: Callable[[Request], List[int]] = lambda r: list(r.table),
                 reclaim: Callable[[int], int] = lambda n: 0,
                 prefix: Callable[[Request], List[int]] = lambda r: [],
                 retain: Callable[[Request], None] = lambda r: None,
                 free_window: Optional[int] = None,
                 needs_pages: bool = True,
                 seed_fn: Callable[[int], int] = lambda rid: rid,
                 clock: Callable[[], float] = time.perf_counter,
                 obs: Optional[Observability] = None):
        self.cfg = cfg
        # HyperTrace hub: the runtime passes its own; a bare scheduler
        # (unit tests) gets a private one so counters stay scoped
        self.obs = obs if obs is not None else Observability()
        self.blocks = blocks
        self.block_size = block_size
        self.max_blocks_per_req = max_blocks_per_req
        # sliding-window block freeing: sound only when EVERY paged layer
        # of the model is windowed (the runtime derives this from the
        # mixer registry's ModelStateLayout and passes the widest window)
        self.free_window = free_window
        # pure-slot models (SSD/RG-LRU only) keep O(1) dense state and no
        # pages at all: admission is bounded by seats and the queue, never
        # by phantom block pressure, and context length is not capped by
        # the block-table width
        self.needs_pages = needs_pages
        self._spill = spill
        self._restore = restore
        self._reclaim = reclaim
        self._prefix = prefix
        self._retain = retain
        self._seed_fn = seed_fn
        self._clock = clock
        self.queue: Deque[Request] = deque()
        self.active: List[Request] = []    # PREFILLING + RUNNING, FCFS order
        self.requests: Dict[int, Request] = {}
        self._rid = itertools.count()
        self._free_slots = list(range(cfg.max_slots - 1, -1, -1))
        self.counters = {"preemptions": 0, "prefix_hits": 0, "rejected": 0}

    # -- intake ------------------------------------------------------------
    def submit(self, prompt: List[int], max_new_tokens: int, *,
               temperature: float = 0.0, eos_id: Optional[int] = None,
               seed: Optional[int] = None, capture_logprobs: bool = False,
               arrival: Optional[float] = None) -> Request:
        rid = next(self._rid)
        # mask into uint32 range: the batched sampler packs seeds into a
        # uint32 array, and a negative/oversized pinned seed must not be
        # able to crash the engine loop mid-decode (the masked value is
        # what gets recorded, so replays still work)
        now = self._clock()
        req = Request(rid=rid, prompt=list(prompt),
                      max_new_tokens=max_new_tokens, temperature=temperature,
                      eos_id=eos_id,
                      seed=(int(seed) & 0x7FFFFFFF) if seed is not None
                      else self._seed_fn(rid),
                      capture_logprobs=capture_logprobs,
                      t_enqueue=now,
                      arrival=now if arrival is None else arrival)
        self.requests[req.rid] = req
        need = blocks_for(req.prompt_len + max_new_tokens, self.block_size)
        cannot_fit = self.needs_pages and (
            need > self.max_blocks_per_req
            or need + self.cfg.watermark_blocks > self.blocks.num_total)
        if not req.prompt or max_new_tokens < 1 or cannot_fit:
            req.reject_reason = "unservable"      # can never fit, ever
        elif len(self.queue) >= self.cfg.max_queue:
            req.reject_reason = "queue_full"      # transient: retry later
        if req.reject_reason is not None:
            req.state = RequestState.REJECTED
            self.counters["rejected"] += 1
            self.obs.metrics.counter("serve.rejected").inc()
            self.obs.trace.instant("serve.reject", rid=rid,
                                   prompt_len=req.prompt_len,
                                   reason=req.reject_reason)
            return req
        self.queue.append(req)
        self.obs.metrics.counter("serve.submitted").inc()
        self.obs.trace.instant("serve.submit", rid=rid,
                               prompt_len=req.prompt_len, seed=req.seed)
        return req

    def cancel(self, rid: int) -> bool:
        req = self.requests.get(rid)
        if req is None or req.done:
            return False
        if req in self.queue:
            self.queue.remove(req)
        if req in self.active:
            self._release(req)
        elif req.table:
            # still queued but already holding blocks (prefix-cache fork
            # from an admission attempt that broke on pool pressure)
            self.blocks.free([b for b in req.table if b])
            req.table = []
        if req.state == RequestState.PREEMPTED:
            self.blocks.archive.discard(req.archive_key)
            self.blocks.archive.discard(req.slot_archive_key)
        req.state = RequestState.CANCELLED
        req.t_finish = self._clock()
        self.obs.metrics.counter("serve.cancelled").inc()
        self.obs.trace.instant("serve.cancel", rid=rid)
        return True

    # -- the per-iteration decision ----------------------------------------
    def schedule(self) -> StepPlan:
        plan = StepPlan()
        self._admit(plan)
        self._plan_prefill(plan)
        self._plan_decode(plan)
        # queue-head proximity AFTER this step's admissions/preemptions:
        # the runtime stages these requests' archived state this iteration
        # so a later _admit consumes an already-moving copy
        plan.near_head = [
            r for r in itertools.islice(self.queue,
                                        self.cfg.restore_lookahead)
            if r.state is RequestState.PREEMPTED]
        return plan

    def _ensure_free(self, n: int) -> bool:
        if not self.blocks.can_alloc(n):
            self._reclaim(n - self.blocks.num_free)
        return self.blocks.can_alloc(n)

    def _admit(self, plan: StepPlan) -> None:
        while self.queue and self._free_slots:
            req = self.queue[0]
            if req.state is RequestState.PREEMPTED:
                # resume from the cold tier: pages come back, not recompute.
                # The watermark headroom prevents resume/preempt thrash: a
                # resumed request must have room to actually decode.
                if not self._ensure_free(req.spilled_blocks
                                         + self.cfg.watermark_blocks):
                    break                       # strict FCFS: don't skip ahead
                # seat BEFORE restoring: the restore callback re-seats the
                # request's dense slot-state rows into req.slot, and a
                # same-cycle re-preemption must spill those seated rows —
                # not whatever the seat held before
                req.slot = self._free_slots.pop()
                try:
                    req.table = self._restore(req)
                except NoFreeBlocks:
                    self._free_slots.append(req.slot)
                    req.slot = -1
                    break
                req.spilled_blocks = 0
                self.queue.popleft()
                req.state = RequestState.RUNNING
                self.active.append(req)
                plan.resumed.append(req)
                self.obs.metrics.counter("serve.resumed").inc()
                self.obs.trace.instant("serve.resume", rid=req.rid)
                continue
            if not req.table and not req.shared_blocks:
                shared = self._prefix(req)      # CoW prefix-cache fork
                if shared:
                    req.table = list(shared)
                    req.shared_blocks = len(shared)
                    req.prefill_done = len(shared) * self.block_size
                    self.counters["prefix_hits"] += 1
                    self.obs.metrics.counter("serve.prefix_hits").inc()
                    self.obs.trace.instant("serve.prefix_hit", rid=req.rid,
                                           blocks=len(shared))
            need = (blocks_for(req.prompt_len, self.block_size)
                    - req.shared_blocks) if self.needs_pages else 0
            if not self._ensure_free(need + self.cfg.watermark_blocks):
                break                           # strict FCFS admission
            self.queue.popleft()
            req.table = req.table + self.blocks.alloc(need)
            req.slot = self._free_slots.pop()
            req.state = RequestState.PREFILLING
            self.active.append(req)
            plan.admitted.append(req)
            req.t_admit = self._clock()
            wait = req.t_admit - req.t_enqueue
            self.obs.metrics.histogram("serve.queue_wait_s").observe(
                max(wait, 0.0))
            self.obs.trace.instant("serve.admit", rid=req.rid,
                                   queue_wait_s=wait)

    def _plan_prefill(self, plan: StepPlan) -> None:
        budget = self.cfg.prefill_chunks_per_step
        for req in self.active:
            if budget == 0:
                break
            if req.state is RequestState.PREFILLING:
                plan.prefill.append(req)
                budget -= 1

    def _plan_decode(self, plan: StepPlan) -> None:
        runners = [r for r in self.active if r.state is RequestState.RUNNING]
        survivors: List[Request] = []
        for req in runners:
            if req.state is not RequestState.RUNNING:
                continue                        # preempted as a victim below
            # the step writes generated[-1]'s KV at position total_len - 1
            # (pure-slot models write no pages: need stays 0, no extension,
            # no pool pressure, no preemption)
            need = (blocks_for(req.total_len, self.block_size)
                    if self.needs_pages else 0)
            while req is not None and len(req.table) < need:
                if self._ensure_free(1):
                    req.table.extend(self.blocks.alloc(1))
                    continue
                victim = self._pick_victim(runners)
                if victim is None or victim is req:
                    self._preempt(req, plan)
                    req = None
                else:
                    self._preempt(victim, plan)
                    if victim in survivors:
                        survivors.remove(victim)
            if req is not None:
                survivors.append(req)
        plan.decode.extend(survivors)

    def _pick_victim(self, runners) -> Optional[Request]:
        """Preempt the youngest runner (latest arrival, FCFS-fair)."""
        candidates = [r for r in runners if r.state is RequestState.RUNNING]
        if not candidates:
            return None
        return max(candidates, key=lambda r: (r.arrival, r.rid))

    def _preempt(self, req: Request, plan: StepPlan) -> None:
        req.spilled_blocks = req.live_blocks
        # window-freed entries are always a table *prefix*; remember how
        # many so restore can rebuild the table with indices aligned
        req.null_prefix = len(req.table) - req.spilled_blocks
        self._spill(req)                        # pages -> host archive + free
        req.table = []
        self._release(req, free_blocks=False)   # spill already freed them
        req.state = RequestState.PREEMPTED
        self.queue.appendleft(req)              # front: oldest-first resume
        plan.preempted.append(req)
        self.counters["preemptions"] += 1
        self.obs.metrics.counter("serve.preemptions").inc()
        self.obs.trace.instant("serve.preempt", rid=req.rid,
                               spilled_blocks=req.spilled_blocks)

    def _release(self, req: Request, *, free_blocks: bool = True) -> None:
        if free_blocks and req.table:
            self.blocks.free([b for b in req.table if b])
            req.table = []
        if req.slot >= 0:
            self._free_slots.append(req.slot)
            req.slot = -1
        if req in self.active:
            self.active.remove(req)

    # -- sliding-window block freeing --------------------------------------
    def _window_free(self, req: Request, next_query_pos: int) -> None:
        """Free blocks wholly below every future query's window.

        ``next_query_pos`` is the lowest position any future query of this
        request can occupy; keys below ``next_query_pos + 1 - window`` are
        permanently masked, so their blocks (always a table prefix — the
        window only moves forward) return to the pool and the table
        entries repoint at the null block.
        """
        if self.free_window is None:
            return
        cutoff = next_query_pos + 1 - self.free_window
        if cutoff <= 0:
            return
        nb = min(cutoff // self.block_size, len(req.table))
        for j in range(nb):
            b = req.table[j]
            if b:
                self.blocks.free([b])
                req.table[j] = BlockManager.NULL

    # -- completion callbacks (invoked by the runtime) ---------------------
    def on_prefill_chunk(self, req: Request, n_tokens: int) -> None:
        req.prefill_done += n_tokens
        assert req.prefill_done <= req.prompt_len
        self._window_free(req, req.prefill_done)

    def _note_first_token(self, req: Request) -> None:
        req.t_first_token = self._clock()
        ttft = req.t_first_token - req.t_enqueue
        self.obs.metrics.histogram("serve.ttft_s").observe(max(ttft, 0.0))
        self.obs.trace.instant("serve.first_token", rid=req.rid,
                               ttft_s=ttft)

    def on_prompt_complete(self, req: Request, first_token: int) -> None:
        req.state = RequestState.RUNNING
        self._note_first_token(req)
        req.generated.append(first_token)
        self._maybe_finish(req)

    def on_decode_token(self, req: Request, token: int) -> None:
        req.generated.append(token)
        if req.t_first_token is None:
            self._note_first_token(req)
        # the next decode step writes + queries at position total_len - 1
        if req.state is RequestState.RUNNING:
            self._window_free(req, req.total_len - 1)
        self._maybe_finish(req)

    def _maybe_finish(self, req: Request) -> None:
        hit_eos = req.eos_id is not None and req.generated[-1] == req.eos_id
        if len(req.generated) >= req.max_new_tokens or hit_eos:
            self._retain(req)                   # prefix cache gets its fork
            self._release(req)
            req.state = RequestState.FINISHED
            req.t_finish = self._clock()
            self.obs.metrics.counter("serve.finished").inc()
            self.obs.metrics.histogram("serve.latency_s").observe(
                max(req.t_finish - req.t_enqueue, 0.0))
            self.obs.trace.instant("serve.finish", rid=req.rid,
                                   tokens=len(req.generated),
                                   reason="eos" if hit_eos else "length")

    # -- introspection -----------------------------------------------------
    def has_work(self) -> bool:
        return bool(self.queue or self.active)

    def stats(self) -> Dict[str, float]:
        return {
            "queued": len(self.queue),
            "prefilling": sum(1 for r in self.active
                              if r.state is RequestState.PREFILLING),
            "running": sum(1 for r in self.active
                           if r.state is RequestState.RUNNING),
            "finished": sum(1 for r in self.requests.values()
                            if r.state is RequestState.FINISHED),
            "preempted_now": sum(1 for r in self.queue
                                 if r.state is RequestState.PREEMPTED),
            "block_occupancy": self.blocks.occupancy(),
            "free_blocks": self.blocks.num_free,
            **self.counters,
        }
