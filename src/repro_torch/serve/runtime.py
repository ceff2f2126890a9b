"""HyperServe engine loop: requests in, tokens out (PyTorch port).

The port of ``repro.serve.runtime.ServeEngine``, on one device,
tensor-parallel on a ``DeviceMesh``, or disaggregated over the prefill and
decode role groups of :mod:`repro_torch.core.mpmd`.  It composes the paged
pool
(:mod:`repro_torch.serve.paged_kv`), the continuous-batching scheduler
(:mod:`repro_torch.serve.scheduler`) and the paged model steps
(:mod:`repro_torch.models.model`) into one iteration:

    plan = scheduler.schedule()          # admit / resume / preempt
    run plan.prefill as ONE batched call # <= budget, so decode never starves
    run one decode step for all slots    # every runner advances one token

The decode batch is a fixed set of ``max_slots`` seats; empty seats decode
a dummy token against the null block and their logits are ignored, and a
slot mixer's (SSD) per-seat state is written only for running seats
(``slot_mask``).  A fresh admission zeroes its seat's state; a preempted
request's seat rows are archived beside its pages and re-seated with
them.  Every
attention layer of a step runs the paged path that ``ServeConfig.kernels``
resolves to (``ops.resolve_paged_path``): the fused block-table-walking
kernels, or the composed lowering (gather, then the dense kernels); on the
card their CUDA kernels, on an explicit ``device="cpu"`` their plain
versions.

On a mesh (``mesh=``, ``plan=`` a ``ShardingPlan`` with ``fsdp=None``) the
params are DTensors placed by the plan's rules, the pool's leaves by
:func:`~repro_torch.serve.engine.make_pool_shardings`, and both steps run
under :func:`~repro_torch.core.meshctx.use_mesh`: the projections shard
over ``model`` as DTensor propagates them, and the fused paged kernels and
the two scans run on each rank's heads or channels under ``local_map``.
MLA's latent pool replicates and its fused decode runs on each rank's
heads; the MoE FFN takes the ragged dispatch expert-parallel over
``model`` (each rank its own experts' rows through the grouped matmul,
the routed and shared experts' outputs ``Partial`` sums).  The logits are
gathered in full before any pick, so every rank takes the same
decisions; the scheduler runs SPMD, every rank on the same requests.
Every family serves on a mesh, fused or composed: the composed lowering
gathers each rank's shard of the pages (``meshctx.local_index``) and runs
``decode_attention`` and flash on each rank's heads under ``local_map``
(MLA's composed decode the plain absorbed form on them); an arch with a
multimodal prefix serves text-only, as the reference's HyperServe does
(:func:`check_mesh_serving` refuses only the data axis).

Prefill/decode disaggregation (HyperMPMD §3.3): given ``prefill_group`` /
``decode_group`` process groups (:func:`repro_torch.core.mpmd.
serving_groups`), the decode group's ranks own the scheduler, the pool and
the decode loop (this engine, on the decode group's mesh), and the prefill
group's ranks run a :class:`PrefillWorker`: the decode group's first rank
sends it each batch of scheduled prompts as one ``(Pb, padded)`` token
block (Pb bucketed to a power of two, padded to a ``prefill_chunk``
multiple), the worker runs the dense prefill on its own group (one
``flash_attention`` an attention layer) and hands the last prompt
position's logits rows and the caches back through
:func:`~repro_torch.core.mpmd.transfer`, and the decode ranks seat the
caches into their pool shards (``StatePool.seat_prefill_caches``): the
decode ranks never spend a step on prefill compute.  Only pure paged
layouts hand over (``models.mixers.check_disagg_supported``), and the
prefix cache never forks under disaggregation.  A finished prompt's full
blocks can otherwise be retained in a copy-on-write **prefix cache**: an
identical prompt prefix forks the cached blocks (refcount bump, zero
copies, zero recompute) and prefills only the tail.
"""
from __future__ import annotations

import functools
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.api.errors import PlanError, ServePlanError
from repro_torch.configs.base import ServeConfig
from repro_torch.core import mpmd
from repro_torch.core.hypershard import ShardingPlan
from repro_torch.core.kvcache import HostArchive
from repro_torch.core.meshctx import use_mesh
from repro_torch.core.tree import tree_map
from repro_torch.kernels import ops
from repro_torch.mem.prefetcher import Prefetcher
from repro_torch.models import mixers as MX, model as M
from repro_torch.obs import Observability
from repro_torch.serve.paged_kv import BlockManager, StatePool
from repro_torch.serve.scheduler import ContinuousScheduler, Request, RequestState


def resolve_device(device=None) -> torch.device:
    """The device to run on: ``device`` if given, else the card.

    With no device named and no CUDA device present this raises; it never
    falls back to the CPU (pass ``device="cpu"`` to run there on purpose).
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: repro_torch runs on the card "
            "unless the caller passes device='cpu' explicitly")
    return torch.device("cuda")


def _resolve_serve_plan(plan, mesh=None):
    """Validate the caller's plan for serving; never silently rewrite it.
    Returns ``(ShardingPlan, ServeConfig | None)``: ``ShardingPlan(fsdp=
    None)`` for None; for a :class:`~repro_torch.api.plan.HyperPlan`
    (validated against ``mesh``'s layout through ``HyperPlan.coerce``) its
    lowered ``ShardingPlan`` and its serving leg; a ``ShardingPlan`` as it
    is.  Raises :class:`~repro_torch.api.errors.ServePlanError` for a plan
    that shards parameters over fsdp (a one-token decode step would gather
    every weight each token, with nothing to amortise the gathers over),
    and :class:`~repro_torch.api.errors.PlanError` for what is no plan."""
    if plan is None:
        return ShardingPlan(fsdp=None), None
    scfg = None
    if not isinstance(plan, ShardingPlan):
        from repro_torch.api.plan import HyperPlan
        from repro_torch.core.layout import layout_for_mesh
        hp = HyperPlan.coerce(plan)
        hp.validate(layout_for_mesh(mesh) if mesh is not None else None)
        plan, scfg = hp.sharding_plan(), hp.serve
    if plan.fsdp:
        raise ServePlanError(
            f"plan shards parameters over fsdp={plan.fsdp}, which the "
            "serving runtime cannot use: decode steps would all-gather every "
            "weight each token (fsdp amortises gathers over a whole training "
            "step; a one-token step has nothing to amortise against), and "
            "the paged pool shards over tp only.  Use plan.replace("
            "fsdp=None), or a serving preset (repro_torch.api.plans.serve() "
            "/ serve_disagg()).")
    return plan, scfg


def check_mesh_serving(mesh) -> None:
    """Refuse, before anything is placed, what does not serve on a mesh: a
    mesh that is not a ``DeviceMesh`` (:class:`PlanError`), and one with a
    data axis (``serve.engine.check_data_axis_serving``).  Every family
    serves, under the fused and the composed lowering; an arch with a
    multimodal prefix serves text-only, as the reference's HyperServe
    never passes a prefix."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.serve.engine import check_data_axis_serving
    if not isinstance(mesh, DeviceMesh):
        raise PlanError(f"mesh={type(mesh).__name__}: not a torch "
                        "DeviceMesh (build one with repro_torch.launch.mesh."
                        "make_host_mesh)")
    check_data_axis_serving(mesh)


def disagg_role(cfg, prefill_group, decode_group,
                mesh=None) -> Optional[str]:
    """This rank's role in a disaggregated engine: None without groups,
    else ``"decode"`` or ``"prefill"``.  Raises the reference's
    ``ValueError`` when only one group is given, a ``ValueError`` when
    ``mesh`` is given beside the groups (each group serves on its own
    mesh), and the reference's
    :class:`~repro_torch.api.errors.ServePlanError` for a model whose
    decode state is not pure paged (``check_disagg_supported``), before
    either group is used."""
    if (prefill_group is None) != (decode_group is None):
        raise ValueError("disaggregation needs BOTH prefill and decode "
                         "groups (or neither)")
    if prefill_group is None:
        return None
    if mesh is not None:
        raise ValueError("mesh= and the prefill/decode groups both given: a "
                         "disaggregated engine serves on its groups' meshes")
    MX.check_disagg_supported(cfg, MX.model_state_layout(cfg))
    for g in (prefill_group, decode_group):
        if g.mesh is not None:
            check_mesh_serving(g.mesh)
    return "decode" if decode_group.has() else "prefill"


# ---------------------------------------------------------------------------
# counter-based sampling: a row's draw is a function of (seed, position,
# vocab index) alone, the port's counterpart of the reference's
# fold_in(PRNGKey(seed), position) (its threefry bits are not reproduced)
# ---------------------------------------------------------------------------
_M32 = 0xFFFFFFFF
_VOCAB_SALT = 0x632BE5AB


def _mul32(x, c: int):
    """(x c) mod 2^32 for int64 x in [0, 2^32) (a numpy array or a torch
    tensor), in two 16-bit halves so that no product overflows int64."""
    return (((x & 0xFFFF) * c) + ((((x >> 16) * c) & 0xFFFF) << 16)) & _M32


def _mix32(x):
    """MurmurHash3's 32-bit finaliser on int64 values in [0, 2^32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def row_keys(seeds, positions) -> np.ndarray:
    """(B,) int64 keys of the rows' draws, from their seeds and positions
    (``len(req.generated)``) alone."""
    s = np.asarray(seeds, np.int64) & _M32
    p = np.asarray(positions, np.int64) & _M32
    return _mix32(_mix32(s) ^ _mul32(p, 0x9E3779B9))


def sample_rows(logits, keys, temps, vocab_hash):
    """One draw a row, on the logits' device: ``logits`` (B, >= V) of any
    float type, ``keys`` (B,) int64 from :func:`row_keys`, ``temps`` (B,)
    f32 > 0, ``vocab_hash`` (V,) int64 ``_mix32(arange(V) ^ salt)``.

    Gumbel-max: token = argmax(logits / T + g) with g = -log(-log(u)) and u
    in (0, 1) from 24 bits of ``_mix32(key ^ vocab_hash)``, so a row's
    token depends on nothing but its own logits, key and temperature (not
    on the other rows, the batch size or the engine's history); the logs
    are taken in float64 and rounded once, so that a row of one and a row
    of a batch agree.  Returns (tokens (B,) int64, logprobs (B,) f32: the
    sampled token's log-softmax under the temperature-scaled logits)."""
    V = vocab_hash.shape[0]
    lg = logits[:, :V].float() / temps[:, None]
    h = _mix32(keys[:, None] ^ vocab_hash[None, :])
    u = ((h >> 8).double() + 0.5) * 2.0 ** -24
    tok = torch.argmax(lg + (-torch.log(-torch.log(u))).float(), dim=-1)
    lp = lg.gather(1, tok[:, None])[:, 0] - torch.logsumexp(lg, dim=-1)
    return tok, lp


class ServeEngine:
    """The serving loop over one model, on ``device`` (the card unless the
    caller names another) or tensor-parallel on ``mesh`` under ``plan``
    (a ``ShardingPlan`` with ``fsdp=None``, the default; every rank builds
    the engine with the same params and runs the same requests).  With
    ``prefill_group`` and ``decode_group`` it is the decode group's engine
    of a disaggregated server (on the decode group's mesh; the prefill
    group's ranks run :class:`PrefillWorker`)."""

    def __init__(self, cfg, params, *, serve_cfg: Optional[ServeConfig] = None,
                 seed: int = 0, obs: Optional[Observability] = None,
                 device=None, mesh=None, plan=None,
                 prefill_group: Optional[mpmd.ProcessGroup] = None,
                 decode_group: Optional[mpmd.ProcessGroup] = None):
        role = disagg_role(cfg, prefill_group, decode_group, mesh)
        if role == "prefill":
            raise ValueError("this rank is in the prefill group: it runs "
                             "PrefillWorker (HyperServe picks it)")
        self.prefill_group = prefill_group
        self.decode_group = decode_group
        if decode_group is not None:
            mesh = decode_group.mesh
        self.device = resolve_device(device)
        self.cfg = cfg
        self.mesh = mesh
        self.plan, plan_scfg = _resolve_serve_plan(plan, mesh)
        # a bare engine gets a private hub so per-engine counters and the
        # compile ledger stay clean across engines in one process
        self.obs = obs if obs is not None else Observability()
        self.scfg = scfg = (serve_cfg or plan_scfg
                            or ServeConfig()).validate()
        # plan-level kernels toggle -> lowering path, resolved ONCE so every
        # step this engine dispatches takes the same path (and the
        # serve.kernels.* counters pin it exactly)
        self.kernel_path = ops.resolve_paged_path(scfg.kernels)
        if mesh is not None:
            check_mesh_serving(mesh)

        self.pcfg = scfg.paged_config(model_dtype=cfg.dtype)
        # resolves cfg against the mixer registry; typed ServePlanError for
        # unservable stacks (unregistered mixer kinds)
        self.pool = StatePool(cfg, self.pcfg, num_slots=scfg.max_slots,
                              device=self.device, mesh=mesh, plan=self.plan)
        self.layout = self.pool.layout
        # HyperMem: the archive is a bounded host->disk tier stack (0 =
        # unbounded), and a lookahead prefetcher stages restores for
        # preempted requests nearing the queue head (StepPlan.near_head)
        self.blocks = BlockManager(self.pcfg, HostArchive(
            self.device, host_budget_bytes=scfg.archive_host_bytes,
            disk_budget_bytes=scfg.archive_disk_bytes, obs=self.obs))
        self._restore_prefetch = Prefetcher(
            lambda key: self.blocks.archive.fetch(key, pop=False),
            depth=max(1, 2 * scfg.restore_lookahead), obs=self.obs)
        self.restore_ahead_hits = 0
        self.scheduler = ContinuousScheduler(
            scfg.scheduler_config(), self.blocks, scfg.block_size,
            scfg.max_blocks_per_req,
            spill=self._spill, restore=self._restore, reclaim=self._reclaim,
            prefix=self._prefix_lookup, retain=self._retain,
            free_window=self.layout.free_window,
            needs_pages=self.layout.has_paged_state,
            seed_fn=self._default_seed, obs=self.obs)
        self.params = tree_map(lambda t: t.to(self.device), params)
        if mesh is not None:
            from repro_torch.models.bridge import shard_params
            self.params = shard_params(self.params, mesh, self.plan)

        # prefix cache: token-tuple -> block ids (refs held by the cache)
        self._prefix_cache: "OrderedDict[Tuple[int, ...], List[int]]" = \
            OrderedDict()
        self.seed = seed
        self.t_start = time.perf_counter()
        self.tokens_generated = 0
        # interval-rate marks: stats() reports tokens/sec over the window
        # since the previous stats() call
        self._rate_t = self.t_start
        self._rate_tokens = 0
        # batching effectiveness: chunks serviced vs calls made
        self.prefill_calls = 0
        self.prefill_chunks = 0
        # the prefill ranks hold the params of this install epoch
        self.params_epoch = self._prefill_epoch = 0
        if prefill_group is not None:
            self.mpmd_sched = mpmd.MPMDScheduler(
                {g.name: g for g in (prefill_group, decode_group)},
                obs=self.obs, device=self.device)
            if mesh is not None:
                from repro_torch.core.tree import tree_flatten_with_path
                self._cache_placements = {
                    k: t.placements
                    for k, t in tree_flatten_with_path(self.pool.state)}

    @property
    def is_decode_leader(self) -> bool:
        """Whether this rank speaks for the decode group (it sends the
        prefill group its work and every reply)."""
        return (self.decode_group is None
                or mpmd.my_rank() == self.decode_group.leader)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _full(self, logits):
        """A step's logits as a plain tensor holding every vocab entry, the
        same on every rank of a mesh (gathered over ``model`` where
        ``serve.engine._vocab_axis`` shards them)."""
        if self.mesh is None:
            return logits
        from repro_torch.serve.engine import full_logits
        return full_logits(self.cfg, self.mesh, logits)

    # ------------------------------------------------------------------
    # tier-movement callbacks (scheduler-driven)
    # ------------------------------------------------------------------
    def _spill(self, req: Request) -> None:
        """Archive a preempted request's pages AND its dense seat rows."""
        with self.obs.trace.span("serve.spill", track="engine", rid=req.rid,
                                 blocks=len(req.table)):
            if self.layout.has_slot_state:
                self.blocks.archive.put(req.slot_archive_key,
                                        self.pool.extract_slot(req.slot))
            self.blocks.spill(req.archive_key, req.table,
                              self.pool.extract_pages)
        self.obs.metrics.counter("serve.spills").inc()

    def _restore(self, req: Request) -> List[int]:
        with self.obs.trace.span("serve.restore", track="engine",
                                 rid=req.rid):
            bids = self._restore_inner(req)
        self.obs.metrics.counter("serve.restores").inc()
        return bids

    def _restore_inner(self, req: Request) -> List[int]:
        # allocate BEFORE consuming staged state: NoFreeBlocks aborts the
        # resume with both the archive entry and the prefetch buffer
        # intact, so the retry next iteration is identical
        pf = self._restore_prefetch
        bids = self.blocks.alloc(req.spilled_blocks)
        pages, hit = pf.take(req.archive_key)
        self.blocks.archive.discard(req.archive_key)
        self.pool.insert_pages(pages, bids)
        # the scheduler seats req.slot before calling this, so the dense
        # seat rows are re-seated here, with the pages (seating them later
        # in step() would lose a same-iteration re-preemption race: _spill
        # would archive the seat's stale rows)
        if self.layout.has_slot_state:
            rows, slot_hit = pf.take(req.slot_archive_key)
            self.blocks.archive.discard(req.slot_archive_key)
            self.pool.insert_slot(req.slot, rows)
            hit = hit and slot_hit
        if hit:
            # the request's archived pages were already moving before
            # _admit asked for them
            self.restore_ahead_hits += 1
            self.obs.metrics.counter("mem.restore_ahead.hit").inc()
        # window-freed entries were a table prefix; rebuild alignment
        return [BlockManager.NULL] * req.null_prefix + bids

    def _stage_restores(self, near: List[Request]) -> None:
        """Predictive restore: start pulling archived pages for PREEMPTED
        requests nearing the queue head.  The fetch is an asynchronous
        host->device copy (pop=False — the archive entry survives until the
        real restore commits), so it overlaps this iteration's work."""
        pf = self._restore_prefetch
        arch = self.blocks.archive
        pf.prune(lambda k: k in arch)     # cancelled requests drop staged
        for req in near:
            if req.archive_key in arch:
                pf.stage(req.archive_key)
            if self.layout.has_slot_state and req.slot_archive_key in arch:
                pf.stage(req.slot_archive_key)

    def _reclaim(self, n: int) -> int:
        """Evict LRU prefix-cache entries until >= n blocks are freed."""
        freed = 0
        while self._prefix_cache and freed < n:
            _, bids = self._prefix_cache.popitem(last=False)
            before = self.blocks.num_free
            self.blocks.free(bids)
            freed += self.blocks.num_free - before
        return freed

    def _prefix_lookup(self, req: Request) -> List[int]:
        # disagg mode seats the whole dense prefill cache into the table,
        # which would write through CoW-shared blocks: no sharing there.
        # Prefix forks are only sound for pure-paged layouts.
        if (not self.scfg.enable_prefix_cache
                or self.prefill_group is not None
                or not self.layout.pure_paged):
            return []
        bs = self.pcfg.block_size
        # at least one prompt token must remain to prefill (its logits seed
        # the first generated token), hence the -1
        for nb in range((req.prompt_len - 1) // bs, 0, -1):
            key = tuple(req.prompt[:nb * bs])
            if key in self._prefix_cache:
                self._prefix_cache.move_to_end(key)
                return self.blocks.fork(self._prefix_cache[key])
        return []

    def _retain(self, req: Request) -> None:
        if not self.scfg.enable_prefix_cache or not self.layout.pure_paged:
            return
        bs = self.pcfg.block_size
        # retain every full-block prefix: a future prompt can only fork a
        # prefix strictly shorter than itself
        for nb in range(1, req.prompt_len // bs + 1):
            key = tuple(req.prompt[:nb * bs])
            if key in self._prefix_cache:
                self._prefix_cache.move_to_end(key)
                continue
            self._prefix_cache[key] = self.blocks.fork(req.table[:nb])
        while (sum(len(v) for v in self._prefix_cache.values())
               > self.scfg.prefix_cache_blocks):
            _, bids = self._prefix_cache.popitem(last=False)
            self.blocks.free(bids)

    # ------------------------------------------------------------------
    # sampling
    # ------------------------------------------------------------------
    def _default_seed(self, rid: int) -> int:
        """Per-request seed for requests that didn't pin one at submit."""
        return (self.seed ^ (rid * 0x9E3779B1)) & 0x7FFFFFFF

    @functools.cached_property
    def _vocab_hash(self) -> torch.Tensor:
        """(V,) int64 per-token hashes of :func:`sample_rows`, made once."""
        v = torch.arange(self.cfg.vocab_size, dtype=torch.int64,
                         device=self.device)
        return _mix32(v ^ _VOCAB_SALT)

    def _draw(self, logits, rows: List[Optional[Request]]):
        """:func:`sample_rows` over ``logits`` (len(rows), >= V), row i for
        temperature > 0 request ``rows[i]`` (None: an empty seat, drawn
        with key 0 at temperature 1 and never read), then ONE transfer of
        (tokens, logprobs) to the host as two float64 rows (token ids are
        exact there)."""
        keys = row_keys([r.seed if r else 0 for r in rows],
                        [len(r.generated) if r else 0 for r in rows])
        temps = np.asarray([r.temperature if r else 1.0 for r in rows],
                           np.float32)
        tok, lp = sample_rows(logits, self._tensor(keys),
                              self._tensor(temps), self._vocab_hash)
        out = torch.stack([tok.double(), lp.double()]).cpu().numpy()
        return out[0].astype(np.int64), out[1]

    def _sample(self, logits_row, req: Request) -> int:
        """Sample the request's next token: greedy at temperature 0, else
        :func:`sample_rows` on this one row, the function the batched
        sampler computes for every row.

        The draw depends only on ``(req.seed, len(req.generated))`` — no
        engine-global state — so a temperature>0 request resamples the
        identical token stream across runs AND across preemption
        spill/restore (which never rolls ``generated`` back), and a row
        samples the same token whatever else is seated.  With
        ``capture_logprobs`` the sampled token's logprob under the sampling
        distribution is appended to ``req.logprobs``.
        """
        if req.temperature > 0:
            toks, lps = self._draw(logits_row[None], [req])
            tok, lp = int(toks[0]), float(lps[0])
        else:
            lg = logits_row[:self.cfg.vocab_size].float()
            tok = int(torch.argmax(lg))
            lp = float(torch.log_softmax(lg, -1)[tok]) \
                if req.capture_logprobs else 0.0
        if req.capture_logprobs:
            req.logprobs.append(lp)
        return tok

    def _sample_batch(self, runners: List[Request], logits):
        """Batched temperature sampling for the decode step's runners: one
        device computation over all ``max_slots`` rows (empty seats draw
        with a zero key at temperature 1, never read), one transfer.  Row
        semantics are :meth:`_sample`'s, so batching never changes a row's
        stream."""
        seated: List[Optional[Request]] = [None] * self.scfg.max_slots
        for r in runners:
            seated[r.slot] = r
        toks, lps = self._draw(logits, seated)
        for r in runners:
            if r.capture_logprobs:
                r.logprobs.append(float(lps[r.slot]))
        return {r.slot: int(toks[r.slot]) for r in runners}

    # ------------------------------------------------------------------
    # prefill execution
    # ------------------------------------------------------------------
    def _run_prefill_batch(self, reqs: List[Request]) -> None:
        """Every scheduled prompt chunk in ONE call (<= prefill_batch rows,
        filler rows padded to limit 0 / the null slot / the null block).

        The row count is bucketed to the next power of two (1, 2, 4, ...,
        prefill_batch), as the reference buckets its jit shapes: a lone
        prefilling request costs a (1, chunk) call, not a fully padded one.
        """
        C = self.scfg.prefill_chunk
        Pb = 1
        while Pb < len(reqs):
            Pb *= 2
        Pb = min(Pb, self.scfg.prefill_batch)
        W = self.pcfg.max_blocks_per_req
        toks = np.zeros((Pb, C), np.int32)
        starts = np.zeros((Pb,), np.int32)
        limits = np.zeros((Pb,), np.int32)
        slots = np.full((Pb,), self.scfg.max_slots, np.int32)
        tables = np.zeros((Pb, W), np.int32)
        meta = []
        for i, req in enumerate(reqs):
            c0 = req.prefill_done
            n = min(C, req.prompt_len - c0)
            toks[i, :n] = req.prompt[c0:c0 + n]
            starts[i] = c0
            limits[i] = req.prompt_len
            slots[i] = req.slot
            tables[i, :len(req.table)] = req.table
            meta.append((i, req, n))
        self.obs.record_compile("paged_prefill", (Pb, C, W))
        self.obs.metrics.counter(
            f"serve.kernels.prefill.{self.kernel_path}").inc()
        with self.obs.trace.span("serve.prefill", track="engine",
                                 rows=len(reqs), bucket=Pb,
                                 rids=[r.rid for r in reqs]):
            with use_mesh(self.mesh):
                logits = self._full(M.prefill_chunk_paged(
                    self.params, self._tensor(toks), self._tensor(starts),
                    self._tensor(limits), self._tensor(slots), self.cfg,
                    self.pool.state, self._tensor(tables),
                    block_size=self.scfg.block_size,
                    kernels=self.kernel_path))
        self.prefill_calls += 1
        self.prefill_chunks += len(reqs)
        self.obs.metrics.counter("serve.prefill_calls").inc()
        self.obs.metrics.counter("serve.prefill_chunks").inc(len(reqs))
        for i, req, n in meta:
            self.scheduler.on_prefill_chunk(req, n)
            if req.prefill_done == req.prompt_len:
                # the step returns each row's LAST in-chunk prompt-token
                # logits: exactly what seeds the first sampled token
                first = self._sample(logits[i], req)
                self.scheduler.on_prompt_complete(req, first)
                self.tokens_generated += 1

    def _sync_prefill_params(self) -> None:
        """Hand the prefill group the params installed since its last
        prefill (a publish installs on the decode ranks at an idle
        boundary; the prefill ranks take the same weights before they
        next prefill, the reference's ``_staged_prefill``)."""
        if self._prefill_epoch == self.params_epoch:
            return
        if self.is_decode_leader:
            mpmd.send_to(self.prefill_group, ("params",))
        mpmd.transfer(self.params, self.decode_group, self.prefill_group)
        self._prefill_epoch = self.params_epoch

    def _run_disagg_prefill(self, reqs: List[Request]) -> None:
        """Whole-prompt prefill for all scheduled prompts as ONE dense
        batch on the prefill group; each row's pages scatter into this
        group's pool.  Rows are right-padded to a shared chunk-aligned
        length (causal attention keeps rows independent, and the dense
        prefill's MoE takes the dropless per-token dispatch, so batching
        rows never changes a row's output); the batch dim is bucketed to
        the next power of two (all-zero filler rows are computed and
        never sent), one dense shape per (bucket, padded length)."""
        S_max = max(r.prompt_len for r in reqs)
        padded = S_max + (-S_max % self.scfg.prefill_chunk)
        Pb = 1
        while Pb < len(reqs):
            Pb *= 2
        toks = np.zeros((Pb, padded), np.int32)
        for i, r in enumerate(reqs):
            toks[i, :r.prompt_len] = r.prompt
        lens = [r.prompt_len for r in reqs]
        self.obs.record_compile("dense_prefill", (Pb, padded))
        with self.obs.trace.span("serve.prefill", track="engine",
                                 rows=len(reqs), bucket=Pb, padded=padded,
                                 rids=[r.rid for r in reqs], disagg=True):
            self._sync_prefill_params()
            if self.is_decode_leader:
                mpmd.send_to(self.prefill_group, ("prefill", toks, lens))
            self.mpmd_sched.wait(self.mpmd_sched.submit(
                self.prefill_group.name, None))
            # the logits rows and the KV pages, from the prefill group's
            # layout into this group's pool layout
            with self.obs.trace.span("serve.kv_transfer", track="engine",
                                     rows=len(reqs)):
                got = mpmd.transfer(None, self.prefill_group,
                                    self.decode_group, self._placement,
                                    device=self.device)
        from repro_torch.core.meshctx import full_tensor
        logits, pcaches = full_tensor(got["logits"]), got["caches"]
        self.prefill_calls += 1
        self.prefill_chunks += len(reqs)
        self.obs.metrics.counter("serve.prefill_calls").inc()
        self.obs.metrics.counter("serve.prefill_chunks").inc(len(reqs))
        for i, req in enumerate(reqs):
            S = req.prompt_len
            self.pool.seat_prefill_caches(pcaches, req.table, S, row=i)
            self.scheduler.on_prefill_chunk(req, S - req.prefill_done)
            first = self._sample(logits[i], req)
            self.scheduler.on_prompt_complete(req, first)
            self.tokens_generated += 1

    def _placement(self, path: str, t):
        """A handed-over leaf's placements on the decode mesh: a cache
        leaf's are its pool leaf's (same dims past the batch), the logits
        rows replicate."""
        from torch.distributed.tensor import Replicate
        return self._cache_placements.get(
            path.removeprefix("caches/"),
            [Replicate()] * self.mesh.ndim)

    # ------------------------------------------------------------------
    # the engine iteration
    # ------------------------------------------------------------------
    @torch.no_grad()
    def step(self) -> List[Tuple[int, int]]:
        """One scheduler+compute iteration.  Returns [(rid, new token)]."""
        plan = self.scheduler.schedule()
        if plan.near_head or self._restore_prefetch.entries:
            self._stage_restores(plan.near_head)
        if self.layout.has_slot_state:
            # fresh admissions must not inherit the previous occupant's
            # recurrence (resumed requests were re-seated inside _restore)
            for req in plan.admitted:
                self.pool.zero_slot(req.slot)
        events: List[Tuple[int, int]] = []
        if plan.prefill:
            # all scheduled chunks run in one batched call per group of
            # prefill_batch rows.  (The reference keeps one request a call
            # under a forced GShard MoE dispatch, whose rows depend on
            # their batch mates; the port's serving takes only the
            # dropless ragged dispatch, so the groups stand.)
            gsz = self.scfg.prefill_batch
            for i in range(0, len(plan.prefill), gsz):
                group = plan.prefill[i:i + gsz]
                if self.prefill_group is not None:
                    self._run_disagg_prefill(group)
                else:
                    self._run_prefill_batch(group)
            for req in plan.prefill:
                if req.generated:
                    events.append((req.rid, req.generated[-1]))

        runners = [r for r in plan.decode
                   if r.state is RequestState.RUNNING]
        if runners:
            B = self.scfg.max_slots
            W = self.pcfg.max_blocks_per_req
            tokens = np.zeros((B, 1), np.int32)
            positions = np.zeros((B,), np.int32)
            tables = np.zeros((B, W), np.int32)
            slot_mask = np.zeros((B,), bool)
            for r in runners:
                tokens[r.slot, 0] = r.generated[-1]
                positions[r.slot] = r.total_len - 1
                tables[r.slot, :len(r.table)] = r.table
                slot_mask[r.slot] = True
            self.obs.record_compile("paged_decode", (B, W))
            self.obs.metrics.counter(
                f"serve.kernels.decode.{self.kernel_path}").inc()
            t_dec = time.perf_counter()
            with self.obs.trace.span("serve.decode", track="engine",
                                     runners=len(runners)):
                with use_mesh(self.mesh):
                    logits = self._full(M.decode_step_paged(
                        self.params, self._tensor(tokens),
                        self._tensor(positions), self.cfg, self.pool.state,
                        self._tensor(tables),
                        block_size=self.scfg.block_size,
                        slot_mask=(self._tensor(slot_mask)
                                   if self.layout.has_slot_state else None),
                        kernels=self.kernel_path))
                if all(r.temperature <= 0 and not r.capture_logprobs
                       for r in runners):
                    # batched greedy: one device op + one transfer for the
                    # whole batch instead of a sync per seated slot
                    nxt = torch.argmax(
                        logits[:, -1, :self.cfg.vocab_size].float(),
                        dim=-1).cpu().numpy()
                    picks = {r.slot: int(nxt[r.slot]) for r in runners}
                elif all(r.temperature > 0 for r in runners):
                    # batched stochastic (the RL rollout hot path)
                    self.obs.record_compile("sampler", (B,))
                    picks = self._sample_batch(runners, logits[:, -1])
                else:
                    picks = {r.slot: self._sample(logits[r.slot, -1], r)
                             for r in runners}
            # one decode step advances every runner one token: the step's
            # wall time IS each seated request's inter-token latency
            self.obs.metrics.histogram("serve.itl_s").observe(
                time.perf_counter() - t_dec)
            for r in runners:
                tok = picks[r.slot]
                self.scheduler.on_decode_token(r, tok)
                self.tokens_generated += 1
                events.append((r.rid, tok))
        self._set_gauges()
        return events

    def _set_gauges(self) -> None:
        """Occupancy snapshot after an engine iteration (pool / archive /
        prefix-cache gauges, plus Perfetto counter tracks while a trace is
        being captured)."""
        m = self.obs.metrics
        occ = self.blocks.occupancy()
        m.gauge("serve.block_occupancy").set(occ)
        m.gauge("serve.blocks_free").set(self.blocks.num_free)
        m.gauge("serve.archive_host_bytes").set(
            self.blocks.archive.nbytes_host())
        m.gauge("serve.archive_disk_bytes").set(
            self.blocks.archive.nbytes_disk())
        m.gauge("serve.pool_hbm_bytes").set(self.pool.hbm_bytes())
        m.gauge("serve.prefix_cache_blocks").set(
            sum(len(v) for v in self._prefix_cache.values()))
        tr = self.obs.trace
        if tr.enabled:
            tr.counter("block_occupancy", occ, track="pool")
            tr.counter("archive_bytes", self.blocks.archive.nbytes(),
                       track="pool")
            tr.counter("running",
                       sum(1 for r in self.scheduler.active
                           if r.state is RequestState.RUNNING), track="pool")

    def run_until_complete(self, max_steps: int = 100_000) -> Dict[int, List[int]]:
        steps = 0
        while self.scheduler.has_work():
            self.step()
            steps += 1
            if steps > max_steps:
                raise RuntimeError("serving loop did not drain "
                                   f"({max_steps} steps)")
        return {rid: r.generated for rid, r in self.scheduler.requests.items()}

    def snapshot(self) -> Dict:
        """Cheap read-only routing surface (HyperFabric keys off this).

        Host-side scheduler and pool accounting only: no device sync, no
        mutation, so a router can poll it at every dispatch decision.  The
        prefix-cache view exposes both the retained block ids and the
        token-tuple keys: the keys are what longest-prefix affinity
        matching needs, the ids what capacity accounting needs.
        Everything here is a function of the request history, which is
        what lets routing decisions (and their counters) be pinned
        exactly."""
        sched = self.scheduler
        prefilling = sum(1 for r in sched.active
                         if r.state is RequestState.PREFILLING)
        running = sum(1 for r in sched.active
                      if r.state is RequestState.RUNNING)
        return {
            "queue_depth": len(sched.queue),
            "prefilling": prefilling,
            "running": running,
            "free_slots": self.scfg.max_slots - prefilling - running,
            "max_slots": self.scfg.max_slots,
            "max_queue": sched.cfg.max_queue,
            "free_blocks": self.blocks.num_free,
            "block_occupancy": self.blocks.occupancy(),
            "prefix_cache_block_ids": tuple(
                b for bids in self._prefix_cache.values() for b in bids),
            "prefix_keys": tuple(self._prefix_cache.keys()),
            "has_work": sched.has_work(),
        }

    def stats(self) -> Dict[str, float]:
        now = time.perf_counter()
        # interval rate: tokens since the previous stats() call over the
        # wall time since that call
        dt_int = now - self._rate_t
        tok_int = self.tokens_generated - self._rate_tokens
        self._rate_t = now
        self._rate_tokens = self.tokens_generated
        dt_cum = now - self.t_start
        m = self.obs.metrics
        ttft = m.histogram("serve.ttft_s")
        itl = m.histogram("serve.itl_s")
        qw = m.histogram("serve.queue_wait_s")
        s = self.scheduler.stats()
        s.update({
            "queue_depth": len(self.scheduler.queue),
            "tokens_generated": self.tokens_generated,
            "tokens_per_sec": tok_int / dt_int if dt_int > 0 else 0.0,
            "tokens_per_sec_cumulative":
                self.tokens_generated / dt_cum if dt_cum > 0 else 0.0,
            "prefill_calls": self.prefill_calls,
            "prefill_chunks": self.prefill_chunks,
            "pool_hbm_bytes": self.pool.hbm_bytes(),
            # per-tier archive accounting (HyperMem): host memory vs the
            # disk tier the bounded archive spills into, and its evictions
            "archive_host_bytes": self.blocks.archive.nbytes_host(),
            "archive_disk_bytes": self.blocks.archive.nbytes_disk(),
            "archive_evict_host": self.blocks.archive.counters["evict_host"],
            "archive_evict_disk": self.blocks.archive.counters["evict_disk"],
            "restore_ahead_hits": self.restore_ahead_hits,
            "prefetch_hits": self._restore_prefetch.counters["hit"],
            "prefetch_misses": self._restore_prefetch.counters["miss"],
            "prefix_cache_blocks": sum(len(v)
                                       for v in self._prefix_cache.values()),
            "ttft_p50_s": ttft.percentile(50),
            "ttft_p95_s": ttft.percentile(95),
            "itl_p50_s": itl.percentile(50),
            "itl_p95_s": itl.percentile(95),
            "queue_wait_p50_s": qw.percentile(50),
            "recompiles": self.obs.recompiles(),
        })
        return s


class PrefillWorker:
    """The prefill group's side of a disaggregated server: the params on
    the group's mesh (or its one device) and the dense prefill step, run
    as the decode group's first rank asks (the decode ranks keep the
    engine's counters and spans).

    :meth:`follow` serves that rank's messages until it replies: a
    ``("prefill", tokens, lengths)`` block runs the dense prefill (an MPMD
    task of this group) and hands each row's last prompt position's
    logits and the caches of the real rows to the decode group
    (:func:`~repro_torch.core.mpmd.transfer`); ``("params",)`` takes the
    weights the decode group installed; ``("reply", value)`` ends the
    call, returning the value the decode ranks' call returned, so that a
    call returns the same on every rank."""

    def __init__(self, cfg, params, *, serve_cfg: Optional[ServeConfig] = None,
                 plan=None, obs: Optional[Observability] = None, device=None,
                 prefill_group: mpmd.ProcessGroup,
                 decode_group: mpmd.ProcessGroup):
        if disagg_role(cfg, prefill_group, decode_group) != "prefill":
            raise ValueError("PrefillWorker runs on the prefill group's "
                             "ranks only")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.plan, plan_scfg = _resolve_serve_plan(plan,
                                                   prefill_group.mesh)
        self.obs = obs if obs is not None else Observability()
        self.scfg = (serve_cfg or plan_scfg or ServeConfig()).validate()
        self.prefill_group = prefill_group
        self.decode_group = decode_group
        self.mesh = prefill_group.mesh
        self.params = self._place(tree_map(lambda t: t.to(self.device),
                                           params))
        self.mpmd_sched = mpmd.MPMDScheduler(
            {g.name: g for g in (prefill_group, decode_group)},
            obs=self.obs, device=self.device)
        from repro_torch.serve.engine import make_prefill_step
        self.prefill_step = make_prefill_step(cfg, self.mesh)

    def _place(self, params):
        if self.mesh is None:
            return params
        from repro_torch.models.bridge import shard_params
        return shard_params(params, self.mesh, self.plan)

    def follow(self):
        """Serve the decode leader's messages until its reply; returns the
        reply's value (re-raises what the decode ranks raised)."""
        while True:
            msg = mpmd.recv_obj(self.decode_group.leader)
            kind = msg[0]
            if kind == "prefill":
                self._prefill(*msg[1:])
            elif kind == "params":
                self._take_params()
            elif kind == "reply":
                return msg[1]
            elif kind == "raise":
                raise msg[1]
            else:
                raise RuntimeError(f"unknown message {kind!r} from the "
                                   "decode group")

    def _take_params(self) -> None:
        from repro_torch.core.hypershard import make_param_shardings
        sh = (make_param_shardings(self.mesh, self.params, self.plan)
              if self.mesh is not None else None)
        placements = None
        if sh is not None:
            from repro_torch.core.tree import tree_flatten_with_path
            by_path = {p: s.placements
                       for p, s in tree_flatten_with_path(sh)}
            placements = (lambda p, t: by_path[p])
        self.params = mpmd.transfer(None, self.decode_group,
                                    self.prefill_group, placements,
                                    device=self.device)

    @torch.no_grad()
    def _prefill(self, toks: np.ndarray, lens: List[int]) -> None:
        Pb, padded = toks.shape
        n = len(lens)
        self.obs.record_compile("dense_prefill", (Pb, padded))
        task = self.mpmd_sched.submit(
            self.prefill_group.name, self.prefill_step,
            self.params, torch.from_numpy(toks).to(self.device))
        logits, caches = self.mpmd_sched.wait(task)[0]
        if self.mesh is not None:
            from repro_torch.serve.engine import full_logits
            logits = full_logits(self.cfg, self.mesh, logits)
        last = torch.tensor(lens, device=logits.device) - 1
        rows = logits[torch.arange(n, device=logits.device), last]
        # the real rows only: the filler rows were computed, not sent
        mpmd.transfer({"logits": rows,
                       "caches": tree_map(lambda c: c[:, :n], caches)},
                      self.prefill_group, self.decode_group)
