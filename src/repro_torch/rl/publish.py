"""Weight publication: the learner's params -> the serving engine.

The port of ``repro.rl.publish`` on one device.  :class:`WeightPublisher`
hands the engine new weights under the reference's rules:

  - **rebind** — on one device there is no layout to change: ``publish``
    stages the learner's own tensors (moved to the engine's device, which
    copies nothing when they are already there).  That is sound because
    the learner never writes a param in place (its AdamW returns new
    tensors every update), so the tensors the engine serves are never the
    ones a later update writes;
  - **version counter** — a publish only *stages* the new weights.  They
    install when no request is mid-generation (``in_flight``), so every
    in-flight decode finishes on the weights it started with; the counter
    bumps at install time, never at stage time.  Queued-but-unstarted
    requests pick up the new version (they have computed nothing yet);
  - **prefix-cache flush** — installing new weights evicts the engine's
    copy-on-write prefix cache: its retained pages embed *old*-weight KV,
    and forking them under new weights would splice two policies into one
    rollout.

The meshes, the reference's resharding ``device_put`` and its cross-group
transfer of a disaggregated session come with ROADMAP.md section 1 items
8d and 8e.
"""
from __future__ import annotations

import time

import torch

from repro_torch.core.tree import tree_map
from repro_torch.serve.scheduler import RequestState


class WeightPublisher:
    """Stage-and-swap of a ServeEngine's parameters, version-counted."""

    def __init__(self, engine):
        self.engine = engine
        self.obs = engine.obs            # publish events land in the
        self.version = 0                 # engine's own HyperTrace hub
        self.staged_version = 0          # latest published (>= version)
        self._staged = None
        self._t_staged = 0.0

    # ------------------------------------------------------------------
    def reshard(self, params):
        """Trainer layout -> serving layout: on one device, the same
        tensors on the engine's device (no copy when already there)."""
        return tree_map(lambda t: t.to(self.engine.device), params)

    @property
    def pending(self) -> bool:
        return self._staged is not None

    def in_flight(self) -> bool:
        """Any request mid-generation?  Those must finish on old weights.

        Covers PREFILLING/RUNNING seats *and* preempted requests parked in
        the queue — their archived pages embed old-weight KV, so resuming
        them under new weights would splice two policies into one rollout.
        """
        sched = self.engine.scheduler
        if sched.active:
            return True
        return any(r.state is RequestState.PREEMPTED for r in sched.queue)

    # ------------------------------------------------------------------
    def publish(self, params, *, wait: bool = False) -> int:
        """Stage new weights.

        Returns the staged version.  Installation happens here iff nothing
        is in flight; otherwise the caller's engine loop installs at the
        next idle boundary via :meth:`maybe_install`.  A second publish
        before install supersedes the first (latest weights win — stale
        intermediates are never served).  ``wait`` waits for the card to
        finish the staging copies (to measure the publish's latency).
        """
        self.staged_version += 1
        self._t_staged = time.perf_counter()
        with self.obs.trace.span("publish.reshard", track="publish",
                                 version=self.staged_version):
            self._staged = self.reshard(params)
            if wait and self.engine.device.type == "cuda":
                torch.cuda.synchronize(self.engine.device)
        self.obs.metrics.counter("rl.publishes").inc()
        self.obs.trace.instant("publish.stage", track="publish",
                               version=self.staged_version)
        self.maybe_install()
        return self.staged_version

    def maybe_install(self) -> bool:
        """Swap staged weights in if no decode is in flight; True if so."""
        if self._staged is None or self.in_flight():
            return False
        # queued-but-unstarted requests may already hold CoW prefix forks
        # (admission broke on pool pressure after the fork): those pages
        # embed OLD-weight KV, so drop them — the request re-prefills from
        # scratch under the new weights
        for r in self.engine.scheduler.queue:
            if r.table or r.shared_blocks:
                self.engine.blocks.free([b for b in r.table if b])
                r.table = []
                r.shared_blocks = 0
                r.prefill_done = 0
        self.engine.params = self._staged
        self._staged = None
        self.version = self.staged_version
        # stage->install gap: how long the newest policy waited for the
        # in-flight generation to drain (the freshness lag GRPO's
        # importance ratio has to absorb)
        self.obs.metrics.histogram("rl.stage_to_install_s").observe(
            max(time.perf_counter() - self._t_staged, 0.0))
        self.obs.metrics.gauge("rl.weights_version").set(self.version)
        self.obs.trace.instant("publish.install", track="publish",
                               version=self.version)
        # retained CoW prefix pages hold old-weight KV: evict them all
        self.engine._reclaim(self.engine.blocks.num_total)
        return True
