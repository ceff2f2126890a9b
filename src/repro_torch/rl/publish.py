"""Weight publication: the learner's params -> the serving engine.

The port of ``repro.rl.publish``.  :class:`WeightPublisher` hands the
engine new weights under the reference's rules:

  - **resharding** — on one device there is no layout to change:
    ``publish`` stages the learner's own tensors (moved to the engine's
    device, which copies nothing when they are already there).  That is
    sound because the learner never writes a param in place (its AdamW
    returns new tensors every update), so the tensors the engine serves
    are never the ones a later update writes.  Colocated on a mesh each
    leaf goes from the learner's placements (fsdp_tp) to the engine's
    serving placements (``fsdp=None``): a redistribute on the same mesh,
    and through the full tensor where the actor serves on another view of
    the same ranks (DTensor cannot redistribute between meshes).  Across
    role groups (actor and learner on disjoint ranks) it is
    :func:`publish_across`, i.e. :func:`repro_torch.core.mpmd.transfer`
    into the engine's placements, then the same stage and install;
  - **version counter** — a publish only *stages* the new weights.  They
    install when no request is mid-generation (``in_flight``), so every
    in-flight decode finishes on the weights it started with; the counter
    bumps at install time, never at stage time.  Queued-but-unstarted
    requests pick up the new version (they have computed nothing yet);
  - **prefix-cache flush** — installing new weights evicts the engine's
    copy-on-write prefix cache: its retained pages embed *old*-weight KV,
    and forking them under new weights would splice two policies into one
    rollout.

An engine with a prefill group (disaggregated serving) hands the weights
it installs to its prefill ranks before their next prefill
(``ServeEngine._sync_prefill_params``, the reference's
``_staged_prefill``): the install bumps ``engine.params_epoch``.
"""
from __future__ import annotations

import time

import torch

from repro_torch.core import mpmd
from repro_torch.core.meshctx import full_tensor, is_dtensor
from repro_torch.core.tree import tree_flatten_with_path, tree_map
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
        # the serving placements of every param leaf (None: one device)
        self._placements = None
        if engine.mesh is not None:
            self._placements = {p: t.placements for p, t in
                                tree_flatten_with_path(engine.params)}

    def placement(self, path: str, _leaf=None):
        """Leaf ``path``'s serving placements on the engine's mesh (the
        ``placements`` of :func:`~repro_torch.core.mpmd.transfer`)."""
        return self._placements[path]

    # ------------------------------------------------------------------
    def reshard(self, params):
        """Trainer layout -> serving layout: on one device, the same
        tensors on the engine's device (no copy when already there); on a
        mesh each leaf placed as the engine's (a redistribute on the
        engine's mesh, else through the full tensor: a collective, so
        every rank publishes)."""
        if self._placements is None:
            return tree_map(lambda t: t.to(self.engine.device), params)
        from repro_torch.core.hypershard import distribute
        from repro_torch.core.tree import tree_map_with_path
        mesh = self.engine.mesh

        def place(path, t):
            pl = self._placements[path]
            if is_dtensor(t) and t.device_mesh == mesh:
                return t.redistribute(mesh, pl)
            return distribute(full_tensor(t).to(self.engine.device), mesh,
                              pl)
        return tree_map_with_path(place, params)

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
        self.engine.params_epoch += 1
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


def publish_across(src: mpmd.ProcessGroup, dst: mpmd.ProcessGroup,
                   publisher: "WeightPublisher", *, wait: bool = False):
    """The actor's side of a disaggregated session's cross-group publish:
    every rank of the actor group ``dst`` calls this while the learner
    group ``src`` sends its params with
    :func:`~repro_torch.core.mpmd.transfer`; they arrive in
    ``publisher``'s serving placements on ``dst``, which stages and
    installs them as :meth:`WeightPublisher.publish` does.  Returns the
    staged version."""
    eng = publisher.engine
    got = mpmd.transfer(None, src, dst, publisher.placement
                        if eng.mesh is not None else None,
                        device=eng.device)
    return publisher.publish(got, wait=wait)
