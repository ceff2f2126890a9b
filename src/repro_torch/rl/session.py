"""RLSession: actor + learner, colocated or as HyperMPMD roles.

The port of ``repro.rl.session``.  The reference resolves its session
from a ``Supernode`` and a ``HyperPlan`` (the learner's fsdp/tp sharding,
the actor's serving knobs, the RL loop and optionally an actor/learner
device split); the port's session takes those legs directly, or from a
``plan=`` (a :class:`~repro_torch.api.plan.HyperPlan`, as
``Supernode.rl`` passes it, or a legacy ``ShardingPlan``) through
``HyperPlan.coerce``: its ``rl``, ``serve`` and ``roles`` legs stand in
for the arguments not given, and its sharding is the learner's.  Three
layouts:

  - one device (no ``mesh``, no ``roles``): both sides on ``device``;
  - ``mesh=`` (colocated, the reference's ``rl_colocate`` on a mesh): the
    learner on the mesh under fsdp_tp, the actor on
    :func:`serving_mesh_for` of it (the same ranks, ``model`` only), every
    rank running both; a publish reshards the learner's placements into
    the serving ones;
  - ``roles={"actor": n, "learner": m}`` (the reference's ``rl_disagg``):
    the world's ranks carved into the two role groups
    (:func:`repro_torch.launch.mesh.role_groups`, a count of 0
    auto-balanced), the actor's ranks rolling out on their group (its flat
    serving mesh, or one device), the learner's updating on theirs, the
    rollout and the update dispatched through an
    :class:`~repro_torch.core.mpmd.MPMDScheduler` and the new weights
    handed across by :func:`~repro_torch.rl.publish.publish_across`.  Every
    rank calls :meth:`iterate`, :meth:`rollout_greedy`,
    :meth:`utilization_report` and :meth:`stats` in the same order and
    gets the same value: the actor's first rank sends the learner's ranks
    the batch and what the actor measured, the learner's first rank sends
    the actor's ranks the update's metrics.

Each :meth:`iterate` is one sample-evaluate-update cycle:

    rollout   the actor fans every prompt into a GRPO group and the
              continuous-batching engine drains them (stragglers never
              barrier the batch);
    evaluate  the caller's ``reward_fn(prompt, tokens)`` scores each
              sample; advantages are group-relative (no value net);
    update    one GRPO step on the learner;
    publish   the new weights are staged for the actor and installed at
              its next idle boundary — version-counted, in-flight decodes
              unaffected.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.api.errors import PlanError
from repro_torch.configs.base import RLConfig, ServeConfig
from repro_torch.core import mpmd
from repro_torch.core.hypershard import ShardingPlan
from repro_torch.rl.buffer import RolloutBuffer
from repro_torch.rl.learner import GRPOLearner, dp_size
from repro_torch.rl.publish import publish_across
from repro_torch.rl.rollout import RolloutEngine, resolve_moe_dispatch
from repro_torch.serve.runtime import resolve_device

RewardFn = Callable[[List[int], List[int]], float]


def serving_mesh_for(mesh):
    """The actor's serving mesh: the same ranks, ``model`` axis only.

    Decoding is tensor-parallel only (the serving leg drops fsdp), so a
    learner mesh's data axes carry no serving meaning, and the serving
    runtime refuses them (``serve.engine.check_data_axis_serving``).  A
    mesh whose non-model axes are all 1 is returned as it is; any other
    becomes the flat ``("data", "model")`` view of shape ``(1, n)`` over
    the same ranks in the same order (a new ``DeviceMesh``: every rank of
    the mesh must call this)."""
    if mesh is None:
        return None
    names = tuple(mesh.mesh_dim_names or ())
    if all(n == 1 for a, n in zip(names, mesh.shape) if a != "model"):
        return mesh
    from torch.distributed.device_mesh import DeviceMesh
    ranks = mesh.mesh.flatten().reshape(1, -1)
    return DeviceMesh(mesh.device_type, ranks,
                      mesh_dim_names=("data", "model"))

def validate_rl(rl: RLConfig) -> RLConfig:
    """The reference's checks of a plan's RL leg (``HyperPlan.validate``):
    PlanError for a loop GRPO cannot learn from."""
    if rl.group_size < 2:
        raise PlanError(
            f"rl.group_size={rl.group_size}: group-relative (GRPO) "
            "advantages need >= 2 samples per prompt — a singleton group's "
            "advantage is identically zero")
    if rl.prompts_per_iter < 1 or rl.max_new_tokens < 1:
        raise PlanError(
            f"rl leg needs prompts_per_iter >= 1 and max_new_tokens >= 1, "
            f"got {rl.prompts_per_iter} / {rl.max_new_tokens}")
    if rl.temperature <= 0:
        raise PlanError(
            f"rl.temperature={rl.temperature}: rollouts must explore "
            "(temperature > 0); greedy rollouts collapse every group to one "
            "sample and GRPO advantages vanish")
    return rl


def _plan_legs(plan, mesh, rl_cfg, serve_cfg, roles):
    """The reference's resolution of an RL plan (``HyperPlan.coerce``,
    the RL and serving legs defaulted, ``validate`` against ``mesh``'s
    layout): (rl_cfg, serve_cfg, roles, the learner's ShardingPlan), each
    argument given winning over the plan's leg."""
    from repro_torch.api.plan import HyperPlan
    from repro_torch.core.layout import layout_for_mesh
    hp = HyperPlan.coerce(plan)
    if hp.rl is None:
        hp = hp.replace(rl=RLConfig())
    if hp.serve is None:
        hp = hp.replace(serve=ServeConfig())
    hp.validate(layout_for_mesh(mesh) if mesh is not None else None)
    return (rl_cfg or hp.rl_config(), serve_cfg or hp.serve_config(),
            roles if roles is not None else (hp.roles_dict() or None),
            hp.sharding_plan())


class RLSession:
    """GRPO with a :class:`GRPOLearner` and a :class:`RolloutEngine`
    serving the learner's params, one MoE dispatch for both: on ``device``
    (the card unless the caller names another), colocated on ``mesh``, or
    as the ``roles`` of the world's ranks (see the module docstring)."""

    def __init__(self, cfg, *, rl_cfg: Optional[RLConfig] = None,
                 serve_cfg: Optional[ServeConfig] = None, params=None,
                 adamw=None, seed: int = 0,
                 moe_dispatch: Optional[str] = None, device=None,
                 roles=None, plan=None, mesh=None):
        lplan = None
        if plan is not None:
            rl_cfg, serve_cfg, roles, lplan = _plan_legs(
                plan, mesh, rl_cfg, serve_cfg, roles)
        from repro_torch.train.steps import check_mesh_plan
        check_mesh_plan(mesh, None)       # PlanError: not a DeviceMesh
        if roles is not None and mesh is not None:
            raise PlanError("roles and mesh: a disaggregated session puts "
                            "each role on its own group's mesh; pass one")
        self.cfg = cfg
        self.rl_cfg = validate_rl(rl_cfg or RLConfig())
        self.serve_cfg = (serve_cfg or ServeConfig()).validate()
        device = resolve_device(device)
        from repro_torch.obs import Observability
        # one HyperTrace hub for the whole session: the actor engine, the
        # learner, the publisher and the scheduler all report into it
        self.obs = Observability()
        self.groups: Dict[str, mpmd.ProcessGroup] = {}
        if roles is not None:
            roles = dict(roles)
            if set(roles) != {"actor", "learner"}:
                raise PlanError(
                    f"RL roles must be exactly {{'actor', 'learner'}}, plan "
                    f"declares {sorted(roles)}")
            from repro_torch.launch.mesh import role_groups
            self.groups = role_groups(roles)
        learner_mesh = (self.groups["learner"].mesh if self.groups
                        else mesh)
        actor_mesh = serving_mesh_for(self.groups["actor"].mesh
                                      if self.groups else mesh)
        self._dp = dp_size(learner_mesh)
        # ONE dispatch for both sides: the learner's logprobs must be
        # computed under the same MoE routing the actor sampled with, or
        # the importance ratio starts biased
        md = resolve_moe_dispatch(cfg, moe_dispatch)
        on = {r: not self.groups or self.groups[r].has()
              for r in ("actor", "learner")}
        self.learner = self.actor = None
        if on["learner"]:
            self.learner = GRPOLearner(
                cfg, rl_cfg=self.rl_cfg, params=params, adamw=adamw,
                seed=seed, moe_dispatch=md, obs=self.obs, device=device,
                mesh=learner_mesh,
                plan=lplan if learner_mesh is not None else None)
        if on["actor"]:
            if self.learner is not None and (mesh is None or
                                             params is None):
                # the learner's own tensors (one device), or the full
                # params it drew (a mesh: gathered, every rank calling)
                from repro_torch.models.bridge import full_params
                aparams = full_params(self.learner.params)
            elif params is not None:
                aparams = params
            else:
                # drawn as the learner's ranks draw theirs
                import torch

                from repro_torch.models import model as M
                aparams = M.init_model(cfg, torch.Generator(
                    device=device).manual_seed(seed))
            self.actor = RolloutEngine(
                cfg, aparams, serve_cfg=self.serve_cfg, rl_cfg=self.rl_cfg,
                seed=seed, moe_dispatch=md, obs=self.obs, device=device,
                mesh=actor_mesh,
                plan=(lplan or ShardingPlan()).replace(fsdp=None)
                if actor_mesh is not None else None)
        self.sched = (mpmd.MPMDScheduler(self.groups, obs=self.obs,
                                         device=device)
                      if self.groups else None)
        self.buffer = RolloutBuffer(adv_eps=self.rl_cfg.adv_eps)
        self.history: List[Dict[str, float]] = []
        self.updates = 0

    # ------------------------------------------------------------------
    def _dispatch(self, role: str, fn, *args):
        if self.sched is not None:
            return self.sched.wait(self.sched.submit(role, fn, *args))[0]
        return fn(*args)

    def _share(self, role: str, fn):
        """``fn()`` on the ranks of ``role``; the value of the role's first
        rank on every rank of the session (no message without roles)."""
        if not self.groups:
            return fn()
        g = self.groups[role]
        return mpmd.share(fn() if g.has() else None, g.leader,
                          mpmd.union_ranks(self.groups))

    def _rollout(self, prompts, reward_fn):
        """Rollout and evaluation on the actor's ranks: (learner batch,
        rewards' mean, rollout tokens, rollout seconds)."""
        t0 = time.perf_counter()
        with self.obs.trace.span("rl.rollout", track="rl",
                                 prompts=len(prompts)):
            groups = [self.actor.submit_group(p) for p in prompts]
            self._dispatch("actor", self.actor.drain)
        t_roll = time.perf_counter() - t0
        self.buffer.clear()
        n_tok = 0
        rewards_all: List[float] = []
        with self.obs.trace.span("rl.evaluate", track="rl"):
            for g in groups:
                ros = self.actor.collect(g)
                rewards = [float(reward_fn(ro.prompt, ro.tokens))
                           for ro in ros]
                self.buffer.add_group(ros, rewards)
                rewards_all += rewards
                n_tok += sum(len(ro.tokens) for ro in ros)
                self.actor.release(g)   # bound engine memory on long loops
        # pad_len_to quantises the step's shape so its compile-ledger key
        # changes only when rollouts genuinely outgrow the previous length
        # bucket, not on every max-length wiggle across iterations
        batch = self.buffer.batch(pad_len_to=16, pad_rows_to=self._dp)
        return (batch, sum(rewards_all) / max(len(rewards_all), 1), n_tok,
                t_roll)

    def iterate(self, prompts: Sequence[Sequence[int]],
                reward_fn: RewardFn) -> Dict[str, float]:
        """One rollout -> advantage -> update -> publish cycle."""
        if self.actor is None:
            # the learner's ranks: the actor's rollout is a peer's task
            self._dispatch("actor", None)
        batch, reward_mean, n_tok, t_roll = self._share(
            "actor", lambda: self._rollout(prompts, reward_fn))
        if self.learner is None:
            self._dispatch("learner", None)
        metrics = self._share("learner", lambda: self._dispatch(
            "learner", self.learner.update, batch))
        t_pub = time.perf_counter()
        with self.obs.trace.span("rl.publish", track="rl",
                                 version=self.updates + 1):
            if self.groups and self.actor is None:
                # the learner's ranks send; the actor's take them in
                mpmd.transfer(self.learner.params, self.groups["learner"],
                              self.groups["actor"])
            elif self.groups:
                publish_across(self.groups["learner"], self.groups["actor"],
                               self.actor.publisher, wait=True)
            else:
                self.actor.publish(self.learner.params, wait=True)
        publish_s, version = self._share("actor", lambda: (
            time.perf_counter() - t_pub, self.actor.version))
        self.updates += 1
        metrics = dict(metrics)
        metrics.update({
            "reward_mean": reward_mean,
            "rollout_tokens": n_tok,
            "rollout_s": t_roll,
            "publish_s": publish_s,
            "weights_version": version,
        })
        m = self.obs.metrics
        m.counter("rl.iterations").inc()
        m.counter("rl.rollout_tokens").inc(n_tok)
        m.gauge("rl.reward_mean").set(metrics["reward_mean"])
        m.histogram("rl.rollout_s").observe(t_roll)
        self.history.append(metrics)
        return metrics

    def run(self, prompts_fn: Callable[[int], Sequence[Sequence[int]]],
            reward_fn: RewardFn, *, iterations: Optional[int] = None,
            hook: Optional[Callable[[Dict[str, float]], None]] = None):
        """``iterations`` cycles (default ``rl_cfg.iterations``).  Returns
        (params, history): the learner's params, or on an actor-only rank
        the ones it serves (the same values, published)."""
        n = iterations if iterations is not None else self.rl_cfg.iterations
        for it in range(n):
            m = self.iterate(prompts_fn(it), reward_fn)
            if hook:
                hook({"iter": it, **m})
        params = (self.learner.params if self.learner is not None
                  else self.actor.engine.params)
        return params, self.history

    # ------------------------------------------------------------------
    def rollout_greedy(self, prompt: Sequence[int],
                       max_new_tokens: int) -> List[int]:
        """Greedy probe through the actor (parity/eval; current weights)."""
        def probe():
            rid = self.actor.submit_probe(prompt, max_new_tokens)
            self.actor.drain()
            return self.actor.release_probe(rid)
        return self._share("actor", probe)

    def utilization_report(self) -> Dict[str, float]:
        """Per-role busy seconds (every role's, on every rank) of a
        disaggregated session; a colocated one has no roles, so this is
        empty."""
        return self.sched.utilization_report() if self.sched else {}

    def stats(self) -> Dict[str, float]:
        s = self._share("actor", lambda: self.actor.stats())
        s["learner_updates"] = self.updates
        return s
