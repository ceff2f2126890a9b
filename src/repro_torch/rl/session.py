"""RLSession: actor + learner colocated on one device.

The port of ``repro.rl.session``.  The reference resolves its session
from a ``Supernode`` and a ``HyperPlan`` (the learner's fsdp/tp sharding,
the actor's serving knobs, the RL loop and optionally an actor/learner
device split); the port has no facade yet (ROADMAP.md section 1 item 8h),
so the session takes those legs directly, colocated on one device, and
asking for roles (the reference's ``rl_disagg``) or a plan raises
:class:`~repro_torch.api.errors.PlanError`.  Each :meth:`iterate` is one
sample-evaluate-update cycle:

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
from repro_torch.rl.buffer import RolloutBuffer
from repro_torch.rl.learner import GRPOLearner
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

NOT_PORTED = ("actor/learner roles are ROADMAP.md section 1 item 8e "
              "(mpmd groups and disaggregation), a learner on a mesh item "
              "8d, plans the facade's item 8h")


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


class RLSession:
    """Colocated GRPO on one device (the card unless ``device`` names
    another): a :class:`GRPOLearner` and a :class:`RolloutEngine` serving
    the learner's params, one MoE dispatch for both."""

    def __init__(self, cfg, *, rl_cfg: Optional[RLConfig] = None,
                 serve_cfg: Optional[ServeConfig] = None, params=None,
                 adamw=None, seed: int = 0,
                 moe_dispatch: Optional[str] = None, device=None,
                 roles=None, plan=None, mesh=None):
        given = sorted(k for k, v in (("roles", roles), ("plan", plan),
                                      ("mesh", mesh)) if v is not None)
        if given:
            raise PlanError(f"{', '.join(given)}: not ported yet; "
                            f"{NOT_PORTED}")
        self.cfg = cfg
        self.rl_cfg = validate_rl(rl_cfg or RLConfig())
        self.serve_cfg = (serve_cfg or ServeConfig()).validate()
        device = resolve_device(device)
        # ONE dispatch for both sides: the learner's logprobs must be
        # computed under the same MoE routing the actor sampled with, or
        # the importance ratio starts biased
        md = resolve_moe_dispatch(cfg, moe_dispatch)
        self.learner = GRPOLearner(cfg, rl_cfg=self.rl_cfg, params=params,
                                   adamw=adamw, seed=seed, moe_dispatch=md,
                                   device=device)
        # one HyperTrace hub for the whole session: the actor engine, the
        # learner and the publisher all report into it
        self.obs = self.learner.obs
        self.actor = RolloutEngine(cfg, self.learner.params,
                                   serve_cfg=self.serve_cfg,
                                   rl_cfg=self.rl_cfg, seed=seed,
                                   moe_dispatch=md, obs=self.obs,
                                   device=device)
        self.buffer = RolloutBuffer(adv_eps=self.rl_cfg.adv_eps)
        self.history: List[Dict[str, float]] = []

    # ------------------------------------------------------------------
    def iterate(self, prompts: Sequence[Sequence[int]],
                reward_fn: RewardFn) -> Dict[str, float]:
        """One rollout -> advantage -> update -> publish cycle."""
        t0 = time.perf_counter()
        with self.obs.trace.span("rl.rollout", track="rl",
                                 prompts=len(prompts)):
            groups = [self.actor.submit_group(p) for p in prompts]
            self.actor.drain()
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
        batch = self.buffer.batch(pad_len_to=16,
                                  pad_rows_to=self.learner.dp_size())

        metrics = self.learner.update(batch)
        t_pub = time.perf_counter()
        with self.obs.trace.span("rl.publish", track="rl",
                                 version=self.actor.version + 1):
            self.actor.publish(self.learner.params, wait=True)
        metrics.update({
            "reward_mean": sum(rewards_all) / max(len(rewards_all), 1),
            "rollout_tokens": n_tok,
            "rollout_s": t_roll,
            "publish_s": time.perf_counter() - t_pub,
            "weights_version": self.actor.version,
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
        """``iterations`` cycles (default ``rl_cfg.iterations``)."""
        n = iterations if iterations is not None else self.rl_cfg.iterations
        for it in range(n):
            m = self.iterate(prompts_fn(it), reward_fn)
            if hook:
                hook({"iter": it, **m})
        return self.learner.params, self.history

    # ------------------------------------------------------------------
    def rollout_greedy(self, prompt: Sequence[int],
                       max_new_tokens: int) -> List[int]:
        """Greedy probe through the actor (parity/eval; current weights)."""
        rid = self.actor.submit_probe(prompt, max_new_tokens)
        self.actor.drain()
        return self.actor.release_probe(rid)

    def utilization_report(self) -> Dict[str, float]:
        """Per-role busy seconds of a disaggregated session; a colocated
        one has no roles, so this is empty."""
        return {}

    def stats(self) -> Dict[str, float]:
        s = self.actor.stats()
        s["learner_updates"] = self.learner.updates
        return s
