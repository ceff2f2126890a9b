"""HyperPlan: one frozen, declarative description of a supernode strategy.

The port of ``repro.api.plan``.  The paper treats the supernode as a
single logical computer whose parallel strategy is *declared*, not
implemented (HyperShard §3.4).  ``HyperPlan`` absorbs the four objects
the engines take — ``ShardingPlan``, ``OffloadConfig``, ``ServeConfig``
and the mpmd role splits — with one field each:

  - sharding intent  (tp / fsdp / dp axes, MoE weight placement)
  - memory-tier intent (HyperOffload §3.2: params / optimizer state /
    activations on host, per-layer streaming)
  - serving intent   (an embedded :class:`~repro_torch.configs.base.ServeConfig`)
  - MPMD role intent (paper Listing 1: ``roles`` name->device-count pairs,
    e.g. prefill/decode disaggregation)

and resolves once — ``sharding_plan()`` / ``offload_config()`` /
``serve_config()`` are pure lowerings consumed by the engines.  Memory-tier
placement lowers *exclusively* into the ``OffloadConfig`` leg (the
``ShardingPlan`` it emits always carries ``params_on_host=False``): the
steps stay on the device and the host<->device legs run between steps.

``validate()`` is the H2-style eager whole-plan check: unknown mesh axes,
inconsistent streaming knobs and malformed roles raise typed
:class:`~repro_torch.api.errors.PlanError` subclasses before any engine is
built.  The reference also refuses host offload on a backend without a
host memory kind; the port's host tier is pinned host memory, which
every PyTorch build has, so it has no such refusal.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

from repro_torch.api.errors import PlanError, UnknownAxisError
from repro_torch.configs.base import (FabricConfig, PipelineConfig, RLConfig,
                                      ServeConfig)
from repro_torch.core.hypershard import ShardingPlan
from repro_torch.core.layout import Layout
from repro_torch.core.offload import OffloadConfig

Axes = Optional[Tuple[str, ...]]

# Axis names a plan may reference beyond the live mesh: a plan written for
# the multi-pod production matrix degrades gracefully on smaller meshes by
# dropping these (e.g. "pod" on a single-pod run) — anything else is a typo.
WELL_KNOWN_AXES = frozenset({"pod", "data", "model"})


def _axes_tuple(v) -> Axes:
    if v is None:
        return None
    if isinstance(v, str):
        return (v,)
    return tuple(v)


@dataclasses.dataclass(frozen=True)
class HyperPlan:
    """The single declarative front door (frozen, so hashable)."""
    # -- sharding intent (HyperShard §3.4) ---------------------------------
    tp: Axes = ("model",)                  # tensor-parallel mesh axes
    fsdp: Axes = ("pod", "data")           # ZeRO-3-ish parameter sharding axes
    dp: Axes = ("pod", "data")             # batch axes
    moe_weights: str = "ep"                # "ep" | "dp" expert placement
    kv_seq_axes: Axes = None               # shard cache sequence (flash-decode)
    # -- memory-tier intent (HyperOffload §3.2) ----------------------------
    params_on_host: bool = False           # weights live in host memory
    opt_state_on_host: bool = False        # optimizer moments live on host
    activation_offload: bool = False       # remat-offload layer residuals
    stream_layers: bool = False            # per-layer fetch pipeline (unrolled)
    prefetch_depth: int = 2                # layers resident in HBM at once
    # HyperMem residency policy: "manual" keeps the flags above as the
    # source of truth; "graph" derives per-leaf tier + prefetch slot from
    # the graph walk (repro_torch.mem.plan_residency) under the per-tier byte
    # budgets below (0 = unbounded), and explain() reports every row
    offload_policy: str = "manual"         # "manual" | "graph"
    hbm_budget_bytes: int = 0              # HBM tier budget (0 = unbounded)
    host_budget_bytes: int = 0             # host-DRAM tier budget
    disk_budget_bytes: int = 0             # disk tier budget
    # -- serving intent ----------------------------------------------------
    serve: Optional[ServeConfig] = None    # paged pool + scheduler knobs
    # -- RL post-training intent (paper §3.3c) -----------------------------
    # the sharding axes above describe the LEARNER; the actor's serving leg
    # is derived (fsdp dropped — see rl/session.py)
    rl: Optional[RLConfig] = None          # rollout + GRPO update knobs
    # -- multi-tenant fabric intent (serving tier above HyperServe) --------
    # replica carve + SLO classes; the fabric owns the submesh split, so a
    # plan may set EITHER fabric or roles, never both
    fabric: Optional[FabricConfig] = None  # router + replica carve knobs
    # -- pipeline-parallel training intent (HyperParallel-Mpipe) -----------
    # contiguous layer stages on disjoint submeshes under synchronous 1F1B;
    # the pipeline owns the stage->submesh carve, so a plan may set EITHER
    # pipeline or fabric/roles, never both
    pipeline: Optional[PipelineConfig] = None
    # -- MPMD role intent (paper Listing 1) --------------------------------
    # ((name, device_count), ...); count 0 = auto-balance the remainder
    roles: Tuple[Tuple[str, int], ...] = ()
    name: str = ""                         # preset name, shown in reports

    def __post_init__(self):
        object.__setattr__(self, "tp", _axes_tuple(self.tp))
        object.__setattr__(self, "fsdp", _axes_tuple(self.fsdp))
        object.__setattr__(self, "dp", _axes_tuple(self.dp))
        object.__setattr__(self, "kv_seq_axes", _axes_tuple(self.kv_seq_axes))
        roles = self.roles
        if isinstance(roles, dict):
            roles = tuple(roles.items())
        object.__setattr__(self, "roles", tuple((str(n), int(c))
                                                for n, c in roles))

    def replace(self, **kw) -> "HyperPlan":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------------
    # coercion from the legacy objects (deprecation-shim entry points)
    # ------------------------------------------------------------------
    @classmethod
    def coerce(cls, plan: Union[None, "HyperPlan", ShardingPlan],
               *, for_serving: bool = False) -> "HyperPlan":
        """Lift a legacy ``ShardingPlan`` (or None) into a HyperPlan."""
        if plan is None:
            return cls(fsdp=None, name="serve-default") if for_serving else cls()
        if isinstance(plan, cls):
            return plan
        if isinstance(plan, ShardingPlan):
            return cls(tp=plan.tp, fsdp=plan.fsdp, dp=plan.dp,
                       moe_weights=plan.moe_weights,
                       kv_seq_axes=plan.kv_seq_axes,
                       params_on_host=plan.params_on_host,
                       opt_state_on_host=plan.opt_state_on_host,
                       activation_offload=plan.activation_offload,
                       name="legacy-sharding-plan")
        raise PlanError(f"cannot coerce {type(plan).__name__} into a HyperPlan")

    def absorb_offload(self, ocfg: OffloadConfig) -> "HyperPlan":
        """Fold a legacy ``OffloadConfig`` in (OR semantics on the booleans).

        Raises :class:`PlanError` when both sides pin ``prefetch_depth`` to
        different values — the one genuinely ambiguous double-spec.
        """
        depth = self.prefetch_depth
        default_depth = OffloadConfig.prefetch_depth
        if ocfg.prefetch_depth != default_depth:
            if depth != default_depth and depth != ocfg.prefetch_depth:
                raise PlanError(
                    f"conflicting prefetch_depth: plan={depth} vs legacy "
                    f"OffloadConfig={ocfg.prefetch_depth}; set it in ONE place "
                    "(the HyperPlan)")
            depth = ocfg.prefetch_depth
        policy = self.offload_policy
        if ocfg.policy != "manual":
            if policy != "manual" and policy != ocfg.policy:
                raise PlanError(
                    f"conflicting offload policy: plan={policy!r} vs legacy "
                    f"OffloadConfig={ocfg.policy!r}; set it in ONE place "
                    "(the HyperPlan)")
            policy = ocfg.policy
        budgets = {}
        for f in ("hbm_budget_bytes", "host_budget_bytes",
                  "disk_budget_bytes"):
            mine, theirs = getattr(self, f), getattr(ocfg, f)
            if theirs and mine and theirs != mine:
                raise PlanError(
                    f"conflicting {f}: plan={mine} vs legacy "
                    f"OffloadConfig={theirs}; set it in ONE place")
            budgets[f] = theirs or mine
        return self.replace(
            params_on_host=self.params_on_host or ocfg.params_on_host,
            opt_state_on_host=self.opt_state_on_host or ocfg.opt_state_on_host,
            activation_offload=(self.activation_offload
                                or ocfg.activations_to_host),
            stream_layers=self.stream_layers or ocfg.stream_layers,
            prefetch_depth=depth, offload_policy=policy, **budgets)

    # ------------------------------------------------------------------
    # lowerings (the single resolution step)
    # ------------------------------------------------------------------
    def sharding_plan(self) -> ShardingPlan:
        """Lower to the HyperShard engine's declaration.

        Memory-tier flags are deliberately NOT propagated: the steps run on
        the device (see module docstring); host placement is owned by
        :meth:`offload_config`.
        """
        return ShardingPlan(tp=self.tp, fsdp=self.fsdp, dp=self.dp,
                            moe_weights=self.moe_weights,
                            kv_seq_axes=self.kv_seq_axes,
                            params_on_host=False, opt_state_on_host=False,
                            activation_offload=self.activation_offload)

    def offload_config(self) -> OffloadConfig:
        return OffloadConfig(params_on_host=self.params_on_host,
                             opt_state_on_host=self.opt_state_on_host,
                             activations_to_host=self.activation_offload,
                             stream_layers=self.stream_layers,
                             prefetch_depth=self.prefetch_depth,
                             policy=self.offload_policy,
                             hbm_budget_bytes=self.hbm_budget_bytes,
                             host_budget_bytes=self.host_budget_bytes,
                             disk_budget_bytes=self.disk_budget_bytes)

    def serve_config(self) -> ServeConfig:
        return self.serve if self.serve is not None else ServeConfig()

    def rl_config(self) -> RLConfig:
        return self.rl if self.rl is not None else RLConfig()

    def fabric_config(self) -> FabricConfig:
        return self.fabric if self.fabric is not None else FabricConfig()

    def pipeline_config(self) -> PipelineConfig:
        return self.pipeline if self.pipeline is not None else PipelineConfig()

    def roles_dict(self) -> Dict[str, int]:
        return dict(self.roles)

    @property
    def wants_offload(self) -> bool:
        return (self.params_on_host or self.opt_state_on_host
                or self.activation_offload
                or (self.offload_policy == "graph"
                    and bool(self.host_budget_bytes
                             or self.disk_budget_bytes)))

    # ------------------------------------------------------------------
    # eager validation
    # ------------------------------------------------------------------
    def _axis_groups(self):
        return (("tp", self.tp), ("fsdp", self.fsdp), ("dp", self.dp),
                ("kv_seq_axes", self.kv_seq_axes))

    def validate(self, layout: Optional[Layout] = None) -> "HyperPlan":
        """Whole-plan consistency check; returns self so it chains.

        ``layout`` (when given) is the device matrix the plan must bind to.
        Axis-binding rules: an axis absent from the layout is tolerated only
        if it is a well-known larger-topology axis (``pod`` on a single-pod
        mesh) AND at least one axis of the group still binds — a group that
        binds nothing, or an axis outside the known vocabulary, is an
        :class:`UnknownAxisError` (a typo would otherwise silently
        replicate everything it was meant to shard).
        """
        if self.moe_weights not in ("ep", "dp"):
            raise PlanError(f"moe_weights must be 'ep' or 'dp', "
                            f"got {self.moe_weights!r}")
        if self.prefetch_depth < 1:
            raise PlanError(f"prefetch_depth must be >= 1, "
                            f"got {self.prefetch_depth}")
        if self.offload_policy not in ("manual", "graph"):
            raise PlanError(
                f"offload_policy must be 'manual' or 'graph', got "
                f"{self.offload_policy!r}")
        for f in ("hbm_budget_bytes", "host_budget_bytes",
                  "disk_budget_bytes"):
            if getattr(self, f) < 0:
                raise PlanError(f"{f} must be >= 0 (0 = unbounded), got "
                                f"{getattr(self, f)}")
        if self.offload_policy == "manual" and (
                self.hbm_budget_bytes or self.host_budget_bytes
                or self.disk_budget_bytes):
            raise PlanError(
                "per-tier byte budgets require offload_policy='graph' — "
                "under 'manual' the params_on_host/opt_state_on_host flags "
                "are the source of truth and the budgets would silently do "
                "nothing")
        if self.stream_layers and not self.params_on_host:
            raise PlanError("stream_layers=True without params_on_host=True: "
                            "per-layer streaming fetches host-resident "
                            "weights; enable params_on_host or drop "
                            "stream_layers")
        if self.serve is not None:
            # typed ServePlanError for zero/negative serving knobs (e.g. a
            # prefill_batch of 0 would silently schedule empty chunk
            # batches) — same check the runtime applies to bare ServeConfigs
            self.serve.validate()
        if self.rl is not None:
            if self.rl.group_size < 2:
                raise PlanError(
                    f"rl.group_size={self.rl.group_size}: group-relative "
                    "(GRPO) advantages need >= 2 samples per prompt — a "
                    "singleton group's advantage is identically zero")
            if self.rl.prompts_per_iter < 1 or self.rl.max_new_tokens < 1:
                raise PlanError(
                    f"rl leg needs prompts_per_iter >= 1 and max_new_tokens "
                    f">= 1, got {self.rl.prompts_per_iter} / "
                    f"{self.rl.max_new_tokens}")
            if self.rl.temperature <= 0:
                raise PlanError(
                    f"rl.temperature={self.rl.temperature}: rollouts must "
                    "explore (temperature > 0); greedy rollouts collapse "
                    "every group to one sample and GRPO advantages vanish")
            bad = {n for n, _ in self.roles} - {"actor", "learner"}
            if bad:
                raise PlanError(
                    f"an RL plan's roles must be drawn from "
                    f"{{'actor', 'learner'}}, got {sorted(bad)}")
        if self.fabric is not None:
            # typed FabricPlanError for malformed replica/tenant knobs —
            # caught here so a bad carve fails before any engine builds
            self.fabric.validate()
            if self.roles:
                raise PlanError(
                    "a plan may set EITHER fabric or roles, not both: the "
                    "fabric owns the replica->submesh carve, so an explicit "
                    f"MPMD role split {self.roles} would double-claim the "
                    "devices; drop one of the two legs")
        if self.pipeline is not None:
            # typed PipelinePlanError for malformed stage/micro-batch knobs
            self.pipeline.validate()
            if self.fabric is not None:
                raise PlanError(
                    "a plan may set EITHER pipeline or fabric, not both: "
                    "each owns its own devices->submesh carve (stage groups "
                    "vs replica groups), so the two legs would double-claim "
                    "the devices; train under the pipeline plan and serve "
                    "under a separate fabric plan")
            if self.roles:
                raise PlanError(
                    "a plan may set EITHER pipeline or roles, not both: the "
                    "pipeline leg carves one MPMD group per stage, so an "
                    f"explicit role split {self.roles} would double-claim "
                    "the devices; drop one of the two legs")
        seen = set()
        for rname, count in self.roles:
            if rname in seen:
                raise PlanError(f"duplicate role {rname!r} in plan roles")
            seen.add(rname)
            if count < 0:
                raise PlanError(f"role {rname!r} has negative device count "
                                f"{count} (use 0 for auto-balance)")
        vocab = WELL_KNOWN_AXES | (set(layout.alias_name) if layout else set())
        for gname, axes in self._axis_groups():
            if not axes:
                continue
            unknown = [a for a in axes if a not in vocab]
            if unknown:
                raise UnknownAxisError(
                    f"plan.{gname}={axes} references unknown mesh ax"
                    f"{'es' if len(unknown) > 1 else 'is'} {unknown}; known "
                    f"axes: {sorted(vocab)}")
            if layout is not None:
                bound = [a for a in axes if a in layout.alias_name]
                if not bound:
                    raise UnknownAxisError(
                        f"plan.{gname}={axes} binds to NO axis of the "
                        f"topology {layout.alias_name}; the intent would "
                        "silently replicate — fix the plan or the topology")
        return self

