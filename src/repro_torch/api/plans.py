"""Named HyperPlan presets — the strategy algebra's standard library.

The port of ``repro.api.plans``: the same presets under the same names,
lowering to the same engine configs.

Each preset is a function returning a fully-formed :class:`HyperPlan`;
keyword overrides pass straight through ``HyperPlan.replace``, so
``plans.fsdp_tp(params_on_host=True)`` composes a preset with extra
intent (HyperParallel-Mpipe's "small algebra + one resolution step").

Presets register by name for CLI / config-file lookup::

    plans.get("serve_disagg")()         # same as plans.serve_disagg()
    plans.names()                       # all registered presets
"""
from __future__ import annotations

from typing import Callable, Dict

from repro_torch.api.plan import HyperPlan
from repro_torch.configs.base import (FabricConfig, PipelineConfig, RLConfig,
                                      ServeConfig)

_REGISTRY: Dict[str, Callable[..., HyperPlan]] = {}


def register(fn: Callable[..., HyperPlan]) -> Callable[..., HyperPlan]:
    _REGISTRY[fn.__name__] = fn
    return fn


def get(name: str) -> Callable[..., HyperPlan]:
    if name not in _REGISTRY:
        raise KeyError(f"unknown plan preset {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def names():
    return tuple(sorted(_REGISTRY))


# ---------------------------------------------------------------------------
@register
def fsdp_tp(**over) -> HyperPlan:
    """Training default: tensor parallel over `model`, ZeRO-3 over pod+data."""
    return HyperPlan(name="fsdp_tp").replace(**over)


@register
def tp_only(**over) -> HyperPlan:
    """TP-sharded weights, replicated over the batch axes (small models)."""
    return HyperPlan(fsdp=None, name="tp_only").replace(**over)


@register
def serve(**over) -> HyperPlan:
    """Inference default: TP weights, dp on batch, no fsdp (see ServePlanError
    in serve/runtime.py for why fsdp and decode do not mix)."""
    return HyperPlan(fsdp=None, serve=ServeConfig(),
                     name="serve").replace(**over)


@register
def serve_disagg(n_prefill: int = 0, n_decode: int = 0, **over) -> HyperPlan:
    """Prefill/decode role disaggregation (HyperMPMD §3.3).

    Device counts of 0 auto-balance over the session's devices at
    resolution time (prefill gets floor(n/2), decode the rest).  Serving
    knobs ride on the ``serve=`` field, same as every preset.
    """
    return HyperPlan(fsdp=None, serve=ServeConfig(),
                     roles=(("prefill", n_prefill), ("decode", n_decode)),
                     name="serve_disagg").replace(**over)


@register
def rl_colocate(**over) -> HyperPlan:
    """RL post-training, actor and learner colocated on ONE mesh
    (paper §3.3c).  The sharding axes describe the learner (fsdp_tp
    default); the actor's serving leg derives fsdp=None from the same
    plan, and weight publication reshards learner->actor layout in place
    (zero-copy rebind when the layouts coincide)."""
    return HyperPlan(serve=ServeConfig(), rl=RLConfig(),
                     name="rl_colocate").replace(**over)


@register
def rl_disagg(n_actor: int = 0, n_learner: int = 0, **over) -> HyperPlan:
    """RL post-training with actor/learner role disaggregation
    (HyperMPMD Fig. 4c): rollouts stream on the actor submesh while the
    learner submesh updates; weight publication crosses role groups via
    ``core.mpmd.transfer``.  Device counts of 0 auto-balance."""
    return HyperPlan(serve=ServeConfig(), rl=RLConfig(),
                     roles=(("actor", n_actor), ("learner", n_learner)),
                     name="rl_disagg").replace(**over)


@register
def fabric(replicas: int = 2, **over) -> HyperPlan:
    """Multi-tenant serving fabric (HyperFabric): ``replicas`` HyperServe
    engines on distinct submeshes carved from one Supernode, fronted by a
    router with per-tenant SLO classes, weighted-fair admission, CoW
    prefix-affinity routing and elastic drain/activate.  Fabric knobs ride
    on ``fabric=``; per-replica serving knobs on ``serve=`` as usual."""
    return HyperPlan(fsdp=None, serve=ServeConfig(),
                     fabric=FabricConfig(replicas=replicas),
                     name="fabric").replace(**over)


@register
def pipeline(stages: int = 2, micro_batches: int = 4, **over) -> HyperPlan:
    """Pipeline-parallel training (HyperParallel-Mpipe): ``stages``
    contiguous layer stages on disjoint submeshes under the synchronous
    1F1B schedule, tensor parallel over each stage submesh's ``model``
    axis, no fsdp (the small-stage default).  Stage/micro knobs ride on
    ``pipeline=``; ``plans.pipeline(stages=4, micro_batches=8)``."""
    return HyperPlan(fsdp=None,
                     pipeline=PipelineConfig(stages=stages,
                                             micro_batches=micro_batches),
                     name="pipeline").replace(**over)


@register
def pipeline_fsdp(stages: int = 2, micro_batches: int = 4,
                  **over) -> HyperPlan:
    """Pipeline stages with ZeRO-3-style fsdp x tp INSIDE each stage's
    submesh: params shard over the stage's ``data`` axis and tensor-
    parallel over its ``model`` axis — the paper's algebraic composition
    of pipeline with the intra-stage strategies.  Set
    ``pipeline=PipelineConfig(stage_mesh=(d, m))`` to pin the per-stage
    (data, model) factoring."""
    return HyperPlan(pipeline=PipelineConfig(stages=stages,
                                             micro_batches=micro_batches),
                     name="pipeline_fsdp").replace(**over)


@register
def offload_all(**over) -> HyperPlan:
    """HyperOffload maximal: params + optimizer state + activations on host."""
    return HyperPlan(params_on_host=True, opt_state_on_host=True,
                     activation_offload=True,
                     name="offload_all").replace(**over)


@register
def offload_graph(**over) -> HyperPlan:
    """HyperMem graph-driven residency: per-leaf tiers + a layer-keyed
    prefetch schedule derived from the graph walk (repro_torch.mem).  Budgets
    default to unbounded — set {hbm,host,disk}_budget_bytes to constrain;
    explain() reports every leaf's tier, prefetch slot, and rule."""
    return HyperPlan(offload_policy="graph",
                     name="offload_graph").replace(**over)
