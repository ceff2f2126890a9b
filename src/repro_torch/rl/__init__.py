"""repro_torch.rl — HyperRL: RL post-training, colocated or as roles.

The port of ``repro.rl`` (paper §3.3c): a continuous-batching rollout
actor, a version-counted weight-publication path and a GRPO learner, on
one device, colocated on a mesh (the learner under fsdp_tp, the actor on
the same ranks' serving view), or as HyperMPMD roles on disjoint ranks::

    from repro_torch.rl import RLSession
    rl = RLSession(cfg, rl_cfg=RLConfig(...), params=params)
    # or RLSession(..., mesh=mesh) / RLSession(..., roles={"actor": 2,
    # "learner": 2}) on every rank of a torch.distributed world
    new_params, history = rl.run(prompts_fn, reward_fn)

The reference resolves the session through its ``Supernode`` facade
(ROADMAP.md section 1 item 8h); the port takes its legs directly.
"""
from repro_torch.configs.base import RLConfig
from repro_torch.rl.buffer import Rollout, RolloutBuffer, group_advantages
from repro_torch.rl.learner import GRPOLearner, grpo_loss, make_rl_step
from repro_torch.rl.publish import WeightPublisher
from repro_torch.rl.rollout import RolloutEngine, RolloutGroup
from repro_torch.rl.session import RLSession, serving_mesh_for

__all__ = [
    "RLConfig", "RLSession", "serving_mesh_for",
    "RolloutEngine", "RolloutGroup",
    "WeightPublisher",
    "RolloutBuffer", "Rollout", "group_advantages",
    "GRPOLearner", "grpo_loss", "make_rl_step",
]
