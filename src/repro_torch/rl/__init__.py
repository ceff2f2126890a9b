"""repro_torch.rl — HyperRL on one device: colocated RL post-training.

The port of ``repro.rl`` (paper §3.3c): a continuous-batching rollout
actor, a version-counted weight-publication path and a GRPO learner,
colocated on one device::

    from repro_torch.rl import RLSession
    rl = RLSession(cfg, rl_cfg=RLConfig(...), params=params)
    new_params, history = rl.run(prompts_fn, reward_fn)

The reference resolves the session through its ``Supernode`` facade and
can split actor and learner over device groups; they come with ROADMAP.md
section 1 items 8h and 8e.
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
