"""Supernode: the session facade — "one logical computer" (paper §2.3).

The port of ``repro.api.session``.  A :class:`Supernode` owns the device
matrix (mesh construction, role carving) and exposes the whole framework
behind its verbs::

    session = Supernode.auto()                  # or Supernode((1, 4))
    params, hist = session.train(cfg, shape, plan=plans.fsdp_tp())
    serve = session.serve(cfg, params, plan=plans.serve_disagg())
    fab   = session.fabric(cfg, params, plan=plans.fabric(replicas=2))
    out   = session.generate(cfg, params, prompts, max_new_tokens=16)
    print(session.explain(plans.offload_all(), cfg))

Every entry point resolves the declarative :class:`HyperPlan` exactly once
(validated eagerly, typed ``PlanError`` on failure) and hands the lowered
``ShardingPlan`` / ``OffloadConfig`` / ``ServeConfig`` / process groups to
the engines.

The reference is one controller over every device; the port runs one
process a rank, so a session's device matrix is the ranks of the
``torch.distributed`` world, a card each (the CPU under gloo), and every
rank builds the same session and calls the same verbs in the same order.
A session runs on the card unless the caller names the CPU
(``device="cpu"``).  Without a process group the session is one device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple, Union

from repro_torch.api.errors import PlanError, TopologyError
from repro_torch.api.explain import SINGLE_DEVICE_LAYOUT, PlanReport, explain
from repro_torch.api.plan import HyperPlan
from repro_torch.core.layout import Layout, layout_for_mesh

_DEFAULT_AXES = {1: ("model",), 2: ("data", "model"),
                 3: ("pod", "data", "model")}


@dataclasses.dataclass(frozen=True)
class Resolution:
    """Everything a HyperPlan lowers to, resolved once per entry point."""
    plan: HyperPlan
    sharding: object            # core.hypershard.ShardingPlan
    offload: object             # core.offload.OffloadConfig
    serve: object               # configs.base.ServeConfig
    groups: Dict[str, object]   # role name -> mpmd.ProcessGroup


def _world_size() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


class Supernode:
    """Session over one device matrix; all mesh construction lives here.

    ``topology`` may be:
      - ``None``           single device, no mesh (the world's ranks stay
                           available to role groups and the fabric's carve)
      - a shape tuple      ``(2, 16, 16)`` -> axes ("pod", "data", "model")
      - a dict             ``{"data": 2, "model": 4}``
      - a ``SupernodeSpec`` (core.topology) for the production matrices
      - an existing ``DeviceMesh`` via ``Supernode(mesh=...)``

    A topology of more than one device needs an initialised process group
    of at least as many ranks (every rank builds the session); the mesh
    spans the world's first ranks.  ``device``: the card unless the caller
    names another (``"cpu"``); the engines the verbs build run there.
    """

    def __init__(self, topology=None, *,
                 axis_names: Optional[Tuple[str, ...]] = None, mesh=None,
                 device=None):
        from repro_torch.core.topology import SupernodeSpec

        self.device = device
        self.mesh = mesh
        self.layout: Optional[Layout] = None
        if mesh is not None:
            self.layout = layout_for_mesh(mesh)
            return
        if topology is None:
            return
        if isinstance(topology, SupernodeSpec):
            shape, names = topology.mesh_shape, topology.axis_names
        elif isinstance(topology, dict):
            names, shape = tuple(topology), tuple(topology.values())
        else:
            shape = tuple(int(n) for n in topology)
            names = tuple(axis_names) if axis_names else _DEFAULT_AXES.get(
                len(shape))
            if names is None:
                raise TopologyError(
                    f"no default axis names for rank-{len(shape)} topology "
                    f"{shape}; pass axis_names=")
        if len(names) != len(shape):
            raise TopologyError(f"topology {shape} and axis_names {names} "
                                "must have equal rank")
        need, have = math.prod(shape), _world_size()
        if need > have:
            raise TopologyError(
                f"topology {shape} needs {need} devices, have {have} (start "
                f"{need} ranks, a device each, with torchrun "
                "--nproc-per-node; gloo ranks emulate them on the CPU)")
        import torch
        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh
        if not dist.is_initialized():
            raise TopologyError(
                f"topology {shape} needs an initialised process group "
                "(torch.distributed.init_process_group)")
        kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
        self.layout = Layout(shape, names)
        self.mesh = DeviceMesh(kind, torch.arange(need).reshape(shape),
                               mesh_dim_names=names)

    @classmethod
    def auto(cls, device=None) -> "Supernode":
        """All the world's ranks: one device and no mesh for one rank, else
        one model axis, the ``(1, world)`` mesh of
        :func:`repro_torch.launch.mesh.join_mesh` (which joins the process
        group from torchrun's environment when it is not joined yet)."""
        import torch.distributed as dist

        from repro_torch.launch.mesh import join_mesh, make_host_mesh
        if dist.is_initialized():
            mesh = make_host_mesh((1, 1)) if _world_size() > 1 else None
        else:
            mesh, device = join_mesh(device)
        return cls(mesh=mesh, device=device)

    def obs(self):
        """The session's HyperTrace hub (lazy; shared by every engine this
        session builds, so serve/RL/train render as one timeline)."""
        from repro_torch.obs import Observability
        if not hasattr(self, "_obs"):
            self._obs = Observability()
        return self._obs

    # ------------------------------------------------------------------
    @property
    def num_devices(self) -> int:
        """The session's devices: its mesh's ranks, else the world's."""
        return self.mesh.size() if self.mesh is not None else _world_size()

    def __repr__(self) -> str:
        if self.layout is None:
            return f"Supernode(single-device, {self.num_devices} available)"
        return (f"Supernode({self.layout.device_matrix} / "
                f"{self.layout.alias_name})")

    # ------------------------------------------------------------------
    # plan resolution (the one place intent becomes placements)
    # ------------------------------------------------------------------
    def resolve(self, plan: Union[None, HyperPlan, object] = None, *,
                for_serving: bool = False) -> Resolution:
        hp = HyperPlan.coerce(plan, for_serving=for_serving)
        hp.validate(self.layout)
        return Resolution(plan=hp, sharding=hp.sharding_plan(),
                          offload=hp.offload_config(),
                          serve=hp.serve_config(),
                          groups=self._role_groups(hp))

    def _role_groups(self, hp: HyperPlan) -> Dict[str, object]:
        """The plan's roles carved from the session's ranks
        (:func:`repro_torch.launch.mesh.auto_roles`: a count of 0
        auto-balances the remainder, the reference's rule and errors)."""
        roles = hp.roles_dict()
        if not roles:
            return {}
        from repro_torch.core import mpmd
        from repro_torch.launch.mesh import auto_roles
        return mpmd.groups_from_mapping(auto_roles(roles, self.num_devices))

    def groups(self, mapping: Dict[str, int], **kw) -> Dict[str, object]:
        """Carve named process groups from the session's ranks (paper
        Listing 1 node-to-module mapping; every rank calls this)."""
        from repro_torch.core import mpmd
        return mpmd.groups_from_mapping(mapping, **kw)

    def scheduler(self, groups: Dict[str, object]):
        """MPMD scheduler over the given groups."""
        from repro_torch.core import mpmd
        return mpmd.MPMDScheduler(groups, obs=self.obs())

    # ------------------------------------------------------------------
    # verbs
    # ------------------------------------------------------------------
    def train(self, cfg, shape, *, plan: Union[None, HyperPlan, object] = None,
              adamw=None, train_cfg=None, steps: Optional[int] = None,
              moe_dispatch: str = "gshard", hook=None):
        """End-to-end training under the resolved plan; (params, history)."""
        from repro_torch.train import trainer
        hp = HyperPlan.coerce(plan)
        if train_cfg is None:
            train_cfg = trainer.TrainConfig(num_steps=steps or 100)
        elif steps is not None:
            train_cfg = dataclasses.replace(train_cfg, num_steps=steps)
        if hp.pipeline is not None:
            # Mpipe leg: stage groups carved from the session's ranks,
            # 1F1B over core/mpmd — not a single SPMD program
            from repro_torch.train import pipeline_trainer
            hp.validate(self.layout)
            return pipeline_trainer.train_pipeline(
                cfg, shape, pipeline=hp.pipeline_config(), plan=hp,
                adamw=adamw, train_cfg=train_cfg, moe_dispatch=moe_dispatch,
                hook=hook, obs=self.obs(), device=self.device)
        if hp.roles:
            raise PlanError(
                f"plan declares mpmd roles {hp.roles_dict()} but "
                "session.train runs one SPMD program; roles drive serve() "
                "(prefill/decode) and rl() (actor/learner) — drop them or "
                "use groups()/scheduler() for custom MPMD training")
        # trainer.train performs the (single) validation + lowering step
        return trainer.train(cfg, shape, mesh=self.mesh, plan=hp,
                             adamw=adamw, train_cfg=train_cfg,
                             moe_dispatch=moe_dispatch, hook=hook,
                             obs=self.obs(), device=self.device)

    def serve(self, cfg, params, *,
              plan: Union[None, HyperPlan, object] = None, seed: int = 0):
        """Continuous-batching HyperServe runtime under the resolved plan
        (MoE archs serve through the ragged dispatch, as the reference's
        default)."""
        from repro_torch.serve.api import HyperServe
        res = self.resolve(plan, for_serving=True)
        groups = res.groups
        if groups and set(groups) != {"prefill", "decode"}:
            raise PlanError(
                f"serving roles must be exactly {{'prefill', 'decode'}}, "
                f"plan declares {sorted(groups)}")
        return HyperServe(cfg, params, serve_cfg=res.serve,
                          mesh=None if groups else self.mesh, plan=res.plan,
                          prefill_group=groups.get("prefill"),
                          decode_group=groups.get("decode"),
                          seed=seed, obs=self.obs(), device=self.device)

    def fabric(self, cfg, params, *,
               plan: Union[None, HyperPlan, object] = None, seed: int = 0):
        """Multi-tenant serving fabric (HyperFabric): N HyperServe replicas
        on rank groups carved from this session's devices (colocated in
        this process on one device), fronted by a
        :class:`~repro_torch.fabric.router.Router` with SLO-class
        weighted-fair dispatch, prefix-affinity routing and elastic scale.
        Plans without a fabric leg get the default carve
        (``plans.fabric(replicas=2)`` spells it out)."""
        from repro_torch.configs.base import FabricConfig
        from repro_torch.fabric.router import Router
        hp = HyperPlan.coerce(plan, for_serving=True)
        if hp.fabric is None:
            hp = hp.replace(fabric=FabricConfig())
        hp.validate(self.layout)
        return Router.build(self, cfg, params, hp, seed=seed)

    def rl(self, cfg, *, plan: Union[None, HyperPlan, object] = None,
           params=None, adamw=None, seed: int = 0,
           moe_dispatch: Optional[str] = None):
        """RL post-training session (HyperRL, paper §3.3c): a continuous-
        batching rollout actor, a GRPO learner and the version-counted
        weight-publication path between them, resolved from ONE plan
        (``plans.rl_colocate()`` / ``plans.rl_disagg()``).  ``params``
        seeds the policy (e.g. the tree ``session.train`` returned);
        None initialises fresh under the plan's layouts."""
        from repro_torch.rl.session import RLSession
        hp = HyperPlan.coerce(plan)
        return RLSession(cfg, plan=hp, params=params, adamw=adamw, seed=seed,
                         moe_dispatch=moe_dispatch, device=self.device,
                         mesh=None if hp.roles else self.mesh)

    def generate(self, cfg, params, prompts, *, max_new_tokens: int = 16,
                 temperature: float = 0.0, max_len: Optional[int] = None,
                 window_override: Optional[int] = None,
                 plan: Union[None, HyperPlan, object] = None, seed: int = 0):
        """Fixed-batch generation (prefill + sequential decode) on one
        device; on a mesh it raises :class:`PlanError` (the port's
        ``Generator`` takes no mesh yet: the last slice)."""
        import torch

        from repro_torch.serve.engine import GenerateConfig, Generator
        if self.mesh is not None:
            raise PlanError(
                "Supernode.generate on a mesh: the port's Generator takes no "
                "mesh yet (ROADMAP.md section 1 item 8h, the last slice: "
                "Generator(mesh=)); serve on the mesh through "
                "Supernode.serve")
        self.resolve(plan, for_serving=True)
        prompts = torch.as_tensor(prompts, dtype=torch.int64)
        if prompts.ndim == 1:
            prompts = prompts[None, :]
        gen = Generator(cfg, params,
                        max_len=max_len or prompts.shape[1] + max_new_tokens
                        + 8, window_override=window_override,
                        obs=self.obs(), device=self.device)
        return gen.generate(prompts, GenerateConfig(
            max_new_tokens=max_new_tokens, temperature=temperature,
            seed=seed))

    def explain(self, plan: Union[None, HyperPlan, object], cfg, *,
                batch: int = 1, cache_len: Optional[int] = None,
                strict: bool = False, for_serving: bool = False) -> PlanReport:
        """Resolution report: every param/opt/cache leaf with spec, memory
        kind and the rule that fired.  ``for_serving=True`` additionally
        reports the HyperServe StatePool leaves with their paged / slot /
        windowed state kind.  ``strict=True`` raises
        :class:`IndivisibleError` on any silent-replication fallback."""
        hp = HyperPlan.coerce(plan, for_serving=for_serving)
        report = explain(hp, cfg, self.layout or SINGLE_DEVICE_LAYOUT,
                         batch=batch, cache_len=cache_len,
                         serving=for_serving)
        return report.raise_on_fallback() if strict else report
