"""Training loop: data -> step -> metrics -> checkpoints, on one device or
on a HyperShard mesh.

The reference's ``repro.train.trainer.train``, with its history keys, log
cadence and observability names: the ``train.step`` span, the
``train.steps`` counter, the ``train.step_s`` histogram (the host's time
around the step call: the card runs behind it, as jax's dispatch does in
the reference, until a log step reads the metrics back), the
``train.loss`` and ``train.grad_norm`` gauges, and the compile-ledger key
``("train_step", (B, S, moe_dispatch))``.  With an ``offload_cfg`` (or a
plan whose offload flags are set) that puts params or optimizer state on
the host, each step runs between the HyperOffload legs, spans
``train.fetch`` and ``train.offload`` inside ``train.step``.

``mesh=`` (a ``DeviceMesh``) and ``plan=`` (a
:class:`~repro_torch.core.hypershard.ShardingPlan`, the reference's legacy
path through :func:`resolve_train_plan`) train every family
sharded (``repro_torch.train.steps``); every rank runs this loop, the
loader gives each its rows, and checkpoints gather each leaf (rank 0
writes).  A ``HyperPlan`` is the facade's, ROADMAP.md section 1 item 8h,
and raises :class:`~repro_torch.api.errors.PlanError`.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable, Optional

import torch

from repro_torch.ckpt import checkpoint
from repro_torch.data.pipeline import DataConfig, make_loader
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.serve.runtime import resolve_device
from repro_torch.train import steps as steps_mod


@dataclasses.dataclass
class TrainConfig:
    num_steps: int = 100
    log_every: int = 10
    ckpt_every: int = 0                 # 0 => disabled
    ckpt_dir: str = dataclasses.field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(),
                                             "repro_ckpt"))
    seed: int = 0


def resolve_train_plan(mesh, plan, offload_cfg):
    """One resolution step, the reference's legacy path: (ShardingPlan |
    None, OffloadConfig | None) -> (the sharding plan, the offload config),
    the plan checked against ``mesh``
    (:func:`~repro_torch.train.steps.check_mesh_plan`) and its
    ``params_on_host`` / ``opt_state_on_host`` folded into the config, so
    one declaration drives both."""
    from repro_torch.core.offload import OffloadConfig
    plan = steps_mod.check_mesh_plan(mesh, plan)
    if plan is not None and (plan.params_on_host or plan.opt_state_on_host):
        base = offload_cfg or OffloadConfig()
        offload_cfg = dataclasses.replace(
            base, params_on_host=base.params_on_host or plan.params_on_host,
            opt_state_on_host=base.opt_state_on_host
            or plan.opt_state_on_host)
    return plan, offload_cfg


def train(cfg, shape, *, adamw: Optional[AdamWConfig] = None,
          train_cfg: Optional[TrainConfig] = None,
          moe_dispatch: str = "gshard", hook: Optional[Callable] = None,
          obs=None, device=None, plan=None, offload_cfg=None, mesh=None):
    """End-to-end training on ``device`` (the card unless the caller names
    another), on ``mesh`` under ``plan`` when given.  Returns (params,
    history); under a mesh the params are DTensors."""
    from repro_torch.obs import Observability
    plan, offload_cfg = resolve_train_plan(mesh, plan, offload_cfg)
    train_cfg = train_cfg or TrainConfig()
    device = resolve_device(device)
    obs = obs if obs is not None else Observability()
    adamw = adamw or AdamWConfig(total_steps=train_cfg.num_steps)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=shape.seq_len,
                      global_batch=shape.global_batch, seed=train_cfg.seed)

    step_fn = steps_mod.make_train_step(cfg, adamw,
                                        moe_dispatch=moe_dispatch, mesh=mesh,
                                        plan=plan)
    params, opt = steps_mod.init_state(cfg, seed=train_cfg.seed,
                                       device=device, mesh=mesh, plan=plan,
                                       offload_cfg=offload_cfg)

    loader = make_loader(dcfg, device, mesh=mesh)
    history = []
    needs_offload = offload_cfg is not None and (
        offload_cfg.params_on_host or offload_cfg.opt_state_on_host)
    obs.record_compile("train_step",
                       (shape.global_batch, shape.seq_len, moe_dispatch))
    t0 = time.perf_counter()
    for i, batch in zip(range(train_cfg.num_steps), loader):
        t_step = time.perf_counter()
        with obs.trace.span("train.step", track="train", step=i + 1):
            if needs_offload:
                with obs.trace.span("train.fetch", track="train"):
                    params, opt = steps_mod.fetch_state(params, opt,
                                                        offload_cfg, device)
            params, opt, metrics = step_fn(params, opt, batch)
            if needs_offload:
                with obs.trace.span("train.offload", track="train"):
                    params, opt = steps_mod.offload_state(params, opt,
                                                          offload_cfg)
        obs.metrics.counter("train.steps").inc()
        obs.metrics.histogram("train.step_s").observe(
            time.perf_counter() - t_step)
        if (i + 1) % train_cfg.log_every == 0 or i == 0:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = i + 1
            m["wall_s"] = time.perf_counter() - t0
            history.append(m)
            for k in ("loss", "grad_norm"):
                if k in m:
                    obs.metrics.gauge(f"train.{k}").set(m[k])
            if hook:
                hook(m)
        if train_cfg.ckpt_every and (i + 1) % train_cfg.ckpt_every == 0:
            _offload_done(device, needs_offload)
            checkpoint.save(train_cfg.ckpt_dir, i + 1, params, opt)
    _offload_done(device, needs_offload)
    return params, history


def _offload_done(device, needs_offload: bool) -> None:
    """Wait for the offload leg's asynchronous copies before the host
    reads the state it wrote."""
    if needs_offload and device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()
