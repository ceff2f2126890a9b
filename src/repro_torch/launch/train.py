"""Training launcher of the port: the train loop on one device or on a
HyperShard mesh.

    python -m repro_torch.launch.train --arch qwen2-0.5b \
        [--shape train_4k] [--global-batch 4] [--steps 100]   # on the card
    python -m repro_torch.launch.train --arch qwen2-0.5b --reduced \
        --steps 2 --device cpu                     # plain versions, CPU
    torchrun --nproc-per-node 2 -m repro_torch.launch.train \
        --arch qwen2-0.5b --reduced --device cpu --mesh auto   # gloo mesh

The reference launcher's flags (``--arch``, ``--shape``, ``--reduced``,
``--steps``, ``--lr``, ``--plan``, ``--offload``, ``--mesh``,
``--ckpt-dir``, ``--moe-dispatch``), plus ``--device`` (default: the
card) and ``--global-batch``, the single-card stand-in for the mesh's
data axis.  Every arch trains on one device, the two recurrent ones
(mamba2-370m, recurrentgemma-2b) through the SSD and RG-LRU scans'
backward kernels; the MoE archs (deepseek-v2-lite-16b, deepseek-moe-16b,
moonshot-v1-16b-a3b) under the default ``--moe-dispatch gshard`` or under
``ragged``, whose grouped matmuls run their forward and backward kernels.
internvl2-26b and musicgen-large train without their prefix here, as the
reference's launcher does (the prefix enters through
``make_train_step(multimodal=True)``).  Weights are random, drawn from a
seeded ``torch.Generator`` on the device; the data is the reference's
synthetic corpus.

``--mesh auto`` under ``torchrun`` (which sets ``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK`` and the rendezvous address) joins the process group, NCCL
on the card (each rank on its ``LOCAL_RANK`` card) and gloo with
``--device cpu``, and trains on a ``(1, world)`` mesh; one rank means no
mesh, as the reference's ``Supernode.auto()`` gives.  Every arch trains
so: the dense GQA, MLA and MoE archs under either ``--moe-dispatch``
(``dp_local`` is a library dispatch, ``make_train_step(moe_dispatch=
"dp_local")``, as in the reference), mamba2-370m and recurrentgemma-2b
with both scans' backwards on each rank's shards, internvl2-26b and
musicgen-large without their prefix, as on one device (the prefix on a
mesh is ``make_train_step(multimodal=True, mesh=)`` with
``data.pipeline.place_prefix``).  ``--plan fsdp_tp``
and ``tp_only`` resolve to the ``ShardingPlan`` those presets lower to;
``--offload`` puts params and optimizer state on the host, on a mesh too.
``--plan offload_all`` and ``--explain`` are the facade's (ROADMAP.md
section 1 item 8h): they raise :class:`~repro_torch.api.errors.PlanError`.
Rank 0 prints the reference's log line.

``--pipeline STAGES`` (with ``--micro-batches M``, default 4) and ``--plan
pipeline|pipeline_fsdp`` train through the 1F1B pipeline trainer
(:func:`~repro_torch.train.pipeline_trainer.train_pipeline`; the presets
are 2 stages of 4 micro-batches unless ``--pipeline`` names the stages):
with one rank every stage runs in this process (colocated), under
``torchrun`` with ``--mesh auto`` the stages are carved from the world's
ranks (one group a stage when there are at least as many ranks as
stages; the world is joined, no mesh over it is made); ``--offload``
composes with both.  ``--ckpt-dir`` with a pipeline raises
:class:`~repro_torch.api.errors.PlanError`: checkpointing is not wired for
the pipeline, as in the reference.

    python -m repro_torch.launch.train --arch qwen2-0.5b --reduced \
        --steps 2 --device cpu --pipeline 2 --micro-batches 2
    torchrun --nproc-per-node 2 -m repro_torch.launch.train \
        --arch qwen2-0.5b --reduced --device cpu --mesh auto --pipeline 2
"""
from __future__ import annotations

import argparse
import dataclasses
import os

from repro_torch.api.errors import PlanError
from repro_torch.configs.base import (SHAPES, PipelineConfig, ShapeConfig,
                                      get_config)
from repro_torch.core.hypershard import ShardingPlan
from repro_torch.core.offload import OffloadConfig
from repro_torch.launch.mesh import join_mesh, join_world
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.pipeline_trainer import train_pipeline
from repro_torch.train.trainer import TrainConfig, train

FACADE = "(ROADMAP.md section 1 item 8h: the facade)"
# the ShardingPlans the reference's presets lower to (repro.api.plans), and
# the pipeline presets' (ShardingPlan, PipelineConfig)
PLANS = {"fsdp_tp": ShardingPlan(), "tp_only": ShardingPlan(fsdp=None)}
PIPELINE_PLANS = {"pipeline": (ShardingPlan(fsdp=None), PipelineConfig()),
                  "pipeline_fsdp": (ShardingPlan(), PipelineConfig())}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--plan", default="fsdp_tp",
                    choices=["fsdp_tp", "tp_only", "offload_all",
                             "pipeline", "pipeline_fsdp"],
                    help="HyperPlan training preset; fsdp_tp and tp_only "
                         "resolve to their ShardingPlans")
    ap.add_argument("--offload", action="store_true",
                    help="HyperOffload: params+opt state on host")
    ap.add_argument("--pipeline", type=int, default=0, metavar="STAGES",
                    help="Mpipe: pipeline-parallel 1F1B over STAGES stage "
                         "groups (adds a pipeline leg to the chosen plan)")
    ap.add_argument("--micro-batches", type=int, default=4,
                    help="micro-batches per step for --pipeline")
    ap.add_argument("--explain", action="store_true",
                    help="plan resolution report (not ported yet)")
    ap.add_argument("--moe-dispatch", default="gshard",
                    choices=["gshard", "ragged"])
    ap.add_argument("--mesh", default="none", choices=["none", "auto"])
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--global-batch", type=int, default=None,
                    help="rows a step; the single-card stand-in for the "
                         "mesh's data axis, over which the reference "
                         "spreads the shape's global batch (train_4k: 256 "
                         "rows of 4096 tokens, which one card cannot hold)")
    ap.add_argument("--device", default=None,
                    help="training device (default: the CUDA card; pass "
                         "'cpu' to run the kernels' plain versions there)")
    args = ap.parse_args(argv)

    for given, flag in ((args.plan == "offload_all", "--plan offload_all"),
                        (args.explain, "--explain")):
        if given:
            raise PlanError(f"{flag}: not ported yet {FACADE}")
    plan, pipeline = PIPELINE_PLANS.get(args.plan, (PLANS.get(args.plan),
                                                    None))
    if args.pipeline:
        pipeline = (pipeline or PipelineConfig()).replace(
            stages=args.pipeline)
    if pipeline is not None:
        pipeline = pipeline.replace(micro_batches=args.micro_batches)
        if args.ckpt_dir:
            raise PlanError("--ckpt-dir: checkpointing is not wired for the "
                            "pipeline, as in the reference")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
        shape = ShapeConfig("reduced", 64, 4, "train")
    else:
        shape = SHAPES[args.shape]
    if args.global_batch is not None:
        shape = dataclasses.replace(shape, global_batch=args.global_batch)

    import torch.distributed as dist
    mesh, device, joined = None, args.device, False
    if args.mesh == "auto" and pipeline is not None:
        # the stages are carved from the world's ranks: no mesh over it
        if int(os.environ.get("WORLD_SIZE", "1")) > 1:
            device, joined = join_world(device), True
    elif args.mesh == "auto":
        mesh, device = join_mesh(device)
        joined = mesh is not None
    rank0 = not joined or dist.get_rank() == 0

    def log(m):
        if rank0:
            print(f"step {m['step']:5d}  loss {m['loss']:.4f}  "
                  f"grad_norm {m['grad_norm']:.3f}  lr {m['lr']:.2e}  "
                  f"{m['wall_s']:.1f}s", flush=True)

    adamw = AdamWConfig(lr=args.lr, total_steps=args.steps)
    offload_cfg = (OffloadConfig(params_on_host=True, opt_state_on_host=True)
                   if args.offload else None)
    try:
        if pipeline is not None:
            train_pipeline(cfg, shape, pipeline=pipeline, plan=plan,
                           offload_cfg=offload_cfg, adamw=adamw,
                           train_cfg=TrainConfig(num_steps=args.steps,
                                                 log_every=10),
                           moe_dispatch=args.moe_dispatch, hook=log,
                           device=device)
        else:
            train(cfg, shape, adamw=adamw,
                  train_cfg=TrainConfig(
                      num_steps=args.steps, log_every=10,
                      ckpt_every=args.steps if args.ckpt_dir else 0,
                      **({"ckpt_dir": args.ckpt_dir} if args.ckpt_dir
                         else {})),
                  moe_dispatch=args.moe_dispatch, hook=log, device=device,
                  mesh=mesh, plan=plan, offload_cfg=offload_cfg)
    except RuntimeError as e:
        if "no CUDA device" in str(e):
            raise SystemExit(str(e))
        raise
    finally:
        if joined:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
