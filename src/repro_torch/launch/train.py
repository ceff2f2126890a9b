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
section 1 item 8h), ``--plan pipeline``, ``pipeline_fsdp`` and
``--pipeline`` the 1F1B pipeline's (item 8f): they raise
:class:`~repro_torch.api.errors.PlanError`.  Rank 0 prints the
reference's log line.
"""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch.api.errors import PlanError
from repro_torch.configs.base import SHAPES, ShapeConfig, get_config
from repro_torch.core.hypershard import ShardingPlan
from repro_torch.core.offload import OffloadConfig
from repro_torch.launch.mesh import join_mesh
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.trainer import TrainConfig, train

FACADE = "(ROADMAP.md section 1 item 8h: the facade)"
PIPELINE = "(ROADMAP.md section 1 item 8f: the 1F1B pipeline)"
# the ShardingPlans the reference's presets lower to (repro.api.plans)
PLANS = {"fsdp_tp": ShardingPlan(), "tp_only": ShardingPlan(fsdp=None)}


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
                    help="pipeline-parallel 1F1B (not ported yet)")
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

    for given, flag, item in (
            (args.plan == "offload_all", "--plan offload_all", FACADE),
            (args.plan.startswith("pipeline"), f"--plan {args.plan}",
             PIPELINE),
            (args.pipeline, "--pipeline", PIPELINE),
            (args.explain, "--explain", FACADE)):
        if given:
            raise PlanError(f"{flag}: not ported yet {item}")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
        shape = ShapeConfig("reduced", 64, 4, "train")
    else:
        shape = SHAPES[args.shape]
    if args.global_batch is not None:
        shape = dataclasses.replace(shape, global_batch=args.global_batch)

    mesh, device = (join_mesh(args.device) if args.mesh == "auto"
                    else (None, args.device))
    rank0 = mesh is None or mesh.get_rank() == 0

    def log(m):
        if rank0:
            print(f"step {m['step']:5d}  loss {m['loss']:.4f}  "
                  f"grad_norm {m['grad_norm']:.3f}  lr {m['lr']:.2e}  "
                  f"{m['wall_s']:.1f}s", flush=True)

    try:
        train(cfg, shape,
              adamw=AdamWConfig(lr=args.lr, total_steps=args.steps),
              train_cfg=TrainConfig(
                  num_steps=args.steps, log_every=10,
                  ckpt_every=args.steps if args.ckpt_dir else 0,
                  **({"ckpt_dir": args.ckpt_dir} if args.ckpt_dir else {})),
              moe_dispatch=args.moe_dispatch, hook=log, device=device,
              mesh=mesh, plan=PLANS[args.plan],
              offload_cfg=(OffloadConfig(params_on_host=True,
                                         opt_state_on_host=True)
                           if args.offload else None))
    except RuntimeError as e:
        if "no CUDA device" in str(e):
            raise SystemExit(str(e))
        raise
    finally:
        if mesh is not None:
            import torch.distributed as dist
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
