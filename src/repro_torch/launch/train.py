"""Training launcher of the port: the single-device train loop.

    python -m repro_torch.launch.train --arch qwen2-0.5b \
        [--shape train_4k] [--global-batch 4] [--steps 100]   # on the card
    python -m repro_torch.launch.train --arch qwen2-0.5b --reduced \
        --steps 2 --device cpu                     # plain versions, CPU

The reference launcher's flags that one card can honour (``--arch``,
``--shape``, ``--reduced``, ``--steps``, ``--lr``, ``--ckpt-dir``,
``--moe-dispatch``), plus ``--device`` (default: the card) and
``--global-batch``, the single-card stand-in for the mesh's data axis.
Every arch trains, the two recurrent ones (mamba2-370m, recurrentgemma-2b)
through the SSD and RG-LRU scans' backward kernels; the MoE archs
(deepseek-v2-lite-16b, deepseek-moe-16b, moonshot-v1-16b-a3b) under the
default ``--moe-dispatch gshard`` or under ``ragged``, whose grouped
matmuls run their forward and backward kernels.  internvl2-26b and musicgen-large train
without their prefix here, as the reference's launcher does (the prefix
enters through ``make_train_step(multimodal=True)``).
Weights are random, drawn from a seeded ``torch.Generator`` on the
device; the data is the reference's synthetic corpus.  ``--plan`` other
than the single-device default, ``--offload``, ``--pipeline``, ``--mesh
auto`` and ``--explain`` need the multi-device facade and raise
:class:`~repro_torch.api.errors.PlanError` naming ROADMAP.md section 1
item 8.  The log line is the reference's.
"""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch.api.errors import PlanError
from repro_torch.configs.base import SHAPES, ShapeConfig, get_config
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.trainer import TrainConfig, train

MULTI_DEVICE = "(ROADMAP.md section 1 item 8: multi-device, then the facade)"


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
                    help="HyperPlan training preset; on one device only "
                         "the default (fsdp_tp, which resolves to the "
                         "single device) is ported")
    ap.add_argument("--offload", action="store_true",
                    help="HyperOffload: params+opt state on host; a "
                         "HyperPlan in the reference, not ported yet (the "
                         "library's train(offload_cfg=) takes the legs)")
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

    for given, flag in ((args.plan != "fsdp_tp", f"--plan {args.plan}"),
                        (args.offload, "--offload"),
                        (args.pipeline, "--pipeline"),
                        (args.mesh == "auto", "--mesh auto"),
                        (args.explain, "--explain")):
        if given:
            raise PlanError(f"{flag}: not ported yet {MULTI_DEVICE}")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
        shape = ShapeConfig("reduced", 64, 4, "train")
    else:
        shape = SHAPES[args.shape]
    if args.global_batch is not None:
        shape = dataclasses.replace(shape, global_batch=args.global_batch)

    def log(m):
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
              moe_dispatch=args.moe_dispatch, hook=log, device=args.device)
    except RuntimeError as e:
        if "no CUDA device" in str(e):
            raise SystemExit(str(e))
        raise


if __name__ == "__main__":
    main()
