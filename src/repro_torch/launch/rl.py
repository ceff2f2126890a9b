"""RL post-training launcher of the port: HyperRL.

Colocated actor/learner on one device, or on the ranks of ``torchrun``
(``--mesh auto``: the learner on the ``(1, world)`` mesh under fsdp_tp,
the actor on the same ranks), or as disaggregated roles (``--plan
rl_disagg``: the ranks split into an actor group and a learner group, the
actor taking half the ranks rounded up, as the reference's preset
balances them; the weights cross groups at every publish):

    python -m repro_torch.launch.rl --arch qwen2-0.5b \
        --iters 3 --prompts 2 --group-size 4 --max-new 8    # on the card
    python -m repro_torch.launch.rl --arch qwen2-0.5b --reduced \
        --iters 2 --device cpu                  # plain versions, CPU
    torchrun --nproc-per-node 2 -m repro_torch.launch.rl \
        --arch qwen2-0.5b --reduced --device cpu --plan rl_disagg

The flags are the reference launcher's (``repro.launch.rl``) plus
``--device`` (default: the card).  The toy reward scores token diversity
(distinct tokens per rollout) — enough within-group variance to give GRPO
a gradient, and you can watch ``reward_mean`` move while
``weights_version`` ticks once per iteration.  Weights are random, drawn
from a seeded ``torch.Generator`` on the device.  Rank 0 prints.
``--plan rl_disagg`` on one rank exits naming the rule (it needs >= 2
ranks); ``--explain`` (the plan resolution report) needs the facade and
exits naming ROADMAP.md section 1 item 8h.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from repro_torch.api.errors import PlanError
from repro_torch.configs.base import RLConfig, ServeConfig, get_config
from repro_torch.launch.mesh import join_mesh, join_world
from repro_torch.models import model as M
from repro_torch.rl import RLSession
from repro_torch.serve.runtime import resolve_device

FACADE = "ROADMAP.md section 1 item 8h: the facade"


def rl_configs(args):
    """(ServeConfig, RLConfig) from the flags, as the reference's
    ``rl_plan`` builds its plan's legs."""
    scfg = ServeConfig(block_size=args.block_size,
                       num_blocks=args.num_blocks,
                       max_blocks_per_req=max(
                           4, -(-(args.prompt_len + args.max_new)
                                // args.block_size) + 1),
                       max_slots=args.slots,
                       prefill_chunk=args.prefill_chunk,
                       enable_prefix_cache=False)
    rcfg = RLConfig(group_size=args.group_size,
                    prompts_per_iter=args.prompts,
                    max_new_tokens=args.max_new,
                    temperature=args.temperature,
                    lr=args.lr, iterations=args.iters)
    return scfg, rcfg


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--plan", default="rl_colocate",
                    choices=["rl_colocate", "rl_disagg"])
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--prompts", type=int, default=2,
                    help="prompt groups per iteration")
    ap.add_argument("--group-size", type=int, default=4,
                    help="GRPO samples per prompt")
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--seed", type=int, default=0)
    # serving-leg knobs (the actor's paged pool)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--block-size", type=int, default=8)
    ap.add_argument("--num-blocks", type=int, default=128)
    ap.add_argument("--prefill-chunk", type=int, default=16)
    ap.add_argument("--explain", action="store_true",
                    help="print the plan resolution report and exit (not "
                         "ported yet)")
    ap.add_argument("--trace", metavar="PATH", default=None,
                    help="capture a HyperTrace timeline and write "
                         "Perfetto/Chrome trace_event JSON here")
    ap.add_argument("--device", default=None,
                    help="device of actor and learner (default: the CUDA "
                         "card; pass 'cpu' to run the kernels' plain "
                         "versions there)")
    ap.add_argument("--mesh", default="none", choices=["none", "auto"],
                    help="auto: colocated GRPO on the (1, world) mesh over "
                         "torchrun's ranks")
    args = ap.parse_args(argv)

    if args.explain:
        raise SystemExit("--explain needs the HyperPlan facade: not ported "
                         f"yet ({FACADE})")
    disagg = args.plan == "rl_disagg"
    if disagg and args.mesh == "auto":
        raise SystemExit("--plan rl_disagg carves the ranks into role "
                         "groups itself: drop --mesh auto")
    if disagg and int(os.environ.get("WORLD_SIZE", "1")) < 2:
        raise SystemExit("PlanError: --plan rl_disagg puts actor and learner "
                         "on separate ranks: it needs >= 2 ranks (torchrun "
                         "--nproc-per-node N, N >= 2)")
    mesh = None
    if disagg:
        args.device = join_world(args.device)
    elif args.mesh == "auto":
        mesh, args.device = join_mesh(args.device)
    try:
        _run(args, mesh)
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()


def _run(args, mesh):
    """The launcher's GRPO loop (on every rank of ``mesh`` or of the
    roles)."""
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(str(e))
    from repro_torch.core.mpmd import my_rank
    log = print if my_rank() == 0 else (lambda *a, **k: None)
    roles = ({"actor": 0, "learner": 0} if args.plan == "rl_disagg"
             else None)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    scfg, rcfg = rl_configs(args)
    try:
        params = M.init_model(
            cfg, torch.Generator(device=device).manual_seed(args.seed))
        rl = RLSession(cfg, rl_cfg=rcfg, serve_cfg=scfg, params=params,
                       seed=args.seed, device=device, mesh=mesh, roles=roles)
    except PlanError as e:
        raise SystemExit(f"{type(e).__name__}: {e}")
    if args.trace:
        rl.obs.trace.enable()

    rng = np.random.default_rng(args.seed)

    def prompts_fn(_it):
        return [rng.integers(1, cfg.vocab_size,
                             size=args.prompt_len).tolist()
                for _ in range(args.prompts)]

    def reward_fn(prompt, tokens):
        return float(len(set(tokens)))     # diversity: distinct tokens

    def hook(m):
        log(f"iter {m['iter']}: loss={m['loss']:+.4f} "
            f"reward={m['reward_mean']:.2f} "
            f"rollout {m['rollout_tokens']} tok in {m['rollout_s']:.2f}s "
            f"publish {m['publish_s']*1e3:.1f}ms "
            f"v{int(m['weights_version'])}", flush=True)

    try:
        rl.run(prompts_fn, reward_fn, iterations=args.iters, hook=hook)
        util = rl.utilization_report()
        if util:
            log("per-role busy seconds:",
                {k: round(v, 3) for k, v in util.items()})
        st = rl.stats()
        log(f"done: {int(st['tokens_generated'])} rollout tokens, "
            f"{int(st['learner_updates'])} updates, "
            f"weights v{int(st['weights_version'])}")
    finally:
        if args.trace and my_rank() == 0:
            tr = rl.obs.trace
            print(f"trace: {tr.export(args.trace)} "
                  f"({len(tr.events())} events, {tr.dropped} dropped)")


if __name__ == "__main__":
    main()
