"""RL post-training launcher of the port: HyperRL on one device.

Colocated actor/learner (the only plan one device has):

    python -m repro_torch.launch.rl --arch qwen2-0.5b \
        --iters 3 --prompts 2 --group-size 4 --max-new 8    # on the card
    python -m repro_torch.launch.rl --arch qwen2-0.5b --reduced \
        --iters 2 --device cpu                  # plain versions, CPU

The flags are the reference launcher's (``repro.launch.rl``) plus
``--device`` (default: the card).  The toy reward scores token diversity
(distinct tokens per rollout) — enough within-group variance to give GRPO
a gradient, and you can watch ``reward_mean`` move while
``weights_version`` ticks once per iteration.  Weights are random, drawn
from a seeded ``torch.Generator`` on the device.  ``--plan rl_disagg``
(actor and learner on separate device groups) and ``--explain`` (the
plan resolution report) need the multi-device facade and exit with a
message naming ROADMAP.md section 1 items 8e and 8h.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.api.errors import PlanError
from repro_torch.configs.base import RLConfig, ServeConfig, get_config
from repro_torch.models import model as M
from repro_torch.rl import RLSession
from repro_torch.serve.runtime import resolve_device

DISAGG = "ROADMAP.md section 1 item 8e: mpmd groups and disaggregation"
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
    args = ap.parse_args(argv)

    if args.plan == "rl_disagg":
        raise SystemExit("PlanError: --plan rl_disagg puts actor and learner "
                         f"on separate device groups: not ported yet "
                         f"({DISAGG})")
    if args.explain:
        raise SystemExit("--explain needs the HyperPlan facade: not ported "
                         f"yet ({FACADE})")
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(str(e))

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    scfg, rcfg = rl_configs(args)
    try:
        params = M.init_model(
            cfg, torch.Generator(device=device).manual_seed(args.seed))
        rl = RLSession(cfg, rl_cfg=rcfg, serve_cfg=scfg, params=params,
                       seed=args.seed, device=device)
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
        print(f"iter {m['iter']}: loss={m['loss']:+.4f} "
              f"reward={m['reward_mean']:.2f} "
              f"rollout {m['rollout_tokens']} tok in {m['rollout_s']:.2f}s "
              f"publish {m['publish_s']*1e3:.1f}ms "
              f"v{int(m['weights_version'])}", flush=True)

    try:
        rl.run(prompts_fn, reward_fn, iterations=args.iters, hook=hook)
        st = rl.stats()
        print(f"done: {int(st['tokens_generated'])} rollout tokens, "
              f"{int(st['learner_updates'])} updates, "
              f"weights v{int(st['weights_version'])}")
    finally:
        if args.trace:
            tr = rl.obs.trace
            print(f"trace: {tr.export(args.trace)} "
                  f"({len(tr.events())} events, {tr.dropped} dropped)")


if __name__ == "__main__":
    main()
