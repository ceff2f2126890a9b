"""Serving launcher of the port: fixed-batch generation (the dense
``Generator``) or the HyperServe continuous-batching runtime.

    python -m repro_torch.launch.serve --arch qwen2-0.5b --batch 4 \
        --prompt-len 16 --max-new 32              # fixed batch, on the card
    python -m repro_torch.launch.serve --arch qwen2-0.5b --continuous \
        --requests 8 --max-new 16 [--kernels composed]   # on the card
    python -m repro_torch.launch.serve --arch qwen2-0.5b --reduced \
        --continuous --device cpu                 # plain versions, CPU
    python -m repro_torch.launch.serve --arch deepseek-v2-lite-16b \
        --continuous                              # MLA + MoE, on the card
    python -m repro_torch.launch.serve --arch mamba2-370m \
        --continuous --slots 16 --prefill-chunk 256   # SSD, on the card
    python -m repro_torch.launch.serve --arch recurrentgemma-2b \
        --continuous --slots 16 --num-blocks 2048 \
        --prefill-chunk 256                       # RG-LRU + local attention

``--mesh auto`` with ``--continuous`` serves tensor-parallel on the
``(1, world)`` mesh over the launcher's ranks (``torchrun``; gloo with
``--device cpu``, NCCL on the cards), every rank running the same
requests and rank 0 printing; one rank means no mesh::

    torchrun --nproc-per-node 2 -m repro_torch.launch.serve \
        --arch qwen2-0.5b --reduced --continuous --device cpu --mesh auto

Every family serves so, under ``--kernels fused`` or ``composed``: the
MLA and MoE archs with their latent pool replicated and their experts
split over ``model``, internvl2-26b and musicgen-large text-only (as the
reference's HyperServe, which passes no prefix).  The fixed batch on a
mesh is the facade's
``Supernode.generate`` (ROADMAP.md section 1 item 8h) and exits naming
it.

``--disaggregate`` serves on at least two ranks with prefill and decode on
separate role groups (HyperMPMD): the prefill group takes half the ranks,
rounded up, and the decode group the rest, as the reference's
``serve_disagg`` preset balances them; the prefill ranks run the dense
prefill of every prompt and hand its KV pages to the decode ranks' pool.
One rank exits naming the rule::

    torchrun --nproc-per-node 2 -m repro_torch.launch.serve \
        --arch qwen2-0.5b --reduced --continuous --device cpu --disaggregate

``--arch`` takes every ported config (``configs.list_archs()``): the dense
qwen2-0.5b and llama3-8b, the MoE deepseek-v2-lite-16b (with MLA),
deepseek-moe-16b and moonshot-v1-16b-a3b, the attention-free
mamba2-370m (SSD, per-seat state: it takes no pages) and the hybrid
recurrentgemma-2b (RG-LRU seat state beside sliding-window attention
pages, freed once out of the window).  The flags are the reference
launcher's (``repro.launch.serve``) plus
``--device``.  Weights are random, drawn from a seeded ``torch.Generator``
on the serving device.  ``--explain`` needs the facade the port does not
have yet (ROADMAP.md) and exits with a message naming it.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from repro_torch.api.errors import PlanError
from repro_torch.configs.base import ServeConfig, get_config
from repro_torch.launch.mesh import join_mesh, join_world, role_groups
from repro_torch.models import model as M
from repro_torch.serve.api import HyperServe
from repro_torch.serve.engine import GenerateConfig, Generator
from repro_torch.serve.runtime import resolve_device


def serve_config(args) -> ServeConfig:
    return ServeConfig(block_size=args.block_size,
                       num_blocks=args.num_blocks,
                       max_blocks_per_req=max(
                           4, -(-(args.prompt_len + args.max_new)
                                // args.block_size) + 1),
                       max_slots=args.slots,
                       prefill_chunk=args.prefill_chunk,
                       kernels=args.kernels)


def run_fixed(gen, args):
    prompts = torch.ones((args.batch, args.prompt_len), dtype=torch.long)
    t0 = time.perf_counter()
    out = gen.generate(prompts, GenerateConfig(
        max_new_tokens=args.max_new, temperature=args.temperature)).cpu()
    dt = time.perf_counter() - t0
    n_new = args.batch * args.max_new
    print(f"generated {n_new} tokens in {dt:.2f}s "
          f"({n_new / dt:.1f} tok/s on {gen.device})")
    print("first sequence:", out[0].tolist())


def run_continuous(serve, cfg, args, log=print):
    rng = np.random.default_rng(0)
    rids = []
    t0 = time.perf_counter()
    for _ in range(args.requests):
        plen = int(rng.integers(4, args.prompt_len + 1))
        prompt = rng.integers(1, cfg.vocab_size, size=plen).tolist()
        rids.append(serve.submit(prompt, int(rng.integers(
            args.max_new // 2, args.max_new + 1)),
            temperature=args.temperature))
        # stagger arrivals: interleave a couple of engine steps per submit
        for _ in range(2):
            serve.step_once()
    out = serve.join()
    if serve.engine.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    st = serve.stats()
    n_new = sum(len(out[r]) for r in rids)
    mesh = serve.engine.mesh
    where = str(serve.engine.device) + (
        "" if mesh is None else f", mesh {tuple(mesh.shape)}")
    pg = getattr(serve.engine, "prefill_group", None)
    if pg is not None:
        dg = serve.engine.decode_group
        where += (f", prefill ranks {list(pg.ranks)}, decode ranks "
                  f"{list(dg.ranks)}")
    log(f"served {len(rids)} requests, {n_new} tokens in {dt:.2f}s "
        f"({n_new / dt:.1f} tok/s on {where})")
    log(f"peak-free blocks={st['free_blocks']} "
        f"preemptions={st['preemptions']} prefix_hits={st['prefix_hits']}")
    log("first request tokens:", out[rids[0]])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4,
                    help="batch of fixed-batch generation")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--window", type=int, default=0,
                    help="sliding-window decode cache of fixed-batch "
                         "generation (0: none)")
    # HyperServe runtime
    ap.add_argument("--continuous", action="store_true",
                    help="continuous batching over the paged KV pool")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--num-blocks", type=int, default=256)
    ap.add_argument("--prefill-chunk", type=int, default=32)
    ap.add_argument("--kernels", default="auto",
                    choices=("auto", "fused", "composed"),
                    help="paged attention lowering: the fused kernels "
                         "(auto), or composed (gather the tables, then the "
                         "dense kernels)")
    ap.add_argument("--disaggregate", action="store_true",
                    help="prefill/decode role split over the ranks "
                         "(torchrun, >= 2 ranks; implies --continuous)")
    ap.add_argument("--explain", action="store_true",
                    help="plan resolution report (not ported yet)")
    ap.add_argument("--trace", metavar="PATH", default=None,
                    help="capture a HyperTrace timeline and write "
                         "Perfetto/Chrome trace_event JSON here")
    ap.add_argument("--metrics", action="store_true",
                    help="print the Prometheus metrics dump after the run")
    ap.add_argument("--device", default=None,
                    help="serving device (default: the CUDA card; pass "
                         "'cpu' to run the kernels' plain versions there)")
    ap.add_argument("--mesh", default="none", choices=["none", "auto"],
                    help="auto: serve tensor-parallel on the (1, world) "
                         "mesh over torchrun's ranks (--continuous only)")
    args = ap.parse_args(argv)

    if args.disaggregate:
        args.continuous = True
        if args.mesh == "auto":
            raise SystemExit("--disaggregate carves the ranks into role "
                             "groups itself: drop --mesh auto")
        if int(os.environ.get("WORLD_SIZE", "1")) < 2:
            raise SystemExit("--disaggregate needs >= 2 devices: one rank "
                             "a device (torchrun --nproc-per-node N, N >= 2)")
    not_ported = [(args.explain, "--explain needs the HyperPlan facade "
                   "(ROADMAP.md section 1 item 8h)"),
                  (args.mesh == "auto" and not args.continuous,
                   "--mesh auto without --continuous: the fixed batch on a "
                   "mesh is the facade's Supernode.generate (ROADMAP.md "
                   "section 1 item 8h)")]
    for flag, why in not_ported:
        if flag:
            raise SystemExit(f"not ported yet: {why}")
    groups = None
    if args.disaggregate:
        mesh, device = None, join_world(args.device)
        groups = role_groups((("prefill", 0), ("decode", 0)))
    else:
        mesh, device = (join_mesh(args.device) if args.mesh == "auto"
                        else (None, args.device))
    try:
        _serve(args, mesh, device, groups)
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()


def _serve(args, mesh, device, groups=None):
    """The launcher's run on ``device`` (on every rank of ``mesh``, or of
    the prefill and decode ``groups``)."""
    try:
        device = resolve_device(device)
    except RuntimeError as e:
        raise SystemExit(str(e))
    from repro_torch.core.mpmd import my_rank
    log = print if my_rank() == 0 else (lambda *a, **k: None)
    disagg = ({} if groups is None else
              dict(prefill_group=groups["prefill"],
                   decode_group=groups["decode"]))

    try:
        cfg = get_config(args.arch)
    except KeyError as e:                  # unknown, or not ported yet
        raise SystemExit(e.args[0])
    if args.reduced:
        cfg = cfg.reduced()
    try:
        params = M.init_model(
            cfg, torch.Generator(device=device).manual_seed(0))
        if args.continuous:
            runner = HyperServe(cfg, params, serve_cfg=serve_config(args),
                                device=device, mesh=mesh, **disagg)
            obs = runner.obs()
        else:
            runner = Generator(
                cfg, params, max_len=args.prompt_len + args.max_new + 8,
                window_override=args.window or None, device=device)
            obs = runner.obs
    except (PlanError, NotImplementedError) as e:
        # typed validation: the message already names the rule
        raise SystemExit(f"{type(e).__name__}: {e}")
    if args.trace:
        obs.trace.enable()
    try:
        if args.continuous:
            run_continuous(runner, cfg, args, log)
        else:
            run_fixed(runner, args)
    finally:
        if args.trace:
            # export validates the payload before writing (assert inside)
            log(f"trace: {obs.trace.export(args.trace)} "
                f"({len(obs.trace.events())} events, "
                f"{obs.trace.dropped} dropped)")
        if args.metrics:
            log(obs.metrics.dump_prometheus(), end="")


if __name__ == "__main__":
    main()
