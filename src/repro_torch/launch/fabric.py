"""HyperFabric launcher of the port — a multi-tenant serving fabric through
the session API: N HyperServe replicas on carved rank groups (colocated on
one card), SLO-class weighted-fair dispatch, prefix-affinity routing,
elastic scale.

    python -m repro_torch.launch.fabric --arch qwen2-0.5b \
        --replicas 2 --requests 12 --max-new 16 [--elastic]   # on the card
    python -m repro_torch.launch.fabric --arch qwen2-0.5b --reduced \
        --device cpu [--explain]                   # plain versions, CPU
    torchrun --nproc-per-node 4 -m repro_torch.launch.fabric \
        --arch qwen2-0.5b --reduced --device cpu   # 2 replicas of 2 ranks

The flags are the reference launcher's (``repro.launch.fabric``) plus
``--device`` (default: the card).  A mixed two-tenant workload is
synthesised: ``chat`` (interactive SLO, short prompts sharing a common
system prefix — exercises affinity) and ``bulk`` (batch SLO, long
prompts).  ``--explain`` prints the resolution report including the
replica->rank-group carve rows and exits.  Weights are random, drawn from
a seeded ``torch.Generator`` on the device.  Under ``torchrun`` every rank
runs the same router calls (``Supernode.auto()`` joins the world; each
replica's engine lives on its group's ranks) and rank 0 prints.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.api import PlanError, Supernode, plans
from repro_torch.configs.base import (FabricConfig, ServeConfig, TenantSpec,
                                      get_config)
from repro_torch.core.mpmd import my_rank
from repro_torch.models import model as M
from repro_torch.serve.runtime import resolve_device


def fabric_plan(args):
    scfg = ServeConfig(block_size=args.block_size,
                       num_blocks=args.num_blocks,
                       max_slots=args.slots,
                       prefill_chunk=args.prefill_chunk)
    fcfg = FabricConfig(
        replicas=args.replicas,
        split=tuple(int(s) for s in args.split.split(",")) if args.split
        else (),
        tenants=(TenantSpec("chat", slo="interactive"),
                 TenantSpec("bulk", slo="batch")),
        max_pending=args.max_pending,
        elastic=args.elastic)
    return plans.fabric(serve=scfg, fabric=fcfg)


def run(session, cfg, params, args, log=print):
    fab = session.fabric(cfg, params, plan=fabric_plan(args))
    rng = np.random.default_rng(0)
    system = rng.integers(1, cfg.vocab_size,
                          size=2 * args.block_size).tolist()
    # warm the shared system prompt: prefix blocks are retained at request
    # FINISH, so one completed chat request seeds the CoW cache the rest
    # of the chat traffic can affinity-route to
    fab.submit(system + [7, 9], 2, tenant="chat")
    fab.join()
    fids = []
    t0 = time.perf_counter()
    for i in range(args.requests):
        if i % 3 == 2:   # every third request is bulk traffic
            plen = int(rng.integers(24, 48))
            prompt = rng.integers(1, cfg.vocab_size, size=plen).tolist()
            fids.append(fab.submit(prompt, args.max_new, tenant="bulk"))
        else:            # chat shares the system prompt -> affinity routing
            tail = rng.integers(1, cfg.vocab_size, size=6).tolist()
            fids.append(fab.submit(system + tail, args.max_new,
                                   tenant="chat"))
        fab.step()       # stagger arrivals one router step apart
    out = fab.join()
    dt = time.perf_counter() - t0
    st = fab.stats()
    n_new = sum(len(out[f]) for f in fids)
    log(f"fabric served {len(fids)} requests ({n_new} tokens) over "
        f"{st['active_replicas']} active replicas in {dt:.2f}s "
        f"({n_new/dt:.1f} tok/s on this host)")
    log(f"dispatched={st['dispatched']} affinity_hits="
        f"{st['affinity_hits']} rejected={st['rejected']} "
        f"scale_up={st['scale_up']} scale_down={st['scale_down']}")
    chat = [f for f in fids if fab.request_meta(f)["tenant"] == "chat"]
    ttfts = [fab.request_meta(f)["ttft_steps"] for f in chat]
    log(f"chat (interactive) TTFT in router steps: {ttfts}")
    return fab


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--split", default="",
                    help="explicit devices per replica, e.g. '4,2' "
                         "(heterogeneous carve; each count must divide "
                         "the model dims, e.g. vocab); empty = even split")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-pending", type=int, default=64)
    ap.add_argument("--elastic", action="store_true",
                    help="drain idle replicas / re-activate on queue depth")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--num-blocks", type=int, default=256)
    ap.add_argument("--prefill-chunk", type=int, default=32)
    ap.add_argument("--explain", action="store_true",
                    help="print the plan resolution report (incl. the "
                         "replica->rank-group carve) and exit")
    ap.add_argument("--trace", metavar="PATH", default=None,
                    help="write a Perfetto/Chrome trace of the front door")
    ap.add_argument("--metrics", action="store_true",
                    help="print the Prometheus metrics dump after the run")
    ap.add_argument("--device", default=None,
                    help="serving device (default: the CUDA card; pass "
                         "'cpu' to run the kernels' plain versions there)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.explain:
        try:
            print(Supernode(device=args.device).explain(
                fabric_plan(args), cfg, batch=args.slots, for_serving=True))
        except PlanError as e:
            raise SystemExit(f"{type(e).__name__}: {e}")
        return
    session = Supernode.auto(device=args.device)
    log = print if my_rank() == 0 else (lambda *a, **k: None)
    obs = session.obs()
    if args.trace:
        obs.trace.enable()
    try:
        try:
            device = resolve_device(session.device)
        except RuntimeError as e:
            raise SystemExit(str(e))
        params = M.init_model(cfg, torch.Generator(device=device)
                              .manual_seed(0))
        run(session, cfg, params, args, log)
    except PlanError as e:
        raise SystemExit(f"{type(e).__name__}: {e}")
    finally:
        if args.trace:
            log(f"trace: {obs.trace.export(args.trace)} "
                f"({len(obs.trace.events())} events, "
                f"{obs.trace.dropped} dropped)")
        if args.metrics:
            log(obs.metrics.dump_prometheus(), end="")
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
