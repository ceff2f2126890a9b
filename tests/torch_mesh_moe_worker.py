"""One rank of a DeepSeek mesh run of the port (MLA and MoE), on the CPU
under gloo.

    python tests/torch_mesh_moe_worker.py RANK WORLD SPEC_JSON

``tests/test_torch_mesh_moe.py`` starts one fresh interpreter per rank,
each joining the process group through a ``FileStore`` file in the
test's temporary directory.  This module imports torch and the port only,
never JAX.  Params come from checkpoints and ``.npz`` files the test
writes (the reference's ``init_model`` / ``init_moe`` at seed 0, bridged).

The spec names the mesh shape, the cases and the tasks to run, in order:

- ``serve``: every serving case on the mesh under ``ShardingPlan(fsdp=
  None)``: each rank's greedy tokens and ``preemptions``, its pool and
  param leaves' local and global shapes, and the fallbacks ``derive_pool``
  and ``derive_param`` record;
- ``train``: for each dispatch of the spec, ``steps`` fsdp_tp train steps
  of reduced deepseek-v2-lite from the start checkpoint; rank 0 writes the
  history, and for gshard the final params in full; each rank its param
  shard shapes;
- ``ep``: ``ep_moe_shardmap`` on the ``(1, world)`` mesh at the spec's
  capacity factor, its output and the input's gradient of ``sum(y * w)``
  (rank 0 writes them);
- ``dp_local``: ``moe_forward(dispatch="dp_local")`` on a ``(world, 1)``
  and a ``(1, world)`` mesh over the same ranks (the expert weights placed
  by the ``dp`` rules, each rank's shard shapes reported), its output,
  gshard's with no mesh, and whether its gradients are finite and
  ``w_gate``'s nonzero (rank 0 writes);
- ``cm``: ``collective_matmul_allgather`` of the rows of x sharded over
  ``model`` against ``x @ w``;
- ``attention``: ``full_attention`` at MLA's reduced (Dk, Dv) = (96, 64)
  on the ``(1, world)`` mesh in ring mode (``flash_chunk``) and in head
  mode (flash under ``local_map``), its output and q, k, v gradients
  against the plain version's with no mesh;
- ``launcher``: after the worker's own group is gone, ``python -m
  repro_torch.launch.train --mesh auto --device cpu --reduced`` on
  deepseek-v2-lite (2 steps of 2 x 64 tokens) in this process,
  ``WORLD_SIZE``/``RANK``/``LOCAL_RANK`` and the rendezvous file set;
  rank 0 writes what it printed.
"""
import contextlib
import dataclasses
import io
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)

from repro_torch.ckpt import checkpoint  # noqa: E402
from repro_torch.configs.base import ServeConfig, get_config  # noqa: E402
from repro_torch.core import hypershard as hs  # noqa: E402
from repro_torch.core.layout import layout_for_mesh  # noqa: E402
from repro_torch.core.meshctx import full_tensor, use_mesh  # noqa: E402
from repro_torch.core.overlap import (collective_matmul_allgather,  # noqa: E402
                                      ep_moe_shardmap)
from repro_torch.core.tree import tree_flatten_with_path  # noqa: E402
from repro_torch.data.pipeline import DataConfig, make_loader  # noqa: E402
from repro_torch.launch.mesh import INIT_METHOD_ENV, make_host_mesh  # noqa: E402
from repro_torch.models import model as M, moe  # noqa: E402
from repro_torch.models.bridge import params_from_numpy, shard_params  # noqa: E402
from repro_torch.optim import adamw as opt  # noqa: E402
from repro_torch.serve.api import HyperServe  # noqa: E402
from repro_torch.train import steps  # noqa: E402

SERVE_PLAN = hs.ShardingPlan(fsdp=None)


def model(case):
    """(cfg, params) of a case: the reduced f32 config with the case's
    overrides, the params restored unsharded from its checkpoint."""
    cfg = dataclasses.replace(get_config(case["arch"]).reduced(),
                              dtype="float32", **case.get("overrides", {}))
    like = M.init_model(cfg, torch.Generator().manual_seed(0))
    return cfg, checkpoint.restore(case["ckpt"], 0, like)


def shapes(tree, derive, layout, plan):
    """Each leaf's [local shape, global shape], and the notes ``derive``
    records for it (only the leaves that have any)."""
    flat = tree_flatten_with_path(tree)
    notes = {k: list(derive(k, tuple(t.shape), layout, plan)[2])
             for k, t in flat}
    return ({k: [list(t.to_local().shape), list(t.shape)] for k, t in flat},
            {k: v for k, v in notes.items() if v})


def run_serve(spec, mesh):
    layout = layout_for_mesh(mesh)
    out = {}
    for name, case in spec["cases"].items():
        cfg, params = model(case)
        server = HyperServe(cfg, params, serve_cfg=ServeConfig(
            **case["scfg"]), mesh=mesh, plan=SERVE_PLAN, device="cpu")
        rids = [server.submit(p, n) for p, n in zip(case["prompts"],
                                                    case["max_new"])]
        got = server.join()
        pool, pool_fb = shapes(server.engine.pool.state, hs.derive_pool,
                               layout, SERVE_PLAN)
        par, par_fb = shapes(server.engine.params, hs.derive_param, layout,
                             SERVE_PLAN)
        out[name] = {"tokens": [got[r] for r in rids],
                     "preemptions": server.stats()["preemptions"],
                     "pool": pool, "pool_fallbacks": pool_fb,
                     "params": par, "param_notes": par_fb}
    return out


def flat_np(tree):
    return {k: full_tensor(v).detach().numpy()
            for k, v in tree_flatten_with_path(tree)}


def run_train(spec, mesh, rank):
    cfg = dataclasses.replace(get_config("deepseek-v2-lite-16b").reduced(),
                              dtype="float32")
    like = M.init_model(cfg, torch.Generator().manual_seed(0))
    out = {}
    for dispatch in spec["dispatches"]:
        step = steps.make_train_step(
            cfg, opt.AdamWConfig(total_steps=spec["steps"]),
            moe_dispatch=dispatch, mesh=mesh, plan=hs.ShardingPlan())
        params, state = checkpoint.restore(
            spec["start"], 0, like, opt.init_adamw(like),
            shardings=step.shardings["params"],
            opt_shardings=step.shardings["opt_in"])
        loader = make_loader(DataConfig(vocab_size=cfg.vocab_size,
                                        seq_len=spec["seq"],
                                        global_batch=spec["batch"]), "cpu",
                             mesh=mesh)
        hist = []
        for _ in range(spec["steps"]):
            params, state, m = step(params, state, next(loader))
            hist.append({k: float(v) for k, v in m.items()})
        final = flat_np(params)
        out[dispatch] = {"hist": hist, "shards": {
            k: [list(t.to_local().shape), list(t.shape)]
            for k, t in tree_flatten_with_path(params)}}
        if rank == 0 and dispatch == "gshard":
            np.savez(os.path.join(spec["out"], "train_params.npz"), **final)
    return out


def moe_inputs(spec, capacity_factor=16.0):
    """The reference test's MoE config (at ``capacity_factor``), params
    and input (bridged)."""
    cfg = get_config("deepseek-moe-16b").reduced()
    cfg = dataclasses.replace(cfg, dtype="float32", moe=dataclasses.replace(
        cfg.moe, capacity_factor=capacity_factor, num_experts=4))
    data = dict(np.load(spec["moe"]))
    p = params_from_numpy({k[2:]: v for k, v in data.items()
                           if k.startswith("p/")}, "cpu")
    return cfg, p, torch.from_numpy(data["x"]), torch.from_numpy(data["w"])


def run_ep(spec, world, rank):
    cfg, p, x, w = moe_inputs(spec, spec["ep_capacity"])
    mesh = make_host_mesh((1, world), device="cpu")
    x = x.clone().requires_grad_(True)
    y = full_tensor(ep_moe_shardmap(p, x, cfg, mesh))
    (gx,) = torch.autograd.grad((y * w).sum(), [x])
    if rank == 0:
        np.savez(os.path.join(spec["out"], "ep.npz"), y=y.detach().numpy(),
                 gx=full_tensor(gx).numpy())
    return {}


def run_dp_local(spec, world, rank):
    """dp_local on (world, 1), then on (1, world), over the same ranks."""
    cfg, p, x, _ = moe_inputs(spec)
    y_gs, _ = moe.moe_forward(p, x, cfg, dispatch="gshard")
    got = {"gshard": y_gs.detach().numpy()}
    report = {}
    for name, shape in (("data", (world, 1)), ("model", (1, world))):
        mesh = make_host_mesh(shape, device="cpu")
        placed = shard_params({"ffn": p}, mesh,
                              hs.ShardingPlan(moe_weights="dp"))["ffn"]
        leaves = [placed[k] for k in sorted(placed)]
        for t in leaves:
            t.requires_grad_(True)
        with use_mesh(mesh):
            y, _ = moe.moe_forward(placed, x, cfg, dispatch="dp_local")
            grads = torch.autograd.grad((y ** 2).sum(), leaves)
        grads = {k: full_tensor(g) for k, g in zip(sorted(placed), grads)}
        got[name] = full_tensor(y).detach().numpy()
        report[name] = {
            "finite": all(bool(g.isfinite().all()) for g in grads.values()),
            "w_gate_max": float(grads["w_gate"].abs().max()),
            "shards": {f"ffn/{k}": [list(t.to_local().shape),
                                    list(t.shape)]
                       for k, t in placed.items()}}
    if rank == 0:
        np.savez(os.path.join(spec["out"], "dp_local.npz"), **got)
    return report


def run_cm(spec, world):
    from torch.distributed.tensor import Shard, distribute_tensor
    data = np.load(spec["cm"])
    x, w = torch.from_numpy(data["x"]), torch.from_numpy(data["w"])
    mesh = make_host_mesh((1, world), device="cpu")
    xs = distribute_tensor(x, mesh, [Shard(0), Shard(0)])
    got = collective_matmul_allgather(xs, w, axis_name="model")
    return {"err": float((full_tensor(got) - x @ w).abs().max()),
            "local_rows": list(xs.to_local().shape)}


def run_attention(world):
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import attention as A
    mesh = make_host_mesh((1, world), device="cpu")
    g = torch.Generator().manual_seed(7)
    q, k, v, do = (torch.randn(2, 32, 4, d, generator=g)
                   for d in (96, 96, 64, 64))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = fa.flash_attention_ref(*leaves, causal=True)
    want_grads = torch.autograd.grad(want, leaves, do)
    out = {}
    for mode in ("ring", "head"):
        A.set_attention_mode(mode)
        try:
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            with use_mesh(mesh):
                got = A.full_attention(*(DTensor.from_local(
                    t, mesh, [Replicate()] * 2, run_check=False)
                    for t in leaves))
                # the dim each mesh dim shards (None: replicated)
                placements = [getattr(p, "dim", None)
                              for p in got.placements]
                got = full_tensor(got)
            grads = torch.autograd.grad(got, leaves, do)
        finally:
            A.set_attention_mode("ring")
        out[mode] = {"placements": placements,
                     "out": float((got - want).abs().max()),
                     "grads": [float((a - b).abs().max())
                               for a, b in zip(grads, want_grads)]}
    return out


def run_launcher(spec, rank, world):
    from repro_torch.launch import train as launcher
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank))
    os.environ[INIT_METHOD_ENV] = f"file://{spec['store']}.launcher"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        launcher.main(["--arch", "deepseek-v2-lite-16b", "--reduced",
                       "--device", "cpu", "--mesh", "auto", "--steps", "2",
                       "--global-batch", "2"])
    return buf.getvalue()


def main():
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    with open(sys.argv[3]) as f:
        spec = json.load(f)
    report = {}
    dist.init_process_group("gloo", init_method=f"file://{spec['store']}",
                            rank=rank, world_size=world)
    try:
        mesh = make_host_mesh(tuple(spec["shape"]), device="cpu")
        for task in spec["tasks"]:
            if task == "serve":
                report["serve"] = run_serve(spec, mesh)
            elif task == "train":
                report["train"] = run_train(spec, mesh, rank)
            elif task == "ep":
                report["ep"] = run_ep(spec, world, rank)
            elif task == "dp_local":
                report["dp_local"] = run_dp_local(spec, world, rank)
            elif task == "cm":
                report["cm"] = run_cm(spec, world)
            elif task == "attention":
                report["attention"] = run_attention(world)
    finally:
        dist.destroy_process_group()
    if "launcher" in spec["tasks"]:
        report["launcher"] = run_launcher(spec, rank, world)
    with open(os.path.join(spec["out"], f"report{rank}.json"), "w") as f:
        json.dump(report, f)


if __name__ == "__main__":
    main()
