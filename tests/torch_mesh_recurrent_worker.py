"""One rank of a mesh run of the port's recurrent and multimodal families
(SSD, RG-LRU, the multimodal prefix) and of the composed lowering, on the
CPU under gloo.

    python tests/torch_mesh_recurrent_worker.py RANK WORLD SPEC_JSON

``tests/test_torch_mesh_recurrent.py`` starts one fresh interpreter per
rank, each joining the process group through a ``FileStore`` file in the
test's temporary directory.  This module imports torch and the port only,
never JAX.  Params come from checkpoints the test writes (the reference's
``init_model`` at seed 0, bridged), prefixes from an ``.npz`` file.

The spec names the mesh shape, the cases and the tasks to run, in order:

- ``train``: for each train case, ``steps`` fsdp_tp train steps from its
  start checkpoint restored under the step's shardings (a multimodal case
  with its seeded prefix placed by ``data.pipeline.place_prefix``), after
  the gradient of the first batch; rank 0 writes the history, the
  gradient and the final params in full; each rank its param shard
  shapes and whether ``bridge.shard_params`` placed every leaf alike;
- ``scans``: ``ssd_scan`` and ``rglru_scan`` on DTensors (rows over
  ``data``, heads or channels over ``model``) under grad, the output and
  every input's gradient of ``sum(y * w)`` gathered, and each backward
  wrapper called on DTensors directly (rank 0 writes them);
- ``serve``: every serving case on the mesh under ``ShardingPlan(fsdp=
  None)`` with the case's lowering: each rank's greedy tokens;
- ``decode``: ``decode_attention`` on DTensors, plain and windowed, with
  the KV heads over ``model`` and with one KV head replicated: each
  rank's output placements and its distance to the plain call on the
  full tensors;
- ``launcher``: after the worker's own group is gone, the train launcher
  on mamba2-370m and the serving launcher with ``--kernels composed``,
  both ``--mesh auto --device cpu --reduced``, in this process with
  ``WORLD_SIZE``/``RANK``/``LOCAL_RANK`` and a rendezvous file set; rank
  0 writes what they printed.
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
from repro_torch.core.meshctx import full_tensor, use_mesh  # noqa: E402
from repro_torch.core.tree import tree_flatten_with_path  # noqa: E402
from repro_torch.data.pipeline import (DataConfig, make_loader,  # noqa: E402
                                       place_prefix)
from repro_torch.launch.mesh import INIT_METHOD_ENV, make_host_mesh  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.bridge import shard_params  # noqa: E402
from repro_torch.optim import adamw as opt  # noqa: E402
from repro_torch.serve.api import HyperServe  # noqa: E402
from repro_torch.train import steps  # noqa: E402

SERVE_PLAN = hs.ShardingPlan(fsdp=None)


def config(case):
    return dataclasses.replace(get_config(case["arch"]).reduced(),
                               dtype="float32", **case.get("overrides", {}))


def flat_np(tree):
    return {k: full_tensor(v).detach().numpy()
            for k, v in tree_flatten_with_path(tree)}


def run_train(spec, mesh, rank):
    out = {}
    plan = hs.ShardingPlan()
    for name, case in spec["train"].items():
        cfg = config(case)
        mm = bool(case.get("prefix"))
        step = steps.make_train_step(
            cfg, opt.AdamWConfig(total_steps=spec["steps"]), mesh=mesh,
            plan=plan, multimodal=mm)
        like = M.init_model(cfg, torch.Generator().manual_seed(0))
        params, state = checkpoint.restore(
            case["start"], 0, like, opt.init_adamw(like),
            shardings=step.shardings["params"],
            opt_shardings=step.shardings["opt_in"])
        bridged = shard_params(checkpoint.restore(case["start"], 0, like),
                               mesh, plan)
        same = all(tuple(a.placements) == tuple(b.placements)
                   and torch.equal(a.to_local(), b.to_local())
                   for (_, a), (_, b) in zip(tree_flatten_with_path(params),
                                             tree_flatten_with_path(bridged)))
        loader = make_loader(DataConfig(vocab_size=cfg.vocab_size,
                                        seq_len=spec["seq"],
                                        global_batch=spec["batch"]), "cpu",
                             mesh=mesh)
        batches = [next(loader) for _ in range(spec["steps"])]
        if mm:
            prefix = np.load(case["prefix"])["prefix"]
            for b, pe in zip(batches, prefix):
                b["prefix_embeds"] = place_prefix(torch.from_numpy(pe), mesh)
        with use_mesh(mesh):
            _, grads = steps.value_and_grad(
                params, batches[0], cfg,
                prefix_embeds=batches[0].get("prefix_embeds"))
        grads = flat_np(grads)
        hist = []
        for b in batches:
            params, state, m = step(params, state, b)
            hist.append({k: float(v) for k, v in m.items()})
        final = flat_np(params)
        out[name] = {"hist": hist, "bridge": same,
                     "prefix_placements": [
                         type(p).__name__ for p in
                         batches[0]["prefix_embeds"].placements] if mm
                     else None,
                     "shards": {k: [list(t.to_local().shape), list(t.shape)]
                                for k, t in tree_flatten_with_path(params)}}
        if rank == 0:
            np.savez(os.path.join(spec["out"], f"{name}_grads.npz"), **grads)
            np.savez(os.path.join(spec["out"], f"{name}_params.npz"),
                     **final)
    return out


def _scan_case(mesh, fn, full, placements, weights):
    """``fn`` on the full tensors and on DTensors placed by
    ``placements``, under grad: the output's and every input's gradient
    of ``sum(y * w)``, the mesh run's gathered, both as numpy."""
    from torch.distributed.tensor import distribute_tensor
    leaves = [t.clone().requires_grad_(True) for t in full]
    y = fn(*leaves)
    want = [y.detach()] + list(torch.autograd.grad((y * weights).sum(),
                                                   leaves))
    dleaves = [distribute_tensor(t, mesh, pl).requires_grad_(True)
               for t, pl in zip(full, placements)]
    with use_mesh(mesh):
        ym = fn(*dleaves)
        grads = torch.autograd.grad((ym * weights).sum(), dleaves)
    got = [full_tensor(ym).detach()] + [full_tensor(g) for g in grads]
    return {"want": [t.numpy() for t in want],
            "got": [t.numpy() for t in got]}


def _bwd_case(mesh, fn, full, placements):
    """The backward wrapper ``fn`` on the full tensors and on DTensors
    placed by ``placements`` (a direct call, each rank on its shards under
    ``local_map``): every gradient, the mesh call's gathered (its
    ``Partial`` ones summed), both as numpy."""
    from torch.distributed.tensor import distribute_tensor
    want = fn(*full)
    got = fn(*[distribute_tensor(t, mesh, pl)
               for t, pl in zip(full, placements)])
    return {"want": [t.numpy() for t in want if t is not None],
            "got": [full_tensor(t).numpy() for t in got if t is not None]}


def run_scans(spec, mesh, rank):
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.kernels import ops, rglru_scan as rs, ssd_scan as ss
    g = torch.Generator().manual_seed(3)
    B, S, H, P, N, W = 2, 32, 4, 32, 16, 64
    rows_heads, rows = [Shard(0), Shard(2)], [Shard(0), Replicate()]
    rep = [Replicate(), Replicate()]
    x = torch.randn(B, S, H, P, generator=g) * 0.5
    dt = torch.rand(B, S, H, generator=g) * 0.2 + 0.05
    A = -torch.rand(H, generator=g) - 0.5
    Bm, Cm = (torch.randn(B, S, N, generator=g) * 0.5 for _ in range(2))
    out = {"ssd": _scan_case(
        mesh, lambda *t: ops.ssd_scan(*t, chunk=8)[0], (x, dt, A, Bm, Cm),
        (rows_heads, rows_heads, rep, rows, rows),
        torch.randn(B, S, H, P, generator=g))}
    dy = torch.randn(B, S, H, P, generator=g)
    bwd = {"ssd": _bwd_case(
        mesh, lambda *t: ss.ssd_scan_bwd(*t, None, chunk=8),
        (x, dt, A, Bm, Cm, dy),
        (rows_heads, rows_heads, rep, rows, rows, rows_heads))}
    xr = torch.randn(B, S, W, generator=g)
    ig, ag = (torch.sigmoid(torch.randn(B, S, W, generator=g))
              for _ in range(2))
    la = -torch.rand(W, generator=g) * 0.1 - 0.01
    out["rglru"] = _scan_case(
        mesh, lambda *t: ops.rglru_scan(*t)[0], (xr, ig, ag, la),
        (rows_heads, rows_heads, rows_heads, rep),
        torch.randn(B, S, W, generator=g))
    bwd["rglru"] = _bwd_case(
        mesh, lambda *t: rs.rglru_scan_bwd(*t, None), (xr, ig, ag, la,
                                                       torch.randn_like(xr)),
        (rows_heads, rows_heads, rows_heads, rep, rows_heads))
    if rank == 0:
        for name, case in out.items():
            np.savez(os.path.join(spec["out"], f"scan_{name}.npz"),
                     **{f"want{i}": a for i, a in enumerate(case["want"])},
                     **{f"got{i}": a for i, a in enumerate(case["got"])},
                     **{f"bwd_want{i}": a
                        for i, a in enumerate(bwd[name]["want"])},
                     **{f"bwd_got{i}": a
                        for i, a in enumerate(bwd[name]["got"])})
    return sorted(out)


def run_serve(spec, mesh):
    out = {}
    for name, case in spec["cases"].items():
        cfg = config(case)
        like = M.init_model(cfg, torch.Generator().manual_seed(0))
        params = checkpoint.restore(case["ckpt"], 0, like)
        server = HyperServe(cfg, params, serve_cfg=ServeConfig(
            **case["scfg"]), mesh=mesh, plan=SERVE_PLAN, device="cpu")
        rids = [server.submit(p, n) for p, n in zip(case["prompts"],
                                                    case["max_new"])]
        got = server.join()
        path = server.engine.kernel_path
        out[name] = {"tokens": [got[r] for r in rids], "path": path,
                     "counted": server.engine.obs.metrics.counter(
                         f"serve.kernels.decode.{path}").value}
    return out


def run_decode(mesh):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.kernels import decode_attention as da
    g = torch.Generator().manual_seed(9)
    out = {}
    for name, KV, window in (("sharded", 2, None), ("windowed", 2, 8),
                             ("one_kv_head", 1, 8)):
        q = torch.randn(3, 1, 4, 64, generator=g)
        k, v = (torch.randn(3, 24, KV, 64, generator=g) for _ in range(2))
        lengths = torch.tensor([24, 13, 5], dtype=torch.int32)
        want = da.decode_attention(q, k, v, lengths, window=window)
        heads = [Replicate(), Shard(2)]
        pool = heads if KV > 1 else [Replicate(), Replicate()]
        got = da.decode_attention(distribute_tensor(q, mesh, heads),
                                  distribute_tensor(k, mesh, pool),
                                  distribute_tensor(v, mesh, pool),
                                  lengths, window=window)
        out[name] = {"placements": [getattr(p, "dim", None)
                                    for p in got.placements],
                     "err": float((full_tensor(got) - want).abs().max())}
    return out


def run_launcher(spec, rank, world):
    from repro_torch.launch import serve as serve_launcher, \
        train as train_launcher
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank))
    out = {}
    for name, main, argv in (
            ("train", train_launcher.main,
             ["--arch", "mamba2-370m", "--steps", "2", "--global-batch",
              "2"]),
            ("serve", serve_launcher.main,
             ["--arch", "qwen2-0.5b", "--continuous", "--kernels",
              "composed", "--requests", "2", "--max-new", "4"])):
        os.environ[INIT_METHOD_ENV] = f"file://{spec['store']}.{name}"
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(argv + ["--reduced", "--device", "cpu", "--mesh", "auto"])
        out[name] = buf.getvalue()
    return out


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
            if task == "train":
                report["train"] = run_train(spec, mesh, rank)
            elif task == "scans":
                report["scans"] = run_scans(spec, mesh, rank)
            elif task == "serve":
                report["serve"] = run_serve(spec, mesh)
            elif task == "decode":
                report["decode"] = run_decode(mesh)
    finally:
        dist.destroy_process_group()
    if "launcher" in spec["tasks"]:
        report["launcher"] = run_launcher(spec, rank, world)
    with open(os.path.join(spec["out"], f"report{rank}.json"), "w") as f:
        json.dump(report, f)


if __name__ == "__main__":
    main()
