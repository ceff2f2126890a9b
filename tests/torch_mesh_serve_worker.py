"""One rank of a HyperServe mesh run of the port, on the CPU under gloo.

    python tests/torch_mesh_serve_worker.py RANK WORLD SPEC_JSON

``tests/test_torch_mesh_serve.py`` starts one fresh interpreter per rank,
each joining the process group through a ``FileStore`` file in the
test's temporary directory.  This module imports torch and the port only,
never JAX.  Params come from checkpoints the test writes (the reference's
``init_model`` at seed 0, bridged), restored unsharded on every rank and
placed by the engine.

The spec names the mesh shape, the cases (arch, ``ServeConfig`` knobs,
prompts, new tokens, checkpoint) and the tasks to run, in order:

- ``serve``: every case served on the mesh under ``ShardingPlan(fsdp=
  None)``: each rank's greedy tokens, its ``preemptions``,
  ``prefill_chunks`` and ``prefill_calls``, and its pool leaves' local and
  global shapes with the recorded pool fallbacks;
- ``pool``: the ``pool`` case again, rank 0 writing the gathered pool and
  the first decode step's full logits;
- ``archive``: the ``budget`` case stepped one engine step at a time:
  after each, every archived key's tier and the archive's host and disk
  bytes; then its counters and tokens;
- ``refuse``: a ``(world, 1)`` mesh, an fsdp plan, a plan that is not a
  ``ShardingPlan`` (each refused), and engines of musicgen-large (its
  multimodal prefix, served text-only) and of deepseek-v2-lite under the
  composed lowering built on the flat mesh: each refusal's typed error
  and message, each engine's lowering;
- ``flat``: ``serving_mesh_for`` of the ``(world, 1)`` mesh, its shape,
  names and vocab axis, and the ``flat`` case served on it;
- ``launcher``: after the worker's own group is gone,
  ``python -m repro_torch.launch.serve --continuous --mesh auto --device
  cpu --reduced`` in this process, ``WORLD_SIZE``/``RANK``/``LOCAL_RANK``
  and the rendezvous file set as a launcher's ranks would find them; rank
  0 writes what it printed.
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

from repro_torch.api.errors import PlanError  # noqa: E402
from repro_torch.ckpt import checkpoint  # noqa: E402
from repro_torch.configs.base import ServeConfig, get_config  # noqa: E402
from repro_torch.core import hypershard as hs  # noqa: E402
from repro_torch.core.hypershard import ShardingPlan  # noqa: E402
from repro_torch.core.layout import layout_for_mesh  # noqa: E402
from repro_torch.core.meshctx import full_tensor  # noqa: E402
from repro_torch.core.tree import tree_flatten_with_path  # noqa: E402
from repro_torch.launch.mesh import INIT_METHOD_ENV, make_host_mesh  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.rl.session import serving_mesh_for  # noqa: E402
from repro_torch.serve import engine as E  # noqa: E402
from repro_torch.serve.api import HyperServe  # noqa: E402

SERVE_PLAN = ShardingPlan(fsdp=None)


def model(case):
    """(cfg, params) of a case: the reduced f32 config with the case's
    overrides, the params restored unsharded from its checkpoint."""
    cfg = dataclasses.replace(get_config(case["arch"]).reduced(),
                              dtype="float32", **case.get("overrides", {}))
    like = M.init_model(cfg, torch.Generator().manual_seed(0))
    return cfg, checkpoint.restore(case["ckpt"], 0, like)


def serve(case, mesh, plan=SERVE_PLAN):
    cfg, params = model(case)
    server = HyperServe(cfg, params, serve_cfg=ServeConfig(**case["scfg"]),
                        mesh=mesh, plan=plan, device="cpu")
    rids = [server.submit(p, n) for p, n in zip(case["prompts"],
                                                case["max_new"])]
    out = server.join()
    return server, [out[r] for r in rids]


def pool_report(server, mesh):
    """Each pool leaf's local and global shape, and the fallbacks
    ``derive_pool`` records for the leaves whose tp placement cannot bind."""
    layout = layout_for_mesh(mesh)
    flat = tree_flatten_with_path(server.engine.pool.state)
    fallbacks = {k: list(hs.derive_pool(k, tuple(t.shape), layout,
                                        SERVE_PLAN)[2]) for k, t in flat}
    return {"leaves": {k: [list(t.to_local().shape), list(t.shape)]
                       for k, t in flat},
            "fallbacks": {k: v for k, v in fallbacks.items() if v}}


def run_serve(spec, mesh):
    out = {}
    for name, case in spec["cases"].items():
        if name in ("pool", "flat", "budget"):
            continue
        server, tokens = serve(case, mesh)
        st = server.stats()
        out[name] = {"tokens": tokens, "preemptions": st["preemptions"],
                     "prefill_chunks": st["prefill_chunks"],
                     "prefill_calls": st["prefill_calls"],
                     **pool_report(server, mesh)}
    return out


def run_pool(spec, mesh, rank):
    """The pool case with the first decode step's logits captured (in
    full, on every rank) and the pool gathered after the run."""
    first = []
    step = M.decode_step_paged

    def capture(*a, **kw):
        logits = step(*a, **kw)
        if not first:
            first.append(full_tensor(logits).numpy())
        return logits
    M.decode_step_paged = capture
    try:
        server, tokens = serve(spec["cases"]["pool"], mesh)
    finally:
        M.decode_step_paged = step
    pool = {k: full_tensor(t).numpy()
            for k, t in tree_flatten_with_path(server.engine.pool.state)}
    if rank == 0:
        np.savez(os.path.join(spec["out"], "pool.npz"), logits=first[0],
                 **{f"pool/{k}": v for k, v in pool.items()})
    return {"tokens": tokens}


def run_archive(spec, mesh):
    """The ``budget`` case, a step at a time, its archive traced."""
    case = spec["cases"]["budget"]
    cfg, params = model(case)
    server = HyperServe(cfg, params, serve_cfg=ServeConfig(**case["scfg"]),
                        mesh=mesh, plan=SERVE_PLAN, device="cpu")
    rids = [server.submit(p, n) for p, n in zip(case["prompts"],
                                                case["max_new"])]
    trace = []
    while server.stats()["finished"] < len(rids):
        server.step_once()
        a, st = server.engine.blocks.archive, server.stats()
        trace.append([sorted([str(k), a.tier_of(k)] for k in a.keys()),
                      st["archive_host_bytes"], st["archive_disk_bytes"]])
    out = server.join()
    st = server.stats()
    return {"trace": trace, "tokens": [out[r] for r in rids],
            "stats": {k: st[k] for k in spec["archive_stats"]}}


def message(fn):
    """[the type of the ``PlanError`` that ``fn()`` raises, its message],
    or ["built", what ``fn()`` returned] where it raises none."""
    try:
        got = fn()
    except PlanError as e:
        return [type(e).__name__, str(e)]
    return ["built", got if isinstance(got, str) else None]


def run_refuse(spec, world):
    data = make_host_mesh((world, 1), device="cpu")
    flat = serving_mesh_for(data)
    case = spec["cases"]["flat"]

    def built(arch, **knobs):
        """The lowering of an engine built on the flat mesh."""
        cfg = dataclasses.replace(get_config(arch).reduced(),
                                  dtype="float32")
        return HyperServe(
            cfg, M.init_model(cfg, torch.Generator().manual_seed(0)),
            serve_cfg=ServeConfig(**dict(case["scfg"], **knobs)),
            mesh=flat, device="cpu").engine.kernel_path
    return {"data_axis": message(lambda: serve(case, data)),
            "fsdp": message(lambda: serve(case, flat, ShardingPlan())),
            "facade": message(lambda: serve(case, flat, "serve")),
            "prefix": message(lambda: built("musicgen-large")),
            "composed": message(lambda: built("deepseek-v2-lite-16b",
                                              kernels="composed"))}


def run_flat(spec, world):
    data = make_host_mesh((world, 1), device="cpu")
    flat = serving_mesh_for(data)
    cfg, _ = model(spec["cases"]["flat"])
    server, tokens = serve(spec["cases"]["flat"], flat)
    return {"shape": list(flat.shape), "names": list(flat.mesh_dim_names),
            "same_ranks": flat.mesh.flatten().tolist()
            == data.mesh.flatten().tolist(),
            "vocab_axis": E._vocab_axis(cfg, flat), "tokens": tokens,
            **pool_report(server, flat)}


def run_launcher(spec, rank, world):
    from repro_torch.launch import serve as launcher
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank))
    os.environ[INIT_METHOD_ENV] = f"file://{spec['store']}.launcher"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        launcher.main(["--arch", "qwen2-0.5b", "--reduced", "--continuous",
                       "--device", "cpu", "--mesh", "auto", "--requests",
                       "3", "--max-new", "6"])
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
            elif task == "pool":
                report["pool"] = run_pool(spec, mesh, rank)
            elif task == "archive":
                report["archive"] = run_archive(spec, mesh)
            elif task == "refuse":
                report["refuse"] = run_refuse(spec, world)
            elif task == "flat":
                report["flat"] = run_flat(spec, world)
    finally:
        dist.destroy_process_group()
    if "launcher" in spec["tasks"]:
        report["launcher"] = run_launcher(spec, rank, world)
    with open(os.path.join(spec["out"], f"report{rank}.json"), "w") as f:
        json.dump(report, f)


if __name__ == "__main__":
    main()
