"""One rank of a pipeline run of the port, on the CPU under gloo.

    python tests/torch_mesh_pipeline_worker.py RANK WORLD SPEC_JSON

``tests/test_torch_mesh_pipeline.py`` starts one fresh interpreter per
rank, each joining the process group through a ``FileStore`` file in the
test's temporary directory, single-threaded.  This module imports torch
and the port only, never JAX.  Params are the port's ``init_model`` at
seed 0 in f32 (the same on every rank).  The tasks, in order:

- ``stages``: ``train_pipeline`` of a 4-layer reduced qwen2-0.5b at S = 4,
  one rank a stage: each rank's history, pipeline counters, merged params
  and the stages it ran;
- ``fsdp``: the ``pipeline_fsdp`` preset's plan at S = 2 with
  ``stage_mesh=(2, 1)`` (params sharded over each stage's data axis, the
  micro-batch's rows too): the same records, each rank's stage mesh; then
  a micro-batch of one row on the data axis of 2, which must be refused;
- ``handoff``: tensors of 32 MB handed between two groups of two ranks in
  the S = 2, M = 4 1F1B order (an activation forward for each F, a
  cotangent back for each B), the receivers checking every byte;
- then, with the process group gone, rank 0 runs ``stages`` and ``fsdp``
  colocated (no process group: one process runs every stage) in this
  process with the same thread settings, and writes both.
"""
import dataclasses
import datetime
import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)

from repro_torch.api.errors import PipelinePlanError  # noqa: E402
from repro_torch.configs.base import (PipelineConfig, ShapeConfig,  # noqa: E402
                                      get_config)
from repro_torch.core import mpmd  # noqa: E402
from repro_torch.core.hypershard import ShardingPlan  # noqa: E402
from repro_torch.core.pipeline import schedule_1f1b  # noqa: E402
from repro_torch.core.tree import tree_flatten_with_path  # noqa: E402
from repro_torch.obs import Observability  # noqa: E402
from repro_torch.train.pipeline_trainer import (PipelineTrainer,  # noqa: E402
                                                train_pipeline)
from repro_torch.train.trainer import TrainConfig  # noqa: E402

COUNTERS = ("bubble_steps", "handoffs", "microbatches", "tied_embed_syncs")


def cfg_of(spec):
    return dataclasses.replace(get_config("qwen2-0.5b").reduced(),
                               dtype="float32", num_layers=spec["layers"])


def run(spec, name, out):
    """``train_pipeline`` of case ``name``; writes the merged params to
    ``out`` and returns the history and counters."""
    case = spec["cases"][name]
    obs = Observability()
    pipeline = PipelineConfig(stages=case["stages"],
                              micro_batches=spec["micro"],
                              stage_mesh=tuple(case["stage_mesh"]))
    params, hist = train_pipeline(
        cfg_of(spec), ShapeConfig("t", spec["seq"], spec["batch"], "train"),
        pipeline=pipeline, plan=ShardingPlan(), obs=obs, device="cpu",
        train_cfg=TrainConfig(num_steps=spec["steps"], log_every=1))
    np.savez(out, **{k: v.detach().numpy() for k, v in
                     tree_flatten_with_path(params)})
    return {"history": hist,
            "counters": {k: obs.metrics.counter(f"train.pipeline.{k}").value
                         for k in COUNTERS}}


def run_fsdp_refusal(spec):
    """A micro-batch of one row where each stage's data axis is 2."""
    try:
        tr = PipelineTrainer(cfg_of(spec), PipelineConfig(
            stages=2, micro_batches=spec["batch"], stage_mesh=(2, 1)),
            device="cpu")
        groups = [list(g.ranks) for g in tr.groups]
        meshes = [list(g.mesh.shape) for g in tr.groups]
        batch = {k: torch.zeros(spec["batch"], spec["seq"], dtype=dt)
                 for k, dt in (("inputs", torch.int32),
                               ("targets", torch.int32),
                               ("mask", torch.float32))}
        tr.step(batch)
    except PipelinePlanError as e:
        return {"error": str(e), "groups": groups, "meshes": meshes}
    return {"error": None}


def run_handoff(spec, rank):
    """S = 2, M = 4 in 1F1B order: stage 0 on ranks (0, 1), stage 1 on
    (2, 3); each F of stage 0 sends a (n,) f32 tensor of 32 MB seeded by
    its micro-batch, each B of stage 1 one seeded by 100 + micro back.
    Returns the seconds it took and whether every received tensor was the
    sent one."""
    groups = mpmd.groups_from_mapping({"stage0": 2, "stage1": 2})
    g = [groups["stage0"], groups["stage1"]]
    n = spec["handoff_bytes"] // 4
    wire = mpmd.Handoff()
    ok = True
    t0 = time.perf_counter()

    def tensor(seed):
        return torch.from_numpy(np.random.default_rng(seed).standard_normal(
            n).astype(np.float32))

    def received(src, dst, seed):
        # a group of two ranks keeps it replicated on its (1, 2) mesh
        got = wire.recv((n,), torch.float32, g[src], g[dst], "cpu")
        return torch.equal(got.to_local(), tensor(seed))
    for op in schedule_1f1b(2, 4).ops:
        s, m = op.stage, op.micro
        if not g[s].has(rank):
            continue
        if op.kind == "F" and s == 0:
            wire.send(tensor(m), g[0], g[1])
        elif op.kind == "F":
            ok &= received(0, 1, m)
        elif s == 1:
            wire.send(tensor(100 + m), g[1], g[0])
        else:
            ok &= received(1, 0, 100 + m)
    wire.wait()
    return {"seconds": time.perf_counter() - t0, "ok": bool(ok),
            "stage": 0 if g[0].has(rank) else 1}


def main():
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    with open(sys.argv[3]) as f:
        spec = json.load(f)
    torch.set_num_threads(1)
    out = spec["out"]
    report = {}
    dist.init_process_group("gloo", init_method=f"file://{spec['store']}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(
                                seconds=spec["timeout"]))
    try:
        for name in ("stages", "fsdp"):
            report[name] = run(spec, name,
                               os.path.join(out, f"{name}{rank}.npz"))
        report["refusal"] = run_fsdp_refusal(spec)
        report["handoff"] = run_handoff(spec, rank)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        for name in ("stages", "fsdp"):
            report[f"{name}_colocated"] = run(
                dict(spec, cases={name: dict(spec["cases"][name],
                                             stage_mesh=[])}),
                name, os.path.join(out, f"{name}_colocated.npz"))
    with open(os.path.join(out, f"report{rank}.json"), "w") as f:
        json.dump(report, f)


if __name__ == "__main__":
    main()
