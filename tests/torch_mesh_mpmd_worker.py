"""One rank of a HyperMPMD run of the port, on the CPU under gloo.

    python tests/torch_mesh_mpmd_worker.py RANK WORLD SPEC_JSON

``tests/test_torch_mesh_mpmd.py`` starts one fresh interpreter per rank,
each joining the process group through a ``FileStore`` file in the test's
temporary directory.  This module imports torch and the port only, never
JAX.  Params come from checkpoints the test writes (the reference's
``init_model`` at seed 0, bridged), restored unsharded on every rank.

The spec names the cases and the tasks to run, in order:

- ``serve``: each serving case (reduced qwen2-0.5b and deepseek-v2-lite in
  f32) served disaggregated on ``serving_groups(n_prefill, world -
  n_prefill)``: each rank's tokens, role, the engine's ``prefill_calls``
  and ``prefill_chunks``, its ``dense_prefill`` and ``paged_prefill``
  compile keys and ``mpmd.tasks.prefill``;
- ``prefix``: one prompt served twice, one after the other, on the same
  groups: the tokens and ``prefix_hits``;
- ``rl_mesh``: one GRPO iteration with the learner on a ``(2, 2)`` mesh
  under fsdp_tp and the actor on its flat ``(1, 4)`` view, then a greedy
  probe; rank 0 writes the learner batch and the updated params; then a
  second update on the same batch, for its metrics;
- ``rl_disagg``: one iteration of ``RLSession(roles={"actor": a,
  "learner": world - a})`` and a greedy probe: each rank's metrics, probe,
  utilization report and ``mpmd.tasks.*`` counters; the learner's first
  rank writes the updated params, the actor's first rank the batch; with
  ``colocated`` rank 0 then runs the same iteration in a one-process
  colocated session and writes its batch, loss and params;
- ``launchers``: after the worker's own group is gone, ``python -m
  repro_torch.launch.serve --disaggregate`` and ``python -m
  repro_torch.launch.rl --plan rl_disagg`` at once, each in a fresh
  interpreter of this rank with ``WORLD_SIZE``/``RANK``/``LOCAL_RANK`` and a
  rendezvous file set as a launcher's ranks would find them; each rank
  reports what it printed.
"""
import dataclasses
import datetime
import json
import os
import subprocess
import sys

import numpy as np
import torch
import torch.distributed as dist

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)

from repro_torch.ckpt import checkpoint  # noqa: E402
from repro_torch.configs.base import (RLConfig, ServeConfig,  # noqa: E402
                                      get_config)
from repro_torch.core import mpmd  # noqa: E402
from repro_torch.core.tree import tree_flatten_with_path  # noqa: E402
from repro_torch.launch.mesh import INIT_METHOD_ENV, make_host_mesh  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.bridge import full_params  # noqa: E402
from repro_torch.rl import RLSession  # noqa: E402
from repro_torch.serve.api import HyperServe  # noqa: E402


def model(spec, arch):
    """(cfg, params) of an arch: the reduced f32 config, the params
    restored unsharded from the test's checkpoint."""
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    like = M.init_model(cfg, torch.Generator().manual_seed(0))
    return cfg, checkpoint.restore(spec["ckpt"][arch], 0, like)


def reward(prompt, tokens):
    """A reward with spread within a group: the token sum mod 5."""
    return float(sum(tokens) % 5)


def flat(params):
    return {k: t.detach().cpu().numpy() for k, t in
            tree_flatten_with_path(params)}


def run_serve(spec, world):
    out = {}
    for arch in spec["archs"]:
        cfg, params = model(spec, arch)
        groups = mpmd.serving_groups(spec["n_prefill"],
                                     world - spec["n_prefill"])
        server = HyperServe(cfg, params, serve_cfg=ServeConfig(
            **spec["scfg"]), prefill_group=groups["prefill"],
            decode_group=groups["decode"], device="cpu")
        rids = [server.submit(p, spec["max_new"]) for p in spec["prompts"]]
        got = server.join()
        st = server.stats()
        obs = server.obs()
        out[arch] = dict(
            tokens=[got[r] for r in rids],
            role="decode" if groups["decode"].has() else "prefill",
            prefill_calls=st["prefill_calls"],
            prefill_chunks=st["prefill_chunks"],
            dense_prefill=[list(k) for k in
                           obs.compiled_keys("dense_prefill")],
            paged_prefill=len(obs.compiled_keys("paged_prefill")),
            tasks=obs.metrics.counter("mpmd.tasks.prefill").value)
    return out


def run_prefix(spec, world):
    cfg, params = model(spec, "qwen2-0.5b")
    groups = mpmd.serving_groups(spec["n_prefill"], world - spec["n_prefill"])
    server = HyperServe(cfg, params, serve_cfg=ServeConfig(**spec["scfg"]),
                        prefill_group=groups["prefill"],
                        decode_group=groups["decode"], device="cpu")
    tokens = []
    for _ in range(2):
        rid = server.submit(spec["prefix_prompt"], spec["max_new"])
        tokens.append(server.join()[rid])
    return dict(tokens=tokens, prefix_hits=server.stats()["prefix_hits"])


def run_rl_mesh(spec, rank):
    cfg, params = model(spec, "qwen2-0.5b")
    mesh = make_host_mesh((2, 2))
    rl = RLSession(cfg, rl_cfg=RLConfig(**spec["rl_mesh"]),
                   serve_cfg=ServeConfig(**spec["rl_scfg"]), params=params,
                   device="cpu", mesh=mesh)
    m = rl.iterate(spec["rl_mesh_prompts"], reward)
    batch = rl.buffer.batch(pad_len_to=16, pad_rows_to=rl.learner.dp_size())
    full = flat(full_params(rl.learner.params))
    probe = rl.rollout_greedy(spec["probe"], spec["max_new"])
    if rank == 0:
        np.savez(os.path.join(spec["out"], "rl_mesh.npz"),
                 **{f"batch/{k}": v for k, v in batch.items()},
                 **{f"params/{k}": v for k, v in full.items()})
    # a second update on the same batch: its metrics are read off the
    # params and AdamW state the first update left on the mesh
    m2 = rl.learner.update(batch)
    return dict(metrics=m, metrics2=m2, probe=probe,
                learner_mesh=list(rl.learner.mesh.shape),
                actor_mesh=list(rl.actor.engine.mesh.shape),
                dp=rl.learner.dp_size())


def rl_session(spec, roles=None):
    cfg, params = model(spec, "qwen2-0.5b")
    return RLSession(cfg, rl_cfg=RLConfig(**spec["rl"]),
                     serve_cfg=ServeConfig(**spec["rl_scfg"]), params=params,
                     device="cpu", roles=roles)


def run_rl_disagg(spec, rank, world):
    n_actor = world // 2
    rl = rl_session(spec, {"actor": n_actor, "learner": world - n_actor})
    m = rl.iterate(spec["rl_prompts"], reward)
    probe = rl.rollout_greedy(spec["probe"], spec["max_new"])
    util = rl.utilization_report()
    g = rl.groups
    out = spec["out"]
    if rl.learner is not None:
        # gathered on every learner rank (a collective on its mesh)
        full = flat(full_params(rl.learner.params))
        if rank == g["learner"].leader:
            np.savez(os.path.join(out, "disagg_params.npz"), **full)
    if rank == g["actor"].leader:
        np.savez(os.path.join(out, "disagg_batch.npz"),
                 **rl.buffer.batch(pad_len_to=16))
    counters = {k: rl.obs.metrics.counter(f"mpmd.tasks.{k}").value
                for k in ("actor", "learner")}
    report = dict(
        metrics=m, probe=probe, util=util, tasks=counters,
        groups=sorted(g), stats_updates=rl.stats()["learner_updates"],
        role="actor" if g["actor"].has() else "learner",
        actor_on_group_mesh=(rl.actor is None
                             or rl.actor.engine.mesh is g["actor"].mesh))
    if spec.get("colocated") and rank == 0:
        col = rl_session(spec)
        cm = col.iterate(spec["rl_prompts"], reward)
        np.savez(os.path.join(out, "colocated.npz"),
                 **{f"batch/{k}": v for k, v in
                    col.buffer.batch(pad_len_to=16).items()},
                 **{f"params/{k}": v for k, v in
                    flat(col.learner.params).items()})
        report["colocated_metrics"] = cm
    return report


def run_launchers(spec, rank, world):
    """Both launchers at once, each in a fresh interpreter of this rank (a
    launcher runs once a process) started with the environment a
    launcher's ranks find."""
    procs = {}
    for name, argv in (
            ("serve", ["repro_torch.launch.serve", "--arch", "qwen2-0.5b",
                       "--reduced", "--device", "cpu", "--disaggregate",
                       "--requests", "3", "--max-new", "6"]),
            ("rl", ["repro_torch.launch.rl", "--arch", "qwen2-0.5b",
                    "--reduced", "--device", "cpu", "--plan", "rl_disagg",
                    "--iters", "2", "--prompts", "1", "--group-size", "2",
                    "--max-new", "4"])):
        env = dict(os.environ, WORLD_SIZE=str(world), RANK=str(rank),
                   LOCAL_RANK=str(rank), PYTHONPATH=SRC,
                   **{INIT_METHOD_ENV: f"file://{spec['store']}.{name}"})
        procs[name] = subprocess.Popen(
            [sys.executable, "-m", *argv], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    out = {}
    for name, p in procs.items():
        stdout, stderr = p.communicate(timeout=600)
        if p.returncode:
            raise RuntimeError(f"{name} launcher on rank {rank}: "
                               f"{stderr[-3000:]}")
        out[name] = stdout
    return out


def main():
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    with open(sys.argv[3]) as f:
        spec = json.load(f)
    torch.set_num_threads(1)
    report = {}
    dist.init_process_group("gloo", init_method=f"file://{spec['store']}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    try:
        for task in spec["tasks"]:
            if task == "serve":
                report["serve"] = run_serve(spec, world)
            elif task == "prefix":
                report["prefix"] = run_prefix(spec, world)
            elif task == "rl_mesh":
                report["rl_mesh"] = run_rl_mesh(spec, rank)
            elif task == "rl_disagg":
                report["rl_disagg"] = run_rl_disagg(spec, rank, world)
    finally:
        dist.destroy_process_group()
    if "launchers" in spec["tasks"]:
        report["launchers"] = run_launchers(spec, rank, world)
    with open(os.path.join(spec["out"], f"report{rank}.json"), "w") as f:
        json.dump(report, f)


if __name__ == "__main__":
    main()
