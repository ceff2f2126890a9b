"""One rank of a HyperShard mesh run of the port, on the CPU under gloo.

    python tests/torch_mesh_worker.py RANK WORLD SPEC_JSON

``tests/test_torch_mesh_train.py`` starts one fresh interpreter per rank
(so no rank inherits a JAX runtime or a forked state), each joining the
process group through a ``FileStore`` file in the test's temporary
directory.  This module imports torch and the port only, never JAX.

The spec names the mesh shape, the attention mode, the plan, the
reduced f32 config's batch and the tasks to run, in order:

- ``train``: restore the starting checkpoint (written unsharded by the
  test) distributed by the step's shardings, and check it against the
  bridge's ``shard_params`` of the same params restored unsharded; take
  the gradient of the first batch, then ``steps`` train steps from the
  mesh loader; rank 0 writes the history, the gradient and the final
  params in full, and each rank its local shard shapes and whether the
  bridge placed every leaf alike;
- ``save``: save the trained state as a checkpoint (rank 0 writes);
- ``restore``: restore another run's checkpoint on this mesh and gather
  it (rank 0 writes it, for a bit-for-bit comparison);
- ``offload``: one offload leg of the restored state: the paths of the
  leaves that went to host memory, and a fetch back bit for bit;
- ``refuse``: a step of each other family built under the mesh (the
  multimodal one with its prefix), and a step under the facade's plan and
  under a mesh that is not a ``DeviceMesh``: the message of the
  ``PlanError`` each raises, None where it builds;
- ``trainer``: ``trainer.train`` on the mesh from the seed.
"""
import dataclasses
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
from repro_torch.configs.base import ShapeConfig, get_config  # noqa: E402
from repro_torch.core import hypershard as hs, offload as off  # noqa: E402
from repro_torch.core.meshctx import full_tensor, use_mesh  # noqa: E402
from repro_torch.core.tree import tree_flatten_with_path  # noqa: E402
from repro_torch.data.pipeline import DataConfig, make_loader  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import attention as A, model as M  # noqa: E402
from repro_torch.models.bridge import shard_params  # noqa: E402
from repro_torch.optim import adamw as opt  # noqa: E402
from repro_torch.train import steps, trainer  # noqa: E402

PLANS = {"fsdp_tp": hs.ShardingPlan(), "tp_only": hs.ShardingPlan(fsdp=None)}


def qwen():
    return dataclasses.replace(get_config("qwen2-0.5b").reduced(),
                               dtype="float32")


def templates(cfg):
    params = M.init_model(cfg, torch.Generator().manual_seed(0))
    return params, opt.init_adamw(params)


def flat_np(tree):
    return {k: full(v).numpy() for k, v in tree_flatten_with_path(tree)}


def full(t):
    if isinstance(t, off.HostShard):
        t = t.to_mesh("cpu")
    return full_tensor(t).detach()


def train(spec, mesh, rank, out):
    cfg = qwen()
    acfg = opt.AdamWConfig(total_steps=spec["steps"])
    step = steps.make_train_step(cfg, acfg, mesh=mesh,
                                 plan=PLANS[spec["plan"]])
    like_p, like_o = templates(cfg)
    params, state = checkpoint.restore(
        spec["start"], 0, like_p, like_o,
        shardings=step.shardings["params"],
        opt_shardings=step.shardings["opt_in"])
    bridged = shard_params(checkpoint.restore(spec["start"], 0, like_p),
                           mesh, PLANS[spec["plan"]])
    same = all(tuple(a.placements) == tuple(b.placements)
               and torch.equal(a.to_local(), b.to_local())
               for (_, a), (_, b) in zip(tree_flatten_with_path(params),
                                         tree_flatten_with_path(bridged)))
    loader = make_loader(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=spec["seq"],
                                    global_batch=spec["batch"]), "cpu",
                         mesh=mesh)
    batches = [next(loader) for _ in range(spec["steps"])]
    with use_mesh(mesh):
        _, grads = steps.value_and_grad(params, batches[0], cfg)
    grads = flat_np(grads)
    hist = []
    for b in batches:
        params, state, m = step(params, state, b)
        hist.append({k: float(v) for k, v in m.items()})
    shards = {k: [list(t.to_local().shape), list(t.shape)]
              for k, t in tree_flatten_with_path(params)}
    with open(os.path.join(out, f"shards{rank}.json"), "w") as f:
        json.dump(shards, f)
    final = flat_np(params)
    batch0 = {k: full(v).numpy() for k, v in batches[0].items()}
    if rank == 0:
        np.savez(os.path.join(out, "grads.npz"), **grads)
        np.savez(os.path.join(out, "params.npz"), **final)
        np.savez(os.path.join(out, "batch0.npz"), **batch0)
        with open(os.path.join(out, "hist.json"), "w") as f:
            json.dump(hist, f)
    with open(os.path.join(out, f"bridge{rank}.json"), "w") as f:
        json.dump(same, f)
    return params, state


def refusal(fn):
    """The message of the ``PlanError`` that ``fn()`` raises, or None."""
    try:
        fn()
    except PlanError as e:
        return str(e)
    return None


def main():
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    with open(sys.argv[3]) as f:
        spec = json.load(f)
    out = spec["out"]
    dist.init_process_group("gloo", init_method=f"file://{spec['store']}",
                            rank=rank, world_size=world)
    try:
        mesh = make_host_mesh(tuple(spec["shape"]), device="cpu")
        A.set_attention_mode(spec.get("mode", "ring"))
        report = {}
        params = state = None
        for task in spec["tasks"]:
            if task == "train":
                params, state = train(spec, mesh, rank, out)
            elif task == "save":
                checkpoint.save(os.path.join(out, "ckpt"), spec["steps"],
                                params, state)
            elif task == "restore":
                cfg = qwen()
                shard = steps.train_shardings(cfg, mesh,
                                              PLANS[spec["plan"]])
                like_p, like_o = templates(cfg)
                p, o = checkpoint.restore(
                    spec["restore"], spec["steps"], like_p, like_o,
                    shardings=shard["params"], opt_shardings=shard["opt_in"])
                got = {**{f"params/{k}": v for k, v in flat_np(p).items()},
                       **{f"opt/{k}": v for k, v in flat_np(o).items()}}
                if rank == 0:
                    np.savez(os.path.join(out, "restored.npz"), **got)
            elif task == "offload":
                both = off.OffloadConfig(params_on_host=True,
                                         opt_state_on_host=True)
                before = flat_np(params)
                hp, ho = steps.offload_state(params, state, both)
                report["host_params"] = sorted(
                    k for k, t in tree_flatten_with_path(hp)
                    if isinstance(t, off.HostShard))
                report["host_mu"] = sorted(
                    k for k, t in tree_flatten_with_path(ho.mu)
                    if isinstance(t, off.HostShard))
                fp, _ = steps.fetch_state(hp, ho, both, "cpu")
                after = flat_np(fp)
                report["fetched_equal"] = all(
                    np.array_equal(before[k], after[k]) for k in before)
            elif task == "refuse":
                msgs = {}
                for arch in ("deepseek-v2-lite-16b", "deepseek-moe-16b",
                             "mamba2-370m", "recurrentgemma-2b",
                             "musicgen-large"):
                    msgs[arch] = refusal(lambda: steps.make_train_step(
                        get_config(arch).reduced(), opt.AdamWConfig(),
                        mesh=mesh, multimodal=arch == "musicgen-large"))
                msgs["facade"] = refusal(lambda: steps.make_train_step(
                    qwen(), opt.AdamWConfig(), mesh=mesh, plan="fsdp_tp"))
                msgs["not_a_mesh"] = refusal(lambda: steps.make_train_step(
                    qwen(), opt.AdamWConfig(), mesh="auto"))
                report["refusals"] = msgs
            elif task == "trainer":
                cfg = qwen()
                _, hist = trainer.train(
                    cfg, ShapeConfig("t", spec["seq"], spec["batch"],
                                     "train"),
                    train_cfg=trainer.TrainConfig(num_steps=spec["steps"],
                                                  log_every=1),
                    device="cpu", mesh=mesh, plan=PLANS[spec["plan"]])
                report["trainer_hist"] = hist
        if rank == 0:
            with open(os.path.join(out, "report.json"), "w") as f:
                json.dump(report, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
