"""One rank of a HyperFabric run of the port, on the CPU under gloo.

    python tests/torch_mesh_fabric_worker.py RANK WORLD SPEC_JSON

``tests/test_torch_fabric.py`` starts one fresh interpreter per rank, each
joining the process group through a ``FileStore`` file in the test's
temporary directory.  This module imports torch and the port only, never
JAX.  Params come from the checkpoint the test writes (the reference's
``init_model`` at seed 0, bridged), restored unsharded on every rank.

The rank builds ``Supernode.auto(device="cpu")`` (the ``(1, world)`` mesh
over the joined world) and its fabric: two replicas, elastic, the carve
one group of ``world / 2`` ranks a replica, each replica's engine on its
group's ``(1, n)`` mesh and built on that group's ranks only.  It submits
the spec's prompts one router step apart, records each step's replica
states and counters, drains, and reports its groups, the replica meshes
it holds, the tokens, the dispatch log, the final counters and each
request's replica.
"""
import dataclasses
import datetime
import json
import os
import sys

import torch
import torch.distributed as dist

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)

from repro_torch.api import Supernode, plans  # noqa: E402
from repro_torch.ckpt import checkpoint  # noqa: E402
from repro_torch.configs.base import (FabricConfig, ServeConfig,  # noqa: E402
                                      get_config)
from repro_torch.models import model as M  # noqa: E402


def main():
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    with open(sys.argv[3]) as f:
        spec = json.load(f)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{spec['store']}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    try:
        cfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(),
                                  dtype="float32")
        like = M.init_model(cfg, torch.Generator().manual_seed(0))
        params = checkpoint.restore(spec["ckpt"], 0, like)
        session = Supernode.auto(device="cpu")
        fab = session.fabric(cfg, params, plan=plans.fabric(
            serve=ServeConfig(**spec["scfg"]),
            fabric=FabricConfig(replicas=2, elastic=True,
                                scale_up_pending=1)))
        trace, fids = [], []
        for p, n in zip(spec["prompts"], spec["max_new"]):
            fids.append(fab.submit(p, n))
            fab.step()
            st = fab.stats()
            trace.append([list(st["replica_states"])]
                         + [st[k] for k in spec["counters"]])
        fab.join()
        st = fab.stats()
        report = dict(
            groups=[list(g.ranks) for g in fab.groups],
            meshes=[None if rep is None or rep.engine.mesh is None
                    else list(rep.engine.mesh.shape)
                    for rep in fab.replicas],
            tokens=[fab.result(f) for f in fids],
            log=[list(x) for x in fab.dispatch_log], trace=trace,
            counters=[st[k] for k in spec["counters"]],
            states=list(st["replica_states"]),
            replicas=[fab.request_meta(f)["replica"] for f in fids])
    finally:
        dist.destroy_process_group()
    with open(os.path.join(spec["out"], f"report{rank}.json"), "w") as f:
        json.dump(report, f)


if __name__ == "__main__":
    main()
