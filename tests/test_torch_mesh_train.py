"""The port's HyperShard train step on CPU meshes, against the port's
unsharded step and the reference trainer.

Each mesh run is one process per rank under gloo (``torch_mesh_worker.py``,
a fresh interpreter each, joined through a ``FileStore`` file in the
test's temporary directory, so parallel test workers never race for a
port).  All runs are reduced qwen2-0.5b in f32, from the reference's
initial state (``repro.models.model.init_model`` at seed 0, bridged and
written as the port's checkpoint), three steps of 2 x 32 tokens from the
shared synthetic corpus:

- ``(1, 2)`` under fsdp_tp, ring attention (qwen2's two KV heads on a
  ``model`` axis of 2 take the reference's default ring: the sequence
  sharded over ``model``, K/V rotating by ``all_to_all_single``);
- ``(1, 2)`` in head mode (heads sharded over ``model``, flash's plain
  version on each rank's heads under ``local_map``);
- ``(2, 1)`` (the batch split over ``data``; flash under ``local_map``);
- ``(2, 2)`` with four ranks.

Each run's loss and grad-norm history is held to the port's unsharded run
from the same state to 1e-5 relative, each gradient leaf of the first batch
to 1e-5 x max(1, max |grad|) (the same sums taken over shards, in another
order), and to the reference trainer's history to 1e-4 relative, the
params within AdamW's bound (``adam_step_bound``: two runs whose gradients
differ only in rounding part by at most sum_t 2 lr_t bound_t).  The (1, 2)
fsdp_tp run is also held to the reference trainer on the same forced
two-device mesh.  Each rank's local shard shapes equal the reference's
``ShardStrategy.shard_shape``, and ``bridge.shard_params`` places every
leaf as the step's shardings do.  A checkpoint saved on (1, 2) restores bit
for bit unsharded and on (2, 1); the offload legs on (1, 2) host-place
exactly the leaves whose reference spec is fully sharded; every family
(MLA, MoE, SSD, RG-LRU, the multimodal prefix) builds its step on a mesh,
while the facade's plan and a mesh that is not a ``DeviceMesh`` raise
``PlanError``; and ``trainer.train`` on (2, 1) from the seed follows the
unsharded trainer.
"""
import dataclasses
import json
import os
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from tests.conftest import run_subprocess  # noqa: E402
from repro.configs.base import ShapeConfig as JaxShapeConfig  # noqa: E402
from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.core import hypershard as jhs, offload as joff  # noqa: E402
from repro.core.layout import Layout as JaxLayout  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import adamw as jax_opt  # noqa: E402
from repro.train import trainer as jax_trainer  # noqa: E402
from repro_torch.ckpt import checkpoint  # noqa: E402
from repro_torch.configs.base import ShapeConfig, get_config  # noqa: E402
from repro_torch.core.tree import tree_flatten_with_path  # noqa: E402
from repro_torch.data.pipeline import DataConfig, make_loader  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.bridge import (adamw_state_from_numpy,  # noqa: E402
                                       params_from_numpy)
from repro_torch.optim import adamw as opt  # noqa: E402
from repro_torch.train import steps, trainer  # noqa: E402

STEPS = 3
SEQ, BATCH = 32, 2
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_mesh_worker.py")
# name -> (mesh shape, attention mode, tasks)
RUNS = {
    "ring_1x2": ((1, 2), "ring", ["train", "save", "offload", "refuse"]),
    "head_1x2": ((1, 2), "head", ["train"]),
    "dp_2x1": ((2, 1), "ring", ["train", "restore", "trainer"]),
    "both_2x2": ((2, 2), "ring", ["train"]),
}
AXES = ("data", "model")


def _cfgs():
    extra = dict(dtype="float32")
    return (dataclasses.replace(jax_get_config("qwen2-0.5b").reduced(),
                                **extra),
            dataclasses.replace(get_config("qwen2-0.5b").reduced(), **extra))


def adam_step_bound(b1: float, b2: float, t: int) -> float:
    """Largest |m_hat / sqrt(v_hat)| AdamW's step ``t`` can take (the
    Cauchy-Schwarz bound of ``chip_smoke.py``); 1 at t = 1."""
    return ((1 - b1) / (1 - b1 ** t)
            * sum((b1 * b1 / b2) ** j for j in range(t)) ** 0.5
            * ((1 - b2 ** t) / (1 - b2)) ** 0.5)


def params_bound(ref_params) -> float:
    acfg = opt.AdamWConfig(total_steps=STEPS)
    lrs = [float(opt.schedule(acfg, torch.tensor(t, dtype=torch.int32)))
           for t in range(1, STEPS + 1)]
    big = max(float(np.abs(v).max()) for v in ref_params.values())
    return (sum(2 * lr * adam_step_bound(acfg.b1, acfg.b2, t)
                for t, lr in enumerate(lrs, 1))
            + 2 * STEPS * big * 2.0 ** -23)


def _flat_np(tree):
    return {k: np.asarray(v.detach()) if torch.is_tensor(v) else
            np.asarray(v) for k, v in tree_flatten_with_path(tree)}


def _start_workers(tmp, name, start, restore=None):
    shape, mode, tasks = RUNS[name]
    out = tmp / name
    out.mkdir()
    spec = dict(store=str(out / "store"), shape=list(shape), mode=mode,
                plan="fsdp_tp", start=start, seq=SEQ, batch=BATCH,
                steps=STEPS, out=str(out), tasks=tasks, restore=restore)
    (out / "spec.json").write_text(json.dumps(spec))
    world = shape[0] * shape[1]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return out, [subprocess.Popen(
        [sys.executable, WORKER, str(r), str(world), str(out / "spec.json")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(world)]


def _wait(procs, name):
    logs = [p.communicate(timeout=300)[0] for p in procs]
    bad = [i for i, p in enumerate(procs) if p.returncode]
    assert not bad, f"{name}: rank {bad[0]} failed:\n{logs[bad[0]][-4000:]}"


JAX_MESH_CODE = """
import dataclasses, json
import numpy as np
from repro.configs.base import ShapeConfig, get_config
from repro.core.hypershard import ShardingPlan
from repro.launch.mesh import make_host_mesh
from repro.train import trainer
cfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(), dtype="float32")
mesh = make_host_mesh((1, 2))
_, hist = trainer.train(cfg, ShapeConfig("t", {seq}, {batch}, "train"),
                        mesh=mesh, plan=ShardingPlan(),
                        train_cfg=trainer.TrainConfig(num_steps={steps},
                                                      log_every=1))
print("HIST" + json.dumps([{{k: float(v) for k, v in m.items()}}
                           for m in hist]))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's start state, its trainer's history and params
    (unsharded), the port's unsharded run from that state, and the four
    mesh runs (three at once, then the (2, 1) run, which restores the
    (1, 2) run's checkpoint), beside the reference on a forced (1, 2)
    mesh in a subprocess of its own (waited for on a thread, so that all
    of them overlap)."""
    tmp = tmp_path_factory.mktemp("mesh")
    jcfg, cfg = _cfgs()
    jp = JM.init_model(jcfg, jax.random.PRNGKey(0))
    np_p = jax.tree.map(np.asarray, jp)
    np_o = jax.tree.map(np.asarray, jax_opt.init_adamw(jp))
    p0 = params_from_numpy(np_p, "cpu")
    o0 = adamw_state_from_numpy(np_o, "cpu")
    start = str(tmp / "start")
    checkpoint.save(start, 0, p0, o0)

    procs = {n: _start_workers(tmp, n, start)
             for n in ("ring_1x2", "head_1x2", "both_2x2")}
    code = JAX_MESH_CODE.format(seq=SEQ, batch=BATCH, steps=STEPS)
    jax_mesh = {}

    def jax_on_mesh():
        try:
            jax_mesh["out"] = run_subprocess(code, devices=2, timeout=600)
        except Exception as e:          # re-raised on the test's thread
            jax_mesh["error"] = e
    thread = threading.Thread(target=jax_on_mesh)
    thread.start()

    tcfg = jax_trainer.TrainConfig(num_steps=STEPS, log_every=1)
    jparams, jhist = jax_trainer.train(
        jcfg, JaxShapeConfig("t", SEQ, BATCH, "train"), train_cfg=tcfg)
    jparams = {k: np.asarray(v, np.float32) for k, v in
               zip(*_jax_paths(jparams))}

    # the port, unsharded, from the same state and batches
    step = steps.make_train_step(cfg, opt.AdamWConfig(total_steps=STEPS))
    loader = make_loader(DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                    global_batch=BATCH), "cpu")
    batches = [next(loader) for _ in range(STEPS)]
    _, grads = steps.value_and_grad(p0, batches[0], cfg)
    p, o, hist = p0, o0, []
    for b in batches:
        p, o, m = step(p, o, b)
        hist.append({k: float(v) for k, v in m.items()})
    _, thist = trainer.train(cfg, ShapeConfig("t", SEQ, BATCH, "train"),
                             train_cfg=trainer.TrainConfig(num_steps=STEPS,
                                                           log_every=1),
                             device="cpu")

    _wait(procs.pop("ring_1x2")[1], "ring_1x2")
    procs["dp_2x1"] = _start_workers(tmp, "dp_2x1", start,
                                     restore=str(tmp / "ring_1x2" / "ckpt"))
    for n, (_, ps) in procs.items():
        _wait(ps, n)
    thread.join()
    if "error" in jax_mesh:
        raise jax_mesh["error"]
    mesh = {}
    for n in RUNS:
        d = tmp / n
        mesh[n] = dict(
            hist=json.loads((d / "hist.json").read_text()),
            grads=dict(np.load(d / "grads.npz")),
            params=dict(np.load(d / "params.npz")),
            batch0=dict(np.load(d / "batch0.npz")),
            shards=[json.loads((d / f"shards{r}.json").read_text())
                    for r in range(np.prod(RUNS[n][0]))],
            bridge=[json.loads((d / f"bridge{r}.json").read_text())
                    for r in range(np.prod(RUNS[n][0]))],
            report=json.loads((d / "report.json").read_text()),
            dir=d)
    line = [ln for ln in jax_mesh["out"].splitlines()
            if ln.startswith("HIST")][0]
    return dict(
        jhist=jhist, jparams=jparams, jmesh=json.loads(line[4:]),
        port=dict(hist=hist, grads=_flat_np(grads), params=_flat_np(p),
                  batch0=_flat_np(batches[0])),
        port_trainer=thist, mesh=mesh, start=start)


def _jax_paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return (["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in kp) for kp, _ in flat],
            [v for _, v in flat])


def _close_hist(a, b, rel, keys=("loss", "ce", "grad_norm", "lr")):
    assert len(a) == len(b) == STEPS
    for x, y in zip(a, b):
        for k in keys:
            assert abs(x[k] - y[k]) <= rel * max(1.0, abs(y[k])), (k, x, y)


@pytest.mark.parametrize("name", list(RUNS))
def test_mesh_run_matches_the_unsharded_port(runs, name):
    """Loss and grad norm each step within 1e-5 relative, each gradient
    leaf of the first batch within 1e-5 x max(1, max |grad|), the params
    within AdamW's bound, and the mesh loader's first batch bit-identical
    to the unsharded loader's."""
    got, want = runs["mesh"][name], runs["port"]
    for k, v in want["batch0"].items():
        assert np.array_equal(got["batch0"][k], v), k
    _close_hist(got["hist"], want["hist"], 1e-5)
    assert got["hist"][-1]["loss"] != got["hist"][0]["loss"]
    for k, g in want["grads"].items():
        tol = 1e-5 * max(1.0, float(np.abs(g).max()))
        assert np.abs(got["grads"][k] - g).max() <= tol, k
    bound = params_bound(want["params"])
    for k, v in want["params"].items():
        assert np.abs(got["params"][k] - v).max() <= bound, k


@pytest.mark.parametrize("name", list(RUNS))
def test_mesh_run_matches_the_reference(runs, name):
    """The reference trainer (no mesh) from the same state: loss, CE, grad
    norm and lr within 1e-4 relative, the params within AdamW's bound."""
    got = runs["mesh"][name]
    _close_hist(got["hist"], runs["jhist"], 1e-4)
    bound = params_bound(runs["jparams"])
    for k, v in runs["jparams"].items():
        assert np.abs(got["params"][k] - v).max() <= bound, k


def test_ring_run_matches_the_reference_on_its_forced_mesh(runs):
    """(1, 2) under fsdp_tp against the reference trainer on a forced
    two-device (1, 2) mesh with the same ShardingPlan."""
    _close_hist(runs["mesh"]["ring_1x2"]["hist"], runs["jmesh"], 1e-4)


@pytest.mark.parametrize("name", list(RUNS))
def test_local_shards_have_the_reference_shard_shape(runs, name):
    """Every rank's local shard of every param leaf has the shape the
    reference's ``derive_param`` strategy gives (``shard_shape``)."""
    shape = RUNS[name][0]
    layout = JaxLayout(shape, AXES)
    plan = jhs.ShardingPlan()
    for shards in runs["mesh"][name]["shards"]:
        for path, (local, full) in shards.items():
            strat, _, _ = jhs.derive_param(path, tuple(full), layout, plan)
            assert tuple(local) == strat.shard_shape(tuple(full)), path


@pytest.mark.parametrize("name", list(RUNS))
def test_bridge_shards_as_the_step_places(runs, name):
    """``bridge.shard_params`` of the full params gives every rank the
    placements and local shards that restoring against the step's
    shardings gives it."""
    assert all(runs["mesh"][name]["bridge"])


def test_checkpoint_moves_between_meshes(runs):
    """The (1, 2) run's checkpoint: written in full, it restores bit for
    bit unsharded (equal to that run's gathered params) and on (2, 1)."""
    _, cfg = _cfgs()
    ring = runs["mesh"]["ring_1x2"]
    like = M.init_model(cfg, torch.Generator().manual_seed(0))
    p, o = checkpoint.restore(str(ring["dir"] / "ckpt"), STEPS, like,
                              opt.init_adamw(like))
    flat = _flat_np(p)
    for k, v in ring["params"].items():
        assert np.array_equal(flat[k], v), k
    moved = dict(np.load(runs["mesh"]["dp_2x1"]["dir"] / "restored.npz"))
    want = {**{f"params/{k}": v for k, v in flat.items()},
            **{f"opt/{k}": v for k, v in _flat_np(o).items()}}
    assert sorted(moved) == sorted(want)
    for k, v in want.items():
        assert np.array_equal(moved[k], v), k


def test_offload_legs_host_place_the_reference_leaves(runs):
    """On (1, 2) the offload leg host-places exactly the params and
    moments whose reference spec is fully sharded over {data: 1, model:
    2}, and the fetch leg brings them back bit for bit."""
    report = runs["mesh"]["ring_1x2"]["report"]
    layout = JaxLayout((1, 2), AXES)
    plan = jhs.ShardingPlan()
    want = sorted(
        k for k, v in runs["jparams"].items()
        if joff.spec_fully_sharded(
            jhs.derive_param(k, v.shape, layout, plan)[0].partition_spec(),
            {"data": 1, "model": 2}))
    assert want and len(want) < len(runs["jparams"])
    assert report["host_params"] == want
    assert report["host_mu"] == want
    assert report["fetched_equal"]


def test_unported_families_refuse_on_a_mesh(runs):
    """Every family builds its step on the mesh: MLA and MoE
    (deepseek-v2-lite, deepseek-moe), SSD and RG-LRU (mamba2,
    recurrentgemma) and the multimodal prefix (musicgen-large with
    ``multimodal=True``).  What is still not ported on a mesh refuses
    before any step runs: a plan that is no plan (a preset's name) raises
    the reference's ``PlanError`` from ``HyperPlan.coerce``, and a mesh
    that is not a ``DeviceMesh`` one naming it."""
    msgs = runs["mesh"]["ring_1x2"]["report"]["refusals"]
    assert sorted(msgs) == sorted(["deepseek-v2-lite-16b",
                                   "deepseek-moe-16b", "mamba2-370m",
                                   "recurrentgemma-2b", "musicgen-large",
                                   "facade", "not_a_mesh"])
    for arch in ("deepseek-v2-lite-16b", "deepseek-moe-16b", "mamba2-370m",
                 "recurrentgemma-2b", "musicgen-large"):
        assert msgs[arch] is None, (arch, msgs[arch])
    assert msgs["facade"] is not None and \
        "cannot coerce str into a HyperPlan" in msgs["facade"]
    assert msgs["not_a_mesh"] is not None \
        and "not a torch DeviceMesh" in msgs["not_a_mesh"]


def test_trainer_on_a_mesh_follows_the_unsharded_trainer(runs):
    """``trainer.train`` on (2, 1) from the seed (``init_state`` draws the
    full params and shards them) against the unsharded trainer."""
    _close_hist(runs["mesh"]["dp_2x1"]["report"]["trainer_hist"],
                runs["port_trainer"], 1e-5)
