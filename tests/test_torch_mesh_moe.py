"""The port's MLA and MoE families on CPU meshes (DeepSeek), and the rest of
``core/overlap``, against the reference and the port's unsharded runs.

Each mesh run is one process per rank under gloo
(``torch_mesh_moe_worker.py``, a fresh interpreter each, joined through a
``FileStore`` file in the test's temporary directory).  Params are the
reference's ``init_model`` at seed 0 in f32, bridged; the MoE-level
functions take ``tests/test_overlap.py``'s config (deepseek-moe-16b
reduced, 4 experts, capacity factor 16) and input (4 x 32 tokens).  Two
process sets, beside one JAX subprocess on a forced 2-device mesh (the
trainer on (1, 2), ``ep_moe_shardmap`` on (1, 2), ``moe_dp_local`` on
(2, 1) and (1, 2)):

- 2 ranks on ``(1, 2)``: reduced deepseek-v2-lite-16b (MLA + MoE, 4
  experts, 4 heads, latent 64 + rope 32) and deepseek-moe-16b served with
  ``tests/test_hyperserve.py:300``'s ``ServeConfig``, every rank's greedy
  tokens equal to the JAX ``Generator``'s and the unsharded port's; a
  forced preemption of deepseek-v2-lite; each rank's pool and param
  shards shaped as the reference's ``derive_pool`` / ``derive_param``
  shard them; 3 fsdp_tp train steps of deepseek-v2-lite under gshard
  (held to the unsharded port to 1e-5 relative and to the reference
  trainer on its forced (1, 2) mesh to 1e-4, params within AdamW's bound)
  and under ragged (held to the unsharded port); ``ep_moe_shardmap``'s
  value and input gradient (at the reduced config's capacity factor,
  1.25); ``moe_dp_local`` on ``(2, 1)`` and ``(1,
  2)`` over the same two ranks (within 1e-3 of gshard, equal to the
  reference's, gradients finite, ``w_gate``'s nonzero);
  ``collective_matmul_allgather`` against ``x @ w``; and ``full_attention``
  at MLA's reduced (96, 64) in ring and in head mode;
- 3 ranks on ``(1, 3)``: deepseek-v2-lite served as the JAX ``Generator``
  does, with the expert (4 % 3) and head fallbacks the reference records,
  and the train launcher's ``--mesh auto`` on deepseek-v2-lite.
"""
import dataclasses
import json
import os
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from tests.conftest import run_subprocess  # noqa: E402
from tests.test_torch_mesh_train import params_bound  # noqa: E402
from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.core import hypershard as jhs  # noqa: E402
from repro.core.layout import Layout as JaxLayout  # noqa: E402
from repro.models import model as JM, moe as jax_moe  # noqa: E402
from repro.optim import adamw as jax_opt  # noqa: E402
from repro.serve.engine import GenerateConfig, Generator  # noqa: E402
from repro_torch.ckpt import checkpoint  # noqa: E402
from repro_torch.configs.base import ServeConfig, get_config  # noqa: E402
from repro_torch.core.overlap import overlap_efficiency  # noqa: E402
from repro_torch.core.tree import tree_flatten_with_path  # noqa: E402
from repro_torch.data.pipeline import DataConfig, make_loader  # noqa: E402
from repro_torch.models.bridge import (adamw_state_from_numpy,  # noqa: E402
                                       params_from_numpy)
from repro_torch.optim import adamw as opt  # noqa: E402
from repro_torch.serve.api import HyperServe  # noqa: E402
from repro_torch.train import steps  # noqa: E402

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_mesh_moe_worker.py")
AXES = ("data", "model")
STEPS, SEQ, BATCH = 3, 32, 2
# ep_moe_shardmap's capacity factor: the reduced config's own (at
# tests/test_overlap.py's 16 its fixed-capacity blocks hold 4096 rows a
# rank, and each row's gathered (D, F) weights make gigabytes)
EP_CAPACITY = 1.25
V2 = "deepseek-v2-lite-16b"
# tests/test_hyperserve.py:300 (test_mla_paged_serve_matches_generator)
MLA_SCFG = dict(block_size=4, num_blocks=40, max_blocks_per_req=8,
                max_slots=3, prefill_chunk=4)
MLA_PROMPTS = [list(range(1, 9)), list(range(20, 33)), list(range(5, 10))]
# name -> (arch, ServeConfig knobs, prompts, new tokens)
CASES = {
    "v2lite": (V2, MLA_SCFG, MLA_PROMPTS, [6, 4, 8]),
    "moe16b": ("deepseek-moe-16b", MLA_SCFG, MLA_PROMPTS, [6, 4, 8]),
    # tests/test_fused_serve.py's forced preemption
    "preempt": (V2, dict(block_size=2, num_blocks=9, max_blocks_per_req=6,
                         max_slots=2, prefill_chunk=4,
                         enable_prefix_cache=False),
                [list(range(1, 5)), list(range(7, 11))], [8, 8]),
    "flat": (V2, MLA_SCFG, [list(range(1, 10)), list(range(3, 8))], [5, 6]),
}
# process set -> (world, mesh shape, serving cases, tasks)
SETS = {
    "two": (2, (1, 2), ["v2lite", "moe16b", "preempt"],
            ["serve", "train", "ep", "dp_local", "cm", "attention"]),
    "three": (3, (1, 3), ["flat"], ["serve", "launcher"]),
}

JAX_CODE = """
import dataclasses, json
import jax, jax.numpy as jnp, numpy as np
from repro.configs.base import ShapeConfig, get_config
from repro.core.hypershard import ShardingPlan
from repro.core.meshctx import use_mesh
from repro.core.overlap import ep_moe_shardmap
from repro.launch.mesh import make_host_mesh
from repro.models import moe as moe_mod
from repro.train import trainer
cfg = dataclasses.replace(get_config("deepseek-v2-lite-16b").reduced(),
                          dtype="float32")
params, hist = trainer.train(
    cfg, ShapeConfig("t", {seq}, {batch}, "train"),
    mesh=make_host_mesh((1, 2)), plan=ShardingPlan(),
    train_cfg=trainer.TrainConfig(num_steps={steps}, log_every=1))
flat = jax.tree_util.tree_flatten_with_path(params)[0]
np.savez("{out}/jtrain.npz", **{{
    "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp):
    np.asarray(v, np.float32) for kp, v in flat}})
print("HIST" + json.dumps([{{k: float(v) for k, v in m.items()}}
                           for m in hist]))
mcfg = get_config("deepseek-moe-16b").reduced()
mcfg = dataclasses.replace(mcfg, dtype="float32", moe=dataclasses.replace(
    mcfg.moe, capacity_factor=16.0, num_experts=4))
p = moe_mod.init_moe(mcfg, jax.random.PRNGKey(0))
x = jax.random.normal(jax.random.PRNGKey(1), (4, 32, mcfg.d_model),
                      jnp.float32) * 0.3
w = jax.random.normal(jax.random.PRNGKey(2), x.shape, jnp.float32)
mesh = make_host_mesh((1, 2))
ecfg = dataclasses.replace(mcfg, moe=dataclasses.replace(
    mcfg.moe, capacity_factor={ep_capacity}))
y_ep = jax.jit(lambda p, x: ep_moe_shardmap(p, x, ecfg, mesh))(p, x)
gx = jax.jit(jax.grad(
    lambda x: jnp.sum(ep_moe_shardmap(p, x, ecfg, mesh) * w)))(x)
got = dict(ep_y=np.asarray(y_ep), ep_gx=np.asarray(gx))
for name, shape in (("data", (2, 1)), ("model", (1, 2))):
    m = make_host_mesh(shape)
    def g(p, x, m=m):
        with use_mesh(m):
            y, _ = moe_mod.moe_forward(p, x, mcfg, dispatch="dp_local")
        return y
    got[name] = np.asarray(jax.jit(g)(p, x))
np.savez("{out}/jmoe.npz", **got)
"""


def _moe_cfgs():
    """tests/test_overlap.py's config, in both packages."""
    def cut(cfg):
        return dataclasses.replace(cfg, dtype="float32",
                                   moe=dataclasses.replace(
                                       cfg.moe, capacity_factor=16.0,
                                       num_experts=4))
    return (cut(jax_get_config("deepseek-moe-16b").reduced()),
            cut(get_config("deepseek-moe-16b").reduced()))


def _start(tmp, name, files):
    world, shape, cases, tasks = SETS[name]
    out = tmp / name
    out.mkdir()
    spec = dict(store=str(out / "store"), shape=list(shape), out=str(out),
                tasks=tasks, steps=STEPS, seq=SEQ, batch=BATCH,
                dispatches=["gshard", "ragged"], **files, cases={})
    for c in cases:
        arch, scfg, prompts, max_new = CASES[c]
        spec["cases"][c] = dict(arch=arch, scfg=scfg, prompts=prompts,
                                max_new=max_new, ckpt=files["ckpts"][arch])
    (out / "spec.json").write_text(json.dumps(spec))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return out, [subprocess.Popen(
        [sys.executable, WORKER, str(r), str(world), str(out / "spec.json")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(world)]


def _wait(name, out, procs):
    logs = [p.communicate(timeout=600)[0] for p in procs]
    bad = [i for i, p in enumerate(procs) if p.returncode]
    assert not bad, f"{name}: rank {bad[0]} failed:\n{logs[bad[0]][-4000:]}"
    return [json.loads((out / f"report{r}.json").read_text())
            for r in range(len(procs))]


def _port_train(cfg, p0, o0, dispatch):
    """The unsharded port's history and final params from the same state
    and batches."""
    step = steps.make_train_step(cfg, opt.AdamWConfig(total_steps=STEPS),
                                 moe_dispatch=dispatch)
    loader = make_loader(DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                    global_batch=BATCH), "cpu")
    p, o, hist = p0, o0, []
    for _ in range(STEPS):
        p, o, m = step(p, o, next(loader))
        hist.append({k: float(v) for k, v in m.items()})
    return hist, {k: v.detach().numpy()
                  for k, v in tree_flatten_with_path(p)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Inputs written first; both process sets and the JAX subprocess
    started at once; while they run, the JAX ``Generator``'s and the
    unsharded port's tokens of every serving case and the unsharded
    port's train runs."""
    tmp = tmp_path_factory.mktemp("mesh_moe")
    models, ckpts = {}, {}
    for arch in (V2, "deepseek-moe-16b"):
        jcfg = dataclasses.replace(jax_get_config(arch).reduced(),
                                   dtype="float32")
        cfg = dataclasses.replace(get_config(arch).reduced(),
                                  dtype="float32")
        jp = JM.init_model(jcfg, jax.random.PRNGKey(0))
        np_p = jax.tree.map(np.asarray, jp)
        tp = params_from_numpy(np_p, "cpu")
        ckpts[arch] = str(tmp / arch)
        checkpoint.save(ckpts[arch], 0, tp)
        models[arch] = (jcfg, cfg, jp, tp, np_p)
    jcfg, cfg, jp, p0, np_p = models[V2]
    o0 = adamw_state_from_numpy(
        jax.tree.map(np.asarray, jax_opt.init_adamw(jp)), "cpu")
    start = str(tmp / "start")
    checkpoint.save(start, 0, p0, o0)
    mj, _ = _moe_cfgs()
    pm = jax_moe.init_moe(mj, jax.random.PRNGKey(0))
    x = jax.random.normal(jax.random.PRNGKey(1), (4, 32, mj.d_model),
                          jnp.float32) * 0.3
    w = jax.random.normal(jax.random.PRNGKey(2), x.shape, jnp.float32)
    np.savez(tmp / "moe.npz", x=np.asarray(x), w=np.asarray(w),
             **{f"p/{k}": np.asarray(v) for k, v in pm.items()})
    # tests/test_overlap.py:19's inputs
    np.savez(tmp / "cm.npz",
             x=np.asarray(jax.random.normal(jax.random.PRNGKey(0),
                                            (64, 32)) * 0.3),
             w=np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                            (32, 16)) * 0.3))
    files = dict(ckpts=ckpts, start=start, moe=str(tmp / "moe.npz"),
                 cm=str(tmp / "cm.npz"), ep_capacity=EP_CAPACITY)
    procs = {n: _start(tmp, n, files) for n in SETS}
    jax_out = {}

    def jax_on_mesh():
        try:
            jax_out["out"] = run_subprocess(JAX_CODE.format(
                seq=SEQ, batch=BATCH, steps=STEPS, out=tmp,
                ep_capacity=EP_CAPACITY), devices=2, timeout=600)
        except Exception as e:          # re-raised on the test's thread
            jax_out["error"] = e
    thread = threading.Thread(target=jax_on_mesh)
    thread.start()

    want, port = {}, {}
    gens = {}
    for name, (arch, scfg, prompts, max_new) in CASES.items():
        jc, c, jparams, tparams, _ = models[arch]
        if arch not in gens:
            gens[arch] = Generator(jc, jparams, max_len=128)
        want[name] = [gens[arch].generate(
            jnp.asarray(p, jnp.int32)[None, :],
            GenerateConfig(max_new_tokens=n))[0, len(p):].tolist()
            for p, n in zip(prompts, max_new)]
        server = HyperServe(c, tparams, serve_cfg=ServeConfig(**scfg),
                            device="cpu")
        rids = [server.submit(p, n) for p, n in zip(prompts, max_new)]
        out = server.join()
        port[name] = [out[r] for r in rids]
    train = {d: _port_train(cfg, p0, o0, d) for d in ("gshard", "ragged")}

    reports = {n: _wait(n, *procs[n]) for n in SETS}
    thread.join()
    if "error" in jax_out:
        raise jax_out["error"]
    line = [ln for ln in jax_out["out"].splitlines()
            if ln.startswith("HIST")][0]
    two = tmp / "two"
    return dict(
        want=want, port=port, train=train, reports=reports,
        jhist=json.loads(line[4:]), jparams=dict(np.load(tmp / "jtrain.npz")),
        jmoe=dict(np.load(tmp / "jmoe.npz")),
        train_params=dict(np.load(two / "train_params.npz")),
        ep=dict(np.load(two / "ep.npz")),
        dp_local=dict(np.load(two / "dp_local.npz")))


def _close_hist(a, b, rel, keys=("loss", "ce", "grad_norm", "lr")):
    assert len(a) == len(b) == STEPS
    for x, y in zip(a, b):
        for k in keys:
            assert abs(x[k] - y[k]) <= rel * max(1.0, abs(y[k])), (k, x, y)


@pytest.mark.parametrize("name", ["v2lite", "moe16b"])
def test_deepseek_serves_on_a_mesh_as_the_generator(runs, name):
    """(1, 2): every rank's greedy tokens equal the JAX Generator's and the
    unsharded port HyperServe's, exactly (MLA's fused decode on each rank's
    heads, the MoE expert-parallel: each rank two of the four experts)."""
    for rank, rep in enumerate(runs["reports"]["two"]):
        got = rep["serve"][name]["tokens"]
        assert got == runs["want"][name] == runs["port"][name], (name, rank)


def test_preempted_deepseek_on_a_mesh_is_identical(runs):
    """(1, 2): the pool runs out, a request's latent pages are archived
    (each rank its own full copy) and restored, and the tokens are the
    Generator's and the unsharded port's."""
    for rep in runs["reports"]["two"]:
        got = rep["serve"]["preempt"]
        assert got["preemptions"] >= 1
        assert got["tokens"] == runs["want"]["preempt"] \
            == runs["port"]["preempt"]


@pytest.mark.parametrize("name", ["v2lite", "moe16b"])
def test_pool_and_param_shards_have_the_reference_shard_shape(runs, name):
    """Each rank's local pool and param leaves have the shapes of the
    reference's ``derive_pool`` / ``derive_param`` strategies on {data: 1,
    model: 2} under ``ShardingPlan(fsdp=None)``, with the reference's
    notes: the MLA latents replicate, the experts split over ``model``."""
    layout = JaxLayout((1, 2), AXES)
    plan = jhs.ShardingPlan(fsdp=None)
    for rep in runs["reports"]["two"]:
        got = rep["serve"][name]
        for what, derive in (("pool", jhs.derive_pool),
                             ("params", jhs.derive_param)):
            notes = got["pool_fallbacks" if what == "pool" else
                        "param_notes"]
            for path, (local, full) in got[what].items():
                strat, _, fb = derive(path, tuple(full), layout, plan)
                assert tuple(local) == strat.shard_shape(tuple(full)), path
                assert notes.get(path, []) == list(fb), path
        (_, e, d, f), (lead, full_e, dd, ff) = \
            got["params"]["seg1/0/ffn/w_gate"]
        assert (2 * e, d, f) == (full_e, dd, ff)
    if name == "v2lite":
        ckv = runs["reports"]["two"][0]["serve"][name]["pool"]["seg0/0/ckv"]
        assert ckv[0] == ckv[1]


def test_three_ranks_serve_with_the_fallbacks(runs):
    """(1, 3): deepseek-v2-lite serves as the JAX Generator does on every
    rank; the four experts (4 % 3) replicate, as do the leaves whose heads
    do not divide, each with the note the reference's ``derive_param``
    records, and ``wq`` (4 heads x 96 = 384 columns) shards as the
    reference's divisibility rule keeps it."""
    layout = JaxLayout((1, 3), AXES)
    plan = jhs.ShardingPlan(fsdp=None)
    for rep in runs["reports"]["three"]:
        got = rep["serve"]["flat"]
        assert got["tokens"] == runs["want"]["flat"] == runs["port"]["flat"]
        for path, (local, full) in got["params"].items():
            strat, _, fb = jhs.derive_param(path, tuple(full), layout, plan)
            assert tuple(local) == strat.shard_shape(tuple(full)), path
            assert got["param_notes"].get(path, []) == list(fb), path
        notes = got["param_notes"]
        for leaf in ("w_gate", "w_up", "w_down"):
            assert f"seg1/0/ffn/{leaf}" in notes, leaf
        assert "seg0/0/attn/w_uk" in notes and "seg0/0/attn/wo" in notes
        wq = got["params"]["seg0/0/attn/wq"]
        assert 3 * wq[0][-1] == wq[1][-1]


def test_gshard_train_matches_the_unsharded_port(runs):
    """fsdp_tp on (1, 2) under gshard: loss, CE, grad norm and lr within
    1e-5 relative of the unsharded port's from the same state, the params
    within AdamW's bound."""
    got = runs["reports"]["two"][0]["train"]["gshard"]["hist"]
    hist, params = runs["train"]["gshard"]
    _close_hist(got, hist, 1e-5)
    assert got[-1]["loss"] != got[0]["loss"]
    bound = params_bound(params)
    for k, v in params.items():
        assert np.abs(runs["train_params"][k] - v).max() <= bound, k


def test_gshard_train_matches_the_reference_on_its_forced_mesh(runs):
    """The same run against the reference trainer on a forced two-device
    (1, 2) mesh with the same ShardingPlan: the history within 1e-4
    relative, the params within AdamW's bound."""
    _close_hist(runs["reports"]["two"][0]["train"]["gshard"]["hist"],
                runs["jhist"], 1e-4)
    bound = params_bound(runs["jparams"])
    assert sorted(runs["jparams"]) == sorted(runs["train_params"])
    for k, v in runs["jparams"].items():
        assert np.abs(runs["train_params"][k] - v).max() <= bound, k


def test_ragged_train_matches_the_unsharded_port(runs):
    """fsdp_tp on (1, 2) under ragged (each rank its two experts' rows
    through the grouped matmul and its backward, the rows past them
    masked): the history within 1e-5 relative of the unsharded port's."""
    got = runs["reports"]["two"][0]["train"]["ragged"]["hist"]
    _close_hist(got, runs["train"]["ragged"][0], 1e-5)
    assert got[-1]["loss"] != got[0]["loss"]


def test_train_shards_have_the_reference_shard_shape(runs):
    """Every rank's trained param shards under fsdp_tp on (1, 2), both
    dispatches, against the reference's ``derive_param``: the experts over
    ``model``, the router replicated."""
    layout = JaxLayout((1, 2), AXES)
    plan = jhs.ShardingPlan()
    for rep in runs["reports"]["two"]:
        for dispatch, run in rep["train"].items():
            for path, (local, full) in run["shards"].items():
                strat, _, _ = jhs.derive_param(path, tuple(full), layout,
                                               plan)
                assert tuple(local) == strat.shard_shape(tuple(full)), \
                    (dispatch, path)
            router = run["shards"]["seg1/0/ffn/router"]
            assert router[0] == router[1]


def test_ep_moe_shardmap_matches_the_reference(runs):
    """``ep_moe_shardmap`` on (1, 2) against the reference's on its forced
    (1, 2) mesh, at the reduced config's capacity factor: the output and
    the input's gradient of sum(y * w)."""
    got, want = runs["ep"], runs["jmoe"]
    assert np.abs(got["y"]).max() > 0
    assert np.abs(got["y"] - want["ep_y"]).max() <= 1e-5
    assert np.abs(got["gx"] - want["ep_gx"]).max() <= 1e-5 * max(
        1.0, float(np.abs(want["ep_gx"]).max()))


@pytest.mark.parametrize("mesh", ["data", "model"])
def test_dp_local_matches_gshard_and_the_reference(runs, mesh):
    """tests/test_overlap.py:39 on (2, 1) (the experts gathered over
    ``data``) and on (1, 2) (F over ``model``, the sequence over
    ``model``): within 1e-3 of gshard's output, equal to the reference's
    ``moe_dp_local`` on the same forced mesh, its gradients finite and
    ``w_gate``'s nonzero; the params placed by the ``dp`` rules
    (``moe_weights="dp"``: the experts over the fsdp axes, F over
    ``model``, the router replicated) with the reference's
    ``derive_param`` shard shapes."""
    got = runs["dp_local"]
    assert np.abs(got[mesh] - got["gshard"]).max() < 1e-3
    assert np.abs(got[mesh] - runs["jmoe"][mesh]).max() <= 1e-5
    shape = (2, 1) if mesh == "data" else (1, 2)
    layout = JaxLayout(shape, AXES)
    plan = jhs.ShardingPlan(moe_weights="dp")
    for rep in runs["reports"]["two"]:
        r = rep["dp_local"][mesh]
        assert r["finite"] and r["w_gate_max"] > 0
        for path, (local, full) in r["shards"].items():
            strat, _, _ = jhs.derive_param(path, tuple(full), layout, plan)
            assert tuple(local) == strat.shard_shape(tuple(full)), path
        assert r["shards"]["ffn/router"][0] == r["shards"]["ffn/router"][1]


def test_collective_matmul_matches_plain(runs):
    """tests/test_overlap.py:19's shapes: x (64, 32), its rows sharded over
    ``model``, by w (32, 16): the ring's product equals x @ w on every
    rank."""
    for rep in runs["reports"]["two"]:
        assert rep["cm"]["local_rows"] == [32, 32]
        assert rep["cm"]["err"] < 1e-4


@pytest.mark.parametrize("mode", ["ring", "head"])
def test_full_attention_takes_mla_head_dims_on_a_mesh(runs, mode):
    """``full_attention`` at the reduced MLA pair (Dk, Dv) = (96, 64) on
    (1, 2): in ring mode (the sequence over ``model``, the plain
    ``flash_chunk`` a K/V chunk) and in head mode (the heads over
    ``model``, flash under ``local_map``), the output and the q, k, v
    gradients within 1e-5 of the plain version's with no mesh."""
    for rep in runs["reports"]["two"]:
        got = rep["attention"][mode]
        assert got["placements"] == [None, 1 if mode == "ring" else 2]
        assert got["out"] <= 1e-5 and max(got["grads"]) <= 1e-5, got


@pytest.mark.parametrize("case", [
    ((10.0, 1.0, 8), {}, ">=", 0.875),
    ((10.0, 1.0, 32), {}, ">", 0.95),
    ((1.0, 1.0, 8), {}, "between", (0.8, 1.0)),
    ((0.1, 1.0, 8), {}, "<", 0.3),
    ((1.0, 1.0, 1), {"masking_floor": 0.6}, "==", 0.6),
])
def test_overlap_efficiency_model(case):
    """tests/test_overlap.py:7's values, each a case."""
    args, kw, op, want = case
    got = overlap_efficiency(*args, **kw)
    assert {">=": lambda: got >= want, ">": lambda: got > want,
            "<": lambda: got < want, "==": lambda: got == want,
            "between": lambda: want[0] < got < want[1]}[op]()


def test_train_launcher_on_three_ranks(runs):
    """``python -m repro_torch.launch.train --arch deepseek-v2-lite-16b
    --reduced --mesh auto --device cpu --steps 2 --global-batch 2`` on
    three gloo ranks: rank 0 logs the reference's line, the others print
    nothing."""
    outs = [rep["launcher"] for rep in runs["reports"]["three"]]
    assert "loss" in outs[0] and "grad_norm" in outs[0]
    assert outs[1] == outs[2] == ""
