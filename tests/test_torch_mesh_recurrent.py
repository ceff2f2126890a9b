"""The port's recurrent and multimodal families on CPU meshes (SSD, RG-LRU,
the multimodal prefix) and the composed lowering on a mesh, against the
port's unsharded runs, the reference trainer on its forced mesh and the
JAX ``Generator``.

Each mesh run is one process per rank under gloo
(``torch_mesh_recurrent_worker.py``, a fresh interpreter each, joined
through a ``FileStore`` file in the test's temporary directory).  Params
are the reference's ``init_model`` at seed 0 in f32, bridged (the cached
reduced models of ``tests/test_torch_serve.py``).  Two process sets,
beside one JAX subprocess on a forced four-device (2, 2) mesh (the
reference trainer on mamba2-370m, and its multimodal step on
musicgen-large with the same seeded prefix):

- 4 ranks on ``(2, 2)`` under fsdp_tp: 3 train steps of 2 x 32 tokens of
  reduced mamba2-370m (the SSD scan and its backward on each rank's rows
  and heads), recurrentgemma-2b cut to 3 layers with a window of 8 (the
  RG-LRU scan and its backward on each rank's rows and channels, the
  LOCAL_ATTN layer's windowed flash) and musicgen-large with 8 seeded
  prefix frames a row, each held to the unsharded port (history to 1e-5
  relative, every gradient leaf of the first batch to 1e-5 x max(1, max
  |grad|)), mamba2 and musicgen also to the reference on its forced mesh
  (1e-4, the params within AdamW's bound); each rank's shard shapes
  against the reference's ``derive_param``; and both scans on DTensors
  under grad, whose shared inputs' gradients (A and log_a over the rows,
  B and C over the heads) come back ``Partial`` and sum to the unsharded
  gradient;
- 2 ranks on ``(1, 2)``: the composed lowering serving reduced
  qwen2-0.5b, recurrentgemma-2b (5 layers, a window of 16, generation
  past it) and deepseek-v2-lite-16b (MLA's composed decode), every rank's
  greedy tokens equal to the JAX ``Generator``'s and the unsharded fused
  port's; internvl2-26b and musicgen-large served text-only on the mesh
  as without it; ``decode_attention`` on DTensors (KV heads sharded,
  windowed, one KV head replicated); and the train launcher on
  mamba2-370m and the serving launcher with ``--kernels composed``, both
  ``--mesh auto``.
"""
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
from tests.test_torch_serve import _generator, _models  # noqa: E402
from repro.core import hypershard as jhs  # noqa: E402
from repro.core.layout import Layout as JaxLayout  # noqa: E402
from repro.optim import adamw as jax_opt  # noqa: E402
from repro.serve.engine import GenerateConfig  # noqa: E402
from repro_torch.ckpt import checkpoint  # noqa: E402
from repro_torch.configs.base import ServeConfig  # noqa: E402
from repro_torch.core.tree import tree_flatten_with_path  # noqa: E402
from repro_torch.data.pipeline import DataConfig, make_loader  # noqa: E402
from repro_torch.models.bridge import adamw_state_from_numpy  # noqa: E402
from repro_torch.optim import adamw as opt  # noqa: E402
from repro_torch.serve.api import HyperServe  # noqa: E402
from repro_torch.train import steps  # noqa: E402

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_mesh_recurrent_worker.py")
AXES = ("data", "model")
STEPS, SEQ, BATCH = 3, 32, 2
# name -> (arch, overrides, with a prefix)
TRAIN = {
    "mamba2": ("mamba2-370m", (), False),
    # a third layer, its LOCAL_ATTN, and a window below the sequence
    "recurrentgemma": ("recurrentgemma-2b",
                       (("num_layers", 3), ("sliding_window", 8)), False),
    "musicgen": ("musicgen-large", (), True),
}
# the leaves whose gradients only a sum over the ranks makes whole
NAMED = {"mamba2": ("seg0/0/mixer/A_log", "seg0/0/mixer/in_proj"),
         "recurrentgemma": ("seg0/0/mixer/lambda",),
         "musicgen": ("frontend_proj",)}
SMALL = dict(block_size=4, num_blocks=48, max_blocks_per_req=8, max_slots=2,
             prefill_chunk=4)
TWO = [list(range(1, 9)), list(range(5, 10))]
# name -> (arch, overrides, ServeConfig knobs, prompts, new tokens)
SERVE = {
    # tests/test_hyperserve.py:154's qwen2 case
    "qwen2": ("qwen2-0.5b", (), dict(SMALL, kernels="composed"),
              [list(range(1, 9)), list(range(20, 33))], [5, 5]),
    # tests/test_torch_serve.py's windowed hybrid: generation past the
    # window of 16, so the composed decode masks and blocks are freed
    "recurrentgemma": ("recurrentgemma-2b",
                       (("num_layers", 5), ("sliding_window", 16)),
                       dict(block_size=4, num_blocks=40,
                            max_blocks_per_req=12, max_slots=2,
                            prefill_chunk=4, kernels="composed"),
                       [list(range(1, 9)), list(range(20, 33))], [20, 16]),
    # tests/test_hyperserve.py:300's MLA case
    "v2lite": ("deepseek-v2-lite-16b", (), dict(
        block_size=4, num_blocks=40, max_blocks_per_req=8, max_slots=3,
        prefill_chunk=4, kernels="composed"),
        [list(range(1, 9)), list(range(20, 33)), list(range(5, 10))],
        [6, 4, 8]),
    # the multimodal archs, text-only, composed and fused
    "internvl2": ("internvl2-26b", (), dict(SMALL, kernels="composed"), TWO,
                  [5, 5]),
    "musicgen": ("musicgen-large", (), dict(SMALL, kernels="fused"), TWO,
                 [5, 5]),
}
GENERATOR_CASES = ("qwen2", "recurrentgemma", "v2lite")
# process set -> (world, mesh shape, tasks)
SETS = {
    "train": (4, (2, 2), ["train", "scans"]),
    "serve": (2, (1, 2), ["serve", "decode", "launcher"]),
}

JAX_CODE = """
import dataclasses, json
import jax, numpy as np
from repro.configs.base import ShapeConfig, get_config
from repro.core.hypershard import ShardingPlan
from repro.data.pipeline import DataConfig, make_loader
from repro.launch.mesh import make_host_mesh
from repro.optim.adamw import AdamWConfig
from repro.train import steps, trainer
mesh = make_host_mesh((2, 2))

def save(name, params, hist):
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    np.savez("{out}/j_" + name + ".npz", **{{
        "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp):
        np.asarray(v, np.float32) for kp, v in flat}})
    print("HIST" + name + " " + json.dumps(
        [{{k: float(v) for k, v in m.items()}} for m in hist]))

cfg = dataclasses.replace(get_config("mamba2-370m").reduced(),
                          dtype="float32")
params, hist = trainer.train(
    cfg, ShapeConfig("t", {seq}, {batch}, "train"), mesh=mesh,
    plan=ShardingPlan(),
    train_cfg=trainer.TrainConfig(num_steps={steps}, log_every=1))
save("mamba2", params, hist)

cfg = dataclasses.replace(get_config("musicgen-large").reduced(),
                          dtype="float32")
step, sh = steps.make_train_step(cfg, mesh, ShardingPlan(),
                                 AdamWConfig(total_steps={steps}),
                                 multimodal=True)
params, state = steps.init_state(cfg, mesh, ShardingPlan(), seed=0)
loader = make_loader(DataConfig(vocab_size=cfg.vocab_size, seq_len={seq},
                                global_batch={batch}), mesh)
prefix = np.load("{prefix}")["prefix"]
hist = []
for pe, batch in zip(prefix, loader):
    batch["prefix_embeds"] = jax.device_put(pe, sh["batch"]["prefix_embeds"])
    params, state, m = step(params, state, batch)
    hist.append(m)
save("musicgen", params, hist)
"""


def _flat_np(tree):
    return {k: v.detach().numpy() for k, v in tree_flatten_with_path(tree)}


def _start(tmp, name, files):
    world, shape, tasks = SETS[name]
    out = tmp / name
    out.mkdir()
    spec = dict(store=str(out / "store"), shape=list(shape), out=str(out),
                tasks=tasks, steps=STEPS, seq=SEQ, batch=BATCH, train={},
                cases={})
    if "train" in tasks:
        for case, (arch, over, mm) in TRAIN.items():
            spec["train"][case] = dict(
                arch=arch, overrides=dict(over), start=files[case],
                prefix=files["prefix"] if mm else None)
    if "serve" in tasks:
        for case, (arch, over, scfg, prompts, max_new) in SERVE.items():
            spec["cases"][case] = dict(
                arch=arch, overrides=dict(over), scfg=scfg,
                prompts=prompts, max_new=max_new,
                ckpt=files[("serve", arch, over)])
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


def _port_train(cfg, p0, o0, prefix):
    """The unsharded port's history, first gradient and final params from
    the same state, batches and prefix."""
    step = steps.make_train_step(cfg, opt.AdamWConfig(total_steps=STEPS),
                                 multimodal=prefix is not None)
    loader = make_loader(DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                    global_batch=BATCH), "cpu")
    batches = [next(loader) for _ in range(STEPS)]
    if prefix is not None:
        for b, pe in zip(batches, prefix):
            b["prefix_embeds"] = torch.from_numpy(pe)
    _, grads = steps.value_and_grad(p0, batches[0], cfg,
                                    prefix_embeds=batches[0].get(
                                        "prefix_embeds"))
    p, o, hist = p0, o0, []
    for b in batches:
        p, o, m = step(p, o, b)
        hist.append({k: float(v) for k, v in m.items()})
    return dict(hist=hist, grads=_flat_np(grads), params=_flat_np(p))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start states and the prefix written first; both process sets and
    the JAX subprocess started at once; while they run, the unsharded
    port's train runs and the JAX ``Generator``'s and the unsharded fused
    port's tokens of every serving case."""
    tmp = tmp_path_factory.mktemp("mesh_recurrent")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)        # beside six single-threaded ranks
    try:
        return _runs(tmp)
    finally:
        torch.set_num_threads(threads)


def _runs(tmp):
    files, starts = {}, {}
    for case, (arch, over, mm) in TRAIN.items():
        jcfg, cfg, jp, tp = _models(arch, over)
        o0 = adamw_state_from_numpy(
            jax.tree.map(np.asarray, jax_opt.init_adamw(jp)), "cpu")
        files[case] = str(tmp / f"start_{case}")
        checkpoint.save(files[case], 0, tp, o0)
        starts[case] = (cfg, tp, o0)
    mcfg = starts["musicgen"][0]
    prefix = np.random.default_rng(17).standard_normal(
        (STEPS, BATCH, mcfg.num_prefix_tokens, mcfg.frontend_dim)).astype(
        np.float32)
    files["prefix"] = str(tmp / "prefix.npz")
    np.savez(files["prefix"], prefix=prefix)
    for case, (arch, over, *_) in SERVE.items():
        key = ("serve", arch, over)
        if key not in files:
            files[key] = str(tmp / f"serve_{case}")
            checkpoint.save(files[key], 0, _models(arch, over)[3])
    procs = {n: _start(tmp, n, files) for n in SETS}
    jax_out = {}

    def jax_on_mesh():
        try:
            jax_out["out"] = run_subprocess(JAX_CODE.format(
                seq=SEQ, batch=BATCH, steps=STEPS, out=tmp,
                prefix=files["prefix"]), devices=4, timeout=600)
        except Exception as e:          # re-raised on the test's thread
            jax_out["error"] = e
    thread = threading.Thread(target=jax_on_mesh)
    thread.start()

    port = {case: _port_train(cfg, p0, o0,
                              prefix if TRAIN[case][2] else None)
            for case, (cfg, p0, o0) in starts.items()}
    want, unsharded = {}, {}
    for case, (arch, over, scfg, prompts, max_new) in SERVE.items():
        _, cfg, _, tp = _models(arch, over)
        if case in GENERATOR_CASES:
            gen = _generator(arch, over)
            want[case] = [gen.generate(jnp.asarray(p, jnp.int32)[None, :],
                                       GenerateConfig(max_new_tokens=n))
                          [0, len(p):].tolist()
                          for p, n in zip(prompts, max_new)]
        server = HyperServe(cfg, tp, serve_cfg=ServeConfig(
            **dict(scfg, kernels="fused")), device="cpu")
        rids = [server.submit(p, n) for p, n in zip(prompts, max_new)]
        out = server.join()
        unsharded[case] = [out[r] for r in rids]

    reports = {n: _wait(n, *procs[n]) for n in SETS}
    thread.join()
    if "error" in jax_out:
        raise jax_out["error"]
    jhist = {ln[4:].split(" ", 1)[0]: json.loads(ln[4:].split(" ", 1)[1])
             for ln in jax_out["out"].splitlines() if ln.startswith("HIST")}
    train_dir = tmp / "train"
    mesh = {case: dict(
        grads=dict(np.load(train_dir / f"{case}_grads.npz")),
        params=dict(np.load(train_dir / f"{case}_params.npz")))
        for case in TRAIN}
    scans = {name: dict(np.load(train_dir / f"scan_{name}.npz"))
             for name in ("ssd", "rglru")}
    return dict(port=port, mesh=mesh, reports=reports, scans=scans,
                jhist=jhist, jparams={c: dict(np.load(tmp / f"j_{c}.npz"))
                                      for c in jhist},
                want=want, unsharded=unsharded)


def _close_hist(a, b, rel, keys=("loss", "ce", "grad_norm", "lr")):
    assert len(a) == len(b) == STEPS
    for x, y in zip(a, b):
        for k in keys:
            assert abs(x[k] - y[k]) <= rel * max(1.0, abs(y[k])), (k, x, y)


@pytest.mark.parametrize("case", list(TRAIN))
def test_mesh_train_matches_the_unsharded_port(runs, case):
    """fsdp_tp on (2, 2): loss, CE, grad norm and lr within 1e-5 relative
    of the unsharded port's from the same state, batches and prefix, the
    params within AdamW's bound, every rank's history the same."""
    hists = [rep["train"][case]["hist"] for rep in runs["reports"]["train"]]
    assert all(h == hists[0] for h in hists)
    want = runs["port"][case]
    _close_hist(hists[0], want["hist"], 1e-5)
    assert hists[0][-1]["loss"] != hists[0][0]["loss"]
    bound = params_bound(want["params"])
    got = runs["mesh"][case]["params"]
    for k, v in want["params"].items():
        assert np.abs(got[k] - v).max() <= bound, k


@pytest.mark.parametrize("case", list(TRAIN))
def test_mesh_grads_match_the_unsharded_port(runs, case):
    """Every gradient leaf of the first batch within 1e-5 x max(1, max
    |grad|) of the unsharded port's, the leaves that only a sum over the
    ranks makes whole among them: A_log (the SSD scan's A, summed over
    the rows), in_proj (its B and C columns, summed over the heads),
    lambda (the RG-LRU scan's log_a, summed over the rows) and the
    prefix's frontend_proj."""
    want, got = runs["port"][case]["grads"], runs["mesh"][case]["grads"]
    assert sorted(got) == sorted(want)
    for name in NAMED[case]:
        assert name in want and np.abs(want[name]).max() > 0, name
    for k, g in want.items():
        tol = 1e-5 * max(1.0, float(np.abs(g).max()))
        assert np.abs(got[k] - g).max() <= tol, k


@pytest.mark.parametrize("case", ["mamba2", "musicgen"])
def test_mesh_train_matches_the_reference_on_its_forced_mesh(runs, case):
    """The same runs against the reference on a forced four-device (2, 2)
    mesh with the same ShardingPlan (its trainer for mamba2, its
    multimodal step with the same prefix for musicgen): the history within
    1e-4 relative, the params within AdamW's bound."""
    _close_hist(runs["reports"]["train"][0]["train"][case]["hist"],
                runs["jhist"][case], 1e-4)
    want, got = runs["jparams"][case], runs["mesh"][case]["params"]
    assert sorted(want) == sorted(got)
    bound = params_bound(want)
    for k, v in want.items():
        assert np.abs(got[k] - v).max() <= bound, k


@pytest.mark.parametrize("case", list(TRAIN))
def test_train_shards_have_the_reference_shard_shape(runs, case):
    """Every rank's trained param shards under fsdp_tp on (2, 2) against
    the reference's ``derive_param`` (``conv_w``, ``A_log``, ``D``,
    ``dt_bias`` and ``lambda`` replicated), ``bridge.shard_params``
    placing every leaf as the step's shardings do, and the prefix's rows
    over ``data``."""
    layout = JaxLayout((2, 2), AXES)
    plan = jhs.ShardingPlan()
    for rep in runs["reports"]["train"]:
        run = rep["train"][case]
        assert run["bridge"]
        for path, (local, full) in run["shards"].items():
            strat, _, _ = jhs.derive_param(path, tuple(full), layout, plan)
            assert tuple(local) == strat.shard_shape(tuple(full)), path
        if TRAIN[case][2]:
            assert run["prefix_placements"] == ["Shard", "Replicate"]


@pytest.mark.parametrize("name", ["ssd", "rglru"])
def test_scans_on_dtensors_sum_their_shared_gradients(runs, name):
    """``ssd_scan`` (x, dt with rows over ``data`` and heads over
    ``model``, A replicated, B and C with rows over ``data``) and
    ``rglru_scan`` (x and both gates with rows and channels sharded,
    log_a replicated) under grad on (2, 2): the output and every input's
    gradient within 1e-5 x max(1, max |value|) of the unsharded call's,
    and the same of ``ssd_scan_bwd`` and ``rglru_scan_bwd`` called on
    DTensors directly.  Each rank's call sees a part of a shared input's
    uses (A's and log_a's over the rows, B's and C's over the heads), so
    these are right only where the scans return them ``Partial`` over
    those mesh dims, to be summed."""
    got = runs["scans"][name]
    n = 6 if name == "ssd" else 5           # the output, then each input
    assert len(got) == 2 * n + 2 * (n - 1)
    for key in [f"{{}}{i}" for i in range(n)] \
            + [f"bwd_{{}}{i}" for i in range(n - 1)]:
        want = got[key.format("want")]
        tol = 1e-5 * max(1.0, float(np.abs(want).max()))
        assert np.abs(got[key.format("got")] - want).max() <= tol, (name,
                                                                     key)


@pytest.mark.parametrize("case", GENERATOR_CASES)
def test_composed_serving_on_a_mesh_matches_the_generator(runs, case):
    """(1, 2) with ``kernels="composed"``: every rank's greedy tokens equal
    the JAX Generator's and the unsharded fused port's (each rank gathers
    its shard of the pages and runs ``decode_attention`` and flash on its
    heads; recurrentgemma's single KV head replicated, past its window;
    deepseek-v2-lite's absorbed MLA decode on its heads), every decode
    step counted on the composed path."""
    for rank, rep in enumerate(runs["reports"]["serve"]):
        got = rep["serve"][case]
        assert got["path"] == "composed" and got["counted"] > 0
        assert got["tokens"] == runs["want"][case] \
            == runs["unsharded"][case], (case, rank)


@pytest.mark.parametrize("case", ["internvl2", "musicgen"])
def test_prefix_archs_serve_text_only_on_a_mesh(runs, case):
    """internvl2-26b (composed) and musicgen-large (fused) on (1, 2),
    text-only as the reference's HyperServe serves them: every rank's
    greedy tokens equal the unsharded fused port's."""
    for rep in runs["reports"]["serve"]:
        got = rep["serve"][case]
        assert got["path"] == SERVE[case][2]["kernels"]
        assert got["tokens"] == runs["unsharded"][case]


@pytest.mark.parametrize("name", ["sharded", "windowed", "one_kv_head"])
def test_decode_attention_on_dtensors(runs, name):
    """``decode_attention`` on DTensors over (1, 2): q (3, 1, 4, 64) with
    its heads over ``model``, the caches' two KV heads sharded alike
    (plain and with a window of 8) or one KV head replicated; the output
    within 1e-6 of the plain call's on the full tensors, its heads
    sharded where the caches' are and whole on every rank where they
    replicate."""
    for rep in runs["reports"]["serve"]:
        got = rep["decode"][name]
        assert got["err"] <= 1e-6, got
        assert got["placements"] == ([None, None] if name == "one_kv_head"
                                     else [None, 2])


@pytest.mark.parametrize("which", ["train", "serve"])
def test_launchers_on_a_mesh(runs, which):
    """``python -m repro_torch.launch.train --arch mamba2-370m --mesh auto``
    and ``python -m repro_torch.launch.serve --arch qwen2-0.5b
    --continuous --kernels composed --mesh auto`` (both ``--reduced
    --device cpu``) on two gloo ranks: rank 0 logs, rank 1 prints
    nothing."""
    outs = [rep["launcher"][which] for rep in runs["reports"]["serve"]]
    if which == "train":
        assert "loss" in outs[0] and "grad_norm" in outs[0]
    else:
        assert "mesh (1, 2)" in outs[0] and "served 2 requests" in outs[0]
    assert outs[1] == ""
