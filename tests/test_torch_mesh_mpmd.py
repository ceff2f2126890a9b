"""HyperMPMD on the port: prefill/decode disaggregation and the RL roles
on CPU ranks, against the JAX ``Generator`` and the port's own aggregated,
unsharded and colocated runs.

Each run is one process per rank under gloo (``torch_mesh_mpmd_worker.py``,
a fresh interpreter each, joined through a ``FileStore`` file in the
test's temporary directory).  Params are the reference's ``init_model`` at
seed 0 in f32, bridged.  Two process sets, started together:

- four ranks: reduced qwen2-0.5b and deepseek-v2-lite (MLA, MoE) served on
  prefill and decode groups of 2 + 2 (the reference test's ``ServeConfig``
  and prompts, ``tests/test_hyperserve.py:201-217``) and one prompt served
  twice (the prefix cache never forks under disaggregation); one GRPO
  iteration with the learner on a ``(2, 2)`` mesh under fsdp_tp and the
  actor on the flat ``(1, 4)`` view; ``rl_disagg`` at 2 + 2 (the
  reference test's assertions, ``tests/test_rl.py:275-307``, on every
  rank);
- two ranks: the same serving at 1 + 1, and ``rl_disagg`` at 1 + 1 held
  bit for bit to a one-process colocated session (rank 0 runs it after);
  then both launchers on the two ranks (``--disaggregate``, ``--plan
  rl_disagg``).
"""
import copy
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from repro.serve.engine import GenerateConfig  # noqa: E402
from repro_torch.ckpt import checkpoint  # noqa: E402
from repro_torch.configs.base import RLConfig, ServeConfig  # noqa: E402
from repro_torch.core.tree import tree_flatten_with_path  # noqa: E402
from repro_torch.rl import GRPOLearner  # noqa: E402
from repro_torch.serve.api import HyperServe  # noqa: E402
from test_torch_serve import _generator, _models  # noqa: E402

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_mesh_mpmd_worker.py")
ARCHS = ("qwen2-0.5b", "deepseek-v2-lite-16b")
# tests/test_hyperserve.py:201-217 (the reference's disaggregation test)
SCFG = dict(block_size=4, num_blocks=48, max_blocks_per_req=8, max_slots=2,
            prefill_chunk=8)
PROMPTS = [list(range(1, 9)), list(range(5, 10))]
NEW = 5
PREFIX_PROMPT = list(range(1, 10))
# tests/test_rl.py:275-307 (the reference's rl_disagg test)
RL = dict(group_size=2, max_new_tokens=5, temperature=1.0, lr=1e-3)
RL_SCFG = dict(block_size=4, num_blocks=64, max_blocks_per_req=8,
               max_slots=2, prefill_chunk=8, enable_prefix_cache=False)
RL_PROMPTS = [list(range(1, 7))]
PROBE = list(range(1, 9))
# the mesh learner: two groups of four, rows over the data axis of 2
RL_MESH = dict(RL, group_size=4)
RL_MESH_PROMPTS = [list(range(1, 7)), list(range(3, 9))]
# process set -> (world, prefill ranks, tasks)
SETS = {
    "four": (4, 2, ["serve", "prefix", "rl_mesh", "rl_disagg"]),
    "two": (2, 1, ["serve", "rl_disagg", "launchers"]),
}


def _start(tmp, name, ckpts):
    world, n_prefill, tasks = SETS[name]
    out = tmp / name
    out.mkdir()
    spec = dict(store=str(out / "store"), out=str(out), tasks=tasks,
                ckpt=ckpts, archs=list(ARCHS), n_prefill=n_prefill,
                scfg=SCFG, prompts=PROMPTS, max_new=NEW,
                prefix_prompt=PREFIX_PROMPT, rl=RL, rl_scfg=RL_SCFG,
                rl_prompts=RL_PROMPTS, probe=PROBE, rl_mesh=RL_MESH,
                rl_mesh_prompts=RL_MESH_PROMPTS, colocated=name == "two")
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


def _jax_tokens(arch, jparams, prompt, n):
    """The reference Generator's greedy tokens (its cached instance, on
    ``jparams`` when given)."""
    gen = _generator(arch)
    if jparams is not None:
        gen = copy.copy(gen)
        gen.params = jparams
    return gen.generate(jnp.asarray(prompt, jnp.int32)[None, :],
                        GenerateConfig(max_new_tokens=n))[0, len(prompt):] \
        .tolist()


def _params(npz, prefix=""):
    return {k[len(prefix):]: npz[k] for k in npz.files
            if k.startswith(prefix)}


def _to_jax(flat, like_tp, jp):
    """Flat port params (path -> array) as the reference's pytree."""
    leaves = [jnp.asarray(flat[p]) for p, _ in
              tree_flatten_with_path(like_tp)]
    return jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(jp),
                                        leaves)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both process sets started at once (params written first), then,
    while they run, the JAX Generator's and the aggregated port's tokens;
    after, the unsharded learner on the mesh run's batch and the
    Generator on the published params."""
    tmp = tmp_path_factory.mktemp("mesh_mpmd")
    ckpts = {}
    for arch in ARCHS:
        ckpts[arch] = str(tmp / arch)
        checkpoint.save(ckpts[arch], 0, _models(arch)[3])
    procs = {n: _start(tmp, n, ckpts) for n in SETS}

    want, agg = {}, {}
    for arch in ARCHS:
        _, cfg, _, tp = _models(arch)
        want[arch] = [_jax_tokens(arch, None, p, NEW) for p in PROMPTS]
        server = HyperServe(cfg, tp, serve_cfg=ServeConfig(**SCFG),
                            device="cpu")
        rids = [server.submit(p, NEW) for p in PROMPTS]
        out = server.join()
        agg[arch] = [out[r] for r in rids]
    _, cfg, jp, tp = _models("qwen2-0.5b")
    server = HyperServe(cfg, tp, serve_cfg=ServeConfig(**SCFG), device="cpu")
    prefix = []
    for _ in range(2):
        rid = server.submit(PREFIX_PROMPT, NEW)
        prefix.append(server.join()[rid])
    agg_prefix = dict(tokens=prefix,
                      prefix_hits=server.stats()["prefix_hits"])

    reports = {n: _wait(n, *procs[n]) for n in SETS}

    mesh = np.load(tmp / "four" / "rl_mesh.npz")
    batch = _params(mesh, "batch/")
    learner = GRPOLearner(cfg, rl_cfg=RLConfig(**RL_MESH), params=tp,
                          device="cpu")
    unsharded = learner.update(batch)
    params1 = {k: v.numpy() for k, v in
               tree_flatten_with_path(learner.params)}
    unsharded2 = learner.update(batch)
    published = {
        "mesh": _params(mesh, "params/"),
        "disagg": dict(np.load(tmp / "four" / "disagg_params.npz"))}
    probes = {k: _jax_tokens("qwen2-0.5b", _to_jax(v, tp, jp), PROBE, NEW)
              for k, v in published.items()}
    two = tmp / "two"
    return dict(
        want=want, agg=agg, agg_prefix=agg_prefix, reports=reports,
        unsharded=dict(metrics=unsharded, metrics2=unsharded2,
                       params=params1),
        published=published, probes=probes,
        bitwise=dict(disagg=dict(np.load(two / "disagg_params.npz")),
                     batch=dict(np.load(two / "disagg_batch.npz")),
                     colocated=dict(np.load(two / "colocated.npz"))))


@pytest.mark.parametrize("world", ["four", "two"])
@pytest.mark.parametrize("arch", ARCHS)
def test_disaggregated_serving_matches_generator(runs, arch, world):
    """Prefill and decode groups of 2 + 2 and 1 + 1: every rank's greedy
    tokens equal the JAX Generator's and the aggregated port HyperServe's,
    for attention K/V pages and MLA latent pages alike."""
    for rank, rep in enumerate(runs["reports"][world]):
        got = rep["serve"][arch]["tokens"]
        assert got == runs["want"][arch] == runs["agg"][arch], (rank, got)


@pytest.mark.parametrize("world", ["four", "two"])
def test_disaggregated_prefill_runs_on_the_prefill_ranks(runs, world):
    """Both prompts prefill in one dense call of two rows padded to the
    chunk (``dense_prefill`` key (2, 8), one MPMD task of the prefill
    group counted on every rank), no rank runs the paged prefill, and the
    decode ranks' stats (``prefill_calls`` 1, ``prefill_chunks`` 2) reach
    every rank."""
    n_prefill = SETS[world][1]
    for rank, rep in enumerate(runs["reports"][world]):
        for arch in ARCHS:
            got = rep["serve"][arch]
            assert got["role"] == ("prefill" if rank < n_prefill
                                   else "decode")
            assert got["prefill_calls"] == 1 and got["prefill_chunks"] == 2
            assert got["dense_prefill"] == [[2, 8]]
            assert got["paged_prefill"] == 0 and got["tasks"] == 1


def test_prefix_cache_never_forks_under_disaggregation(runs):
    """One prompt served twice: the aggregated engine forks its cached
    prefix blocks, the disaggregated one prefills the whole prompt again
    (the dense cache is seated whole, which would write through shared
    blocks), with the same tokens."""
    assert runs["agg_prefix"]["prefix_hits"] >= 1
    for rep in runs["reports"]["four"]:
        got = rep["prefix"]
        assert got["prefix_hits"] == 0
        assert got["tokens"] == runs["agg_prefix"]["tokens"]


def test_learner_on_a_mesh_matches_the_unsharded_learner(runs):
    """One GRPO update with the learner on a (2, 2) mesh under fsdp_tp
    (the batch's rows over the data axis) and the actor on the flat (1, 4)
    view: the update's metrics (loss, ratio, clip fraction, grad norm, ...)
    within 1e-5 x max(1, |x|) of the unsharded port learner on the same
    batch, on every rank.  The first update's metrics are read before it
    moves anything, so a second update on the same batch is held to the
    unsharded learner's second the same way: its loss, ratio and grad norm
    are read off the params and AdamW state the first left on the mesh,
    and they differ from the first's by many times that tolerance, so a
    wrong or missing first step shows.  Every param leaf after the first
    step lies within AdamW's bound of one step, 2 lr (its first step moves
    an entry by lr g / (|g| + eps), so a gradient entry that rounding
    takes across zero, or one within a few eps of it, moves by up to
    2 lr, as ``tests/test_torch_mesh_train.py`` bounds its params); the
    mesh learner moves the params."""
    ref = runs["unsharded"]
    assert ref["metrics"]["grad_norm"] > 0
    for k in ("loss", "ratio_mean", "grad_norm"):
        a, b = ref["metrics"][k], ref["metrics2"][k]
        assert abs(b - a) > 100 * 1e-5 * max(1.0, abs(b)), k
    for rep in runs["reports"]["four"]:
        got = rep["rl_mesh"]
        assert got["learner_mesh"] == [2, 2] and got["actor_mesh"] == [1, 4]
        assert got["dp"] == 2
        for which in ("metrics", "metrics2"):
            for k, v in ref[which].items():
                assert abs(got[which][k] - v) <= 1e-5 * max(1.0, abs(v)), \
                    (which, k)
        assert got["metrics"]["weights_version"] == 1
    before = {k: t.numpy() for k, t in
              tree_flatten_with_path(_models("qwen2-0.5b")[3])}
    moved = 0
    for k, v in ref["params"].items():
        g = runs["published"]["mesh"][k]
        assert np.abs(g - v).max() <= 2 * RL_MESH["lr"], k
        moved += not np.array_equal(g, before[k])
    assert moved == len(before)


def test_probe_after_a_mesh_publish_is_the_generator(runs):
    """After the publish from the (2, 2) learner into the (1, 4) actor,
    every rank's greedy probe equals the JAX Generator on the published
    params."""
    for rep in runs["reports"]["four"]:
        assert rep["rl_mesh"]["probe"] == runs["probes"]["mesh"]


def test_rl_disagg_two_plus_two_as_the_reference(runs):
    """``rl_disagg`` on 2 + 2 ranks, the reference test's assertions on
    every rank: the groups are exactly actor and learner, the actor
    serves on its group's mesh, the iteration publishes version 1, the
    greedy probe equals the JAX Generator on the published params, and
    the utilization report holds both roles, the same on every rank, as
    the metrics are."""
    reps = [r["rl_disagg"] for r in runs["reports"]["four"]]
    for rank, got in enumerate(reps):
        assert got["groups"] == ["actor", "learner"]
        assert got["role"] == ("actor" if rank < 2 else "learner")
        assert got["actor_on_group_mesh"]
        assert got["metrics"]["weights_version"] == 1
        assert got["probe"] == runs["probes"]["disagg"]
        assert set(got["util"]) >= {"actor", "learner"}
        assert got["util"] == reps[0]["util"]
        assert got["metrics"] == reps[0]["metrics"]
        assert got["stats_updates"] == 1


@pytest.mark.parametrize("world", ["four", "two"])
def test_mpmd_tasks_are_counted_on_every_rank(runs, world):
    """Every rank counts one actor task (the rollout) and one learner task
    (the update) of the iteration, its own role's and the peer's."""
    for rep in runs["reports"][world]:
        assert rep["rl_disagg"]["tasks"] == {"actor": 1, "learner": 1}


def test_rl_disagg_one_plus_one_is_the_colocated_session(runs):
    """``rl_disagg`` on 1 + 1 ranks against a one-process colocated
    session from the same params and seed: the rollouts (tokens and
    logprobs in the learner batch), the loss and every param after the
    update identical, bit for bit (the same kernels on the same tensors,
    the hand-offs exact byte copies)."""
    bw = runs["bitwise"]
    col = bw["colocated"]
    for k, v in bw["batch"].items():
        assert np.array_equal(v, col[f"batch/{k}"]), k
    assert sorted(bw["disagg"]) == sorted(k[len("params/"):] for k in col
                                          if k.startswith("params/"))
    for k, v in bw["disagg"].items():
        assert np.array_equal(v, col[f"params/{k}"]), k
    reps = [r["rl_disagg"] for r in runs["reports"]["two"]]
    cm = reps[0]["colocated_metrics"]
    for got in reps:
        assert got["metrics"]["loss"] == cm["loss"]
        assert got["metrics"]["ratio_mean"] == cm["ratio_mean"]
        assert got["probe"] == reps[0]["probe"]


def test_serving_launcher_disaggregates_two_ranks(runs):
    """``python -m repro_torch.launch.serve --disaggregate --device cpu``
    on two ranks: rank 0 reports the two groups (prefill rank 0, decode
    rank 1) and every request served; rank 1 prints nothing."""
    outs = [r["launchers"]["serve"] for r in runs["reports"]["two"]]
    assert "served 3 requests" in outs[0]
    assert "prefill ranks [0], decode ranks [1]" in outs[0]
    assert outs[1] == ""


def test_rl_launcher_runs_rl_disagg_on_two_ranks(runs):
    """``python -m repro_torch.launch.rl --plan rl_disagg --device cpu`` on
    two ranks: two iterations (v1, v2), the per-role busy seconds of both
    roles, two updates; only rank 0 prints."""
    outs = [r["launchers"]["rl"] for r in runs["reports"]["two"]]
    lines = outs[0].strip().splitlines()
    assert lines[0].startswith("iter 0: loss=") and lines[0].endswith(" v1")
    assert lines[1].startswith("iter 1: loss=") and lines[1].endswith(" v2")
    assert lines[2].startswith("per-role busy seconds:")
    assert "'actor'" in lines[2] and "'learner'" in lines[2]
    assert lines[-1].endswith("2 updates, weights v2")
    assert outs[1] == ""
