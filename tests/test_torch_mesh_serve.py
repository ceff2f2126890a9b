"""The port's HyperServe on CPU meshes, against the JAX ``Generator`` and
the port's unsharded ``HyperServe``.

Each mesh run is one process per rank under gloo
(``torch_mesh_serve_worker.py``, a fresh interpreter each, joined through
a ``FileStore`` file in the test's temporary directory).  Params are the
reference's ``init_model`` at seed 0 in f32, bridged; configs and
``ServeConfig``s are the reference's own mesh tests' (``tests/
test_hyperserve.py``).  Two process sets:

- ``(1, 2)`` under ``ShardingPlan(fsdp=None)``: reduced qwen2-0.5b (two KV
  heads: the pool sharded on them), mamba2-370m (16 SSD heads: seat state
  and conv tails sharded) and recurrentgemma-2b cut to 3 layers with a
  16-token window (one KV head: the pool replicated with a recorded
  fallback, the RG-LRU channels sharded), each rank's greedy tokens equal
  to the JAX ``Generator``'s and the unsharded port's; the batched
  prefill (chunks > calls); forced preemptions of qwen2 and of the
  hybrid (pages and seat rows through the host archive, each rank its own
  shard); each rank's pool leaves shaped as the reference's
  ``derive_pool`` shards them; qwen2 preempted under a small host
  budget, the archive's tiers, bytes and evictions after every step equal
  to the reference HyperServe's on a forced 2-device mesh (global bytes);
  qwen2's gathered pool and first decode logits within 1e-5 x max(1, |x|)
  of the unsharded port's (``wo``'s partial sums taken in another order);
- 3 ranks: a ``(3, 1)`` mesh refused for its data axis, an fsdp plan and
  a plan that is not a ``ShardingPlan`` refused with typed errors naming
  their rule or ROADMAP item, while engines of the multimodal prefix and
  of the composed lowering are built; ``serving_mesh_for`` gives the
  flat ``(1, 3)`` view,
  which serves qwen2 as the JAX ``Generator`` does with the vocabulary
  (1024 % 3) and KV-head (2 % 3) fallbacks; and the serving launcher's
  ``--mesh auto`` on the three ranks.
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

from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.core import hypershard as jhs  # noqa: E402
from repro.core.layout import Layout as JaxLayout  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve.engine import GenerateConfig, Generator  # noqa: E402
from tests.conftest import run_subprocess  # noqa: E402
from repro_torch.ckpt import checkpoint  # noqa: E402
from repro_torch.configs.base import ServeConfig, get_config  # noqa: E402
from repro_torch.core.tree import tree_flatten_with_path  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402
from repro_torch.serve.api import HyperServe  # noqa: E402

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_mesh_serve_worker.py")
AXES = ("data", "model")
HYBRID = {"num_layers": 3, "sliding_window": 16}
SMALL = dict(block_size=4, num_blocks=48, max_blocks_per_req=8, max_slots=2,
             prefill_chunk=4)
TWO = [list(range(1, 9)), list(range(5, 10))]
# name -> (arch, overrides, ServeConfig knobs, prompts, new tokens)
CASES = {
    # tests/test_hyperserve.py:154 (qwen2 on a forced 8-device mesh)
    "qwen2": ("qwen2-0.5b", {}, SMALL,
              [list(range(1, 9)), list(range(20, 33))], [5, 5]),
    # :340 (the SSD and RG-LRU families on it)
    "mamba2": ("mamba2-370m", {}, SMALL, TWO, [6, 6]),
    "recurrentgemma": ("recurrentgemma-2b", HYBRID, SMALL, TWO, [6, 6]),
    # :447 (the batched prefill on it)
    "batched": ("qwen2-0.5b", {}, dict(
        SMALL, max_slots=3, prefill_chunks_per_step=3, prefill_batch=3,
        enable_prefix_cache=False),
        [list(range(1, 14)), list(range(20, 23)), list(range(30, 39))],
        [5, 5, 5]),
    # tests/test_fused_serve.py's forced preemption, and
    # test_slot_state_preemption_spill_restore_exact's (seat rows too)
    "preempt_qwen2": ("qwen2-0.5b", {}, dict(
        block_size=2, num_blocks=9, max_blocks_per_req=6, max_slots=2,
        prefill_chunk=4, enable_prefix_cache=False),
        [list(range(1, 5)), list(range(7, 11))], [8, 8]),
    "preempt_recurrentgemma": ("recurrentgemma-2b", HYBRID, dict(
        block_size=2, num_blocks=11, max_blocks_per_req=10, max_slots=2,
        prefill_chunk=4, enable_prefix_cache=False),
        [list(range(1, 5)), list(range(7, 11))], [8, 8]),
    # :521 (the flat view of a (2, 4) mesh), here of (3, 1)
    "flat": ("qwen2-0.5b", {}, SMALL, [list(range(1, 10))], [5]),
    # preemptions under a host budget of three of qwen2's pages (their
    # global bytes; each holds half of them on a rank of (1, 2)): the
    # archive's counters and tiers against the reference on its mesh
    "budget": ("qwen2-0.5b", {}, dict(
        block_size=2, num_blocks=9, max_blocks_per_req=6, max_slots=2,
        prefill_chunk=4, enable_prefix_cache=False,
        archive_host_bytes=12288),
        [list(range(1, 5)), list(range(7, 11)), list(range(11, 14)),
         list(range(20, 24))], [8, 8, 8, 8]),
}
ARCHIVE_STATS = ("preemptions", "archive_evict_host", "archive_evict_disk",
                 "archive_host_bytes", "archive_disk_bytes", "finished")
CASES["pool"] = CASES["qwen2"]
FAMILIES = ("qwen2", "mamba2", "recurrentgemma")
# process set -> (world, mesh shape, cases, tasks)
SETS = {
    "tp2": (2, (1, 2), [c for c in CASES if c != "flat"],
            ["serve", "pool", "archive"]),
    "three": (3, (1, 3), ["flat"], ["refuse", "flat", "launcher"]),
}


def _case(name):
    arch, over, scfg, prompts, max_new = CASES[name]
    return arch, tuple(sorted(over.items())), scfg, prompts, max_new


def _cfgs(arch, over):
    kw = dict(over, dtype="float32")
    return (dataclasses.replace(jax_get_config(arch).reduced(), **kw),
            dataclasses.replace(get_config(arch).reduced(), **kw))


def _start(tmp, name, ckpts):
    world, shape, cases, tasks = SETS[name]
    out = tmp / name
    out.mkdir()
    spec = dict(store=str(out / "store"), shape=list(shape), out=str(out),
                tasks=tasks, cases={}, archive_stats=ARCHIVE_STATS)
    for c in cases:
        arch, over, scfg, prompts, max_new = _case(c)
        spec["cases"][c] = dict(arch=arch, overrides=dict(over), scfg=scfg,
                                prompts=prompts, max_new=max_new,
                                ckpt=ckpts[(arch, over)])
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


# the reference's HyperServe on a forced 2-device (1, 2) mesh, stepped as
# the worker's ``archive`` task steps the port's
ARCHIVE_CODE = """
import dataclasses, json, jax
from repro.configs.base import ServeConfig, get_config
from repro.launch.mesh import make_host_mesh
from repro.models import model as M
from repro.serve.api import HyperServe
cfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(), dtype="float32")
serve = HyperServe(cfg, M.init_model(cfg, jax.random.PRNGKey(0)),
                   serve_cfg=ServeConfig(**{scfg}),
                   mesh=make_host_mesh((1, 2)))
rids = [serve.submit(p, n) for p, n in zip({prompts}, {max_new})]
trace = []
while serve.stats()["finished"] < len(rids):
    serve.step_once()
    a, st = serve.engine.blocks.archive, serve.stats()
    trace.append([sorted([str(k), a.tier_of(k)] for k in a.keys()),
                  st["archive_host_bytes"], st["archive_disk_bytes"]])
out = serve.join()
st = serve.stats()
print("ARCHIVE" + json.dumps(dict(
    trace=trace, tokens=[out[r] for r in rids],
    stats={{k: st[k] for k in {keys}}})))
"""


def _archive_reference():
    """The reference's archive trace of the ``budget`` case on its forced
    mesh (a subprocess of two forced host devices)."""
    _, _, scfg, prompts, max_new = _case("budget")
    out = run_subprocess(ARCHIVE_CODE.format(
        scfg=repr(scfg), prompts=prompts, max_new=max_new,
        keys=ARCHIVE_STATS), devices=2, timeout=600)
    line = [ln for ln in out.splitlines() if ln.startswith("ARCHIVE")][0]
    return json.loads(line[len("ARCHIVE"):])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both process sets started at once (params written first), then,
    while they run, the JAX ``Generator``'s and the unsharded port's tokens
    of every case and the unsharded port's pool and first decode logits
    of the ``pool`` case."""
    tmp = tmp_path_factory.mktemp("mesh_serve")
    models, ckpts = {}, {}
    for name in CASES:
        arch, over = _case(name)[:2]
        if (arch, over) in models:
            continue
        jcfg, cfg = _cfgs(arch, dict(over))
        jp = JM.init_model(jcfg, jax.random.PRNGKey(0))
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
        ckpts[(arch, over)] = str(tmp / f"{arch}{len(ckpts)}")
        checkpoint.save(ckpts[(arch, over)], 0, tp)
        models[(arch, over)] = (jcfg, cfg, jp, tp)
    procs = {n: _start(tmp, n, ckpts) for n in SETS}
    archive = {}

    def reference_archive():
        try:
            archive["ref"] = _archive_reference()
        except Exception as e:          # re-raised on the test's thread
            archive["error"] = e
    thread = threading.Thread(target=reference_archive)
    thread.start()

    gens, want, port = {}, {}, {}
    for name in CASES:
        arch, over, scfg, prompts, max_new = _case(name)
        jcfg, cfg, jp, tp = models[(arch, over)]
        if (arch, over) not in gens:
            gens[(arch, over)] = Generator(jcfg, jp, max_len=128)
        gen = gens[(arch, over)]
        want[name] = [gen.generate(jnp.asarray(p, jnp.int32)[None, :],
                                   GenerateConfig(max_new_tokens=n))
                      [0, len(p):].tolist()
                      for p, n in zip(prompts, max_new)]
        first = []
        step = M.decode_step_paged

        def capture(*a, **kw):
            logits = step(*a, **kw)
            if not first:
                first.append(logits.numpy())
            return logits
        M.decode_step_paged = capture
        try:
            server = HyperServe(cfg, tp, serve_cfg=ServeConfig(**scfg),
                                device="cpu")
            rids = [server.submit(p, n) for p, n in zip(prompts, max_new)]
            out = server.join()
        finally:
            M.decode_step_paged = step
        port[name] = dict(
            tokens=[out[r] for r in rids], logits=first[0],
            pool={k: t.numpy() for k, t in
                  tree_flatten_with_path(server.engine.pool.state)})
    reports = {n: _wait(n, *procs[n]) for n in SETS}
    thread.join()
    if "error" in archive:
        raise archive["error"]
    return dict(want=want, port=port, reports=reports,
                pool=dict(np.load(tmp / "tp2" / "pool.npz")),
                archive=archive["ref"])


@pytest.mark.parametrize("name", FAMILIES)
def test_families_serve_on_a_mesh_as_the_generator(runs, name):
    """(1, 2): every rank's greedy tokens equal the JAX Generator's and the
    unsharded port HyperServe's, exactly."""
    for rank, rep in enumerate(runs["reports"]["tp2"]):
        got = rep["serve"][name]["tokens"]
        assert got == runs["want"][name] == runs["port"][name]["tokens"], \
            (name, rank)


def test_batched_prefill_on_a_mesh(runs):
    """(1, 2): chunks of several requests share a prefill call (chunks >
    calls), and the tokens are the Generator's."""
    for rep in runs["reports"]["tp2"]:
        got = rep["serve"]["batched"]
        assert got["tokens"] == runs["want"]["batched"]
        assert got["prefill_chunks"] > got["prefill_calls"] >= 1


@pytest.mark.parametrize("name", ["preempt_qwen2", "preempt_recurrentgemma"])
def test_preempted_run_on_a_mesh_is_identical(runs, name):
    """(1, 2): the pool runs out, requests are preempted (their pages, and
    the hybrid's seat rows, archived as each rank's own shards) and
    restored, and the tokens are the Generator's and the unsharded
    port's."""
    for rep in runs["reports"]["tp2"]:
        got = rep["serve"][name]
        assert got["preemptions"] >= 1
        assert got["tokens"] == runs["want"][name] \
            == runs["port"][name]["tokens"]


@pytest.mark.parametrize("name", FAMILIES)
def test_pool_shards_have_the_reference_shard_shape(runs, name):
    """Each rank's local pool leaf has the shape of the reference's
    ``derive_pool`` strategy for that leaf on {data: 1, model: 2}, and the
    fallbacks recorded are the reference's (recurrentgemma's one KV head:
    its pool replicated)."""
    layout = JaxLayout((1, 2), AXES)
    plan = jhs.ShardingPlan(fsdp=None)
    for rep in runs["reports"]["tp2"]:
        got = rep["serve"][name]
        sharded = 0
        for path, (local, full) in got["leaves"].items():
            strat, _, fb = jhs.derive_pool(path, tuple(full), layout, plan)
            assert tuple(local) == strat.shard_shape(tuple(full)), path
            assert got["fallbacks"].get(path, []) == list(fb), path
            sharded += tuple(local) != tuple(full)
        assert sharded, name
    fallbacks = runs["reports"]["tp2"][0]["serve"]["recurrentgemma"][
        "fallbacks"]
    assert sorted(fallbacks) == ["seg0/2/k", "seg0/2/v"]


def test_gathered_pool_and_first_logits_match_the_unsharded_port(runs):
    """qwen2 on (1, 2): the pool gathered after the run and the first
    decode step's logits within 1e-5 x max(1, |x|) of the unsharded
    port's (the row-sharded ``wo``'s partial sums reduced in another
    order), and not trivially: the pool was written."""
    got, want = runs["pool"], runs["port"]["pool"]
    ref = want["logits"]
    assert got["logits"].shape == ref.shape
    assert np.abs(got["logits"] - ref).max() <= 1e-5 * max(
        1.0, float(np.abs(ref).max()))
    assert sorted(k[len("pool/"):] for k in got if k != "logits") \
        == sorted(want["pool"])
    for k, v in want["pool"].items():
        assert np.abs(v).max() > 0, k
        assert np.abs(got[f"pool/{k}"] - v).max() <= 1e-5 * max(
            1.0, float(np.abs(v).max())), k


def test_archive_counts_global_bytes_as_the_reference(runs):
    """(1, 2), preemptions under a host budget of three pages: after every
    engine step each archived key's tier and the archive's host and disk
    bytes, and at the end its eviction counters, equal the reference
    HyperServe's on a forced 2-device mesh (every leaf's global bytes
    counted, though each rank stores its half of the KV heads); the
    budget evicts, and the tokens are the Generator's."""
    ref = runs["archive"]
    assert ref["stats"]["archive_evict_host"] >= 1
    assert ref["tokens"] == runs["want"]["budget"]
    for rep in runs["reports"]["tp2"]:
        got = rep["archive"]
        assert got["trace"] == ref["trace"]
        assert got["stats"] == ref["stats"]
        assert got["tokens"] == ref["tokens"]


def test_data_axis_mesh_is_refused(runs):
    """A (3, 1) mesh: ``ServePlanError`` naming the data axis and the flat
    view that serves instead."""
    for rep in runs["reports"]["three"]:
        kind, msg = rep["refuse"]["data_axis"]
        assert kind == "ServePlanError" and "data" in msg
        assert "serving_mesh_for" in msg


def test_flat_view_serves_with_the_fallbacks(runs):
    """``serving_mesh_for`` of the (3, 1) mesh is the (1, 3) view of the
    same ranks; on it the vocabulary (1024 % 3) gives replicated logits and
    the two KV heads (2 % 3) a replicated pool with recorded fallbacks,
    and qwen2 serves as the JAX Generator does, on every rank."""
    for rep in runs["reports"]["three"]:
        flat = rep["flat"]
        assert flat["shape"] == [1, 3] and flat["names"] == list(AXES)
        assert flat["same_ranks"] and flat["vocab_axis"] is None
        assert sorted(flat["fallbacks"]) == ["seg0/0/k", "seg0/0/v"]
        assert all(local == full for local, full in flat["leaves"].values())
        assert flat["tokens"] == runs["want"]["flat"]


def test_fsdp_plan_is_refused(runs):
    """A plan that shards params over fsdp: ``ServePlanError`` naming
    fsdp (a decode step would gather every weight each token)."""
    for rep in runs["reports"]["three"]:
        kind, msg = rep["refuse"]["fsdp"]
        assert kind == "ServePlanError" and "fsdp" in msg


def test_facade_plan_is_refused(runs):
    """A plan that is not a ``ShardingPlan`` (the facade's ``HyperPlan``):
    ``PlanError`` naming ROADMAP item 8h."""
    for rep in runs["reports"]["three"]:
        kind, msg = rep["refuse"]["facade"]
        assert kind == "PlanError" and "item 8h" in msg


def test_mla_and_moe_are_refused_on_a_mesh(runs):
    """What the mesh used to refuse is built on the flat (1, 3) mesh: an
    engine of the multimodal musicgen-large (served text-only, fused, as
    the reference's HyperServe serves it) and one of deepseek-v2-lite
    (MLA and MoE) under the composed lowering; what is still refused
    (a data axis, an fsdp plan, the facade's plan) is refused by the
    tests above."""
    for rep in runs["reports"]["three"]:
        assert rep["refuse"]["prefix"] == ["built", "fused"]
        assert rep["refuse"]["composed"] == ["built", "composed"]


def test_launcher_serves_on_three_ranks(runs):
    """``python -m repro_torch.launch.serve --continuous --mesh auto
    --device cpu --reduced`` on three gloo ranks: rank 0 reports the
    (1, 3) mesh and every request served; the other ranks print nothing."""
    outs = [rep["launcher"] for rep in runs["reports"]["three"]]
    assert "mesh (1, 3)" in outs[0] and "served 3 requests" in outs[0]
    assert outs[1] == outs[2] == ""
