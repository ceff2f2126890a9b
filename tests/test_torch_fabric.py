"""HyperFabric on the port against the reference's, on the CPU.

The cases of ``tests/test_fabric.py``, each run twice on the same f32
params (the reference's ``init_model`` at seed 0, bridged) and the same
submissions: through the JAX ``Supernode().fabric`` and through the port's
``Supernode(device="cpu").fabric``.  The determinism contract makes the
comparison exact: the dispatch logs, the affinity hits and misses, the
replica states after every router step, the router's counters, the
engines' request records, every key of ``snapshot()`` after the same
history and the typed rejections (``reason``, ``tenant``,
``retry_after_s`` and the message) are equal, and the greedy tokens equal
the JAX ``Generator``'s.  Plan validation, the carve and ``explain()``'s
fabric rows are held to the reference's classes and texts.

Then one gloo process set of four ranks (``torch_mesh_fabric_worker.py``,
a fresh interpreter a rank, two replicas of two ranks on ``(1, 2)``
meshes) against the JAX fabric on a forced four-device mesh (two replicas
on ``(1, 2)`` submeshes): every rank's tokens, dispatch log, counters and
replica states equal the reference's.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

import repro.api as japi  # noqa: E402
import repro_torch.api as tapi  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.fabric import carve as jcarve  # noqa: E402
from repro.serve.api import RequestRejected as JaxRejected  # noqa: E402
from repro.serve.engine import GenerateConfig  # noqa: E402
from repro_torch.ckpt import checkpoint  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.fabric import carve as tcarve  # noqa: E402
from repro_torch.serve.api import RequestRejected  # noqa: E402
from test_torch_serve import _generator, _models  # noqa: E402
from tests.conftest import run_subprocess  # noqa: E402

ARCH = "qwen2-0.5b"
# tests/test_fabric.py's ServeConfig
SCFG = dict(block_size=4, num_blocks=40, max_blocks_per_req=8, max_slots=3,
            prefill_chunk=4)
SIDES = {"jax": (japi, jbase, JaxRejected),
         "torch": (tapi, tbase, RequestRejected)}
COUNTERS = ("submitted", "dispatched", "finished", "rejected",
            "affinity_hits", "affinity_misses", "scale_up", "scale_down",
            "pending", "pending_by_tenant", "active_replicas",
            "replica_states")
META = ("fid", "tenant", "slo", "replica", "affinity_hit", "enqueue_step",
        "first_token_step", "ttft_steps")
ENGINE_META = ("rid", "state", "n_tokens", "finish_reason")
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_mesh_fabric_worker.py")


@pytest.fixture(scope="module")
def models():
    return _models(ARCH)


def _fabric(side, models, scfg=SCFG, tenants=(), **fkw):
    """A fabric of ``side`` ("jax" or "torch") over the f32 reduced qwen2:
    ``tenants`` as (name, TenantSpec keywords) pairs, ``fkw`` the
    FabricConfig's other knobs."""
    api, base, _ = SIDES[side]
    jcfg, cfg, jp, tp = models
    if tenants:
        fkw["tenants"] = tuple(base.TenantSpec(n, **kw) for n, kw in tenants)
    plan = api.plans.fabric(serve=base.ServeConfig(**scfg),
                            fabric=base.FabricConfig(**fkw))
    if side == "jax":
        return api.Supernode().fabric(jcfg, jp, plan=plan)
    return api.Supernode(device="cpu").fabric(cfg, tp, plan=plan)


def _stats(fab):
    st = fab.stats()
    return {k: st[k] for k in COUNTERS}


def _meta(fab, fid):
    m = fab.request_meta(fid)
    out = {k: m[k] for k in META}
    if "engine" in m:
        out["engine"] = {k: m["engine"][k] for k in ENGINE_META}
    return out


def _rejection(fn, rejected):
    """(reason, tenant, retry_after_s, message) of the typed rejection
    ``fn`` raises."""
    with pytest.raises(rejected) as ei:
        fn()
    e = ei.value
    return e.reason, e.tenant, e.retry_after_s, str(e)


def _both(models, scenario, **kw):
    """``scenario(fab, RequestRejected)`` on both sides; returns the two
    records (reference, port) after holding them equal."""
    got = {side: scenario(_fabric(side, models, **kw), SIDES[side][2])
           for side in SIDES}
    assert got["torch"] == got["jax"]
    return got["jax"]


def _want(prompt, n):
    gen = _generator(ARCH)
    return gen.generate(jnp.asarray(prompt, jnp.int32)[None, :],
                        GenerateConfig(max_new_tokens=n))[0, len(prompt):] \
        .tolist()


# ---------------------------------------------------------------------------
# greedy parity: routing must never change tokens
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("replicas", [1, 2])
def test_fabric_greedy_matches_generator(models, replicas):
    prompts = [list(range(1, 9)), list(range(20, 33)),
               list(range(5, 10)), list(range(40, 47))]
    max_new = [6, 4, 8, 5]

    def scenario(fab, _):
        fids = [fab.submit(p, mn) for p, mn in zip(prompts, max_new)]
        fab.join()
        return {"tokens": [fab.result(f) for f in fids],
                "log": list(fab.dispatch_log), "stats": _stats(fab),
                "meta": [_meta(fab, f) for f in fids]}
    rec = _both(models, scenario, replicas=replicas)
    assert rec["tokens"] == [_want(p, mn) for p, mn in zip(prompts, max_new)]
    assert rec["stats"]["dispatched"] == rec["stats"]["finished"] == 4
    if replicas == 2:        # least-loaded fallback spreads work around
        assert len({m["replica"] for m in rec["meta"]}) == 2


# ---------------------------------------------------------------------------
# SLO classes: weighted-fair dispatch, deterministic given submission order
# ---------------------------------------------------------------------------
def test_weighted_fair_dispatch_order_and_determinism(models):
    def scenario(fab, _):
        for i in range(5):
            fab.submit([1 + i, 2, 3, 4, 5], 2, tenant="chat")
            fab.submit([30 + i, 2, 3, 4, 5], 2, tenant="bulk")
        fab.step()           # one dispatch pass over everything pending
        order = [t for _, t, _ in fab.dispatch_log]
        fab.join()
        return order, list(fab.dispatch_log), _stats(fab)
    kw = dict(replicas=1, dispatch_depth=8,
              tenants=(("chat", dict(slo="interactive")),
                       ("bulk", dict(slo="batch"))))
    order, log, _ = _both(models, scenario, **kw)
    assert order == ["chat", "bulk", "chat", "chat", "chat", "chat",
                     "bulk", "bulk", "bulk", "bulk"]
    again = scenario(_fabric("torch", models, **kw), RequestRejected)
    assert again[:2] == (order, log)        # fully reproducible


# ---------------------------------------------------------------------------
# prefix affinity: requests follow the replica holding their CoW prefix
# ---------------------------------------------------------------------------
def test_prefix_affinity_routes_to_cow_holder(models):
    shared = [7, 3, 9, 2, 11, 5, 13, 8]                 # two full blocks

    def scenario(fab, _):
        warm = fab.submit(shared + [17, 19], 3)
        fab.join()                                      # replica 0 retains
        filler = fab.submit(list(range(50, 60)), 8)
        fab.step()
        aff = fab.submit(shared + [21, 23], 4)
        fab.join()
        return {"meta": [_meta(fab, f) for f in (warm, filler, aff)],
                "tokens": fab.result(aff), "stats": _stats(fab),
                "prefix_hits": fab.replicas[0].stats()["prefix_hits"],
                "snapshots": [r.snapshot() for r in fab.replicas]}
    rec = _both(models, scenario, replicas=2)
    warm, filler, aff = rec["meta"]
    assert warm["replica"] == filler["replica"] == aff["replica"] == 0
    assert aff["affinity_hit"] is True and rec["stats"]["affinity_hits"] == 1
    # the forked CoW blocks decode the exact same greedy tokens
    assert rec["tokens"] == _want(shared + [21, 23], 4)
    assert rec["prefix_hits"] >= 1


def test_affinity_disabled_falls_back_to_least_loaded(models):
    shared = [7, 3, 9, 2, 11, 5, 13, 8]

    def scenario(fab, _):
        fab.submit(shared + [17, 19], 3)
        fab.join()
        fab.submit(shared + [21, 23], 3)
        fab.join()
        return list(fab.dispatch_log), _stats(fab)
    _, st = _both(models, scenario, replicas=2, affinity=False)
    assert st["affinity_hits"] == st["affinity_misses"] == 0


# ---------------------------------------------------------------------------
# admission control: typed rejections + backpressure, admit after drain
# ---------------------------------------------------------------------------
def test_backpressure_queue_full_then_admit_after_drain(models):
    def scenario(fab, rejected):
        fab.submit([1, 2, 3], 2)
        fab.submit([4, 5, 6], 2)
        why = _rejection(lambda: fab.submit([7, 8, 9], 2), rejected)
        fab.join()                                   # drain the front door
        fid = fab.submit([7, 8, 9], 2)               # now it must admit
        fab.join()
        return why, fab.result(fid), _stats(fab)
    why, tokens, st = _both(models, scenario, replicas=1, max_pending=2,
                            retry_after_s=0.125)
    assert why[:3] == ("queue_full", "default", 0.125)
    assert len(tokens) == 2 and st["rejected"] == 1


def test_over_quota_rejection_names_tenant(models):
    def scenario(fab, rejected):
        fab.submit([1, 2, 3], 2, tenant="capped")
        why = _rejection(lambda: fab.submit([4, 5, 6], 2, tenant="capped"),
                         rejected)
        fab.join()                                   # in-flight count drops
        fab.submit([4, 5, 6], 2, tenant="capped")
        fab.join()
        return why, _stats(fab), list(fab.dispatch_log)
    why, _, _ = _both(models, scenario, replicas=1,
                      tenants=(("capped", dict(max_inflight=1)),))
    assert why[:2] == ("over_quota", "capped") and why[2] is not None


def test_unservable_rejected_at_front_door(models):
    def scenario(fab, rejected):
        why = _rejection(lambda: fab.submit(list(range(1, 200)), 64),
                         rejected)
        with pytest.raises(KeyError) as ei:
            fab.submit([1, 2], 2, tenant="nobody")
        return why, str(ei.value), _stats(fab)
    why, _, st = _both(models, scenario, replicas=1)
    assert why[0] == "unservable" and why[2] is None   # retrying cannot help
    assert st["rejected"] == 1


def test_engine_level_rejection_is_typed(models):
    from repro.serve.api import HyperServe as JaxHyperServe
    from repro_torch.serve.api import HyperServe
    jcfg, cfg, jp, tp = models
    got = [_rejection(lambda: JaxHyperServe(
        jcfg, jp, serve_cfg=jbase.ServeConfig(**SCFG)).submit([], 4),
        JaxRejected)]
    got.append(_rejection(lambda: HyperServe(
        cfg, tp, serve_cfg=tbase.ServeConfig(**SCFG),
        device="cpu").submit([], 4), RequestRejected))
    assert got[1] == got[0]
    assert got[0][:2] == ("unservable", None)    # bare engine: no tenant


# ---------------------------------------------------------------------------
# elastic scale: drain when idle, re-activate on queue depth
# ---------------------------------------------------------------------------
def test_elastic_drain_then_activate(models):
    def scenario(fab, _):
        states = []
        fab.step()                                   # idle -> drain 1
        states.append(_stats(fab))
        fab.step()                                   # stays at min_replicas
        states.append(_stats(fab))
        fids = [fab.submit([10 + i, 2, 3], 2) for i in range(3)]
        fab.step()                                   # pending 3 > 2
        states.append(_stats(fab))
        while fab.stats()["finished"] < len(fids):
            fab.step()
            states.append(_stats(fab))
        return states, [fab.result(f) for f in fids], list(fab.dispatch_log)
    states, tokens, _ = _both(models, scenario, replicas=2, elastic=True,
                              min_replicas=1, scale_up_pending=2)
    assert states[0]["replica_states"] == ("active", "draining")
    assert states[0]["scale_down"] == 1
    assert states[1]["active_replicas"] == 1
    assert states[2]["active_replicas"] == 2 and states[2]["scale_up"] == 1
    assert all(len(t) == 2 for t in tokens)


# ---------------------------------------------------------------------------
# engine snapshot surface (the router's entire read path)
# ---------------------------------------------------------------------------
def test_engine_snapshot_surface(models):
    from repro.serve.api import HyperServe as JaxHyperServe
    from repro_torch.serve.api import HyperServe
    jcfg, cfg, jp, tp = models
    servers = {"jax": JaxHyperServe(jcfg, jp,
                                    serve_cfg=jbase.ServeConfig(**SCFG)),
               "torch": HyperServe(cfg, tp, serve_cfg=tbase.ServeConfig(
                   **SCFG), device="cpu")}
    snaps = {}
    for side, serve in servers.items():
        got = [serve.snapshot()]
        rid = serve.submit([1, 2, 3, 4, 5], 3)
        got.append(serve.snapshot())
        serve.join()
        got.append(serve.snapshot())
        got.append(serve.result(rid))
        # a second request forks the retained prefix
        serve.submit([1, 2, 3, 4, 9, 9], 2)
        serve.step_once()
        got.append(serve.snapshot())
        serve.join()
        got.append(serve.snapshot())
        snaps[side] = got
    assert snaps["torch"] == snaps["jax"]
    first, queued, done = snaps["jax"][:3]
    assert first["queue_depth"] == 0 and first["has_work"] is False
    assert queued["queue_depth"] == 1 and queued["has_work"] is True
    assert done["prefix_keys"] == ((1, 2, 3, 4),)
    assert len(done["prefix_cache_block_ids"]) == 1


# ---------------------------------------------------------------------------
# plan validation + explain
# ---------------------------------------------------------------------------
def _error(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - compared by class and text
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("case", ["replicas0", "split_len", "dup_tenant",
                                  "bad_slo", "roles", "knobs",
                                  "min_replicas", "occupancy"])
def test_fabric_plan_validation(case):
    def build(api, base):
        fab = {"replicas0": dict(replicas=0),
               "split_len": dict(replicas=2, split=(1, 2, 3)),
               "dup_tenant": dict(tenants=(base.TenantSpec("a"),
                                           base.TenantSpec("a"))),
               "bad_slo": dict(tenants=(base.TenantSpec("a", slo="premium"),
                                        base.TenantSpec("b", weight=-1))),
               "roles": {},
               "knobs": dict(max_pending=0, dispatch_depth=0,
                             scale_up_pending=0, split=(0, 1)),
               "min_replicas": dict(replicas=2, min_replicas=3),
               "occupancy": dict(scale_down_occupancy=1.5, tenants=())}[case]
        if case == "roles":
            return api.plans.fabric(roles=(("prefill", 1), ("decode", 1)))
        return api.plans.fabric(fabric=base.FabricConfig(**fab))
    got = [_error(lambda: build(api, base).validate())
           for api, base, _ in SIDES.values()]
    assert got[1] == got[0] and got[0] is not None
    assert got[0][0] == ("PlanError" if case == "roles"
                         else "FabricPlanError")


def test_split_overclaim_raises(models):
    got = [_error(lambda: _fabric(side, models, replicas=2, split=(1, 1)))
           for side in SIDES]
    assert got[1] == got[0] and got[0][0] == "FabricPlanError"
    assert "claims" in got[0][1]


@pytest.mark.parametrize("n,kw", [(1, dict(replicas=2)),
                                  (8, dict(replicas=3)),
                                  (8, dict(replicas=2, split=(6, 2))),
                                  (4, dict(replicas=2, split=(2, 1)))])
def test_carve_counts_and_rows_match_the_reference(n, kw):
    counts = [carve.carve_counts(n, base.FabricConfig(**kw))
              for carve, base in ((jcarve, jbase), (tcarve, tbase))]
    assert counts[1] == counts[0]
    assert tcarve.describe_carve(counts[1]) == jcarve.describe_carve(
        counts[0])


def _rows(report):
    return [(r.kind, r.path, tuple(r.shape), r.spec, r.memory, r.rule,
             tuple(r.notes)) for r in report.select("fabric")]


@pytest.mark.parametrize("layout", [None, ((1, 8), ("data", "model")),
                                    ((2, 2), ("data", "model"))])
def test_explain_reports_replica_carve(models, layout):
    jcfg, cfg = models[:2]
    got = []
    for api, base, _ in SIDES.values():
        plan = api.plans.fabric(replicas=2, fabric=base.FabricConfig(
            replicas=2, tenants=(base.TenantSpec("chat"),
                                 base.TenantSpec("bulk", slo="batch",
                                                 max_inflight=3))))
        c = jcfg if api is japi else cfg
        if layout is None:
            rep = (api.Supernode() if api is japi else
                   api.Supernode(device="cpu")).explain(plan, c,
                                                        for_serving=True)
        else:
            L = __import__(("repro" if api is japi else "repro_torch")
                           + ".core.layout", fromlist=["Layout"]).Layout
            rep = api.explain(plan, c, L(*layout))
        got.append(_rows(rep))
    assert got[1] == got[0]
    paths = [r[1] for r in got[0]]
    assert paths == ["replica[0]", "replica[1]", "tenant[chat]",
                     "tenant[bulk]"]
    assert "weight=4" in got[0][2][5] and "weight=1" in got[0][3][5]


def test_launcher_routes_as_the_reference_launcher(capsys, monkeypatch):
    """``python -m repro_torch.launch.fabric`` on the CPU prints the
    reference launcher's three lines for the same flags; the routing lines
    (dispatches, affinity hits, rejections, scale events, the chat
    requests' TTFT in router steps) are equal: they depend only on the
    submissions."""
    from repro.launch import fabric as jax_launcher
    from repro_torch.launch import fabric as launcher
    flags = ["--arch", "qwen2-0.5b", "--reduced", "--elastic",
             "--requests", "9", "--max-new", "6"]
    monkeypatch.setattr(sys, "argv", ["fabric", *flags])
    jax_launcher.main()
    want = capsys.readouterr().out.strip().splitlines()
    launcher.main([*flags, "--device", "cpu", "--metrics"])
    got = capsys.readouterr().out.strip().splitlines()
    assert got[0].startswith("fabric served 9 requests (54 tokens)")
    assert got[1:3] == want[1:3]
    assert "fabric_dispatched" in "\n".join(got[3:])


# ---------------------------------------------------------------------------
# four gloo ranks: two replicas of two ranks against the forced 4-device
# reference
# ---------------------------------------------------------------------------
PROMPTS = [list(range(1, 9)), list(range(20, 29)), list(range(5, 12)),
           [7, 3, 9, 2, 11, 5, 13, 8, 17, 19],
           [7, 3, 9, 2, 11, 5, 13, 8, 21, 23]]
MAX_NEW = [5, 4, 6, 3, 4]
MESH_SCFG = dict(block_size=4, num_blocks=40, max_blocks_per_req=8,
                 max_slots=2, prefill_chunk=4)
JAX_FABRIC = """
import dataclasses, json
import jax
from repro.api import Supernode, plans
from repro.configs.base import FabricConfig, ServeConfig, get_config
from repro.models import model as M

cfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(), dtype="float32")
params = M.init_model(cfg, jax.random.PRNGKey(0))
spec = json.loads('''SPEC''')
fab = Supernode((1, 4)).fabric(cfg, params, plan=plans.fabric(
    serve=ServeConfig(**spec["scfg"]),
    fabric=FabricConfig(replicas=2, elastic=True, scale_up_pending=1)))
meshes = [list(rep.engine.mesh.devices.shape) for rep in fab.replicas]
trace = []
fids = []
for p, n in zip(spec["prompts"], spec["max_new"]):
    fids.append(fab.submit(p, n))
    fab.step()
    st = fab.stats()
    trace.append([list(st["replica_states"])]
                 + [st[k] for k in spec["counters"]])
fab.join()
st = fab.stats()
print("FABRIC-JSON" + json.dumps(dict(
    meshes=meshes, tokens=[fab.result(f) for f in fids],
    log=[list(x) for x in fab.dispatch_log], trace=trace,
    counters=[st[k] for k in spec["counters"]],
    states=list(st["replica_states"]),
    replicas=[fab.request_meta(f)["replica"] for f in fids])))
"""


def test_four_gloo_ranks_two_replicas_match_the_reference(models, tmp_path):
    """Every rank's record (each replica's engine on its group's (1, 2)
    mesh, built on its two ranks only; the other replica's values shared
    by its first rank) equals the JAX fabric's on ``Supernode((1, 4))``:
    the replica mesh shapes, tokens, dispatch log, each router step's
    replica states and counters, and the final counters."""
    _, cfg, _, tp = models
    ckpt = str(tmp_path / "ckpt")
    checkpoint.save(ckpt, 0, tp)
    counters = list(COUNTERS[:8])
    spec = dict(store=str(tmp_path / "store"), out=str(tmp_path),
                ckpt=ckpt, scfg=MESH_SCFG, prompts=PROMPTS,
                max_new=MAX_NEW, counters=counters)
    (tmp_path / "spec.json").write_text(json.dumps(spec))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), "4", str(tmp_path / "spec.json")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(4)]
    out = run_subprocess(JAX_FABRIC.replace("SPEC", json.dumps(
        dict(spec, store=None))), devices=4)
    want = json.loads(out.split("FABRIC-JSON", 1)[1])
    logs = [p.communicate(timeout=600)[0] for p in procs]
    bad = [i for i, p in enumerate(procs) if p.returncode]
    assert not bad, f"rank {bad[0]} failed:\n{logs[bad[0]][-4000:]}"
    reports = [json.loads((tmp_path / f"report{r}.json").read_text())
               for r in range(4)]
    assert want["meshes"] == [[1, 2], [1, 2]]
    assert sorted(set(want["replicas"])) == [0, 1]
    for r, rep in enumerate(reports):
        assert rep["groups"] == [[0, 1], [2, 3]], r
        assert rep["meshes"] == ([[1, 2], None] if r < 2
                                 else [None, [1, 2]]), r
        for k in ("tokens", "log", "trace", "counters", "states",
                  "replicas"):
            assert rep[k] == want[k], (r, k)
    assert want["tokens"] == [_want(p, n) for p, n in zip(PROMPTS, MAX_NEW)]
