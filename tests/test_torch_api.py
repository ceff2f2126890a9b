"""The port's facade against the reference's, on the CPU: HyperPlan, the
presets, explain(), Supernode and its verbs, the typed errors.

- ``explain()``'s rows for every arch at full size (a meta-tensor init on
  the port's side, ``jax.eval_shape`` on the reference's): param, opt and
  cache rows on the production matrix, host-placed rows under
  ``offload_all``, serving-state and kernel rows on a ``(1, 16)`` model
  axis, HyperMem residency rows under ``offload_graph``, pipeline rows and
  fabric rows — kind, path, shape, spec, memory, rule and notes equal,
  exactly, or the same error class and text where the reference refuses;
- the reference's ``tests/test_api.py`` cases on the port, each held to
  the reference's outcome: error classes and texts of plan validation and
  topology, the preset registry (names and every field), the legacy
  ``ShardingPlan`` and ``OffloadConfig`` routes against the plan route;
- the verbs on one device (``device="cpu"``): ``train`` equal to the
  port's trainer bit for bit and to the JAX session's within 1e-4
  relative from the same params; ``serve``, ``fabric`` and ``rl`` equal to
  the port's engines built directly; ``generate`` equal to the port's
  ``Generator`` and, greedy, to the JAX session's; the refusals.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

import repro.api as japi  # noqa: E402
import repro_torch.api as tapi  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.core.layout import Layout as JaxLayout  # noqa: E402
from repro.core.offload import OffloadConfig as JaxOffloadConfig  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import adamw as jax_opt  # noqa: E402
from repro.train import trainer as jax_trainer  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.core import hypershard  # noqa: E402
from repro_torch.core.layout import Layout  # noqa: E402
from repro_torch.core.offload import OffloadConfig  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.bridge import (adamw_state_from_numpy,  # noqa: E402
                                       params_from_numpy)
from repro_torch.train import steps, trainer  # noqa: E402
from test_torch_serve import _generator, _models  # noqa: E402

PROD = ((2, 16, 16), ("pod", "data", "model"))
SIDES = ((japi, jbase, JaxLayout, JaxOffloadConfig),
         (tapi, tbase, Layout, OffloadConfig))


def _error(fn):
    """(class name, text) of what ``fn`` raises, or None."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - compared by class and text
        return type(e).__name__, str(e)
    return None


def _rows(report):
    return [(l.kind, l.path, tuple(l.shape),
             l.spec if isinstance(l.spec, str) else tuple(l.spec),
             l.memory, l.rule, tuple(l.notes)) for l in report.leaves]


def _explain_both(arch, make_plan, layout, **kw):
    """``explain`` of the same plan on both sides: (reference rows or
    error, port rows or error).  The port's slot state holds one row more
    than the seats (the null seat that filler prefill rows write, which
    the reference's pool lacks): its serving-state rows of kind ``slot``
    are compared with that row taken off."""
    out = []
    for api, base, L, _ in SIDES:
        cfg = base.get_config(arch)
        out.append(_run(lambda: _rows(api.explain(
            make_plan(api, base), cfg, L(*layout), **kw))))
    if isinstance(out[1], list):
        out[1] = [r[:2] + ((r[2][0], r[2][1] - 1) + r[2][2:],) + r[3:]
                  if r[0] == "state" and r[4] == "slot" else r
                  for r in out[1]]
    return out


def _run(fn):
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 - compared by class and text
        return type(e).__name__, str(e)


# ---------------------------------------------------------------------------
# explain: the reference's rows for every arch
# ---------------------------------------------------------------------------
EXPLAIN_CASES = {
    "fsdp_tp": (lambda api, base: api.plans.fsdp_tp(), PROD, {}),
    "offload_all": (lambda api, base: api.plans.offload_all(),
                    ((16, 16), ("data", "model")), dict(with_opt=True)),
    "serve": (lambda api, base: api.plans.serve(serve=base.ServeConfig(
        kernels="fused", max_slots=8)), ((1, 16), ("data", "model")),
        dict(serving=True, batch=8, cache_len=4096)),
    "serve_disagg": (lambda api, base: api.plans.serve_disagg(
        serve=base.ServeConfig(kernels="composed")),
        ((1, 1), ("data", "model")), dict(serving=True)),
    "offload_graph": (lambda api, base: api.plans.offload_graph(
        hbm_budget_bytes=2 ** 30, host_budget_bytes=2 ** 33),
        ((1, 1), ("data", "model")), dict(with_cache=False)),
    "pipeline": (lambda api, base: api.plans.pipeline(stages=2,
                                                      micro_batches=8),
                 ((1, 4), ("data", "model")), dict(with_cache=False)),
    "fabric": (lambda api, base: api.plans.fabric(
        replicas=3, fabric=base.FabricConfig(replicas=3, tenants=(
            base.TenantSpec("chat"), base.TenantSpec("bulk", slo="batch",
                                                     weight=2)))),
               ((1, 8), ("data", "model")), dict(with_opt=False)),
}


@pytest.mark.parametrize("case", sorted(EXPLAIN_CASES))
@pytest.mark.parametrize("arch", sorted(jbase.list_archs()))
def test_explain_rows_match_the_reference(arch, case):
    make_plan, layout, kw = EXPLAIN_CASES[case]
    want, got = _explain_both(arch, make_plan, layout, **kw)
    assert got == want
    if isinstance(want, list):
        kinds = {r[0] for r in want}
        assert "param" in kinds
        assert {"serve": "state", "serve_disagg": "kernel",
                "offload_graph": "mem", "pipeline": "pipeline",
                "fabric": "fabric"}.get(case, "param") in kinds


@pytest.mark.parametrize("arch", ("granite-3-2b", "deepseek-moe-16b",
                                  "recurrentgemma-2b"))
def test_explain_covers_every_leaf(arch):
    """100% of param + cache leaves appear in the report, each with a
    spec, a memory kind and the rule that fired; the text renders."""
    cfg = tbase.get_config(arch).reduced()
    report = tapi.Supernode(device="cpu").explain(tapi.plans.fsdp_tp(), cfg)
    from repro_torch.core.tree import tree_leaves
    from repro_torch.mem.planner import param_shapes
    n_params = len(tree_leaves(param_shapes(cfg)))
    n_caches = len(tree_leaves(M.init_caches(
        cfg, 1, max(cfg.sliding_window, 64), device="meta")))
    c = report.coverage()
    assert c["param"] == n_params and c["cache"] == n_caches
    assert c["opt"] == 2 * n_params                  # AdamW mu + nu
    for leaf in report.leaves:
        assert leaf.rule and leaf.memory in ("device", "host")
    jrep = japi.Supernode().explain(japi.plans.fsdp_tp(),
                                    jbase.get_config(arch).reduced())
    assert _rows(report) == _rows(jrep)
    text = str(report)
    assert "divisibility fallbacks" in text
    assert text.splitlines()[0] == str(jrep).splitlines()[0]


def test_explain_memory_kinds_follow_offload_intent():
    cfg = tbase.get_config("qwen2-0.5b").reduced()
    session = tapi.Supernode(device="cpu")
    report = session.explain(tapi.plans.offload_all(), cfg)
    hosted = [l for l in report.params if l.memory == "host"]
    assert hosted and all(len(l.shape) >= 2 for l in hosted)
    assert all(l.memory == "device" for l in session.explain(
        tapi.plans.fsdp_tp(), cfg).leaves)


def test_explain_strict_raises_on_silent_replication():
    """4 reduced experts cannot divide the 16-way tp axis: the same typed
    error and text on both sides."""
    got = [_error(lambda: api.explain(api.plans.fsdp_tp(),
                                      base.get_config(
                                          "deepseek-moe-16b").reduced(),
                                      L(*PROD)).raise_on_fallback())
           for api, base, L, _ in SIDES]
    assert got[1] == got[0] and got[0][0] == "IndivisibleError"
    assert "silently replicate" in got[0][1]
    assert tapi.Supernode(device="cpu").explain(
        tapi.plans.fsdp_tp(), tbase.get_config("qwen2-0.5b").reduced(),
        strict=True).fallbacks == ()


def test_explain_strict_catches_cache_fallbacks():
    strat, note, fbs = hypershard.derive_cache(
        "seg0/0/k", (2, 3, 100, 3, 64), Layout(*PROD),
        hypershard.ShardingPlan(), batch=3)
    assert strat.partition_spec() == (None,) * 5
    assert fbs and "unplaced" in fbs[0]
    got = [_error(lambda: api.explain(
        api.plans.fsdp_tp(), base.get_config("qwen2-0.5b").reduced(),
        L(*PROD), batch=1, cache_len=100).raise_on_fallback())
        for api, base, L, _ in SIDES]
    assert got[1] == got[0] and got[0][0] == "IndivisibleError"


# ---------------------------------------------------------------------------
# eager validation: typed PlanErrors, the reference's classes and texts
# ---------------------------------------------------------------------------
BAD_PLANS = {
    "unknown_axis": (dict(tp=("modle",)), None),
    "unbound_group": (dict(tp=("pod",)), ((2, 4), ("data", "model"))),
    "stream_without_host": (dict(stream_layers=True), None),
    "prefetch_depth": (dict(prefetch_depth=0), None),
    "moe_weights": (dict(moe_weights="nope"), None),
    "dup_role": (dict(roles=(("a", 1), ("a", 2))), None),
    "neg_role": (dict(roles=(("a", -1),)), None),
    "policy": (dict(offload_policy="lru"), None),
    "neg_budget": (dict(offload_policy="graph", hbm_budget_bytes=-1), None),
    "manual_budget": (dict(host_budget_bytes=8), None),
    "serve_knob": ("serve", None),
    "rl_group": ("rl_group", None),
    "rl_temperature": ("rl_temperature", None),
    "rl_roles": ("rl_roles", None),
    "fabric_roles": ("fabric_roles", None),
    "pipeline_fabric": ("pipeline_fabric", None),
    "pipeline_roles": ("pipeline_roles", None),
    "pipeline_knob": ("pipeline_knob", None),
    "ok_pod_degrades": (dict(), ((2, 4), ("data", "model"))),
}


def _bad_plan(api, base, what):
    if isinstance(what, dict):
        return api.HyperPlan(**what)
    return {
        "serve": lambda: api.plans.serve(serve=base.ServeConfig(
            prefill_batch=0)),
        "rl_group": lambda: api.plans.rl_colocate(rl=base.RLConfig(
            group_size=1)),
        "rl_temperature": lambda: api.plans.rl_colocate(rl=base.RLConfig(
            temperature=0.0)),
        "rl_roles": lambda: api.plans.rl_colocate(roles=(("critic", 1),)),
        "fabric_roles": lambda: api.plans.fabric(
            roles=(("prefill", 1), ("decode", 1))),
        "pipeline_fabric": lambda: api.plans.pipeline(
            fabric=base.FabricConfig()),
        "pipeline_roles": lambda: api.plans.pipeline(roles=(("a", 1),)),
        "pipeline_knob": lambda: api.plans.pipeline(stages=0),
    }[what]()


@pytest.mark.parametrize("case", sorted(BAD_PLANS))
def test_plan_validation_matches_the_reference(case):
    what, layout = BAD_PLANS[case]
    got = [_error(lambda: _bad_plan(api, base, what).validate(
        L(*layout) if layout else None)) for api, base, L, _ in SIDES]
    assert got[1] == got[0]
    assert (got[0] is None) == (case == "ok_pod_degrades")


def test_unknown_axis_is_a_typed_error():
    with pytest.raises(tapi.UnknownAxisError):
        tapi.HyperPlan(tp=("modle",)).validate()
    tapi.HyperPlan().validate(Layout((2, 4), ("data", "model")))
    with pytest.raises(tapi.UnknownAxisError):
        tapi.HyperPlan(tp=("pod",)).validate(Layout((2, 4),
                                                    ("data", "model")))


def test_topology_errors():
    """The reference's topology errors on one process: a matrix larger
    than the world (the same class and text, but for the remedy each
    names), axis names of another rank, and roles that need more devices
    than the session has (the same text)."""
    got = [_error(lambda: api.Supernode((4, 4))) for api, *_ in SIDES]
    assert got[0][0] == got[1][0] == "TopologyError"
    assert got[1][1].split(" (set")[0].split(" (start")[0] == \
        got[0][1].split(" (set")[0] == \
        "topology (4, 4) needs 16 devices, have 1"
    got = [_error(lambda: api.Supernode((2, 2), axis_names=("data",)))
           for api, *_ in SIDES]
    assert got[1] == got[0] and got[0][0] == "TopologyError"
    got = [_error(lambda: s.resolve(api.plans.serve_disagg())) for api, s in
           ((japi, japi.Supernode()),
            (tapi, tapi.Supernode(device="cpu")))]
    assert got[1] == got[0] and got[0][0] == "TopologyError"
    got = [_error(lambda: api.Supernode((2, 2, 2, 2))) for api, *_ in SIDES]
    assert got[1] == got[0]


def test_session_train_rejects_role_plans():
    got = [_error(lambda: s.train(base.get_config("qwen2-0.5b").reduced(),
                                  base.ShapeConfig("x", 32, 2, "train"),
                                  plan=api.plans.serve_disagg()))
           for api, base, s in ((japi, jbase, japi.Supernode()),
                                (tapi, tbase, tapi.Supernode(
                                    device="cpu")))]
    assert got[1] == got[0] and "roles" in got[0][1]


def test_serving_rejects_fsdp_plans_with_reason():
    from repro_torch.api.errors import ServePlanError
    from repro_torch.serve.runtime import _resolve_serve_plan
    with pytest.raises(ServePlanError) as ei:
        _resolve_serve_plan(hypershard.ShardingPlan())
    assert "fsdp" in str(ei.value) and "replace(fsdp=None)" in str(ei.value)
    splan, scfg = _resolve_serve_plan(None)
    assert splan.fsdp is None and scfg is None
    splan2, scfg2 = _resolve_serve_plan(tapi.plans.serve())
    assert splan2.fsdp is None and isinstance(scfg2, tbase.ServeConfig)
    with pytest.raises(ServePlanError):
        _resolve_serve_plan(tapi.plans.fsdp_tp())


# ---------------------------------------------------------------------------
# the legacy routes resolve as the plan route does
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ("granite-3-2b", "deepseek-moe-16b",
                                  "recurrentgemma-2b"))
def test_legacy_sharding_plan_and_hyperplan_specs_identical(arch):
    from repro_torch.core.tree import tree_flatten_with_path
    from repro_torch.mem.planner import param_shapes
    cfg = tbase.get_config(arch)
    layout = Layout(*PROD)
    legacy, lowered = hypershard.ShardingPlan(), \
        tapi.plans.fsdp_tp().sharding_plan()
    assert legacy == lowered
    for path, leaf in tree_flatten_with_path(param_shapes(cfg)):
        assert (hypershard.param_strategy(path, tuple(leaf.shape), layout,
                                          legacy).partition_spec()
                == hypershard.param_strategy(path, tuple(leaf.shape), layout,
                                             lowered).partition_spec())


def test_legacy_offload_folds_into_plan():
    legacy = trainer.resolve_train_plan(
        None, None, OffloadConfig(params_on_host=True, opt_state_on_host=True))
    plan = trainer.resolve_train_plan(
        None, tapi.plans.fsdp_tp(params_on_host=True,
                                 opt_state_on_host=True), None)
    folded = trainer.resolve_train_plan(
        None, tapi.plans.fsdp_tp(), OffloadConfig(params_on_host=True,
                                                  opt_state_on_host=True))
    assert plan == folded
    assert legacy[1] == plan[1]
    splan, ocfg = plan
    # the steps stay on the device: the lowered ShardingPlan never carries
    # the host flags (they lower into the OffloadConfig leg only)
    assert not splan.params_on_host and not splan.opt_state_on_host
    assert ocfg.params_on_host and ocfg.opt_state_on_host


@pytest.mark.parametrize("legs", [
    (dict(stream_layers=True, prefetch_depth=3), dict(prefetch_depth=5)),
    (dict(offload_policy="graph"), dict(policy="lru")),
    (dict(offload_policy="graph", host_budget_bytes=4),
     dict(host_budget_bytes=8)),
    (dict(prefetch_depth=3), dict(prefetch_depth=3, params_on_host=True))])
def test_absorb_offload_matches_the_reference(legs):
    plan_kw, off_kw = legs
    got = [_run(lambda: dataclasses.asdict(api.plans.offload_all(
        **plan_kw).absorb_offload(O(**off_kw))))
        for api, _, _, O in SIDES]
    assert got[1] == got[0]


def test_coerce_matches_the_reference():
    for_serving = [api.HyperPlan.coerce(None, for_serving=True)
                   for api, *_ in SIDES]
    assert dataclasses.asdict(for_serving[1]) == dataclasses.asdict(
        for_serving[0])
    from repro.core.hypershard import ShardingPlan as JaxShardingPlan
    legacy = [japi.HyperPlan.coerce(JaxShardingPlan(fsdp=("data",),
                                                    params_on_host=True)),
              tapi.HyperPlan.coerce(hypershard.ShardingPlan(
                  fsdp=("data",), params_on_host=True))]
    assert dataclasses.asdict(legacy[1]) == dataclasses.asdict(legacy[0])
    got = [_error(lambda: api.HyperPlan.coerce("fsdp_tp"))
           for api, *_ in SIDES]
    assert got[1] == got[0] and got[0][0] == "PlanError"


def test_preset_registry():
    """The same preset names, each preset (and with arguments and
    overrides) field for field the reference's."""
    assert tapi.plans.names() == japi.plans.names()
    for name in japi.plans.names():
        assert (dataclasses.asdict(tapi.plans.get(name)())
                == dataclasses.asdict(japi.plans.get(name)())), name
    for api in (japi, tapi):
        with pytest.raises(KeyError):
            api.plans.get("nope")
    p = tapi.plans.fsdp_tp(params_on_host=True)
    assert p.params_on_host and p.fsdp == ("pod", "data")
    assert tapi.plans.serve_disagg(3, 5).roles_dict() == {"prefill": 3,
                                                          "decode": 5}
    assert dataclasses.asdict(tapi.plans.pipeline_fsdp(3, 6)) == \
        dataclasses.asdict(japi.plans.pipeline_fsdp(3, 6))
    assert dataclasses.asdict(tapi.plans.rl_disagg(1, 2)) == \
        dataclasses.asdict(japi.plans.rl_disagg(1, 2))


def test_topology_module_keeps_the_reference_shapes():
    """The logical matrices of the reference, with the H100's rates."""
    from repro.core import topology as jtopo
    from repro_torch.core import topology as ttopo
    for a, b in ((jtopo.SINGLE_POD, ttopo.SINGLE_POD),
                 (jtopo.MULTI_POD, ttopo.MULTI_POD)):
        assert (a.chips, a.pods, a.mesh_shape, a.axis_names) == \
            (b.chips, b.pods, b.mesh_shape, b.axis_names)
        assert b.axis_size("model") == a.axis_size("model")
    assert ttopo.PEAK_FLOPS_BF16 == 989e12 and ttopo.HBM_BW == 3.35e12
    t = ttopo.roofline_terms(989e12, 3.35e12 / 2, 0.0)
    assert t["dominant"] == "compute" and t["bound_s"] == 1.0
    cfg = tbase.get_config("qwen2-0.5b")
    assert ttopo.model_flops(cfg, 10, training=True) == jtopo.model_flops(
        jbase.get_config("qwen2-0.5b"), 10, training=True)


# ---------------------------------------------------------------------------
# session verbs on one device
# ---------------------------------------------------------------------------
def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def test_session_train_matches_the_trainer_and_the_reference():
    """``Supernode.train`` under fsdp_tp, f32: the history bit for bit the
    port's ``trainer.train`` from the same params, and within 1e-4
    relative of the JAX session's (the reference's params, bridged)."""
    jcfg = dataclasses.replace(jbase.get_config("qwen2-0.5b").reduced(),
                               dtype="float32")
    cfg = dataclasses.replace(tbase.get_config("qwen2-0.5b").reduced(),
                              dtype="float32")
    jp = JM.init_model(jcfg, jax.random.PRNGKey(0))
    bridged = (params_from_numpy(_np_tree(jp), "cpu"),
               adamw_state_from_numpy(_np_tree(jax_opt.init_adamw(jp)),
                                      "cpu"))
    _, jhist = japi.Supernode().train(
        jcfg, jbase.ShapeConfig("api", 32, 2, "train"),
        plan=japi.plans.fsdp_tp(),
        train_cfg=jax_trainer.TrainConfig(num_steps=3, log_every=1))
    mp = pytest.MonkeyPatch()
    mp.setattr(steps, "init_state", lambda *a, **k: bridged)
    try:
        _, hist = tapi.Supernode(device="cpu").train(
            cfg, tbase.ShapeConfig("api", 32, 2, "train"),
            plan=tapi.plans.fsdp_tp(),
            train_cfg=trainer.TrainConfig(num_steps=3, log_every=1))
        _, direct = trainer.train(
            cfg, tbase.ShapeConfig("api", 32, 2, "train"),
            train_cfg=trainer.TrainConfig(num_steps=3, log_every=1),
            device="cpu")
    finally:
        mp.undo()
    keys = ("loss", "ce", "grad_norm", "lr")
    assert [[m[k] for k in keys] for m in hist] == \
        [[m[k] for k in keys] for m in direct]
    for j, t in zip(jhist, hist):
        for k in keys:
            assert abs(j[k] - t[k]) <= 1e-4 * max(1.0, abs(j[k])), (k, j, t)


def test_session_pipeline_train_matches_the_pipeline_trainer():
    from repro_torch.train.pipeline_trainer import train_pipeline
    cfg = tbase.get_config("qwen2-0.5b").reduced()
    shape = tbase.ShapeConfig("api", 32, 2, "train")
    tc = trainer.TrainConfig(num_steps=2, log_every=1)
    _, hist = tapi.Supernode(device="cpu").train(
        cfg, shape, plan=tapi.plans.pipeline(micro_batches=2), train_cfg=tc)
    _, direct = train_pipeline(
        cfg, shape, pipeline=tbase.PipelineConfig(micro_batches=2),
        plan=hypershard.ShardingPlan(fsdp=None), train_cfg=tc, device="cpu")
    keys = ("loss", "grad_norm", "lr")
    assert [[m[k] for k in keys] for m in hist] == \
        [[m[k] for k in keys] for m in direct]


def test_session_generate_and_serve_match_the_engines():
    """``generate`` equal to the port's Generator and (greedy) to the JAX
    session's; ``serve`` (the plan's ServeConfig) equal to HyperServe
    built directly and to the generated tokens."""
    from repro_torch.serve.api import HyperServe
    from repro_torch.serve.engine import GenerateConfig, Generator
    jcfg, cfg, jp, tp = _models("qwen2-0.5b")
    session = tapi.Supernode(device="cpu")
    prompt = list(range(1, 9))
    got = session.generate(cfg, tp, np.asarray([prompt], np.int32),
                           max_new_tokens=5, max_len=64)
    direct = Generator(cfg, tp, max_len=64, device="cpu").generate(
        torch.tensor([prompt]), GenerateConfig(max_new_tokens=5))
    assert torch.equal(got, direct)
    want = japi.Supernode().generate(jcfg, jp, np.asarray([prompt], np.int32),
                                     max_new_tokens=5, max_len=64)
    assert got[0].tolist() == np.asarray(want)[0].tolist()
    scfg = tbase.ServeConfig(block_size=4, num_blocks=32,
                             max_blocks_per_req=8, max_slots=2,
                             prefill_chunk=4)
    serve = session.serve(cfg, tp, plan=tapi.plans.serve(serve=scfg))
    assert serve.engine.scfg == scfg
    rid = serve.submit(prompt, 5)
    out = serve.join()
    assert out[rid] == got[0, 8:].tolist()
    lone = HyperServe(cfg, tp, serve_cfg=scfg, device="cpu")
    lrid = lone.submit(prompt, 5)
    assert lone.join()[lrid] == out[rid]
    assert out[rid] == _generator("qwen2-0.5b").generate(
        jnp.asarray(prompt, jnp.int32)[None, :],
        GenerateConfig(max_new_tokens=5))[0, 8:].tolist()


def test_session_serve_rejects_training_plan():
    _, cfg, _, tp = _models("qwen2-0.5b")
    with pytest.raises(tapi.ServePlanError):
        tapi.Supernode(device="cpu").serve(cfg, tp,
                                           plan=tapi.plans.fsdp_tp())


def test_session_rl_matches_a_direct_session():
    """``Supernode.rl`` under ``rl_colocate`` (its RL and serving legs from
    the plan): one iteration equal to an ``RLSession`` built with those
    legs directly."""
    from repro_torch.rl import RLSession
    _, cfg, _, tp = _models("qwen2-0.5b")
    rl_cfg = tbase.RLConfig(group_size=2, max_new_tokens=4, lr=1e-3)
    scfg = tbase.ServeConfig(block_size=4, num_blocks=64,
                             max_blocks_per_req=8, max_slots=2,
                             prefill_chunk=8, enable_prefix_cache=False)
    prompts = [list(range(1, 7))]

    def reward(prompt, tokens):
        return float(sum(tokens) % 5)
    a = tapi.Supernode(device="cpu").rl(cfg, plan=tapi.plans.rl_colocate(
        rl=rl_cfg, serve=scfg), params=tp)
    b = RLSession(cfg, rl_cfg=rl_cfg, serve_cfg=scfg, params=tp,
                  device="cpu")
    ma, mb = a.iterate(prompts, reward), b.iterate(prompts, reward)
    keys = ("loss", "reward_mean", "rollout_tokens", "weights_version")
    assert [ma[k] for k in keys] == [mb[k] for k in keys]


def test_session_fabric_matches_replicas_built_directly():
    from repro_torch.serve.api import HyperServe
    _, cfg, _, tp = _models("qwen2-0.5b")
    scfg = tbase.ServeConfig(block_size=4, num_blocks=40,
                             max_blocks_per_req=8, max_slots=3,
                             prefill_chunk=4)
    fab = tapi.Supernode(device="cpu").fabric(
        cfg, tp, plan=tapi.plans.fabric(serve=scfg))
    assert len(fab.replicas) == 2 and fab.groups is None
    assert all(r.engine.scfg == scfg for r in fab.replicas)
    fids = [fab.submit(p, 4) for p in ([1, 2, 3, 4, 5], [9, 8, 7])]
    fab.join()
    lone = HyperServe(cfg, tp, serve_cfg=scfg, device="cpu")
    rids = [lone.submit(p, 4) for p in ([1, 2, 3, 4, 5], [9, 8, 7])]
    out = lone.join()
    assert [fab.result(f) for f in fids] == [out[r] for r in rids]


def test_session_refusals_name_what_is_left():
    """``generate`` on a mesh names the last slice; a plan that is no plan
    raises the reference's PlanError wherever a plan is taken (the port's
    engines took only a ShardingPlan before the facade)."""
    import types
    from repro_torch.rl import RLSession
    from repro_torch.serve.api import HyperServe
    _, cfg, _, tp = _models("qwen2-0.5b")
    session = tapi.Supernode(device="cpu")
    session.mesh = types.SimpleNamespace()           # a stand-in mesh
    with pytest.raises(tapi.PlanError, match="item 8h, the last slice"):
        session.generate(cfg, tp, [[1, 2, 3]])
    for fn in (lambda: HyperServe(cfg, tp, plan="serve", device="cpu"),
               lambda: RLSession(cfg, params=tp, plan="rl", device="cpu"),
               lambda: steps.make_train_step(cfg, None, plan="fsdp_tp")):
        with pytest.raises(tapi.PlanError, match="cannot coerce str into a "
                           "HyperPlan"):
            fn()
    # a HyperPlan is taken where a ShardingPlan was: lowered once
    assert steps.check_mesh_plan(None, tapi.plans.tp_only()) == \
        hypershard.ShardingPlan(fsdp=None)


def test_launchers_explain_the_reference_report(capsys):
    """``--explain`` of the train, serve, rl and fabric launchers prints
    the plan resolution report the reference's launcher prints (its
    header, rows and totals line), and exits."""
    import contextlib
    import io

    from repro.api import explain as jexplain
    from repro_torch.launch import fabric, rl, serve, train
    jcfg = jbase.get_config("qwen2-0.5b").reduced()
    for mod, argv, plan in (
            (train, [], japi.plans.fsdp_tp()),
            (serve, ["--slots", "4", "--kernels", "fused"],
             japi.plans.serve(serve=jbase.ServeConfig(
                 block_size=16, num_blocks=256, max_blocks_per_req=4,
                 max_slots=4, prefill_chunk=32, kernels="fused"))),
            (rl, [], None), (fabric, [], None)):
        mod.main(["--arch", "qwen2-0.5b", "--reduced", "--explain", *argv])
        out = capsys.readouterr().out.strip().splitlines()
        assert out[0].startswith("HyperPlan resolution: model=qwen2-0.5b")
        assert "divisibility fallbacks" in out[-1]
        if plan is not None and mod is train:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                print(jexplain(plan, jcfg, batch=4))
            assert out[-1] == buf.getvalue().strip().splitlines()[-1]
