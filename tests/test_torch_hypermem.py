"""The port's HyperMem against the reference's, on the CPU.

- ``TierStack``: one seeded call history of puts (pinned and unpinned),
  gets, pops, peeks and discards, replayed against the reference's store
  (numpy leaves) and the port's (torch leaves, float32 and bfloat16, the
  reference's leaves of the same byte width): at every step the same
  tier for every key, the same counters and byte totals, the same typed
  capacity errors, and values bit-identical to what was put after any
  number of disk round trips.
- ``HostArchive``: evictions reach ``obs``; a disk tier full of pinned
  entries is the port's typed ``MemCapacityError``.
- Serving through the disk tier: the reference's own round-trip cases
  (``tests/test_hypermem.py``: paged qwen2-0.5b, the windowed
  recurrentgemma-2b with seat rows, a forced preemption of mamba2-370m,
  and a pool below the working set) served by the port's ``HyperServe`` on
  the CPU, greedy tokens identical to the JAX ``HyperServe`` and
  ``Generator``, the archive and prefetch stats equal to the reference's;
  a disk budget below one spilled entry raises ``MemCapacityError`` in
  both, the pinned entry kept.
- ``plan_residency`` on four full-size archs (a walk of shapes only),
  each leaf's tier, rule, first use, layers and prefetch step and the
  schedule equal to the reference's under two budget splits, and the
  capacity error.
- ``KVCachePool`` and ``combine_partials`` against the reference's on the
  reference's own cases (``tests/test_serve.py``), within 1e-4 in f32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from repro.configs.base import ServeConfig as JaxServeConfig  # noqa: E402
from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.core import kvcache as jkv  # noqa: E402
from repro.core.offload import OffloadConfig as JaxOffloadConfig  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.mem import MemCapacityError as JaxMemCapacityError  # noqa: E402
from repro.mem import TierStack as JaxTierStack  # noqa: E402
from repro.mem import plan_residency as jax_plan_residency  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve.api import HyperServe as JaxHyperServe  # noqa: E402
from repro.serve.engine import GenerateConfig  # noqa: E402
from repro.serve.scheduler import RequestState as JaxRequestState  # noqa: E402
from repro.serve.scheduler import StepPlan as JaxStepPlan  # noqa: E402
from repro_torch.api.errors import PlanError  # noqa: E402
from repro_torch.configs.base import ServeConfig, get_config  # noqa: E402
from repro_torch.core import kvcache as kv  # noqa: E402
from repro_torch.core.offload import OffloadConfig  # noqa: E402
from repro_torch.mem import (DISK, HBM, HOST, MemCapacityError,  # noqa: E402
                             TierStack, plan_residency, tree_nbytes)
from repro_torch.obs import Observability  # noqa: E402
from repro_torch.serve.api import HyperServe  # noqa: E402
from repro_torch.serve.paged_kv import blocks_for  # noqa: E402
from repro_torch.serve.scheduler import RequestState, StepPlan  # noqa: E402
from test_torch_serve import HYBRID, _generator, _models  # noqa: E402


# ---------------------------------------------------------------------------
# TierStack: one call history, both stores, step by step
# ---------------------------------------------------------------------------
def _history(seed=0, n=160, keys=8):
    """Seeded ops: (op, key, pinned, (n_a, m_b)); sizes in elements."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n):
        op = rng.choice(["put", "put", "get", "pop", "peek", "discard"])
        ops.append((str(op), int(rng.integers(keys)),
                    bool(rng.random() < 0.7),
                    (int(rng.integers(1, 24)), int(rng.integers(1, 6)))))
    return ops


def _bits(t):
    return t.contiguous().view(torch.uint8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tierstack_replay_matches_reference(dtype):
    tdt = getattr(torch, dtype)
    ndt = {"float32": np.float32, "bfloat16": np.float16}[dtype]
    budgets = dict(host_bytes=30 * tdt.itemsize, disk_bytes=70 * tdt.itemsize)
    ref, port = JaxTierStack(**budgets), TierStack(**budgets)
    gen = torch.Generator().manual_seed(1)
    truth = {}
    raised = {"capacity": 0, "missing": 0}
    for i, (op, key, pinned, (na, mb)) in enumerate(_history()):
        if op == "put":
            pv = {"a": torch.randn(na, generator=gen).to(tdt),
                  "b": (torch.randn(2, mb, generator=gen).to(tdt),)}
            rv = {"a": np.zeros(na, ndt), "b": (np.zeros((2, mb), ndt),)}
            truth[key] = pv
            outcome = []
            for store, value, err in ((ref, rv, JaxMemCapacityError),
                                      (port, pv, MemCapacityError)):
                try:
                    store.put(key, value, pinned=pinned)
                    outcome.append(None)
                except err as e:
                    outcome.append(str(e))
            assert outcome[0] == outcome[1], (i, outcome)
            raised["capacity"] += outcome[0] is not None
        else:
            kw = {"get": dict(), "pop": dict(pop=True),
                  "peek": dict(promote=False)}.get(op)
            if kw is None:
                ref.discard(key)
                port.discard(key)
            elif key not in ref:
                assert key not in port
                with pytest.raises(KeyError):
                    port.get(key, **kw)
                raised["missing"] += 1
            else:
                (_, rtier), (got, ptier) = ref.get(key, **kw), port.get(key,
                                                                        **kw)
                assert rtier == ptier, i
                want = truth[key]
                assert got["a"].dtype == tdt and got["b"][0].dtype == tdt
                assert torch.equal(_bits(got["a"]), _bits(want["a"]))
                assert torch.equal(_bits(got["b"][0]), _bits(want["b"][0]))
        for k in range(8):
            assert ref.tier_of(k) == port.tier_of(k), (i, k)
        assert ref.counters == port.counters, i
        for tier in (HOST, DISK, None):
            assert ref.nbytes(tier) == port.nbytes(tier), (i, tier)
            assert ref.entries(tier) == port.entries(tier), (i, tier)
    # the history exercised every path
    assert port.counters["evict_host"] and port.counters["evict_disk"]
    assert port.counters["disk_loads"] and raised["capacity"]
    assert raised["missing"]
    assert tree_nbytes({"x": torch.zeros(3, 5, dtype=tdt)}) == \
        15 * tdt.itemsize
    path = port._tmpdir
    port.close()
    ref.close()
    assert path is None or not __import__("os").path.exists(path)


def test_host_archive_counters_reach_obs_and_capacity_error_is_typed():
    obs = Observability()
    ar = kv.HostArchive("cpu", host_budget_bytes=100, obs=obs)
    ar.put(("req", 0), {"pages": torch.ones(2, 3, 4)})          # 96 B
    ar.put(("req", 1), {"pages": torch.full((2, 3, 4), 2.0)})
    assert ar.tier_of(("req", 0)) == DISK and ar.tier_of(("req", 1)) == HOST
    assert ar.nbytes_host() == ar.nbytes_disk() == 96
    assert obs.metrics.counter("mem.evict.host").value == 1
    got = ar.fetch(("req", 0), pop=False)                       # a peek
    assert torch.equal(got["pages"], torch.ones(2, 3, 4))
    assert ar.tier_of(("req", 0)) == DISK                       # not promoted
    ar.fetch(("req", 0), pop=False, promote=True)
    assert ar.tier_of(("req", 0)) == HOST
    assert obs.metrics.counter("mem.evict.host").value == \
        ar.counters["evict_host"] == 2
    small = kv.HostArchive("cpu", host_budget_bytes=8, disk_budget_bytes=8,
                           obs=obs)
    with pytest.raises(MemCapacityError, match="disk tier exhausted"):
        small.put(("req", 0), torch.ones(64))
    assert issubclass(MemCapacityError, RuntimeError)
    assert small.tier_of(("req", 0)) == DISK                    # kept
    assert obs.metrics.counter("mem.evict.host").value == 3


# ---------------------------------------------------------------------------
# serving round trips through the disk tier (tests/test_hypermem.py cases)
# ---------------------------------------------------------------------------
ROUND_TRIPS = {
    # test_paged_family_disk_round_trip_predictive_restore
    "paged": ("qwen2-0.5b", (), dict(
        block_size=4, num_blocks=9, max_blocks_per_req=8, max_slots=2,
        prefill_chunk=4, enable_prefix_cache=False, archive_host_bytes=64,
        restore_lookahead=2),
        [list(range(1, 9)), list(range(20, 33)), list(range(5, 10))],
        [8, 8, 8], False),
    # test_windowed_slot_family_disk_round_trip (the port's cached hybrid
    # model: 5 layers, window 16, so both segments exist)
    "windowed": (*HYBRID, dict(
        block_size=2, num_blocks=11, max_blocks_per_req=10, max_slots=2,
        prefill_chunk=4, enable_prefix_cache=False, archive_host_bytes=64,
        restore_lookahead=2),
        [list(range(1, 5)), list(range(7, 11))], [8, 8], False),
    # test_ssd_family_disk_round_trip_forced
    "ssd": ("mamba2-370m", (), dict(
        block_size=4, num_blocks=40, max_blocks_per_req=8, max_slots=2,
        prefill_chunk=4, enable_prefix_cache=False, archive_host_bytes=64,
        restore_lookahead=2),
        [list(range(1, 9)), list(range(20, 28))], [6, 6], True),
    # test_tiny_hbm_pool_below_peak_working_set_completes
    "tiny_pool": ("qwen2-0.5b", (), dict(
        block_size=4, num_blocks=9, max_blocks_per_req=8, max_slots=3,
        prefill_chunk=4, enable_prefix_cache=False, archive_host_bytes=256,
        restore_lookahead=2),
        [list(range(1, 9)), list(range(20, 33)), list(range(5, 10)),
         list(range(40, 52))], [8, 8, 8, 8], False),
}
STAT_KEYS = ("preemptions", "restore_ahead_hits", "prefetch_misses",
             "archive_evict_host", "archive_evict_disk",
             "archive_host_bytes", "archive_disk_bytes", "finished")


def _drive(serve, prompts, max_new, lookahead, force, state, plan_cls):
    """Submit, optionally preempt the first runner white-box as the
    reference's test does (then stage near-head restores, as the tail of
    an engine step would), and join."""
    rids = [serve.submit(p, n) for p, n in zip(prompts, max_new)]
    if force:
        sched = serve.engine.scheduler
        for _ in range(64):
            serve.step_once()
            runners = [r for r in sched.active if r.state is state.RUNNING]
            if runners:
                sched._preempt(runners[-1], plan_cls())
                near = [r for r in list(sched.queue)[:lookahead]
                        if r.state is state.PREEMPTED]
                serve.engine._stage_restores(near)
                break
        else:
            raise AssertionError("no request ever reached RUNNING")
    out = serve.join()
    return [out[r] for r in rids]


@pytest.mark.parametrize("case", sorted(ROUND_TRIPS))
def test_disk_round_trip_matches_reference(case):
    arch, over, kw, prompts, max_new, force = ROUND_TRIPS[case]
    jcfg, cfg, jp, tp = _models(arch, over)
    gen = _generator(arch, over)
    want_gen = [gen.generate(jnp.asarray(p, jnp.int32)[None, :],
                             GenerateConfig(max_new_tokens=n))[0, len(p):]
                .tolist() for p, n in zip(prompts, max_new)]
    ref = JaxHyperServe(jcfg, jp, serve_cfg=JaxServeConfig(kernels="composed",
                                                           **kw))
    want = _drive(ref, prompts, max_new, kw["restore_lookahead"], force,
                  JaxRequestState, JaxStepPlan)
    port = HyperServe(cfg, tp, serve_cfg=ServeConfig(**kw), device="cpu")
    got = _drive(port, prompts, max_new, kw["restore_lookahead"], force,
                 RequestState, StepPlan)
    assert got == want == want_gen
    rs, ps = ref.stats(), port.stats()
    for key in STAT_KEYS:
        assert ps[key] == rs[key], (key, ps[key], rs[key])
    assert ps["preemptions"] >= 1 and ps["archive_evict_host"] >= 1
    assert ps["archive_host_bytes"] == ps["archive_disk_bytes"] == 0
    m, jm = port.obs().metrics, ref.obs().metrics
    for name in ("mem.evict.host", "mem.evict.disk", "mem.restore_ahead.hit",
                 "mem.prefetch.hit", "mem.prefetch.miss"):
        assert m.counter(name).value == jm.counter(name).value, name
    assert m.counter("mem.evict.host").value == ps["archive_evict_host"]
    if case != "tiny_pool":
        assert ps["restore_ahead_hits"] >= 1
    else:
        assert sum(blocks_for(len(p) + n, kw["block_size"])
                   for p, n in zip(prompts, max_new)) > kw["num_blocks"] - 1


def test_disk_budget_below_a_spilled_entry_raises():
    """A disk tier that cannot hold one spilled (pinned) entry: the typed
    MemCapacityError in both packages, the entry kept, nothing dropped."""
    arch, over, kw, prompts, max_new, _ = ROUND_TRIPS["paged"]
    kw = dict(kw, archive_disk_bytes=64)
    jcfg, cfg, jp, tp = _models(arch, over)
    ref = JaxHyperServe(jcfg, jp, serve_cfg=JaxServeConfig(kernels="composed",
                                                           **kw))
    with pytest.raises(JaxMemCapacityError, match="disk tier exhausted"):
        _drive(ref, prompts, max_new, 2, False, JaxRequestState, JaxStepPlan)
    port = HyperServe(cfg, tp, serve_cfg=ServeConfig(**kw), device="cpu")
    with pytest.raises(MemCapacityError, match="disk tier exhausted"):
        _drive(port, prompts, max_new, 2, False, RequestState, StepPlan)
    arch_ = port.engine.blocks.archive
    assert arch_.counters["evict_disk"] == 0
    spilled = [r for r in port.engine.scheduler.requests.values()
               if r.archive_key in arch_]
    assert len(spilled) == 1 and arch_.tier_of(spilled[0].archive_key) == DISK
    assert arch_.nbytes_disk() > kw["archive_disk_bytes"]
    assert port.obs().metrics.counter("mem.evict.host").value == \
        arch_.counters["evict_host"] >= 1


# ---------------------------------------------------------------------------
# plan_residency at full size
# ---------------------------------------------------------------------------
PLAN_ARCHS = ("qwen2-0.5b", "deepseek-v2-lite-16b", "mamba2-370m",
              "recurrentgemma-2b")


def _splits(total):
    # tests/test_hypermem.py's 1/3 + 1/3 + unbounded split; device only
    return {"thirds": dict(policy="graph", hbm_budget_bytes=total // 3,
                           host_budget_bytes=total // 3,
                           disk_budget_bytes=0),
            "hbm_only": dict(policy="graph", prefetch_depth=1)}


@pytest.mark.parametrize("arch", PLAN_ARCHS)
def test_plan_residency_matches_reference(arch):
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    total = sum(l.nbytes for l in plan_residency(
        cfg, OffloadConfig(policy="graph")).leaves)
    for name, kw in _splits(total).items():
        want = jax_plan_residency(jcfg, JaxOffloadConfig(**kw))
        got = plan_residency(cfg, OffloadConfig(**kw))
        assert want.graph_order and got.graph_order, name
        assert len(got.leaves) == len(want.leaves)
        for a, b in zip(got.leaves, want.leaves):
            assert dataclasses.asdict(a) == dataclasses.asdict(b), (name, a)
        assert got.schedule == want.schedule, name
        assert (got.model, got.policy, got.budgets, got.prefetch_depth) == (
            want.model, want.policy, want.budgets, want.prefetch_depth)
        if name == "thirds":
            assert got.count_in(HBM) and got.count_in(HOST) and \
                got.count_in(DISK)
    assert total == sum(l.nbytes for l in want.leaves)
    budget = dict(policy="graph", hbm_budget_bytes=4096,
                  host_budget_bytes=4096, disk_budget_bytes=4096)
    with pytest.raises(JaxMemCapacityError) as je:
        jax_plan_residency(jcfg, JaxOffloadConfig(**budget))
    with pytest.raises(MemCapacityError) as te:
        plan_residency(cfg, OffloadConfig(**budget))
    assert str(te.value) == str(je.value)


def test_run_schedule_stages_a_plan_as_the_reference():
    """A graph plan's prefetch schedule driven step by step through both
    packages' Prefetchers: the same keys staged, hit and missed."""
    from repro.mem import Prefetcher as JaxPrefetcher
    from repro.mem import run_schedule as jax_run_schedule
    from repro_torch.mem import Prefetcher, run_schedule
    kw = dict(policy="graph", prefetch_depth=1, hbm_budget_bytes=1 << 20)
    cfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(),
                              num_layers=4)
    jcfg = dataclasses.replace(jax_get_config("qwen2-0.5b").reduced(),
                              num_layers=4)
    sched = plan_residency(cfg, OffloadConfig(**kw)).schedule_dict()
    assert sched == jax_plan_residency(jcfg, JaxOffloadConfig(**kw)) \
        .schedule_dict() and len(sched) > 1
    staged = []
    for pf_cls, run in ((JaxPrefetcher, jax_run_schedule),
                        (Prefetcher, run_schedule)):
        pf = pf_cls(lambda k: k, depth=4)
        n = [run(sched, step, pf, consume=pf.take)
             for step in range(max(sched) + 1)]
        staged.append((n, dict(pf.counters)))
    assert staged[0] == staged[1] and sum(staged[1][0]) > 0


def test_plan_residency_refuses_the_hlo_summary():
    with pytest.raises(PlanError, match="HLO"):
        plan_residency(get_config("qwen2-0.5b"),
                       OffloadConfig(policy="graph"), with_hlo=True)


# ---------------------------------------------------------------------------
# KVCachePool (tests/test_serve.py's cases)
# ---------------------------------------------------------------------------
def test_combine_partials_matches_reference_and_oracle():
    rng = np.random.default_rng(0)
    B, H, KV, D, S = 2, 4, 2, 32, 96
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    k = (rng.standard_normal((B, S, KV, D)) * 0.3).astype(np.float32)
    v = (rng.standard_normal((B, S, KV, D)) * 0.3).astype(np.float32)
    cuts = ((0, 32), (32, 64), (64, S))
    parts = [kv._partial_attn(torch.from_numpy(q),
                              torch.from_numpy(k[:, a:b]),
                              torch.from_numpy(v[:, a:b])) for a, b in cuts]
    jparts = [jkv._partial_attn(q, k[:, a:b], v[:, a:b]) for a, b in cuts]
    for (o, l), (jo, jl) in zip(parts, jparts):
        assert np.abs(o.numpy() - np.asarray(jo)).max() < 1e-5
        assert np.abs(l.numpy() - np.asarray(jl)).max() < 1e-5
    got = kv.combine_partials([o for o, _ in parts], [l for _, l in parts])
    want = jax_ref.decode_attention(q[:, None], k, v,
                                    jnp.full((B,), S, jnp.int32))[:, 0]
    assert np.abs(got.numpy() - np.asarray(want)).max() < 1e-4


@pytest.mark.parametrize("case", ["flat_cache", "accounting"])
def test_kv_pool_matches_reference(case):
    B, max_len, hot, block, n = {"flat_cache": (2, 64, 16, 8, 40),
                                 "accounting": (1, 128, 8, 4, 64)}[case]
    jcfg = dataclasses.replace(jax_get_config("granite-3-2b").reduced(),
                               dtype="float32")
    cfg = dataclasses.replace(get_config("granite-3-2b").reduced(),
                              dtype="float32")
    jpool = jkv.KVCachePool(jcfg, batch=B, max_len=max_len,
                            pool=jkv.KVPoolConfig(hot_window=hot, block=block,
                                                  dtype="float32"))
    pool = kv.KVCachePool(cfg, batch=B, max_len=max_len,
                          pool=kv.KVPoolConfig(hot_window=hot, block=block,
                                               dtype="float32"),
                          device="cpu")
    KV, hd, H = cfg.num_kv_heads, cfg.resolved_head_dim, cfg.num_heads
    rng = np.random.default_rng(1)
    ks = (rng.standard_normal((n, B, 1, KV, hd)) * 0.3).astype(np.float32)
    vs = (rng.standard_normal((n, B, 1, KV, hd)) * 0.3).astype(np.float32)
    hbm0 = pool.hbm_bytes()
    for t in range(n):
        jpool.append(jnp.asarray(ks[t]), jnp.asarray(vs[t]))
        pool.append(torch.from_numpy(ks[t]), torch.from_numpy(vs[t]))
        assert (pool.length, len(pool.archive_k), pool.host_bytes()) == (
            jpool.length, len(jpool.archive_k), jpool.host_bytes())
    assert pool.hbm_bytes() == jpool.hbm_bytes() == hbm0
    q = (rng.standard_normal((B, H, hd)) * 0.5).astype(np.float32)
    got = pool.attend(torch.from_numpy(q)).numpy()
    assert np.abs(got - np.asarray(jpool.attend(jnp.asarray(q)))).max() < 1e-4
    want = jax_ref.decode_attention(
        q[:, None], np.concatenate(ks, 1), np.concatenate(vs, 1),
        jnp.full((B,), n, jnp.int32))[:, 0]
    assert np.abs(got - np.asarray(want)).max() < 1e-4
    if case == "flat_cache":
        assert pool.hbm_bytes() < pool.host_bytes()
