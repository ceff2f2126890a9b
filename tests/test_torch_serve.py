"""The port's HyperServe against the reference's, end to end on the CPU.

Same float32 params (JAX ``init_model``, carried over by the weight
bridge), same prompts and ``ServeConfig``s as the reference's own fused
serving tests (``tests/test_fused_serve.py``): the port's ``HyperServe``
on ``device="cpu"`` (the fused kernels' plain versions) must produce
greedy tokens identical to the JAX ``HyperServe`` (composed lowering, the
fast one on CPU) and to the JAX ``Generator``, through preemption, with
the scheduler counters and the compile-ledger keys equal to the
reference's exactly; the port's composed lowering is held to the same
tokens and to both frameworks' ``Generator``s.  The MoE configs
(deepseek-v2-lite-16b with MLA, deepseek-moe-16b) are served the same way,
fused and composed, through the ragged MoE dispatch, and the attention-free
mamba2-370m (SSD mixer, per-seat state) as the reference's own slot-state
serving tests serve it, and the hybrid recurrentgemma-2b (RG-LRU seat
state beside windowed LOCAL_ATTN pages) through window freeing and a
preemption that spills both.  Float32 so that no argmax can flip on
rounding.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from repro.configs.base import ServeConfig as JaxServeConfig  # noqa: E402
from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve.api import HyperServe as JaxHyperServe  # noqa: E402
from repro.serve.engine import GenerateConfig, Generator  # noqa: E402
from repro_torch.api.errors import ServePlanError  # noqa: E402
from repro_torch.configs.base import (ServeConfig, get_config,  # noqa: E402
                                      list_archs)
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402
from repro_torch.serve.api import HyperServe, RequestRejected  # noqa: E402
from repro_torch.serve.engine import \
    GenerateConfig as PortGenerateConfig  # noqa: E402
from repro_torch.serve.engine import Generator as PortGenerator  # noqa: E402
from repro_torch.serve.scheduler import RequestState  # noqa: E402

CASES = {
    # tests/test_fused_serve.py: test_attn_fused_serve_matches_generator
    "mixed": (dict(block_size=4, num_blocks=40, max_blocks_per_req=8,
                   max_slots=3, prefill_chunk=4),
              [list(range(1, 9)), list(range(20, 33)), list(range(5, 10))],
              [6, 4, 8]),
    # tests/test_fused_serve.py: test_fused_preemption_spill_restore_exact
    "preempt": (dict(block_size=2, num_blocks=9, max_blocks_per_req=6,
                     max_slots=2, prefill_chunk=4, enable_prefix_cache=False),
                [list(range(1, 5)), list(range(7, 11))], [8, 8]),
}


# mamba2-370m: tests/test_hyperserve.py's slot-state cases
SSD_CASES = {
    # test_mamba2_paged_serve_matches_generator
    "mixed": CASES["mixed"],
    # test_batched_prefill_matches_generator_all_families: ragged lengths,
    # chunks of several requests per call, filler rows at the null seat
    "batched": (dict(block_size=4, num_blocks=48, max_blocks_per_req=8,
                     max_slots=4, prefill_chunk=4, prefill_chunks_per_step=4,
                     prefill_batch=4, enable_prefix_cache=False),
                [list(range(1, 14)), list(range(20, 23)),
                 list(range(30, 39)), list(range(50, 56))], [5, 7, 4, 6]),
    # test_pure_slot_models_ignore_block_pressure: a prompt far beyond the
    # block-table budget (40 tokens >> 4 x 2)
    "beyond_budget": (dict(block_size=4, num_blocks=4, max_blocks_per_req=2,
                           max_slots=2, prefill_chunk=8,
                           enable_prefix_cache=False),
                      [list(range(1, 41)), list(range(50, 60))], [8, 6]),
}


# recurrentgemma-2b (RG-LRU + LOCAL_ATTN): tests/test_hyperserve.py's
# hybrid cases, cut to 5 layers so both segments, (RG-LRU, RG-LRU,
# LOCAL_ATTN) and the (RG-LRU, RG-LRU) tail, exist, with a 16-token window
HYBRID = ("recurrentgemma-2b", (("num_layers", 5), ("sliding_window", 16)))
HYBRID_CASES = {
    # test_rglru_local_attn_windowed_serve_matches_generator: generation
    # runs past the window, so out-of-window blocks are freed
    "windowed": (dict(block_size=4, num_blocks=40, max_blocks_per_req=12,
                      max_slots=2, prefill_chunk=4),
                 [list(range(1, 9)), list(range(20, 33))], [20, 16]),
    # several chunks per call, filler rows at the null seat and block
    "batched": SSD_CASES["batched"],
    # test_slot_state_preemption_spill_restore_exact: the paged LOCAL_ATTN
    # layer's blocks run out, so a request is preempted and its seat rows
    # are spilled and restored beside its pages
    "preempt": (dict(block_size=2, num_blocks=11, max_blocks_per_req=10,
                     max_slots=2, prefill_chunk=4, enable_prefix_cache=False),
                [list(range(1, 5)), list(range(7, 11))], [8, 8]),
}


@functools.cache
def _models(arch, overrides=()):
    kw = dict(overrides, dtype="float32")
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(), **kw)
    cfg = dataclasses.replace(get_config(arch).reduced(), **kw)
    jp = JM.init_model(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                            "cpu")


@functools.cache
def _generator(arch, overrides=()):
    """One reference Generator per arch: its decode step compiles once
    for both cases."""
    jcfg, _, jp, _ = _models(arch, overrides)
    return Generator(jcfg, jp, max_len=128)


def _serve(server, prompts, max_new, **kw):
    rids = [server.submit(p, n, **kw) for p, n in zip(prompts, max_new)]
    out = server.join()
    return [out[r] for r in rids]


@pytest.mark.parametrize("arch,case", [
    (arch, case) for arch in ("qwen2-0.5b", "llama3-8b") for case in
    sorted(CASES)] + [("granite-3-2b", "mixed"), ("phi4-mini-3.8b", "mixed")])
def test_serve_matches_reference_serve_and_generator(arch, case):
    kw, prompts, max_new = CASES[case]
    jcfg, cfg, jp, tp = _models(arch)
    ref = JaxHyperServe(jcfg, jp, serve_cfg=JaxServeConfig(kernels="composed",
                                                           **kw))
    want = _serve(ref, prompts, max_new)
    gen = _generator(arch)
    want_gen = [gen.generate(jnp.asarray(p, jnp.int32)[None, :],
                             GenerateConfig(max_new_tokens=n))[0, len(p):]
                .tolist() for p, n in zip(prompts, max_new)]
    port = HyperServe(cfg, tp, serve_cfg=ServeConfig(**kw), device="cpu")
    got = _serve(port, prompts, max_new)
    assert got == want == want_gen
    rs, ps = ref.stats(), port.stats()
    for key in ("prefill_calls", "prefill_chunks", "preemptions",
                "prefix_hits", "finished"):
        assert ps[key] == rs[key], key
    if case == "preempt":
        assert ps["preemptions"] >= 1, "the case must really preempt"
        m = port.engine.obs.metrics
        assert m.counter("serve.spills").value >= 1
        assert m.counter("serve.restores").value >= 1
    assert (port.engine.obs.compiled_keys()
            == ref.engine.obs.compiled_keys())


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "deepseek-moe-16b"])
def test_moe_serve_matches_reference_and_generators(arch, case):
    """MLA + MoE and attention + MoE: the port's HyperServe, fused and
    composed, gives the JAX HyperServe's and both Generators' greedy
    tokens (the "preempt" case through preemption), with the scheduler
    counters, the ``serve.kernels.*`` dispatch counts and the compile
    ledger equal to the reference's (MLA has no fused prefill, so its
    prefill counts under the toggle, as in the reference)."""
    kw, prompts, max_new = CASES[case]
    jcfg, cfg, jp, tp = _models(arch)
    ref = JaxHyperServe(jcfg, jp, serve_cfg=JaxServeConfig(kernels="composed",
                                                           **kw))
    want = _serve(ref, prompts, max_new)
    gen = _generator(arch)
    want_gen = [gen.generate(jnp.asarray(p, jnp.int32)[None, :],
                             GenerateConfig(max_new_tokens=n))[0, len(p):]
                .tolist() for p, n in zip(prompts, max_new)]
    port_gen = PortGenerator(cfg, tp, max_len=128, device="cpu")
    got_gen = [port_gen.generate(torch.tensor([p]), PortGenerateConfig(
        max_new_tokens=n))[0, len(p):].tolist()
        for p, n in zip(prompts, max_new)]
    assert want == want_gen == got_gen
    rs, rm = ref.stats(), ref.engine.obs.metrics
    for kernels in ("fused", "composed"):
        port = HyperServe(cfg, tp, device="cpu", serve_cfg=ServeConfig(
            kernels=kernels, **kw))
        assert _serve(port, prompts, max_new) == want, kernels
        ps, m = port.stats(), port.engine.obs.metrics
        for key in ("prefill_calls", "prefill_chunks", "preemptions",
                    "prefix_hits", "finished"):
            assert ps[key] == rs[key], key
        for stage in ("decode", "prefill"):
            assert (m.counter(f"serve.kernels.{stage}.{kernels}").value
                    == rm.counter(f"serve.kernels.{stage}.composed").value
                    >= 1)
        assert (port.engine.obs.compiled_keys()
                == ref.engine.obs.compiled_keys())
    if case == "preempt":
        assert ps["preemptions"] >= 1, "the case must really preempt"


@pytest.mark.parametrize("case", sorted(SSD_CASES))
def test_ssd_serve_matches_reference_and_generators(case):
    """mamba2-370m (SSD, per-seat state): the port's HyperServe gives the
    JAX HyperServe's and both Generators' greedy tokens, with the scheduler
    counters and the compile ledger equal to the reference's; a prompt far
    beyond the block budget is admitted and never preempted, and no block
    is ever taken."""
    arch = "mamba2-370m"
    kw, prompts, max_new = SSD_CASES[case]
    jcfg, cfg, jp, tp = _models(arch)
    ref = JaxHyperServe(jcfg, jp, serve_cfg=JaxServeConfig(kernels="composed",
                                                           **kw))
    want = _serve(ref, prompts, max_new)
    gen = _generator(arch)
    want_gen = [gen.generate(jnp.asarray(p, jnp.int32)[None, :],
                             GenerateConfig(max_new_tokens=n))[0, len(p):]
                .tolist() for p, n in zip(prompts, max_new)]
    port_gen = PortGenerator(cfg, tp, max_len=128, device="cpu")
    got_gen = [port_gen.generate(torch.tensor([p]), PortGenerateConfig(
        max_new_tokens=n))[0, len(p):].tolist()
        for p, n in zip(prompts, max_new)]
    port = HyperServe(cfg, tp, serve_cfg=ServeConfig(**kw), device="cpu")
    got = _serve(port, prompts, max_new)
    assert got == want == want_gen == got_gen
    rs, ps = ref.stats(), port.stats()
    for key in ("prefill_calls", "prefill_chunks", "preemptions",
                "prefix_hits", "finished"):
        assert ps[key] == rs[key], key
    assert (port.engine.obs.compiled_keys()
            == ref.engine.obs.compiled_keys())
    if case == "batched":
        assert ps["prefill_chunks"] > ps["prefill_calls"]
    if case == "beyond_budget":
        assert ps["preemptions"] == 0 and ps["block_occupancy"] == 0.0


@pytest.mark.parametrize("case", sorted(HYBRID_CASES))
def test_hybrid_serve_matches_reference_and_generators(case):
    """recurrentgemma-2b (RG-LRU seat state + LOCAL_ATTN windowed pages):
    the port's HyperServe, fused and composed, gives the JAX HyperServe's
    and both Generators' greedy tokens with the reference's counters and
    compile ledger; every paged layer is windowed, so the runtime frees
    out-of-window blocks (seen in the "windowed" case) and a running
    request never holds more than ceil(window / block) + 1 blocks; the
    "preempt" case preempts, spilling and restoring seat rows and pages."""
    kw, prompts, max_new = HYBRID_CASES[case]
    jcfg, cfg, jp, tp = _models(*HYBRID)
    ref = JaxHyperServe(jcfg, jp, serve_cfg=JaxServeConfig(kernels="composed",
                                                           **kw))
    want = _serve(ref, prompts, max_new)
    gen = _generator(*HYBRID)
    want_gen = [gen.generate(jnp.asarray(p, jnp.int32)[None, :],
                             GenerateConfig(max_new_tokens=n))[0, len(p):]
                .tolist() for p, n in zip(prompts, max_new)]
    port_gen = PortGenerator(cfg, tp, max_len=128, device="cpu")
    got_gen = [port_gen.generate(torch.tensor([p]), PortGenerateConfig(
        max_new_tokens=n))[0, len(p):].tolist()
        for p, n in zip(prompts, max_new)]
    assert want == want_gen == got_gen
    rs = ref.stats()
    bound = -(-cfg.sliding_window // kw["block_size"]) + 1
    for kernels in ("fused", "composed"):
        port = HyperServe(cfg, tp, device="cpu", serve_cfg=ServeConfig(
            kernels=kernels, **kw))
        eng = port.engine
        assert eng.layout.free_window == cfg.sliding_window
        assert eng.layout.has_slot_state and not eng.layout.pure_paged
        rids = [port.submit(p, n) for p, n in zip(prompts, max_new)]
        freed = False
        while eng.scheduler.has_work():
            port.step_once()
            for r in eng.scheduler.requests.values():
                if r.state is RequestState.RUNNING:
                    assert r.live_blocks <= bound, (r.total_len, r.table)
                    freed = freed or r.null_prefix > 0 or (
                        bool(r.table) and r.table[0] == 0)
        assert [port.result(r) for r in rids] == want, kernels
        ps = port.stats()
        for key in ("prefill_calls", "prefill_chunks", "preemptions",
                    "prefix_hits", "finished"):
            assert ps[key] == rs[key], key
        assert eng.obs.compiled_keys() == ref.engine.obs.compiled_keys()
        assert eng.blocks.num_free == eng.blocks.num_total     # drained
        if case == "windowed":
            assert freed, "windowed freeing never fired"
        if case == "batched":
            assert ps["prefill_chunks"] > ps["prefill_calls"]
        if case == "preempt":
            m = eng.obs.metrics
            assert ps["preemptions"] >= 1, "the case must really preempt"
            assert m.counter("serve.spills").value >= 1
            assert m.counter("serve.restores").value >= 1


def test_kernel_dispatch_counters_pinned():
    """The reference pins its dispatch counts on this workload (prompts of
    5 and 3 tokens: prefill chunks [4+3] then [1], then 4 batched decode
    steps); the port counts the same dispatches on the fused path."""
    cfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(),
                              dtype="float32")
    params = M.init_model(cfg, torch.Generator().manual_seed(0))
    serve = HyperServe(cfg, params, device="cpu", serve_cfg=ServeConfig(
        block_size=4, num_blocks=40, max_blocks_per_req=8, max_slots=2,
        prefill_chunk=4))
    assert serve.engine.kernel_path == "fused"
    _serve(serve, [[1, 2, 3, 4, 5], [7, 8, 9]], [4, 3])
    m = serve.engine.obs.metrics
    assert m.counter("serve.kernels.decode.fused").value == 4
    assert m.counter("serve.kernels.prefill.fused").value == 2
    assert m.counter("serve.kernels.decode.composed").value == 0


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "llama3-8b"])
def test_composed_serve_matches_reference_and_generator(arch):
    """``kernels="composed"`` (gather the tables, then the dense
    ``decode_attention``/``flash_attention``): greedy tokens identical to
    the JAX ``HyperServe(kernels="composed")`` and to the JAX and port
    ``Generator``s, through preemption, with every dispatch counted on
    the composed path and none on the fused one."""
    kw, prompts, max_new = CASES["preempt"]
    jcfg, cfg, jp, tp = _models(arch)
    ref = JaxHyperServe(jcfg, jp, serve_cfg=JaxServeConfig(kernels="composed",
                                                           **kw))
    want = _serve(ref, prompts, max_new)
    gen = _generator(arch)
    want_gen = [gen.generate(jnp.asarray(p, jnp.int32)[None, :],
                             GenerateConfig(max_new_tokens=n))[0, len(p):]
                .tolist() for p, n in zip(prompts, max_new)]
    port_gen = PortGenerator(cfg, tp, max_len=128, device="cpu")
    got_gen = [port_gen.generate(torch.tensor([p]), PortGenerateConfig(
        max_new_tokens=n))[0, len(p):].tolist()
        for p, n in zip(prompts, max_new)]
    port = HyperServe(cfg, tp, serve_cfg=ServeConfig(kernels="composed",
                                                     **kw), device="cpu")
    got = _serve(port, prompts, max_new)
    assert got == want == want_gen == got_gen
    assert port.stats()["preemptions"] == ref.stats()["preemptions"] >= 1
    m, rm = port.engine.obs.metrics, ref.engine.obs.metrics
    for stage in ("decode", "prefill"):
        n = m.counter(f"serve.kernels.{stage}.composed").value
        assert n >= 1
        assert n == rm.counter(f"serve.kernels.{stage}.composed").value
        assert m.counter(f"serve.kernels.{stage}.fused").value == 0
    assert n == port.engine.prefill_calls


def test_seeded_sampling_replays_within_the_port():
    """Temperature sampling draws from a generator seeded by (request
    seed, position): two runs give the same tokens, and so does a run
    that preempts, spills and restores on a tight pool."""
    cfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(),
                              dtype="float32")
    params = M.init_model(cfg, torch.Generator().manual_seed(0))
    kw, prompts, max_new = CASES["preempt"]
    ample = dict(kw, num_blocks=40)
    runs = []
    for skw in (ample, ample, kw):
        serve = HyperServe(cfg, params, serve_cfg=ServeConfig(**skw),
                           device="cpu")
        rids = [serve.submit(p, n, temperature=0.9, seed=11 + i,
                             capture_logprobs=True)
                for i, (p, n) in enumerate(zip(prompts, max_new))]
        out = serve.join()
        runs.append(([out[r] for r in rids],
                     [serve.engine.scheduler.requests[r].logprobs
                      for r in rids], serve.stats()["preemptions"]))
    (t0, lp0, _), (t1, lp1, _), (t2, lp2, pre) = runs
    assert t0 == t1 == t2
    assert lp0 == lp1
    assert np.allclose(np.concatenate(lp0), np.concatenate(lp2), atol=1e-5)
    assert pre >= 1
    # sampling really happened: not the greedy stream
    greedy = HyperServe(cfg, params, serve_cfg=ServeConfig(**ample),
                        device="cpu")
    assert _serve(greedy, prompts, max_new) != t0


def test_cancel_and_admission_control():
    """Cancelling returns a request's blocks and seat; an unservable or
    over-queue submit raises the typed RequestRejected."""
    cfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(),
                              dtype="float32")
    params = M.init_model(cfg, torch.Generator().manual_seed(0))
    serve = HyperServe(cfg, params, device="cpu", serve_cfg=ServeConfig(
        block_size=4, num_blocks=16, max_blocks_per_req=4, max_slots=1,
        prefill_chunk=4, max_queue=1))
    free0 = serve.stats()["free_blocks"]
    a = serve.submit(list(range(1, 6)), 4)
    serve.step_once()                       # a is seated and prefilling
    b = serve.submit(list(range(1, 4)), 2)  # b waits in the queue
    with pytest.raises(RequestRejected) as e:
        serve.submit([1, 2], 2)             # queue full
    assert e.value.reason == "queue_full" and e.value.retry_after_s
    with pytest.raises(RequestRejected) as e:
        serve.submit(list(range(20)), 4)    # can never fit the table
    assert e.value.reason == "unservable" and e.value.retry_after_s is None
    assert serve.cancel(a) and serve.state(a) == "cancelled"
    assert not serve.cancel(a)
    assert serve.result(b) == [] and len(serve.join()[b]) == 2
    assert serve.stats()["free_blocks"] == free0 - serve.stats()[
        "prefix_cache_blocks"]


def test_typed_errors_name_what_is_missing():
    cfg = get_config("qwen2-0.5b").reduced()
    params = M.init_model(cfg, torch.Generator().manual_seed(0))
    budgets = HyperServe(cfg, params, device="cpu", serve_cfg=ServeConfig(
        archive_host_bytes=1 << 20, archive_disk_bytes=1 << 24))
    tiers = budgets.engine.blocks.archive._tiers
    assert (tiers.host_bytes, tiers.disk_bytes) == (1 << 20, 1 << 24)
    assert budgets.stats()["archive_evict_host"] == 0
    for knob in ("archive_host_bytes", "archive_disk_bytes"):
        with pytest.raises(ServePlanError, match=knob):
            HyperServe(cfg, params, device="cpu",
                       serve_cfg=ServeConfig(**{knob: -1}))
    assert HyperServe(cfg, params, device="cpu", serve_cfg=ServeConfig(
        kernels="composed")).engine.kernel_path == "composed"
    with pytest.raises(ServePlanError, match="num_blocks"):
        HyperServe(cfg, params, device="cpu",
                   serve_cfg=ServeConfig(num_blocks=1))
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("musicgen-large-v2")


def test_ported_and_not_yet_ported_archs():
    """Every arch of the reference is ported (the four dense GQA configs,
    the three MoE configs, mamba2-370m, the hybrid recurrentgemma-2b and
    the two with a multimodal prefix, internvl2-26b and musicgen-large),
    each a copy of the reference's config, full and reduced."""
    from repro.configs.base import list_archs as jax_list_archs
    assert list_archs() == ("deepseek-moe-16b", "deepseek-v2-lite-16b",
                            "granite-3-2b", "internvl2-26b", "llama3-8b",
                            "mamba2-370m", "moonshot-v1-16b-a3b",
                            "musicgen-large", "phi4-mini-3.8b",
                            "qwen2-0.5b", "recurrentgemma-2b")
    assert list_archs() == tuple(sorted(jax_list_archs()))
    for name in list_archs():      # the copies hold the reference's values
        assert (dataclasses.asdict(get_config(name).reduced())
                == dataclasses.asdict(jax_get_config(name).reduced()))
        assert (dataclasses.asdict(get_config(name))
                == dataclasses.asdict(jax_get_config(name)))
