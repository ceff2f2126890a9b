"""The port's 1F1B pipeline trainer against the reference's, on the CPU.

The schedule, the partitioner and the config check are host arithmetic:
each (S, M) of a grid and each arch's split give the reference's op
labels, ticks, spans, bubbles, windows and digests, and the reference's
error texts word for word.  The trainer runs colocated (one process, as
the JAX side's one CPU device runs it) on reduced configs in float32 from
the reference's ``init_model`` at seed 0, bridged: qwen2-0.5b (tied
embeddings) at S = 2, M = 2 against the JAX ``train_pipeline`` (history
within 1e-4 relative, params within AdamW's bound, the pipeline counters
and the compile key equal) and against the port's own non-pipelined
``train`` (1e-5 relative); deepseek-v2-lite (MLA, gshard MoE, untied) at
S = 2 against the JAX side, the aux terms entering per micro-batch; a
4-layer qwen2 at S = 3 (explicit (2, 1, 1) against the even split, the
same cut: bit for bit); sequential dispatch and HyperOffload against
1F1B (bit for bit); the refusals.  The JAX trainer's compile is most of
this file's time, so each arch's runs are shared by a module fixture.
"""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from repro.api import plans as jax_plans  # noqa: E402
from repro.api.errors import PipelinePlanError as JaxPipelineError  # noqa: E402
from repro.configs.base import PipelineConfig as JaxPipelineConfig  # noqa: E402
from repro.configs.base import ShapeConfig as JaxShapeConfig  # noqa: E402
from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.core import pipeline as jax_pipe  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.obs import Observability as JaxObservability  # noqa: E402
from repro.train import pipeline_trainer as jax_pt  # noqa: E402
from repro.train.trainer import TrainConfig as JaxTrainConfig  # noqa: E402
from repro_torch.api.errors import PipelinePlanError  # noqa: E402
from repro_torch.configs.base import (PipelineConfig, ShapeConfig,  # noqa: E402
                                      get_config)
from repro_torch.core import mpmd, pipeline as pipe  # noqa: E402
from repro_torch.core.offload import OffloadConfig  # noqa: E402
from repro_torch.core.tree import tree_flatten_with_path  # noqa: E402
from repro_torch.data.pipeline import DataConfig, make_loader  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402
from repro_torch.obs import Observability  # noqa: E402
from repro_torch.optim import adamw as opt  # noqa: E402
from repro_torch.train import pipeline_trainer as pt  # noqa: E402
from repro_torch.train import steps  # noqa: E402
from repro_torch.train import trainer  # noqa: E402

STEPS = 2
SHAPE = (32, 4)                       # seq_len, global batch
PIPE = dict(stages=2, micro_batches=2)
COUNTERS = ("bubble_steps", "handoffs", "microbatches", "tied_embed_syncs")
GRID = [(s, m) for s in (1, 2, 3, 4) for m in (1, 2, 4, 8)]


def _cfgs(arch, **extra):
    extra = dict(dtype="float32", **extra)
    return (dataclasses.replace(jax_get_config(arch).reduced(), **extra),
            dataclasses.replace(get_config(arch).reduced(), **extra))


def _flat(tree):
    return {k: v.detach().numpy() for k, v in tree_flatten_with_path(tree)}


def _jax_flat(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in kp): np.asarray(v) for kp, v in flat}


def _bridged(jcfg):
    return params_from_numpy(jax.tree.map(np.asarray, JM.init_model(
        jcfg, jax.random.PRNGKey(0))), "cpu")


def _drawn(mp, params):
    """Under ``mp``, ``steps.init_state`` (the trainers' draw) returns
    ``params``."""
    mp.setattr(steps, "init_state",
               lambda *a, **k: (params, opt.init_adamw(params)))


def _port(cfg, params, **kw):
    """(merged params as numpy, history, obs) of the port's pipeline
    started from ``params``."""
    obs = Observability()
    kw.setdefault("pipeline", PipelineConfig(**PIPE))
    with pytest.MonkeyPatch.context() as mp:
        _drawn(mp, params)
        merged, hist = pt.train_pipeline(
            cfg, ShapeConfig("t", *SHAPE, "train"),
            train_cfg=trainer.TrainConfig(num_steps=STEPS, log_every=1),
            obs=obs, device="cpu", **kw)
    return _flat(merged), hist, obs


def _port_sequential(cfg, params):
    """:func:`_port`'s run with each step in the no-overlap order:
    ``PipelineTrainer.step(batch, dispatch="sequential")`` over the batches
    ``train_pipeline`` reads.  Returns (merged params as numpy, the
    history's values but ``step`` and ``wall_s``, obs)."""
    obs = Observability()
    with pytest.MonkeyPatch.context() as mp:
        _drawn(mp, params)
        tr = pt.PipelineTrainer(cfg, PipelineConfig(**PIPE), obs=obs,
                                adamw=opt.AdamWConfig(total_steps=STEPS),
                                device="cpu")
    loader = make_loader(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=SHAPE[0], global_batch=SHAPE[1],
                                    seed=0), "cpu")
    hist = [{k: float(v) for k, v in tr.step(
        batch, dispatch="sequential").items() if not isinstance(v, tuple)}
        for _, batch in zip(range(STEPS), loader)]
    return _flat(tr.merged_params()), hist, obs


def _counters(obs):
    return {k: obs.metrics.counter(f"train.pipeline.{k}").value
            for k in COUNTERS}


def params_bound(ref) -> float:
    """AdamW's bound on two runs whose gradients differ only in rounding:
    sum_t 2 lr_t bound_t (``adam_step_bound`` of chip_smoke.py) plus an
    f32 rounding of the largest weight a step."""
    acfg = opt.AdamWConfig(total_steps=STEPS)
    lrs = [float(opt.schedule(acfg, torch.tensor(t, dtype=torch.int32)))
           for t in range(1, STEPS + 1)]
    b1, b2 = acfg.b1, acfg.b2
    step_bound = [((1 - b1) / (1 - b1 ** t)
                   * sum((b1 * b1 / b2) ** j for j in range(t)) ** 0.5
                   * ((1 - b2 ** t) / (1 - b2)) ** 0.5)
                  for t in range(1, STEPS + 1)]
    big = max(float(np.abs(v).max()) for v in ref.values())
    return (sum(2 * lr * b for lr, b in zip(lrs, step_bound))
            + 2 * STEPS * big * 2.0 ** -23)


@pytest.fixture(scope="module")
def runs():
    """Per arch: the JAX ``train_pipeline`` (params, history, obs) and the
    port's from the same params; for qwen2 also the port's non-pipelined
    ``train``."""
    out = {}
    for arch in ("qwen2-0.5b", "deepseek-v2-lite-16b"):
        jcfg, cfg = _cfgs(arch)
        jobs = JaxObservability()
        jparams, jhist = jax_pt.train_pipeline(
            jcfg, JaxShapeConfig("t", *SHAPE, "train"),
            plan=jax_plans.pipeline(**PIPE),
            train_cfg=JaxTrainConfig(num_steps=STEPS, log_every=1), obs=jobs)
        port = _port(cfg, _bridged(jcfg))
        out[arch] = dict(jax=(_jax_flat(jparams), jhist, jobs), port=port)
    jcfg, cfg = _cfgs("qwen2-0.5b")
    with pytest.MonkeyPatch.context() as mp:
        _drawn(mp, _bridged(jcfg))
        plain, phist = trainer.train(
            cfg, ShapeConfig("t", *SHAPE, "train"),
            train_cfg=trainer.TrainConfig(num_steps=STEPS, log_every=1),
            device="cpu")
    out["plain"] = (_flat(plain), phist)
    return out


# ---------------------------------------------------------------------------
# host arithmetic
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("s,m", GRID)
def test_schedule_and_dispatch_are_the_reference(s, m):
    """``schedule_1f1b`` and ``sequential_dispatch`` at (S, M): the same
    ops (kind, micro, stage, tick) in the same order, labels, span, bubble
    count (= ``pipeline_bubble_steps``), stage windows and phases, and
    the same digests."""
    got, want = pipe.schedule_1f1b(s, m), jax_pipe.schedule_1f1b(s, m)
    assert [dataclasses.astuple(o) for o in got.ops] == \
        [dataclasses.astuple(o) for o in want.ops]
    assert got.dispatch_labels() == want.dispatch_labels()
    assert (got.span, got.bubble_steps, got.stage_windows) == \
        (want.span, want.bubble_steps, want.stage_windows)
    assert got.bubble_steps == mpmd.pipeline_bubble_steps(s, m)
    assert [got.stage_phases(i) for i in range(s)] == \
        [want.stage_phases(i) for i in range(s)]
    seq, jseq = pipe.sequential_dispatch(s, m), \
        jax_pipe.sequential_dispatch(s, m)
    assert [dataclasses.astuple(o) for o in seq] == \
        [dataclasses.astuple(o) for o in jseq]
    for labels in (got.dispatch_labels(), [o.label() for o in seq]):
        assert pipe.dispatch_digest(labels) == \
            jax_pipe.dispatch_digest(labels)


def _same_outcome(fn, jfn):
    """The port's call and the reference's: equal results, or the same
    PipelinePlanError text."""
    try:
        want = jfn()
    except JaxPipelineError as e:
        with pytest.raises(PipelinePlanError) as got:
            fn()
        assert str(got.value) == str(e)
        return None
    return fn(), want


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "deepseek-v2-lite-16b",
                                  "recurrentgemma-2b"])
def test_partition_stages_is_the_reference(arch):
    """Full-size configs (qwen2's 24 layers; deepseek's dense first layer
    and 26 MoE layers, two segments; recurrentgemma's 8 pattern repeats
    and a tail segment): every stage count from 1 to one past the
    macro-layers (the last is a stage-overclaim), and explicit counts
    (right, too many, too few, an empty stage, a wrong length) give the
    reference's assignments or its error text; ``num_macro_layers`` and
    ``even_stage_layers`` agree."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    n = pipe.num_macro_layers(cfg)
    assert n == jax_pipe.num_macro_layers(jcfg)
    cases = [(s, ()) for s in range(0, n + 2)]
    even3 = pipe.even_stage_layers(n, 3)
    assert even3 == jax_pipe.even_stage_layers(n, 3)
    cases += [(3, even3), (3, (n - 2, 1, 1)), (3, (n, 1, 1)),
              (3, (1, 1, 1)), (3, (n - 1, 1, 0)), (2, (n - 1, 1, 0))]
    for s, counts in cases:
        out = _same_outcome(
            lambda: pipe.partition_stages(cfg, s, counts),
            lambda: jax_pipe.partition_stages(jcfg, s, counts))
        if out is not None:
            got, want = out
            assert [dataclasses.astuple(a) for a in got] == \
                [dataclasses.astuple(a) for a in want], (s, counts)
            assert [(a.first, a.last) for a in got] == \
                [(a.first, a.last) for a in want]


@pytest.mark.parametrize("kw", [
    dict(), dict(stages=0), dict(micro_batches=0),
    dict(stages=2, stage_layers=(1, 1, 1)), dict(stage_layers=(1, 0)),
    dict(stage_mesh=(2,)), dict(stage_mesh=(0, 2)),
    dict(stages=0, micro_batches=0, stage_mesh=(1, 2, 3))])
def test_pipeline_config_validate_is_the_reference(kw):
    """``PipelineConfig.validate``: the same fields, and the same
    PipelinePlanError text for every malformed knob."""
    out = _same_outcome(lambda: PipelineConfig(**kw).validate(),
                        lambda: JaxPipelineConfig(**kw).validate())
    if out is not None:
        assert dataclasses.astuple(out[0]) == dataclasses.astuple(out[1])
        assert dataclasses.astuple(PipelineConfig(**kw).replace(
            stages=5)) == dataclasses.astuple(JaxPipelineConfig(**kw)
                                              .replace(stages=5))


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "deepseek-v2-lite-16b"])
def test_stage_param_tree_owns_contiguous_copies(arch):
    """Each stage's tree has the reference's leaves and shapes (the first
    the embedding, the last the final norm and the readout: under tied
    embeddings a copy of ``embed``), each leaf a contiguous copy of its
    slice sharing no storage with the full tree, equal to it."""
    jcfg, cfg = _cfgs(arch, num_layers=4)
    full = M.init_model(cfg, torch.Generator().manual_seed(0))
    # the reference's slicing is jax.tree.map over the tree it is given:
    # the same tree as numpy arrays
    jfull = jax.tree.map(lambda t: t.numpy(), full)
    ptrs = {t.untyped_storage().data_ptr() for _, t in
            tree_flatten_with_path(full)}
    for asn, jasn in zip(pipe.partition_stages(cfg, 3),
                         jax_pipe.partition_stages(jcfg, 3)):
        got = _flat(pipe.stage_param_tree(full, cfg, asn))
        want = _jax_flat(jax_pipe.stage_param_tree(jfull, jcfg, jasn))
        assert sorted(got) == sorted(want)
        for k, v in tree_flatten_with_path(
                pipe.stage_param_tree(full, cfg, asn)):
            assert v.is_contiguous()
            assert v.untyped_storage().data_ptr() not in ptrs
            assert np.array_equal(got[k], want[k]), k
        assert ("embed" in got) == (asn.first or cfg.tie_embeddings
                                    and asn.last)


# ---------------------------------------------------------------------------
# the trainer against the reference and the non-pipelined trainer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "deepseek-v2-lite-16b"])
def test_pipeline_matches_the_jax_trainer(runs, arch):
    """S = 2, M = 2, two steps from the same params: loss, its parts, the
    MoE terms (per micro-batch, times 1/M), grad norm and lr within 1e-4
    relative at every step; every merged param within AdamW's bound of the
    JAX side's; the pipeline counters (bubble steps, hand-offs, micro-
    batches, tied-embedding syncs) and the ``pipeline_step`` compile key
    equal to the JAX ``Observability``'s exactly."""
    jparams, jhist, jobs = runs[arch]["jax"]
    got, hist, obs = runs[arch]["port"]
    assert len(hist) == len(jhist) == STEPS
    for a, b in zip(hist, jhist):
        for k in ("loss", "ce", "aux", "moe_aux_loss", "moe_z_loss",
                  "grad_norm", "lr", "handoffs"):
            assert abs(a[k] - b[k]) <= 1e-4 * max(1.0, abs(b[k])), (k, a, b)
    if arch == "deepseek-v2-lite-16b":
        assert all(h["aux"] > 0 and h["moe_aux_loss"] > 0 for h in hist)
    assert sorted(got) == sorted(jparams)
    bound = params_bound(jparams)
    for k, v in jparams.items():
        assert np.abs(got[k] - v).max() <= bound, k
    assert _counters(obs) == {
        k: jobs.metrics.counter(f"train.pipeline.{k}").value
        for k in COUNTERS}
    assert obs.compiled_keys("pipeline_step") == \
        jobs.compiled_keys("pipeline_step") == \
        [(2, 2, get_config(arch).name, "gshard")]


def test_pipeline_matches_the_non_pipelined_trainer(runs):
    """The port's pipeline (S = 2, M = 2) against the port's own
    ``trainer.train`` on the same params and batches: loss and grad norm
    within 1e-5 relative at every step, params within AdamW's bound."""
    got, hist, _ = runs["qwen2-0.5b"]["port"]
    plain, phist = runs["plain"]
    for a, b in zip(hist, phist):
        for k in ("loss", "ce", "grad_norm", "lr"):
            assert abs(a[k] - b[k]) <= 1e-5 * max(1.0, abs(b[k])), (k, a, b)
    bound = params_bound(plain)
    for k, v in plain.items():
        assert np.abs(got[k] - v).max() <= bound, k


def test_sequential_dispatch_and_offload_equal_1f1b(runs):
    """The same steps in the no-overlap per-micro order, and with params
    and optimizer state offloaded between steps: the history and every
    merged param bit for bit the 1F1B run's; the sequential run counts no
    bubble steps, the same hand-offs and micro-batches."""
    jcfg, cfg = _cfgs("qwen2-0.5b")
    got, hist, obs = runs["qwen2-0.5b"]["port"]
    for sequential in (True, False):
        other, ohist, oobs = (
            _port_sequential(cfg, _bridged(jcfg)) if sequential else
            _port(cfg, _bridged(jcfg), offload_cfg=OffloadConfig(
                params_on_host=True, opt_state_on_host=True)))
        assert [{k: v for k, v in h.items() if k not in ("step", "wall_s")}
                for h in ohist] == \
            [{k: v for k, v in h.items() if k not in ("step", "wall_s")}
             for h in hist]
        assert sorted(other) == sorted(got)
        for k, v in got.items():
            assert np.array_equal(other[k], v), (sequential, k)
        want = _counters(obs)
        if sequential:
            want["bubble_steps"] = 0
        assert _counters(oobs) == want


def test_explicit_split_equals_the_even_split():
    """A 4-layer qwen2 at S = 3: ``stage_layers=(2, 1, 1)`` is the even
    split's cut, and gives the even run's history and params bit for bit
    (stage 1 owns neither the embedding nor the readout; the tied copy
    syncs every step)."""
    jcfg, cfg = _cfgs("qwen2-0.5b", num_layers=4)
    assert [a.layers for a in pipe.partition_stages(cfg, 3)] == \
        [(0, 1), (2,), (3,)]
    out = [_port(cfg, _bridged(jcfg), pipeline=PipelineConfig(
        stages=3, micro_batches=2, stage_layers=sl)) for sl in ((),
                                                                (2, 1, 1))]
    (even, ehist, eobs), (expl, xhist, xobs) = out
    assert [h["loss"] for h in ehist] == [h["loss"] for h in xhist]
    assert [h["grad_norm"] for h in ehist] == [h["grad_norm"]
                                               for h in xhist]
    for k, v in even.items():
        assert np.array_equal(expl[k], v), k
    assert _counters(eobs) == _counters(xobs) == {
        "bubble_steps": STEPS * 12, "handoffs": STEPS * 8,
        "microbatches": STEPS * 2, "tied_embed_syncs": STEPS}


def test_step_returns_the_reference_dict():
    """One ``PipelineTrainer.step``: the reference's keys, the dispatch
    labels of 1F1B (and of the sequential order), the hand-off count."""
    _, cfg = _cfgs("qwen2-0.5b")
    tr = pt.PipelineTrainer(cfg, PipelineConfig(**PIPE), device="cpu")
    rng = np.random.default_rng(3)
    batch = {"inputs": torch.from_numpy(rng.integers(
        3, cfg.vocab_size, (4, 16)).astype(np.int32))}
    batch["targets"] = torch.roll(batch["inputs"], -1, 1)
    batch["mask"] = torch.ones(4, 16)
    out = tr.step(batch)
    assert set(out) == {"loss", "ce", "aux", "moe_aux_loss", "moe_z_loss",
                        "grad_norm", "lr", "handoffs", "dispatch"}
    assert out["dispatch"] == jax_pipe.schedule_1f1b(2, 2).dispatch_labels()
    assert out["handoffs"] == 4 and out["aux"] == 0.0
    seq = tr.step(batch, dispatch="sequential")["dispatch"]
    assert list(seq) == [o.label() for o in
                         jax_pipe.sequential_dispatch(2, 2)]


def test_refusals_are_the_reference():
    """A multimodal frontend, a batch the micro count does not divide,
    and more stages than macro-layers: the reference's PipelinePlanError
    texts, word for word."""
    cases = []
    jmg, mg = _cfgs("musicgen-large")
    cases.append((lambda: pt.PipelineTrainer(mg, device="cpu"),
                  lambda: jax_pt.PipelineTrainer(jmg, jax_plans.pipeline())))
    jcfg, cfg = _cfgs("qwen2-0.5b")
    cases.append((lambda: pt.PipelineTrainer(
        cfg, PipelineConfig(stages=3), device="cpu"),
        lambda: jax_pt.PipelineTrainer(jcfg, jax_plans.pipeline(stages=3))))
    batch = {"inputs": np.zeros((4, 8), np.int32),
             "targets": np.zeros((4, 8), np.int32),
             "mask": np.ones((4, 8), np.float32)}
    cases.append((lambda: pt.PipelineTrainer(
        cfg, PipelineConfig(micro_batches=3), device="cpu").step(
            {k: torch.from_numpy(v) for k, v in batch.items()}),
        lambda: jax_pt.PipelineTrainer(
            jcfg, jax_plans.pipeline(micro_batches=3)).step(batch)))
    for fn, jfn in cases:
        assert _same_outcome(fn, jfn) is None
