"""The port's train step against the reference's, on the CPU.

The same inputs, made with numpy from a seed, go through the JAX package
and the port in float32 on reduced configs (``.reduced()``: 2 layers,
d_model 256): qwen2-0.5b (4 heads over 2 kv heads of 64) for the cross
entropy, AdamW from one state (bridged with ``adamw_state_from_numpy``),
the packed synthetic loader, the flash backward (the port's autograd
Function on the CPU runs the plain forward with its lse and
``flash_attention_bwd_ref``) against autograd and ``jax.grad`` of the
reference's oracle, and the checkpoints in both directions; ``loss_fn``
and its gradient leaf by leaf, and five train steps, on each of
:data:`TRAIN_ARCHS`: qwen2-0.5b, deepseek-v2-lite-16b (MLA at (Dk, Dv) =
(96, 64), MoE under the reference's default gshard dispatch),
deepseek-moe-16b, musicgen-large and internvl2-26b with a seeded
multimodal prefix (through ``make_train_step(multimodal=True)``, since
neither trainer makes a prefix), mamba2-370m (the SSD scan's backward) and
recurrentgemma-2b (the RG-LRU scan's, cut to its first three layers with a
window of 8, so that the windowed flash backward runs too); and the typed
refusals of what one
device does not train (a mesh, a plan, a head-dim pair or a ``q_offset``
the backward does not take), and a MoE step under the ragged dispatch,
which trains through the grouped matmul's backward.

Tolerances, float32 throughout: CE and AdamW 1e-6 (the same f32
arithmetic in the same order; values of order 1); the flash gradients
2e-5 (sums over keys and heads in another order); ``loss_fn`` 1e-5 and
its gradient 1e-5 x max(1, max |grad|) per leaf (matmuls, softmax and
norms summed in another order over two layers); the train history 1e-4
relative over five steps (the same differences carried through AdamW,
whose first steps move a weight by about lr whatever the gradient's
size).  The JAX trainer's compile is most of this file's time, so each
arch's run is shared by a module-scoped fixture.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from repro.ckpt import checkpoint as jax_ckpt  # noqa: E402
from repro.configs.base import ShapeConfig as JaxShapeConfig  # noqa: E402
from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.data import pipeline as jax_pipeline  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.obs import Observability as JaxObservability  # noqa: E402
from repro.optim import adamw as jax_opt  # noqa: E402
from repro.train import steps as jax_steps  # noqa: E402
from repro.train import trainer as jax_trainer  # noqa: E402
from repro_torch.api.errors import PlanError  # noqa: E402
from repro_torch.ckpt import checkpoint  # noqa: E402
from repro_torch.configs.base import ShapeConfig, get_config  # noqa: E402
from repro_torch.core.tree import tree_flatten_with_path  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models.bridge import (adamw_state_from_numpy,  # noqa: E402
                                       params_from_numpy)
from repro_torch.obs import Observability  # noqa: E402
from repro_torch.optim import adamw as opt  # noqa: E402
from repro_torch.train import steps  # noqa: E402
from repro_torch.train import trainer  # noqa: E402

TRAIN_STEPS = 5
SHAPE = (32, 2)                       # seq_len, global batch
# the dense GQA main path, MLA at (Dk, Dv) = (96, 64) with MoE, GQA with
# MoE, the two archs with a multimodal prefix, and the two recurrent archs
# (the SSD scan's and the RG-LRU scan's backward)
TRAIN_ARCHS = ("qwen2-0.5b", "deepseek-v2-lite-16b", "deepseek-moe-16b",
               "musicgen-large", "internvl2-26b", "mamba2-370m",
               "recurrentgemma-2b")
# recurrentgemma-2b's .reduced() keeps 2 layers, both RG-LRU: a third, its
# LOCAL_ATTN, and a window of 8 (below the sequences here) make the
# windowed flash backward part of its step
REDUCED_EXTRA = {"recurrentgemma-2b": dict(num_layers=3, sliding_window=8)}


def _cfgs(arch="qwen2-0.5b"):
    extra = dict(dtype="float32", **REDUCED_EXTRA.get(arch, {}))
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(), **extra)
    cfg = dataclasses.replace(get_config(arch).reduced(), **extra)
    return jcfg, cfg


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree):
    """{path: f32 numpy array} of a port tree, JAX's spelling."""
    return {k: (v.detach().cpu().float().numpy() if torch.is_tensor(v)
                else np.asarray(v)) for k, v in tree_flatten_with_path(tree)}


def _jax_flat(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in kp): np.asarray(v) for kp, v in flat}


def _batch(cfg, seed, B=2, S=16):
    rng = np.random.default_rng(seed)
    inputs = rng.integers(3, cfg.vocab_size, size=(B, S)).astype(np.int32)
    targets = rng.integers(3, cfg.vocab_size, size=(B, S)).astype(np.int32)
    mask = (rng.random((B, S)) > 0.2).astype(np.float32)
    return {"inputs": inputs, "targets": targets, "mask": mask}


@pytest.mark.parametrize("vocab", [16, 11])
def test_cross_entropy_matches_reference(vocab):
    """Unpadded (V_pad = vocab) and padded vocab, with a loss mask."""
    rng = np.random.default_rng(0)
    logits = (3 * rng.standard_normal((2, 8, 16))).astype(np.float32)
    targets = rng.integers(0, vocab, size=(2, 8)).astype(np.int32)
    mask = (rng.random((2, 8)) > 0.3).astype(np.float32)
    j = [jax_steps.cross_entropy_parts(jnp.asarray(logits),
                                       jnp.asarray(targets),
                                       jnp.asarray(mask), vocab),
         (jax_steps.cross_entropy(jnp.asarray(logits), jnp.asarray(targets),
                                  jnp.asarray(mask), vocab),)]
    t = [steps.cross_entropy_parts(torch.from_numpy(logits),
                                   torch.from_numpy(targets),
                                   torch.from_numpy(mask), vocab),
         (steps.cross_entropy(torch.from_numpy(logits),
                              torch.from_numpy(targets),
                              torch.from_numpy(mask), vocab),)]
    for a, b in zip(sum(map(tuple, j), ()), sum(map(tuple, t), ())):
        assert abs(float(a) - float(b)) <= 1e-6 * max(1.0, abs(float(a)))


def _opt_case(clip_active):
    """A small param tree with a stacked (L, d) norm leaf, a 1-D leaf and
    matrices, grads from a seed, and a state one update in."""
    rng = np.random.default_rng(3)
    params = {"embed": rng.standard_normal((6, 4)).astype(np.float32),
              "final_norm": rng.standard_normal((4,)).astype(np.float32),
              "seg0": ({"norm1": rng.standard_normal((2, 4))
                        .astype(np.float32),
                        "w": rng.standard_normal((2, 4, 3))
                        .astype(np.float32)},)}
    scale = 10.0 if clip_active else 0.01
    grads = [jax.tree.map(lambda x, i=i: (scale * np.random.default_rng(i)
                                          .standard_normal(x.shape))
                          .astype(np.float32), params) for i in (4, 5)]
    return params, grads


@pytest.mark.parametrize("clip_active", [True, False])
def test_adamw_update_matches_reference(clip_active):
    """From one state (bridged): new params, moments, count, grad norm and
    lr; the stacked (L, d) norm leaf is decayed as a >= 2-dim leaf."""
    params, (g0, g1) = _opt_case(clip_active)
    cfg = jax_opt.AdamWConfig(lr=1e-2, warmup_steps=3, total_steps=10)
    tcfg = opt.AdamWConfig(lr=1e-2, warmup_steps=3, total_steps=10)
    jp = jax.tree.map(jnp.asarray, params)
    js = jax_opt.init_adamw(jp)
    jp, js, _ = jax_opt.adamw_update(jax.tree.map(jnp.asarray, g0), js, jp,
                                     cfg)
    tp = params_from_numpy(_np_tree(jp), "cpu")
    ts = adamw_state_from_numpy(_np_tree(js), "cpu")
    jp2, js2, jm = jax_opt.adamw_update(jax.tree.map(jnp.asarray, g1), js,
                                        jp, cfg)
    tp2, ts2, tm = opt.adamw_update(params_from_numpy(g1, "cpu"), ts, tp,
                                    tcfg)
    assert (float(jm["grad_norm"]) > 1.0) == clip_active
    for name in ("grad_norm", "lr"):
        assert abs(float(jm[name]) - float(tm[name])) <= \
            1e-6 * max(1.0, float(jm[name]))
    assert int(ts2.count) == int(js2.count) == 2
    assert ts2.count.dtype == torch.int32
    for jt, tt in ((jp2, tp2), (js2.mu, ts2.mu), (js2.nu, ts2.nu)):
        want, got = _jax_flat(jt), _flat(tt)
        assert sorted(want) == sorted(got)
        for k in want:
            assert np.max(np.abs(want[k] - got[k])) <= 1e-6, k
    # the norm stack decays: with zero grads its update is -lr * wd * p
    # (Adam's step vanishes), the 1-D final_norm's is 0
    zeros = {k: np.zeros_like(v) if not isinstance(v, tuple) else
             ({kk: np.zeros_like(vv) for kk, vv in v[0].items()},)
             for k, v in params.items()}
    fresh = opt.init_adamw(params_from_numpy(params, "cpu"))
    out, _, m = opt.adamw_update(params_from_numpy(zeros, "cpu"), fresh,
                                 params_from_numpy(params, "cpu"), tcfg)
    lr = float(m["lr"])
    norm = torch.from_numpy(params["seg0"][0]["norm1"])
    assert torch.allclose(out["seg0"][0]["norm1"], norm - lr * 0.1 * norm,
                          atol=1e-7)
    assert torch.equal(out["final_norm"],
                       torch.from_numpy(params["final_norm"]))


def test_schedule_matches_reference():
    """Steps 0, 1, the end of warmup, mid-decay and the end."""
    jcfg = jax_opt.AdamWConfig(lr=3e-4, warmup_steps=10, total_steps=50)
    tcfg = opt.AdamWConfig(lr=3e-4, warmup_steps=10, total_steps=50)
    for step in (0, 1, 10, 30, 50):
        want = float(jax_opt.schedule(jcfg, jnp.int32(step)))
        got = float(opt.schedule(tcfg, torch.tensor(step, dtype=torch.int32)))
        assert abs(want - got) <= 1e-6 * max(want, 1e-12), step


@pytest.mark.parametrize("seed", [0, 1])
def test_packed_batches_match_reference(seed):
    """Bit-identical token stream, targets and mask; the loader hands the
    same arrays over as int32/f32 tensors on the device."""
    for vocab, S, B in ((151936, 64, 4), (50, 33, 3)):
        jit = jax_pipeline.PackedBatches(jax_pipeline.DataConfig(
            vocab_size=vocab, seq_len=S, global_batch=B, seed=seed))
        dcfg = pipeline.DataConfig(vocab_size=vocab, seq_len=S,
                                   global_batch=B, seed=seed)
        tit = pipeline.PackedBatches(dcfg)
        loader = pipeline.make_loader(dcfg, "cpu")
        for _ in range(3):
            want, got, dev = next(jit), next(tit), next(loader)
            for k in ("inputs", "targets", "mask"):
                np.testing.assert_array_equal(want[k], got[k])
                assert want[k].dtype == got[k].dtype
                np.testing.assert_array_equal(want[k], dev[k].numpy())
    assert (pipeline.BOS, pipeline.EOS, pipeline.PAD) == (
        jax_pipeline.BOS, jax_pipeline.EOS, jax_pipeline.PAD)


def _max_rel(a, b):
    return float(np.max(np.abs(a - b))) / max(1.0, float(np.max(np.abs(a))))


def _prefix(cfg, seed, B=2):
    """Seeded prefix embeddings (B, P, frontend_dim) for an arch with a
    multimodal prefix, else None."""
    if not cfg.frontend_dim:
        return None
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.num_prefix_tokens, cfg.frontend_dim)).astype(np.float32)


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_loss_and_grads_match_reference(arch):
    """``loss_fn`` and its gradient, leaf by leaf, against ``jax.grad`` of
    the reference's (remat on, the reference's default; MoE under its
    default gshard dispatch; a seeded prefix where the arch has one);
    remat off gives the port the same gradient."""
    jcfg, cfg = _cfgs(arch)
    jp = JM.init_model(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(_np_tree(jp), "cpu")
    batch = _batch(cfg, 7)
    pe = _prefix(cfg, 8)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jax_steps.loss_fn(
            p, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg,
            prefix_embeds=None if pe is None else jnp.asarray(pe)),
        has_aux=True)(jp)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tpe = None if pe is None else torch.from_numpy(pe)
    (tl, tm), tg = steps.value_and_grad(tp, tb, cfg, prefix_embeds=tpe)
    assert abs(float(jl) - float(tl)) <= 1e-5
    for name in ("ce", "aux", "moe_aux_loss", "moe_z_loss"):
        assert abs(float(jm[name]) - float(tm[name])) <= 1e-5, name
    assert (float(tm["aux"]) != 0.0) == (cfg.moe is not None)
    want, got = _jax_flat(jg), _flat(tg)
    assert sorted(want) == sorted(got)
    for k in want:
        assert _max_rel(want[k], got[k]) <= 1e-5, k
    (tl2, _), tg2 = steps.value_and_grad(tp, tb, cfg, remat=False,
                                         prefix_embeds=tpe)
    assert float(tl2) == float(tl)
    for (k, a), (_, b) in zip(tree_flatten_with_path(tg),
                              tree_flatten_with_path(tg2)):
        assert torch.equal(a, b), k
    assert all(not p.requires_grad for _, p in tree_flatten_with_path(tp))


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("G,dim", [(2, 64), (7, 64), (2, 128)])
def test_flash_backward_matches_autograd_and_jax(G, dim, window):
    """The flash autograd Function on CPU tensors (plain forward with lse,
    ``flash_attention_bwd_ref``) against autograd through the plain
    forward and ``jax.grad`` of the reference's oracle; the counters
    count no launch on the CPU."""
    rng = np.random.default_rng(G * dim)
    B, S, KV = 2, 23, 2
    q, k, v, do = (rng.standard_normal(s).astype(np.float32) for s in
                   ((B, S, KV * G, dim), (B, S, KV, dim), (B, S, KV, dim),
                    (B, S, KV * G, dim)))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    n0 = fa.flash_attention.launches, fa.flash_attention_bwd.launches
    got = torch.autograd.grad(fa.flash_attention(*leaves, window=window),
                              leaves, torch.from_numpy(do))
    assert (fa.flash_attention.launches,
            fa.flash_attention_bwd.launches) == n0
    plain = torch.autograd.grad(
        fa.flash_attention_ref(*leaves, window=window), leaves,
        torch.from_numpy(do))
    _, vjp = jax.vjp(lambda a, b, c: jax_ref.flash_attention(
        a, b, c, causal=True, window=window), *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    for a, b, c in zip(got, plain, want):
        assert float((a - b).abs().max()) <= 2e-5
        assert np.max(np.abs(a.numpy() - np.asarray(c))) <= 2e-5


def _trainer_runs(arch):
    """The reference's ``train`` and the port's for TRAIN_STEPS steps from
    the same params (the port's ``init_state`` returns the reference's,
    bridged), logging every step."""
    jcfg, cfg = _cfgs(arch)
    S, B = SHAPE
    jobs, tobs = JaxObservability(), Observability()
    tcfg = dict(num_steps=TRAIN_STEPS, log_every=1)
    _, jhist = jax_trainer.train(jcfg, JaxShapeConfig("t", S, B, "train"),
                                 train_cfg=jax_trainer.TrainConfig(**tcfg),
                                 obs=jobs)
    jp = JM.init_model(jcfg, jax.random.PRNGKey(0))
    bridged = (params_from_numpy(_np_tree(jp), "cpu"),
               adamw_state_from_numpy(_np_tree(jax_opt.init_adamw(jp)),
                                      "cpu"))
    mp = pytest.MonkeyPatch()
    mp.setattr(steps, "init_state", lambda *a, **k: bridged)
    try:
        _, thist = trainer.train(cfg, ShapeConfig("t", S, B, "train"),
                                 train_cfg=trainer.TrainConfig(**tcfg),
                                 obs=tobs, device="cpu")
    finally:
        mp.undo()
    return jhist, thist, jobs, tobs


def _prefix_runs(arch):
    """TRAIN_STEPS multimodal steps of the reference's ``make_train_step``
    and the port's from the same params, on the packed corpus's batches
    plus seeded prefix embeddings (neither trainer makes a prefix)."""
    jcfg, cfg = _cfgs(arch)
    S, B = SHAPE
    jp = JM.init_model(jcfg, jax.random.PRNGKey(0))
    jo = jax_opt.init_adamw(jp)
    tp = params_from_numpy(_np_tree(jp), "cpu")
    to = adamw_state_from_numpy(_np_tree(jo), "cpu")
    jstep, _ = jax_steps.make_train_step(
        jcfg, None, None, jax_opt.AdamWConfig(total_steps=TRAIN_STEPS),
        multimodal=True, donate=False)
    tstep = steps.make_train_step(
        cfg, opt.AdamWConfig(total_steps=TRAIN_STEPS), multimodal=True)
    batches = jax_pipeline.PackedBatches(jax_pipeline.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=S, global_batch=B, seed=0))
    jhist, thist = [], []
    for i in range(TRAIN_STEPS):
        batch = {**next(batches), "prefix_embeds": _prefix(cfg, 100 + i, B)}
        jp, jo, jm = jstep(jp, jo, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        tp, to, tm = tstep(tp, to, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
        jhist.append({"step": i + 1, **{k: float(v) for k, v in jm.items()}})
        thist.append({"step": i + 1, **{k: float(v) for k, v in tm.items()}})
    return jhist, thist


@pytest.fixture(scope="module")
def train_runs():
    return _trainer_runs("qwen2-0.5b")


@pytest.fixture(scope="module", params=TRAIN_ARCHS)
def histories(request, train_runs):
    arch = request.param
    if arch == "qwen2-0.5b":
        return arch, train_runs[:2]
    if get_config(arch).frontend_dim:
        return arch, _prefix_runs(arch)
    return arch, _trainer_runs(arch)[:2]


def test_train_history_matches_reference(histories):
    """Five steps from one state, through the trainers (or, with a
    prefix, the multimodal steps): loss, CE, grad norm and lr, and the MoE
    terms where the arch has them (MoE under gshard), each step."""
    arch, (jhist, thist) = histories
    moe = get_config(arch).moe is not None
    assert len(jhist) == len(thist) == TRAIN_STEPS
    for j, t in zip(jhist, thist):
        assert sorted(j) == sorted(t)
        assert j["step"] == t["step"]
        for k in ("loss", "ce", "grad_norm", "lr"):
            assert abs(j[k] - t[k]) <= 1e-4 * max(1.0, abs(j[k])), (k, j, t)
        for k in ("aux", "moe_aux_loss", "moe_z_loss"):
            if moe:
                assert abs(j[k] - t[k]) <= 1e-4 * max(1.0, abs(j[k])), \
                    (k, j, t)
            else:
                assert j[k] == t[k] == 0.0
    assert thist[-1]["loss"] != thist[0]["loss"]


def test_train_observability_matches_reference(train_runs):
    _, thist, jobs, tobs = train_runs
    for name in ("train.steps",):
        assert (tobs.metrics.counter(name).value
                == jobs.metrics.counter(name).value == TRAIN_STEPS)
    assert tobs.metrics.histogram("train.step_s").count == TRAIN_STEPS
    assert tobs.metrics.gauge("train.loss").value == thist[-1]["loss"]
    assert tobs.compiled_keys("train_step") == jobs.compiled_keys(
        "train_step")


def test_trainer_writes_checkpoints(tmp_path):
    """``ckpt_every`` saves params and optimizer state that restore into
    the reference's trees."""
    jcfg, cfg = _cfgs()
    path = str(tmp_path / "ck")
    params, _ = trainer.train(cfg, ShapeConfig("t", 16, 2, "train"),
                              train_cfg=trainer.TrainConfig(
                                  num_steps=2, ckpt_every=1, ckpt_dir=path),
                              device="cpu")
    assert checkpoint.latest_step(path) == 2
    jp = JM.init_model(jcfg, jax.random.PRNGKey(1))
    restored, ropt = jax_ckpt.restore(path, 2, jp, jax_opt.init_adamw(jp))
    got = _jax_flat(restored)
    for k, v in _flat(params).items():
        np.testing.assert_array_equal(got[k], v)
    assert int(ropt.count) == 2


def test_checkpoints_cross_load_both_ways(tmp_path):
    """JAX writes, the port restores equal tensors (bf16 leaves through
    f32); the port writes, JAX restores; a shape mismatch raises."""
    jcfg = jax_get_config("qwen2-0.5b").reduced()            # bfloat16
    cfg = get_config("qwen2-0.5b").reduced()
    jp = JM.init_model(jcfg, jax.random.PRNGKey(0))
    jo = jax_opt.init_adamw(jp)
    jo = jo._replace(mu=jax.tree.map(lambda x: x + 0.5, jo.mu),
                     count=jnp.int32(3))
    jax_ckpt.save(str(tmp_path / "j"), 3, jp, jo)
    tp = params_from_numpy(_np_tree(jp), "cpu")
    like = (jax.tree.map(lambda x: torch.zeros(x.shape, dtype=torch.bfloat16)
                         if x.dtype == jnp.bfloat16 else
                         torch.zeros(x.shape), _np_tree(jp)))
    rp, ro = checkpoint.restore(str(tmp_path / "j"), 3, like,
                                opt.init_adamw(tp))
    assert rp["embed"].dtype == torch.bfloat16
    for (k, a), (_, b) in zip(tree_flatten_with_path(rp),
                              tree_flatten_with_path(tp)):
        assert torch.equal(a, b), k
    assert int(ro.count) == 3 and ro.count.dtype == torch.int32
    assert float(ro.mu["embed"][0, 0]) == 0.5
    checkpoint.save(str(tmp_path / "t"), 4, rp, ro)
    with np.load(str(tmp_path / "t" / "step_4.npz")) as a, \
            np.load(str(tmp_path / "j" / "step_3.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
    jr, jro = jax_ckpt.restore(str(tmp_path / "t"), 4, jp, jo)
    for a, b in zip(jax.tree.leaves(jr), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))
    assert int(jro.count) == 3
    small = dataclasses.replace(cfg, d_model=128, head_dim=32)
    from repro_torch.models import model as M
    with pytest.raises(ValueError, match="shape mismatch"):
        checkpoint.restore(str(tmp_path / "j"), 3,
                           M.init_model(small, torch.Generator()
                                        .manual_seed(0)))


def test_typed_refusals():
    """A mesh that is not a DeviceMesh raises PlanError naming the ROADMAP
    item, a plan that is no plan the reference's PlanError from
    ``HyperPlan.coerce``, and an offload is accepted (HyperOffload's legs, tests/test_torch_offload.py);
    a MoE config under the ragged dispatch trains (the grouped matmul's
    backward, ROADMAP item 2.9b; tests/test_torch_grouped_bwd.py holds it
    against the reference), its experts moving; flash refuses a gradient at
    a head-dim pair or a q_offset its backward does not take, before
    anything runs."""
    from repro_torch.core.offload import OffloadConfig
    jcfg, cfg = _cfgs()
    acfg = opt.AdamWConfig()
    with pytest.raises(PlanError, match="item"):
        steps.make_train_step(cfg, acfg, mesh=object())
    both = OffloadConfig(params_on_host=True, opt_state_on_host=True)
    params, state = steps.init_state(cfg, device="cpu", offload_cfg=both)
    assert all(t.device.type == "cpu"
               for _, t in tree_flatten_with_path((params, state)))
    steps.make_train_step(cfg, acfg, offload_cfg=both)
    shape = ShapeConfig("t", 8, 1, "train")
    for kw, why in ((dict(plan=object()), "cannot coerce object into a "
                     "HyperPlan"), (dict(mesh=object()), "item 8")):
        with pytest.raises(PlanError, match=why):
            trainer.train(cfg, shape, device="cpu", **kw)
    _, hist = trainer.train(cfg, shape, device="cpu", offload_cfg=both,
                            train_cfg=trainer.TrainConfig(num_steps=1))
    assert len(hist) == 1 and np.isfinite(hist[0]["loss"])
    _, mcfg = _cfgs("deepseek-moe-16b")
    params, state = steps.init_state(mcfg, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(mcfg, 1, 1, 4).items()}
    step = steps.make_train_step(mcfg, acfg, moe_dispatch="ragged")
    new, _, m = step(params, state, batch)
    assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0
    assert not torch.equal(new["seg1"][0]["ffn"]["w_gate"],
                           params["seg1"][0]["ffn"]["w_gate"])
    q = torch.zeros(1, 4, 2, 32, requires_grad=True)
    k = torch.zeros(1, 4, 2, 32)
    with pytest.raises(ValueError, match="backward is built"):
        fa.flash_attention(q, k, k, window=8)
    q = torch.zeros(1, 4, 2, 64, requires_grad=True)
    k = torch.zeros(1, 8, 2, 64)
    with pytest.raises(ValueError, match="q_offset = 0"):
        fa.flash_attention(q, k, k, q_offset=torch.tensor([4]))


def test_launcher_trains_on_an_explicit_cpu(capsys, monkeypatch):
    """The reference's log line; without ``--device`` the launcher targets
    the card (and exits without one); ``--offload``, ``--plan tp_only``,
    ``--mesh auto`` on one rank (no mesh, as the reference's
    ``Supernode.auto()``), and the 1F1B pipeline's ``--pipeline 2`` and
    ``--plan pipeline`` (colocated on one rank, with ``--mesh auto`` too)
    train, and so does ``--plan offload_all`` (through the facade's
    plan); ``--explain`` prints the plan resolution report;
    ``--ckpt-dir`` with a pipeline raises (checkpointing is not wired
    there)."""
    from repro_torch.launch import train as launcher
    launcher.main(["--arch", "qwen2-0.5b", "--reduced", "--steps", "2",
                   "--device", "cpu", "--global-batch", "2"])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and out[0].startswith("step     1  loss ")
    assert "grad_norm" in out[0] and " lr " in out[0]
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    for flags in (["--offload"], ["--plan", "tp_only"], ["--mesh", "auto"],
                  ["--pipeline", "2", "--micro-batches", "2"],
                  ["--plan", "pipeline", "--micro-batches", "2"],
                  ["--mesh", "auto", "--pipeline", "2", "--micro-batches",
                   "2"]):
        launcher.main(["--arch", "qwen2-0.5b", "--reduced", "--steps", "1",
                       "--device", "cpu", "--global-batch", "2", *flags])
        out = capsys.readouterr().out.strip().splitlines()
        assert len(out) == 1 and out[0].startswith("step     1  loss ")
    launcher.main(["--arch", "qwen2-0.5b", "--reduced", "--steps", "1",
                   "--device", "cpu", "--global-batch", "2", "--plan",
                   "offload_all"])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and out[0].startswith("step     1  loss ")
    launcher.main(["--arch", "qwen2-0.5b", "--reduced", "--explain"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].startswith("HyperPlan resolution: model=qwen2-0.5b "
                             "plan=fsdp_tp")
    with pytest.raises(PlanError, match="checkpointing is not wired for "
                       "the pipeline"):
        launcher.main(["--arch", "qwen2-0.5b", "--reduced", "--pipeline",
                       "2", "--ckpt-dir", "ckpt"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        launcher.main(["--arch", "qwen2-0.5b", "--reduced", "--steps", "1"])
