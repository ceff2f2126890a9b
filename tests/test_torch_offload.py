"""The port's HyperOffload against the reference's, on the CPU.

- ``streamed_apply`` over ``unstack_layers`` of a segment's stacked
  params (the layers' params fetched one at a time) against the plain
  loop over the same layers, within 1e-5 (the same operations on the
  same values: equal here).
- ``train_hbm_bytes`` and ``serve_hbm_bytes`` (and the config's
  ``param_count``) equal to the reference's for every arch.
- Training with params and optimizer state on the host:
  ``train(offload_cfg=OffloadConfig(params_on_host=True,
  opt_state_on_host=True))`` on reduced qwen2-0.5b (f32) for five steps,
  its history and params bit-identical to the same run without offload,
  and its history equal to the reference trainer's to
  ``tests/test_torch_train.py``'s 1e-4 relative; between steps every leaf
  of rank >= 2 lies in host memory and 1-D leaves stay put (the
  reference's ``spec_fully_sharded`` on a one-device mesh), and the
  ``train.fetch`` / ``train.offload`` spans run once a step.
"""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from repro.configs.base import ShapeConfig as JaxShapeConfig  # noqa: E402
from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.configs.base import list_archs as jax_list_archs  # noqa: E402
from repro.core import offload as joff  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import adamw as jax_opt  # noqa: E402
from repro.train import trainer as jax_trainer  # noqa: E402
from repro_torch.configs.base import ShapeConfig, get_config  # noqa: E402
from repro_torch.core import offload as off  # noqa: E402
from repro_torch.core.tree import tree_flatten_with_path, tree_map  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.bridge import (adamw_state_from_numpy,  # noqa: E402
                                       params_from_numpy)
from repro_torch.models.mixers import segments  # noqa: E402
from repro_torch.obs import Observability  # noqa: E402
from repro_torch.train import steps, trainer  # noqa: E402

TRAIN_STEPS = 5
SHAPE = (32, 2)                       # seq_len, global batch
BOTH = off.OffloadConfig(params_on_host=True, opt_state_on_host=True)


def test_streamed_apply_matches_the_layer_loop():
    cfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(),
                              dtype="float32", num_layers=3)
    params = M.init_model(cfg, torch.Generator().manual_seed(0))
    seg = segments(cfg)[0]
    stacked = params["seg0"]
    layers = off.unstack_layers(stacked)
    assert len(layers) == seg.repeat == 3
    x0 = torch.randn(2, 8, cfg.d_model, generator=torch.Generator()
                     .manual_seed(1))
    positions = torch.arange(8)

    def layer_fn(x, lp):
        return M._layer_forward(lp, seg.kinds, x, positions, cfg,
                                mode="train", window_override=None,
                                moe_dispatch="gshard")[0]
    want = x0
    for i in range(seg.repeat):
        want = layer_fn(want, tree_map(lambda a: a[i], stacked))
    host = [tree_map(off.to_host_async, lp) for lp in layers]
    got = off.streamed_apply(layer_fn, x0, host, torch.device("cpu"))
    assert (got - want).abs().max() <= 1e-5
    assert not torch.equal(got, x0)


@pytest.mark.parametrize("arch", jax_list_archs())
def test_hbm_models_match_reference(arch):
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    for kw in (dict(), dict(params_on_host=True, stream_layers=True),
               dict(opt_state_on_host=True, activations_to_host=True,
                    prefetch_depth=3),
               dict(params_on_host=True, opt_state_on_host=True)):
        for tp in (1, 4):
            assert off.train_hbm_bytes(
                cfg, 4, 4096, offload=off.OffloadConfig(**kw), tp=tp) == \
                joff.train_hbm_bytes(jcfg, 4, 4096,
                                     offload=joff.OffloadConfig(**kw), tp=tp)
    for kw in (dict(), dict(kv_on_host_frac=0.75, tp=2),
               dict(window=2048, kv_on_host_frac=0.5)):
        assert off.serve_hbm_bytes(cfg, 8, 32768, **kw) == \
            joff.serve_hbm_bytes(jcfg, 8, 32768, **kw)


def test_spec_fully_sharded_matches_reference():
    sizes = ({"data": 1, "model": 1}, {"data": 4, "model": 2},
             {"data": 8, "model": 1})
    for spec in ((None,), ("data", None), (None, "model"),
                 ("data", "model"), (("data", "model"), None),
                 (None, None, None)):
        for axes in sizes:
            assert off.spec_fully_sharded(spec, axes) == \
                joff.spec_fully_sharded(spec, axes), (spec, axes)
    assert off.host_placeable(torch.zeros(2, 3))
    assert not off.host_placeable(torch.zeros(3))


def _cfgs():
    extra = dict(dtype="float32")
    return (dataclasses.replace(jax_get_config("qwen2-0.5b").reduced(),
                                **extra),
            dataclasses.replace(get_config("qwen2-0.5b").reduced(), **extra))


@pytest.fixture(scope="module")
def offload_runs():
    """The reference trainer, then the port's from the same (bridged)
    state without and with offload; the offloaded run records what each
    offload leg moved and where the state lay after it."""
    jcfg, cfg = _cfgs()
    S, B = SHAPE
    tcfg = dict(num_steps=TRAIN_STEPS, log_every=1)
    _, jhist = jax_trainer.train(jcfg, JaxShapeConfig("t", S, B, "train"),
                                 train_cfg=jax_trainer.TrainConfig(**tcfg))
    jp = JM.init_model(jcfg, jax.random.PRNGKey(0))
    np_p = jax.tree.map(np.asarray, jp)
    np_o = jax.tree.map(np.asarray, jax_opt.init_adamw(jp))

    def bridged_init(cfg, *, seed=0, device=None, mesh=None, plan=None,
                     offload_cfg=None):
        p = params_from_numpy(np_p, "cpu")
        o = adamw_state_from_numpy(np_o, "cpu")
        return (steps.offload_state(p, o, offload_cfg) if offload_cfg
                else (p, o))

    moved, after = [], []
    real_to_host, real_offload = off.to_host_async, steps.offload_state

    def to_host(t):
        moved.append(t.dim())
        return real_to_host(t)

    def offload_state(params, opt_state, offload_cfg):
        out = real_offload(params, opt_state, offload_cfg)
        after.append([(t.dim(), t.device.type, t.is_pinned())
                      for _, t in tree_flatten_with_path(out)])
        return out

    runs = {}
    for name, ocfg in (("plain", None), ("offload", BOTH)):
        mp = pytest.MonkeyPatch()
        mp.setattr(steps, "init_state", bridged_init)
        if ocfg is not None:
            mp.setattr(off, "to_host_async", to_host)
            mp.setattr(steps, "offload_state", offload_state)
        obs = Observability()
        obs.trace.enable()
        try:
            runs[name] = trainer.train(
                cfg, ShapeConfig("t", S, B, "train"),
                train_cfg=trainer.TrainConfig(**tcfg), obs=obs,
                device="cpu", offload_cfg=ocfg) + (obs,)
        finally:
            mp.undo()
    return jhist, runs, moved, after


def test_offloaded_training_is_bit_identical(offload_runs):
    jhist, runs, _, _ = offload_runs
    (pp, ph, _), (op, oh, _) = runs["plain"], runs["offload"]
    drop = lambda h: [{k: v for k, v in m.items() if k != "wall_s"}  # noqa
                      for m in h]
    assert drop(oh) == drop(ph) and len(oh) == TRAIN_STEPS
    for (k, a), (_, b) in zip(tree_flatten_with_path(op),
                              tree_flatten_with_path(pp)):
        assert torch.equal(a, b), k
    for j, t in zip(jhist, oh):
        for k in ("loss", "ce", "grad_norm", "lr"):
            assert abs(j[k] - t[k]) <= 1e-4 * max(1.0, abs(j[k])), (k, j, t)
    assert oh[-1]["loss"] != oh[0]["loss"]


def test_offload_legs_move_every_leaf_of_rank_two_or_more(offload_runs):
    _, runs, moved, after = offload_runs
    params = runs["offload"][0]
    ranks = [t.dim() for _, t in tree_flatten_with_path(params)]
    per_leg = 3 * sum(r >= 2 for r in ranks)        # params, mu, nu
    # init_state's placement, then one offload leg a step
    assert len(after) == TRAIN_STEPS + 1
    assert len(moved) == per_leg * (TRAIN_STEPS + 1) and min(moved) >= 2
    pinned = torch.cuda.is_available()
    for leg in after:
        assert len(leg) == 3 * len(ranks) + 1       # + the step count
        for dim, dev, is_pinned in leg:
            if dim >= 2:
                assert dev == "cpu" and is_pinned == pinned
    _, _, obs = runs["offload"]
    names = [e["name"] for e in obs.trace.events() if e.get("ph") == "X"]
    for span in ("train.fetch", "train.offload", "train.step"):
        assert names.count(span) == TRAIN_STEPS, span
    _, _, pobs = runs["plain"]
    assert "train.fetch" not in [e["name"] for e in pobs.trace.events()]
    # f32 params: the moments take as many bytes as the params
    state = steps.opt_mod.init_adamw(params)
    assert steps.state_nbytes(params, state, BOTH) == 3 * sum(
        t.numel() * 4 for _, t in tree_flatten_with_path(params)
        if t.dim() >= 2)
