"""The port's dense path (``forward``, ``decode_step``, ``Generator``)
against the reference's, on bridged params.

JAX ``init_model`` params for ``qwen2-0.5b`` (QKV bias, tied embeddings)
and ``llama3-8b`` (no bias, untied) at ``.reduced()`` size in float32 go
through ``jax.tree.map(np.asarray, ...)`` and the port's weight bridge, so
both frameworks compute the same function on the same tokens (made with
numpy from a seed).  On the CPU the port's ``flash_attention`` and
``decode_attention`` run their plain versions.

Tolerances: logits and caches 1e-4 abs in float32 (the matmul and softmax
sums run in another order; the caches hold K/V straight from the same
projections).  Greedy tokens exactly equal: float32, so no argmax flips on
rounding.  Windowed cases use a window shorter than the prompt, so the
flash window, the ring-layout prefill cache and the ring decode cache all
run; so does the hybrid recurrentgemma-2b, whose LOCAL_ATTN layers are
windowed by the config and whose RG-LRU layers carry a recurrent state
and a conv tail.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve.engine import GenerateConfig as JaxGenerateConfig  # noqa
from repro.serve.engine import Generator as JaxGenerator  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402
from repro_torch.serve.engine import GenerateConfig, Generator  # noqa: E402

TOL = 1e-4
ARCHS = ["qwen2-0.5b", "llama3-8b"]
WINDOWS = [None, 8]


# recurrentgemma-2b cut to 5 layers, (RG-LRU, RG-LRU, LOCAL_ATTN) + (RG-LRU,
# RG-LRU), so both segments exist, with a window shorter than the prompts
HYBRID = ("recurrentgemma-2b", (("num_layers", 5), ("sliding_window", 16)))


@functools.cache
def _models(arch, overrides=()):
    kw = dict(overrides, dtype="float32")
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(), **kw)
    cfg = dataclasses.replace(get_config(arch).reduced(), **kw)
    jp = JM.init_model(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, cfg, jp, tp


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        1, cfg.vocab_size, size=shape).astype(np.int32)


def _sorted(tree):
    """The port tree with its dict keys in the order JAX flattens them."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_sorted(v) for v in tree)
    return tree


def _assert_tree_close(jtree, ttree):
    jl = jax.tree.leaves(jtree)
    tl = tree_leaves(_sorted(ttree))
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert tuple(a.shape) == tuple(b.shape)
        if a.size:                  # a segment of no layers holds nothing
            assert np.max(np.abs(np.asarray(a) - b.numpy())) < TOL


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_forward_matches_reference(arch, window):
    """Logits and the stacked per-layer caches of ``mode="prefill"``
    (ring layout, slot = pos % window, when windowed), and the train-mode
    logits."""
    jcfg, cfg, jp, tp = _models(arch)
    tokens = _tokens(cfg, (2, 19), 1)
    lj, cj, _ = JM.forward(jp, jnp.asarray(tokens), jcfg, mode="prefill",
                           window_override=window)
    with torch.no_grad():
        lt, ct, metrics = M.forward(tp, torch.from_numpy(tokens), cfg,
                                    mode="prefill", window_override=window)
        lt_train, none, _ = M.forward(tp, torch.from_numpy(tokens), cfg,
                                      window_override=window)
    assert np.max(np.abs(np.asarray(lj) - lt.numpy())) < TOL
    _assert_tree_close(cj, ct)
    assert none is None and torch.equal(lt, lt_train)
    assert float(metrics["moe_aux_loss"]) == 0.0
    if window is not None:
        assert ct["seg0"][0]["k"].shape[2] == window


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_reference(arch, window):
    """Token-by-token decode from empty caches past the window, so the
    ring buffer wraps (as ``tests/test_serve.py``'s windowed decode test
    drives it), comparing the logits of every step and the final caches."""
    jcfg, cfg, jp, tp = _models(arch)
    B, steps, cache_len = 2, 13, 16
    tokens = _tokens(cfg, (B, steps), 2)
    jc = JM.init_caches(jcfg, B, cache_len, dtype=jnp.float32,
                        window_override=window)
    tc = M.init_caches(cfg, B, cache_len, dtype=torch.float32,
                       window_override=window)
    _assert_tree_close(jc, tc)
    for t in range(steps):
        lj, jc = JM.decode_step(jp, jnp.asarray(tokens[:, t:t + 1]),
                                jnp.int32(t), jcfg, jc,
                                window_override=window)
        with torch.no_grad():
            lt = M.decode_step(tp, torch.from_numpy(tokens[:, t:t + 1]), t,
                               cfg, tc, window_override=window)
        assert np.max(np.abs(np.asarray(lj) - lt.numpy())) < TOL, t
    _assert_tree_close(jc, tc)


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("arch", ARCHS)
def test_generator_greedy_tokens_match_reference(arch, window):
    jcfg, cfg, jp, tp = _models(arch)
    prompts = _tokens(cfg, (2, 16), 3)
    want = JaxGenerator(jcfg, jp, max_len=32, window_override=window) \
        .generate(jnp.asarray(prompts), JaxGenerateConfig(max_new_tokens=8))
    gen = Generator(cfg, tp, max_len=32, window_override=window,
                    device="cpu")
    got = gen.generate(torch.from_numpy(prompts),
                       GenerateConfig(max_new_tokens=8))
    assert got.tolist() == np.asarray(want).tolist()
    assert gen.obs.compiled_keys() == {"dense_prefill": [(2, 16)],
                                       "dense_serve": [(2, 32)]}


def test_seeded_sampling_replays_within_the_port():
    """Temperature sampling draws from a generator seeded by
    ``GenerateConfig.seed``: the same seed gives the same tokens, another
    seed and greedy decoding give other ones."""
    _, cfg, _, tp = _models("qwen2-0.5b")
    prompts = torch.from_numpy(_tokens(cfg, (2, 6), 4))
    gen = Generator(cfg, tp, max_len=32, device="cpu")
    runs = [gen.generate(prompts, GenerateConfig(max_new_tokens=12,
                                                 temperature=1.5, seed=s))
            for s in (7, 7, 8)]
    greedy = gen.generate(prompts, GenerateConfig(max_new_tokens=12))
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])
    assert not torch.equal(runs[0], greedy)
    assert bool(((runs[0] >= 0) & (runs[0] < cfg.vocab_size)).all())


def test_hybrid_forward_decode_and_generator_match_reference():
    """recurrentgemma-2b (RG-LRU + LOCAL_ATTN, 5 layers, window 16): the
    prefill logits and caches (the windowed layer's in ring layout, the
    RG-LRU layers' state and conv tail), 20 decode steps from zero caches
    past the window, and the Generator's greedy tokens on 20-token
    prompts, against the reference's."""
    jcfg, cfg, jp, tp = _models(*HYBRID)
    tokens = _tokens(cfg, (2, 19), 5)
    lj, cj, _ = JM.forward(jp, jnp.asarray(tokens), jcfg, mode="prefill")
    with torch.no_grad():
        lt, ct, _ = M.forward(tp, torch.from_numpy(tokens), cfg,
                              mode="prefill")
    assert np.max(np.abs(np.asarray(lj) - lt.numpy())) < TOL
    _assert_tree_close(cj, ct)
    assert ct["seg0"][2]["k"].shape[2] == cfg.sliding_window
    B, steps = 2, 20
    tokens = _tokens(cfg, (B, steps), 6)
    jc = JM.init_caches(jcfg, B, 24, dtype=jnp.float32)
    tc = M.init_caches(cfg, B, 24, dtype=torch.float32)
    _assert_tree_close(jc, tc)
    step = jax.jit(JM.decode_step, static_argnums=3)
    for t in range(steps):
        lj, jc = step(jp, jnp.asarray(tokens[:, t:t + 1]), jnp.int32(t),
                      jcfg, jc)
        with torch.no_grad():
            lt = M.decode_step(tp, torch.from_numpy(tokens[:, t:t + 1]), t,
                               cfg, tc)
        assert np.max(np.abs(np.asarray(lj) - lt.numpy())) < TOL, t
    _assert_tree_close(jc, tc)
    prompts = _tokens(cfg, (2, 20), 7)
    want = JaxGenerator(jcfg, jp, max_len=48).generate(
        jnp.asarray(prompts), JaxGenerateConfig(max_new_tokens=10))
    got = Generator(cfg, tp, max_len=48, device="cpu").generate(
        torch.from_numpy(prompts), GenerateConfig(max_new_tokens=10))
    assert got.tolist() == np.asarray(want).tolist()


def test_hybrid_of_two_layers_has_an_empty_pattern_segment():
    """``.reduced()`` recurrentgemma-2b keeps 2 layers: its pattern segment
    (the pattern cut to the 2 layers there are) repeats 0 times and the
    tail holds both layers.  The prefill still returns the empty segment's caches, with
    the shapes the reference's scan gives them, and the Generator seats
    them: its greedy tokens match the reference's."""
    jcfg, cfg, jp, tp = _models("recurrentgemma-2b")
    tokens = _tokens(cfg, (2, 9), 8)
    lj, cj, _ = JM.forward(jp, jnp.asarray(tokens), jcfg, mode="prefill")
    with torch.no_grad():
        lt, ct, _ = M.forward(tp, torch.from_numpy(tokens), cfg,
                              mode="prefill")
    assert ct["seg0"][0]["state"].shape[0] == 0
    assert np.max(np.abs(np.asarray(lj) - lt.numpy())) < TOL
    _assert_tree_close(cj, ct)
    want = JaxGenerator(jcfg, jp, max_len=24).generate(
        jnp.asarray(tokens), JaxGenerateConfig(max_new_tokens=6))
    got = Generator(cfg, tp, max_len=24, device="cpu").generate(
        torch.from_numpy(tokens), GenerateConfig(max_new_tokens=6))
    assert got.tolist() == np.asarray(want).tolist()
