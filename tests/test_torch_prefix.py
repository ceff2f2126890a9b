"""The multimodal prefix of the port's model against the reference's.

internvl2-26b and musicgen-large take precomputed frontend embeddings (the
reference stubs the ViT and the EnCodec/T5 frontends), projected by
``frontend_proj`` and put before the tokens.  JAX ``init_model`` params at
``.reduced()`` size in float32 go through the weight bridge, and seeded
prefix embeddings made with numpy go to both frameworks:

- ``forward(prefix_embeds=)`` logits (the tokens' only) in train and
  prefill modes, and the prefill caches, which hold prefix and tokens;
- the ``Generator``'s greedy tokens (the reference's Generator passes no
  prefix either);
- a checkpoint with ``frontend_proj`` written by either package restores
  in the other;
- the train launcher trains two steps of reduced musicgen-large on the
  CPU.

Tolerances: logits and caches 1e-4 abs in float32, as
``tests/test_torch_generate.py`` (sums in another order); greedy tokens
exactly equal (float32, so no argmax flips on rounding).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from repro.ckpt import checkpoint as jax_ckpt  # noqa: E402
from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import adamw as jax_opt  # noqa: E402
from repro.serve.engine import GenerateConfig as JaxGenerateConfig  # noqa
from repro.serve.engine import Generator as JaxGenerator  # noqa: E402
from repro_torch.ckpt import checkpoint  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core.tree import tree_flatten_with_path  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402
from repro_torch.optim import adamw as opt  # noqa: E402
from repro_torch.serve.engine import GenerateConfig, Generator  # noqa: E402

TOL = 1e-4
ARCHS = ["internvl2-26b", "musicgen-large"]


@functools.cache
def _models(arch):
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(),
                               dtype="float32")
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    jp = JM.init_model(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, cfg, jp, tp


def _inputs(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, cfg.vocab_size, size=(B, S)).astype(np.int32)
    pe = rng.standard_normal((B, cfg.num_prefix_tokens,
                              cfg.frontend_dim)).astype(np.float32)
    return tokens, pe


def _sorted(tree):
    """The port tree with its dict keys in the order JAX flattens them."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_sorted(v) for v in tree)
    return tree


@pytest.mark.parametrize("arch", ARCHS)
def test_init_has_the_reference_frontend_projection(arch):
    """``frontend_proj`` (frontend_dim, d_model) in the model's dtype, and
    the same leaves, shapes and dtypes as the reference's tree."""
    cfg = get_config(arch).reduced()
    tp = M.init_model(cfg, torch.Generator().manual_seed(0))
    assert tp["frontend_proj"].shape == (cfg.frontend_dim, cfg.d_model)
    assert tp["frontend_proj"].dtype == torch.bfloat16
    jp = jax.eval_shape(lambda: JM.init_model(jax_get_config(arch).reduced(),
                                              jax.random.PRNGKey(0)))
    jl = jax.tree.leaves(jp)
    tl = tree_leaves(_sorted(tp))
    assert [(tuple(a.shape), str(a.dtype)) for a in jl] == \
        [(tuple(b.shape), str(b.dtype).replace("torch.", "")) for b in tl]


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_with_a_prefix_matches_reference(arch):
    """Train- and prefill-mode logits of the tokens (B, S, V_pad) after a
    prefix of P frames, and the prefill caches over P + S positions."""
    jcfg, cfg, jp, tp = _models(arch)
    tokens, pe = _inputs(cfg, 2, 11, 1)
    P = cfg.num_prefix_tokens
    lj, cj, _ = JM.forward(jp, jnp.asarray(tokens), jcfg, mode="prefill",
                           prefix_embeds=jnp.asarray(pe))
    lj_train, _, _ = JM.forward(jp, jnp.asarray(tokens), jcfg,
                                prefix_embeds=jnp.asarray(pe))
    with torch.no_grad():
        lt, ct, _ = M.forward(tp, torch.from_numpy(tokens), cfg,
                              mode="prefill",
                              prefix_embeds=torch.from_numpy(pe))
        lt_train, none, _ = M.forward(tp, torch.from_numpy(tokens), cfg,
                                      prefix_embeds=torch.from_numpy(pe))
        plain, _, _ = M.forward(tp, torch.from_numpy(tokens), cfg)
    assert lt.shape == (2, 11, cfg.padded_vocab) and none is None
    assert np.max(np.abs(np.asarray(lj) - lt.numpy())) < TOL
    assert np.max(np.abs(np.asarray(lj_train) - lt_train.numpy())) < TOL
    assert not torch.allclose(lt_train, plain)    # the prefix is seen
    jl, tl = jax.tree.leaves(cj), tree_leaves(_sorted(ct))
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert tuple(a.shape) == tuple(b.shape)
        assert np.max(np.abs(np.asarray(a) - b.numpy())) < TOL
    assert ct["seg0"][0]["k"].shape[2] == P + 11


@pytest.mark.parametrize("arch", ARCHS)
def test_generator_greedy_tokens_match_reference(arch):
    jcfg, cfg, jp, tp = _models(arch)
    prompts, _ = _inputs(cfg, 2, 12, 2)
    want = JaxGenerator(jcfg, jp, max_len=24).generate(
        jnp.asarray(prompts), JaxGenerateConfig(max_new_tokens=8))
    got = Generator(cfg, tp, max_len=24, device="cpu").generate(
        torch.from_numpy(prompts), GenerateConfig(max_new_tokens=8))
    assert got.tolist() == np.asarray(want).tolist()


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoints_with_a_prefix_cross_load_both_ways(arch, tmp_path):
    """JAX writes params with ``frontend_proj`` and AdamW state, the port
    restores equal tensors (bf16 through f32); the port writes, JAX
    restores the same."""
    jcfg = jax_get_config(arch).reduced()                  # bfloat16
    cfg = get_config(arch).reduced()
    jp = JM.init_model(jcfg, jax.random.PRNGKey(4))
    jo = jax_opt.init_adamw(jp)._replace(count=jnp.int32(2))
    jax_ckpt.save(str(tmp_path / "j"), 2, jp, jo)
    like = M.init_model(cfg, torch.Generator().manual_seed(0))
    rp, ro = checkpoint.restore(str(tmp_path / "j"), 2, like,
                                opt.init_adamw(like))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    assert rp["frontend_proj"].dtype == torch.bfloat16
    for (k, a), (_, b) in zip(tree_flatten_with_path(rp),
                              tree_flatten_with_path(tp)):
        assert torch.equal(a, b), k
    assert int(ro.count) == 2
    checkpoint.save(str(tmp_path / "t"), 3, rp, ro)
    jr, jro = jax_ckpt.restore(str(tmp_path / "t"), 3, jp, jo)
    np.testing.assert_array_equal(
        np.asarray(jr["frontend_proj"], np.float32),
        np.asarray(jp["frontend_proj"], np.float32))
    for a, b in zip(jax.tree.leaves(jr), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))
    assert int(jro.count) == 2


def test_launcher_trains_musicgen_on_the_cpu(capsys):
    """Two steps of reduced musicgen-large (the trainer, as the
    reference's, makes no prefix), one log line."""
    from repro_torch.launch import train as launcher
    launcher.main(["--arch", "musicgen-large", "--reduced", "--steps", "2",
                   "--device", "cpu", "--global-batch", "2"])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and out[0].startswith("step     1  loss ")
    assert np.isfinite(float(out[0].split()[3]))
