"""The port's paged serving steps against the reference's, on bridged params.

JAX ``init_model`` params for ``qwen2-0.5b`` (QKV bias, tied embeddings)
and ``llama3-8b`` (no bias, untied) at ``.reduced()`` size in float32 go
through ``jax.tree.map(np.asarray, ...)`` and the port's weight bridge, so
both frameworks compute the same function.  On the same pools, tables,
starts, limits and positions (made with numpy from a seed),
``decode_step_paged`` and ``prefill_chunk_paged`` must give the same
logits and the same updated pools, each of the port's lowerings
(``kernels="fused"`` and ``"composed"``) against the reference's same
lowering.  Pools are compared outside the null block 0, which takes the
padding writes in any order.  Tolerance 1e-4 abs in float32: the matmul
and softmax sums run in another order.
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
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core.tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402

BS, NB, W = 4, 24, 6
TOL = 1e-4
ARCHS = ["qwen2-0.5b", "llama3-8b"]


@functools.cache
def _models(arch):
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(),
                               dtype="float32")
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    jp = JM.init_model(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, cfg, jp, tp


def _pools(cfg, rng):
    shape = (cfg.num_layers, NB, BS, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"seg0": ({"k": rng.standard_normal(shape).astype(np.float32),
                      "v": rng.standard_normal(shape).astype(np.float32)},)}


def _tables(rows):
    perm = np.random.RandomState(0).permutation(NB - 1)[:rows * W] + 1
    return perm.reshape(rows, W).astype(np.int32)


def _assert_same(logits_j, pools_j, logits_t, pools_t, rows=slice(None)):
    lj = np.asarray(logits_j)[rows]
    lt = logits_t.numpy()[rows]
    assert lj.shape == lt.shape
    assert np.max(np.abs(lj - lt)) < TOL
    for (name, a), b in zip(
            sorted(pools_j["seg0"][0].items()),
            (v for _, v in sorted(pools_t["seg0"][0].items()))):
        diff = np.abs(np.asarray(a)[:, 1:] - b.numpy()[:, 1:])
        assert np.max(diff) < TOL, name


def test_bridge_maps_every_leaf():
    jcfg, cfg, jp, tp = _models("qwen2-0.5b")
    jflat = jax.tree_util.tree_leaves_with_path(jp)
    assert len(jflat) == len(tree_leaves(tp))
    # same tree: every reference leaf has a same-shaped, equal port leaf
    for path, leaf in jflat:
        node = tp
        for k in path:
            node = node[getattr(k, "key", getattr(k, "idx", None))]
        assert tuple(node.shape) == leaf.shape
        assert np.array_equal(node.numpy(), np.asarray(leaf))
    # bf16 leaves pass through float32 losslessly
    bf = jax.random.normal(jax.random.PRNGKey(1), (64,), jnp.bfloat16)
    back = params_from_numpy({"w": np.asarray(bf)}, "cpu")["w"]
    assert back.dtype == torch.bfloat16
    assert np.array_equal(back.float().numpy(),
                          np.asarray(bf.astype(jnp.float32)))


@pytest.mark.parametrize("kernels", ["composed", "fused"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_paged_matches_reference(arch, kernels):
    jcfg, cfg, jp, tp = _models(arch)
    rng = np.random.default_rng(2)
    pools = _pools(cfg, rng)
    B = 3
    tables = _tables(B)
    positions = np.asarray([5, 0, 13], np.int32)
    tokens = rng.integers(1, cfg.vocab_size, size=(B, 1)).astype(np.int32)
    lj, pj = JM.decode_step_paged(
        jp, jnp.asarray(tokens), jnp.asarray(positions), jcfg,
        jax.tree.map(jnp.asarray, pools), jnp.asarray(tables),
        block_size=BS, kernels=kernels)
    tpools = tree_map(lambda a: torch.from_numpy(a.copy()), pools)
    lt = M.decode_step_paged(
        tp, torch.from_numpy(tokens), torch.from_numpy(positions), cfg,
        tpools, torch.from_numpy(tables), block_size=BS, kernels=kernels)
    _assert_same(lj, pj, lt, tpools)


@pytest.mark.parametrize("kernels", ["composed", "fused"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_chunk_paged_matches_reference(arch, kernels):
    jcfg, cfg, jp, tp = _models(arch)
    rng = np.random.default_rng(3)
    pools = _pools(cfg, rng)
    C = 8
    starts = np.asarray([0, 8, 0], np.int32)
    limits = np.asarray([6, 21, 0], np.int32)      # partial, middle, filler
    slots = np.asarray([0, 1, 4], np.int32)
    tables = _tables(3)
    tokens = rng.integers(1, cfg.vocab_size, size=(3, C)).astype(np.int32)
    lj, pj = JM.prefill_chunk_paged(
        jp, jnp.asarray(tokens), jnp.asarray(starts), jnp.asarray(limits),
        jnp.asarray(slots), jcfg, jax.tree.map(jnp.asarray, pools),
        jnp.asarray(tables), block_size=BS, kernels=kernels)
    tpools = tree_map(lambda a: torch.from_numpy(a.copy()), pools)
    lt = M.prefill_chunk_paged(
        tp, torch.from_numpy(tokens), torch.from_numpy(starts),
        torch.from_numpy(limits), torch.from_numpy(slots), cfg, tpools,
        torch.from_numpy(tables), block_size=BS, kernels=kernels)
    # the composed lowering attends filler rows too (their logits are
    # discarded) and the fused kernels zero them; rows are compared where
    # the result is defined: every row fused, the live rows composed
    _assert_same(lj, pj, lt, tpools,
                 rows=slice(None) if kernels == "fused" else slice(0, 2))


def test_init_model_is_seeded_and_stacked():
    cfg = get_config("qwen2-0.5b").reduced()
    a = M.init_model(cfg, torch.Generator().manual_seed(3))
    b = M.init_model(cfg, torch.Generator().manual_seed(3))
    jp = JM.init_model(jax_get_config("qwen2-0.5b").reduced(),
                       jax.random.PRNGKey(0))
    # same tree, shapes and dtypes as the reference's init
    for path, leaf in jax.tree_util.tree_leaves_with_path(jp):
        na, nb = a, b
        for k in path:
            key = getattr(k, "key", getattr(k, "idx", None))
            na, nb = na[key], nb[key]
        assert tuple(na.shape) == leaf.shape
        assert str(na.dtype).split(".")[-1] == str(leaf.dtype)
        assert torch.equal(na, nb)
