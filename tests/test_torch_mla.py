"""The port's MLA (multi-head latent attention) against the reference.

- ``paged_mla_decode_attention``: the port's plain version (what the
  wrapper runs for CPU tensors) against the reference's Pallas kernel in
  interpret mode and its oracle, on ``tests/test_paged_kernels.py``'s case
  (block size 4, table width 6, 32 pool blocks, scrambled tables, lengths
  [10, 3, 24]) at its latent dims and at the reduced deepseek-v2-lite's;
- ``mla_forward`` (decompressed form through ``flash_attention`` with key
  dims nope + rope and value dims v_head_dim), ``mla_decode`` (absorbed
  form, dense latent cache);
- the whole reduced deepseek-v2-lite-16b (MLA + a dense and a MoE FFN):
  ``decode_step_paged`` and ``prefill_chunk_paged``, fused and composed,
  logits and latent pools;
- the weight bridge on a bfloat16 MLA + MoE tree and the MLA decode's
  work model.

Params are the reference's ``init_*`` in float32, carried over by the
weight bridge; inputs are made with numpy from a seed.  Tolerances: 2e-5
for the kernel's plain version (the reference's kernel tolerance), 1e-4
for layers and whole steps (matmul and softmax sums in another order).
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
from repro.kernels import ref  # noqa: E402
from repro.kernels.paged_decode_attention import \
    paged_mla_decode_attention as pallas_mla  # noqa: E402
from repro.models import mla as jax_mla  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core.tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.kernels import paged_decode_attention as pda  # noqa: E402
from repro_torch.kernels import perf_model as pm  # noqa: E402
from repro_torch.models import mla  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.attention import DecodePosition  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402

ARCH = "deepseek-v2-lite-16b"
BS, W, N = 4, 6, 32
TOL = 1e-4


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _maxdiff(a, b):
    if torch.is_tensor(a):
        a = a.float().numpy()
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


def _tables(batch):
    perm = np.random.RandomState(0).permutation(N - 1)[:batch * W] + 1
    return perm.reshape(batch, W).astype(np.int32)


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5),
                                       ("bfloat16", 3e-2)])
@pytest.mark.parametrize("H,R,r", [(4, 16, 8), (4, 64, 32)])
def test_mla_decode_plain_matches_oracle_and_pallas(H, R, r, dtype, tol):
    rng = np.random.default_rng(R)
    B = 3
    lengths = np.asarray([10, 3, 24], np.int32)
    arrays = [rng.standard_normal(s).astype(np.float32) * 0.3
              for s in ((B, H, R), (B, H, r), (N, BS, R), (N, BS, r))]
    tdt = getattr(torch, dtype)
    targs = [torch.from_numpy(a).to(tdt) for a in arrays]
    jargs = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrays]
    tables = _tables(B)
    scale = (R + r) ** -0.5
    got = pda.paged_mla_decode_attention(
        *targs, _t(tables), _t(lengths), block_size=BS, scale=scale)
    assert got.shape == (B, H, R) and got.dtype == torch.float32
    kw = dict(block_size=BS, scale=scale)
    want = ref.paged_mla_decode_attention(*jargs, jnp.asarray(tables),
                                          jnp.asarray(lengths), **kw)
    assert _maxdiff(got, want) < tol
    pallas = pallas_mla(*jargs, jnp.asarray(tables), jnp.asarray(lengths),
                        interpret=True, **kw)
    assert _maxdiff(got, pallas) < tol


@functools.cache
def _models():
    jcfg = dataclasses.replace(jax_get_config(ARCH).reduced(),
                               dtype="float32")
    cfg = dataclasses.replace(get_config(ARCH).reduced(), dtype="float32")
    jp = JM.init_model(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                            "cpu")


def _attn_params(jp, tp, layer=0):
    """The first segment's MLA params of one layer, both frameworks."""
    return (jax.tree.map(lambda a: a[layer], jp["seg0"][0]["attn"]),
            tree_map(lambda a: a[layer], tp["seg0"][0]["attn"]))


def test_mla_forward_and_dense_decode_match_reference():
    jcfg, cfg, jp, tp = _models()
    pj, pt = _attn_params(jp, tp)
    rng = np.random.default_rng(5)
    B, S = 2, 13
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    yj, cj = jax_mla.mla_forward(pj, jnp.asarray(x), jnp.arange(S), jcfg,
                                 return_cache=True)
    with torch.no_grad():
        yt, ct = mla.mla_forward(pt, _t(x), torch.arange(S), cfg,
                                 return_cache=True)
    assert _maxdiff(yt, yj) < TOL
    for name in ("ckv", "krope"):
        assert _maxdiff(ct[name], cj[name]) < TOL
    # absorbed decode against a dense latent cache, token by token
    L = 16
    jc = jax_mla.init_mla_cache(jcfg, B, L, jnp.float32)
    tc = mla.init_mla_cache(cfg, B, L, torch.float32, "cpu")
    for pos in range(6):
        xs = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        yj, jc = jax_mla.mla_decode(pj, jnp.asarray(xs), pos, jcfg, jc)
        with torch.no_grad():
            yt = mla.mla_decode(pt, _t(xs), DecodePosition(pos, B, "cpu"),
                                cfg, tc)
        assert _maxdiff(yt, yj) < TOL
    for name in ("ckv", "krope"):
        assert _maxdiff(tc[name], jc[name]) < TOL


def _pools(cfg, rng):
    m = cfg.mla
    return {f"seg{si}": ({
        "ckv": rng.standard_normal((1, N, BS, m.kv_lora_rank)).astype(
            np.float32),
        "krope": rng.standard_normal((1, N, BS, m.qk_rope_head_dim)).astype(
            np.float32)},) for si in range(2)}


def _assert_same(lj, pj, lt, pt, rows=slice(None)):
    assert np.asarray(lj)[rows].shape == lt.numpy()[rows].shape
    assert _maxdiff(lt[rows], np.asarray(lj)[rows]) < TOL
    for a, b in zip(jax.tree.leaves(pj), tree_leaves(pt)):
        # outside the null block 0, which takes the padding writes
        assert _maxdiff(b[:, 1:], np.asarray(a)[:, 1:]) < TOL


@pytest.mark.parametrize("kernels", ["composed", "fused"])
def test_paged_steps_match_reference(kernels):
    """One decode step (three seats at mixed positions) and one batched
    prefill call (a partial row, a middle chunk and a filler row) of the
    whole model, MLA latent pools and MoE FFN included."""
    jcfg, cfg, jp, tp = _models()
    assert [f for _, f in cfg.block_kinds()] == ["dense", "moe"]
    rng = np.random.default_rng(6)
    tables = _tables(3)
    pools = _pools(cfg, rng)
    positions = np.asarray([5, 0, 13], np.int32)
    tokens = rng.integers(1, cfg.vocab_size, size=(3, 1)).astype(np.int32)
    lj, pj = JM.decode_step_paged(
        jp, jnp.asarray(tokens), jnp.asarray(positions), jcfg,
        jax.tree.map(jnp.asarray, pools), jnp.asarray(tables),
        block_size=BS, kernels=kernels, moe_dispatch="ragged")
    tpools = tree_map(lambda a: torch.from_numpy(a.copy()), pools)
    with torch.no_grad():
        lt = M.decode_step_paged(
            tp, _t(tokens), _t(positions), cfg, tpools, _t(tables),
            block_size=BS, kernels=kernels)
    _assert_same(lj, pj, lt, tpools)

    C = 8
    starts = np.asarray([0, 8, 0], np.int32)
    limits = np.asarray([6, 21, 0], np.int32)
    slots = np.asarray([0, 1, 4], np.int32)
    tokens = rng.integers(1, cfg.vocab_size, size=(3, C)).astype(np.int32)
    lj, pj = JM.prefill_chunk_paged(
        jp, jnp.asarray(tokens), jnp.asarray(starts), jnp.asarray(limits),
        jnp.asarray(slots), jcfg, jax.tree.map(jnp.asarray, pools),
        jnp.asarray(tables), block_size=BS, kernels=kernels,
        moe_dispatch="ragged")
    tpools = tree_map(lambda a: torch.from_numpy(a.copy()), pools)
    with torch.no_grad():
        lt = M.prefill_chunk_paged(
            tp, _t(tokens), _t(starts), _t(limits), _t(slots), cfg, tpools,
            _t(tables), block_size=BS, kernels=kernels)
    # MLA prefill is composed on both sides: filler rows attend the null
    # block and their logits are discarded, so live rows are compared
    _assert_same(lj, pj, lt, tpools, rows=slice(0, 2))


def test_bridge_keeps_the_router_in_f32():
    """A bfloat16 MLA + MoE tree maps leaf to leaf with ``dtype`` given:
    every leaf equal and of the reference's type, the f32 router too."""
    jcfg = jax_get_config(ARCH).reduced()                    # bfloat16
    jp = JM.init_model(jcfg, jax.random.PRNGKey(1))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu",
                           dtype=torch.bfloat16)
    jflat = jax.tree_util.tree_leaves_with_path(jp)
    assert len(jflat) == len(tree_leaves(tp))
    names = set()
    for path, leaf in jflat:
        node = tp
        for k in path:
            node = node[getattr(k, "key", getattr(k, "idx", None))]
            names.add(getattr(k, "key", None))
        assert tuple(node.shape) == leaf.shape
        assert str(node.dtype).split(".")[-1] == str(leaf.dtype)
        assert np.array_equal(node.float().numpy(),
                              np.asarray(leaf, np.float32))
    assert {"router", "w_dkv", "kv_norm", "w_uk", "w_uv", "ws_gate"} <= names
    assert tp["seg1"][0]["ffn"]["router"].dtype == torch.float32


def test_mla_decode_work_model():
    lengths = [10, 3, 24]
    cost = pm.paged_mla_decode_cost(lengths, num_heads=4, kv_lora_rank=16,
                                    rope_dim=8, itemsize=2)
    keys = 37
    assert cost.flops == 2 * 4 * (2 * 16 + 8) * keys
    assert cost.hbm_bytes == (keys * 24 * 2 + 3 * 4 * 24 * 2
                              + 3 * 4 * 16 * 4 + 3 * 4)
    assert cost.bound_by("bfloat16") == "bytes"


def test_init_model_tree_matches_reference():
    """The port's ``init_model`` for the bfloat16 deepseek-v2-lite makes
    the reference's tree: the same leaves, shapes and dtypes (the MoE
    router in f32), stacked per segment."""
    cfg = get_config(ARCH).reduced()
    tp = M.init_model(cfg, torch.Generator().manual_seed(2))
    jp = jax.eval_shape(lambda: JM.init_model(jax_get_config(ARCH).reduced(),
                                              jax.random.PRNGKey(0)))
    jflat = jax.tree_util.tree_leaves_with_path(jp)
    assert len(jflat) == len(tree_leaves(tp))
    for path, leaf in jflat:
        node = tp
        for k in path:
            node = node[getattr(k, "key", getattr(k, "idx", None))]
        assert tuple(node.shape) == leaf.shape
        assert str(node.dtype).split(".")[-1] == str(leaf.dtype)
