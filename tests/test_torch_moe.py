"""The port's MoE FFN and its grouped-matmul kernel against the reference.

- ``grouped_matmul``: the port's plain version (what the wrapper runs for
  CPU tensors) against the reference's Pallas kernel in interpret mode and
  its oracle ``ref.grouped_matmul``, at the shapes of
  ``tests/test_kernels.py`` (group sizes drawn so that some are empty) and
  its empty-groups case;
- ``ragged_moe_apply`` and ``moe_forward`` (dispatch ``"ragged"``, shared
  experts, the router's loss terms) against the reference on the same
  params, carried over by the weight bridge;
- the GShard capacity dispatch (``"gshard"``, the train step's): outputs,
  router metrics and gradients against ``jax.grad``, with capacity drops;
- the expert-stack initialiser and the grouped matmul's work model.

Inputs are made with numpy from a seed and handed to both frameworks.
Tolerances: 2e-5 in float32 (the sums run in another order; the reference's
own, ``tests/test_kernels.py``), 3e-2 in bfloat16 (the reference's own).
The CUDA kernel itself runs only on the card (``tests/test_torch_cuda.py``).
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
from repro.core.overlap import \
    ragged_moe_apply as jax_ragged_moe_apply  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro.kernels.grouped_matmul import \
    grouped_matmul as pallas_grouped_matmul  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core.overlap import ragged_moe_apply  # noqa: E402
from repro_torch.kernels import grouped_matmul as gm  # noqa: E402
from repro_torch.kernels import ops, perf_model as pm  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402

DTYPES = {"float32": (torch.float32, jnp.float32, 2e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 3e-2)}


def _both(a, dtype):
    tdt, jdt, _ = DTYPES[dtype]
    return torch.from_numpy(a).to(tdt), jnp.asarray(a).astype(jdt)


def _maxdiff(a, b):
    return float(np.max(np.abs(a.float().numpy()
                               - np.asarray(b, np.float32))))


def _sizes(rng, T, E):
    """Group sizes summing to T with about a third of the groups empty."""
    live = rng.random(E) > 0.35
    live[rng.integers(E)] = True
    cuts = np.sort(rng.integers(0, T + 1, int(live.sum()) - 1))
    sizes = np.zeros(E, np.int32)
    sizes[live] = np.diff(np.concatenate([[0], cuts, [T]]))
    return sizes


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("T,D,F,E", [(512, 64, 128, 4), (1024, 128, 64, 8),
                                     (256, 256, 256, 2)])
def test_grouped_matmul_plain_matches_oracle_and_pallas(T, D, F, E, dtype):
    rng = np.random.default_rng(T + E)
    x, xj = _both(rng.standard_normal((T, D)).astype(np.float32) * 0.3, dtype)
    w, wj = _both(rng.standard_normal((E, D, F)).astype(np.float32) * 0.3,
                  dtype)
    sizes = _sizes(rng, T, E)
    got = gm.grouped_matmul(x, w, torch.from_numpy(sizes))
    assert got.shape == (T, F) and got.dtype == DTYPES[dtype][0]
    tol = DTYPES[dtype][2]
    want = ref.grouped_matmul(xj, wj, jnp.asarray(sizes))
    assert _maxdiff(got, want) < tol
    pallas = pallas_grouped_matmul(xj, wj, jnp.asarray(sizes),
                                   interpret=True, block_t=128)
    assert _maxdiff(got, pallas) < tol


def test_grouped_matmul_empty_groups():
    """tests/test_kernels.py's case: every row in one expert, the other
    groups empty; sizes summing below the rows leave the rows past the sum
    zeros (they belong to no expert: the expert-parallel dispatch's rows of
    other ranks' experts), and sizes summing past them are refused."""
    x = torch.ones(128, 32)
    w = torch.ones(4, 32, 16)
    sizes = np.array([0, 128, 0, 0], np.int32)
    got = gm.grouped_matmul(x, w, torch.from_numpy(sizes))
    want = pallas_grouped_matmul(jnp.ones((128, 32)), jnp.ones((4, 32, 16)),
                                 jnp.asarray(sizes), interpret=True,
                                 block_t=64)
    assert _maxdiff(got, want) < 1e-5
    assert _maxdiff(got, ref.grouped_matmul(jnp.ones((128, 32)),
                                            jnp.ones((4, 32, 16)),
                                            jnp.asarray(sizes))) < 1e-5
    assert gm.grouped_matmul(x[:0], w, torch.zeros(4, dtype=torch.int32)
                             ).shape == (0, 16)
    part = gm.grouped_matmul(x, w, torch.tensor([0, 100, 0, 0]))
    assert torch.equal(part[:100], got[:100])
    assert torch.equal(part[100:], torch.zeros(28, 16))
    with pytest.raises(ValueError, match="sum to 200"):
        gm.grouped_matmul(x, w, torch.tensor([0, 100, 100, 0]))


@functools.cache
def _moe_models(arch):
    """Reduced config in float32 and the reference's MoE params of one
    layer, bridged to the port."""
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(),
                               dtype="float32")
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    jp = jax_moe.init_moe(jcfg, jax.random.PRNGKey(3))
    return jcfg, cfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                            "cpu")


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b",
                                  "deepseek-moe-16b"])
def test_ragged_moe_apply_and_moe_forward_match_reference(arch):
    jcfg, cfg, jp, tp = _moe_models(arch)
    rng = np.random.default_rng(4)
    B, S, D = 3, 7, cfg.d_model
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    # the routed-expert sum on its own, from the same routing
    T, k, E = B * S, cfg.moe.top_k, cfg.moe.num_experts
    idx = np.stack([rng.permutation(E)[:k] for _ in range(T)]).astype(
        np.int64)
    gates = rng.random((T, k)).astype(np.float32)
    got = ragged_moe_apply(tp, torch.from_numpy(x.reshape(T, D)),
                           torch.from_numpy(idx), torch.from_numpy(gates),
                           cfg)
    want = jax_ragged_moe_apply(jp, jnp.asarray(x.reshape(T, D)),
                                jnp.asarray(idx), jnp.asarray(gates), jcfg)
    assert _maxdiff(got, want) < 2e-5
    # the whole FFN: router, top-k, ragged dispatch, shared experts, metrics
    with torch.no_grad():
        y, metrics = moe.moe_forward(tp, torch.from_numpy(x), cfg)
        y2, none = moe.moe_forward(tp, torch.from_numpy(x), cfg,
                                   metrics=False)
    yj, mj = jax_moe.moe_forward(jp, jnp.asarray(x), jcfg, dispatch="ragged")
    assert y.shape == (B, S, D)
    assert _maxdiff(y, yj) < 2e-5
    assert torch.equal(y, y2) and none == {}
    assert sorted(metrics) == sorted(mj)
    for name in mj:
        assert abs(float(metrics[name]) - float(mj[name])) < 1e-5, name


def test_training_dispatches_name_the_roadmap_item():
    """``dp_local`` with no mesh falls back to the ragged dispatch, as the
    reference's does (``repro/models/moe.py:75-92``): the same output and
    metrics, bit for bit; an unknown name is refused."""
    _, cfg, _, tp = _moe_models("deepseek-moe-16b")
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 8, cfg.d_model)).astype(np.float32))
    y, m = moe.moe_forward(tp, x, cfg, dispatch="dp_local")
    y_r, m_r = moe.moe_forward(tp, x, cfg, dispatch="ragged")
    assert torch.equal(y, y_r) and sorted(m) == sorted(m_r)
    assert all(torch.equal(m[k], m_r[k]) for k in m)
    with pytest.raises(ValueError, match="must be one of"):
        moe.moe_forward(tp, x, cfg, dispatch="dense")


def _capacity_drops(cfg, idx):
    """Routed (token, slot) pairs GShard drops for lack of room: per group
    of ``moe._group(T)`` tokens, each expert's count past its capacity."""
    mo = cfg.moe
    T, k = idx.shape
    G = moe._group(T)
    C = max(1, int(G * k / mo.num_experts * mo.capacity_factor))
    counts = np.stack([np.bincount(g.reshape(-1), minlength=mo.num_experts)
                       for g in idx.reshape(T // G, G * k)])
    return int(np.maximum(counts - C, 0).sum())


@pytest.mark.parametrize("B,S,skew", [(3, 7, False), (2, 64, True),
                                      (1, 1024, True)])
def test_gshard_dispatch_matches_reference(B, S, skew):
    """The reference's default dispatch on reduced deepseek-v2-lite in
    float32: the FFN's output, its three router metrics and the gradients
    of every MoE param and of the input against ``jax.grad``, at token
    counts of one group (21, 128) and of two groups of 512.  ``skew``
    leans every token toward expert 0, so that the capacity C drops
    routed tokens (counted from the router's choices)."""
    jcfg, cfg, jp, tp = _moe_models("deepseek-v2-lite-16b")
    rng = np.random.default_rng(B * S)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    if skew:
        lean = np.asarray(jp["router"])[:, 0]
        x += (4.0 * lean / np.linalg.norm(lean)).astype(np.float32)
    r = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    names = ("moe_aux_loss", "moe_z_loss", "router_entropy")

    def jloss(p, xx):
        y, m = jax_moe.moe_forward(p, xx, jcfg, dispatch="gshard")
        return jnp.sum(y * r) + sum(m[n] for n in names), (y, m)
    (_, (yj, mj)), (gpj, gxj) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(x))

    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_()
    y, m = moe.moe_forward(leaves, xt, cfg, dispatch="gshard")
    loss = (y * torch.from_numpy(r)).sum() + sum(m[n] for n in names)
    grads = torch.autograd.grad(loss, [*leaves.values(), xt])
    assert _maxdiff(y.detach(), yj) < 2e-5
    for n in names:
        assert abs(float(m[n].detach()) - float(mj[n])) < 1e-5, n
    for (k, g) in zip([*leaves, "x"], grads):
        want = np.asarray(gxj if k == "x" else gpj[k])
        assert np.max(np.abs(g.numpy() - want)) <= \
            1e-5 * max(1.0, float(np.abs(want).max())), k
    with torch.no_grad():
        probs, _ = moe.router_probs(tp, torch.from_numpy(x).reshape(B * S, -1),
                                    cfg)
        idx = torch.topk(probs, cfg.moe.top_k, dim=-1)[1].numpy()
    if skew:
        assert _capacity_drops(cfg, idx) > 0


def test_expert_stacks_draw_per_layer_in_the_model_dtype():
    """The routed experts are drawn one layer at a time into a stack of
    the model's dtype with the reference's scale; the router stays f32."""
    cfg = get_config("deepseek-v2-lite-16b").reduced()      # bfloat16
    p = moe.init_moe(cfg, torch.Generator().manual_seed(0), lead=(3,))
    E, d, F = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff_expert
    assert p["router"].dtype == torch.float32
    assert p["w_gate"].shape == (3, E, d, F)
    assert p["w_down"].shape == (3, E, F, d)
    assert p["w_gate"].dtype == torch.bfloat16
    std = float(p["w_up"].float().std())
    assert abs(std / (2.0 / (d + F)) ** 0.5 - 1) < 0.05
    assert not torch.equal(p["w_gate"][0], p["w_gate"][1])


def test_ops_dispatch_and_work_model():
    x, w = torch.randn(6, 16), torch.randn(3, 16, 8)
    sizes = torch.tensor([2, 0, 4], dtype=torch.int32)
    ops.set_mode("ref")
    try:
        a = ops.grouped_matmul(x, w, sizes)
    finally:
        ops.set_mode("auto")
    assert torch.equal(a, ops.grouped_matmul(x, w, sizes))
    cost = pm.grouped_matmul_cost([2, 0, 4], d_in=16, d_out=8, itemsize=2)
    assert cost.flops == 2 * 6 * 16 * 8
    # rows of x, two live experts' weights, the output rows, the sizes
    assert cost.hbm_bytes == (6 * 16 + 2 * 16 * 8 + 6 * 8) * 2 + 3 * 4
    assert pm.grouped_matmul_cost([0, 0, 0], d_in=16, d_out=8,
                                  itemsize=2).hbm_bytes == 12
