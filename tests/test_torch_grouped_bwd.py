"""The grouped matmul's backward (ROADMAP 2.9b) against the reference, on
the CPU.

- ``grouped_matmul_bwd_ref`` (the plain version the wrapper runs for CPU
  tensors) against autograd through the differentiable plain forward and
  ``jax.vjp`` of the reference's oracle ``ref.grouped_matmul``, with empty
  groups and one-expert groups, in float32 within 2e-5 x max(1, max
  |grad|) (the sums over a group's rows in another order);
- ``GroupedMatmulFn``: a gradient through ``grouped_matmul`` on CPU
  tensors is the plain backward's, bit for bit, and counts no launch; the
  bf16 plain backward rounds its f32 result once;
- the backward's work model counted by hand;
- a train step under the ragged dispatch of reduced deepseek-v2-lite-16b
  (MLA + MoE) and deepseek-moe-16b against the reference's ragged step
  from the same bridged params (``tests/test_torch_serve.py``'s cached
  models) and batches: loss within 1e-5, the history
  (loss, grad norm) within 1e-4 relative over three steps, as the gshard
  steps of ``tests/test_torch_train.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from repro.data import pipeline as jax_pipeline  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.optim import adamw as jax_opt  # noqa: E402
from repro.train import steps as jax_steps  # noqa: E402
from repro_torch.kernels import grouped_matmul as gm  # noqa: E402
from repro_torch.kernels import perf_model as pm  # noqa: E402
from repro_torch.models.bridge import adamw_state_from_numpy  # noqa: E402
from repro_torch.optim import adamw as opt  # noqa: E402
from repro_torch.train import steps  # noqa: E402
from test_torch_serve import _models  # noqa: E402

SIZES = [
    [3, 0, 7, 0, 0, 5],          # empty groups between live ones
    [0, 0, 9, 0],                # one expert takes every row
    [11],                        # a single group
    [1, 1, 0, 2, 0, 0, 6, 1],    # one-row groups
]
RAGGED_ARCHS = ("deepseek-v2-lite-16b", "deepseek-moe-16b")
RAGGED_STEPS = 3


def _inputs(sizes, D, F, seed):
    rng = np.random.default_rng(seed)
    T = sum(sizes)
    x = rng.standard_normal((T, D)).astype(np.float32)
    w = (rng.standard_normal((len(sizes), D, F)) / D ** 0.5).astype(
        np.float32)
    dy = rng.standard_normal((T, F)).astype(np.float32)
    return x, w, np.asarray(sizes, np.int32), dy


def _close(got, want):
    want = np.asarray(want)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    return np.max(np.abs(got - want), initial=0.0) <= \
        2e-5 * max(1.0, float(np.max(np.abs(want), initial=0.0)))


@pytest.mark.parametrize("sizes", SIZES)
def test_grouped_bwd_plain_matches_autograd_and_jax(sizes):
    x, w, gs, dy = _inputs(sizes, 24, 16, len(sizes))
    tx, tw = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    tgs, tdy = torch.from_numpy(gs), torch.from_numpy(dy)
    dx, dw = gm.grouped_matmul_bwd_ref(tx.detach(), tw.detach(), tgs, tdy)
    ax, aw = torch.autograd.grad(gm.grouped_matmul_ref(tx, tw, tgs),
                                 [tx, tw], tdy)
    _, vjp = jax.vjp(lambda a, b: jax_ref.grouped_matmul(a, b,
                                                         jnp.asarray(gs)),
                     jnp.asarray(x), jnp.asarray(w))
    jx, jw = vjp(jnp.asarray(dy))
    for got, want in ((dx, ax), (dx, jx), (dw, aw), (dw, jw)):
        assert _close(got, want.numpy() if torch.is_tensor(want) else want)
    empty = [e for e, n in enumerate(sizes) if n == 0]
    assert not dw[empty].any()


def test_grouped_matmul_fn_on_cpu_is_the_plain_backward():
    """Through the wrapper with a gradient recorded: GroupedMatmulFn, the
    plain backward bit for bit, no launch counted; without one the plain
    forward, no graph.  bf16 rounds the f32 backward once."""
    x, w, gs, dy = (torch.from_numpy(a) for a in _inputs(SIZES[0], 32, 16, 3))
    leaves = [x.clone().requires_grad_(), w.clone().requires_grad_()]
    counts = (gm.grouped_matmul, gm.grouped_matmul_bwd_dx,
              gm.grouped_matmul_bwd_dw)
    n0 = [f.launches for f in counts]
    y = gm.grouped_matmul(*leaves, gs)
    assert y.grad_fn is not None and "GroupedMatmulFn" in type(
        y.grad_fn).__name__
    got = torch.autograd.grad(y, leaves, dy)
    want = gm.grouped_matmul_bwd(x, w, gs, dy)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with torch.no_grad():
        assert gm.grouped_matmul(*leaves, gs).grad_fn is None
    assert [f.launches for f in counts] == n0
    bf = gm.grouped_matmul_bwd_ref(x.bfloat16(), w.bfloat16(), gs,
                                   dy.bfloat16())
    f32 = gm.grouped_matmul_bwd_ref(x.bfloat16().float(),
                                    w.bfloat16().float(), gs,
                                    dy.bfloat16().float())
    assert all(torch.equal(a, b.bfloat16()) for a, b in zip(bf, f32))


def test_grouped_bwd_plain_sizes_summing_below_the_rows():
    """Sizes summing to S < T: the plain dw takes them (the rows past S,
    NaN here, belong to no expert) and equals jax.vjp's dw over the first S
    rows; the plain dx, whose contract is the forward's (sizes summing to
    at most T, the rows past the sum zeros), gives jax.vjp's dx on the
    first S rows and zeros past them; both refuse sizes summing past the
    rows."""
    sizes = SIZES[0]
    x, w, gs, dy = _inputs(sizes, 24, 16, 7)
    S = sum(sizes)
    tx = torch.from_numpy(np.concatenate([x, np.full((4, 24), np.nan,
                                                     np.float32)]))
    tdy = torch.from_numpy(np.concatenate([dy, np.full((4, 16), np.nan,
                                                       np.float32)]))
    tgs = torch.from_numpy(gs)
    dw = gm.grouped_matmul_bwd_dw_ref(tx, tdy, tgs)
    _, vjp = jax.vjp(lambda b: jax_ref.grouped_matmul(jnp.asarray(x), b,
                                                      jnp.asarray(gs)),
                     jnp.asarray(w))
    assert bool(dw.isfinite().all()) and _close(dw, vjp(jnp.asarray(dy))[0])
    assert torch.equal(dw, gm.grouped_matmul_bwd_dw_ref(tx[:S], tdy[:S],
                                                        tgs))
    dx = gm.grouped_matmul_bwd_dx_ref(tdy, torch.from_numpy(w), tgs)
    _, vjp_x = jax.vjp(lambda a: jax_ref.grouped_matmul(a, jnp.asarray(w),
                                                        jnp.asarray(gs)),
                       jnp.asarray(x))
    assert _close(dx[:S], vjp_x(jnp.asarray(dy))[0])
    assert torch.equal(dx[S:], torch.zeros(4, 24))
    with pytest.raises(ValueError, match="sum to 15, dy has 11 rows"):
        gm.grouped_matmul_bwd_dx_ref(tdy[:11], torch.from_numpy(w), tgs)
    with pytest.raises(ValueError, match="sum to 15, x has 11 rows"):
        gm.grouped_matmul_bwd_dw_ref(tx[:11], tdy[:11], tgs)


def test_grouped_bwd_cost_counts_the_work_by_hand():
    sizes, D, F = [2, 0, 4], 16, 8
    dx = pm.grouped_matmul_bwd_cost(sizes, d_in=D, d_out=F, itemsize=2,
                                    part="dx")
    dw = pm.grouped_matmul_bwd_cost(sizes, d_in=D, d_out=F, itemsize=2,
                                    part="dw")
    assert dx.flops == dw.flops == 2 * 6 * D * F
    # dy's rows, two live experts' weights, dx's rows; the sizes
    assert dx.hbm_bytes == (6 * F + 2 * D * F + 6 * D) * 2 + 3 * 4
    # x's and dy's rows, all three experts' dw (the empty one's zeros)
    assert dw.hbm_bytes == (6 * D + 6 * F + 3 * D * F) * 2 + 3 * 4
    with pytest.raises(ValueError, match="part"):
        pm.grouped_matmul_bwd_cost(sizes, d_in=D, d_out=F, itemsize=2,
                                   part="dy")


@pytest.mark.parametrize("arch", RAGGED_ARCHS)
def test_ragged_train_steps_match_reference(arch):
    """RAGGED_STEPS train steps under ``moe_dispatch="ragged"`` from the
    same params, on the reference's packed batches: the port's (autograd
    through GroupedMatmulFn, the plain backward on the CPU) against the
    reference's (jax.grad of its grouped-matmul oracle)."""
    jcfg, cfg, jp, tp = _models(arch)
    jo = jax_opt.init_adamw(jp)
    to = adamw_state_from_numpy(jax.tree.map(np.asarray, jo), "cpu")
    acfg = dict(total_steps=RAGGED_STEPS)
    jstep, _ = jax_steps.make_train_step(
        jcfg, None, None, jax_opt.AdamWConfig(**acfg), moe_dispatch="ragged",
        donate=False)
    tstep = steps.make_train_step(cfg, opt.AdamWConfig(**acfg),
                                  moe_dispatch="ragged")
    batches = jax_pipeline.PackedBatches(jax_pipeline.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=16, global_batch=2, seed=0))
    for _ in range(RAGGED_STEPS):
        batch = next(batches)
        jp, jo, jm = jstep(jp, jo, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        tp, to, tm = tstep(tp, to, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
        assert abs(float(jm["loss"]) - float(tm["loss"])) <= 1e-5 * max(
            1.0, abs(float(jm["loss"])))
        for k in ("loss", "grad_norm", "moe_aux_loss", "moe_z_loss"):
            assert abs(float(jm[k]) - float(tm[k])) <= 1e-4 * max(
                1.0, abs(float(jm[k]))), k
