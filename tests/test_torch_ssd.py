"""The port's Mamba-2 SSD slice against the reference, on the CPU.

- ``ssd_scan_ref`` (the plain version the wrapper runs for CPU tensors)
  against the oracle ``ref.ssd_scan``, with and without ``init_state`` and
  with dt = 0 tails (a prompt's padding), in float32 within 2e-5 and in
  bfloat16 within the reference's 3e-2; and against the Pallas kernel in
  interpret mode at ``tests/test_kernels.py::test_ssd_scan``'s three shapes,
  within its 1e-3;
- ``ssd_decode_step``, ``causal_conv1d`` and ``conv1d_decode_step``;
- ``mamba2_forward``, ``mamba2_decode`` and ``mamba2_prefill_chunk`` of the
  reduced mamba2-370m (bridged float32 params), the last with padded tails
  and a filler row whose writes must not reach any live seat;
- ``StatePool``'s seat operations, which touch only their seat and only
  slot leaves, and the SSD scan's work model counted by hand.

Inputs are made with numpy from a seed.  Layers compare within 1e-4
(matmul sums in another order).
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
from repro.kernels.ssd_scan import ssd_scan as pallas_ssd_scan  # noqa: E402
from repro.models import common as jax_common  # noqa: E402
from repro.models import mamba2 as jax_m2  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.kernels import ops, perf_model as pm  # noqa: E402
from repro_torch.kernels import ssd_scan as ss  # noqa: E402
from repro_torch.models import common, mamba2  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402
from repro_torch.serve.paged_kv import PagedKVConfig, StatePool  # noqa: E402

ARCH = "mamba2-370m"
TOL = 1e-4


def _maxdiff(a, b):
    if torch.is_tensor(a):
        a = a.float().numpy()
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


def _scan_inputs(B, S, H, P, N, seed, *, init=False, tail=0):
    """x, dt, A, Bm, Cm (and init_state) at the reference test's scales;
    the last ``tail`` positions of row 0 get dt = 0 (padding)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32) * 0.3
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    if tail:
        dt[0, S - tail:] = 0.0
    A = -np.exp(rng.standard_normal(H) * 0.3).astype(np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32) * 0.3
    Cm = rng.standard_normal((B, S, N)).astype(np.float32) * 0.3
    s0 = (rng.standard_normal((B, H, P, N)).astype(np.float32)
          if init else None)
    return x, dt, A, Bm, Cm, s0


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5),
                                       ("bfloat16", 3e-2)])
@pytest.mark.parametrize("B,S,H,P,N,Q,init,tail", [
    (2, 64, 4, 32, 16, 32, False, 0),
    (2, 64, 4, 32, 16, 32, True, 0),
    (3, 96, 2, 32, 16, 32, True, 40),       # padding across a chunk edge
    (2, 100, 2, 32, 16, 100, True, 7),      # Q = 100: no power of two
    (1, 24, 2, 16, 8, 8, False, 24),        # all padding: the state passes
])
def test_ssd_scan_plain_matches_oracle(B, S, H, P, N, Q, init, tail, dtype,
                                       tol):
    arrays = _scan_inputs(B, S, H, P, N, seed=S + Q, init=init, tail=tail)
    x, dt, A, Bm, Cm, s0 = arrays
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got_y, got_s = ss.ssd_scan_ref(
        torch.from_numpy(x).to(tdt), torch.from_numpy(dt),
        torch.from_numpy(A), torch.from_numpy(Bm).to(tdt),
        torch.from_numpy(Cm).to(tdt), chunk=Q,
        init_state=None if s0 is None else torch.from_numpy(s0).to(tdt))
    want_y, want_s = ref.ssd_scan(
        jnp.asarray(x).astype(jdt), jnp.asarray(dt), jnp.asarray(A),
        jnp.asarray(Bm).astype(jdt), jnp.asarray(Cm).astype(jdt), chunk=Q,
        init_state=None if s0 is None else jnp.asarray(s0).astype(jdt))
    assert got_y.dtype == got_s.dtype == tdt
    assert _maxdiff(got_y, want_y) < tol
    assert _maxdiff(got_s, want_s) < tol
    if tail == S and s0 is not None:
        # dt = 0 everywhere: decay 1, no input, the state passes through
        assert torch.equal(got_s[0], torch.from_numpy(s0[0]).to(tdt))


@pytest.mark.parametrize("B,S,H,P,N,Q", [(2, 256, 4, 32, 16, 64),
                                         (1, 128, 2, 64, 32, 32),
                                         (2, 64, 8, 16, 8, 16)])
def test_ssd_scan_plain_matches_pallas(B, S, H, P, N, Q):
    """The reference kernel test's shapes, against the Pallas kernel in
    interpret mode, within that test's 1e-3."""
    x, dt, A, Bm, Cm, _ = _scan_inputs(B, S, H, P, N, seed=B * S + H)
    got_y, got_s = ss.ssd_scan(*(torch.from_numpy(a) for a in
                                 (x, dt, A, Bm, Cm)), chunk=Q)
    want_y, want_s = pallas_ssd_scan(*(jnp.asarray(a) for a in
                                       (x, dt, A, Bm, Cm)), chunk=Q,
                                     interpret=True)
    assert _maxdiff(got_y, want_y) < 1e-3 and _maxdiff(got_s, want_s) < 1e-3


def test_ssd_scan_wrapper_on_the_cpu_takes_the_plain_version():
    """A CPU tensor runs the plain version and counts no launch; ``ops``
    dispatches to the wrapper, and in ``ref`` mode to the plain version;
    an input that requires grad takes :class:`SSDScanFn`, whose gradient
    flows and matches autograd through the plain forward."""
    x, dt, A, Bm, Cm, s0 = (torch.from_numpy(a) for a in _scan_inputs(
        1, 32, 2, 32, 16, seed=5, init=True))
    n0 = ss.ssd_scan.launches
    want = ss.ssd_scan_ref(x, dt, A, Bm, Cm, chunk=16, init_state=s0)
    for mode in ("auto", "ref"):
        ops.set_mode(mode)
        try:
            got = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=16, init_state=s0)
        finally:
            ops.set_mode("auto")
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert ss.ssd_scan.launches == n0
    leaf = x.clone().requires_grad_()
    y, fin = ss.ssd_scan(leaf, dt, A, Bm, Cm, chunk=16)
    assert y.grad_fn is not None
    (got,) = torch.autograd.grad(y.sum() + fin.sum(), leaf)
    leaf2 = x.clone().requires_grad_()
    y2, fin2 = ss.ssd_scan_ref(leaf2, dt, A, Bm, Cm, chunk=16)
    (auto,) = torch.autograd.grad(y2.sum() + fin2.sum(), leaf2)
    assert _maxdiff(got, auto.numpy()) <= 2e-5 * max(
        1.0, float(auto.abs().max()))
    assert ss.ssd_scan.launches == n0 and ss.ssd_scan_bwd.launches == 0


def _ssd_vjp(arrays, dy, dfin, Q):
    """jax.vjp of the oracle ``ref.ssd_scan`` at ``arrays`` (x, dt, A, Bm,
    Cm, init_state or None) with output cotangents (dy, dfin or zeros)."""
    *ins, s0 = (None if a is None else jnp.asarray(a) for a in arrays)
    if s0 is None:
        fn = lambda *a: ref.ssd_scan(*a, chunk=Q)            # noqa: E731
    else:
        fn = lambda *a: ref.ssd_scan(*a[:5], chunk=Q,        # noqa: E731
                                     init_state=a[5])
        ins.append(s0)
    (_, fin), vjp = jax.vjp(fn, *ins)
    return vjp((jnp.asarray(dy), jnp.zeros_like(fin) if dfin is None
                else jnp.asarray(dfin)))


@pytest.mark.parametrize("B,S,H,P,N,Q,init,with_dfin", [
    (2, 64, 4, 32, 16, 32, False, False),
    (2, 64, 4, 32, 16, 32, False, True),
    (2, 64, 4, 32, 16, 32, True, True),
    (1, 100, 2, 16, 8, 100, True, False),   # Q = 100: no power of two
    (2, 48, 3, 8, 4, 16, True, True),
])
def test_ssd_scan_bwd_plain_matches_jax_vjp(B, S, H, P, N, Q, init,
                                            with_dfin):
    """``ssd_scan_bwd_ref`` against ``jax.vjp`` of the oracle, with dfin
    zero and not, with and without ``init_state``; each gradient within
    2e-5 x max(1, max |grad|) plus twice the plain version's own distance
    from its float64 evaluation (the decays' running sums, as the
    forward's limit); then autograd through the plain forward and
    :class:`SSDScanFn` on CPU tensors against the same."""
    arrays = _scan_inputs(B, S, H, P, N, seed=7 * S + Q, init=init)
    rng = np.random.default_rng(S + 1)
    dy = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dfin = (rng.standard_normal((B, H, P, N)).astype(np.float32)
            if with_dfin else None)
    want = _ssd_vjp(arrays, dy, dfin, Q)
    T = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    targs = [T(a) for a in arrays]
    got = ss.ssd_scan_bwd_ref(*targs[:5], T(dy), T(dfin), chunk=Q,
                              init_state=targs[5])
    got64 = ss.ssd_scan_bwd_ref(
        *(None if a is None else a.double() for a in targs[:5]),
        T(dy).double(), None if dfin is None else T(dfin).double(),
        chunk=Q, init_state=None if not init else targs[5].double(),
        acc=torch.float64)
    leaves = [t.clone().requires_grad_() for t in targs if t is not None]
    init_leaf = leaves[5] if init else None
    for fn in (ss.ssd_scan_ref, ss.ssd_scan):
        y, fin = fn(*leaves[:5], chunk=Q, init_state=init_leaf)
        loss = (y * T(dy)).sum()
        if dfin is not None:
            loss = loss + (fin * T(dfin)).sum()
        auto = torch.autograd.grad(loss, leaves)
        for g, a in zip(got, auto):
            assert _maxdiff(g, a.detach()) <= 2e-5 * max(
                1.0, float(a.abs().max()))
    assert got[5] is None if not init else got[5].shape == (B, H, P, N)
    for g, g64, w in zip(got, got64, want):
        if g is None:
            continue
        own = _maxdiff(g, g64.float())
        limit = 2e-5 * max(1.0, float(np.abs(np.asarray(w)).max())) \
            + 2 * own
        assert _maxdiff(g, w) <= limit


def test_decode_step_and_convs_match_reference():
    rng = np.random.default_rng(11)
    B, H, P, N, S, K, C = 3, 4, 8, 16, 9, 4, 24
    x = rng.standard_normal((B, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, H)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(H) * 0.3).astype(np.float32)
    Bm, Cm = (rng.standard_normal((B, N)).astype(np.float32)
              for _ in range(2))
    st = rng.standard_normal((B, H, P, N)).astype(np.float32)
    got = ops.ssd_decode_step(*(torch.from_numpy(a)
                                for a in (x, dt, A, Bm, Cm, st)))
    want = ref.ssd_decode_step(*(jnp.asarray(a)
                                 for a in (x, dt, A, Bm, Cm, st)))
    assert all(_maxdiff(g, w) < 2e-5 for g, w in zip(got, want))
    xs = rng.standard_normal((B, S, C)).astype(np.float32)
    w = rng.standard_normal((K, C)).astype(np.float32)
    cache = rng.standard_normal((B, K - 1, C)).astype(np.float32)
    for c in (None, cache):
        got = common.causal_conv1d(
            torch.from_numpy(xs), torch.from_numpy(w),
            cache=None if c is None else torch.from_numpy(c))
        want = jax_common.causal_conv1d(
            jnp.asarray(xs), jnp.asarray(w),
            cache=None if c is None else jnp.asarray(c))
        assert all(_maxdiff(g, v) < 2e-5 for g, v in zip(got, want))
    got = common.conv1d_decode_step(torch.from_numpy(xs[:, 0]),
                                    torch.from_numpy(w),
                                    torch.from_numpy(cache))
    want = jax_common.conv1d_decode_step(jnp.asarray(xs[:, 0]),
                                         jnp.asarray(w), jnp.asarray(cache))
    assert all(_maxdiff(g, v) < 2e-5 for g, v in zip(got, want))


@functools.cache
def _layer():
    """One SSD sublayer of the reduced mamba2-370m in float32: the
    reference's params and the bridged port params."""
    jcfg = dataclasses.replace(jax_get_config(ARCH).reduced(),
                               dtype="float32")
    cfg = dataclasses.replace(get_config(ARCH).reduced(), dtype="float32")
    jp = JM.init_model(jcfg, jax.random.PRNGKey(0))
    jl = jax.tree.map(lambda a: a[0], jp["seg0"][0]["mixer"])
    tl = params_from_numpy(jax.tree.map(np.asarray, jl), "cpu")
    return jcfg, cfg, jl, tl


def test_mamba2_forward_and_decode_match_reference():
    jcfg, cfg, jl, tl = _layer()
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    got, gcache = mamba2.mamba2_forward(tl, torch.from_numpy(x), cfg,
                                        return_cache=True)
    want, wcache = jax_m2.mamba2_forward(jl, jnp.asarray(x), jcfg,
                                         return_cache=True)
    assert _maxdiff(got, want) < TOL
    for k in ("state", "conv"):
        assert _maxdiff(gcache[k], wcache[k]) < TOL
    x1 = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    got, gnew = mamba2.mamba2_decode(tl, torch.from_numpy(x1), cfg, gcache)
    want, wnew = jax_m2.mamba2_decode(jl, jnp.asarray(x1), jcfg, wcache)
    assert _maxdiff(got, want) < TOL
    for k in ("state", "conv"):
        assert _maxdiff(gnew[k], wnew[k]) < TOL


def test_mamba2_prefill_chunk_matches_reference():
    """Four rows of a 16-token chunk: a first chunk, a middle chunk of a
    long prompt, a final partial chunk (padded tail) and a filler row (the
    null seat, limit 0).  The live rows' outputs and every seat's state
    and conv tail match the reference's; the filler's writes reach no live
    seat (the port's pool has one more row, the null seat)."""
    jcfg, cfg, jl, tl = _layer()
    n, C = 5, 16
    rng = np.random.default_rng(8)
    one = jax_m2.init_mamba2_cache(jcfg, n, jnp.float32)
    cache = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in one.items()}
    x = rng.standard_normal((4, C, cfg.d_model)).astype(np.float32)
    starts = np.array([0, 32, 48, 0], np.int32)
    limits = np.array([40, 100, 55, 0], np.int32)
    slots = np.array([3, 0, 4, n], np.int32)
    want, wcache = jax_m2.mamba2_prefill_chunk(
        jl, jnp.asarray(x), jnp.asarray(starts), jnp.asarray(limits),
        jnp.asarray(slots), jcfg, {k: jnp.asarray(v)
                                   for k, v in cache.items()})
    pool = {k: torch.from_numpy(np.concatenate(
        [v, np.zeros_like(v[:1])])) for k, v in cache.items()}
    got = mamba2.mamba2_prefill_chunk(
        tl, torch.from_numpy(x), *(torch.from_numpy(a) for a in
                                   (starts, limits, slots)), cfg, pool)
    assert _maxdiff(got[:3], np.asarray(want)[:3]) < TOL
    for k in ("state", "conv"):
        assert _maxdiff(pool[k][:n], wcache[k]) < TOL
        # seats 1 and 2 hold no row of this call: untouched, exactly
        assert np.array_equal(pool[k][1:3].numpy(), cache[k][1:3])


def test_state_pool_seat_operations_touch_only_their_seat():
    """``extract_slot``/``insert_slot``/``zero_slot`` move one seat's rows
    of every slot leaf, leave the other seats and the null seat alone, and
    a round trip restores the seat exactly."""
    cfg = get_config(ARCH).reduced()
    pool = StatePool(cfg, PagedKVConfig(block_size=4, num_blocks=8,
                                        dtype="float32"), num_slots=3,
                     device="cpu")
    leaves = pool.state["seg0"][0]
    assert leaves["state"].shape[:2] == (cfg.num_layers, 4)
    g = torch.Generator().manual_seed(0)
    for v in leaves.values():
        v.copy_(torch.randn(v.shape, generator=g))
    before = {k: v.clone() for k, v in leaves.items()}
    rows = pool.extract_slot(1)
    assert rows["seg0"][0]["state"].shape[1] == 1
    pool.zero_slot(1)
    for k, v in leaves.items():
        assert not v[:, 1].any()
        assert torch.equal(v[:, [0, 2, 3]], before[k][:, [0, 2, 3]])
    pool.insert_slot(1, rows)
    for k, v in leaves.items():
        assert torch.equal(v, before[k])
    # a seat's rows land in another seat and only there
    pool.insert_slot(2, rows)
    for k, v in leaves.items():
        assert torch.equal(v[:, 2], before[k][:, 1])
        assert torch.equal(v[:, [0, 1, 3]], before[k][:, [0, 1, 3]])
    # the page operations see no slot leaf
    assert pool.extract_pages([1, 2]) == {"seg0": ({},)}


def test_ssd_scan_cost_counts_the_work_by_hand():
    """B = 2 rows of S = 8 positions in chunks of Q = 4, H = 3 heads, P =
    2, N = 5, bf16: per (row, chunk) 10 causal pairs; C B^T 2 N = 10 flops
    a pair once for the heads; per head the scores times x 2 P = 4 a pair,
    the state update 2 Q P N = 80, and the read-out of the carried state 80
    for every chunk but a zero-state row's first."""
    kw = dict(batch=2, seq=8, heads=3, head_dim=2, d_state=5, chunk=4,
              itemsize=2)
    per_chunk = 10 * 10 + 3 * (10 * 4 + 80)             # 460
    cost = pm.ssd_scan_cost(init_state=False, **kw)
    assert cost.flops == 2 * (2 * per_chunk + 1 * 3 * 80)
    x_y = 2 * (2 * 8 * 3 * 2 * 2)                       # x in, y out
    dt_a = 2 * 8 * 3 * 4 + 3 * 4
    bc = 2 * 2 * 8 * 5 * 2
    state = 2 * 3 * 2 * 5 * 2
    assert cost.hbm_bytes == x_y + dt_a + bc + state
    init = pm.ssd_scan_cost(init_state=True, **kw)
    assert init.flops == 2 * (2 * per_chunk + 2 * 3 * 80)
    assert init.hbm_bytes == cost.hbm_bytes + state
    assert cost.bound_by("bfloat16") == "bytes"


def test_ssd_scan_bwd_cost_at_the_train_shape():
    """mamba2-370m's train step, 4 x 4096, H = 32, (P, N) = (64, 128),
    chunks of 256, bf16: 61,276,684,288 flops over 222,298,368 bytes, bound
    by bytes at 0.06636 ms on the H100's 3.35 TB/s; the count is of the
    visible work, whatever body runs it."""
    cost = pm.ssd_scan_bwd_cost(batch=4, seq=4096, heads=32, head_dim=64,
                                d_state=128, chunk=256, itemsize=2,
                                init_state=False, dfin=False)
    assert cost.flops == 61_276_684_288
    assert cost.hbm_bytes == 222_298_368
    assert cost.bound_by("bfloat16") == "bytes"
    assert round(cost.bound_seconds("bfloat16") * 1e3, 5) == 0.06636


def test_ssd_scan_bwd_cost_counts_the_work_by_hand():
    """The backward at the forward test's shapes: per (row, chunk) 10
    causal pairs; C B^T, dG B and dG^T C 3 x 2 N = 30 flops a pair once for
    the heads; per head M^T dy and dy (x dt)^T 2 x 2 P = 8 a pair and four
    state products of 2 Q P N = 80, and the read-out's 80 for every chunk
    but a zero-state row's first.  Bytes: x, dy, dx; dt, ddt; A, dA; Bm,
    Cm, dBm, dCm; the initial state and its gradient, dfin when given."""
    kw = dict(batch=2, seq=8, heads=3, head_dim=2, d_state=5, chunk=4,
              itemsize=2)
    per_chunk = 10 * 30 + 3 * (10 * 8 + 4 * 80)
    cost = pm.ssd_scan_bwd_cost(init_state=False, dfin=False, **kw)
    assert cost.flops == 2 * (2 * per_chunk + 1 * 3 * 80)
    xs = 3 * (2 * 8 * 3 * 2 * 2)
    dts = 2 * (2 * 8 * 3 * 4) + 2 * 3 * 4
    bc = 4 * 2 * 8 * 5 * 2
    state = 2 * 3 * 2 * 5 * 2
    assert cost.hbm_bytes == xs + dts + bc
    full = pm.ssd_scan_bwd_cost(init_state=True, dfin=True, **kw)
    assert full.flops == 2 * (2 * per_chunk + 2 * 3 * 80)
    assert full.hbm_bytes == cost.hbm_bytes + 3 * state
