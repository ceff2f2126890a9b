"""The port's RG-LRU slice against the reference, on the CPU.

- ``rglru_scan_ref`` (the plain version the wrapper runs for CPU tensors)
  against the oracle ``ref.rglru_scan`` and against the Pallas kernel in
  interpret mode (``block_s=64``) at ``tests/test_kernels.py::
  test_rglru_scan``'s three shapes, in float32 within 2e-5 and in bfloat16
  within 3e-2 (the reference's own tolerances); with ``init_state``, odd
  lengths and padding (a_gate = 0 passes the state through exactly)
  against the oracle only, since the Pallas kernel takes no initial state;
- ``rglru_decode_step`` against ``ref.rglru_decode_step``, and the scan's
  last state against S decode steps;
- ``rglru_forward``, ``rglru_decode`` and ``rglru_prefill_chunk`` of the
  reduced recurrentgemma-2b (bridged float32 params), the last with a
  limit inside the chunk and a filler row whose writes reach no live seat;
- the wrapper's device dispatch, its input checks, and the scan's work
  model counted by hand.

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
from repro.kernels.rglru_scan import \
    rglru_scan as pallas_rglru_scan  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import rglru as jax_rg  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.kernels import ops, perf_model as pm  # noqa: E402
from repro_torch.kernels import rglru_scan as rs  # noqa: E402
from repro_torch.models import rglru  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402

ARCH = "recurrentgemma-2b"
TOL = 1e-4
DTYPE_TOL = [("float32", 2e-5), ("bfloat16", 3e-2)]
# the reference's functions compiled whole (eagerly, each of their many
# small ops compiles on its own, which costs more than one program)
oracle_scan = jax.jit(ref.rglru_scan)
jax_forward = jax.jit(jax_rg.rglru_forward, static_argnums=2,
                      static_argnames="return_cache")
jax_decode = jax.jit(jax_rg.rglru_decode, static_argnums=2)
jax_prefill = jax.jit(jax_rg.rglru_prefill_chunk, static_argnums=5)


def _maxdiff(a, b):
    if torch.is_tensor(a):
        a = a.float().numpy()
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


def _scan_inputs(B, S, W, seed, *, init=False, pad=0):
    """x, input_gate, a_gate, log_a (and init_state) at the reference
    kernel test's scales; the last ``pad`` positions of row 0 get a_gate
    = 0 (padding past a limit)."""
    rng = np.random.default_rng(seed)
    sig = lambda v: 1.0 / (1.0 + np.exp(-v))           # noqa: E731
    x = (rng.standard_normal((B, S, W)) * 0.5).astype(np.float32)
    ig = sig(rng.standard_normal((B, S, W))).astype(np.float32)
    ag = sig(rng.standard_normal((B, S, W))).astype(np.float32)
    if pad:
        ag[0, S - pad:] = 0.0
    la = (-np.log1p(np.exp(-np.linspace(2, 6, W)))).astype(np.float32)
    s0 = rng.standard_normal((B, W)).astype(np.float32) if init else None
    return x, ig, ag, la, s0


def _both(arrays, dtype):
    """The arrays as torch and jax inputs in ``dtype`` (log_a float32)."""
    x, ig, ag, la, s0 = arrays
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    t = [torch.from_numpy(a).to(tdt) for a in (x, ig, ag)]
    j = [jnp.asarray(a).astype(jdt) for a in (x, ig, ag)]
    ts0 = None if s0 is None else torch.from_numpy(s0).to(tdt)
    js0 = None if s0 is None else jnp.asarray(s0).astype(jdt)
    return (*t, torch.from_numpy(la)), ts0, (*j, jnp.asarray(la)), js0


SHAPES = [(2, 256, 128), (1, 128, 64), (2, 64, 256)]


@pytest.mark.parametrize("dtype,tol", DTYPE_TOL)
@pytest.mark.parametrize("B,S,W", SHAPES)
def test_rglru_scan_plain_matches_oracle_and_pallas(B, S, W, dtype, tol):
    """The reference kernel test's shapes: the plain version against the
    oracle and the Pallas kernel in interpret mode (block_s=64), each side
    asserted on its own; a failure names the side, every side's max |diff|
    (the two references against each other too) and whether a second run
    of the plain version gives the same bits."""
    targs, _, jargs, _ = _both(_scan_inputs(B, S, W, seed=B * S + W), dtype)
    got_h, got_f = rs.rglru_scan_ref(*targs)
    assert got_h.dtype == got_f.dtype == getattr(torch, dtype)
    wants = {"oracle": oracle_scan(*jargs),
             "pallas": pallas_rglru_scan(*jargs, interpret=True, block_s=64)}
    diffs = {side: (_maxdiff(got_h, h), _maxdiff(got_f, f))
             for side, (h, f) in wants.items()}
    diffs["oracle vs pallas"] = tuple(
        _maxdiff(a, b) for a, b in zip(wants["oracle"], wants["pallas"]))

    def report(side):
        again = rs.rglru_scan_ref(*targs)
        same = all(torch.equal(a, b) for a, b in zip((got_h, got_f), again))
        return (f"plain version against {side}: max |diff| (h, final) "
                f"{diffs[side]}, limit {tol}; all sides {diffs}; a second "
                f"plain run {'gives the same bits' if same else 'differs'}")

    for side in wants:
        assert max(diffs[side]) < tol, report(side)


@pytest.mark.parametrize("dtype,tol", DTYPE_TOL)
@pytest.mark.parametrize("B,S,W,pad", [
    (2, 64, 32, 0),
    (3, 37, 48, 11),         # an odd length, padding inside the sequence
    (2, 1, 16, 0),           # one step
    (1, 24, 8, 24),          # all padding: the state passes through
])
def test_rglru_scan_init_state_and_padding_match_oracle(B, S, W, pad, dtype,
                                                        tol):
    targs, ts0, jargs, js0 = _both(
        _scan_inputs(B, S, W, seed=S + W, init=True, pad=pad), dtype)
    got_h, got_f = rs.rglru_scan_ref(*targs, init_state=ts0)
    want_h, want_f = oracle_scan(*jargs, init_state=js0)
    assert _maxdiff(got_h, want_h) < tol and _maxdiff(got_f, want_f) < tol
    if pad == S:
        # a_gate = 0: a_t = 1 and beta = 0, so the state passes through
        # every padded step exactly
        assert torch.equal(got_f[0], ts0[0])
        assert torch.equal(got_h[0], ts0[0].expand(S, W))
    elif pad:
        # past the limit the state holds the last valid step's (the tree
        # combines the same terms in another order: within the tolerance)
        held = got_h[0, S - pad - 1].float()
        assert _maxdiff(got_h[0, S - pad:], held.expand(pad, W)) < tol


def test_rglru_decode_step_matches_reference_and_the_scan():
    """One step against the oracle's; S steps from a state end where the
    scan with that initial state ends."""
    x, ig, ag, la, s0 = _scan_inputs(3, 20, 24, seed=4, init=True)
    got = ops.rglru_decode_step(*(torch.from_numpy(a) for a in
                                  (x[:, 0], ig[:, 0], ag[:, 0], la, s0)))
    want = ref.rglru_decode_step(*(jnp.asarray(a) for a in
                                   (x[:, 0], ig[:, 0], ag[:, 0], la, s0)))
    assert all(_maxdiff(g, w) < 2e-5 for g, w in zip(got, want))
    t = [torch.from_numpy(a) for a in (x, ig, ag, la, s0)]
    state = t[4]
    for i in range(x.shape[1]):
        h, state = rs.rglru_decode_step(t[0][:, i], t[1][:, i], t[2][:, i],
                                        t[3], state)
    h_scan, fin = rs.rglru_scan_ref(*t[:4], init_state=t[4])
    assert _maxdiff(fin, state.numpy()) < 2e-5
    assert _maxdiff(h_scan[:, -1], h.numpy()) < 2e-5


def test_rglru_scan_wrapper_on_the_cpu_takes_the_plain_version():
    """A CPU tensor runs the plain version and counts no launch; ``ops``
    dispatches to the wrapper, and in ``ref`` mode to the plain version;
    an input that requires grad takes :class:`RGLRUScanFn`, whose gradient
    flows and matches autograd through the plain forward;
    the checks run before a launch name what the kernel does not take."""
    x, ig, ag, la, s0 = (torch.from_numpy(a) for a in _scan_inputs(
        2, 16, 8, seed=5, init=True))
    n0 = rs.rglru_scan.launches
    want = rs.rglru_scan_ref(x, ig, ag, la, init_state=s0)
    for mode in ("auto", "ref"):
        ops.set_mode(mode)
        try:
            got = ops.rglru_scan(x, ig, ag, la, init_state=s0)
        finally:
            ops.set_mode("auto")
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert rs.rglru_scan.launches == n0
    leaf = x.clone().requires_grad_()
    h, fin = rs.rglru_scan(leaf, ig, ag, la)
    assert h.grad_fn is not None
    (got,) = torch.autograd.grad(h.sum() + fin.sum(), leaf)
    leaf2 = x.clone().requires_grad_()
    h2, fin2 = rs.rglru_scan_ref(leaf2, ig, ag, la)
    (auto,) = torch.autograd.grad(h2.sum() + fin2.sum(), leaf2)
    assert _maxdiff(got, auto.numpy()) <= 2e-5 * max(
        1.0, float(auto.abs().max()))
    assert rs.rglru_scan.launches == n0 and rs.rglru_scan_bwd.launches == 0
    rs._check(x, ig, ag, la, s0)                     # what it takes
    rs._check(x.bfloat16(), ig.bfloat16(), ag.bfloat16(), la, s0)
    for args, match in (
            ((x.half(), ig.half(), ag.half(), la, None), "dtypes"),
            ((x, ig, ag, la.double(), None), "log_a"),
            ((x, ig[:, :3], ag, la, None), "need"),
            ((x, ig, ag, la[:4], None), "need"),
            ((x.transpose(1, 2).contiguous().transpose(1, 2), ig, ag, la,
              None), "contiguous last dim"),
            ((x, ig, ag, la, s0[:1]), "init_state"),
            ((x.bfloat16(), ig.bfloat16(), ag.bfloat16(), la, s0.double()),
             "init_state")):
        with pytest.raises(ValueError, match=match):
            rs._check(*args)


@functools.cache
def _layer():
    """The first RG-LRU sublayer of the reduced recurrentgemma-2b in
    float32: the reference's params and the bridged port params."""
    kw = dict(dtype="float32", num_layers=3)     # seg0: one whole pattern
    jcfg = dataclasses.replace(jax_get_config(ARCH).reduced(), **kw)
    cfg = dataclasses.replace(get_config(ARCH).reduced(), **kw)
    jp = JM.init_model(jcfg, jax.random.PRNGKey(0))
    jl = jax.tree.map(lambda a: a[0], jp["seg0"][0]["mixer"])
    tl = params_from_numpy(jax.tree.map(np.asarray, jl), "cpu",
                           torch.bfloat16)
    assert tl["lambda"].dtype == torch.float32    # the bridge keeps it f32
    tl = params_from_numpy(jax.tree.map(np.asarray, jl), "cpu")
    return jcfg, cfg, jl, tl


@pytest.mark.parametrize("B,S,W,init,with_dfin", [
    (2, 64, 16, False, False),
    (2, 64, 16, False, True),
    (2, 37, 8, True, True),                 # odd length
    (1, 100, 32, True, False),
])
def test_rglru_scan_bwd_plain_matches_jax_vjp(B, S, W, init, with_dfin):
    """``rglru_scan_bwd_ref`` against ``jax.vjp`` of the oracle, with dfin
    zero and not, with and without ``init_state``, each gradient within
    2e-5 x max(1, max |grad|); then autograd through the plain forward and
    :class:`RGLRUScanFn` on CPU tensors against the same."""
    x, ig, ag, la, s0 = _scan_inputs(B, S, W, seed=3 * S + W, init=init)
    rng = np.random.default_rng(S + 2)
    dh = rng.standard_normal((B, S, W)).astype(np.float32)
    dfin = (rng.standard_normal((B, W)).astype(np.float32)
            if with_dfin else None)
    ins = [jnp.asarray(a) for a in (x, ig, ag, la)]
    if init:
        fn = lambda *a: ref.rglru_scan(*a[:4], init_state=a[4])  # noqa
        ins.append(jnp.asarray(s0))
    else:
        fn = ref.rglru_scan
    (_, jfin), vjp = jax.vjp(fn, *ins)
    want = vjp((jnp.asarray(dh), jnp.zeros_like(jfin) if dfin is None
                else jnp.asarray(dfin)))
    T = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    got = rs.rglru_scan_bwd_ref(T(x), T(ig), T(ag), T(la), T(dh), T(dfin),
                                init_state=T(s0))
    assert (got[4] is None) == (not init)
    for g, w in zip(got, want):
        assert _maxdiff(g, w) <= 2e-5 * max(1.0, float(np.abs(
            np.asarray(w)).max()))
    leaves = [torch.from_numpy(a).requires_grad_()
              for a in (x, ig, ag, la) + ((s0,) if init else ())]
    for fn in (rs.rglru_scan_ref, rs.rglru_scan):
        h, fin = fn(*leaves[:4], init_state=leaves[4] if init else None)
        loss = (h * T(dh)).sum()
        if dfin is not None:
            loss = loss + (fin * T(dfin)).sum()
        auto = torch.autograd.grad(loss, leaves)
        for g, a in zip(got, auto):
            assert _maxdiff(g, a.detach()) <= 2e-5 * max(
                1.0, float(a.abs().max()))


def test_rglru_forward_and_decode_match_reference():
    jcfg, cfg, jl, tl = _layer()
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    got, gcache = rglru.rglru_forward(tl, torch.from_numpy(x), cfg,
                                      return_cache=True)
    want, wcache = jax_forward(jl, jnp.asarray(x), jcfg, return_cache=True)
    assert _maxdiff(got, want) < TOL
    for k in ("state", "conv"):
        assert _maxdiff(gcache[k], wcache[k]) < TOL
    x1 = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    got, gnew = rglru.rglru_decode(tl, torch.from_numpy(x1), cfg, gcache)
    want, wnew = jax_decode(jl, jnp.asarray(x1), jcfg, wcache)
    assert _maxdiff(got, want) < TOL
    for k in ("state", "conv"):
        assert _maxdiff(gnew[k], wnew[k]) < TOL


def test_rglru_prefill_chunk_matches_reference():
    """Four rows of a 16-token chunk: a first chunk, a middle chunk of a
    long prompt, a final partial chunk (the limit inside the chunk, a
    padded tail) and a filler row (the null seat, limit 0).  The live rows'
    outputs and every seat's state and conv tail match the reference's;
    the filler's writes reach no live seat (the port's pool has one more
    row, the null seat)."""
    jcfg, cfg, jl, tl = _layer()
    n, C = 5, 16
    rng = np.random.default_rng(8)
    one = jax_rg.init_rglru_cache(jcfg, n, jnp.float32)
    cache = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in one.items()}
    x = rng.standard_normal((4, C, cfg.d_model)).astype(np.float32)
    starts = np.array([0, 32, 48, 0], np.int32)
    limits = np.array([40, 100, 55, 0], np.int32)
    slots = np.array([3, 0, 4, n], np.int32)
    want, wcache = jax_prefill(
        jl, jnp.asarray(x), jnp.asarray(starts), jnp.asarray(limits),
        jnp.asarray(slots), jcfg, {k: jnp.asarray(v)
                                   for k, v in cache.items()})
    pool = {k: torch.from_numpy(np.concatenate(
        [v, np.zeros_like(v[:1])])) for k, v in cache.items()}
    got = rglru.rglru_prefill_chunk(
        tl, torch.from_numpy(x), *(torch.from_numpy(a) for a in
                                   (starts, limits, slots)), cfg, pool)
    assert _maxdiff(got[:3], np.asarray(want)[:3]) < TOL
    for k in ("state", "conv"):
        assert _maxdiff(pool[k][:n], wcache[k]) < TOL
        # seats 1 and 2 hold no row of this call: untouched, exactly
        assert np.array_equal(pool[k][1:3].numpy(), cache[k][1:3])


def test_rglru_scan_cost_counts_the_work_by_hand():
    """B = 2 rows of S = 3 positions at W = 5, bf16: 30 elements at 10
    flops; x, input_gate, a_gate read and h written (4 x 30 x 2 bytes),
    log_a (5 x 4), the final state written (2 x 5 x 2) and, with an
    initial state, read too."""
    kw = dict(batch=2, seq=3, width=5, itemsize=2)
    cost = pm.rglru_scan_cost(init_state=False, **kw)
    assert cost.flops == 300
    assert cost.hbm_bytes == 240 + 20 + 20
    init = pm.rglru_scan_cost(init_state=True, **kw)
    assert init.flops == 300 and init.hbm_bytes == cost.hbm_bytes + 20
    assert cost.bound_by("bfloat16") == "bytes"


def test_rglru_scan_bwd_cost_counts_the_work_by_hand():
    """The backward at the forward test's shape: 30 elements at 28 flops;
    x, input_gate, a_gate and dh read, dx, d input_gate and d a_gate written
    (7 x 30 x 2 bytes), log_a read and d log_a written (2 x 5 x 4); the
    initial state read and its gradient written, and dfin read, when
    given (2 x 5 x 2 each)."""
    kw = dict(batch=2, seq=3, width=5, itemsize=2)
    cost = pm.rglru_scan_bwd_cost(init_state=False, dfin=False, **kw)
    assert cost.flops == 30 * 28
    assert cost.hbm_bytes == 420 + 40
    full = pm.rglru_scan_bwd_cost(init_state=True, dfin=True, **kw)
    assert full.flops == cost.flops
    assert full.hbm_bytes == cost.hbm_bytes + 3 * 20
    assert cost.bound_by("bfloat16") == "bytes"


@pytest.mark.parametrize("B,S,W,chunks", [
    (1, 4096, 2560, 64),       # recurrentgemma-2b's train step
    (2, 1, 5, 1),              # one step: one chunk
    (3, 64, 7, 1),             # one whole chunk
    (3, 65, 7, 2),             # a step past it
    (2, 200, 130, 4)])         # three chunks and a ragged tail
def test_rglru_bwd_workspace_counts_its_planes_by_hand(B, S, W, chunks):
    """The backward's f32 workspace: the time axis in chunks of
    RG_BWD_CHUNK = 64 steps, and six (B, chunks, W) planes, one value a
    (row, chunk, channel) in each: the chunk's product of a, its local h
    and its local adjoint; the h carry into it and the adjoint's out of
    it; its d log_a partial."""
    assert rs.RG_BWD_CHUNK == 64
    assert rs.rglru_bwd_workspace(B, S, W) == 6 * B * chunks * W
