"""The port's attention kernels against the reference.

On the CPU each wrapper runs its kernel's plain PyTorch version; these
tests hold that plain version against BOTH the reference's oracle
(``repro.kernels.ref``) and its Pallas kernel in interpret mode.  The
fused paged kernels take the cases of ``tests/test_paged_kernels.py``:
block size 4, table width 6, 32 pool blocks, scrambled tables, lengths
[10, 3, 24], windowed or not, GQA and MHA, a filler row that must come
out exactly zero.  The dense ``flash_attention`` and ``decode_attention``
take the shapes, windows, dtypes and tolerances of
``tests/test_kernels.py``, plus the two things the port adds: the
windowed decode (against ``ref.decode_attention(window=)``; the Pallas
kernel has no window) and the per-row ``q_offset`` tensor (against a loop
of ``ref.flash_attention(q_offset=int)``).  Inputs are made with numpy
from a seed and handed to both frameworks.  Tolerance 2e-5 in float32:
the sums run in another order.  3e-2 in bfloat16, the reference's own: the
plain versions compute in f32 and round once, while the oracle and the
Pallas kernel also round p to bfloat16 before the PV product.

The CUDA kernels themselves run only on the card:
``tests/test_torch_cuda.py`` holds them against the plain versions there.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from repro.kernels import perf_model as ref_pm  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro.kernels.decode_attention import \
    decode_attention as pallas_dense_decode  # noqa: E402
from repro.kernels.flash_attention import \
    flash_attention as pallas_flash  # noqa: E402
from repro.kernels.paged_decode_attention import \
    paged_decode_attention as pallas_decode  # noqa: E402
from repro.kernels.ragged_prefill_attention import \
    ragged_prefill_attention as pallas_prefill  # noqa: E402
from repro_torch.kernels import ops, perf_model as pm  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import paged_decode_attention as pda  # noqa: E402
from repro_torch.kernels import ragged_prefill_attention as rpa  # noqa: E402

BS, W, N = 4, 6, 32                     # block size, table width, pool blocks
TOL = 2e-5


def _pools(rng, kv_heads, head_dim):
    shape = (N, BS, kv_heads, head_dim)
    return (rng.standard_normal(shape).astype(np.float32) * 0.3,
            rng.standard_normal(shape).astype(np.float32) * 0.3)


def _tables(batch):
    perm = np.random.RandomState(0).permutation(N - 1)[:batch * W] + 1
    return perm.reshape(batch, W).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _maxdiff(a, b):
    if torch.is_tensor(a):
        a = a.float().numpy()
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


DTYPES = {"float32": (torch.float32, jnp.float32, 2e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 3e-2)}


def _both(a, dtype):
    """One numpy f32 array as a (torch, jax) pair in ``dtype``; both
    frameworks round to bfloat16 to nearest even, so they hold equal
    values."""
    tdt, jdt, _ = DTYPES[dtype]
    return torch.from_numpy(a).to(tdt), jnp.asarray(a).astype(jdt)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape,window", [
    ((2, 256, 4, 2, 64), None),
    ((1, 512, 8, 8, 32), None),
    ((2, 256, 6, 2, 64), 128),
    ((1, 128, 2, 1, 64), None),
    ((1, 128, 4, 4, 128), 64),
])
def test_flash_plain_matches_oracle_and_pallas(shape, window, dtype):
    B, S, H, KV, D = shape
    rng = np.random.default_rng(7)
    (tq, jq), (tk, jk), (tv, jv) = (
        _both(rng.standard_normal(s).astype(np.float32) * 0.3, dtype)
        for s in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D)))
    got = fa.flash_attention(tq, tk, tv, window=window)
    oracle = ref.flash_attention(jq, jk, jv, window=window)
    pallas = pallas_flash(jq, jk, jv, window=window, interpret=True,
                          block_q=128, block_k=128)
    tol = DTYPES[dtype][2]
    assert got.shape == oracle.shape and got.dtype == DTYPES[dtype][0]
    assert _maxdiff(got, oracle) < tol
    assert _maxdiff(got, pallas) < tol


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,S,H,KV,D", [(2, 512, 4, 2, 64),
                                        (1, 1024, 8, 8, 32),
                                        (2, 256, 2, 1, 128)])
def test_decode_plain_matches_dense_oracle_and_pallas(B, S, H, KV, D, dtype):
    rng = np.random.default_rng(8)
    (tq, jq), (tk, jk), (tv, jv) = (
        _both(rng.standard_normal(s).astype(np.float32) * 0.3, dtype)
        for s in ((B, 1, H, D), (B, S, KV, D), (B, S, KV, D)))
    lens = np.full((B,), S // 2, np.int32)
    got = da.decode_attention(tq, tk, tv, _t(lens))
    oracle = ref.decode_attention(jq, jk, jv, jnp.asarray(lens))
    pallas = pallas_dense_decode(jq, jk, jv, jnp.asarray(lens),
                                 interpret=True, block_s=128)
    tol = DTYPES[dtype][2]
    assert got.shape == oracle.shape and got.dtype == DTYPES[dtype][0]
    assert _maxdiff(got, oracle) < tol
    assert _maxdiff(got, pallas) < tol


@pytest.mark.parametrize("window", [1, 7, 40])
def test_windowed_decode_and_row_offsets_match_the_oracle(window):
    """The two things the port adds to the dense kernels: a windowed
    decode (keys below ``length - window`` masked; the reference sends it
    to its oracle) with mixed lengths, and the per-row ``q_offset`` tensor
    of ``flash_rows`` against one ``q_offset=int`` oracle call per row."""
    rng = np.random.default_rng(9)
    H, KV, D, S = 4, 2, 16, 48
    lens = np.asarray([1, 6, 7, 30, 48], np.int32)
    q, k, v = (rng.standard_normal(s).astype(np.float32) * 0.3
               for s in ((5, 1, H, D), (5, S, KV, D), (5, S, KV, D)))
    got = da.decode_attention(_t(q), _t(k), _t(v), _t(lens), window=window)
    want = ref.decode_attention(*(jnp.asarray(a) for a in (q, k, v, lens)),
                                window=window)
    assert _maxdiff(got, want) < TOL
    C, offs = 8, np.asarray([0, 5, 16, 40], np.int32)
    q, k, v = (rng.standard_normal(s).astype(np.float32) * 0.3
               for s in ((4, C, H, D), (4, S, KV, D), (4, S, KV, D)))
    got = fa.flash_attention(_t(q), _t(k), _t(v), q_offset=_t(offs),
                             window=window)
    for r, off in enumerate(offs):
        want = ref.flash_attention(*(jnp.asarray(a[r:r + 1])
                                     for a in (q, k, v)),
                                   q_offset=int(off), window=window)
        assert _maxdiff(got[r:r + 1], want) < TOL
    assert torch.equal(got[1:2], fa.flash_attention(
        _t(q[1:2]), _t(k[1:2]), _t(v[1:2]), q_offset=5, window=window))


def test_dense_wrappers_refuse_inputs_that_require_grad():
    """A gradient must not be computed wrong in silence, so the wrappers
    refuse inputs that require one where no backward is built, on every
    device: decode has none, and flash's takes q_offset 0 and (Dk, Dv) in
    ``BWD_PAIRS`` only (here (16, 16), and a per-row offset tensor)."""
    q = torch.zeros(1, 4, 2, 16, requires_grad=True)
    k = torch.zeros(1, 4, 2, 16)
    with pytest.raises(ValueError, match="backward is built"):
        fa.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="q_offset = 0"):
        fa.flash_attention(torch.zeros(1, 4, 2, 64, requires_grad=True),
                           torch.zeros(1, 4, 2, 64), torch.zeros(1, 4, 2, 64),
                           q_offset=torch.tensor([1]))
    with pytest.raises(RuntimeError, match="no backward"):
        da.decode_attention(q[:, :1], k, k, torch.tensor([3]))
    with torch.no_grad():
        assert fa.flash_attention(q, k, k).shape == (1, 4, 2, 16)


@pytest.mark.parametrize("window", [None, 7])
@pytest.mark.parametrize("kv_heads", [2, 4])
def test_decode_plain_matches_oracle_and_pallas(window, kv_heads):
    H, D = 4, 16
    lengths = np.asarray([10, 3, 24], np.int32)
    B = len(lengths)
    rng = np.random.default_rng(1)
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32) * 0.3
    k_pool, v_pool = _pools(rng, kv_heads, D)
    tables = _tables(B)
    kw = dict(block_size=BS, window=window)
    got = pda.paged_decode_attention(_t(q), _t(k_pool), _t(v_pool),
                                     _t(tables), _t(lengths), **kw).numpy()
    args = [jnp.asarray(a) for a in (q, k_pool, v_pool, tables, lengths)]
    oracle = ref.paged_decode_attention(*args, **kw)
    pallas = pallas_decode(*args, **kw, interpret=True)
    assert got.shape == oracle.shape == (B, 1, H, D)
    assert _maxdiff(got, oracle) < TOL
    assert _maxdiff(got, pallas) < TOL


@pytest.mark.parametrize("window", [None, 5])
def test_ragged_prefill_plain_matches_oracle_and_pallas(window):
    H, KV, D, C = 4, 2, 16, 8
    starts = np.asarray([0, 5, 16, 0], np.int32)
    limits = np.asarray([12, 13, 24, 0], np.int32)     # last row = filler
    P = len(starts)
    rng = np.random.default_rng(3)
    q = rng.standard_normal((P, C, H, D)).astype(np.float32) * 0.3
    k_pool, v_pool = _pools(rng, KV, D)
    tables = _tables(P)
    kw = dict(block_size=BS, window=window)
    got = rpa.ragged_prefill_attention(
        _t(q), _t(k_pool), _t(v_pool), _t(tables), _t(starts), _t(limits),
        **kw).numpy()
    args = [jnp.asarray(a) for a in (q, k_pool, v_pool, tables, starts,
                                     limits)]
    oracle = ref.ragged_prefill_attention(*args, **kw)
    pallas = pallas_prefill(*args, **kw, interpret=True)
    assert got.shape == oracle.shape == (P, C, H, D)
    assert _maxdiff(got, oracle) < TOL
    assert _maxdiff(got, pallas) < TOL
    assert np.all(got[3] == 0.0)          # filler row: exact zeros


def test_cpu_tensors_take_plain_version_without_launching():
    """On CPU tensors the wrappers return the plain version's result and
    count no launch; ``ref`` mode routes to the plain versions too."""
    rng = np.random.default_rng(5)
    q = _t(rng.standard_normal((2, 1, 4, 16)).astype(np.float32))
    k_pool, v_pool = (_t(a) for a in _pools(rng, 2, 16))
    tables, lengths = _t(_tables(2)), _t(np.asarray([7, 13], np.int32))
    before = pda.paged_decode_attention.launches
    for mode in ("auto", "ref"):
        ops.set_mode(mode)
        try:
            got = ops.paged_decode_attention(q, k_pool, v_pool, tables,
                                             lengths, block_size=BS)
        finally:
            ops.set_mode("auto")
        want = pda.paged_decode_attention_ref(q, k_pool, v_pool, tables,
                                              lengths, block_size=BS)
        assert torch.equal(got, want)
    assert pda.paged_decode_attention.launches == before
    with pytest.raises(ValueError):
        ops.set_mode("pallas")


def test_kernel_input_checks_name_the_problem():
    """The checks each wrapper runs before a launch (on the card only) are
    plain Python: every kernel refuses a dtype, head dim, grouping or
    shape it was not built for, with a message naming it."""
    q = torch.zeros(2, 1, 16, 64)
    k = torch.zeros(2, 8, 2, 64)
    for mod, args in ((pda, (q, k, k)), (rpa, (q, k, k)),
                      (fa, (q, k, k, 0)), (da, (q, k, k, torch.ones(2)))):
        mod._check(*args)                     # takes what it was built for
        with pytest.raises(ValueError, match="dtypes"):
            mod._check(q.half(), *args[1:])
        with pytest.raises(ValueError, match="head dims"):
            mod._check(q[..., :32], k[..., :32], k[..., :32], *args[3:])
        with pytest.raises(ValueError, match="contiguous"):
            mod._check(q, k.transpose(0, 1), k, *args[3:])
    for mod in (pda, da):        # any number of query heads per kv head,
        n = [torch.ones(2)] if mod is da else []    # but H a multiple of KV
        k1 = k[:, :, :1].contiguous()            # G = 16 over one kv head
        mod._check(q, k1, k1, *n)
        with pytest.raises(ValueError, match="H % KV"):
            mod._check(q[:, :, :15], k, k, *n)
    with pytest.raises(ValueError, match="q_offset"):
        fa._check(q, k, k, torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="length"):
        da._check(q, k, k, torch.ones(3))


@pytest.mark.parametrize("kernel", ["paged_decode", "ragged_prefill",
                                    "flash", "decode"])
def test_attention_at_head_dim_256_and_ten_heads_per_kv_head(kernel):
    """recurrentgemma-2b's LOCAL_ATTN shape, (H, KV, D) = (10, 1, 256),
    windowed: every attention wrapper's checks take it (the kernels are
    built for it), and the plain version the wrapper runs on the CPU
    matches the reference's oracle within 2e-5 in float32."""
    H, KV, D, window = 10, 1, 256, 9
    rng = np.random.default_rng(12)

    def rnd(*shape):
        return rng.standard_normal(shape).astype(np.float32) * 0.3
    if kernel in ("paged_decode", "ragged_prefill"):
        k_pool, v_pool = _pools(rng, KV, D)
        tables = _tables(3)
        if kernel == "paged_decode":
            mod, q = pda, rnd(3, 1, H, D)
            extra = [np.asarray([10, 3, 24], np.int32)]
        else:
            mod, q = rpa, rnd(3, 8, H, D)
            extra = [np.asarray([0, 5, 16], np.int32),
                     np.asarray([12, 13, 24], np.int32)]
        args = [q, k_pool, v_pool, tables, *extra]
        kw = dict(block_size=BS, window=window)
        fn = (mod.paged_decode_attention if mod is pda
              else mod.ragged_prefill_attention)
        oracle = (ref.paged_decode_attention if mod is pda
                  else ref.ragged_prefill_attention)
        mod._check(*(_t(a) for a in args[:3]))
    elif kernel == "flash":
        args, kw = [rnd(2, 24, H, D), rnd(2, 24, KV, D), rnd(2, 24, KV, D)], \
            dict(window=window)
        fn, oracle = fa.flash_attention, ref.flash_attention
        fa._check(*(_t(a) for a in args), 0)
    else:
        args = [rnd(3, 1, H, D), rnd(3, 30, KV, D), rnd(3, 30, KV, D),
                np.asarray([1, 17, 30], np.int32)]
        kw = dict(window=window)
        fn, oracle = da.decode_attention, ref.decode_attention
        da._check(*(_t(a) for a in args))
    got = fn(*(_t(a) for a in args), **kw)
    want = oracle(*(jnp.asarray(a) for a in args), **kw)
    assert got.shape == want.shape and got.shape[-2:] == (H, D)
    assert _maxdiff(got, want) < TOL


def test_resolve_paged_path():
    assert ops.resolve_paged_path("auto") == "fused"
    assert ops.resolve_paged_path("fused") == "fused"
    assert ops.resolve_paged_path("composed") == "composed"
    with pytest.raises(ValueError):
        ops.resolve_paged_path("bogus")


@pytest.mark.parametrize("window", [None, 5])
def test_perf_model_matches_reference_work_definition(window):
    """The bound the port reports uses the reference's pages-visited and
    bytes/FLOPs definitions, copied: same counts on the same inputs."""
    lengths, starts, limits = [10, 3, 24, 17], [0, 5, 16, 0], [12, 13, 24, 0]
    assert (pm.decode_pages_visited(lengths, block_size=BS, window=window)
            == ref_pm.decode_pages_visited(lengths, block_size=BS,
                                           window=window))
    pv = pm.prefill_pages_visited(starts, limits, 8, block_size=BS,
                                  table_width=W, window=window)
    assert pv == ref_pm.prefill_pages_visited(starts, limits, 8,
                                              block_size=BS, table_width=W,
                                              window=window)
    kw = dict(num_heads=14, kv_heads=2, head_dim=64, block_size=BS,
              pages_visited=pv, itemsize=2)
    for ours, theirs in (
            (pm.paged_decode_cost(batch=4, **kw),
             ref_pm.paged_decode_cost(batch=4, **kw)),
            (pm.ragged_prefill_cost(rows_live=3, chunk=8, **kw),
             ref_pm.ragged_prefill_cost(rows_live=3, chunk=8, **kw))):
        assert (ours.flops, ours.hbm_bytes) == (theirs.flops,
                                                theirs.hbm_bytes)
    cost = pm.paged_decode_cost(batch=4, **kw)
    assert cost.bound_by("bfloat16") == "bytes"
    assert cost.bound_seconds("bfloat16") == cost.hbm_bytes / 3.35e12


@pytest.mark.parametrize("window", [None, 5])
def test_visible_work_counts_the_masks(window):
    """The bound's work is what the plain versions' masks let through:
    (query, key) pairs counted one by one, queries below each row's limit,
    keys some such query sees, the whole output written."""
    H, KV, D, C, item = 14, 2, 64, 8, 2
    lengths, starts, limits = [10, 3, 24, 0], [0, 5, 16, 0], [12, 9, 24, 0]
    pos = np.arange(W * BS)
    seen = [(pos < n) & ((pos >= n - window) if window else True)
            for n in lengths]
    cost = pm.decode_visible_cost(lengths, num_heads=H, kv_heads=KV,
                                  head_dim=D, itemsize=item, window=window)
    keys = sum(int(s.sum()) for s in seen)
    assert cost.flops == 4 * D * H * keys
    assert cost.hbm_bytes == (keys * 2 * KV * D * item
                              + 2 * len(lengths) * H * D * item
                              + 4 * len(lengths))
    pairs = queries = keys = 0
    for start, limit in zip(starts, limits):
        qp = start + np.arange(C)[:, None]
        mask = (pos[None, :] <= qp) & ((qp - pos[None, :] < window)
                                       if window else True)
        mask &= (qp < limit) & (limit > 0)
        pairs += int(mask.sum())
        queries += int(mask.any(axis=1).sum())
        keys += int(mask.any(axis=0).sum())
    cost = pm.prefill_visible_cost(starts, limits, C, num_heads=H,
                                   kv_heads=KV, head_dim=D, itemsize=item,
                                   window=window)
    assert cost.flops == 4 * D * H * pairs
    assert cost.hbm_bytes == ((queries * H + keys * 2 * KV) * D * item
                              + len(starts) * C * H * D * item
                              + 8 * len(starts))


@pytest.mark.parametrize("window", [None, 5])
def test_visible_work_bounds_the_dense_kernels(window):
    """A causal flash call is the ragged prefill's visible work with every
    row live (limit = q_offset + Sq): its pairs are the ones the plain
    version's mask lets through."""
    H, KV, D, Sq, Sk, item = 14, 2, 64, 8, 24, 2
    offs = [0, 5, 16]
    pairs = 0
    for off in offs:
        qp = off + np.arange(Sq)[:, None]
        kp = np.arange(Sk)[None, :]
        mask = (kp <= qp) & ((qp - kp < window) if window else True)
        pairs += int(mask.sum())
    cost = pm.prefill_visible_cost(offs, [o + Sq for o in offs], Sq,
                                   num_heads=H, kv_heads=KV, head_dim=D,
                                   itemsize=item, window=window)
    assert cost.flops == 4 * D * H * pairs
    assert cost.bound_by("bfloat16") == "bytes"   # tiny: bytes dominate
