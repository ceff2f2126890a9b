"""The port's fused paged kernels against the reference.

On the CPU each wrapper runs its kernel's plain PyTorch version; these
tests hold that plain version against BOTH the reference's oracle
(``repro.kernels.ref``) and its Pallas kernel in interpret mode, on the
cases of ``tests/test_paged_kernels.py``: block size 4, table width 6,
32 pool blocks, scrambled tables, lengths [10, 3, 24], windowed or not,
GQA and MHA, a filler row that must come out exactly zero.  Inputs are
made with numpy from a seed and handed to both frameworks.  Tolerance
2e-5 in float32: the sums run in another order.

The CUDA kernels themselves run only on the card:
``tests/test_torch_cuda.py`` holds them against the plain versions there.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import perf_model as ref_pm  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro.kernels.paged_decode_attention import \
    paged_decode_attention as pallas_decode  # noqa: E402
from repro.kernels.ragged_prefill_attention import \
    ragged_prefill_attention as pallas_prefill  # noqa: E402
from repro_torch.kernels import ops, perf_model as pm  # noqa: E402
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
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


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


def test_resolve_paged_path():
    assert ops.resolve_paged_path("auto") == "fused"
    assert ops.resolve_paged_path("fused") == "fused"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ops.resolve_paged_path("composed")
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
