"""The port's CUDA kernels, its serving path and its Generator on the card.

The eight kernels (fused paged decode, ragged prefill, flash attention
with per-row query offsets and MLA's (Dk, Dv) = (96, 64) and (192, 128),
dense decode with a window, MLA paged decode (in bf16 at the edges of its
key splits: rows ending inside a split, at its end and one past it, empty
splits, one seat and sixteen, two calls bit-identical), the MoE grouped
matmul with empty and single-expert groups and its backward (dx and dw,
through its autograd Function too), the Mamba-2 SSD scan at
chunks of 256, 100, 48, 32, 16, 8 and 1 (both of its bodies) with and
without an initial state and under a decay whose running sum falls
below -200 in a chunk, the RG-LRU scan with and
without an initial state, padded and at odd lengths, at the edges of
its warps' chunks and segments, a padded tail held bit for bit; the paged
decode at the edges of its key splits for 3, 7 and 10 heads a kv head,
windowed over null blocks; the four GQA
attention kernels also at recurrentgemma-2b's head dim 256 with 10 query
heads per kv head, windowed; the bf16 prefill body of flash and the ragged
prefill at every (Dk, Dv) pair at the edges of its tiles; the grouped
matmul at the edges of its row tiles and work list, the split dense decode
at the edges of its splits for 1-20 heads a kv head) against their
plain versions, the flash backward (dq, dk, dv and the forward's lse)
against its plain version and autograd, in both of its bodies, over a
sequence that wraps the tensor-core body's ring many times, and at MLA's
(Dk, Dv) = (192, 128) (the column-split tensor-core body), (96, 64)
and recurrentgemma-2b's (256, 256) over up to 4160 keys, a second call's
dk and dv bit for bit; the SSD and RG-LRU scans' backwards against their
plain versions (every gradient, with and without an initial state and
the final state's gradient, a second call bit for bit, and through their
autograd Functions against autograd over the plain forwards; the SSD
backward also at mamba2-370m's 32 heads, over 16 chunks and past one wave
of (b, h) pairs); the
wrappers' refusals (shapes,
dtypes, inputs that require grad where no backward is built, side inputs on another device or of the wrong shape, an
unaligned pool; never a plain version on a CUDA tensor), and the
Generator and HyperServe on the card
token-identical to the CPU, for qwen2-0.5b, deepseek-v2-lite (MLA + MoE),
mamba2-370m and recurrentgemma-2b (RG-LRU + LOCAL_ATTN), and one train step on
a one-rank NCCL mesh (HyperShard) against the unsharded step; HyperMPMD's
hand-off of a tree of CUDA tensors (KV pages, params) from a second
process on the card through gloo and pinned host memory, both ways, bit
for bit; on that mesh
too, the paged decode, ragged prefill, dense decode and both scans (with
their backwards, under grad and called directly) handed DTensors against
their plain versions, HyperServe against no mesh for the dense, SSD and
RG-LRU families and the composed lowering against the fused one without
a mesh, and mamba2, recurrentgemma and musicgen (with its prefix)
trained on the mesh against no mesh.  The bf16 flash backward under
``torch.use_deterministic_algorithms(True)`` (the FMA body, no atomics)
replays bit for bit at qwen2's and deepseek-v2-lite's head dims, and the
fabric launcher serves qwen2-0.5b at full width with the reference
launcher's routing.

Every test here is marked ``gpu`` and skips without a CUDA device (the
CUDA kernels have no CPU mode; on the CPU the wrappers run the plain
versions, which ``tests/test_torch_kernels.py`` holds against the JAX
reference).  The file imports no JAX, so it runs on a machine with a card
and no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

Tolerances: 2e-5 in float32 (sums in another order).  In bfloat16 the
kernels and the plain versions both compute in float32 and round once, so
the kernel must be within one bfloat16 step of the plain version and
within half a step of the plain version's float32 result on the same
inputs (plus 4e-6 where a step is smaller than the float32 differences;
2e-5 for the grouped matmul, whose float32 sums over D = 2048 differ from
cuBLAS's by up to 1.335e-5, as ``chip_smoke.py`` measured on an H100 80GB
HBM3 at 700 W).
The MLA decode kernel returns float32 from bfloat16 inputs, both sides
computing in float32: 1e-4 abs.  The SSD scan's decays exp(cs_q - cs_k)
are differences of running sums of dt * A that reach |cs| ~ 200 in a chunk
of 256, so every float32 evaluation carries ~|cs| 2^-24 relative error in
them, and two that sum in different orders differ by about twice the plain
version's own distance from a float64 evaluation: its float32 limit, and
its bfloat16 slack, is 2e-5 times max(1, the largest |output|) of the
tensor plus twice that distance.  The RG-LRU scan: 2e-5 in float32 (the
kernel walks t in order, the plain version in a log-depth tree), and
2e-5 as its bfloat16 slack (its float32 carries differ by that much, not
by the attention kernels' 4e-6).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import ServeConfig, get_config  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import grouped_matmul as gm  # noqa: E402
from repro_torch.kernels import paged_decode_attention as pda  # noqa: E402
from repro_torch.kernels import ragged_prefill_attention as rpa  # noqa: E402
from repro_torch.kernels import rglru_scan as rs  # noqa: E402
from repro_torch.kernels import ssd_scan as ss  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serve.api import HyperServe  # noqa: E402
from repro_torch.serve.engine import GenerateConfig, Generator  # noqa: E402

pytestmark = pytest.mark.gpu

BS, W, N = 4, 6, 32
H, KV, D = 14, 2, 64
GM_SLACK = 2e-5         # bf16 slack of the grouped matmul (module docstring)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(dtype, device):
    g = torch.Generator().manual_seed(7)
    perm = torch.randperm(N - 1, generator=g)[:4 * W] + 1
    tables = perm.reshape(4, W).to(torch.int32)

    def rnd(*shape):
        return torch.randn(*shape, generator=g).to(device, dtype)
    return (rnd(N, BS, KV, D), rnd(N, BS, KV, D), tables.to(device),
            rnd(3, 1, H, D), rnd(4, 8, H, D))


def _bf16_step(x):
    _, e = torch.frexp(x.float().abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def _assert_close(got, fn, args, kw, slack=4e-6):
    want = fn(*args, **kw)
    if got.dtype == torch.float32:
        assert (got - want).abs().max().item() < 2e-5
        return
    want32 = fn(*[a.float() if a.is_floating_point() else a for a in args],
                **kw)
    err = (got.float() - want.float()).abs()
    assert bool((err <= _bf16_step(want) + slack).all())
    err32 = (got.float() - want32).abs()
    assert bool((err32 <= 0.5 * _bf16_step(want32) + slack).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 7])
def test_kernels_match_plain_versions(cuda, dtype, window):
    k_pool, v_pool, tables, q_dec, q_pre = _inputs(dtype, cuda)
    kw = dict(block_size=BS, window=window)
    lengths = torch.tensor([10, 3, 24], dtype=torch.int32, device=cuda)
    n0 = pda.paged_decode_attention.launches
    args = (q_dec, k_pool, v_pool, tables[:3], lengths)
    got = pda.paged_decode_attention(*args, **kw)
    assert pda.paged_decode_attention.launches == n0 + 1
    _assert_close(got, pda.paged_decode_attention_ref, args, kw)
    starts = torch.tensor([0, 5, 16, 0], dtype=torch.int32, device=cuda)
    limits = torch.tensor([12, 13, 24, 0], dtype=torch.int32, device=cuda)
    args = (q_pre, k_pool, v_pool, tables, starts, limits)
    got = rpa.ragged_prefill_attention(*args, **kw)
    _assert_close(got, rpa.ragged_prefill_attention_ref, args, kw)
    assert bool((got[3] == 0).all())


def test_decode_kernel_at_serving_lengths(cuda):
    """Block size 16, lengths from 1 key to 40 pages with last pages of
    many fill levels (a full one too), so every lane position of a warp
    tile and the cross-warp combine are exercised."""
    g = torch.Generator().manual_seed(3)
    B, Wd, Nb = 18, 40, 800
    lengths = torch.tensor([2, 1, 15, 16, 17, 31, 32, 33, 100, 255, 256,
                            257, 511, 600, 613, 639, 640, 7], dtype=torch.int32)
    tables = (torch.randperm(Nb - 1, generator=g)[:B * Wd] + 1).reshape(B, Wd)
    for dtype in (torch.float32, torch.bfloat16):
        def rnd(*shape):
            return torch.randn(*shape, generator=g).to(cuda, dtype)
        args = (rnd(B, 1, H, D), rnd(Nb, 16, KV, D), rnd(Nb, 16, KV, D),
                tables.to(cuda, torch.int32), lengths.to(cuda))
        for window in (None, 50):
            kw = dict(block_size=16, window=window)
            got = pda.paged_decode_attention(*args, **kw)
            _assert_close(got, pda.paged_decode_attention_ref, args, kw)


def test_wrappers_refuse_what_no_kernel_takes(cuda):
    k_pool, v_pool, tables, q_dec, q_pre = _inputs(torch.float32, cuda)
    lengths = torch.tensor([10, 3, 24], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        pda.paged_decode_attention(q_dec[..., :16], k_pool[..., :16],
                                   v_pool[..., :16], tables[:3], lengths,
                                   block_size=BS)
    with pytest.raises(ValueError, match="dtypes"):
        pda.paged_decode_attention(q_dec.half(), k_pool, v_pool, tables[:3],
                                   lengths, block_size=BS)
    # the dense kernels: no launch for what they do not take, and none
    # for an input that asks for a gradient no backward is built for
    # (decode has none; flash's takes q_offset 0 and (64, 64) / (128, 128))
    q, k, kd = q_pre, k_pool[:4], k_pool[:3]     # B = 4 and B = 3 rows
    n0 = (fa.flash_attention.launches, da.decode_attention.launches)
    with pytest.raises(ValueError, match="q_offset = 0"):
        fa.flash_attention(q.clone().requires_grad_(), k, k, q_offset=3)
    with pytest.raises(ValueError, match="backward is built"):
        fa.flash_attention(q[..., :32].clone().requires_grad_(),
                           k[..., :32], k[..., :32])
    with pytest.raises(RuntimeError, match="no backward"):
        da.decode_attention(q_dec, kd.clone().requires_grad_(), kd, lengths)
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_attention(q[..., :32], k[..., :32], k[..., :32])
    with pytest.raises(ValueError, match="q_offset"):
        fa.flash_attention(q, k, k, q_offset=lengths)
    with pytest.raises(ValueError, match="dtypes"):
        da.decode_attention(q_dec.half(), kd, kd, lengths)
    assert (fa.flash_attention.launches,
            da.decode_attention.launches) == n0
    with torch.no_grad():                  # no gradient asked: it runs
        da.decode_attention(q_dec, kd.clone().requires_grad_(), kd, lengths)
    assert da.decode_attention.launches == n0[1] + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads,kv,dim", [(14, 2, 64), (32, 8, 128)])
@pytest.mark.parametrize("window", [None, 37])
def test_flash_kernel_matches_plain_version(cuda, dtype, heads, kv, dim,
                                            window):
    """Dense causal prefill (q_offset 0, Sq = Sk, a length that is no
    multiple of the query tile) and the composed paged prefill's per-row
    q_offset tensor (Sq < Sk, offsets at and off tile edges)."""
    g = torch.Generator().manual_seed(11)

    def rnd(*shape):
        return torch.randn(*shape, generator=g).to(cuda, dtype)
    q, k, v = rnd(2, 77, heads, dim), rnd(2, 77, kv, dim), rnd(2, 77, kv, dim)
    kw = dict(causal=True, window=window)
    n0 = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, **kw)
    assert fa.flash_attention.launches == n0 + 1
    _assert_close(got, fa.flash_attention_ref, (q, k, v), kw)
    offs = torch.tensor([0, 37, 160, 219], dtype=torch.int32, device=cuda)
    q, k, v = rnd(4, 48, heads, dim), rnd(4, 272, kv, dim), \
        rnd(4, 272, kv, dim)
    kw = dict(causal=True, window=window, q_offset=offs)
    _assert_close(fa.flash_attention(q, k, v, **kw), fa.flash_attention_ref,
                  (q, k, v), kw)
    kw = dict(causal=True, window=window, q_offset=19)
    _assert_close(fa.flash_attention(q, k, v, **kw), fa.flash_attention_ref,
                  (q, k, v), kw)
    kw = dict(causal=False, window=None, q_offset=0)
    _assert_close(fa.flash_attention(q, k, v, **kw), fa.flash_attention_ref,
                  (q, k, v), kw)


def _assert_grad_close(got, want, want32):
    """The backward's rule (``chip_smoke.py`` phase 3): float32 within
    2e-5 x max(1, max |grad|) (its sums run over up to Sk keys, or G x Sq
    query rows, in another order); bfloat16 within one step of the plain
    version and half a step of its float32 result, plus that float32
    limit as slack."""
    lim = 2e-5 * max(1.0, want32.abs().max().item())
    if got.dtype == torch.float32:
        assert (got - want).abs().max().item() <= lim
        return
    err = (got.float() - want.float()).abs()
    assert bool((err <= _bf16_step(want) + lim).all())
    err32 = (got.float() - want32).abs()
    assert bool((err32 <= 0.5 * _bf16_step(want32) + lim).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,dk,dv,S", [
    (7, 64, 64, 150), (1, 64, 64, 150), (3, 128, 128, 150),
    (7, 64, 64, 1000), (3, 128, 128, 1000),
    (1, 192, 128, 150), (4, 192, 128, 300), (1, 192, 128, 4160),
    (1, 96, 64, 150), (4, 96, 64, 300), (1, 96, 64, 4160),
    (10, 256, 256, 150), (1, 256, 256, 300)])
@pytest.mark.parametrize("window", [None, 37])
def test_flash_backward_kernel_matches_plain_version(cuda, dtype, G, dk, dv,
                                                     S, window, monkeypatch):
    """The forward's lse against the plain version's, its output bit for
    bit the serving path's (lse null), and the backward kernel's dq, dk,
    dv against ``flash_attention_bwd_ref`` at 150 tokens (no multiple of
    the 64-row tiles), at 1000, whose G x 16 query tiles wrap the
    tensor-core body's ring of Q/dO stages many times, and at MLA's pairs
    (192, 128) (bf16 on the tensor-core body with the columns split
    between its warpgroups, f32 on the FMA body), (96, 64) (the FMA
    body in both dtypes) and recurrentgemma-2b's (256, 256) (bf16 on the
    wide wgmma body, f32 on the FMA body with the head dims in 64-wide
    chunks; both a dK/dV block a query head, its partials summed) at G = 1
    and G > 1, over 4160 keys among others (a
    train row's prefix plus tokens: the last 128-key tile half full);
    causal and, unwindowed, not causal; a second call on the same inputs
    within the rule of the first, its dk and dv bit for bit (dq's f32 sums
    arrive by atomics); through autograd the Function against autograd
    over the plain forward, with the plain versions barred from CUDA
    tensors."""
    g = torch.Generator().manual_seed(17)

    def rnd(*shape):
        return torch.randn(*shape, generator=g).to(cuda, dtype)
    B, KV = 2, 2
    q, k, v = rnd(B, S, KV * G, dk), rnd(B, S, KV, dk), rnd(B, S, KV, dv)
    do = rnd(B, S, KV * G, dv)
    plain, plain_bwd = fa.flash_attention_ref, fa.flash_attention_bwd_ref
    for causal in ((True, False) if window is None else (True,)):
        kw = dict(causal=causal, window=window)
        out, lse = fa.flash_attention_lse(q, k, v, **kw)
        assert torch.equal(out, fa.flash_attention(q, k, v, **kw))
        _, want_lse = fa.flash_attention_lse_ref(q, k, v, **kw)
        assert (lse - want_lse).abs().max().item() <= \
            2e-5 * want_lse.abs().max().item()
        n0 = fa.flash_attention_bwd.launches
        got = fa.flash_attention_bwd(q, k, v, out, lse, do, **kw)
        assert fa.flash_attention_bwd.launches == n0 + 1
        want = plain_bwd(q, k, v, out, lse, do, **kw)
        want32 = plain_bwd(*(t.float() for t in (q, k, v, out)), lse,
                           do.float(), **kw)
        for a, w, w32 in zip(got, want, want32):
            assert a.dtype == dtype and a.shape == w.shape
            _assert_grad_close(a, w, w32)
        again = fa.flash_attention_bwd(q, k, v, out, lse, do, **kw)
        for a, first, w32 in zip(again, got, want32):
            _assert_grad_close(a, first, w32)
        assert torch.equal(again[1], got[1]) and torch.equal(again[2], got[2])
        if dtype != torch.float32:
            continue
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        want = torch.autograd.grad(plain(*leaves, **kw), leaves, do)

        def refuse(*a, **k):
            raise AssertionError("a plain version ran on a CUDA tensor")
        monkeypatch.setattr(fa, "flash_attention_ref", refuse)
        monkeypatch.setattr(fa, "flash_attention_lse_ref", refuse)
        monkeypatch.setattr(fa, "flash_attention_bwd_ref", refuse)
        n0 = fa.flash_attention.launches, fa.flash_attention_bwd.launches
        got = torch.autograd.grad(fa.flash_attention(*leaves, **kw), leaves,
                                  do)
        monkeypatch.undo()
        assert (fa.flash_attention.launches,
                fa.flash_attention_bwd.launches) == (n0[0] + 1, n0[1] + 1)
        for a, w in zip(got, want):
            _assert_grad_close(a, w, w)


@pytest.mark.parametrize("G,dk,dv,S", [
    (7, 64, 64, 150), (7, 64, 64, 4096), (3, 128, 128, 1000),
    (1, 192, 128, 300), (1, 192, 128, 4096)])
@pytest.mark.parametrize("window", [None, 37])
def test_flash_backward_deterministic_bf16_replays(cuda, G, dk, dv, S,
                                                   window):
    """Under ``torch.use_deterministic_algorithms(True)`` the bf16
    backward at the tensor-core body's pairs takes the FMA body
    (``flash_bwd_body`` "fma": dQ summed in registers, no atomics): two
    calls on the same inputs equal bit for bit in dq, dk and dv, each
    within the bf16 rule of the plain version, at qwen2's (64, 64) and
    deepseek-v2-lite's (192, 128) among others, over 4096 keys too; with
    the switch off the body is the tensor-core one again."""
    g = torch.Generator().manual_seed(19)

    def rnd(*shape):
        return torch.randn(*shape, generator=g).to(cuda, torch.bfloat16)
    B, KV = 2, 2 if G > 1 else 16
    q, k, v = rnd(B, S, KV * G, dk), rnd(B, S, KV, dk), rnd(B, S, KV, dv)
    do = rnd(B, S, KV * G, dv)
    kw = dict(causal=True, window=window)
    assert fa.flash_bwd_body(torch.bfloat16, dk, dv) == "wgmma"
    out, lse = fa.flash_attention_lse(q, k, v, **kw)
    want = fa.flash_attention_bwd_ref(q, k, v, out, lse, do, **kw)
    want32 = fa.flash_attention_bwd_ref(*(t.float() for t in (q, k, v, out)),
                                        lse, do.float(), **kw)
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        assert fa.flash_bwd_body(torch.bfloat16, dk, dv) == "fma"
        n0 = fa.flash_attention_bwd.launches
        first = fa.flash_attention_bwd(q, k, v, out, lse, do, **kw)
        again = fa.flash_attention_bwd(q, k, v, out, lse, do, **kw)
        assert fa.flash_attention_bwd.launches == n0 + 2
    finally:
        torch.use_deterministic_algorithms(before)
    for a, b, w, w32 in zip(first, again, want, want32):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)
        _assert_grad_close(a, w, w32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,G,S", [(1, 1, 151), (1, 10, 301), (3, 2, 97),
                                   (1, 10, 4096), (2, 3, 1000)])
@pytest.mark.parametrize("window", [None, 37, 2048])
def test_flash_backward_wide_at_one_kv_head(cuda, dtype, B, G, S, window):
    """The (256, 256) backward at one kv head, as recurrentgemma-2b lays
    its heads out: a dK/dV block a query head, a kv head's G partials
    summed in order; at counts of row dots (B H S = 151, 3010, 582) that
    are no multiple of 4, so the partials start past padding; at
    recurrentgemma-2b's train shape (1 x 4096, G = 10, window 2048); at
    1000 tokens (no multiple of the 64-row tiles) with a window of 37,
    shorter than one of the ring's 64-row stages, so that a key tile's
    reach ends inside a stage; against the plain version, and dq, dk and
    dv bit for bit on a second call (neither body adds by atomics)."""
    g = torch.Generator().manual_seed(23)

    def rnd(*shape):
        return torch.randn(*shape, generator=g).to(cuda, dtype)
    q, k, v = rnd(B, S, G, 256), rnd(B, S, 1, 256), rnd(B, S, 1, 256)
    do = rnd(B, S, G, 256)
    kw = dict(causal=True, window=window)
    out, lse = fa.flash_attention_lse(q, k, v, **kw)
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    want = fa.flash_attention_bwd_ref(q, k, v, out, lse, do, **kw)
    want32 = fa.flash_attention_bwd_ref(*(t.float() for t in (q, k, v, out)),
                                        lse, do.float(), **kw)
    for a, w, w32 in zip(got, want, want32):
        assert a.dtype == dtype and a.shape == w.shape
        _assert_grad_close(a, w, w32)
    again = fa.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    assert all(torch.equal(a, b) for a, b in zip(again, got))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads,kv,dim", [(14, 2, 64), (32, 8, 128)])
@pytest.mark.parametrize("window", [None, 50])
def test_decode_kernel_matches_plain_version(cuda, dtype, heads, kv, dim,
                                             window):
    """Lengths of 1 to 640 keys over a 640-entry cache, so every lane
    position of a warp tile and the cross-warp combine are exercised, and
    a window shorter and longer than the length."""
    g = torch.Generator().manual_seed(5)
    lengths = torch.tensor([1, 2, 15, 16, 17, 31, 33, 100, 255, 257, 511,
                            613, 639, 640], dtype=torch.int32)
    B, S = len(lengths), 640

    def rnd(*shape):
        return torch.randn(*shape, generator=g).to(cuda, dtype)
    args = (rnd(B, 1, heads, dim), rnd(B, S, kv, dim), rnd(B, S, kv, dim),
            lengths.to(cuda))
    kw = dict(window=window)
    n0 = da.decode_attention.launches
    got = da.decode_attention(*args, **kw)
    assert da.decode_attention.launches == n0 + 1
    _assert_close(got, da.decode_attention_ref, args, kw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G", [1, 7, 10, 16, 20])
@pytest.mark.parametrize("dim", [64, 128, 256])
@pytest.mark.parametrize("short_window", [False, True])
def test_decode_kernel_at_the_edges_of_its_splits(cuda, dtype, G, dim,
                                                  short_window):
    """Lengths of one key, at a split's edge -1/0/+1 (the split the bf16
    launch takes on this card) and the whole cache; a window shorter than a
    split; G heads per kv head around the 16-row chunk."""
    B, KV, S = 8, 2, 640
    blocks = B * KV * -(-G // da.HEAD_CHUNK)
    splits, keys = da.decode_splits(S, blocks, da._sm_count(0))
    assert splits > 2
    lengths = torch.tensor([1, keys - 1, keys, keys + 1, 2 * keys - 1,
                            2 * keys, 2 * keys + 1, S], dtype=torch.int32)
    g = torch.Generator().manual_seed(G * dim)

    def rnd(*shape):
        return torch.randn(*shape, generator=g).to(cuda, dtype)
    args = (rnd(B, 1, KV * G, dim), rnd(B, S, KV, dim), rnd(B, S, KV, dim),
            lengths.to(cuda))
    kw = dict(window=max(1, keys // 2) if short_window else None)
    n0 = da.decode_attention.launches
    got = da.decode_attention(*args, **kw)
    assert da.decode_attention.launches == n0 + 1
    _assert_close(got, da.decode_attention_ref, args, kw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G", [3, 7, 10])
@pytest.mark.parametrize("dim", [64, 128, 256])
@pytest.mark.parametrize("windowed", [False, True])
def test_paged_decode_kernel_at_the_edges_of_its_splits(cuda, dtype, G, dim,
                                                        windowed):
    """Rows of length 0 and 1, exactly one split (the split the bf16 plan
    takes on this card), one split and one key, exactly the window (or two
    splits), the full table and one key short of it, and a row whose
    visible keys straddle splits; windowed, the table's blocks wholly below
    a row's window are the null block, whose keys are large, so reading
    one would show.  G heads a kv head: phi4-mini's 3 (24 over 8), qwen2's
    7, recurrentgemma's 10.  A second call replays the first bit for bit
    (the combine merges the splits in split order); a row of length 0
    writes zeros."""
    KV = {3: 8, 7: 2, 10: 1}[G]
    B, bs, W = 8, 16, 40
    window = 200 if windowed else None
    splits, keys = da.paged_decode_splits(B, KV, G, dim, W * bs, window,
                                          da._sm_count(0))
    assert splits > 1
    lengths = [0, 1, keys, keys + 1, window or 2 * keys, W * bs, W * bs - 1,
               (window or keys) + keys + 1]
    g = torch.Generator().manual_seed(G * dim + windowed)
    tables = (torch.randperm(B * W, generator=g) + 1).reshape(B, W).to(
        torch.int32)
    for r, n in enumerate(lengths):
        if window:
            tables[r, :max(0, n - window) // bs] = 0
    k_pool, v_pool = (torch.randn(B * W + 1, bs, KV, dim, generator=g)
                      for _ in range(2))
    k_pool[0], v_pool[0] = 100.0, 100.0           # the null block
    q = torch.randn(B, 1, KV * G, dim, generator=g)
    args = (q.to(cuda, dtype), k_pool.to(cuda, dtype), v_pool.to(cuda, dtype),
            tables.to(cuda), torch.tensor(lengths, dtype=torch.int32,
                                          device=cuda))
    kw = dict(block_size=bs, window=window)
    n0 = pda.paged_decode_attention.launches
    got = pda.paged_decode_attention(*args, **kw)
    again = pda.paged_decode_attention(*args, **kw)
    assert pda.paged_decode_attention.launches == n0 + 2
    assert torch.equal(got, again)
    assert not got[0].any()
    _assert_close(got[1:], lambda *a, **k: pda.paged_decode_attention_ref(
        *a, **k)[1:], args, kw)


def test_fabric_launcher_serves_at_full_width_on_the_card(cuda):
    """``python -m repro_torch.launch.fabric --arch qwen2-0.5b`` with no
    device named serves on the card at full width: two colocated
    replicas, the reference launcher's two-tenant traffic, every request
    dispatched and none rejected, the routing counters the reference's
    launcher prints for the same flags (they depend on the submissions
    only)."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.fabric", "--arch",
         "qwen2-0.5b", "--elastic"], capture_output=True, text=True,
        timeout=600, cwd=root,
        env=dict(os.environ, PYTHONPATH=os.path.join(root, "src")))
    assert out.returncode == 0, out.stderr[-4000:]
    lines = out.stdout.strip().splitlines()
    assert lines[0].startswith("fabric served 12 requests (192 tokens)")
    assert lines[1] == ("dispatched=13 affinity_hits=8 rejected=0 "
                        "scale_up=0 scale_down=1")
    assert lines[2] == ("chat (interactive) TTFT in router steps: "
                        "[1, 1, 1, 13, 13, 13, 24, 25]")


def test_generator_on_the_card_matches_the_cpu(cuda):
    """Reduced qwen2-0.5b in float32 (head dim 64): the Generator's greedy
    tokens on the card (CUDA kernels) equal the CPU's (plain versions),
    windowed or not, and the card run launches one flash_attention per
    layer for the prefill and one decode_attention per layer and step."""
    cfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(),
                              dtype="float32")
    params = M.init_model(cfg, torch.Generator().manual_seed(0))
    prompts = torch.randint(1, cfg.vocab_size, (2, 24),
                            generator=torch.Generator().manual_seed(1))
    for window in (None, 8):
        outs = {}
        for device in ("cpu", cuda):
            gen = Generator(cfg, params, max_len=40, window_override=window,
                            device=device)
            n0 = (fa.flash_attention.launches, da.decode_attention.launches)
            outs[str(device)] = gen.generate(
                prompts.to(device), GenerateConfig(max_new_tokens=6)).cpu()
        assert torch.equal(outs["cpu"], outs["cuda"])
        assert (fa.flash_attention.launches - n0[0],
                da.decode_attention.launches - n0[1]) == (2, 2 * 5)


def test_serving_on_the_card_matches_the_cpu(cuda):
    """Reduced qwen2-0.5b in float32: the same params served on the card
    (CUDA kernels) and on the CPU (plain versions) give the same greedy
    tokens, through preemption, and the card run launches the kernels."""
    cfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(),
                              dtype="float32")
    params = M.init_model(cfg, torch.Generator().manual_seed(0))
    scfg = ServeConfig(block_size=2, num_blocks=9, max_blocks_per_req=6,
                       max_slots=2, prefill_chunk=4, enable_prefix_cache=False)
    prompts, max_new = [list(range(1, 5)), list(range(7, 11))], [8, 8]
    outs = {}
    n0 = (pda.paged_decode_attention.launches,
          rpa.ragged_prefill_attention.launches)
    for device in ("cpu", cuda):
        serve = HyperServe(cfg, params, serve_cfg=scfg, device=device)
        rids = [serve.submit(p, n) for p, n in zip(prompts, max_new)]
        out = serve.join()
        outs[str(device)] = [out[r] for r in rids]
        assert serve.stats()["preemptions"] >= 1
    assert outs["cpu"] == outs["cuda"]
    assert pda.paged_decode_attention.launches > n0[0]
    assert rpa.ragged_prefill_attention.launches > n0[1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dk,dv", [(96, 64), (192, 128), (64, 64),
                                   (128, 128), (256, 256)])
def test_flash_kernel_takes_mla_head_dims(cuda, dtype, dk, dv, monkeypatch):
    """MLA's decompressed heads: keys of Dk = nope + rope dims, values of
    Dv.  The output has the values' width (a wrapper that shaped it like
    q, as before, fails here), dense causal and with per-row offsets.
    Every built (Dk, Dv) pair also runs at the edges of the bf16 body's
    tiles: C x G query rows and key ranges that are no multiple of 64, a
    window smaller than one key tile, rows whose first query lies past the
    window, per-row offsets, no causal mask; the plain version never runs
    on a CUDA tensor."""
    g = torch.Generator().manual_seed(13)

    def rnd(*shape):
        return torch.randn(*shape, generator=g).to(cuda, dtype)
    plain = fa.flash_attention_ref

    def refuse(*a, **k):
        raise AssertionError("the plain version ran on a CUDA tensor")
    monkeypatch.setattr(fa, "flash_attention_ref", refuse)
    H = 16 if dk == 192 else 4
    n0 = fa.flash_attention.launches
    q, k, v = rnd(2, 77, H, dk), rnd(2, 77, H, dk), rnd(2, 77, H, dv)
    got = fa.flash_attention(q, k, v, causal=True)
    assert tuple(got.shape) == (2, 77, H, dv)
    _assert_close(got, plain, (q, k, v), dict(causal=True))
    offs = torch.tensor([0, 37, 160, 219], dtype=torch.int32, device=cuda)
    q, k, v = rnd(4, 48, H, dk), rnd(4, 272, H, dk), rnd(4, 272, H, dv)
    kw = dict(causal=True, q_offset=offs, scale=dk ** -0.5)
    got = fa.flash_attention(q, k, v, **kw)
    assert tuple(got.shape) == (4, 48, H, dv)
    _assert_close(got, plain, (q, k, v), kw)
    assert fa.flash_attention.launches == n0 + 2
    # three query heads a kv head: 77 x 3 rows; 300 keys
    q, k, v = rnd(4, 77, 6, dk), rnd(4, 300, 2, dk), rnd(4, 300, 2, dv)
    for kw in (dict(causal=True, window=37, q_offset=offs),
               dict(causal=True, window=5, q_offset=offs),
               dict(causal=True, window=100, q_offset=offs),
               dict(causal=False, q_offset=0)):
        _assert_close(fa.flash_attention(q, k, v, **kw), plain, (q, k, v),
                      kw)
    assert fa.flash_attention.launches == n0 + 6
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_attention(q[..., :dv], k[..., :dv], v[..., :32])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dim", [64, 128, 256])
@pytest.mark.parametrize("window", [None, 20])
def test_ragged_prefill_kernel_at_the_edges_of_its_tiles(cuda, dtype, dim,
                                                         window, monkeypatch):
    """The ragged prefill at every head dim it is built for, three query
    heads a kv head over 70-token chunks (210 query rows, no multiple of
    64), with a first chunk, a row whose queries run past its limit, a row
    that starts past the window (smaller than one key tile) with a null
    block below it, a filler row (exact zeros) and key ranges that end
    inside a tile; the plain version never runs on a CUDA tensor."""
    g = torch.Generator().manual_seed(23)
    bs, nb, Wt = 16, 128, 24

    def rnd(*shape):
        return torch.randn(*shape, generator=g).to(cuda, dtype)
    plain = rpa.ragged_prefill_attention_ref

    def refuse(*a, **k):
        raise AssertionError("the plain version ran on a CUDA tensor")
    monkeypatch.setattr(rpa, "ragged_prefill_attention_ref", refuse)
    k_pool, v_pool = rnd(nb, bs, 2, dim), rnd(nb, bs, 2, dim)
    tables = (torch.randperm(nb - 1, generator=g)[:4 * Wt] + 1).reshape(4, Wt)
    tables[2, :10] = 0                       # freed below the window
    starts = torch.tensor([0, 100, 300, 0], dtype=torch.int32)
    limits = torch.tensor([70, 150, 370, 0], dtype=torch.int32)
    args = (rnd(4, 70, 6, dim), k_pool, v_pool, tables.to(cuda, torch.int32),
            starts.to(cuda), limits.to(cuda))
    kw = dict(block_size=bs, window=window)
    n0 = rpa.ragged_prefill_attention.launches
    got = rpa.ragged_prefill_attention(*args, **kw)
    assert rpa.ragged_prefill_attention.launches == n0 + 1
    _assert_close(got, plain, args, kw)
    assert bool((got[3] == 0).all())


def test_wrappers_refuse_side_inputs_off_device_or_misshapen(cuda):
    """Kernels 1, 3, 4 and 5 take raw pointers to their side inputs: a CPU
    table, lengths, starts or k beside a CUDA q, a table of the wrong row
    count, a pool whose dim 1 is not the block size, or (ragged) a pool
    off a 16-byte boundary is refused with a ValueError that names it, and
    nothing is launched."""
    k_pool, v_pool, tables, q_dec, q_pre = _inputs(torch.bfloat16, cuda)
    lengths = torch.tensor([10, 3, 24], dtype=torch.int32, device=cuda)
    starts = torch.tensor([0, 5, 16, 0], dtype=torch.int32, device=cuda)
    limits = torch.tensor([12, 13, 24, 0], dtype=torch.int32, device=cuda)
    q_lat, q_rope, ckv, krope, mtab, mlen = _mla_inputs(
        torch.bfloat16, cuda, 4, 64, 32, 4, [5, 9], seed=3)
    wrappers = (fa.flash_attention, pda.paged_decode_attention,
                pda.paged_mla_decode_attention, rpa.ragged_prefill_attention)
    n0 = [w.launches for w in wrappers]
    kw = dict(block_size=BS)
    unaligned = torch.empty(k_pool.numel() + 1, dtype=k_pool.dtype,
                            device=cuda)[1:].view(k_pool.shape)
    cases = [
        (lambda: pda.paged_decode_attention(q_dec, k_pool, v_pool,
                                            tables[:3].cpu(), lengths, **kw),
         "block_tables on cpu"),
        (lambda: pda.paged_decode_attention(q_dec, k_pool, v_pool,
                                            tables[:3], lengths.cpu(), **kw),
         "lengths on cpu"),
        (lambda: pda.paged_decode_attention(q_dec, k_pool, v_pool,
                                            tables, lengths, **kw),
         r"block_tables \(4, 6\): need \(3, W\)"),
        (lambda: pda.paged_decode_attention(q_dec, k_pool, v_pool,
                                            tables[:3], lengths,
                                            block_size=BS * 2),
         "dim 1 must be block_size=8"),
        (lambda: pda.paged_mla_decode_attention(
            q_lat, q_rope, ckv, krope, mtab.cpu(), mlen, block_size=4,
            scale=0.1), "block_tables on cpu"),
        (lambda: pda.paged_mla_decode_attention(
            q_lat, q_rope, ckv, krope, mtab, mlen[:1], block_size=4,
            scale=0.1), r"lengths \(1,\): need \(2,\)"),
        (lambda: rpa.ragged_prefill_attention(q_pre, k_pool, v_pool, tables,
                                              starts.cpu(), limits, **kw),
         "starts on cpu"),
        (lambda: rpa.ragged_prefill_attention(q_pre, k_pool, v_pool, tables,
                                              starts, limits[:3], **kw),
         r"limits \(3,\): need \(4,\)"),
        (lambda: rpa.ragged_prefill_attention(q_pre, unaligned, v_pool,
                                              tables, starts, limits, **kw),
         "16-byte boundary"),
        (lambda: fa.flash_attention(q_pre, k_pool[:4].cpu(), k_pool[:4]),
         "k on cpu"),
        (lambda: fa.flash_attention(q_pre, k_pool[:4], k_pool[:4].cpu()),
         "v on cpu"),
    ]
    for call, pattern in cases:
        with pytest.raises(ValueError, match=pattern):
            call()
    assert [w.launches for w in wrappers] == n0


EDGE_SIZES = [0, 1, 63, 64, 65, 127, 128, 129]   # around the 64-row tiles


def _gm_inputs(dtype, device, sizes, D, F, seed):
    g = torch.Generator().manual_seed(seed)
    sizes = torch.tensor(sizes, dtype=torch.int32)
    T, E = int(sizes.sum()), len(sizes)
    x = torch.randn(T, D, generator=g).to(device, dtype)
    w = (torch.randn(E, D, F, generator=g) * D ** -0.5).to(device, dtype)
    return x, w, sizes.to(device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sizes,D,F", [
    ([3, 0, 70, 1, 0, 0, 22, 0], 256, 128),       # empty groups, 2 row tiles
    ([0, 0, 200, 0], 64, 16),                     # one expert takes all
    ([1] * 40 + [0] * 20 + [14, 0, 30, 12], 2048, 1408),   # a decode step
    ([5, 0, 9], 1408, 2048),                      # w_down's shape
    # the edges of the bf16 kernel's row tiles, tile heights and work list
    (EDGE_SIZES, 256, 1408),                      # 128-row tiles (T > 64 E)
    (EDGE_SIZES + [0] * 8, 256, 72),              # 64-row tiles, F < a tile
    ([0] * 32 + [6144] + [0] * 31, 2048, 1408),   # one expert: 288 items,
                                                  # more than the grid holds
    ([0, 0, 1], 1408, 2048),                      # 16 items: fewer
])
def test_grouped_matmul_kernel_matches_plain_version(cuda, dtype, sizes, D,
                                                     F):
    x, w, gs = _gm_inputs(dtype, cuda, sizes, D, F, seed=len(sizes))
    n0 = gm.grouped_matmul.launches
    got = gm.grouped_matmul(x, w, gs)
    assert gm.grouped_matmul.launches == n0 + 1
    assert tuple(got.shape) == (x.shape[0], F) and got.dtype == dtype
    _assert_close(got, gm.grouped_matmul_ref, (x, w, gs), {},
                  slack=GM_SLACK)


def test_grouped_matmul_all_groups_empty_and_refusals(cuda):
    """No rows at all (every group empty): an empty output, dx empty and
    dw zeros, and no launch.  The wrappers refuse what no kernel takes,
    before any launch."""
    x, w, gs = _gm_inputs(torch.bfloat16, cuda, [0, 0, 0, 0], 64, 32, 1)
    n0 = _gm_counts()
    assert tuple(gm.grouped_matmul(x, w, gs).shape) == (0, 32)
    dx, dw = gm.grouped_matmul_bwd(x, w, gs, x.new_empty(0, 32))
    assert tuple(dx.shape) == (0, 64) and not dw.any()
    x, w, gs = _gm_inputs(torch.float32, cuda, [2, 3], 64, 32, 2)
    with pytest.raises(ValueError, match="dtypes"):
        gm.grouped_matmul(x.half(), w.half(), gs)
    with pytest.raises(ValueError, match="multiples of 8"):
        gm.grouped_matmul(x[:, :60], w[:, :60].contiguous(), gs)
    with pytest.raises(ValueError, match="dy"):
        gm.grouped_matmul_bwd(x, w, gs, x.new_zeros(5, 16))
    with pytest.raises(ValueError, match="dtype"):
        gm.grouped_matmul_bwd(x, w, gs, x.new_zeros(5, 32).double())
    with pytest.raises(ValueError, match="dy"):
        gm.grouped_matmul_bwd_dw(x, x.new_zeros(5, 32).bfloat16(), gs)
    assert _gm_counts() == n0


def _gm_counts():
    return (gm.grouped_matmul.launches, gm.grouped_matmul_bwd_dx.launches,
            gm.grouped_matmul_bwd_dw.launches)


def _gm_grad_close(got, want, want32, want64):
    """The backward's rule (its sums run over up to thousands of rows in
    another order): f32 within 2e-5 x max(1, max |grad|) plus twice the f32
    plain version's own distance from float64; bf16 within one step of the
    plain version and half a step of its f32 result, that f32 limit the
    slack."""
    lim = (2e-5 * max(1.0, want32.abs().max().item())
           + 2 * (want32.double() - want64).abs().max().item())
    err = (got.float() - want.float()).abs()
    if got.dtype == torch.float32:
        assert err.max().item() <= lim
        return
    assert bool((err <= _bf16_step(want) + lim).all())
    err32 = (got.float() - want32).abs()
    assert bool((err32 <= 0.5 * _bf16_step(want32) + lim).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sizes,D,F", [
    ([3, 0, 70, 1, 0, 0, 22, 0], 256, 128),       # empty groups
    ([0, 0, 200, 0], 64, 16),                     # one expert, F < a tile
    ([1] * 40 + [0] * 20 + [14, 0, 30, 12], 2048, 1408),   # a decode mix
    ([5, 0, 9], 1408, 2048),                      # w_down's shape
    (EDGE_SIZES, 256, 1408),                      # row tiles' edges
    (EDGE_SIZES + [0] * 8, 256, 72),              # 64-row dx tiles
    ([0] * 32 + [6144] + [0] * 31, 2048, 1408),   # one expert takes all
    ([700, 768, 0, 833, 64, 65, 1, 0], 2048, 1408),   # train-sized groups
    # groups ending on a 64-row step (no row zeroed) and on 16-row slices
    ([64, 128, 0, 192, 16, 48, 80], 256, 128),
    ([30, 0, 77], 128, 256),                      # 3 items of dx and of dw
    ("rl", 2048, 1408),                           # the RL update's rows
    ("rl", 1408, 2048),
])
def test_grouped_matmul_bwd_kernels_match_plain_version(cuda, dtype, sizes,
                                                        D, F):
    """dx and dw against the plain backward, an empty expert's dw exact
    zeros, one launch of each kernel a call; a second call bit for bit.
    "rl": deepseek-v2-lite's RL update, 1 x 4 samples of 64 + 32 tokens
    routed top-6 over 64 experts (2304 rows, ~36 an expert)."""
    if sizes == "rl":
        sizes = _topk_sizes(4 * (64 + 32), 64, 6, seed=D)
    x, w, gs = _gm_inputs(dtype, cuda, sizes, D, F, seed=len(sizes) + 1)
    dy = torch.randn(x.shape[0], F, generator=torch.Generator()
                     .manual_seed(5)).to(cuda, dtype)
    n0 = _gm_counts()
    got = gm.grouped_matmul_bwd(x, w, gs, dy)
    assert _gm_counts() == (n0[0], n0[1] + 1, n0[2] + 1)
    args = (x, w, gs, dy)
    want = gm.grouped_matmul_bwd_ref(*args)
    want32 = gm.grouped_matmul_bwd_ref(
        *[a.float() if a.is_floating_point() else a for a in args])
    want64 = gm.grouped_matmul_bwd_ref(
        *[a.double() if a.is_floating_point() else a for a in args],
        acc=torch.float64)
    for g, a, b, c in zip(got, want, want32, want64):
        assert g.dtype == dtype and g.shape == a.shape
        _gm_grad_close(g, a, b, c)
    empty = [e for e, n in enumerate(sizes) if n == 0]
    assert not got[1][empty].any()
    again = gm.grouped_matmul_bwd(x, w, gs, dy)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def _topk_sizes(tokens, E, k, seed):
    """Group sizes of ``tokens`` routed to ``k`` distinct experts of ``E``
    drawn uniformly."""
    g = torch.Generator().manual_seed(seed)
    picks = torch.rand(tokens, E, generator=g).topk(k, dim=-1).indices
    return torch.bincount(picks.reshape(-1), minlength=E).tolist()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sizes,nan_rows", [
    ([70, 50, 33], (70, 76)),      # the last step of group 0 ends 6 rows
                                   # into a 16-row slice: rows 70.. zeroed
    ([40, 50, 33], (40, 64)),      # 40 rows: the slices from row 48 read
                                   # zeros; rows 40..47 zeroed
    ([64, 50, 33], (64, 80)),      # a group ending on a 64-row step
])
def test_grouped_matmul_bwd_rows_of_the_next_group_add_nothing(
        cuda, dtype, sizes, nan_rows):
    """NaN in x and dy at the first rows of group 1: the last k step of
    group 0's dw reaches into them, and must add exactly nothing, so dw[0]
    and dw[2] match the plain version (finite) and dx's rows outside the
    NaN rows too."""
    D, F = 256, 1408
    x, w, gs = _gm_inputs(dtype, cuda, sizes, D, F, seed=11)
    dy = torch.randn(x.shape[0], F, generator=torch.Generator()
                     .manual_seed(12)).to(cuda, dtype)
    lo, hi = nan_rows
    x[lo:hi], dy[lo:hi] = float("nan"), float("nan")
    dx, dw = gm.grouped_matmul_bwd(x, w, gs, dy)
    args = (x, w, gs, dy)
    want = gm.grouped_matmul_bwd_ref(*args)
    want32 = gm.grouped_matmul_bwd_ref(
        *[a.float() if a.is_floating_point() else a for a in args])
    want64 = gm.grouped_matmul_bwd_ref(
        *[a.double() if a.is_floating_point() else a for a in args],
        acc=torch.float64)
    keep = [e for e in range(len(sizes)) if e != 1]
    assert bool(dw[keep].isfinite().all())
    _gm_grad_close(dw[keep], want[1][keep], want32[1][keep],
                   want64[1][keep])
    rows = torch.ones(x.shape[0], dtype=torch.bool, device=cuda)
    rows[lo:hi] = False
    assert bool(dx[rows].isfinite().all())
    _gm_grad_close(dx[rows], want[0][rows], want32[0][rows],
                   want64[0][rows])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,F", [(2048, 1408), (256, 72)])
def test_grouped_matmul_bwd_sizes_summing_to_less_than_rows(cuda, dtype, D,
                                                            F):
    """group_sizes summing to S < T: the rows past S (NaN here) belong to
    no group, so dw is the plain version's (which takes S < T too).  dx's
    contract is sizes summing to T, as the forward's: its first S rows are
    the plain version's over the first S rows, and the rows past S are
    unspecified (the kernel does not write them), so they are not read."""
    sizes = [100, 0, 37, 64]
    S = sum(sizes)
    x, w, gs = _gm_inputs(dtype, cuda, sizes + [0], D, F, seed=13)
    T = S + 45
    x = torch.cat([x, x.new_full((T - S, D), float("nan"))])
    dy = torch.randn(T, F, generator=torch.Generator().manual_seed(14)).to(
        cuda, dtype)
    dy[S:] = float("nan")
    gs = gs[:len(sizes)]
    w = w[:len(sizes)].contiguous()
    dx, dw = gm.grouped_matmul_bwd(x, w, gs, dy)
    args = (x[:S], w, gs, dy[:S])
    want = gm.grouped_matmul_bwd_ref(*args)
    want32 = gm.grouped_matmul_bwd_ref(
        *[a.float() if a.is_floating_point() else a for a in args])
    want64 = gm.grouped_matmul_bwd_ref(
        *[a.double() if a.is_floating_point() else a for a in args],
        acc=torch.float64)
    assert torch.equal(gm.grouped_matmul_bwd_dw_ref(x, dy, gs), want[1])
    assert dx.shape == (T, D) and bool(dw.isfinite().all())
    _gm_grad_close(dx[:S], want[0], want32[0], want64[0])
    _gm_grad_close(dw, want[1], want32[1], want64[1])
    assert not dw[1].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_matmul_fn_trains_through_both_kernels(cuda, dtype):
    """A gradient through the wrapper runs GroupedMatmulFn: one forward and
    one backward launch, and the backward kernels' dx and dw."""
    x, w, gs = _gm_inputs(dtype, cuda, [30, 0, 77, 5], 128, 256, 9)
    dy = torch.randn(x.shape[0], 256, generator=torch.Generator()
                     .manual_seed(6)).to(cuda, dtype)
    leaves = [x.clone().requires_grad_(), w.clone().requires_grad_()]
    n0 = _gm_counts()
    got = torch.autograd.grad(gm.grouped_matmul(*leaves, gs), leaves, dy)
    assert _gm_counts() == tuple(n + 1 for n in n0)
    want = gm.grouped_matmul_bwd(x, w, gs, dy)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def _mla_inputs(dtype, device, H, R, r, bs, lengths, seed):
    g = torch.Generator().manual_seed(seed)
    B = len(lengths)
    W = max(-(-n // bs) for n in lengths) + 1
    N = B * W + 1
    tables = (torch.randperm(N - 1, generator=g)[:B * W] + 1).reshape(B, W)

    def rnd(*shape):
        return torch.randn(*shape, generator=g).to(device, dtype)
    return (rnd(B, H, R), rnd(B, H, r), rnd(N, bs, R), rnd(N, bs, r),
            tables.to(device, torch.int32),
            torch.tensor(lengths, dtype=torch.int32, device=device))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,R,r,bs", [(16, 512, 64, 16), (4, 64, 32, 4)])
def test_mla_decode_kernel_matches_plain_version(cuda, dtype, H, R, r, bs):
    """Lengths from one key to several key tiles of either kernel body
    (64 keys in bf16, 32 in f32), at and off tile and page edges."""
    lengths = [1, 2, 31, 32, 33, 63, 64, 65, 100, 257, 700]
    args = _mla_inputs(dtype, cuda, H, R, r, bs, lengths, seed=R)
    kw = dict(block_size=bs, scale=(R + r) ** -0.5)
    n0 = pda.paged_mla_decode_attention.launches
    got = pda.paged_mla_decode_attention(*args, **kw)
    assert pda.paged_mla_decode_attention.launches == n0 + 1
    want = pda.paged_mla_decode_attention_ref(*args, **kw)
    assert got.dtype == want.dtype == torch.float32
    assert tuple(got.shape) == (len(lengths), H, R)
    tol = 2e-5 if dtype == torch.float32 else 1e-4
    assert (got - want).abs().max().item() < tol
    with pytest.raises(ValueError, match="latent dims"):
        pda.paged_mla_decode_attention(args[0][..., :32], args[1],
                                       args[2][..., :32].contiguous(),
                                       *args[3:], **kw)


@pytest.mark.parametrize("B", [1, 16])
def test_mla_decode_kernel_at_the_edges_of_its_splits(cuda, B):
    """bf16 at deepseek-v2-lite's (H, R, r) = (16, 512, 64) over a 96-block
    table of block 16: the split plan cuts 1536 keys into splits of 192
    (B = 16) or 128 (B = 1), so rows end inside a split, exactly at a
    split's end and one past it, or fill the table, and the splits past a
    row's length are empty.  A second call on the same inputs replays the
    first bit for bit (the combine merges splits in split order)."""
    H, R, r, bs, W = 16, 512, 64, 16, 96
    edges = [1, 64, 127, 128, 129, 191, 192, 193, W * bs]
    sets = ([[n] for n in edges] if B == 1 else
            [edges + [100, 385, 700, 1000, 1151, 1152, 1500]])
    g = torch.Generator().manual_seed(5)
    ckv = torch.randn(B * W + 1, bs, R, generator=g).to(cuda, torch.bfloat16)
    krope = torch.randn(B * W + 1, bs, r, generator=g).to(cuda,
                                                          torch.bfloat16)
    tables = (torch.randperm(B * W, generator=g) + 1).reshape(B, W).to(
        cuda, torch.int32)
    q_lat = torch.randn(B, H, R, generator=g).to(cuda, torch.bfloat16)
    q_rope = torch.randn(B, H, r, generator=g).to(cuda, torch.bfloat16)
    splits, keys = da.mla_decode_splits(
        B, W * bs, torch.cuda.get_device_properties(cuda).multi_processor_count)
    assert splits > 1
    kw = dict(block_size=bs, scale=(R + r) ** -0.5)
    for lengths in sets:
        lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
        args = (q_lat, q_rope, ckv, krope, tables, lens)
        got = pda.paged_mla_decode_attention(*args, **kw)
        again = pda.paged_mla_decode_attention(*args, **kw)
        want = pda.paged_mla_decode_attention_ref(*args, **kw)
        assert torch.equal(got, again)
        assert (got - want).abs().max().item() < 1e-4, (lengths, keys)


def test_deepseek_serving_on_the_card_matches_the_cpu(cuda):
    """Reduced deepseek-v2-lite (MLA + MoE) in float32: greedy tokens on
    the card (CUDA kernels) equal the CPU's (plain versions), fused and
    composed, through preemption; the fused card run launches the MLA
    decode kernel once per layer and step, and the grouped matmul three
    times per MoE layer and call; the Generator's tokens are the same."""
    cfg = dataclasses.replace(get_config("deepseek-v2-lite-16b").reduced(),
                              dtype="float32")
    params = M.init_model(cfg, torch.Generator().manual_seed(0))
    scfg = ServeConfig(block_size=2, num_blocks=9, max_blocks_per_req=6,
                       max_slots=2, prefill_chunk=4, enable_prefix_cache=False)
    prompts, max_new = [list(range(1, 5)), list(range(7, 11))], [8, 8]
    moe_layers = sum(f == "moe" for _, f in cfg.block_kinds())
    outs = {}
    for kernels in ("fused", "composed"):
        for device in ("cpu", cuda):
            n0 = (pda.paged_mla_decode_attention.launches,
                  gm.grouped_matmul.launches)
            serve = HyperServe(cfg, params, device=device,
                               serve_cfg=dataclasses.replace(
                                   scfg, kernels=kernels))
            rids = [serve.submit(p, n) for p, n in zip(prompts, max_new)]
            out = serve.join()
            outs[kernels, str(device)] = [out[r] for r in rids]
            assert serve.stats()["preemptions"] >= 1
            if device == "cpu":
                continue
            m = serve.engine.obs.metrics
            steps = m.counter(f"serve.kernels.decode.{kernels}").value
            calls = m.counter(f"serve.kernels.prefill.{kernels}").value
            mla = pda.paged_mla_decode_attention.launches - n0[0]
            assert mla == (cfg.num_layers * steps if kernels == "fused"
                           else 0)
            assert (gm.grouped_matmul.launches - n0[1]
                    == 3 * moe_layers * (steps + calls))
    want = outs["fused", "cpu"]
    assert all(v == want for v in outs.values())
    gen = Generator(cfg, params, max_len=32, device=cuda)
    got = [gen.generate(torch.tensor([p], device=cuda), GenerateConfig(
        max_new_tokens=n))[0, len(p):].tolist()
        for p, n in zip(prompts, max_new)]
    assert got == want


def _ssd_inputs(dtype, device, B, S, H, P, N, seed, init):
    """The reference kernel test's scales; row 0's last 40 positions have
    dt = 0 (a prompt's padding)."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, S, H, P, generator=g) * 0.3
    dt = torch.nn.functional.softplus(torch.randn(B, S, H, generator=g))
    dt[0, -40:] = 0.0
    A = -torch.exp(torch.randn(H, generator=g) * 0.3)
    Bm = torch.randn(B, S, N, generator=g) * 0.3
    Cm = torch.randn(B, S, N, generator=g) * 0.3
    s0 = torch.randn(B, H, P, N, generator=g) if init else None
    to = lambda t: t.to(device, dtype)  # noqa: E731
    return ((to(x), dt.to(device), A.to(device), to(Bm), to(Cm)),
            None if s0 is None else to(s0))


def _ssd_close(got, want, want32, want64):
    """The SSD limit of the module docstring."""
    tol = (2e-5 * max(1.0, want32.abs().max().item())
           + 2 * (want32.double() - want64).abs().max().item())
    if got.dtype == torch.float32:
        assert (got - want).abs().max().item() <= tol
        return
    err = (got.float() - want.float()).abs()
    assert bool((err <= _bf16_step(want) + tol).all())
    err32 = (got.float() - want32).abs()
    assert bool((err32 <= 0.5 * _bf16_step(want32) + tol).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("S,Q,P,N", [(512, 256, 64, 128), (200, 100, 64, 128),
                                     (64, 8, 64, 128), (45, 1, 32, 16),
                                     (96, 32, 32, 16), (64, 16, 64, 128),
                                     (144, 48, 64, 128)])
def test_ssd_scan_kernel_matches_plain_version(cuda, dtype, init, S, Q, P,
                                               N):
    args, s0 = _ssd_inputs(dtype, cuda, 2, S, 3, P, N, seed=S + Q, init=init)
    n0 = ss.ssd_scan.launches
    y, fin = ss.ssd_scan(*args, chunk=Q, init_state=s0)
    assert ss.ssd_scan.launches == n0 + 1
    assert y.dtype == fin.dtype == dtype
    want = ss.ssd_scan_ref(*args, chunk=Q, init_state=s0)
    args32 = [a.float() for a in args]
    want32 = ss.ssd_scan_ref(*args32, chunk=Q, init_state=None if s0 is None
                             else s0.float())
    want64 = ss.ssd_scan_ref(*[a.double() for a in args], chunk=Q,
                             init_state=None if s0 is None else s0.double(),
                             acc=torch.float64)
    for g, w, w32, w64 in zip((y, fin), want, want32, want64):
        _ssd_close(g, w, w32, w64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("S,Q,P,N", [(512, 256, 64, 128), (200, 100, 64, 128),
                                     (144, 48, 64, 128), (96, 32, 32, 16),
                                     (45, 1, 32, 16)])
def test_ssd_bwd_kernel_matches_plain_version(cuda, dtype, with_state, S, Q,
                                              P, N, monkeypatch):
    """The SSD scan's backward kernels against ``ssd_scan_bwd_ref`` (the
    SSD limit of the module docstring on each of dx, ddt, dA, dB, dC and d
    init_state), at chunks of 256, 100, 48, 32 and 1 (key and query tiles
    of 32 whole, partial and single), with and without an initial state
    and the final state's gradient; a second call bit for bit (no
    atomics); through autograd, :class:`SSDScanFn` against autograd over
    the plain forward in f32, with the plain versions barred from CUDA
    tensors."""
    _ssd_bwd_check(cuda, dtype, with_state, 2, S, 3, Q, P, N, monkeypatch)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("B,S,Q", [(2, 2048, 256), (1, 4096, 256),
                                   (2, 512, 16), (2, 512, 64),
                                   (8, 512, 128)])
def test_ssd_bwd_kernel_at_mamba2_heads(cuda, dtype, with_state, B, S, Q,
                                        monkeypatch):
    """The same checks at mamba2-370m's 32 heads and (P, N) = (64, 128):
    8 and 16 chunks of 256 (the passes over chunks walked in both
    directions), chunks of 16 and 64 (one 64-row tile of the wgmma kernels
    mostly zero-filled, and whole), and 8 x 32 = 256 (b, h) pairs, more
    than the card's SMs hold at once, so that the state kernel's grid runs
    past one wave."""
    _ssd_bwd_check(cuda, dtype, with_state, B, S, 32, Q, 64, 128,
                   monkeypatch)


def _ssd_bwd_check(cuda, dtype, with_state, B, S, H, Q, P, N, monkeypatch):
    args, s0 = _ssd_inputs(dtype, cuda, B, S, H, P, N, seed=S + Q + 1,
                           init=with_state)
    g = torch.Generator().manual_seed(S)
    dy = torch.randn(B, S, H, P, generator=g).to(cuda, dtype)
    dfin = (torch.randn(B, H, P, N, generator=g).to(cuda, dtype)
            if with_state else None)
    kw = dict(chunk=Q, init_state=s0)
    n0 = ss.ssd_scan_bwd.launches
    got = ss.ssd_scan_bwd(*args, dy, dfin, **kw)
    assert ss.ssd_scan_bwd.launches == n0 + 1
    want = ss.ssd_scan_bwd_ref(*args, dy, dfin, **kw)
    f32 = lambda t: None if t is None else t.float()        # noqa: E731
    f64 = lambda t: None if t is None else t.double()       # noqa: E731
    want32 = ss.ssd_scan_bwd_ref(*map(f32, args), f32(dy), f32(dfin),
                                 chunk=Q, init_state=f32(s0))
    want64 = ss.ssd_scan_bwd_ref(*map(f64, args), f64(dy), f64(dfin),
                                 chunk=Q, init_state=f64(s0),
                                 acc=torch.float64)
    assert (got[5] is None) == (not with_state)
    for a, w, w32, w64 in zip(got, want, want32, want64):
        if a is None:
            continue
        assert a.dtype == w.dtype and a.shape == w.shape
        _ssd_close(a, w, w32, w64)
    del want32
    again = ss.ssd_scan_bwd(*args, dy, dfin, **kw)
    assert all(a is None or torch.equal(a, b) for a, b in zip(again, got))
    if dtype != torch.float32:
        return
    leaves = [t.clone().requires_grad_() for t in args]
    init = None if s0 is None else s0.clone().requires_grad_()
    every = leaves + ([init] if init is not None else [])

    def loss(y, fin):
        out = (y * dy).sum()
        return out + (fin * dfin).sum() if dfin is not None else out
    auto = torch.autograd.grad(loss(*ss.ssd_scan_ref(
        *leaves, chunk=Q, init_state=init)), every)

    def refuse(*a, **k):
        raise AssertionError("a plain version ran on a CUDA tensor")
    monkeypatch.setattr(ss, "ssd_scan_ref", refuse)
    monkeypatch.setattr(ss, "ssd_scan_bwd_ref", refuse)
    n0 = ss.ssd_scan.launches, ss.ssd_scan_bwd.launches
    through = torch.autograd.grad(loss(*ss.ssd_scan(
        *leaves, chunk=Q, init_state=init)), every)
    monkeypatch.undo()
    assert (ss.ssd_scan.launches, ss.ssd_scan_bwd.launches) == (
        n0[0] + 1, n0[1] + 1)
    for a, w, w64 in zip(through, auto, want64):
        _ssd_close(a, w, w, w64)


def test_scan_backwards_refuse_before_any_launch(cuda):
    """A shape or dtype the backward kernels do not take raises before any
    launch: (P, N) outside SSD_DIMS, a chunk that does not divide S, a dy
    of the wrong shape, a dfin of the wrong dtype; the RG-LRU's dh and
    dfin likewise."""
    args, _ = _ssd_inputs(torch.float32, cuda, 1, 64, 2, 16, 8, seed=1,
                          init=False)
    dy = torch.zeros(1, 64, 2, 16, device=cuda)
    n0 = ss.ssd_scan_bwd.launches
    with pytest.raises(ValueError, match="kernel built for"):
        ss.ssd_scan_bwd(*args, dy, None, chunk=32)
    args, _ = _ssd_inputs(torch.float32, cuda, 1, 64, 2, 32, 16, seed=1,
                          init=False)
    with pytest.raises(ValueError, match="chunk"):
        ss.ssd_scan_bwd(*args, torch.zeros(1, 64, 2, 32, device=cuda), None,
                        chunk=48)
    with pytest.raises(ValueError, match="dy"):
        ss.ssd_scan_bwd(*args, torch.zeros(1, 64, 2, 16, device=cuda), None,
                        chunk=32)
    with pytest.raises(ValueError, match="dfin"):
        ss.ssd_scan_bwd(*args, torch.zeros(1, 64, 2, 32, device=cuda),
                        torch.zeros(1, 2, 32, 16, device=cuda,
                                    dtype=torch.float16), chunk=32)
    assert ss.ssd_scan_bwd.launches == n0
    rargs, _ = _rg_inputs(torch.float32, cuda, 2, 16, 8, seed=1, init=False)
    n0 = rs.rglru_scan_bwd.launches
    with pytest.raises(ValueError, match="dh"):
        rs.rglru_scan_bwd(*rargs, torch.zeros(2, 15, 8, device=cuda), None)
    with pytest.raises(ValueError, match="dfin"):
        rs.rglru_scan_bwd(*rargs, torch.zeros(2, 16, 8, device=cuda),
                          torch.zeros(3, 8, device=cuda))
    with pytest.raises(ValueError, match="dtypes"):
        rs.rglru_scan_bwd(*(t.half() if i < 3 else t
                            for i, t in enumerate(rargs)),
                          torch.zeros(2, 16, 8, device=cuda).half(), None)
    assert rs.rglru_scan_bwd.launches == n0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_kernel_under_a_strong_decay(cuda, dtype):
    """dt ~ 3 and A ~ -1 over chunks of 256: the running sum cs of dt * A
    falls below -200 inside a chunk, so exp(-cs) would overflow float32;
    the decays exp(cs_q - cs_k) of the kernel must not, and its outputs
    stay finite and within the SSD limit."""
    g = torch.Generator().manual_seed(11)
    B, S, H, P, N, Q = 2, 512, 3, 64, 128, 256
    x = torch.randn(B, S, H, P, generator=g) * 0.3
    dt = 3.0 + 0.2 * torch.rand(B, S, H, generator=g)
    A = -(1.0 + 0.05 * torch.rand(H, generator=g))
    Bm = torch.randn(B, S, N, generator=g) * 0.3
    Cm = torch.randn(B, S, N, generator=g) * 0.3
    s0 = torch.randn(B, H, P, N, generator=g)
    cs = (dt * A).reshape(B, S // Q, Q, H).cumsum(2)
    assert cs.min().item() < -200
    args = [t.to(cuda, dtype) if i != 1 and i != 2 else t.to(cuda)
            for i, t in enumerate((x, dt, A, Bm, Cm))]
    init = s0.to(cuda, dtype)
    y, fin = ss.ssd_scan(*args, chunk=Q, init_state=init)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(fin).all())
    want = ss.ssd_scan_ref(*args, chunk=Q, init_state=init)
    args32 = [a.float() for a in args]
    want32 = ss.ssd_scan_ref(*args32, chunk=Q, init_state=init.float())
    want64 = ss.ssd_scan_ref(*[a.double() for a in args], chunk=Q,
                             init_state=init.double(), acc=torch.float64)
    for g_, w, w32, w64 in zip((y, fin), want, want32, want64):
        _ssd_close(g_, w, w32, w64)


def test_ssd_scan_kernel_takes_strided_views_and_f32_state(cuda):
    """x, B and C as the model hands them over (column slices of one
    projection, so strided rows), and a float32 initial state with
    bfloat16 inputs."""
    g = torch.Generator().manual_seed(1)
    B, S, H, P, N = 2, 128, 4, 64, 128
    xbc = (torch.randn(B, S, H * P + 2 * N, generator=g) * 0.3).to(
        cuda, torch.bfloat16)
    x = xbc[..., :H * P].reshape(B, S, H, P)
    Bm, Cm = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
    dt = torch.nn.functional.softplus(torch.randn(B, S, H, generator=g)).to(
        cuda)
    A = -torch.ones(H, device=cuda)
    s0 = torch.randn(B, H, P, N, generator=g).to(cuda)
    got = ss.ssd_scan(x, dt, A, Bm, Cm, chunk=64, init_state=s0)
    want = ss.ssd_scan_ref(x.contiguous(), dt, A, Bm.contiguous(),
                           Cm.contiguous(), chunk=64, init_state=s0)
    want32 = ss.ssd_scan_ref(x.float(), dt, A, Bm.float(), Cm.float(),
                             chunk=64, init_state=s0)
    want64 = ss.ssd_scan_ref(*[t.double() for t in (x, dt, A, Bm, Cm)],
                             chunk=64, init_state=s0.double(),
                             acc=torch.float64)
    for gt, w, w32, w64 in zip(got, want, want32, want64):
        _ssd_close(gt, w, w32, w64)


def test_ssd_scan_refusals_and_no_plain_version_on_the_card(cuda,
                                                            monkeypatch):
    """An unbuilt (P, N) and a chunk above 256 or not dividing S are
    refused before any launch, also for an input that requires grad
    (which takes ``SSDScanFn``: the same checks, then the kernel); on a
    CUDA tensor the wrapper never runs the plain version."""
    args, _ = _ssd_inputs(torch.float32, cuda, 1, 64, 2, 32, 16, seed=4,
                          init=False)
    x, dt, A, Bm, Cm = args
    n0 = ss.ssd_scan.launches
    with pytest.raises(ValueError, match=r"\(P, N\)"):
        ss.ssd_scan(x[..., :16], dt, A, Bm[..., :8], Cm[..., :8], chunk=8)
    with pytest.raises(ValueError, match="chunk"):
        ss.ssd_scan(*args, chunk=24)
    with pytest.raises(ValueError, match="dtypes"):
        ss.ssd_scan(x.half(), dt, A, Bm.half(), Cm.half(), chunk=8)
    with pytest.raises(ValueError, match="chunk"):
        ss.ssd_scan(x, dt.clone().requires_grad_(), A, Bm, Cm, chunk=24)
    assert ss.ssd_scan.launches == n0

    def plain(*a, **k):
        raise AssertionError("the plain version ran on a CUDA tensor")
    monkeypatch.setattr(ss, "ssd_scan_ref", plain)
    ss.ssd_scan(*args, chunk=8)
    assert ss.ssd_scan.launches == n0 + 1


def test_mamba2_serving_on_the_card_matches_the_cpu(cuda):
    """Reduced mamba2-370m in float32: greedy tokens on the card (the SSD
    scan kernel) equal the CPU's (plain versions) and the card Generator's,
    with one ssd_scan launch per layer and prefill call."""
    cfg = dataclasses.replace(get_config("mamba2-370m").reduced(),
                              dtype="float32")
    params = M.init_model(cfg, torch.Generator().manual_seed(0))
    scfg = ServeConfig(block_size=4, num_blocks=48, max_blocks_per_req=8,
                       max_slots=4, prefill_chunk=4, prefill_batch=4,
                       enable_prefix_cache=False)
    prompts = [list(range(1, 14)), list(range(20, 23)), list(range(30, 39))]
    max_new = [5, 7, 4]
    outs = {}
    for device in ("cpu", cuda):
        n0 = ss.ssd_scan.launches
        serve = HyperServe(cfg, params, device=device, serve_cfg=scfg)
        rids = [serve.submit(p, n) for p, n in zip(prompts, max_new)]
        out = serve.join()
        outs[str(device)] = [out[r] for r in rids]
        if device != "cpu":
            calls = serve.stats()["prefill_calls"]
            assert ss.ssd_scan.launches - n0 == cfg.num_layers * calls
    assert outs["cpu"] == outs[str(cuda)]
    gen = Generator(cfg, params, max_len=32, device=cuda)
    got = [gen.generate(torch.tensor([p], device=cuda), GenerateConfig(
        max_new_tokens=n))[0, len(p):].tolist()
        for p, n in zip(prompts, max_new)]
    assert got == outs["cpu"]


RG_ABS = 2e-5           # the RG-LRU scan's bf16 slack (module docstring)


def _rg_inputs(dtype, device, B, S, W, seed, *, init, pad=0,
               init_dtype=None):
    """x, input_gate, a_gate (dtype), log_a (float32) and an initial state
    (``init_dtype``, default dtype), at the reference kernel test's
    scales; row 0's last ``pad`` positions have a_gate = 0."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, S, W, generator=g) * 0.5
    ig = torch.sigmoid(torch.randn(B, S, W, generator=g))
    ag = torch.sigmoid(torch.randn(B, S, W, generator=g))
    if pad:
        ag[0, S - pad:] = 0.0
    la = -torch.nn.functional.softplus(-torch.linspace(2.0, 6.0, W))
    s0 = (torch.randn(B, W, generator=g).to(device, init_dtype or dtype)
          if init else None)
    return [t.to(device, dtype) for t in (x, ig, ag)] + [la.to(device)], s0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,W,init,pad", [
    (4, 256, 2560, True, 136),      # a serving prefill call, a padded row
    (2, 1024, 512, False, 0),       # the Generator's length
    (3, 1, 64, True, 0),            # one step
    (2, 100, 200, True, 100),       # a row all padding
    (2, 1023, 96, False, 7),        # odd lengths, a ragged last unroll
])
def test_rglru_scan_kernel_matches_plain_version(cuda, dtype, B, S, W, init,
                                                 pad):
    args, s0 = _rg_inputs(dtype, cuda, B, S, W, seed=S + W, init=init,
                          pad=pad)
    n0 = rs.rglru_scan.launches
    h, fin = rs.rglru_scan(*args, init_state=s0)
    assert rs.rglru_scan.launches == n0 + 1
    assert h.dtype == fin.dtype == dtype
    kw = dict(init_state=s0)
    _assert_close(h, lambda *a, **k: rs.rglru_scan_ref(*a, **k)[0], args, kw,
                  slack=RG_ABS)
    _assert_close(fin, lambda *a, **k: rs.rglru_scan_ref(*a, **k)[1], args,
                  kw, slack=RG_ABS)
    if pad:
        # a_gate = 0: a_t = 1, beta = 0; the carry passes through exactly
        held = s0[0] if pad == S else h[0, S - pad - 1]
        assert torch.equal(h[0, S - pad:], held.expand(pad, W))
        assert torch.equal(fin[0], held)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,W,with_state", [
    (2, 4096, 2560, False),          # recurrentgemma-2b's train rows
    (2, 1000, 512, True),
    (3, 1, 64, True),                # one step
    (2, 128, 96, True),              # whole 64-step chunks
    (2, 65, 40, False),              # a step past a chunk, a partial tile
    (2, 63, 40, True),               # a step short of one
    (1, 1023, 96, True),             # odd lengths, a ragged last unroll
    (1, 4096, 2560, False),          # the train step's one row exactly
    (2, 64, 130, True),              # one whole chunk; 128 + 2 channels
    (1, 1000, 2600, True),           # 15 chunks and 40 steps, W % 128 = 40
])
def test_rglru_bwd_kernel_matches_plain_version(cuda, dtype, B, S, W,
                                                with_state, monkeypatch):
    """The RG-LRU scan's backward kernel against ``rglru_scan_bwd_ref`` on
    dx, d input_gate, d a_gate, d log_a and d init_state (2e-5 x max(1,
    max |grad|) plus twice the plain version's own distance from float64:
    the kernel's f32 carries walk t in order, the plain version's a
    log-depth tree, and d log_a sums B x S terms), with and without an
    initial state and the final state's gradient, at the edges of its
    64-step chunks and 128-channel tiles; a second call bit for bit; through
    autograd, :class:`RGLRUScanFn` against autograd over the plain forward
    in f32, the plain versions barred from CUDA tensors."""
    args, s0 = _rg_inputs(dtype, cuda, B, S, W, seed=S + W + 1,
                          init=with_state)
    g = torch.Generator().manual_seed(S + 5)
    dh = torch.randn(B, S, W, generator=g).to(cuda, dtype)
    dfin = (torch.randn(B, W, generator=g).to(cuda, dtype)
            if with_state else None)
    n0 = rs.rglru_scan_bwd.launches
    got = rs.rglru_scan_bwd(*args, dh, dfin, init_state=s0)
    assert rs.rglru_scan_bwd.launches == n0 + 1
    want = rs.rglru_scan_bwd_ref(*args, dh, dfin, init_state=s0)
    f32 = lambda t: None if t is None else t.float()        # noqa: E731
    f64 = lambda t: None if t is None else t.double()       # noqa: E731
    want32 = rs.rglru_scan_bwd_ref(*map(f32, args), f32(dh), f32(dfin),
                                   init_state=f32(s0))
    want64 = rs.rglru_scan_bwd_ref(*map(f64, args), f64(dh), f64(dfin),
                                   init_state=f64(s0), acc=torch.float64)
    assert (got[4] is None) == (not with_state)
    for a, w, w32, w64 in zip(got, want, want32, want64):
        if a is None:
            continue
        assert a.dtype == w.dtype and a.shape == w.shape
        _ssd_close(a, w, w32, w64)
    again = rs.rglru_scan_bwd(*args, dh, dfin, init_state=s0)
    assert all(a is None or torch.equal(a, b) for a, b in zip(again, got))
    if dtype != torch.float32 or S > 1024:
        return
    leaves = [t.clone().requires_grad_() for t in args]
    init = None if s0 is None else s0.clone().requires_grad_()
    every = leaves + ([init] if init is not None else [])

    def loss(h, fin):
        out = (h * dh).sum()
        return out + (fin * dfin).sum() if dfin is not None else out
    auto = torch.autograd.grad(loss(*rs.rglru_scan_ref(
        *leaves, init_state=init)), every)

    def refuse(*a, **k):
        raise AssertionError("a plain version ran on a CUDA tensor")
    monkeypatch.setattr(rs, "rglru_scan_ref", refuse)
    monkeypatch.setattr(rs, "rglru_scan_bwd_ref", refuse)
    n0 = rs.rglru_scan.launches, rs.rglru_scan_bwd.launches
    through = torch.autograd.grad(loss(*rs.rglru_scan(
        *leaves, init_state=init)), every)
    monkeypatch.undo()
    assert (rs.rglru_scan.launches, rs.rglru_scan_bwd.launches) == (
        n0[0] + 1, n0[1] + 1)
    for a, w, w64 in zip(through, auto, want64):
        _ssd_close(a, w, w, w64)


def test_rglru_scan_kernel_takes_an_f32_state_and_strided_rows(cuda):
    """bf16 inputs with a float32 initial state (the port's pool may hold
    either), and x, input_gate and a_gate as strided views of wider rows,
    of every other step of a longer sequence, and one element in with odd
    strides: the same result bit for bit."""
    args, s0 = _rg_inputs(torch.bfloat16, cuda, 2, 64, 128, seed=3,
                          init=True, init_dtype=torch.float32)
    wide = torch.cat([a for a in args[:3]], dim=-1)          # (B, S, 3W)
    views = [wide[..., i * 128:(i + 1) * 128] for i in range(3)]
    got = rs.rglru_scan(*views, args[3], init_state=s0)
    want = rs.rglru_scan(*args, init_state=s0)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    tall = torch.zeros(2, 128, 3 * 128, dtype=torch.bfloat16, device=cuda)
    tall[:, ::2] = wide
    steps = [tall[:, ::2, i * 128:(i + 1) * 128] for i in range(3)]
    got = rs.rglru_scan(*steps, args[3], init_state=s0)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    _assert_close(got[0], lambda *a, **k: rs.rglru_scan_ref(*a, **k)[0],
                  args, dict(init_state=s0), slack=RG_ABS)
    odd = torch.cat([wide[..., :1], wide], dim=-1)           # (B, S, 3W + 1)
    got = rs.rglru_scan(*[odd[..., 1 + i * 128:1 + (i + 1) * 128]
                          for i in range(3)], args[3], init_state=s0)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


RG_L, RG_SEG = 8, 32    # csrc/rglru_scan.cu: RG_L steps a warp's chunk,
                        # RG_NW x RG_L a segment


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [RG_L - 1, RG_L, RG_L + 1, RG_SEG - 1, RG_SEG,
                               RG_SEG + 1, 1023, 1024])
def test_rglru_scan_kernel_at_the_edges_of_its_segments(cuda, dtype, S):
    """Lengths around a warp's chunk and a segment, and the Generator's
    1024 and one short of it, over a width whose last channel tile is
    partly past W; the final state is the last step's h bit for bit."""
    args, s0 = _rg_inputs(dtype, cuda, 2, S, 200, seed=S, init=True)
    n0 = rs.rglru_scan.launches
    h, fin = rs.rglru_scan(*args, init_state=s0)
    assert rs.rglru_scan.launches == n0 + 1
    kw = dict(init_state=s0)
    _assert_close(h, lambda *a, **k: rs.rglru_scan_ref(*a, **k)[0], args, kw,
                  slack=RG_ABS)
    _assert_close(fin, lambda *a, **k: rs.rglru_scan_ref(*a, **k)[1], args,
                  kw, slack=RG_ABS)
    assert torch.equal(fin, h[:, -1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [RG_SEG + 3, 256])
def test_rglru_scan_kernel_passes_a_padded_tail_through(cuda, dtype, S):
    """Rows padded past limits at and around a chunk's and a segment's
    edges (a_gate = 0 there, as the serving prefill chunk zeroes it) and a
    filler row (limit 0) with a zero state: every padded step holds the
    state at the limit and the final state equals it bit for bit, and the
    filler row stays zero."""
    limits = [0, 1, RG_L - 1, RG_L, RG_SEG - 1, RG_SEG, RG_SEG + 1, S - 1]
    args, s0 = _rg_inputs(dtype, cuda, len(limits), S, 200, seed=S + 1,
                          init=True)
    pos = torch.arange(S, device=cuda)
    lim = torch.tensor(limits, device=cuda)
    args[2] = args[2] * (pos[None, :] < lim[:, None])[..., None].to(dtype)
    s0[0] = 0.0
    h, fin = rs.rglru_scan(*args, init_state=s0)
    for r, n in enumerate(limits):
        held = s0[r] if n == 0 else h[r, n - 1]
        assert torch.equal(h[r, n:], held.expand(S - n, -1)), n
        assert torch.equal(fin[r], held), n
    assert not h[0].any() and not fin[0].any()
    kw = dict(init_state=s0)
    _assert_close(h, lambda *a, **k: rs.rglru_scan_ref(*a, **k)[0], args, kw,
                  slack=RG_ABS)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 50])
def test_attention_kernels_at_head_dim_256_and_ten_heads(cuda, dtype,
                                                         window):
    """recurrentgemma-2b's LOCAL_ATTN shape, (H, KV, D) = (10, 1, 256): the
    decode kernels take the 10 heads in two blocks of at most 8 and a
    64 KB combine buffer in dynamic shared memory; flash its (256, 256)
    tensor-core tiles (67.6 KB); each matches its plain version."""
    H, KV, D, bs = 10, 1, 256, 16
    g = torch.Generator().manual_seed(21)

    def rnd(*shape):
        return torch.randn(*shape, generator=g).to(cuda, dtype)
    nb = 64
    k_pool, v_pool = rnd(nb, bs, KV, D), rnd(nb, bs, KV, D)
    tables = (torch.randperm(nb - 1, generator=g)[:4 * 15] + 1).reshape(
        4, 15).to(cuda, torch.int32)
    lengths = torch.tensor([1, 17, 130, 240], dtype=torch.int32, device=cuda)
    kw = dict(block_size=bs, window=window)
    n0 = pda.paged_decode_attention.launches
    args = (rnd(4, 1, H, D), k_pool, v_pool, tables, lengths)
    _assert_close(pda.paged_decode_attention(*args, **kw),
                  pda.paged_decode_attention_ref, args, kw)
    assert pda.paged_decode_attention.launches == n0 + 1
    starts = torch.tensor([0, 60, 150, 0], dtype=torch.int32, device=cuda)
    limits = torch.tensor([40, 90, 170, 0], dtype=torch.int32, device=cuda)
    args = (rnd(4, 40, H, D), k_pool, v_pool, tables, starts, limits)
    got = rpa.ragged_prefill_attention(*args, **kw)
    _assert_close(got, rpa.ragged_prefill_attention_ref, args, kw)
    assert bool((got[3] == 0).all())             # the filler row
    q, k, v = rnd(2, 150, H, D), rnd(2, 150, KV, D), rnd(2, 150, KV, D)
    for fkw in (dict(causal=True, window=window),
                dict(causal=True, window=window, q_offset=torch.tensor(
                    [0, 70], dtype=torch.int32, device=cuda))):
        qq = q if "q_offset" not in fkw else q[:, :80]
        _assert_close(fa.flash_attention(qq, k, v, **fkw),
                      fa.flash_attention_ref, (qq, k, v), fkw)
    lens = torch.tensor([1, 50, 149, 150], dtype=torch.int32, device=cuda)
    kd, vd = rnd(4, 150, KV, D), rnd(4, 150, KV, D)
    args = (rnd(4, 1, H, D), kd, vd, lens)
    _assert_close(da.decode_attention(*args, window=window),
                  da.decode_attention_ref, args, dict(window=window))


def test_unsupported_shapes_raise_and_never_fall_back(cuda, monkeypatch):
    """A head dim no kernel was built for, a head count that is no multiple
    of the kv heads, a float16 RG-LRU input or a float64 log_a are refused
    before any launch, with no plain version run in their place; on a CUDA
    tensor the RG-LRU wrapper never runs its plain version."""
    g = torch.Generator().manual_seed(2)

    def rnd(*shape):
        return torch.randn(*shape, generator=g).to(cuda)
    pool = rnd(8, 4, 1, 96)
    tables = torch.ones(2, 2, dtype=torch.int32, device=cuda)
    lengths = torch.tensor([3, 5], dtype=torch.int32, device=cuda)
    n0 = (pda.paged_decode_attention.launches, da.decode_attention.launches,
          rs.rglru_scan.launches)
    with pytest.raises(ValueError, match="head dims"):
        pda.paged_decode_attention(rnd(2, 1, 10, 96), pool, pool, tables,
                                   lengths, block_size=4)
    with pytest.raises(ValueError, match="H % KV"):
        da.decode_attention(rnd(2, 1, 10, 64), rnd(2, 8, 3, 64),
                            rnd(2, 8, 3, 64), lengths)
    args, _ = _rg_inputs(torch.float32, cuda, 2, 8, 16, seed=1, init=False)
    with pytest.raises(ValueError, match="dtypes"):
        rs.rglru_scan(*[a.half() for a in args[:3]], args[3])
    with pytest.raises(ValueError, match="log_a"):
        rs.rglru_scan(*args[:3], args[3].double())
    assert (pda.paged_decode_attention.launches,
            da.decode_attention.launches, rs.rglru_scan.launches) == n0

    def plain(*a, **k):
        raise AssertionError("the plain version ran on a CUDA tensor")
    monkeypatch.setattr(rs, "rglru_scan_ref", plain)
    rs.rglru_scan(*args)
    assert rs.rglru_scan.launches == n0[2] + 1


def test_hybrid_serving_on_the_card_matches_the_cpu(cuda):
    """Reduced recurrentgemma-2b (5 layers, window 16) in float32: greedy
    tokens on the card, fused and composed, equal the CPU's through window
    freeing, with one rglru_scan launch per RG-LRU layer and prefill call
    and one paged_decode_attention per LOCAL_ATTN layer and decode step."""
    cfg = dataclasses.replace(get_config("recurrentgemma-2b").reduced(),
                              dtype="float32", num_layers=5,
                              sliding_window=16)
    params = M.init_model(cfg, torch.Generator().manual_seed(0))
    scfg = ServeConfig(block_size=4, num_blocks=40, max_blocks_per_req=12,
                       max_slots=2, prefill_chunk=4)
    prompts, max_new = [list(range(1, 9)), list(range(20, 33))], [20, 16]
    n_rg = sum(m == "rglru" for m, _ in cfg.block_kinds())
    n_attn = cfg.num_layers - n_rg
    outs = {}
    for device, kernels in (("cpu", "fused"), (cuda, "fused"),
                            (cuda, "composed")):
        n0 = (rs.rglru_scan.launches, pda.paged_decode_attention.launches)
        serve = HyperServe(cfg, params, device=device,
                           serve_cfg=dataclasses.replace(scfg,
                                                         kernels=kernels))
        rids = [serve.submit(p, n) for p, n in zip(prompts, max_new)]
        out = serve.join()
        outs[str(device), kernels] = [out[r] for r in rids]
        if device != "cpu":
            m = serve.engine.obs.metrics
            calls = serve.stats()["prefill_calls"]
            steps = m.counter(f"serve.kernels.decode.{kernels}").value
            assert rs.rglru_scan.launches - n0[0] == n_rg * calls
            assert pda.paged_decode_attention.launches - n0[1] == (
                n_attn * steps if kernels == "fused" else 0)
    assert len(set(map(str, outs.values()))) == 1, outs


def test_train_step_on_a_one_rank_nccl_mesh(cuda, tmp_path):
    """Reduced qwen2-0.5b in float32: one train step on a (1, 1) NCCL mesh
    under ``ShardingPlan()`` (DTensor params, moments and batch; flash's
    kernels under ``local_map``) against the unsharded step on the card
    from the same state and batch: loss and grad norm within 1e-5
    relative, params within 2e-5 x max(1, |p|), with two flash forward
    launches and one backward call a layer in each step."""
    import torch.distributed as dist

    from repro_torch.core import hypershard as hs
    from repro_torch.data.pipeline import DataConfig, make_loader
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.bridge import full_params, shard_params
    from repro_torch.optim import adamw as opt
    from repro_torch.train import steps
    cfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(),
                              dtype="float32")
    acfg = opt.AdamWConfig(total_steps=1)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=2)
    p0 = M.init_model(cfg, torch.Generator(device=cuda).manual_seed(0))
    p1, _, m1 = steps.make_train_step(cfg, acfg)(
        p0, opt.init_adamw(p0), next(make_loader(dcfg, cuda)))
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = make_host_mesh((1, 1))
        step = steps.make_train_step(cfg, acfg, mesh=mesh,
                                     plan=hs.ShardingPlan())
        dp = shard_params(p0, mesh)
        n0 = (fa.flash_attention.launches, fa.flash_attention_bwd.launches)
        p2, _, m2 = step(dp, opt.init_adamw(dp),
                         next(make_loader(dcfg, cuda, mesh=mesh)))
        assert (fa.flash_attention.launches - n0[0],
                fa.flash_attention_bwd.launches - n0[1]) == \
            (2 * cfg.num_layers, cfg.num_layers)
        for k in ("loss", "grad_norm"):
            a, b = float(m2[k]), float(m1[k])
            assert abs(a - b) <= 1e-5 * max(1.0, abs(b)), k
        full = full_params(p2)
        for a, b in zip(torch.utils._pytree.tree_leaves(full),
                        torch.utils._pytree.tree_leaves(p1)):
            assert (a - b).abs().max().item() <= 2e-5 * max(
                1.0, b.abs().max().item())
    finally:
        dist.destroy_process_group()


@pytest.fixture
def one_rank_mesh(cuda, tmp_path):
    """A (1, 1) mesh over a one-rank NCCL group (a file store in the
    test's temporary directory), destroyed after the test."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        yield make_host_mesh((1, 1))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_serving_kernels_take_dtensors_on_a_one_rank_nccl_mesh(
        one_rank_mesh, cuda, dtype):
    """The paged decode, the ragged prefill and the two scans handed
    DTensor inputs on a (1, 1) NCCL mesh (side inputs plain, as the
    serving steps hand them over): one launch a call each, under
    ``local_map``, and a DTensor out whose local tensor is within the
    limits above of the plain version on the same local tensors."""
    from torch.distributed.tensor import DTensor, Replicate

    def on_mesh(t):
        return None if t is None else DTensor.from_local(
            t, one_rank_mesh, [Replicate(), Replicate()], run_check=False)

    k_pool, v_pool, tables, q_dec, q_pre = _inputs(dtype, cuda)
    lengths = torch.tensor([10, 3, 24], dtype=torch.int32, device=cuda)
    starts = torch.tensor([0, 5, 16, 0], dtype=torch.int32, device=cuda)
    limits = torch.tensor([12, 13, 24, 0], dtype=torch.int32, device=cuda)
    for window in (None, 7):
        kw = dict(block_size=BS, window=window)
        for wrapper, ref, args in (
                (pda.paged_decode_attention, pda.paged_decode_attention_ref,
                 (q_dec, k_pool, v_pool, tables[:3], lengths)),
                (rpa.ragged_prefill_attention,
                 rpa.ragged_prefill_attention_ref,
                 (q_pre, k_pool, v_pool, tables, starts, limits))):
            n0 = wrapper.launches
            got = wrapper(*map(on_mesh, args[:3]), *args[3:], **kw)
            assert wrapper.launches == n0 + 1
            assert isinstance(got, DTensor)
            _assert_close(got.to_local(), ref, args, kw)
    args, s0 = _ssd_inputs(dtype, cuda, 2, 200, 3, 64, 128, seed=5,
                           init=True)
    n0 = ss.ssd_scan.launches
    y, fin = ss.ssd_scan(*map(on_mesh, args), chunk=100,
                         init_state=on_mesh(s0))
    assert ss.ssd_scan.launches == n0 + 1
    want = ss.ssd_scan_ref(*args, chunk=100, init_state=s0)
    want32 = ss.ssd_scan_ref(*[a.float() for a in args], chunk=100,
                             init_state=s0.float())
    want64 = ss.ssd_scan_ref(*[a.double() for a in args], chunk=100,
                             init_state=s0.double(), acc=torch.float64)
    for g, w, w32, w64 in zip((y, fin), want, want32, want64):
        _ssd_close(g.to_local(), w, w32, w64)
    args, s0 = _rg_inputs(dtype, cuda, 4, 256, 512, seed=6, init=True,
                          pad=36)
    n0 = rs.rglru_scan.launches
    h, fin = rs.rglru_scan(*map(on_mesh, args), init_state=on_mesh(s0))
    assert rs.rglru_scan.launches == n0 + 1
    for i, got in enumerate((h, fin)):
        _assert_close(got.to_local(),
                      lambda *a, **k: rs.rglru_scan_ref(*a, **k)[i], args,
                      dict(init_state=s0), slack=RG_ABS)


def test_serving_on_a_one_rank_nccl_mesh_matches_no_mesh(one_rank_mesh,
                                                         cuda):
    """Reduced qwen2-0.5b, mamba2-370m and recurrentgemma-2b (3 layers,
    window 16) in float32: HyperServe on the (1, 1) NCCL mesh under
    ``ShardingPlan(fsdp=None)`` gives the tokens and the launch counts of
    the same engine without a mesh (the same kernels on the same
    tensors)."""
    kernels = (pda.paged_decode_attention, rpa.ragged_prefill_attention,
               ss.ssd_scan, rs.rglru_scan)
    scfg = ServeConfig(block_size=4, num_blocks=48, max_blocks_per_req=8,
                       max_slots=2, prefill_chunk=4)
    prompts = [list(range(1, 9)), list(range(5, 10))]
    for arch, kw in (("qwen2-0.5b", {}), ("mamba2-370m", {}),
                     ("recurrentgemma-2b",
                      dict(num_layers=3, sliding_window=16))):
        cfg = dataclasses.replace(get_config(arch).reduced(),
                                  dtype="float32", **kw)
        params = M.init_model(cfg, torch.Generator(device=cuda).manual_seed(0))
        runs = []
        for mesh in (None, one_rank_mesh):
            n0 = [k.launches for k in kernels]
            serve = HyperServe(cfg, params, serve_cfg=scfg, mesh=mesh)
            rids = [serve.submit(p, 6) for p in prompts]
            out = serve.join()
            runs.append(([out[r] for r in rids],
                         [k.launches - n for k, n in zip(kernels, n0)]))
        assert runs[0] == runs[1], arch
        assert sum(runs[1][1]) > 0, arch


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_deepseek_kernels_take_dtensors_on_a_one_rank_nccl_mesh(
        one_rank_mesh, cuda, dtype):
    """The MLA decode, the grouped matmul, its backward's dx and dw, and
    flash's forward (with its lse) and backward at (Dk, Dv) = (192, 128),
    each handed DTensor inputs on a (1, 1) NCCL mesh (the tables, lengths
    and group sizes plain, as the steps hand them over): one launch a call
    each, under ``local_map``, and DTensors out whose local tensors are
    within the limits above of the plain versions on the same local
    tensors.  The grouped matmul's sizes sum to 16 rows less than x holds
    (the expert-parallel dispatch's rows of other ranks' experts): the
    rows within the sum are checked, in the forward and in dx."""
    from torch.distributed.tensor import DTensor, Replicate

    def on_mesh(t):
        return DTensor.from_local(t, one_rank_mesh, [Replicate()] * 2,
                                  run_check=False)

    args = _mla_inputs(dtype, cuda, 16, 512, 64, 16, [1, 65, 700, 257],
                       seed=3)
    kw = dict(block_size=16, scale=576 ** -0.5)
    n0 = pda.paged_mla_decode_attention.launches
    got = pda.paged_mla_decode_attention(*map(on_mesh, args[:4]), *args[4:],
                                         **kw)
    assert pda.paged_mla_decode_attention.launches == n0 + 1
    assert isinstance(got, DTensor)
    want = pda.paged_mla_decode_attention_ref(*args, **kw)
    tol = 2e-5 if dtype == torch.float32 else 1e-4
    assert (got.to_local() - want).abs().max().item() < tol

    sizes = [1] * 40 + [0] * 20 + [14, 0, 30, 12]
    x, w, gs = _gm_inputs(dtype, cuda, sizes, 2048, 1408, seed=9)
    S = x.shape[0]
    g = torch.Generator().manual_seed(10)
    x = torch.cat([x, torch.randn(16, 2048, generator=g).to(cuda, dtype)])
    dy = torch.randn(S + 16, 1408, generator=g).to(cuda, dtype)
    n0 = _gm_counts()
    out = gm.grouped_matmul(on_mesh(x), on_mesh(w), gs)
    dx = gm.grouped_matmul_bwd_dx(on_mesh(dy), on_mesh(w), gs)
    dw = gm.grouped_matmul_bwd_dw(on_mesh(x), on_mesh(dy), gs)
    assert _gm_counts() == (n0[0] + 1, n0[1] + 1, n0[2] + 1)
    assert all(isinstance(t, DTensor) for t in (out, dx, dw))
    _assert_close(out.to_local()[:S], gm.grouped_matmul_ref,
                  (x[:S], w, gs), {}, slack=GM_SLACK)
    bwd = (x[:S], w, gs, dy[:S])
    want = gm.grouped_matmul_bwd_ref(*bwd)
    want32 = gm.grouped_matmul_bwd_ref(
        *[a.float() if a.is_floating_point() else a for a in bwd])
    want64 = gm.grouped_matmul_bwd_ref(
        *[a.double() if a.is_floating_point() else a for a in bwd],
        acc=torch.float64)
    for got_, a, b, c in zip((dx.to_local()[:S], dw.to_local()), want,
                             want32, want64):
        _gm_grad_close(got_, a, b, c)

    g = torch.Generator().manual_seed(11)
    q, k, v, do = (torch.randn(1, 192, 4, d, generator=g).to(cuda, dtype)
                   for d in (192, 192, 128, 128))
    n0 = (fa.flash_attention.launches, fa.flash_attention_bwd.launches)
    o, lse = fa.flash_attention_lse(*map(on_mesh, (q, k, v)), causal=True)
    grads = fa.flash_attention_bwd(*map(on_mesh, (q, k, v, o.to_local(),
                                                  lse.to_local(), do)),
                                   causal=True)
    assert (fa.flash_attention.launches, fa.flash_attention_bwd.launches) \
        == (n0[0] + 1, n0[1] + 1)
    _assert_close(o.to_local(), fa.flash_attention_ref, (q, k, v),
                  dict(causal=True))
    bargs = (q, k, v, o.to_local(), lse.to_local(), do)
    want = fa.flash_attention_bwd_ref(*bargs, causal=True)
    want32 = fa.flash_attention_bwd_ref(*(t.float() for t in bargs),
                                        causal=True)
    for got_, a, b in zip(grads, want, want32):
        _assert_grad_close(got_.to_local(), a, b)


def test_deepseek_on_a_one_rank_nccl_mesh_matches_no_mesh(one_rank_mesh,
                                                          cuda):
    """Reduced deepseek-v2-lite-16b (MLA + MoE) and deepseek-moe-16b in
    float32: HyperServe on the (1, 1) NCCL mesh gives the tokens and the
    launch counts of the same engine without a mesh; and two train steps of
    deepseek-v2-lite under gshard and under ragged on the mesh (fsdp_tp)
    give the losses and grad norms of the run without one within 1e-5
    relative, with the same launches of every train kernel."""
    from repro_torch.data.pipeline import DataConfig, make_loader
    from repro_torch.optim import adamw as opt
    from repro_torch.train import steps
    kernels = (pda.paged_mla_decode_attention, fa.flash_attention,
               fa.flash_attention_bwd, gm.grouped_matmul,
               gm.grouped_matmul_bwd_dx, gm.grouped_matmul_bwd_dw)
    scfg = ServeConfig(block_size=4, num_blocks=48, max_blocks_per_req=8,
                       max_slots=2, prefill_chunk=4)
    for arch in ("deepseek-v2-lite-16b", "deepseek-moe-16b"):
        cfg = dataclasses.replace(get_config(arch).reduced(),
                                  dtype="float32")
        params = M.init_model(cfg, torch.Generator(device=cuda).manual_seed(0))
        runs = []
        for mesh in (None, one_rank_mesh):
            n0 = [k.launches for k in kernels]
            serve = HyperServe(cfg, params, serve_cfg=scfg, mesh=mesh)
            rids = [serve.submit(p, 6) for p in ([1, 2, 3, 4, 5, 6, 7, 8],
                                                 list(range(20, 33)))]
            out = serve.join()
            runs.append(([out[r] for r in rids],
                         [k.launches - n for k, n in zip(kernels, n0)]))
        assert runs[0] == runs[1], arch
        assert runs[1][1][3] > 0, arch
    cfg = dataclasses.replace(get_config("deepseek-v2-lite-16b").reduced(),
                              dtype="float32")
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=2)
    for dispatch in ("gshard", "ragged"):
        runs = []
        for mesh in (None, one_rank_mesh):
            n0 = [k.launches for k in kernels]
            step = steps.make_train_step(cfg, opt.AdamWConfig(total_steps=2),
                                         moe_dispatch=dispatch, mesh=mesh)
            p, o = steps.init_state(cfg, seed=0, device=cuda, mesh=mesh)
            loader = make_loader(dcfg, cuda, mesh=mesh)
            hist = []
            for _ in range(2):
                p, o, m = step(p, o, next(loader))
                hist.append((float(m["loss"]), float(m["grad_norm"])))
            runs.append((hist, [k.launches - n for k, n in zip(kernels, n0)]))
        assert runs[0][1] == runs[1][1], dispatch
        assert (runs[1][1][4] > 0) == (dispatch == "ragged")
        for a, b in zip(runs[1][0], runs[0][0]):
            for x, y in zip(a, b):
                assert abs(x - y) <= 1e-5 * max(1.0, abs(y)), dispatch


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_takes_dtensors_on_a_one_rank_nccl_mesh(
        one_rank_mesh, cuda, dtype):
    """The dense decode handed DTensor q and caches on a (1, 1) NCCL mesh
    (the lengths plain, as the composed decode hands them over), plain and
    windowed, at qwen2's (14, 2, 64) and recurrentgemma's (10, 1, 256):
    one launch a call, under ``local_map``, a DTensor out whose local
    tensor is within the limits above of the plain version; an input that
    requires grad is refused on DTensors too."""
    from torch.distributed.tensor import DTensor, Replicate

    def on_mesh(t):
        return DTensor.from_local(t, one_rank_mesh, [Replicate()] * 2,
                                  run_check=False)
    g = torch.Generator().manual_seed(12)
    for heads, kv, dim, window in ((14, 2, 64, None), (14, 2, 64, 7),
                                   (10, 1, 256, None), (10, 1, 256, 40)):
        q = torch.randn(4, 1, heads, dim, generator=g).to(cuda, dtype)
        k, v = (torch.randn(4, 96, kv, dim, generator=g).to(cuda, dtype)
                for _ in range(2))
        lengths = torch.tensor([96, 1, 50, 33], dtype=torch.int32,
                               device=cuda)
        n0 = da.decode_attention.launches
        got = da.decode_attention(on_mesh(q), on_mesh(k), on_mesh(v),
                                  lengths, window=window)
        assert da.decode_attention.launches == n0 + 1
        assert isinstance(got, DTensor)
        _assert_close(got.to_local(), da.decode_attention_ref,
                      (q, k, v, lengths), dict(window=window))
    with pytest.raises(RuntimeError, match="requires grad"):
        da.decode_attention(on_mesh(q.requires_grad_(True)), on_mesh(k),
                            on_mesh(v), lengths)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scans_with_gradients_take_dtensors_on_a_one_rank_nccl_mesh(
        one_rank_mesh, cuda, dtype):
    """``SSDScanFn`` and ``RGLRUScanFn`` under ``local_map`` on a (1, 1)
    NCCL mesh (the train step's path): the forward and every input's
    gradient of sum(y * w) against the same call without a mesh (the same
    kernels on the same tensors: within 1e-6 x max(1, |value|)), one
    forward launch and one backward call each; and ``ssd_scan_bwd`` and
    ``rglru_scan_bwd`` called on DTensors directly, the same against their
    calls on the plain tensors."""
    from repro_torch.core.meshctx import full_tensor
    from torch.distributed.tensor import DTensor, Replicate

    def on_mesh(t):
        return DTensor.from_local(t, one_rank_mesh, [Replicate()] * 2,
                                  run_check=False)

    def close(got, want):
        got = full_tensor(got)
        lim = 1e-6 * max(1.0, want.float().abs().max().item())
        assert (got.float() - want.float()).abs().max().item() <= lim

    def both(fn, args, w, counters):
        outs = []
        for mesh in (False, True):
            leaves = [a.detach().clone().requires_grad_(True) for a in args]
            n0 = [c.launches for c in counters]
            ins = [on_mesh(t) if mesh else t for t in leaves]
            y = fn(*ins)
            grads = torch.autograd.grad((y * (on_mesh(w) if mesh else w))
                                        .sum(), ins)
            assert [c.launches - n for c, n in zip(counters, n0)] == [1, 1]
            outs.append((y.detach(), grads))
        for a, b in zip((outs[1][0], *outs[1][1]), (outs[0][0],
                                                    *outs[0][1])):
            close(a, b)

    args, _ = _ssd_inputs(dtype, cuda, 2, 256, 32, 64, 128, seed=21,
                          init=False)
    g = torch.Generator().manual_seed(22)
    w = torch.randn(2, 256, 32, 64, generator=g).to(cuda, dtype)
    both(lambda *t: ss.ssd_scan(*t, chunk=64)[0], args, w,
         (ss.ssd_scan, ss.ssd_scan_bwd))
    want = ss.ssd_scan_bwd(*args, w, None, chunk=64)
    got = ss.ssd_scan_bwd(*map(on_mesh, args), on_mesh(w), None, chunk=64)
    for a, b in zip(got[:5], want[:5]):
        close(a, b)
    args, _ = _rg_inputs(dtype, cuda, 2, 300, 256, seed=23, init=False)
    w = torch.randn(2, 300, 256, generator=g).to(cuda, dtype)
    both(lambda *t: rs.rglru_scan(*t)[0], args, w,
         (rs.rglru_scan, rs.rglru_scan_bwd))
    want = rs.rglru_scan_bwd(*args, w, None)
    got = rs.rglru_scan_bwd(*map(on_mesh, args), on_mesh(w), None)
    for a, b in zip(got[:4], want[:4]):
        close(a, b)


def test_recurrent_and_prefix_training_on_a_one_rank_nccl_mesh(
        one_rank_mesh, cuda):
    """Reduced mamba2-370m, recurrentgemma-2b (3 layers, window 8) and
    musicgen-large (with a seeded prefix, its rows placed by
    ``data.pipeline.place_prefix``) in float32: two fsdp_tp train steps
    on the (1, 1) NCCL mesh give the losses and grad norms of the run
    without one within 1e-5 relative, with the same launches of every
    scan, scan backward and flash kernel (both scans' backwards under
    ``local_map``)."""
    from repro_torch.data.pipeline import (DataConfig, make_loader,
                                           place_prefix)
    from repro_torch.optim import adamw as opt
    from repro_torch.train import steps
    kernels = (ss.ssd_scan, ss.ssd_scan_bwd, rs.rglru_scan,
               rs.rglru_scan_bwd, fa.flash_attention, fa.flash_attention_bwd)
    for arch, kw in (("mamba2-370m", {}),
                     ("recurrentgemma-2b",
                      dict(num_layers=3, sliding_window=8)),
                     ("musicgen-large", {})):
        cfg = dataclasses.replace(get_config(arch).reduced(),
                                  dtype="float32", **kw)
        mm = bool(cfg.frontend_dim)
        dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                          global_batch=2)
        g = torch.Generator().manual_seed(31)
        prefix = [torch.randn(2, cfg.num_prefix_tokens, cfg.frontend_dim,
                              generator=g).to(cuda) for _ in range(2)] \
            if mm else [None, None]
        runs = []
        for mesh in (None, one_rank_mesh):
            n0 = [k.launches for k in kernels]
            step = steps.make_train_step(cfg, opt.AdamWConfig(total_steps=2),
                                         mesh=mesh, multimodal=mm)
            p, o = steps.init_state(cfg, seed=0, device=cuda, mesh=mesh)
            loader = make_loader(dcfg, cuda, mesh=mesh)
            hist = []
            for pe in prefix:
                batch = next(loader)
                if mm:
                    batch["prefix_embeds"] = place_prefix(pe, mesh)
                p, o, m = step(p, o, batch)
                hist.append((float(m["loss"]), float(m["grad_norm"])))
            runs.append((hist, [k.launches - n for k, n in zip(kernels, n0)]))
        assert runs[0][1] == runs[1][1] and sum(runs[1][1]) > 0, arch
        for a, b in zip(runs[1][0], runs[0][0]):
            for x, y in zip(a, b):
                assert abs(x - y) <= 1e-5 * max(1.0, abs(y)), arch


def test_composed_serving_on_a_one_rank_nccl_mesh_matches_fused(
        one_rank_mesh, cuda):
    """Reduced qwen2-0.5b, recurrentgemma-2b (5 layers, window 16,
    generation past it), deepseek-v2-lite-16b (MLA's composed decode) and
    internvl2-26b (text-only) in float32: HyperServe with
    ``kernels="composed"`` on the (1, 1) NCCL mesh gives the tokens of the
    fused engine without a mesh, with ``decode_attention`` launched on
    the mesh where the arch has GQA attention layers and no fused decode
    launched."""
    scfg = ServeConfig(block_size=4, num_blocks=48, max_blocks_per_req=12,
                       max_slots=2, prefill_chunk=4)
    prompts = [list(range(1, 9)), list(range(20, 33))]
    for arch, kw in (("qwen2-0.5b", {}),
                     ("recurrentgemma-2b",
                      dict(num_layers=5, sliding_window=16)),
                     ("deepseek-v2-lite-16b", {}), ("internvl2-26b", {})):
        cfg = dataclasses.replace(get_config(arch).reduced(),
                                  dtype="float32", **kw)
        params = M.init_model(cfg, torch.Generator(device=cuda).manual_seed(0))
        runs = []
        for mesh, kernels in ((None, "fused"), (one_rank_mesh, "composed")):
            n0 = (da.decode_attention.launches,
                  pda.paged_decode_attention.launches)
            serve = HyperServe(cfg, params, mesh=mesh, serve_cfg=(
                dataclasses.replace(scfg, kernels=kernels)))
            rids = [serve.submit(p, 20) for p in prompts]
            out = serve.join()
            runs.append(([out[r] for r in rids],
                         (da.decode_attention.launches - n0[0],
                          pda.paged_decode_attention.launches - n0[1])))
        assert runs[1][0] == runs[0][0], arch
        assert runs[1][1][1] == 0, arch
        assert (runs[1][1][0] > 0) == (arch != "deepseek-v2-lite-16b"), arch


# ---------------------------------------------------------------------------
# HyperMPMD's hand-offs between two processes on the one card: gloo (NCCL
# refuses two ranks on one card), the bytes through pinned host buffers
# ---------------------------------------------------------------------------
HAND_OFF_PEER = """
import sys, datetime
sys.path.insert(0, sys.argv[2])
import torch, torch.distributed as dist
from repro_torch.core import mpmd
torch.cuda.set_device(0)
dist.init_process_group("gloo", init_method=f"file://{sys.argv[1]}/store",
                        rank=1, world_size=2,
                        timeout=datetime.timedelta(seconds=120))
from tests_hand_off import tree
src, dst = mpmd.ProcessGroup("src", (1,)), mpmd.ProcessGroup("dst", (0,))
mpmd.transfer(tree(sys.argv[3], torch.device("cuda")), src, dst)
back = mpmd.transfer(None, dst, src, device="cuda")
assert all(torch.equal(a, b) for a, b in zip(
    mpmd.tree_leaves(back), mpmd.tree_leaves(tree(sys.argv[3], "cuda"))))
dist.destroy_process_group()
"""


def hand_off_tree(kind, device):
    """A seeded tree as phase 42 hands over (KV pages: bf16 caches of two
    layer segments, odd row counts, and f32 logits rows) or as phase 44
    publishes (params: bf16 matrices, an f32 norm, an odd-length bf16
    vector that leaves the next leaf's bytes unaligned without padding)."""
    g = torch.Generator(device=device).manual_seed(3)

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device=device).to(dtype)
    if kind == "pages":
        return {"logits": rnd(3, 1024, dtype=torch.float32),
                "caches": {f"seg{i}": ({"k": rnd(2, 3, 37, 2, 64),
                                        "v": rnd(2, 3, 37, 2, 64)},)
                           for i in range(2)}}
    return {"embed": rnd(1000, 96), "seg0": ({"attn": {
        "bq": rnd(7), "wq": rnd(96, 128, dtype=torch.float32)},
        "norm": rnd(96, dtype=torch.float32)},)}


@pytest.mark.parametrize("kind", ["pages", "params"])
def test_hand_off_between_two_processes_is_exact(cuda, tmp_path, kind):
    """A peer process on the same card hands a tree of CUDA tensors to
    this one through ``mpmd.transfer`` (gloo, staged through pinned host
    memory) and takes it back: both copies equal the seeded tree, bit for
    bit, dtypes and shapes kept."""
    import os
    import subprocess
    import sys

    import torch.distributed as dist

    from repro_torch.core import mpmd
    src_dir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    (tmp_path / "tests_hand_off.py").write_text(
        "import torch\n" + __import__("inspect").getsource(hand_off_tree)
        .replace("def hand_off_tree", "def tree"))
    peer = subprocess.Popen(
        [sys.executable, "-c", HAND_OFF_PEER, str(tmp_path), src_dir, kind],
        env=dict(os.environ, PYTHONPATH=f"{tmp_path}:{src_dir}"))
    try:
        import datetime
        dist.init_process_group(
            "gloo", init_method=f"file://{tmp_path}/store", rank=0,
            world_size=2, timeout=datetime.timedelta(seconds=120))
        try:
            src, dst = mpmd.ProcessGroup("src", (1,)), \
                mpmd.ProcessGroup("dst", (0,))
            got = mpmd.transfer(None, src, dst, device=cuda)
            want = hand_off_tree(kind, cuda)
            for a, b in zip(mpmd.tree_leaves(got), mpmd.tree_leaves(want)):
                assert a.device.type == "cuda" and a.dtype == b.dtype
                assert torch.equal(a, b)
            mpmd.transfer(got, dst, src)
        finally:
            dist.destroy_process_group()
        assert peer.wait(timeout=120) == 0
    finally:
        if peer.poll() is None:
            peer.kill()


# ---------------------------------------------------------------------------
# the 1F1B pipeline trainer on the card: colocated, and its hand-off of an
# activation between two processes
# ---------------------------------------------------------------------------
def test_colocated_pipeline_step_matches_the_plain_step_on_the_card(cuda):
    """Reduced qwen2-0.5b in float32 (tied embeddings): one colocated
    pipeline step (2 stages, 2 micro-batches) against the non-pipelined
    train step on the card from the same params (both drawn at seed 0,
    the trainer by ``steps.init_state``) and batch: loss and grad
    norm within 1e-5 relative, every param within 2e-5 x max(1, |p|), and
    two flash forwards and one backward a layer and micro-batch."""
    from repro_torch.configs.base import PipelineConfig
    from repro_torch.core.tree import tree_flatten_with_path
    from repro_torch.data.pipeline import DataConfig, make_loader
    from repro_torch.optim import adamw as opt
    from repro_torch.train import steps
    from repro_torch.train.pipeline_trainer import PipelineTrainer
    cfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(),
                              dtype="float32")
    acfg = opt.AdamWConfig(total_steps=1)
    batch = next(make_loader(DataConfig(vocab_size=cfg.vocab_size,
                                        seq_len=64, global_batch=4), cuda))
    p0 = M.init_model(cfg, torch.Generator(device=cuda).manual_seed(0))
    p1, _, m1 = steps.make_train_step(cfg, acfg)(p0, opt.init_adamw(p0),
                                                 batch)
    tr = PipelineTrainer(cfg, PipelineConfig(stages=2, micro_batches=2),
                         adamw=acfg, device=cuda)
    n0 = (fa.flash_attention.launches, fa.flash_attention_bwd.launches)
    m2 = tr.step(batch)
    assert (fa.flash_attention.launches - n0[0],
            fa.flash_attention_bwd.launches - n0[1]) == \
        (2 * cfg.num_layers * 2, cfg.num_layers * 2)
    for k in ("loss", "grad_norm"):
        a, b = float(m2[k]), float(m1[k])
        assert abs(a - b) <= 1e-5 * max(1.0, abs(b)), k
    want = dict(tree_flatten_with_path(p1))
    got = dict(tree_flatten_with_path(tr.merged_params()))
    assert sorted(got) == sorted(want)
    for k, b in want.items():
        a = got[k]
        assert a.device.type == "cuda"
        assert float((a - b).abs().max()) <= 2e-5 * max(
            1.0, float(b.abs().max())), k


PIPELINE_PEER = """
import sys, datetime
sys.path.insert(0, sys.argv[2])
import torch, torch.distributed as dist
from repro_torch.core import mpmd
torch.cuda.set_device(0)
dist.init_process_group("gloo", init_method=f"file://{sys.argv[1]}/store",
                        rank=1, world_size=2,
                        timeout=datetime.timedelta(seconds=120))
s0, s1 = mpmd.ProcessGroup("stage0", (0,)), mpmd.ProcessGroup("stage1", (1,))
wire = mpmd.Handoff()
x = wire.recv((1, 4096, 896), torch.bfloat16, s0, s1, "cuda")
wire.send(x, s1, s0)
wire.wait()
dist.destroy_process_group()
"""


def test_pipeline_handoff_between_two_processes_is_exact(cuda, tmp_path):
    """A stage's activation at qwen2-0.5b's micro-batch shape (1 x 4096 x
    896 bf16) handed to a peer process on the same card by
    ``mpmd.Handoff`` (gloo, the non-blocking send staged through pinned
    host memory) and back, as a cotangent goes back: both copies equal
    the seeded tensor, bit for bit, on the card."""
    import datetime
    import os
    import subprocess
    import sys

    import torch.distributed as dist

    from repro_torch.core import mpmd
    src_dir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    peer = subprocess.Popen(
        [sys.executable, "-c", PIPELINE_PEER, str(tmp_path), src_dir])
    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{tmp_path}/store", rank=0,
            world_size=2, timeout=datetime.timedelta(seconds=120))
        try:
            s0, s1 = mpmd.ProcessGroup("stage0", (0,)), \
                mpmd.ProcessGroup("stage1", (1,))
            g = torch.Generator(device=cuda).manual_seed(4)
            x = torch.randn(1, 4096, 896, generator=g,
                            device=cuda).to(torch.bfloat16)
            wire = mpmd.Handoff()
            wire.send(x, s0, s1)
            back = wire.recv(tuple(x.shape), x.dtype, s1, s0, cuda)
            wire.wait()
            assert back.device.type == "cuda" and torch.equal(back, x)
        finally:
            dist.destroy_process_group()
        assert peer.wait(timeout=120) == 0
    finally:
        if peer.poll() is None:
            peer.kill()


NCCL_PIPELINE_RANK = """
import dataclasses, datetime, sys
sys.path.insert(0, sys.argv[3])
import torch, torch.distributed as dist
from repro_torch.configs.base import PipelineConfig, ShapeConfig, get_config
from repro_torch.core import mpmd
from repro_torch.core.pipeline import schedule_1f1b
from repro_torch.core.tree import tree_flatten_with_path
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.pipeline_trainer import train_pipeline
from repro_torch.train.trainer import TrainConfig
rank = int(sys.argv[2])
dev = torch.device("cuda", rank)
torch.cuda.set_device(dev)
dist.init_process_group("nccl", init_method=f"file://{sys.argv[1]}/store",
                        rank=rank, world_size=2,
                        timeout=datetime.timedelta(seconds=60))
s = [mpmd.ProcessGroup("stage0", (0,)), mpmd.ProcessGroup("stage1", (1,))]
wire = mpmd.Handoff()
shape = (1, 4096, 896)


def seeded(seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)


exact = True
for op in schedule_1f1b(2, 4).ops:
    if op.stage != rank:
        continue
    if op.kind == "F" and rank == 0:
        wire.send(seeded(op.micro), s[0], s[1])
    elif op.kind == "F":
        exact &= torch.equal(wire.recv(shape, torch.bfloat16, s[0], s[1],
                                       dev), seeded(op.micro))
    elif rank == 1:
        wire.send(seeded(100 + op.micro), s[1], s[0])
    else:
        exact &= torch.equal(wire.recv(shape, torch.bfloat16, s[1], s[0],
                                       dev), seeded(100 + op.micro))
wire.wait()
torch.cuda.synchronize(dev)
assert exact, "a hand-off arrived changed"

cfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(), dtype="float32")


def run():
    params, hist = train_pipeline(
        cfg, ShapeConfig("t", 64, 4, "train"),
        pipeline=PipelineConfig(stages=2, micro_batches=4),
        adamw=AdamWConfig(total_steps=2),
        train_cfg=TrainConfig(num_steps=2, log_every=1), device=dev)
    return dict(tree_flatten_with_path(params)), hist


got, hist = run()
dist.destroy_process_group()
if rank == 0:
    want, whist = run()
    for a, b in zip(hist, whist):
        for k in ("loss", "grad_norm", "lr"):
            assert abs(a[k] - b[k]) <= 1e-5 * max(1.0, abs(b[k])), (k, a, b)
    assert sorted(got) == sorted(want)
    for k, b in want.items():
        assert float((got[k] - b).abs().max()) <= 2e-5 * max(
            1.0, float(b.abs().max())), k
"""


def test_pipeline_handoffs_between_two_cards_under_nccl(cuda, tmp_path):
    """Two processes, one a card, under NCCL.  First the S = 2, M = 4 1F1B
    order of hand-offs at qwen2-0.5b's micro-batch shape (1 x 4096 x 896
    bf16, 7.3 MB: above NCCL's 4 MiB of buffer between two ranks, so a
    send waits for its receive): stage 0 sends an activation at each F
    while stage 1 sends a cotangent back at each B.  Both must finish
    within the process group's 60 s timeout, every tensor bit for bit the
    seeded one.  Then two steps of the reduced qwen2-0.5b in float32 with
    one process a stage, against the colocated run of the same config on
    card 0: loss, grad norm and lr within 1e-5 relative, every merged
    param within 2e-5 x max(1, |p|)."""
    import os
    import subprocess
    import sys
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: one process a card")
    src_dir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    ranks = [subprocess.Popen(
        [sys.executable, "-c", NCCL_PIPELINE_RANK, str(tmp_path), str(r),
         src_dir], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in ranks]
    finally:
        for p in ranks:
            if p.poll() is None:
                p.kill()
    for r, (p, log) in enumerate(zip(ranks, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-3000:]}"
