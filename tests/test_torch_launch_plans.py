"""Host-side launch plans of the bf16 split decodes, the SSD scan's body
and the grouped matmul.

The dense decode kernel cuts each row's keys into splits chosen on the
host from the cache length S and the SM count (``decode_splits``), and
writes the splits' partials to a workspace of ``decode_workspace_shape``;
the MLA decode kernel does the same over a table of W * block_size keys,
in whole 64-key tiles (``mla_decode_splits``, ``mla_workspace_shape``),
and the paged GQA decode over the most keys a row can see, min(W *
block_size, window), in whole 64-key tiles placed from each row's lower
bound on the card (``paged_decode_splits``).  The plans are plain Python,
made from shapes alone (no length), checked here on the CPU against what
the kernels need: splits that cover the keys, and blocks enough to give
every SM one, and no more, wherever there are keys enough for them.  The
SSD scan's wrapper picks its kernel's body from the shapes (``ssd_body``),
and flash's backward from the dtype and head dims (``flash_bwd_body``).
``chip_smoke.py``'s train runs count the grouped matmul's and its
backward's launches (``train_launches_per_step``) under both MoE
dispatches.
The wrappers' input checks (which run before a launch, on the card only)
are plain Python too and refuse what no kernel takes, and take what the
model layers hand over.  The kernels themselves run on the card
(``tests/test_torch_cuda.py``).
"""
import inspect

import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import grouped_matmul as gm  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import rglru_scan as rs  # noqa: E402
from repro_torch.kernels import ssd_scan as ss  # noqa: E402
from repro_torch.models import mamba2, rglru  # noqa: E402

SMS = 132                  # an H100 SXM's SMs


@pytest.mark.parametrize("S,blocks,sms", [
    (1096, 8, SMS), (1096, 16, SMS), (1096, 32, SMS), (640, 16, SMS),
    (1024, 16, SMS), (100_000, 1, SMS), (17, 1, SMS), (16, 4, SMS),
    (1096, SMS, SMS), (1096, 300, SMS), (1096, 8, 1), (1, 1, SMS)])
def test_decode_splits_cover_the_cache_one_block_an_sm(S, blocks, sms):
    splits, keys = da.decode_splits(S, blocks, sms)
    assert splits >= 1 and keys >= 1
    assert splits * keys >= S > (splits - 1) * keys or S <= 1
    assert splits * blocks <= max(blocks, sms)
    if splits > 1:
        assert keys >= da.MIN_SPLIT
    want = max(1, sms // blocks)
    if want == 1:
        assert splits == 1
    elif S >= da.MIN_SPLIT * want:
        assert splits >= 0.9 * want       # the card is filled


def test_decode_plans_at_the_main_path_shapes():
    """The Generator decodes of chip_smoke.py on 132 SMs: recurrentgemma's
    8 rows x (1 kv head, 10 heads) and qwen2's 8 rows x (2 kv heads, 7
    heads) over 1096 entries, and llama3-8b's 8 x 8 kv heads."""
    assert da.decode_splits(1096, 8 * 1 * 1, SMS) == (16, 69)
    assert da.decode_splits(1096, 8 * 2 * 1, SMS) == (8, 137)
    assert da.decode_splits(1096, 8 * 8 * 1, SMS) == (2, 548)
    assert da.decode_workspace_shape(8, 10, 256, 16) == (8, 10, 16, 258)
    assert da.decode_workspace_shape(8, 14, 64, 8) == (8, 14, 8, 66)
    assert da.decode_workspace_shape(64, 32, 128, 1) is None


def test_decode_check_refuses_misshapen_inputs():
    q = torch.zeros(2, 1, 14, 64, dtype=torch.bfloat16)
    k = torch.zeros(2, 32, 2, 64, dtype=torch.bfloat16)
    lens = torch.ones(2, dtype=torch.int32)
    da._check(q, k, k, lens)
    with pytest.raises(ValueError, match=r"\(B, 1, H, D\)"):
        da._check(torch.zeros(2, 2, 14, 64, dtype=torch.bfloat16), k, k,
                  lens)
    with pytest.raises(ValueError, match="do not match"):
        da._check(q, k, k[:, :16], lens)


def test_grouped_matmul_check_refuses_what_no_kernel_takes():
    x = torch.zeros(10, 64, dtype=torch.bfloat16)
    w = torch.zeros(4, 64, 72, dtype=torch.bfloat16)
    sizes = torch.tensor([3, 0, 7, 0], dtype=torch.int32)
    gm._check(x, w, sizes)
    with pytest.raises(ValueError, match="dtypes"):
        gm._check(x, w.float(), sizes)
    with pytest.raises(ValueError, match=r"\(T, D\) and \(E, D, F\)"):
        gm._check(x[:, :32], w, sizes)
    with pytest.raises(ValueError, match="multiples of 8"):
        gm._check(x, w[..., :68].contiguous(), sizes)
    with pytest.raises(ValueError, match="group_sizes"):
        gm._check(x, w, sizes[:3])
    with pytest.raises(ValueError, match="contiguous"):
        gm._check(x, w.transpose(1, 2).contiguous().transpose(1, 2), sizes)


def _chip_smoke():
    """chip_smoke.py as a module (it imports torch and the port only inside
    its phases)."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("layers,moe", [
    ("reduced", 1),               # .reduced(): a dense layer, a MoE layer
    (4, 3),                       # chip_smoke.py's train runs' cut
    (None, 26),                   # all 27 layers: the first dense
])
def test_train_launches_per_step_under_both_dispatches(layers, moe):
    """deepseek-v2-lite's train step: under ragged every MoE layer runs
    w_gate, w_up and w_down as a grouped matmul each, twice (the forward
    and its remat recompute), and each backward kernel three times;
    under gshard no grouped matmul at all; the attention's counts (two
    flash forwards and one backward a layer) the same under both."""
    import dataclasses
    cs = _chip_smoke()
    cfg = get_config("deepseek-v2-lite-16b")
    if layers == "reduced":
        cfg = cfg.reduced()
    elif layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    n = cfg.num_layers
    ragged = cs.train_launches_per_step(cfg, "ragged")
    gshard = cs.train_launches_per_step(cfg)
    assert gshard == cs.train_launches_per_step(cfg, "gshard")
    assert ragged == {**gshard, "grouped_matmul": 6 * moe,
                      "grouped_matmul_bwd_dx": 3 * moe,
                      "grouped_matmul_bwd_dw": 3 * moe}
    assert gshard == {"flash_attention": 2 * n, "flash_attention_bwd": n,
                      "grouped_matmul": 0, "grouped_matmul_bwd_dx": 0,
                      "grouped_matmul_bwd_dw": 0, "ssd_scan": 0,
                      "ssd_scan_bwd": 0, "rglru_scan": 0,
                      "rglru_scan_bwd": 0}
    assert set(ragged) == set(cs.TRAIN_KERNELS)


def test_train_launches_per_step_without_moe_ignore_the_dispatch():
    """A model with no MoE layer counts the same under both dispatches."""
    cs = _chip_smoke()
    for arch in ("qwen2-0.5b", "mamba2-370m", "recurrentgemma-2b"):
        cfg = get_config(arch)
        assert (cs.train_launches_per_step(cfg, "ragged")
                == cs.train_launches_per_step(cfg))


@pytest.mark.parametrize("B", [1, 4, 16])
@pytest.mark.parametrize("W", [1, 96, 194])
def test_mla_splits_cover_the_table_in_whole_tiles_one_block_an_sm(B, W):
    """Every W * 16 keys in splits of whole 64-key tiles, at least
    MLA_MIN_SPLIT keys, none wholly past the table; at most one (row,
    split) block an SM, and where the rows have keys enough for every SM,
    at least 3/4 of the card (splits are whole tiles, so a table of 49
    tiles cut for 8 splits a row gives 7 of 7 tiles)."""
    S = W * 16
    splits, keys = da.mla_decode_splits(B, S, SMS)
    assert splits >= 1 and keys % da.MLA_TILE == 0
    assert keys >= da.MLA_MIN_SPLIT
    assert splits * keys >= S > (splits - 1) * keys
    assert B * splits <= SMS
    room = B * -(-S // da.MLA_MIN_SPLIT)      # blocks the keys allow
    assert B * splits >= 0.75 * min(SMS, room)
    shape = da.mla_workspace_shape(B, 16, 512, splits)
    assert shape is None if splits == 1 else shape == (B, 16, splits, 514)


def test_mla_plan_at_the_serving_decode():
    """deepseek-v2-lite's serving decode in chip_smoke.py: 16 seats over a
    96-block table of block 16 on 132 SMs is 8 splits of 192 keys, 128
    blocks; its partials are 4.2 MB against the keys' 16.5 MB."""
    assert da.mla_decode_splits(16, 96 * 16, SMS) == (8, 192)
    assert da.mla_workspace_shape(16, 16, 512, 8) == (16, 16, 8, 514)
    assert da.mla_decode_splits(1, 16, SMS) == (1, 128)
    assert da.mla_workspace_shape(1, 16, 512, 1) is None
    assert da.mla_decode_splits(SMS, 96 * 16, SMS)[0] == 1
    assert da.mla_decode_splits(4 * SMS, 96 * 16, SMS) == (1, 1536)


@pytest.mark.parametrize("B,KV,G", [(1, 1, 10), (16, 1, 10), (16, 2, 7),
                                    (16, 8, 3), (4, 8, 3), (3, 2, 20),
                                    (SMS, 1, 1), (64, 8, 4)])
@pytest.mark.parametrize("W,window", [(1, None), (128, None), (194, 2048),
                                      (194, None), (40, 200), (8, 4096),
                                      (194, 1)])
@pytest.mark.parametrize("D", [64, 256])
def test_paged_splits_cover_the_window_in_whole_tiles_one_block_an_sm(
        B, KV, G, W, window, D):
    """The most keys a row can see, min(W * 16, window), in splits of
    whole 64-key tiles, none wholly past them; at most
    ``paged_blocks_an_sm(D)`` (row, kv head, head chunk, split) blocks an
    SM (four below D = 256, one at it), and no cut into shorter splits of
    whole tiles stays within that."""
    keys = W * 16
    cover = min(keys, window) if window else keys
    splits, split_len = da.paged_decode_splits(B, KV, G, D, keys, window,
                                               SMS)
    assert splits >= 1 and split_len % da.SPLIT_TILE == 0
    assert splits * split_len >= cover > (splits - 1) * split_len
    blocks = B * KV * -(-G // da.HEAD_CHUNK)
    slots = da.paged_blocks_an_sm(D) * SMS
    assert da.paged_blocks_an_sm(D) == (1 if D == 256 else 4)
    assert splits * blocks <= max(blocks, slots)
    tiles, per = -(-cover // da.SPLIT_TILE), split_len // da.SPLIT_TILE
    assert per == 1 or -(-tiles // (per - 1)) * blocks > slots


def test_paged_plan_takes_shapes_only():
    """The plan reads no length: its arguments are the shapes, the window
    and the SM count, so a call makes it without a wait on the card."""
    assert list(inspect.signature(da.paged_decode_splits).parameters) == [
        "B", "KV", "G", "D", "keys", "window", "sm_count"]


def test_paged_plan_at_the_serving_decodes():
    """The numbers of the plan's docstring, chip_smoke.py's serving decodes
    on 132 SMs: qwen2-0.5b's 16 seats x 2 kv heads of 7 at D = 64 over a
    128-block table of block 16, recurrentgemma-2b's 16 x 1 kv head of 10
    at D = 256 over 194 blocks with its window of 2048 (the splits cover
    the window, not the 3104-key table), phi4-mini's 16 x 8 kv heads of 3
    at D = 128; and their workspaces."""
    assert da.paged_decode_splits(16, 2, 7, 64, 128 * 16, None,
                                  SMS) == (16, 128)
    assert da.paged_decode_splits(16, 1, 10, 256, 194 * 16, 2048,
                                  SMS) == (8, 256)
    assert da.paged_decode_splits(16, 8, 3, 128, 128 * 16, None,
                                  SMS) == (4, 512)
    assert da.paged_decode_splits(SMS, 8, 3, 128, 128 * 16, None,
                                  SMS) == (1, 2048)
    assert da.decode_workspace_shape(16, 14, 64, 16) == (16, 14, 16, 66)
    assert da.decode_workspace_shape(16, 10, 256, 8) == (16, 10, 8, 258)
    assert da.decode_workspace_shape(SMS, 24, 128, 1) is None


@pytest.mark.parametrize("prefill", [False, True])
def test_rglru_check_accepts_what_the_rglru_layer_hands_over(prefill,
                                                             monkeypatch):
    """recurrentgemma-2b's RG-LRU layer at its full width (lru_width 2560)
    on CPU tensors: every rglru_scan call of its forward and of its serving
    prefill chunk (an initial state from the seat rows) passes the
    wrapper's check."""
    cfg = get_config("recurrentgemma-2b")
    p = rglru.init_rglru(cfg, torch.Generator().manual_seed(0))
    seen = []

    def checked(x, input_gate, a_gate, log_a, *, init_state=None, c=8.0):
        rs._check(x, input_gate, a_gate, log_a, init_state)
        seen.append(x.shape)
        return rs.rglru_scan_ref(x, input_gate, a_gate, log_a,
                                 init_state=init_state, c=c)
    monkeypatch.setattr(ops.rs, "rglru_scan", checked)
    g = torch.Generator().manual_seed(1)
    if prefill:
        x = torch.randn(4, 16, cfg.d_model, generator=g).to(torch.bfloat16)
        cache = rglru.init_rglru_cache(cfg, 5, torch.bfloat16, "cpu")
        rglru.rglru_prefill_chunk(
            p, x, torch.tensor([0, 16, 0, 0]), torch.tensor([16, 20, 9, 0]),
            torch.tensor([0, 1, 2, 4]), cfg, cache)
    else:
        x = torch.randn(2, 8, cfg.d_model, generator=g).to(torch.bfloat16)
        rglru.rglru_forward(p, x, cfg)
    assert len(seen) == 1 and seen[0][-1] == 2560


@pytest.mark.parametrize("dtype,P,N,chunk,body", [
    (torch.bfloat16, 64, 128, 256, "wgmma"),
    (torch.bfloat16, 64, 128, 100, "wgmma"),
    (torch.bfloat16, 64, 128, 48, "wgmma"),
    (torch.bfloat16, 64, 128, 16, "wgmma"),
    (torch.bfloat16, 64, 128, 8, "fma"),
    (torch.bfloat16, 64, 128, 1, "fma"),
    (torch.bfloat16, 32, 16, 32, "fma"),
    (torch.float32, 64, 128, 256, "fma"),
    (torch.float32, 32, 16, 1, "fma")])
def test_ssd_body_is_chosen_by_shape(dtype, P, N, chunk, body):
    """The tensor cores take bf16 at the full width from a 16-position
    chunk on; float32 (the identity runs) and short chunks take the FMA
    body."""
    assert ss.ssd_body(dtype, P, N, chunk) == body


@pytest.mark.parametrize("dtype,P,N,body", [
    (torch.bfloat16, 64, 128, "mma"),
    (torch.bfloat16, 32, 16, "fma"),
    (torch.float32, 64, 128, "fma"),
    (torch.float32, 32, 16, "fma")])
def test_ssd_bwd_body_is_chosen_by_shape(dtype, P, N, body):
    """The backward runs on the tensor cores (its chunk states, R_c and
    query pass on wgmma, its key pass on mma.sync) for bf16 at the full
    width, whatever the chunk; float32 (the identity runs, which must stay
    f32) and the reduced widths take the FMA body."""
    assert ss.ssd_bwd_body(dtype, P, N) == body


@pytest.mark.parametrize("body,B,S,H,P,N,chunk,values", [
    # 2 x 8, 3 heads, chunks of 4 (nc = 2, one 32-key tile): the states in
    # three bf16 parts, 2 x (2 3 2 64 128 x 3 / 2) = 294912; cs, ct, rd 3 x
    # 48; dG 2 2 16 = 64; rows 2 3 2 1 4 = 48; lastp 12; d cs_last one a
    # chunk, 12; dA's parts 6
    ("mma", 2, 8, 3, 64, 128, 4, 294912 + 144 + 64 + 48 + 12 + 12 + 6),
    # the same in the FMA body: f32 states, 2 x 2 3 2 8192 = 196608, and d
    # cs_last in 8 parts a chunk, 96
    ("fma", 2, 8, 3, 64, 128, 4, 196608 + 144 + 64 + 48 + 12 + 96 + 6),
    # mamba2-370m's train shape, 4 x 4096, 32 heads, chunks of 256 (nc =
    # 16, nt = 8): parts 2 x 4 32 16 8192 x 3 / 2 = 50331648; 3 x 524288;
    # dG 4 16 65536 = 4194304; rows 4 32 16 8 256 = 4194304; lastp 16384;
    # d cs_last 2048; dA's parts 128 (241 MB)
    ("mma", 4, 4096, 32, 64, 128, 256,
     50331648 + 1572864 + 4194304 + 4194304 + 16384 + 2048 + 128),
    # the reduced widths, a chunk of 1 (32 x 16; nt = 1): f32 states 2 x 1
    # 2 45 512 = 92160; 3 x 90; dG 45; rows 90; lastp 90; d cs_last 720;
    # dA's parts 2
    ("fma", 1, 45, 2, 32, 16, 1, 92160 + 270 + 45 + 90 + 90 + 720 + 2)])
def test_ssd_bwd_workspace_counts_the_layout_by_hand(body, B, S, H, P, N,
                                                     chunk, values):
    """The backward's f32 workspace for each body, counted region by
    region as ``csrc/ssd_scan_bwd.cu``'s launcher lays it out."""
    assert ss.ssd_bwd_workspace(B, S, H, P, N, chunk, body) == values


def _ssd_views(rows, S, shift=0, width=None):
    """x, dt, A, Bm, Cm as mamba2-370m's layer hands them over: column
    slices of one (rows, S, 2304) bf16 tensor, ``shift`` elements in."""
    H, P, N = 32, 64, 128
    width = width or H * P + 2 * N
    xbc = torch.zeros(rows, S, width + shift, dtype=torch.bfloat16)[
        ..., shift:]
    x = xbc[..., :H * P].reshape(rows, S, H, P)
    dt = torch.ones(rows, S, H)
    A = -torch.ones(H)
    return x, dt, A, xbc[..., H * P:H * P + N], xbc[..., H * P + N:]


def test_ssd_check_refuses_views_off_16_bytes():
    """The tensor-core body copies 16-byte pieces of every row: a base or
    a row stride off a 16-byte boundary is refused before any launch (the
    FMA body reads elements and takes it)."""
    ss._check(*_ssd_views(2, 256), 256, None)
    with pytest.raises(ValueError, match="16-byte boundary"):
        ss._check(*_ssd_views(2, 256, shift=4), 256, None)   # base + 8 B
    with pytest.raises(ValueError, match="16-byte boundary"):
        ss._check(*_ssd_views(2, 256, width=2 * 2048 + 2 * 128 + 4),
                  256, None)                                 # row stride
    x, dt, A, Bm, Cm = _ssd_views(2, 256)
    flat = torch.zeros(2 * 256 * 128 + 2, dtype=torch.bfloat16)
    assert flat.data_ptr() % 16 == 0
    with pytest.raises(ValueError, match="Bm at 4 bytes"):
        ss._check(x, dt, A, flat[2:].view(2, 256, 128), Cm, 256, None)
    ss._check(*_ssd_views(2, 256, shift=4), 8, None)        # FMA body


@pytest.mark.parametrize("prefill", [False, True])
def test_ssd_check_accepts_what_the_mamba2_layer_hands_over(prefill,
                                                           monkeypatch):
    """mamba2-370m's layer at its full widths (d_model 1024, 32 heads of
    64, N = 128) on CPU tensors: every ssd_scan call of its forward and of
    its serving prefill chunk passes the wrapper's check, chunk and init
    state included, and takes the tensor-core body."""
    cfg = get_config("mamba2-370m")
    p = mamba2.init_mamba2(cfg, torch.Generator().manual_seed(0))
    seen = []

    def checked(x, dt, A, Bm, Cm, *, chunk, init_state=None):
        ss._check(x, dt, A, Bm, Cm, chunk, init_state)
        seen.append(ss.ssd_body(x.dtype, x.shape[-1], Bm.shape[-1], chunk))
        return ss.ssd_scan_ref(x, dt, A, Bm, Cm, chunk=chunk,
                               init_state=init_state)
    monkeypatch.setattr(ops.ss, "ssd_scan", checked)
    g = torch.Generator().manual_seed(1)
    if prefill:
        x = torch.randn(4, 64, cfg.d_model, generator=g).to(torch.bfloat16)
        cache = mamba2.init_mamba2_cache(cfg, 5, torch.bfloat16, "cpu")
        mamba2.mamba2_prefill_chunk(
            p, x, torch.tensor([0, 64, 0, 0]), torch.tensor([64, 100, 30, 0]),
            torch.tensor([0, 1, 2, 4]), cfg, cache)
    else:
        x = torch.randn(2, 32, cfg.d_model, generator=g).to(torch.bfloat16)
        mamba2.mamba2_forward(p, x, cfg)
    assert seen == ["wgmma"]


@pytest.mark.parametrize("dtype,dk,dv,body", [
    (torch.bfloat16, 64, 64, "wgmma"),
    (torch.bfloat16, 128, 128, "wgmma"),
    (torch.bfloat16, 192, 128, "wgmma"),
    (torch.bfloat16, 96, 64, "fma"),
    (torch.float32, 64, 64, "fma"),
    (torch.float32, 128, 128, "fma"),
    (torch.float32, 192, 128, "fma"),
    (torch.float32, 96, 64, "fma"),
    (torch.bfloat16, 256, 256, "wide"),
    (torch.float32, 256, 256, "fma")])
def test_flash_bwd_body_is_chosen_by_dtype_and_head_dims(dtype, dk, dv,
                                                         body):
    """The backward's fused tensor-core pass takes bf16 at its built pairs
    (MLA's (192, 128) with the columns split), bf16 at recurrentgemma's
    (256, 256) takes the wide wgmma body (a dK/dV pass and a dQ pass);
    float32 (the identity runs, which must stay f32) and bf16 at (96, 64),
    no multiple of the fused pass's 64-value column blocks, take the FMA
    body."""
    assert fa.flash_bwd_body(dtype, dk, dv) == body


def _bwd_args(dtype=torch.bfloat16, dk=64, dv=64, shift=0, B=2, S=100,
              H=14, KV=2):
    """q, k, v, o, lse, do as the train step hands them to the backward,
    on the CPU; q ``shift`` elements past a 16-byte boundary."""
    flat = torch.zeros(B * S * H * dk + shift, dtype=dtype)
    q = flat[shift:].view(B, S, H, dk)
    k = torch.zeros(B, S, KV, dk, dtype=dtype)
    v = torch.zeros(B, S, KV, dv, dtype=dtype)
    o, do = (torch.zeros(B, S, H, dv, dtype=dtype) for _ in range(2))
    return q, k, v, o, torch.zeros(B, H, S), do


@pytest.mark.parametrize("dtype,dk,dv", [(torch.bfloat16, 64, 64),
                                         (torch.bfloat16, 128, 128),
                                         (torch.float32, 64, 64),
                                         (torch.bfloat16, 192, 128),
                                         (torch.bfloat16, 96, 64),
                                         (torch.float32, 96, 64),
                                         (torch.bfloat16, 256, 256),
                                         (torch.float32, 256, 256)])
def test_flash_bwd_check_takes_what_the_train_step_hands_over(dtype, dk, dv):
    fa._bwd_check(*_bwd_args(dtype, dk, dv))
    assert fa._grad_problems(*_bwd_args(dtype, dk, dv)[:3:2], 0) == []


@pytest.mark.parametrize("case,match", [
    ("pair (128, 64)", "head dims"),
    ("pair (32, 32)", "head dims"),
    ("misaligned q", "16-byte boundary"),
    ("lse shape", "lse"),
    ("q_offset", "q_offset = 0")])
def test_flash_bwd_check_refuses_what_the_launcher_refuses(case, match):
    """The wrapper refuses before any launch what the C launcher refuses
    (a pair outside BWD_PAIRS, a q offset, a base the tensor-core body's
    TMA cannot take) and what it cannot check (shapes)."""
    if case == "q_offset":
        q, _, v = _bwd_args()[:3]
        assert any(match in p for p in fa._grad_problems(q, v, 3))
        q.requires_grad_()
        with pytest.raises(ValueError, match=match):
            fa.flash_attention(q, *_bwd_args()[1:3], q_offset=3)
        return
    if case.startswith("pair"):
        dk, dv = (128, 64) if "64" in case else (32, 32)
        args = _bwd_args(dk=dk, dv=dv)
    elif case == "misaligned q":
        args = _bwd_args(shift=1)
        assert args[0].data_ptr() % 16 == 2
    else:
        args = list(_bwd_args())
        args[4] = torch.zeros(2, 14, 99)
    with pytest.raises(ValueError, match=match):
        fa._bwd_check(*args)
    if case == "misaligned q":            # the FMA body reads elements
        fa._bwd_check(*_bwd_args(torch.float32, shift=1))


@pytest.mark.parametrize("B,S,KV,G,padded", [
    (1, 4096, 1, 10, 40960),   # recurrentgemma-2b's train step
    (2, 4096, 1, 10, 81920),
    (5, 4096, 1, 10, 204800),
    (1, 4097, 1, 1, 4100)])    # the row dots padded to 16 bytes
def test_flash_bwd_workspace(B, S, KV, G, padded):
    """At (256, 256) both bodies give every query head its own dK/dV
    block, so the workspace holds each head's f32 partial dK and dV: the
    FMA body's after its row dots (padded to a 16-byte boundary for the
    partials' float2 stores), the wide wgmma body's after its ring's row
    pieces (lse and D, 2 x 64 values a (row, head, 64-row query tile),
    padded rows included), whatever the batch; the other FMA pairs'
    workspaces are the row dots alone."""
    H = KV * G
    dots = B * H * S
    partials = H * B * S * 2 * 256
    assert fa.flash_bwd_workspace("fma", B, S, H, 256, S, KV) == \
        padded + partials
    pieces = B * H * -(-S // 64) * 128
    assert fa.flash_bwd_workspace("wide", B, S, H, 256, S, KV) == \
        pieces + partials
    assert fa.flash_bwd_workspace("fma", B, S, H, 64, S, KV) == dots
