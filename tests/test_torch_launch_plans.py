"""Host-side launch plans of the bf16 split decode and the grouped matmul.

The dense decode kernel cuts each row's keys into splits chosen on the
host from the cache length S and the SM count (``decode_splits``), and
writes the splits' partials to a workspace of ``decode_workspace_shape``;
both are plain Python, checked here on the CPU against what the kernel
needs: splits of at least a warp's 16 keys that cover S, and blocks enough
to give every SM one, and no more, wherever S has keys enough for them.  The wrappers' input
checks (which run before a launch, on the card only) are plain Python too
and refuse what no kernel takes.  The kernels themselves run on the card
(``tests/test_torch_cuda.py``).
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import grouped_matmul as gm  # noqa: E402

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
