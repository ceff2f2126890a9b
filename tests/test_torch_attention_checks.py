"""The side-input checks of the port's attention kernel wrappers.

The CUDA attention kernels are handed raw pointers to their block tables,
lengths, row bounds, pools and dense K/V, so a wrapper must refuse a side
input that lies on another device than q (a CPU table beside a CUDA q
would hand the card a host pointer) or whose shape disagrees with q's
rows or the pool's block size, before any launch.  The wrappers share one
pure check, ``repro_torch.kernels.side_input_problems``, which reads
shapes, dtypes and devices only; here it runs on meta tensors (standing
for the card's) beside CPU tensors, one case per mismatch.  The wrappers'
own refusals on the card are in ``tests/test_torch_cuda.py``.
"""
import re

import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from repro_torch.kernels import side_input_problems  # noqa: E402

B, C, H, KV, D, BS, W, N = 3, 8, 14, 2, 64, 16, 6, 32
ON = "meta"          # q's device
OFF = "cpu"          # another device


def _paged(**change):
    """A paged call's inputs that agree, with ``change`` replacing one."""
    kw = dict(pools=(torch.empty(N, BS, KV, D, device=ON),
                     torch.empty(N, BS, KV, D, device=ON)),
              block_size=BS,
              tables=torch.empty(B, W, dtype=torch.int32, device=ON),
              lengths=torch.empty(B, dtype=torch.int32, device=ON))
    kw.update(change)
    return kw


def _ragged(**change):
    kw = dict(pools=(torch.empty(N, BS, KV, D, device=ON),
                     torch.empty(N, BS, KV, D, device=ON)),
              block_size=BS,
              tables=torch.empty(B, W, dtype=torch.int32, device=ON),
              starts=torch.empty(B, dtype=torch.int32, device=ON),
              limits=torch.empty(B, dtype=torch.int64, device=ON))
    kw.update(change)
    return kw


def _dense(**change):
    kw = dict(dense=(torch.empty(B, 40, KV, D, device=ON),
                     torch.empty(B, 40, KV, D, device=ON)))
    kw.update(change)
    return kw


def _i32(*shape, device=ON):
    return torch.empty(*shape, dtype=torch.int32, device=device)


CASES = {
    "paged decode agrees": (_paged(), None),
    "ragged prefill agrees": (_ragged(), None),
    "flash agrees": (_dense(), None),
    "table on another device": (_paged(tables=_i32(B, W, device=OFF)),
                                "block_tables on cpu"),
    "table of rank 1": (_paged(tables=_i32(B * W)), r"block_tables \(18,\)"),
    "table of another row count": (_ragged(tables=_i32(B + 1, W)),
                                   r"block_tables \(4, 6\): need \(3, W\)"),
    "table of floats": (_paged(tables=torch.empty(B, W, device=ON)),
                        "block_tables of dtype torch.float32"),
    "lengths on another device": (_paged(lengths=_i32(B, device=OFF)),
                                  "lengths on cpu"),
    "lengths of another length": (_paged(lengths=_i32(B - 1)),
                                  r"lengths \(2,\): need \(3,\)"),
    "starts on another device": (_ragged(starts=_i32(B, device=OFF)),
                                 "starts on cpu"),
    "starts of another length": (_ragged(starts=_i32(B + 2)),
                                 r"starts \(5,\): need \(3,\)"),
    "limits of another length": (_ragged(limits=_i32(1)),
                                 r"limits \(1,\): need \(3,\)"),
    "limits of another rank": (_ragged(limits=_i32(B, 1)),
                               r"limits \(3, 1\): need \(3,\)"),
    "pool on another device": (
        _ragged(pools=(torch.empty(N, BS, KV, D, device=OFF),
                       torch.empty(N, BS, KV, D, device=ON))),
        "pool 0 on cpu"),
    "pool of another block size": (
        _paged(pools=(torch.empty(N, BS, KV, D, device=ON),
                      torch.empty(N, BS // 2, KV, D, device=ON))),
        "pool 1 .* dim 1 must be block_size=16"),
    "flash k on another device": (
        _dense(dense=(torch.empty(B, 40, KV, D, device=OFF),
                      torch.empty(B, 40, KV, D, device=ON))),
        "k on cpu"),
    "flash v on another device": (
        _dense(dense=(torch.empty(B, 40, KV, D, device=ON),
                      torch.empty(B, 40, KV, D, device=OFF))),
        "v on cpu"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_side_input_problems_name_each_mismatch(case):
    """Each mismatch gives exactly one problem, which names it; inputs that
    agree give none."""
    kw, pattern = CASES[case]
    q = torch.empty(B, C, H, D, device=ON)
    problems = side_input_problems(q, B, **kw)
    if pattern is None:
        assert problems == []
        return
    assert len(problems) == 1, problems
    assert re.search(pattern, problems[0]), problems[0]
