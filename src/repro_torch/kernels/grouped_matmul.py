"""Ragged grouped matmul (MoE expert compute) and its backward: CUDA
kernels, plain versions, launch counts, and the autograd Function.

Replaces the TPU kernel ``repro/kernels/grouped_matmul.py``, function
``grouped_matmul``: ``out[t] = x[t] @ w[expert_of(t)]`` for ``x`` (T, D)
sorted by expert, ``w`` (E, D, F) and ``group_sizes`` (E,) each expert's
contiguous row count (groups may be empty).  The kernel
(``csrc/grouped_matmul.cu``) runs, in bf16, a persistent grid over a work
list of (expert, row tile, F tile) items that each block builds from the
sizes on the device (no host sync), its products on wgmma fed by a TMA
ring, so each non-empty expert's weights stream once per row
tile; in f32 one block per (F tile, expert) of FMAs.  Its header says
what bounds it on the H100 (bytes, at serving shapes).

:func:`grouped_matmul_bwd` computes ``dx = dy w[e]^T`` and ``dw[e] =
x_e^T dy_e`` (``csrc/grouped_matmul_bwd.cu``: dx on the forward's
persistent kernel with the weights read K-major and its tiles stored
through shared memory by TMA, dw a persistent kernel over (expert, D
tile, F tile) items; it replaces no TPU kernel, since the reference
differentiates its oracle).  :class:`GroupedMatmulFn` ties the two
together, so a ragged MoE forward is differentiable: the train step and
the GRPO learner under ``moe_dispatch="ragged"`` run both kernels.

:func:`grouped_matmul` and :func:`grouped_matmul_bwd` launch their kernels
for CUDA tensors and run :func:`grouped_matmul_ref` /
:func:`grouped_matmul_bwd_ref` for CPU tensors — the device of the input
decides, never a fallback.  ``grouped_matmul.launches``,
``grouped_matmul_bwd_dx.launches`` and ``grouped_matmul_bwd_dw.launches``
count each entry point's kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import (DTYPE_CODES, PLAIN_DEVICES, build,
                                 count_launch, raise_problems)


def grouped_matmul_ref(x, w, group_sizes) -> torch.Tensor:
    """Plain version: one f32 matmul per non-empty expert on its slice of
    rows, rounded once to x.dtype (the reference's
    ``ref.grouped_matmul``, without its (T, D, F) gather of every row's
    weights).  Reads the sizes back to the host, which the kernel does not."""
    T, F = x.shape[0], w.shape[2]
    out = x.new_empty(T, F)
    start = 0
    for e, n in enumerate(group_sizes.tolist()):
        if n:
            out[start:start + n] = (x[start:start + n].float()
                                    @ w[e].float()).to(x.dtype)
        start += n
    if start != T:
        raise ValueError(f"grouped_matmul: group sizes sum to {start}, "
                         f"x has {T} rows")
    return out


def grouped_matmul_bwd_dx_ref(dy, w, group_sizes, *, acc=torch.float32):
    """Plain dx (T, D) of :func:`grouped_matmul_ref` for the output's
    gradient ``dy`` (T, F): one product ``dy_e w[e]^T`` per non-empty
    expert in ``acc`` (float32; float64 the yardstick of the f32
    evaluation's own rounding), rounded once to dy's dtype.  Reads the sizes
    back to the host."""
    T, D = dy.shape[0], w.shape[1]
    dx = dy.new_empty(T, D)
    start = 0
    for e, n in enumerate(group_sizes.tolist()):
        if n:
            dx[start:start + n] = (dy[start:start + n].to(acc)
                                   @ w[e].to(acc).T).to(dy.dtype)
        start += n
    if start != T:
        raise ValueError(f"grouped_matmul_bwd: group sizes sum to {start}, "
                         f"dy has {T} rows")
    return dx


def grouped_matmul_bwd_dw_ref(x, dy, group_sizes, *, acc=torch.float32):
    """Plain dw (E, D, F): ``x_e^T dy_e`` over each expert's rows in
    ``acc``, rounded once to x's dtype; an empty expert's zeros.  The sizes
    may sum to less than x's rows: the rows past the sum belong to no
    expert, as in the kernel."""
    E = group_sizes.shape[0]
    dw = x.new_zeros(E, x.shape[1], dy.shape[1])
    start = 0
    for e, n in enumerate(group_sizes.tolist()):
        if n:
            dw[e] = (x[start:start + n].to(acc).T
                     @ dy[start:start + n].to(acc)).to(x.dtype)
        start += n
    if start > x.shape[0]:
        raise ValueError(f"grouped_matmul_bwd: group sizes sum to {start}, "
                         f"x has {x.shape[0]} rows")
    return dw


def grouped_matmul_bwd_ref(x, w, group_sizes, dy, *, acc=torch.float32):
    """Plain backward of :func:`grouped_matmul_ref`: (dx (T, D), dw (E, D,
    F)) for the output's gradient ``dy`` (T, F)."""
    return (grouped_matmul_bwd_dx_ref(dy, w, group_sizes, acc=acc),
            grouped_matmul_bwd_dw_ref(x, dy, group_sizes, acc=acc))


_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


@functools.cache
def _lib():
    fn = build.load("grouped_matmul").grouped_matmul_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


@functools.cache
def _bwd_lib():
    lib = build.load("grouped_matmul_bwd")
    fns = lib.grouped_matmul_bwd_dx_launch, lib.grouped_matmul_bwd_dw_launch
    for fn in fns:
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fns


def _check(x, w, group_sizes):
    problems = []
    if x.dtype not in DTYPE_CODES or w.dtype != x.dtype:
        problems.append(f"dtypes x={x.dtype} w={w.dtype}: need one of "
                        "float32/bfloat16")
    if x.ndim != 2 or w.ndim != 3 or w.shape[1] != x.shape[1]:
        problems.append(f"x {tuple(x.shape)} / w {tuple(w.shape)}: need "
                        "(T, D) and (E, D, F)")
    elif x.shape[1] % 8 or w.shape[2] % 8:
        problems.append(f"D={x.shape[1]}, F={w.shape[2]}: need multiples of "
                        "8 (16-byte row chunks)")
    if group_sizes.shape != (w.shape[0],) or group_sizes.device != x.device:
        problems.append(f"group_sizes {tuple(group_sizes.shape)} on "
                        f"{group_sizes.device}: need ({w.shape[0]},) on "
                        f"{x.device}")
    if not w.is_contiguous() or w.data_ptr() % 16:
        problems.append("w must be contiguous and 16-byte aligned")
    raise_problems("grouped_matmul", problems)


def grouped_matmul(x, w, group_sizes) -> torch.Tensor:
    """x (T, D) sorted by expert; w (E, D, F); group_sizes (E,) integer,
    summing to T.  Returns (T, F) in x.dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    Differentiable in x and w: when a gradient is recorded the call goes
    through :class:`GroupedMatmulFn`, whose backward is
    :func:`grouped_matmul_bwd`.
    """
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return GroupedMatmulFn.apply(x, w, group_sizes)
    return _forward(x, w, group_sizes)


def _forward(x, w, group_sizes) -> torch.Tensor:
    if x.device.type in PLAIN_DEVICES:
        return grouped_matmul_ref(x, w, group_sizes)
    if x.device.type != "cuda":
        raise ValueError(f"grouped_matmul: no kernel for device {x.device}")
    _check(x, w, group_sizes)
    T, D = x.shape
    E, _, F = w.shape
    out = x.new_empty(T, F)
    if T == 0:
        return out
    x = x.contiguous()
    sizes = group_sizes.to(torch.int32).contiguous()
    rc = _lib()(x.data_ptr(), w.data_ptr(), sizes.data_ptr(), out.data_ptr(),
                T, D, F, E, DTYPE_CODES[x.dtype],
                torch.cuda.current_stream(x.device).cuda_stream)
    count_launch(grouped_matmul, rc)
    return out


def grouped_matmul_bwd(x, w, group_sizes, dy):
    """The gradients of :func:`grouped_matmul` for the output's gradient
    ``dy`` (T, F): (dx (T, D), dw (E, D, F)) in the inputs' dtype, by
    :func:`grouped_matmul_bwd_dx` and :func:`grouped_matmul_bwd_dw`."""
    return (grouped_matmul_bwd_dx(dy, w, group_sizes),
            grouped_matmul_bwd_dw(x, dy, group_sizes))


def _bwd_inputs(name, a, dy, group_sizes, D, F, E):
    """Checks of a backward product's inputs: a (T, D), dy (T, F) of one
    dtype on one device, the sizes (E,); raises on what no kernel takes."""
    T = a.shape[0]
    problems = []
    if a.dtype not in DTYPE_CODES:
        problems.append(f"dtype {a.dtype}: need one of float32/bfloat16")
    if (a.ndim != 2 or tuple(dy.shape) != (T, F) or dy.dtype != a.dtype
            or dy.device != a.device):
        problems.append(f"dy {tuple(dy.shape)} {dy.dtype} on {dy.device}: "
                        f"need ({T}, {F}) {a.dtype} on {a.device}")
    if D % 8 or F % 8:
        problems.append(f"D={D}, F={F}: need multiples of 8 (16-byte row "
                        "chunks)")
    if group_sizes.shape != (E,) or group_sizes.device != a.device:
        problems.append(f"group_sizes {tuple(group_sizes.shape)} on "
                        f"{group_sizes.device}: need ({E},) on {a.device}")
    raise_problems(name, problems)


def _bwd_launch(wrapper, fn, a, b, group_sizes, out, T, D, F, E):
    sizes = group_sizes.to(torch.int32).contiguous()
    rc = fn(a.data_ptr(), b.data_ptr(), sizes.data_ptr(), out.data_ptr(),
            T, D, F, E, DTYPE_CODES[a.dtype],
            torch.cuda.current_stream(a.device).cuda_stream)
    count_launch(wrapper, rc)


def grouped_matmul_bwd_dx(dy, w, group_sizes) -> torch.Tensor:
    """dx (T, D): each row of dy (T, F) against its expert's w (E, D, F)
    transposed; the sizes sum to T, as the forward's do (the kernel leaves
    the rows past a smaller sum unwritten, and the plain version refuses
    it).  CPU tensors take the plain version; CUDA tensors launch
    the dx kernel (with no rows, nothing: dx is empty)."""
    if dy.device.type in PLAIN_DEVICES:
        return grouped_matmul_bwd_dx_ref(dy, w, group_sizes)
    if dy.device.type != "cuda":
        raise ValueError(f"grouped_matmul_bwd_dx: no kernel for device "
                         f"{dy.device}")
    E, D, F = w.shape
    _bwd_inputs("grouped_matmul_bwd_dx", dy, dy, group_sizes, D, F, E)
    if w.dtype != dy.dtype or w.device != dy.device \
            or not w.is_contiguous() or w.data_ptr() % 16:
        raise_problems("grouped_matmul_bwd_dx", [
            f"w {w.dtype} on {w.device}: need {dy.dtype} on {dy.device}, "
            "contiguous and 16-byte aligned"])
    T = dy.shape[0]
    dx = dy.new_empty(T, D)
    if T:
        _bwd_launch(grouped_matmul_bwd_dx, _bwd_lib()[0], dy.contiguous(), w,
                    group_sizes, dx, T, D, F, E)
    return dx


def grouped_matmul_bwd_dw(x, dy, group_sizes) -> torch.Tensor:
    """dw (E, D, F): ``x_e^T dy_e`` over each expert's rows of x (T, D) and
    dy (T, F), E = len(group_sizes), zeros for an empty expert; the sizes
    sum to at most T, and rows past the sum add nothing.  CPU tensors
    take the plain version; CUDA tensors launch the dw kernel (with no
    rows, nothing: dw is zeros)."""
    if x.device.type in PLAIN_DEVICES:
        return grouped_matmul_bwd_dw_ref(x, dy, group_sizes)
    if x.device.type != "cuda":
        raise ValueError(f"grouped_matmul_bwd_dw: no kernel for device "
                         f"{x.device}")
    E = group_sizes.shape[0]
    T, D = x.shape
    F = dy.shape[-1]
    _bwd_inputs("grouped_matmul_bwd_dw", x, dy, group_sizes, D, F, E)
    if not T:
        return x.new_zeros(E, D, F)
    dw = x.new_empty(E, D, F)
    _bwd_launch(grouped_matmul_bwd_dw, _bwd_lib()[1], x.contiguous(),
                dy.contiguous(), group_sizes, dw, T, D, F, E)
    return dw


class GroupedMatmulFn(torch.autograd.Function):
    """:func:`grouped_matmul` with its backward kernel: forward the
    wrapper, backward :func:`grouped_matmul_bwd` (the group sizes take no
    gradient)."""

    @staticmethod
    def forward(ctx, x, w, group_sizes):
        ctx.save_for_backward(x, w, group_sizes)
        return _forward(x, w, group_sizes)

    @staticmethod
    def backward(ctx, dy):
        x, w, group_sizes = ctx.saved_tensors
        dx, dw = grouped_matmul_bwd(x, w, group_sizes, dy.contiguous())
        return dx, dw, None


grouped_matmul.launches = 0
grouped_matmul_bwd_dx.launches = 0
grouped_matmul_bwd_dw.launches = 0
