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
count each entry point's kernel launches.  On DTensors (MoE on a mesh)
every entry point runs on each rank's local shards under ``local_map``
and counts one launch a rank a call (:func:`mesh_placements`).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.meshctx import is_dtensor
from repro_torch.kernels import (DTYPE_CODES, PLAIN_DEVICES, build,
                                 count_launch, on_local_shards,
                                 raise_problems)


def grouped_matmul_ref(x, w, group_sizes) -> torch.Tensor:
    """Plain version: one f32 matmul per non-empty expert on its slice of
    rows, rounded once to x.dtype (the reference's
    ``ref.grouped_matmul``, without its (T, D, F) gather of every row's
    weights).  The sizes may sum to less than T: the rows past the sum
    belong to no expert and come out as zeros (the kernel leaves them
    unwritten).  Reads the sizes back to the host, which the kernel does
    not."""
    T, F = x.shape[0], w.shape[2]
    out = x.new_empty(T, F)
    start = 0
    for e, n in enumerate(group_sizes.tolist()):
        if n:
            out[start:start + n] = (x[start:start + n].float()
                                    @ w[e].float()).to(x.dtype)
        start += n
    _check_sum("grouped_matmul", start, T, "x")
    out[start:] = 0
    return out


def _check_sum(name: str, total: int, T: int, what: str) -> None:
    if total > T:
        raise ValueError(f"{name}: group sizes sum to {total}, {what} has "
                         f"{T} rows")


def grouped_matmul_bwd_dx_ref(dy, w, group_sizes, *, acc=torch.float32):
    """Plain dx (T, D) of :func:`grouped_matmul_ref` for the output's
    gradient ``dy`` (T, F): one product ``dy_e w[e]^T`` per non-empty
    expert in ``acc`` (float32; float64 the yardstick of the f32
    evaluation's own rounding), rounded once to dy's dtype.  Reads the sizes
    back to the host.  As in the forward, the sizes may sum to less than
    T, and the rows past the sum are zeros."""
    T, D = dy.shape[0], w.shape[1]
    dx = dy.new_empty(T, D)
    start = 0
    for e, n in enumerate(group_sizes.tolist()):
        if n:
            dx[start:start + n] = (dy[start:start + n].to(acc)
                                   @ w[e].to(acc).T).to(dy.dtype)
        start += n
    _check_sum("grouped_matmul_bwd", start, T, "dy")
    dx[start:] = 0
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
    _check_sum("grouped_matmul_bwd", start, x.shape[0], "x")
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
    summing to at most T (the rows past the sum belong to no expert: the
    kernel leaves them unwritten, the plain version zeros them).  Returns
    (T, F) in x.dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    Differentiable in x and w: when a gradient is recorded the call goes
    through :class:`GroupedMatmulFn`, whose backward is
    :func:`grouped_matmul_bwd`.

    DTensor x and w (MoE on a mesh) run this wrapper on each rank's local
    shards under ``local_map``, one launch a rank a call
    (:func:`mesh_placements`): where w shards its experts (expert
    parallelism), each rank multiplies its own rows, x's ``Shard(0)``, by
    its own experts, the sizes a DTensor sharded alike (each rank's
    experts' row counts); elsewhere w is gathered whole.
    """
    if is_dtensor(x) or is_dtensor(w):
        _, wp, _ = mesh_placements(x, _experts_of(w, group_sizes))
        w = w.redistribute(w.device_mesh, wp)   # differentiable: a gather
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return GroupedMatmulFn.apply(x, w, group_sizes)
    return _forward(x, w, group_sizes)


def _experts_of(w, group_sizes) -> list:
    """Per mesh dim of the DTensor ``w``: whether it shards w's experts
    (dim 0 over more than one rank).  The group sizes must then be a
    DTensor sharded there too, each rank's own experts' counts."""
    from torch.distributed.tensor import Shard
    if not is_dtensor(w):
        raise ValueError("grouped_matmul: a DTensor x takes a DTensor w")
    ep = [isinstance(q, Shard) and q.dim == 0 and n > 1
          for q, n in zip(w.placements, w.device_mesh.shape)]
    if any(ep) and _experts_of_sizes(group_sizes) != ep:
        raise ValueError(f"grouped_matmul: w's experts sharded "
                         f"{w.placements}, the group sizes "
                         f"{getattr(group_sizes, 'placements', 'plain')}: "
                         "each rank needs its own experts' sizes")
    return ep


def _experts_of_sizes(group_sizes) -> list:
    """Per mesh dim: whether the DTensor sizes shard the experts."""
    from torch.distributed.tensor import Shard
    if not is_dtensor(group_sizes):
        return []
    return [isinstance(q, Shard) and n > 1 for q, n in
            zip(group_sizes.placements, group_sizes.device_mesh.shape)]


def mesh_placements(x, experts):
    """(x's, w's, dw's) placements of a call on DTensors, per mesh dim of
    x's mesh, given ``experts`` (per mesh dim: whether the experts are
    sharded there).  x keeps its rows' sharding (``Shard(0)``, each rank's
    own rows) or replication; w is ``Shard(0)`` where the experts are
    sharded, which needs x's rows sharded there too, and ``Replicate``
    elsewhere; dw is ``Shard(0)`` with the experts, a ``Partial`` sum
    where only the rows are sharded (each rank's rows add to every
    expert's gradient), ``Replicate`` where neither is."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    if not is_dtensor(x):
        raise ValueError("grouped_matmul: a DTensor w takes a DTensor x")
    experts = list(experts) or [False] * x.device_mesh.ndim
    xp, wp, dwp = [], [], []
    for p, ep, n in zip(x.placements, experts, x.device_mesh.shape):
        rows = isinstance(p, Shard) and p.dim == 0
        if not (rows or isinstance(p, Replicate)) or (ep and not rows):
            raise ValueError(f"grouped_matmul: x placed {x.placements}: "
                             "its rows must be sharded (dim 0) or "
                             "replicated, and sharded where the experts are")
        xp.append(Shard(0) if rows else Replicate())
        wp.append(Shard(0) if ep else Replicate())
        dwp.append(Shard(0) if ep else Partial() if rows and n > 1
                   else Replicate())
    return xp, wp, dwp


def _sizes_placements(group_sizes):
    return tuple(group_sizes.placements) if is_dtensor(group_sizes) else None


def _forward(x, w, group_sizes) -> torch.Tensor:
    if is_dtensor(x):
        xp, wp, _ = mesh_placements(x, _experts_of(w, group_sizes))
        return on_local_shards(_forward, x.device_mesh, xp,
                               (xp, wp, _sizes_placements(group_sizes)),
                               x, w, group_sizes)
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
    transposed; the sizes sum to at most T, as the forward's do (the
    kernel leaves the rows past a smaller sum unwritten, the plain version
    zeros them).  CPU tensors take the plain version; CUDA tensors launch
    the dx kernel (with no rows, nothing: dx is empty); DTensors run it on
    each rank's shards under ``local_map``, placed as the forward's x and
    w (:func:`mesh_placements`)."""
    if is_dtensor(dy):
        xp, wp, _ = mesh_placements(dy, _experts_of(w, group_sizes))
        return on_local_shards(grouped_matmul_bwd_dx, dy.device_mesh, xp,
                               (xp, wp, _sizes_placements(group_sizes)),
                               dy, w, group_sizes)
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
    rows, nothing: dw is zeros); DTensors run it on each rank's shards
    under ``local_map``, dw sharded on its experts where the sizes are and
    a ``Partial`` sum where only x's rows are (:func:`mesh_placements`)."""
    if is_dtensor(x):
        xp, _, dwp = mesh_placements(x, _experts_of_sizes(group_sizes))
        return on_local_shards(grouped_matmul_bwd_dw, x.device_mesh, dwp,
                               (xp, xp, _sizes_placements(group_sizes)),
                               x, dy, group_sizes)
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
