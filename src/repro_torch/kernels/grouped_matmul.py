"""Ragged grouped matmul (MoE expert compute): CUDA kernel, plain version,
launch count.

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

:func:`grouped_matmul` launches the kernel for CUDA tensors and runs
:func:`grouped_matmul_ref` for CPU tensors — the device of the input
decides, never a fallback.  ``grouped_matmul.launches`` counts kernel
launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import (DTYPE_CODES, PLAIN_DEVICES, build,
                                 count_launch, raise_problems, refuse_grad)


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


@functools.cache
def _lib():
    lib = build.load("grouped_matmul")
    fn = lib.grouped_matmul_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


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
    """
    refuse_grad("grouped_matmul", x, w,
                item="section 2 item 2.9b; train MoE under gshard")
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


grouped_matmul.launches = 0
