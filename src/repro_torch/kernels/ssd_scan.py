"""Mamba-2 SSD chunked scan: CUDA kernel, plain version, launch count; and
the one-token recurrence step.

Replaces the TPU kernel ``repro/kernels/ssd_scan.py``, function
``ssd_scan``, and computes what its oracle ``ref.ssd_scan`` computes,
``init_state`` included: for x (B, S, H, P), dt (B, S, H) float32, A (H,)
float32 and Bm, Cm (B, S, N) shared by the heads, chunks of ``chunk``
positions, the intra-chunk quadratic form (L o C B^T)(dt x), the read-out
of the state carried into each chunk, and the state update; returns y
(B, S, H, P) and the final state (B, H, P, N), both in x's dtype.  The
kernel (``csrc/ssd_scan.cu``) runs one thread block per (b, h) over its
chunks in order, in one of two bodies that :func:`ssd_body` picks from the
shapes before the launch: the tensor-core body (wgmma, bf16 at the full
width, chunks of at least SSD_WG_QMIN positions) or the FMA body (float32,
short chunks, the reduced widths); its header says what bounds it on the
H100.

:func:`ssd_scan` launches the kernel for CUDA tensors and runs
:func:`ssd_scan_ref` for CPU tensors — the device of the input decides,
never a fallback.  ``ssd_scan.launches`` counts kernel launches.
:func:`ssd_decode_step` is plain PyTorch: the reference runs its decode
step through the oracle only (``ops.ssd_decode_step``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import (DTYPE_CODES, NEG_INF, build, count_launch,
                                 raise_problems, refuse_grad)

SSD_DIMS = ((64, 128), (32, 16))     # (P, N) built: full width, reduced
SSD_QMAX = 256                       # longest chunk the kernel takes
SSD_WG_DIMS = (64, 128)              # (P, N) of the tensor-core body
SSD_WG_QMIN = 16                     # shortest chunk it takes: below one
                                     # wgmma depth (16 keys) a 64-row tile
                                     # is mostly zero-filled rows


def ssd_body(dtype, P: int, N: int, chunk: int) -> str:
    """Which body of the kernel a launch runs, from the shapes alone and
    before the launch: "wgmma" (the tensor cores) for bf16 at (P, N) =
    SSD_WG_DIMS and chunks of at least SSD_WG_QMIN positions, else "fma"
    (float32 FMAs: the f32 identity runs, which must stay f32, the short
    chunks of odd sequence lengths, and the reduced test widths).  Never a
    choice made after a failure: a launch that fails raises."""
    if (dtype == torch.bfloat16 and (P, N) == SSD_WG_DIMS
            and chunk >= SSD_WG_QMIN):
        return "wgmma"
    return "fma"


def ssd_scan_ref(x, dt, A, Bm, Cm, *, chunk=64, init_state=None,
                 acc=torch.float32):
    """Plain version: the reference's four steps in float32 with pairwise
    contractions (a 4-operand einsum may materialise a (B, nc, H, Q, Q, P)
    intermediate), rounded once to x.dtype.  Returns (y, final_state).
    ``acc=torch.float64`` computes in float64 instead (with float64
    inputs, a yardstick of the float32 evaluation's own rounding)."""
    Bb, S, H, P = x.shape
    N = Bm.shape[-1]
    if S % chunk:
        raise ValueError(f"ssd_scan: S={S} is no multiple of chunk={chunk}")
    nc, Q = S // chunk, chunk
    f32 = acc
    xc = x.reshape(Bb, nc, Q, H, P).to(f32)
    dtc = dt.reshape(Bb, nc, Q, H).to(f32)
    Bc = Bm.reshape(Bb, nc, Q, N).to(f32)
    Cc = Cm.reshape(Bb, nc, Q, N).to(f32)
    dA = dtc * A.to(f32)                                   # (B, nc, Q, H)
    cs = torch.cumsum(dA, dim=2)                           # (B, nc, Q, H)
    csh = cs.permute(0, 1, 3, 2)                           # (B, nc, H, Q)
    # 1. intra-chunk: L[q, k] = exp(cs_q - cs_k) for k <= q, else 0
    tri = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    seg = torch.where(tri, csh[..., :, None] - csh[..., None, :],
                      torch.full((), NEG_INF, device=x.device))
    scores = Cc @ Bc.transpose(-1, -2)                     # (B, nc, Q, Q)
    xdt = (xc * dtc[..., None]).permute(0, 1, 3, 2, 4)     # (B, nc, H, Q, P)
    y = (torch.exp(seg) * scores[:, :, None]) @ xdt        # (B, nc, H, Q, P)
    # 2. each chunk's contribution to the state at its end
    decay_to_end = torch.exp(cs[:, :, -1:] - cs)           # (B, nc, Q, H)
    w = (xdt * decay_to_end.permute(0, 1, 3, 2)[..., None])
    states = w.transpose(-1, -2) @ Bc[:, :, None]          # (B, nc, H, P, N)
    # 3. the recurrence over chunks
    chunk_decay = torch.exp(cs[:, :, -1])                  # (B, nc, H)
    s = (init_state.to(f32) if init_state is not None
         else x.new_zeros(Bb, H, P, N, dtype=f32))
    prev = []
    for c in range(nc):
        prev.append(s)
        s = s * chunk_decay[:, c, :, None, None] + states[:, c]
    prev = torch.stack(prev, dim=1)                        # (B, nc, H, P, N)
    # 4. read-out of the state carried into each chunk
    y_off = (Cc[:, :, None] @ prev.transpose(-1, -2)) \
        * torch.exp(csh)[..., None]                        # (B, nc, H, Q, P)
    y = (y + y_off).permute(0, 1, 3, 2, 4).reshape(Bb, S, H, P)
    return y.to(x.dtype), s.to(x.dtype)


def ssd_decode_step(x, dt, A, Bm, Cm, state):
    """One SSD recurrence step (the reference's ``ref.ssd_decode_step``):
    x (B, H, P), dt (B, H), A (H,), Bm, Cm (B, N), state (B, H, P, N).
    Returns (y (B, H, P) in x.dtype, new state in state.dtype)."""
    f32 = torch.float32
    dA = torch.exp(dt.to(f32) * A.to(f32)[None, :])                # (B, H)
    upd = (dt.to(f32)[:, :, None, None] * x.to(f32)[..., None]
           * Bm.to(f32)[:, None, None, :])
    s_new = state.to(f32) * dA[..., None, None] + upd
    y = (s_new @ Cm.to(f32)[:, None, :, None])[..., 0]
    return y.to(x.dtype), s_new.to(state.dtype)


@functools.cache
def _lib():
    lib = build.load("ssd_scan")
    fn = lib.ssd_scan_launch
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
                   + [ctypes.c_longlong] * 10 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(x, dt, A, Bm, Cm, chunk, init_state):
    problems = []
    Bb, S, H, P = x.shape if x.ndim == 4 else (0, 0, 0, 0)
    N = Bm.shape[-1]
    if x.dtype not in DTYPE_CODES or Bm.dtype != x.dtype \
            or Cm.dtype != x.dtype:
        problems.append(f"dtypes x={x.dtype} Bm={Bm.dtype} Cm={Cm.dtype}: "
                        "need one of float32/bfloat16")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        problems.append(f"dt={dt.dtype}, A={A.dtype}: need float32")
    if (x.ndim != 4 or dt.shape != (Bb, S, H) or A.shape != (H,)
            or Bm.shape != (Bb, S, N) or Cm.shape != (Bb, S, N)):
        problems.append(f"x {tuple(x.shape)}, dt {tuple(dt.shape)}, A "
                        f"{tuple(A.shape)}, Bm {tuple(Bm.shape)}, Cm "
                        f"{tuple(Cm.shape)}: need (B, S, H, P), (B, S, H), "
                        "(H,), (B, S, N), (B, S, N)")
    elif (P, N) not in SSD_DIMS:
        problems.append(f"(P, N) = ({P}, {N}): kernel built for {SSD_DIMS}")
    if not 1 <= chunk <= SSD_QMAX or (S and S % chunk):
        problems.append(f"chunk={chunk}: need 1 <= chunk <= {SSD_QMAX} "
                        f"dividing S={S}")
    if any(t.stride(-1) != 1 for t in (x, Bm, Cm)):
        problems.append("x, Bm and Cm need a contiguous last dim")
    elif x.ndim == 4 and Bm.ndim == Cm.ndim == 3 \
            and ssd_body(x.dtype, P, N, chunk) == "wgmma":
        # the tensor-core body copies 16-byte pieces of each row: one test
        # of every base and row stride at once, the details if it fails
        init = init_state if init_state is not None \
            and init_state.is_contiguous() else None
        sx, sb, sc = x.stride(), Bm.stride(), Cm.stride()
        bits = (x.data_ptr() | Bm.data_ptr() | Cm.data_ptr()
                | (0 if init is None else init.data_ptr())
                | (sx[0] | sx[1] | sx[2] | sb[0] | sb[1] | sc[0] | sc[1])
                * x.element_size())
        if bits % 16:
            views = (("x", x), ("Bm", Bm), ("Cm", Cm), ("init_state", init))
            problems += [
                f"{name} at {t.data_ptr() % 16} bytes past a 16-byte "
                f"boundary with strides {tuple(t.stride())}: the tensor-core "
                "body needs every row on a 16-byte boundary"
                for name, t in views if t is not None and (
                    t.data_ptr() % 16 or name != "init_state" and any(
                        st * t.element_size() % 16
                        for st in t.stride()[:-1]))]
    if init_state is not None and (
            init_state.shape != (Bb, H, P, N)
            or init_state.dtype not in (x.dtype, torch.float32)):
        problems.append(f"init_state {tuple(init_state.shape)} "
                        f"{init_state.dtype}: need ({Bb}, {H}, {P}, {N}) in "
                        f"{x.dtype} or float32")
    if any(t.device != x.device for t in (dt, A, Bm, Cm)):
        problems.append("every input must lie on x's device")
    raise_problems("ssd_scan", problems)


def ssd_scan(x, dt, A, Bm, Cm, *, chunk=64, init_state=None):
    """x (B, S, H, P); dt (B, S, H) float32; A (H,) float32; Bm, Cm (B, S,
    N); chunk divides S; init_state (B, H, P, N) or None for zeros.
    Returns (y (B, S, H, P), final state (B, H, P, N)), both in x.dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    extra = () if init_state is None else (init_state,)
    refuse_grad("ssd_scan", x, dt, A, Bm, Cm, *extra,
                item="section 2 item 2.9c")
    if x.device.type == "cpu":
        return ssd_scan_ref(x, dt, A, Bm, Cm, chunk=chunk,
                            init_state=init_state)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: no kernel for device {x.device}")
    _check(x, dt, A, Bm, Cm, chunk, init_state)
    Bb, S, H, P = x.shape
    N = Bm.shape[-1]
    y = x.new_empty(Bb, S, H, P)
    fin = x.new_empty(Bb, H, P, N)
    init = None if init_state is None else init_state.contiguous()
    A = A.contiguous()
    rc = _lib()(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                Cm.data_ptr(), 0 if init is None else init.data_ptr(),
                y.data_ptr(), fin.data_ptr(), Bb, S, H, P, N, chunk,
                DTYPE_CODES[x.dtype],
                int(init is not None and init.dtype == torch.float32),
                int(ssd_body(x.dtype, P, N, chunk) == "wgmma"),
                *x.stride()[:3], *dt.stride(), *Bm.stride()[:2],
                *Cm.stride()[:2],
                torch.cuda.current_stream(x.device).cuda_stream)
    count_launch(ssd_scan, rc)
    return y, fin


ssd_scan.launches = 0
