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

Gradients: when an input requires grad, :func:`ssd_scan` runs
:class:`SSDScanFn`, whose backward is :func:`ssd_scan_bwd`: the
hand-written ``csrc/ssd_scan_bwd.cu`` on CUDA tensors (no
``pallas_call`` counterpart: the reference differentiates its oracle
``ref.ssd_scan``), :func:`ssd_scan_bwd_ref` on CPU tensors; for bf16 at
the full width every product runs on the tensor cores
(:func:`ssd_bwd_body`).  ``ssd_scan_bwd.launches`` counts backward calls
(each launches the body's kernels, as the file's header lists them).
:func:`ssd_decode_step` is plain PyTorch: the reference runs its decode
step through the oracle only (``ops.ssd_decode_step``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.meshctx import is_dtensor
from repro_torch.kernels import (DTYPE_CODES, NEG_INF, PLAIN_DEVICES, build,
                                 count_launch, on_local_shards,
                                 raise_problems, sharded_on)

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


def ssd_scan_bwd_ref(x, dt, A, Bm, Cm, dy, dfin, *, chunk, init_state=None,
                     acc=torch.float32):
    """Plain backward of :func:`ssd_scan_ref`: an explicit reverse chunked
    scan in ``acc`` (float32; float64 the yardstick), not autograd.  ``dy``
    (B, S, H, P) and ``dfin`` (B, H, P, N) are the outputs' gradients
    (``dfin`` None: zeros).  With cs the running sum of dt A in a chunk,
    M = L o (C B^T) the decayed scores, S_c the state carried into chunk c
    and g_c the adjoint of the state at its end (g = dfin after the last
    chunk, g_{c-1} = exp(cs_last) g_c + sum_q exp(cs_q) dy_q^T C_q):

      d(x dt)_k = sum_q M_qk dy_q + exp(cs_last - cs_k) g B_k,
      dG_qk = sum_h L_qk (dy_q . (x dt)_k)  (dC += dG B, dB += dG^T C),
      dC_q += sum_h exp(cs_q) S_c^T dy_q,  dB_k += sum_h exp(cs_last -
      cs_k) g^T (x dt)_k,

    and d cs from every exponential, whose reverse running sum in the
    chunk is d(dt A).  Returns (dx, ddt, dA, dBm, dCm, d init_state or
    None) in the inputs' dtypes."""
    Bb, S, H, P = x.shape
    N = Bm.shape[-1]
    nc, Q = S // chunk, chunk
    f = acc
    xc = x.reshape(Bb, nc, Q, H, P).to(f).permute(0, 1, 3, 2, 4)  # (B,nc,H,Q,P)
    dyc = dy.reshape(Bb, nc, Q, H, P).to(f).permute(0, 1, 3, 2, 4)
    dtc = dt.reshape(Bb, nc, Q, H).to(f).permute(0, 1, 3, 2)      # (B,nc,H,Q)
    Bc = Bm.reshape(Bb, nc, Q, N).to(f)
    Cc = Cm.reshape(Bb, nc, Q, N).to(f)
    Af = A.to(f)
    cs = torch.cumsum(dtc * Af[:, None], dim=-1)                  # (B,nc,H,Q)
    last = cs[..., -1]                                            # (B,nc,H)
    tri = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    L = torch.exp(torch.where(tri, cs[..., :, None] - cs[..., None, :],
                              torch.full((), NEG_INF, dtype=f,
                                         device=x.device)))
    M = L * (Cc @ Bc.transpose(-1, -2))[:, :, None]             # (B,nc,H,Q,Q)
    xdt = xc * dtc[..., None]
    decay = torch.exp(last[..., None] - cs)                       # (B,nc,H,Q)
    eq = torch.exp(cs)
    # the states carried into the chunks, and the adjoints at their ends
    states = (xdt * decay[..., None]).transpose(-1, -2) @ Bc[:, :, None]
    R = (dyc * eq[..., None]).transpose(-1, -2) @ Cc[:, :, None]
    s = (init_state.to(f) if init_state is not None
         else x.new_zeros(Bb, H, P, N, dtype=f))
    prev = []
    for c in range(nc):
        prev.append(s)
        s = s * torch.exp(last[:, c])[..., None, None] + states[:, c]
    prev = torch.stack(prev, dim=1)                               # (B,nc,H,P,N)
    g = (dfin.to(f) if dfin is not None
         else x.new_zeros(Bb, H, P, N, dtype=f))
    gend = [None] * nc
    for c in reversed(range(nc)):
        gend[c] = g
        g = g * torch.exp(last[:, c])[..., None, None] + R[:, c]
    gend = torch.stack(gend, dim=1)
    # x dt: the intra-chunk products and the state's
    u = Bc[:, :, None] @ gend.transpose(-1, -2)                   # g B_k
    dxdt = M.transpose(-1, -2) @ dyc + decay[..., None] * u
    dM = dyc @ xdt.transpose(-1, -2)
    dG = (dM * L).sum(2)                                          # (B,nc,Q,Q)
    T = dM * M
    sd = decay * (xdt * u).sum(-1)
    dcs = T.sum(-1) - T.sum(-2) - sd
    dcs = dcs + eq * (dyc * (Cc[:, :, None] @ prev.transpose(-1, -2))).sum(-1)
    dcs[..., -1] += sd.sum(-1) + torch.exp(last) * (gend * prev).sum((-1, -2))
    d_dA = torch.flip(torch.cumsum(torch.flip(dcs, (-1,)), -1), (-1,))
    ddt = (dxdt * xc).sum(-1) + d_dA * Af[:, None]
    dA = (d_dA * dtc).sum((0, 1, 3))
    dx = dxdt * dtc[..., None]
    dC = dG @ Bc + ((dyc * eq[..., None]) @ prev).sum(2)
    dB = dG.transpose(-1, -2) @ Cc + ((xdt * decay[..., None]) @ gend).sum(2)
    dinit = None if init_state is None else g.to(init_state.dtype)
    return (dx.permute(0, 1, 3, 2, 4).reshape(Bb, S, H, P).to(x.dtype),
            ddt.permute(0, 1, 3, 2).reshape(Bb, S, H).to(dt.dtype),
            dA.to(A.dtype), dB.reshape(Bb, S, N).to(Bm.dtype),
            dC.reshape(Bb, S, N).to(Cm.dtype), dinit)


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
    When an input requires grad, :class:`SSDScanFn` runs instead.  DTensor
    inputs (HyperServe and the train step on a mesh) run this wrapper on
    each rank's rows and heads under ``local_map`` (:func:`_mesh_scan`),
    with a gradient where an input requires one.
    """
    if any(is_dtensor(t) for t in (x, init_state)):
        return _mesh_scan(x, dt, A, Bm, Cm, chunk, init_state)
    extra = () if init_state is None else (init_state,)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, A, Bm, Cm, *extra)):
        return SSDScanFn.apply(x, dt, A, Bm, Cm, init_state, chunk)
    return _forward(x, dt, A, Bm, Cm, chunk, init_state)


def mesh_placements(x, init_state=None):
    """The placements the scan and its backward run under on a mesh, a
    dict: the heads sharded over the mesh dims that shard the seat state's
    heads (dim 1 of ``init_state``; x's dim 2 without a state), so that
    each rank scans its own heads from its own rows of the pool, and the
    rows (dim 0) over the mesh dims that shard them (the train step's
    batch over the dp axes); B and C, shared by the heads, whole over the
    head dims.  ``heads`` is that of x, dt, y and their gradients,
    ``state`` the states', ``per_head`` A's, ``shared`` B's and C's; A's
    gradient (A is summed over every row) is ``Partial`` over the row dims
    (``d_a``), and B's and C's (summed over every head) over the head dims
    (``d_bc``), so that each is the sum of the ranks' parts."""
    from torch.distributed.tensor import Partial, Shard
    ref, d = (init_state, 1) if is_dtensor(init_state) else (x, 2)
    rows = ((0, 0),)
    shared, per_head = sharded_on(ref, 0), sharded_on(ref, d, 0)
    return dict(
        mesh=ref.device_mesh, heads=list(sharded_on(ref, d, 2, also=rows)),
        state=list(sharded_on(ref, d, 1, also=rows)),
        per_head=list(per_head), shared=list(shared),
        d_a=[Partial() if isinstance(r, Shard) else h
             for r, h in zip(shared, per_head)],
        d_bc=[Partial() if isinstance(h, Shard) else r
              for r, h in zip(shared, per_head)])


def _mesh_scan(x, dt, A, Bm, Cm, chunk, init_state):
    """:func:`ssd_scan` on a mesh, under :func:`mesh_placements`: one
    launch a rank a call on its rows and heads.  Under grad each rank's
    call runs :class:`SSDScanFn` on its shards, so ``ssd_scan_bwd`` runs
    on them too, and the gradients of A, B and C come back ``Partial``
    where each rank holds a part of them."""
    pl = mesh_placements(x, init_state)
    heads, shared, state = pl["heads"], pl["shared"], pl["state"]
    ins = (heads, heads, pl["per_head"], shared, shared,
           None if init_state is None else state)
    return on_local_shards(
        lambda x, dt, A, Bm, Cm, init: ssd_scan(x, dt, A, Bm, Cm, chunk=chunk,
                                                init_state=init),
        pl["mesh"], (heads, state), ins, x, dt, A, Bm, Cm, init_state,
        in_grad_placements=(None, None, pl["d_a"], pl["d_bc"], pl["d_bc"],
                            None))


def _forward(x, dt, A, Bm, Cm, chunk, init_state):
    if x.device.type in PLAIN_DEVICES:
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


class SSDScanFn(torch.autograd.Function):
    """The SSD scan with a gradient: the forward kernel (the plain forward
    on CPU tensors) saves its inputs; the backward is :func:`ssd_scan_bwd`
    with both output gradients, the final state's (None when the loss does
    not reach it, as in training) starting the reverse sweep.  Under
    ``torch.utils.checkpoint`` the forward runs again in the backward
    pass, so each remat'd layer launches the forward kernel twice and the
    backward once."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, init_state, chunk):
        ctx.set_materialize_grads(False)
        y, fin = _forward(x, dt, A, Bm, Cm, chunk, init_state)
        ctx.save_for_backward(x, dt, A, Bm, Cm, init_state)
        ctx.chunk = chunk
        return y, fin

    @staticmethod
    def backward(ctx, dy, dfin):
        x, dt, A, Bm, Cm, init_state = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        grads = ssd_scan_bwd(x, dt, A, Bm, Cm, dy, dfin, chunk=ctx.chunk,
                             init_state=init_state)
        return (*grads, None)


SSD_BWD_KT = 32      # keys (and queries) a tile of the backward's kernels
SSD_BWD_BODIES = {"fma": 0, "mma": 1}   # the launcher's body codes
SSD_BWD_SPLITS = 8   # most parts of a chunk decay's d cs_last (FMA body)


def ssd_bwd_body(dtype, P: int, N: int) -> str:
    """Which body the backward runs, from the shapes alone and before the
    launch: "mma" (the tensor cores, the f32 operands in three bf16 parts:
    wgmma for the chunk states and the query pass, mma.sync for the key
    pass) for bf16 at (P, N) = SSD_WG_DIMS, whatever the chunk, else "fma"
    (float32 FMAs: the f32 identity runs, which must stay f32, and the
    reduced widths)."""
    if dtype == torch.bfloat16 and (P, N) == SSD_WG_DIMS:
        return "mma"
    return "fma"


def ssd_bwd_workspace(B: int, S: int, H: int, P: int, N: int,
                      chunk: int, body: str) -> int:
    """f32 values of the backward's workspace (``csrc/ssd_scan_bwd.cu``)
    for ``body``: the chunk-boundary states and their adjoints (B H nc P N
    each: f32 in the FMA body; three bf16 parts, 1.5 f32 values an entry,
    in the tensor-core body, which writes them once as the products read
    them), the running sums cs and the d cs parts of the key and query
    passes (B H S each), the head-summed dG (B nc Q Q), the score rows'
    partial sums (B H nc ceil(Q / 32) Q), each key tile's share of d
    cs_last (B H nc ceil(Q / 32)), the chunk decays' d cs_last (B H nc: one
    in-block sum a chunk in the tensor-core body; up to SSD_BWD_SPLITS
    parts in the FMA body) and dA's per-row partials (B H)."""
    nc, nt = S // chunk, -(-chunk // SSD_BWD_KT)
    mma = body == "mma"
    state = B * H * nc * P * N * (3 if mma else 2) // 2
    return (2 * state + 3 * B * H * S + B * nc * chunk * chunk
            + B * H * nc * nt * chunk + B * H * nc * nt
            + B * H * nc * (1 if mma else SSD_BWD_SPLITS) + B * H)


@functools.cache
def _bwd_lib():
    lib = build.load("ssd_scan_bwd")
    fn = lib.ssd_scan_bwd_launch
    fn.argtypes = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 10
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def ssd_scan_bwd(x, dt, A, Bm, Cm, dy, dfin, *, chunk, init_state=None):
    """Gradients (dx, ddt, dA, dBm, dCm, d init_state or None) of
    :func:`ssd_scan` from the outputs' gradients ``dy`` and ``dfin``
    (None: zeros).  CPU tensors take :func:`ssd_scan_bwd_ref`; CUDA
    tensors launch ``csrc/ssd_scan_bwd.cu``'s kernels in one call, counted
    once on ``ssd_scan_bwd.launches``.  The inputs are the forward's and
    pass its checks; dy must match x, dfin the state's shape in x's dtype
    or float32.  DTensor inputs (a mesh's train step hands its scans'
    backward the local shards inside ``local_map``; a direct call on
    DTensors) run this wrapper on each rank's rows and heads under
    ``local_map`` (:func:`mesh_placements`), dA ``Partial`` over the row
    dims and dBm, dCm over the head dims."""
    if any(is_dtensor(t) for t in (x, dy, init_state)):
        pl = mesh_placements(x, init_state)
        heads, shared, state = pl["heads"], pl["shared"], pl["state"]
        init = None if init_state is None else state
        return on_local_shards(
            lambda x, dt, A, Bm, Cm, dy, dfin, i: ssd_scan_bwd(
                x, dt, A, Bm, Cm, dy, dfin, chunk=chunk, init_state=i),
            pl["mesh"], (heads, heads, pl["d_a"], pl["d_bc"], pl["d_bc"],
                         init),
            (heads, heads, pl["per_head"], shared, shared, heads,
             None if dfin is None else state, init),
            x, dt, A, Bm, Cm, dy, dfin, init_state)
    if x.device.type in PLAIN_DEVICES:
        return ssd_scan_bwd_ref(x, dt, A, Bm, Cm, dy, dfin, chunk=chunk,
                                init_state=init_state)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan_bwd: no kernel for device {x.device}")
    # contiguous, x, Bm, Cm and dy on 16-byte boundaries (the tensor-core
    # body copies 16-byte pieces of their rows)
    x, dt, A, Bm, Cm, dy = (t.contiguous() for t in (x, dt, A, Bm, Cm, dy))
    x, Bm, Cm, dy = (t if t.data_ptr() % 16 == 0 else t.clone()
                     for t in (x, Bm, Cm, dy))
    _check(x, dt, A, Bm, Cm, chunk, init_state)
    Bb, S, H, P = x.shape
    N = Bm.shape[-1]
    problems = []
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        problems.append(f"dy {tuple(dy.shape)} {dy.dtype}: need "
                        f"{tuple(x.shape)} {x.dtype} on {x.device}")
    if dfin is not None and (dfin.shape != (Bb, H, P, N)
                             or dfin.dtype not in (x.dtype, torch.float32)
                             or dfin.device != x.device):
        problems.append(f"dfin {tuple(dfin.shape)} {dfin.dtype}: need "
                        f"({Bb}, {H}, {P}, {N}) in {x.dtype} or float32")
    raise_problems("ssd_scan_bwd", problems)
    init = None if init_state is None else init_state.contiguous()
    dfin = None if dfin is None else dfin.contiguous()
    dx, dB, dC = (torch.empty_like(t) for t in (x, Bm, Cm))
    ddt = torch.empty(Bb, S, H, dtype=torch.float32, device=x.device)
    dA = torch.empty(H, dtype=torch.float32, device=x.device)
    dinit = None if init is None else torch.empty_like(init)
    body = ssd_bwd_body(x.dtype, P, N)
    ws = torch.empty(ssd_bwd_workspace(Bb, S, H, P, N, chunk, body),
                     dtype=torch.float32, device=x.device)
    rc = _bwd_lib()(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                    Bm.data_ptr(), Cm.data_ptr(),
                    0 if init is None else init.data_ptr(), dy.data_ptr(),
                    0 if dfin is None else dfin.data_ptr(), dx.data_ptr(),
                    ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(),
                    dC.data_ptr(), 0 if dinit is None else dinit.data_ptr(),
                    ws.data_ptr(), Bb, S, H, P, N, chunk,
                    DTYPE_CODES[x.dtype],
                    int(init is not None and init.dtype == torch.float32),
                    int(dfin is not None and dfin.dtype == torch.float32),
                    SSD_BWD_BODIES[body],
                    torch.cuda.current_stream(x.device).cuda_stream)
    count_launch(ssd_scan_bwd, rc)
    return dx, ddt, dA, dB, dC, dinit


ssd_scan_bwd.launches = 0
