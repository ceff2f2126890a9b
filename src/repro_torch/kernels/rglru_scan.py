"""RG-LRU gated linear recurrence: CUDA kernel, plain version, launch
count; and the one-token recurrence step.

Replaces the TPU kernel ``repro/kernels/rglru_scan.py``, function
``rglru_scan``, and computes what its oracle ``ref.rglru_scan`` computes,
``init_state`` included (the Pallas kernel refuses one; serving prefill
passes one): for x, input_gate, a_gate (B, S, W) and log_a (W,) float32,

    log_at = c * log_a * a_gate,  a_t = exp(log_at),
    beta_t = sqrt(-expm1(2 log_at))            (sqrt(1 - a_t^2), stably)
    h_t = a_t h_{t-1} + beta_t (input_gate_t x_t),  h_{-1} = init_state or 0

in float32, and returns h (B, S, W) and the final state h_{S-1} (B, W),
both rounded once to x's dtype.  The kernel (``csrc/rglru_scan.cu``)
parallelises the time axis inside a block: a block's warps scan
consecutive chunks of a segment from a zero carry, fold the chunks'
(prod a, local h) pairs into carries through shared memory, and fix up
h_t = local_t + prod_t carry_in; its header says what bounds it on the
H100 (bytes) and how its segments were sized.

:func:`rglru_scan` launches the kernel for CUDA tensors and runs
:func:`rglru_scan_ref` for CPU tensors — the device of the input decides,
never a fallback.  ``rglru_scan.launches`` counts kernel launches.

Gradients: when an input requires grad, :func:`rglru_scan` runs
:class:`RGLRUScanFn`, whose backward is :func:`rglru_scan_bwd`: the
hand-written ``csrc/rglru_scan_bwd.cu`` on CUDA tensors (no
``pallas_call`` counterpart: the reference differentiates its oracle
``ref.rglru_scan``), :func:`rglru_scan_bwd_ref` on CPU tensors.
``rglru_scan_bwd.launches`` counts backward calls (each launches the
file's four kernels: the time axis split over blocks in chunks, the
chunks' carries joined by a short walk, the gradients, the d log_a sum).
:func:`rglru_decode_step` is plain PyTorch: the reference runs its decode
step through the oracle only (``ops.rglru_decode_step``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.meshctx import is_dtensor
from repro_torch.kernels import (DTYPE_CODES, PLAIN_DEVICES, build,
                                 count_launch, on_local_shards,
                                 raise_problems, sharded_on)


def _gates(input_gate, a_gate, log_a, x, c, f):
    """(a_t, beta_t (input_gate x)) in type ``f``, as the oracle forms
    them."""
    log_at = c * log_a.to(f) * a_gate.to(f)
    a = torch.exp(log_at)
    beta = torch.sqrt(-torch.expm1(2.0 * log_at))
    return a, beta * (input_gate.to(f) * x.to(f))


def rglru_scan_ref(x, input_gate, a_gate, log_a, *, init_state=None,
                   c: float = 8.0, acc=torch.float32):
    """Plain version: the oracle's (a, b) monoid, combine(l, r) = (a_l a_r,
    b_l a_r + b_r), scanned over S in log2(S) Hillis-Steele steps in
    float32 (as ``jax.lax.associative_scan`` scans it in a log-depth
    tree, not a loop of S steps), the initial state folded into the first
    step; rounded once to x.dtype.  Returns (h, final state).
    ``acc=torch.float64`` computes in float64 instead (with float64
    inputs, a yardstick of the float32 evaluation's own rounding)."""
    a, b = _gates(input_gate, a_gate, log_a, x, c, acc)
    if init_state is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * init_state.to(acc)[:, None],
                       b[:, 1:]], dim=1)
    b = _linear_scan(a, b)
    return b.to(x.dtype), b[:, -1].to(x.dtype)


def _linear_scan(a, b):
    """h_t = a_t h_{t-1} + b_t from h_{-1} = 0 along dim 1, in log2(S)
    Hillis-Steele steps of the (a, b) monoid."""
    S, d = a.shape[1], 1
    while d < S:
        b = torch.cat([b[:, :d], b[:, :-d] * a[:, d:] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
        d *= 2
    return b


def rglru_scan_bwd_ref(x, input_gate, a_gate, log_a, dh, dfin, *,
                       init_state=None, c: float = 8.0, acc=torch.float32):
    """Plain backward of :func:`rglru_scan_ref` in ``acc`` (float32;
    float64 the yardstick), not autograd.  ``dh`` (B, S, W) and ``dfin``
    (B, W) are the outputs' gradients (``dfin`` None: zeros).  The
    adjoint g of h runs the recurrence backwards, g_t = dh_t + a_{t+1}
    g_{t+1} with dfin added at t = S - 1 (the same monoid scanned over the
    reversed time axis, a shifted by one), on h recomputed in ``acc``;
    then with b_t = beta_t i_t x_t,

      d log_at = g_t h_{t-1} a_t - g_t (i_t x_t) a_t^2 / beta_t

    (the derivative of beta = sqrt(-expm1(2 log_at)) is -a_t^2 / beta_t),
    dx = g beta i, d input_gate = g beta x, d a_gate = d log_at c log_a,
    d log_a = sum_{b,t} d log_at c a_gate and d init_state = a_0 g_0.
    Returns (dx, d input_gate, d a_gate, d log_a, d init_state or None) in
    the inputs' dtypes."""
    f = acc
    log_at = c * log_a.to(f) * a_gate.to(f)
    a = torch.exp(log_at)
    beta = torch.sqrt(-torch.expm1(2.0 * log_at))
    ix = input_gate.to(f) * x.to(f)
    b = beta * ix
    h0 = (init_state.to(f) if init_state is not None
          else x.new_zeros(x.shape[0], x.shape[2], dtype=f))
    b0 = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    h = _linear_scan(a, b0)
    h_prev = torch.cat([h0[:, None], h[:, :-1]], dim=1)
    gin = dh.to(f).clone()
    if dfin is not None:
        gin[:, -1] += dfin.to(f)
    a_next = torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], dim=1)
    g = torch.flip(_linear_scan(torch.flip(a_next, (1,)),
                                torch.flip(gin, (1,))), (1,))
    dlog_at = g * h_prev * a - g * ix * a * a / beta
    dx = g * beta * input_gate.to(f)
    dig = g * beta * x.to(f)
    dag = dlog_at * c * log_a.to(f)
    dla = (dlog_at * c * a_gate.to(f)).sum((0, 1))
    dinit = (None if init_state is None
             else (a[:, 0] * g[:, 0]).to(init_state.dtype))
    return (dx.to(x.dtype), dig.to(input_gate.dtype), dag.to(a_gate.dtype),
            dla.to(log_a.dtype), dinit)


def rglru_decode_step(x, input_gate, a_gate, log_a, state, *,
                      c: float = 8.0):
    """One RG-LRU step (the reference's ``ref.rglru_decode_step``): x,
    input_gate, a_gate, state (B, W), log_a (W,).  Returns (h in x.dtype,
    new state in state.dtype)."""
    a, b = _gates(input_gate, a_gate, log_a, x, c, torch.float32)
    h = a * state.float() + b
    return h.to(x.dtype), h.to(state.dtype)


@functools.cache
def _lib():
    lib = build.load("rglru_scan")
    fn = lib.rglru_scan_launch
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 6
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(x, input_gate, a_gate, log_a, init_state):
    problems = []
    if x.dtype not in DTYPE_CODES or input_gate.dtype != x.dtype \
            or a_gate.dtype != x.dtype:
        problems.append(f"dtypes x={x.dtype} input_gate={input_gate.dtype} "
                        f"a_gate={a_gate.dtype}: need one of "
                        "float32/bfloat16")
    if log_a.dtype != torch.float32:
        problems.append(f"log_a={log_a.dtype}: need float32")
    Bb, S, W = x.shape if x.ndim == 3 else (0, 0, 0)
    if (x.ndim != 3 or input_gate.shape != x.shape or a_gate.shape != x.shape
            or log_a.shape != (W,) or S < 1):
        problems.append(f"x {tuple(x.shape)}, input_gate "
                        f"{tuple(input_gate.shape)}, a_gate "
                        f"{tuple(a_gate.shape)}, log_a {tuple(log_a.shape)}: "
                        "need (B, S, W) thrice with S >= 1, and (W,)")
    if any(t.stride(-1) != 1 for t in (x, input_gate, a_gate)):
        problems.append("x, input_gate and a_gate need a contiguous last dim")
    if init_state is not None and (
            init_state.shape != (Bb, W)
            or init_state.dtype not in (x.dtype, torch.float32)):
        problems.append(f"init_state {tuple(init_state.shape)} "
                        f"{init_state.dtype}: need ({Bb}, {W}) in {x.dtype} "
                        "or float32")
    extra = () if init_state is None else (init_state,)
    if any(t.device != x.device for t in (input_gate, a_gate, log_a, *extra)):
        problems.append("every input must lie on x's device")
    raise_problems("rglru_scan", problems)


def rglru_scan(x, input_gate, a_gate, log_a, *, init_state=None,
               c: float = 8.0):
    """x, input_gate, a_gate (B, S, W), each with a contiguous last dim;
    log_a (W,) float32; init_state (B, W) in x's dtype or float32, or None
    for zeros.  Returns (h (B, S, W), final state (B, W)), both in x.dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    When an input requires grad, :class:`RGLRUScanFn` runs instead.  DTensor
    inputs (HyperServe and the train step on a mesh) run this wrapper on
    each rank's rows and channels under ``local_map`` (:func:`_mesh_scan`),
    with a gradient where an input requires one.
    """
    if any(is_dtensor(t) for t in (x, init_state)):
        return _mesh_scan(x, input_gate, a_gate, log_a, init_state, c)
    extra = () if init_state is None else (init_state,)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, input_gate, a_gate, log_a, *extra)):
        return RGLRUScanFn.apply(x, input_gate, a_gate, log_a, init_state, c)
    return _forward(x, input_gate, a_gate, log_a, init_state, c)


def mesh_placements(x, init_state=None):
    """The placements the scan and its backward run under on a mesh, a
    dict: the channels sharded over the mesh dims that shard the seat
    state's (dim 1 of ``init_state``; x's dim 2 without a state), each
    rank scanning its own channels from its own rows of the pool (the
    recurrence is channelwise), and the rows (dim 0) over the mesh dims
    that shard them (the train step's batch over the dp axes).  ``ch`` is
    that of x, both gates, h and their gradients, ``state`` the states',
    ``per_ch`` log_a's; log_a's gradient (log_a is summed over every row)
    is ``Partial`` over the row dims (``d_la``).  No input is shared
    across channels."""
    from torch.distributed.tensor import Partial, Shard
    ref, d = (init_state, 1) if is_dtensor(init_state) else (x, 2)
    rows = ((0, 0),)
    per_ch = sharded_on(ref, d, 0)
    return dict(
        mesh=ref.device_mesh, ch=list(sharded_on(ref, d, 2, also=rows)),
        state=list(sharded_on(ref, d, 1, also=rows)), per_ch=list(per_ch),
        d_la=[Partial() if isinstance(r, Shard) else p
              for r, p in zip(sharded_on(ref, 0), per_ch)])


def _mesh_scan(x, input_gate, a_gate, log_a, init_state, c):
    """:func:`rglru_scan` on a mesh, under :func:`mesh_placements`: one
    launch a rank a call on its rows and channels.  Under grad each rank's
    call runs :class:`RGLRUScanFn` on its shards, so ``rglru_scan_bwd``
    runs on them too, and log_a's gradient comes back ``Partial`` over
    the row dims."""
    pl = mesh_placements(x, init_state)
    ch, state = pl["ch"], pl["state"]
    ins = (ch, ch, ch, pl["per_ch"], None if init_state is None else state)
    return on_local_shards(
        lambda x, ig, ag, la, init: rglru_scan(x, ig, ag, la,
                                               init_state=init, c=c),
        pl["mesh"], (ch, state), ins, x, input_gate, a_gate, log_a,
        init_state, in_grad_placements=(None, None, None, pl["d_la"], None))


def _forward(x, input_gate, a_gate, log_a, init_state, c):
    if x.device.type in PLAIN_DEVICES:
        return rglru_scan_ref(x, input_gate, a_gate, log_a,
                              init_state=init_state, c=c)
    if x.device.type != "cuda":
        raise ValueError(f"rglru_scan: no kernel for device {x.device}")
    _check(x, input_gate, a_gate, log_a, init_state)
    Bb, S, W = x.shape
    h = x.new_empty(Bb, S, W)
    fin = x.new_empty(Bb, W)
    init = None if init_state is None else init_state.contiguous()
    log_a = log_a.contiguous()
    rc = _lib()(x.data_ptr(), input_gate.data_ptr(), a_gate.data_ptr(),
                log_a.data_ptr(), 0 if init is None else init.data_ptr(),
                h.data_ptr(), fin.data_ptr(), Bb, S, W, DTYPE_CODES[x.dtype],
                int(init is not None and init.dtype == torch.float32),
                *x.stride()[:2], *input_gate.stride()[:2],
                *a_gate.stride()[:2], c,
                torch.cuda.current_stream(x.device).cuda_stream)
    count_launch(rglru_scan, rc)
    return h, fin


rglru_scan.launches = 0


class RGLRUScanFn(torch.autograd.Function):
    """The RG-LRU scan with a gradient: the forward kernel (the plain
    forward on CPU tensors) saves its inputs, not its bf16 output (the
    backward needs h_{t-1} in float32 and recomputes it); the backward is
    :func:`rglru_scan_bwd`, the final state's gradient (None when the loss
    does not reach it, as in training) starting the reverse sweep.  Under
    ``torch.utils.checkpoint`` each remat'd layer launches the forward
    kernel twice and the backward once."""

    @staticmethod
    def forward(ctx, x, input_gate, a_gate, log_a, init_state, c):
        ctx.set_materialize_grads(False)
        h, fin = _forward(x, input_gate, a_gate, log_a, init_state, c)
        ctx.save_for_backward(x, input_gate, a_gate, log_a, init_state)
        ctx.c = c
        return h, fin

    @staticmethod
    def backward(ctx, dh, dfin):
        x, input_gate, a_gate, log_a, init_state = ctx.saved_tensors
        if dh is None:
            dh = torch.zeros_like(x)
        grads = rglru_scan_bwd(x, input_gate, a_gate, log_a, dh, dfin,
                               init_state=init_state, c=ctx.c)
        return (*grads, None)


RG_BWD_CHUNK = 64    # steps a chunk of csrc/rglru_scan_bwd.cu


def rglru_bwd_workspace(B: int, S: int, W: int) -> int:
    """f32 values of the backward's workspace, six (B, ceil(S /
    RG_BWD_CHUNK), W) planes, one value a (row, chunk, channel) in each:
    the chunks' pairs from zero carries (the product of a, the local h at
    the chunk's end, the adjoint's local sum), then the carries joined
    across chunks (h into each chunk, the adjoint out of it), then each
    chunk's d log_a partial."""
    return 6 * B * -(-S // RG_BWD_CHUNK) * W


@functools.cache
def _bwd_lib():
    lib = build.load("rglru_scan_bwd")
    fn = lib.rglru_scan_bwd_launch
    fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def rglru_scan_bwd(x, input_gate, a_gate, log_a, dh, dfin, *,
                   init_state=None, c: float = 8.0):
    """Gradients (dx, d input_gate, d a_gate, d log_a, d init_state or
    None) of :func:`rglru_scan` from the outputs' gradients ``dh`` and
    ``dfin`` (None: zeros).  CPU tensors take :func:`rglru_scan_bwd_ref`;
    CUDA tensors launch ``csrc/rglru_scan_bwd.cu``'s four kernels in one
    call, counted once on ``rglru_scan_bwd.launches``.  The inputs are the
    forward's and pass its checks; dh must match x, dfin the state's shape
    in x's dtype or float32.  DTensor inputs (a mesh's train step hands
    its scans' backward the local shards inside ``local_map``; a direct
    call on DTensors) run this wrapper on each rank's rows and channels
    under ``local_map`` (:func:`mesh_placements`), d log_a ``Partial``
    over the row dims."""
    if any(is_dtensor(t) for t in (x, dh, init_state)):
        pl = mesh_placements(x, init_state)
        ch, state = pl["ch"], pl["state"]
        init = None if init_state is None else state
        return on_local_shards(
            lambda x, ig, ag, la, dh, dfin, i: rglru_scan_bwd(
                x, ig, ag, la, dh, dfin, init_state=i, c=c),
            pl["mesh"], (ch, ch, ch, pl["d_la"], init),
            (ch, ch, ch, pl["per_ch"], ch, None if dfin is None else state,
             init),
            x, input_gate, a_gate, log_a, dh, dfin, init_state)
    if x.device.type in PLAIN_DEVICES:
        return rglru_scan_bwd_ref(x, input_gate, a_gate, log_a, dh, dfin,
                                  init_state=init_state, c=c)
    if x.device.type != "cuda":
        raise ValueError(f"rglru_scan_bwd: no kernel for device {x.device}")
    x, input_gate, a_gate, log_a, dh = (
        t.contiguous() for t in (x, input_gate, a_gate, log_a, dh))
    _check(x, input_gate, a_gate, log_a, init_state)
    Bb, S, W = x.shape
    problems = []
    if dh.shape != x.shape or dh.dtype != x.dtype or dh.device != x.device:
        problems.append(f"dh {tuple(dh.shape)} {dh.dtype}: need "
                        f"{tuple(x.shape)} {x.dtype} on {x.device}")
    if dfin is not None and (dfin.shape != (Bb, W)
                             or dfin.dtype not in (x.dtype, torch.float32)
                             or dfin.device != x.device):
        problems.append(f"dfin {tuple(dfin.shape)} {dfin.dtype}: need "
                        f"({Bb}, {W}) in {x.dtype} or float32")
    raise_problems("rglru_scan_bwd", problems)
    init = None if init_state is None else init_state.contiguous()
    dfin = None if dfin is None else dfin.contiguous()
    dx, dig, dag = (torch.empty_like(x) for _ in range(3))
    dla = torch.empty(W, dtype=torch.float32, device=x.device)
    dinit = None if init is None else torch.empty_like(init)
    ws = torch.empty(rglru_bwd_workspace(Bb, S, W), dtype=torch.float32,
                     device=x.device)
    rc = _bwd_lib()(x.data_ptr(), input_gate.data_ptr(), a_gate.data_ptr(),
                    log_a.data_ptr(), 0 if init is None else init.data_ptr(),
                    dh.data_ptr(), 0 if dfin is None else dfin.data_ptr(),
                    dx.data_ptr(), dig.data_ptr(), dag.data_ptr(),
                    dla.data_ptr(), 0 if dinit is None else dinit.data_ptr(),
                    ws.data_ptr(), Bb, S, W, DTYPE_CODES[x.dtype],
                    int(init is not None and init.dtype == torch.float32),
                    int(dfin is not None and dfin.dtype == torch.float32),
                    c, torch.cuda.current_stream(x.device).cuda_stream)
    count_launch(rglru_scan_bwd, rc)
    return dx, dig, dag, dla, dinit


rglru_scan_bwd.launches = 0
