"""Hand-written Hopper kernels of the port, their plain PyTorch versions,
and the dispatch in :mod:`repro_torch.kernels.ops`.  CUDA sources live in
``csrc/`` and build at first use (:mod:`repro_torch.kernels.build`).

What every attention wrapper shares lives here: the reference's masked
score, the dtype codes of ``csrc/common.cuh``, the checks of what the
kernels take, and the launch bookkeeping."""
import torch

NEG_INF = -1e30                                      # masked score
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}  # REPRO_F32, REPRO_BF16
SAME_DIMS = ((64, 64), (128, 128), (256, 256))       # (Dk, Dv) built
# devices whose tensors take a wrapper's plain version: the CPU, and meta
# tensors (shapes only, no data: the residency planner's graph walk);
# CUDA tensors launch the kernel, any other device raises
PLAIN_DEVICES = ("cpu", "meta")


def refuse_grad(name: str, *tensors, item: str = "train step") -> None:
    """Raise when a gradient is asked of a kernel that has no backward
    (the wrappers launch through ctypes, so autograd would not see the
    kernel and the gradient would be wrong in silence).  Flash attention,
    the two scans and the grouped matmul have one
    (``flash_attention.FlashAttentionFn``, ``ssd_scan.SSDScanFn``,
    ``rglru_scan.RGLRUScanFn``, ``grouped_matmul.GroupedMatmulFn``); the
    decode kernels serve only: ``item`` names the ROADMAP.md item that
    brings this one's."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: an input requires grad, and the kernel "
                           f"has no backward yet (ROADMAP.md, {item}); "
                           "run under torch.no_grad()")


def attention_problems(q, k, v, *, vector_loads=False, pairs=SAME_DIMS):
    """What the kernels cannot take in q (..., H, Dk), k (..., KV, Dk) and
    v (..., KV, Dv): the dtypes, the (Dk, Dv) pair (one of ``pairs``), the
    head grouping (H a multiple of KV), contiguous k and v, and, for
    kernels that read k and v with 16-byte vector loads, their alignment.
    Returns the list of problems, empty when the kernels take them."""
    H, D, KV = q.shape[-2], q.shape[-1], k.shape[-2]
    problems = []
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        problems.append(f"dtypes q={q.dtype} k={k.dtype} v={v.dtype}: need "
                        "one of float32/bfloat16")
    dims = (D, v.shape[-1])
    if dims not in pairs or k.shape[-1] != D:
        problems.append(f"head dims q {D}, k {k.shape[-1]}, v {v.shape[-1]}: "
                        f"kernel built for (Dk, Dv) in {pairs}")
    if H % KV:
        problems.append(f"H={H}, KV={KV}: need H % KV == 0")
    if not (k.is_contiguous() and v.is_contiguous()):
        problems.append("k and v must be contiguous")
    if vector_loads and (k.data_ptr() | v.data_ptr()) % 16:
        problems.append("k and v must start on a 16-byte boundary (the "
                        "kernel reads them with 16-byte vector loads)")
    return problems


def side_input_problems(q, rows: int, *, pools=(), block_size=None,
                        tables=None, lengths=None, starts=None, limits=None,
                        dense=()):
    """What is wrong with the side inputs of an attention kernel whose
    queries ``q`` have ``rows`` rows: every pool, table, vector and dense
    tensor (flash's k and v) must lie on q's device, since the kernel is
    handed their raw pointers; ``tables`` must be (rows, W) and
    ``lengths``, ``starts`` and ``limits`` (rows,), all of an integer
    dtype; each pool's dim 1 must be ``block_size``.  Reads shapes, dtypes
    and devices only, so meta tensors do.  Returns the list of problems."""
    problems = []
    named = [(f"pool {i}", t) for i, t in enumerate(pools)]
    named += [(n, t) for n, t in (("block_tables", tables),
                                  ("lengths", lengths), ("starts", starts),
                                  ("limits", limits)) if t is not None]
    named += [(n, t) for n, t in zip("kv", dense)]
    for name, t in named:
        if t.device != q.device:
            problems.append(f"{name} on {t.device}, q on {q.device}: every "
                            "input of the kernel must lie on q's device")
    if tables is not None and (tables.dim() != 2 or tables.shape[0] != rows):
        problems.append(f"block_tables {tuple(tables.shape)}: need "
                        f"({rows}, W)")
    for name, t in (("block_tables", tables), ("lengths", lengths),
                    ("starts", starts), ("limits", limits)):
        if t is None:
            continue
        if name != "block_tables" and tuple(t.shape) != (rows,):
            problems.append(f"{name} {tuple(t.shape)}: need ({rows},)")
        if t.dtype.is_floating_point or t.dtype.is_complex \
                or t.dtype == torch.bool:
            problems.append(f"{name} of dtype {t.dtype}: need integers")
    for i, pool in enumerate(pools):
        if pool.dim() < 2 or pool.shape[1] != block_size:
            problems.append(f"pool {i} {tuple(pool.shape)}: dim 1 must be "
                            f"block_size={block_size}")
    return problems


def raise_problems(name: str, problems) -> None:
    if problems:
        raise ValueError(f"{name} kernel: " + "; ".join(problems))


def count_launch(wrapper, rc: int) -> None:
    """Raise when the C launcher returned an error (``cudaGetLastError``
    after the launch, or -1 for a configuration no kernel was built for);
    else count the launch on ``wrapper.launches``."""
    if rc != 0:
        raise RuntimeError(f"{wrapper.__name__} launch failed: code {rc}")
    wrapper.launches += 1


def sharded_on(t, dim: int, as_dim=None, *, also=()) -> tuple:
    """One DTensor placement per dim of ``t``'s mesh: ``Shard(as_dim)``
    (default ``dim``) where the DTensor ``t`` is sharded on its dim ``dim``
    (and the mesh dim has more than one rank), ``Replicate()`` elsewhere:
    the placements of another tensor whose dim ``as_dim`` is sharded as
    ``t``'s dim ``dim`` is.  ``also`` holds more ``(dim, as_dim)`` pairs
    kept the same way (a train scan keeps the batch rows sharded as well as
    the heads).  The serving kernels run on each rank's heads (channels)
    of a pool or a seat state sharded so, and on all of them where it
    replicates."""
    from torch.distributed.tensor import Replicate, Shard
    pairs = dict(((dim, dim if as_dim is None else as_dim), *also))
    return tuple(Shard(pairs[p.dim]) if isinstance(p, Shard)
                 and p.dim in pairs and n > 1 else Replicate()
                 for p, n in zip(t.placements, t.device_mesh.shape))


def on_local_shards(fn, mesh, out_placements, in_placements, *args,
                    in_grad_placements=None):
    """``fn(*args)`` on each rank's local shards under ``local_map``: a
    DTensor argument is redistributed to its entry of ``in_placements``
    first, an entry of None takes the argument as a plain tensor (a
    DTensor there is gathered in full: the side inputs, block tables,
    lengths, starts and limits, are the same on every rank).
    ``out_placements`` is a list for one output, a tuple of lists for
    several.  ``in_grad_placements`` gives, where an entry is not None,
    the placements of that input's local gradient: ``Partial`` over the
    mesh dims where each rank's call sees only a part of the input's uses
    (an input shared by the rows or the heads that the mesh splits), so
    that the parts are summed; elsewhere the gradient is placed as the
    input.  ``fn`` is
    the wrapper itself, so every rank launches its kernel once (one launch
    a rank a call) on plain tensors and the checks see local tensors."""
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.core.meshctx import full_tensor
    args = tuple(full_tensor(a) if p is None and a is not None else a
                 for a, p in zip(args, in_placements))
    grads = None
    if in_grad_placements is not None:
        grads = tuple(p if g is None else g
                      for p, g in zip(in_placements, in_grad_placements))
    return local_map(fn, out_placements=out_placements,
                     in_placements=in_placements,
                     in_grad_placements=grads, device_mesh=mesh,
                     redistribute_inputs=True)(*args)
