"""Mesh context for sharding hints inside model code.

The port of ``repro.core.meshctx``.  Model code never names a concrete
mesh; it calls ``constrain(x, ("pod", "data"), None, "model")`` with
logical axis names.  While a ``DeviceMesh`` is active (:func:`use_mesh`,
entered by the sharded train step) a DTensor ``x`` is redistributed to
the spec's placements, the counterpart of ``with_sharding_constraint``;
with no mesh, or on a plain tensor, it is the identity, so the same model
code runs on one device and on a mesh unchanged.

:func:`use_mesh` also enters DTensor's ``implicit_replication``: a plain
tensor that meets a DTensor in one operator (the RoPE positions, a
vocab mask, the AdamW schedule's step count) takes part as a replicated
DTensor, as a constant does in the reference's SPMD program.
"""
from __future__ import annotations

import contextlib
import types
from repro_torch.core.layout import placements_on

# process-wide, not thread-local: autograd runs a CUDA backward on its own
# device thread, and a checkpointed layer's recompute there must take the
# same mesh path (the same constrain points and dispatch) as its forward
_state = types.SimpleNamespace(mesh=None)


def current_mesh():
    """The active ``DeviceMesh``, or None."""
    return _state.mesh


@contextlib.contextmanager
def use_mesh(mesh):
    prev = current_mesh()
    _state.mesh = mesh
    try:
        if mesh is None:
            yield
        else:
            from torch.distributed.tensor.experimental import \
                implicit_replication
            with implicit_replication():
                yield
    finally:
        _state.mesh = prev


def mesh_axis_size(mesh, name: str) -> int:
    """The size of ``mesh``'s axis ``name`` (1 for an axis it lacks)."""
    names = tuple(mesh.mesh_dim_names or ())
    return mesh.shape[names.index(name)] if name in names else 1


def _filter_spec(mesh, spec):
    """Drop axis names the mesh doesn't have (e.g. 'pod' on single-pod)."""
    names = tuple(mesh.mesh_dim_names or ())
    out = []
    for s in spec:
        if s is None:
            out.append(None)
        elif isinstance(s, (tuple, list)):
            kept = tuple(a for a in s if a in names)
            out.append(kept if kept else None)
        else:
            out.append(s if s in names else None)
    return tuple(out)


def spec_divides(mesh, shape, spec) -> bool:
    """Whether every dim of ``shape`` divides the mesh axes ``spec``
    (already filtered) shards it over."""
    for dim, s in zip(shape, spec):
        if s is None:
            continue
        n = 1
        for a in ((s,) if isinstance(s, str) else s):
            n *= mesh_axis_size(mesh, a)
        if dim % n:
            return False
    return True


def constrain(x, *spec):
    """Sharding hint: no-op without an active mesh or on a plain tensor.
    A spec that does not divide ``x``'s shape is skipped, as in the
    reference (e.g. tiny smoke shapes)."""
    mesh = current_mesh()
    if mesh is None or not is_dtensor(x):
        return x
    sp = _filter_spec(mesh, spec)
    if not spec_divides(mesh, x.shape, sp):
        return x
    placements = placements_on(sp, mesh)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(mesh, placements)


def is_dtensor(t) -> bool:
    """Whether ``t`` is a DTensor (a tensor on a ``DeviceMesh``)."""
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def local_placed(t, mesh, placements):
    """This rank's local shard of ``t`` placed by ``placements`` on
    ``mesh``: a DTensor is redistributed first; a plain tensor (the same
    on every rank) is taken as replicated and chunked, with no
    communication."""
    from torch.distributed.tensor import DTensor, Replicate
    if not is_dtensor(t):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    return t.redistribute(mesh, placements).to_local()


def as_dtensor(t, mesh):
    """``t`` as a DTensor on ``mesh``: a plain tensor (the same on every
    rank) as replicated, with no communication; a DTensor as it is."""
    if is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def local_index(t, index):
    """``t[index]`` where ``index`` picks rows of leading dims that no
    placement shards and keeps ``t``'s rank (a seat index, block and
    offset tensors): on a DTensor the rows of this rank's shard, as a
    DTensor with ``t``'s placements (DTensor has no rule for such an
    advanced index; no communication is needed)."""
    if not is_dtensor(t):
        return t[index]
    from torch.distributed.tensor import DTensor, Shard
    if any(isinstance(p, Shard) and p.dim < len(index)
           for p in t.placements):
        raise ValueError(f"local_index: {t.placements} shard a dim the "
                         f"index picks from (the first {len(index)})")
    return DTensor.from_local(t.to_local()[index], t.device_mesh,
                              t.placements, run_check=False)


def local_index_put(t, index, v) -> None:
    """``t[index] = v`` in place, ``index`` as :func:`local_index` takes
    it; on a DTensor ``t`` into this rank's shard (a view of ``t``'s own
    storage), from ``v`` placed as ``t`` is."""
    if is_dtensor(t):
        v = local_placed(v, t.device_mesh, t.placements)
        t = t.to_local()
    t[index] = v.to(t.dtype)


def split_heads(t, heads: int):
    """``t`` (..., heads * d) viewed as (..., heads, d).  On a DTensor
    whose last dim is sharded over a mesh dim whose size does not divide
    ``heads`` (a column shard that HyperShard's divisibility rule keeps
    for the product dim, e.g. 4 heads of 96 over 3 ranks), that mesh dim
    is gathered first: DTensor cannot split a shard across a head
    boundary, where the reference's partitioner reshards."""
    if is_dtensor(t):
        from torch.distributed.tensor import Replicate, Shard
        last = t.dim() - 1
        pl = [Replicate() if isinstance(p, Shard) and p.dim % t.dim() == last
              and heads % n else p
              for p, n in zip(t.placements, t.device_mesh.shape)]
        if pl != list(t.placements):
            t = t.redistribute(t.device_mesh, pl)
    return t.reshape(*t.shape[:-1], heads, t.shape[-1] // heads)


def whole_dims(t, *dims):
    """``t`` with its dims ``dims`` whole on every rank: on a DTensor each
    mesh dim that shards one of them is gathered, the others keep their
    placements (the batch rows stay where they are); a plain tensor as it
    is.  The causal conv takes its rows so: its shifted slices along the
    sequence need every position of a row on one rank."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate, Shard
    want = {d % t.dim() for d in dims}
    pl = [Replicate() if isinstance(p, Shard) and p.dim % t.dim() in want
          else p for p in t.placements]
    if pl == list(t.placements):
        return t
    return t.redistribute(t.device_mesh, pl)


def full_tensor(t):
    """A DTensor's full value as a plain tensor on every rank (a
    collective); a plain tensor as it is."""
    return t.full_tensor() if is_dtensor(t) else t


def replicated(x):
    """``x`` gathered in full on every rank of its mesh (a DTensor with
    every placement ``Replicate``); the identity on a plain tensor.  The
    embedding lookup takes its table so: DTensor's row-sharded lookup
    yields a masked partial sum that its redistribution cannot reduce
    when the rows are also sharded over a second mesh dim, and the
    gradient of the gathered table goes back to the shards as a reduce
    scatter."""
    from torch.distributed.tensor import Replicate
    if not is_dtensor(x):
        return x
    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)


def dp_entry(mesh):
    """The spec entry of the batch dim: the dp axes as the reference's
    ``P`` entry spells them (one name, a tuple, or None)."""
    dp = tuple(a for a in ("pod", "data")
               if a in tuple(mesh.mesh_dim_names or ()))
    return dp if len(dp) > 1 else (dp[0] if dp else None)

