"""HyperShard's declarative Layout abstraction (paper §3.4), on DTensor.

The port of ``repro.core.layout``::

    Layout(device_matrix, alias_name, tensor_map)

  - device_matrix : logical arrangement of devices, e.g. (2, 16, 16)
  - alias_name    : name per device-matrix dimension, e.g. ("pod","data","model")
  - tensor_map    : per tensor dimension, which device dims shard it

Declaring a Layout derives the parallel strategy; no tensor is sliced
until it is distributed.  The reference's derivation target is a
``NamedSharding`` over a ``jax.sharding.Mesh``; here it is one DTensor
placement per dim of a ``torch.distributed.device_mesh.DeviceMesh`` with
the same axis names (:meth:`ShardStrategy.placements`).  A spec is the
reference's ``PartitionSpec`` as a plain tuple, one entry per tensor dim:
None, an axis name, or a tuple of axis names (major first).

A tensor dim sharded over two axes, e.g. ``("pod", "data")``, becomes
``Shard(d)`` on each of those mesh dims.  DTensor splits such a dim over
its mesh dims left to right, so the mesh dim named first is the major one,
as in JAX; the rules only name axes in mesh order, which
:meth:`ShardStrategy.placements` checks.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple, Union

AxisRef = Union[str, None, Tuple[str, ...]]


class LayoutError(ValueError):
    pass


@dataclasses.dataclass(frozen=True)
class Layout:
    device_matrix: Tuple[int, ...]
    alias_name: Tuple[str, ...]

    def __post_init__(self):
        if len(self.device_matrix) != len(self.alias_name):
            raise LayoutError(
                f"device_matrix {self.device_matrix} and alias_name "
                f"{self.alias_name} must have equal rank")
        if len(set(self.alias_name)) != len(self.alias_name):
            raise LayoutError(f"duplicate alias in {self.alias_name}")
        for n in self.device_matrix:
            if n < 1:
                raise LayoutError(f"non-positive device dim {n}")

    @property
    def num_devices(self) -> int:
        return math.prod(self.device_matrix)

    def axis_size(self, alias: str) -> int:
        try:
            return self.device_matrix[self.alias_name.index(alias)]
        except ValueError:
            raise LayoutError(f"unknown alias {alias!r}; have {self.alias_name}")

    def __call__(self, *tensor_map: AxisRef) -> "ShardStrategy":
        used: set = set()
        for entry in tensor_map:
            for a in axes_of(entry):
                if a not in self.alias_name:
                    raise LayoutError(
                        f"tensor_map references {a!r}, not in {self.alias_name}")
                if a in used:
                    raise LayoutError(f"alias {a!r} used for two tensor dims")
                used.add(a)
        return ShardStrategy(self, tuple(tensor_map))


def axes_of(entry: AxisRef) -> Tuple[str, ...]:
    """The axis names of one spec entry (None -> (), a name -> (name,))."""
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


@dataclasses.dataclass(frozen=True)
class ShardStrategy:
    """A formally derived parallel strategy for one tensor (paper Fig. 6)."""
    layout: Layout
    tensor_map: Tuple[AxisRef, ...]

    def partition_spec(self) -> Tuple[AxisRef, ...]:
        return self.tensor_map

    def shards_per_dim(self) -> Tuple[int, ...]:
        return tuple(math.prod(self.layout.axis_size(a) for a in axes_of(e))
                     for e in self.tensor_map)

    def shard_shape(self, global_shape: Sequence[int]) -> Tuple[int, ...]:
        """Derive the per-device shard shape (validates divisibility)."""
        if len(global_shape) < len(self.tensor_map):
            raise LayoutError(
                f"tensor rank {len(global_shape)} < tensor_map rank "
                f"{len(self.tensor_map)}")
        out = []
        nper = self.shards_per_dim()
        for i, dim in enumerate(global_shape):
            n = nper[i] if i < len(nper) else 1
            if dim % n:
                raise LayoutError(
                    f"dim {i} of size {dim} not divisible by {n} shards")
            out.append(dim // n)
        return tuple(out)

    def divisible(self, global_shape: Sequence[int]) -> bool:
        try:
            self.shard_shape(global_shape)
            return True
        except LayoutError:
            return False

    def placements(self, mesh) -> tuple:
        """One DTensor placement per dim of ``mesh`` (a ``DeviceMesh`` whose
        axis names and shape are this layout's): ``Shard(d)`` on every mesh
        dim that shards tensor dim ``d``, ``Replicate()`` on the others and
        on every mesh dim of size 1 (:func:`placements_on`)."""
        check_mesh(mesh, self.layout)
        return placements_on(self.tensor_map, mesh)


def placements_for(spec, alias_name: Sequence[str]) -> tuple:
    """DTensor placements of ``spec`` over mesh dims named ``alias_name``.
    A dim sharded over several axes must name them in mesh order (the
    major one first), the order in which DTensor splits it."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate()] * len(alias_name)
    for d, entry in enumerate(spec):
        axes = axes_of(entry)
        idx = [alias_name.index(a) for a in axes]
        if idx != sorted(idx):
            raise LayoutError(f"dim {d} names {axes} out of mesh order "
                              f"{tuple(alias_name)}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def placements_on(spec, mesh) -> tuple:
    """:func:`placements_for` over ``mesh``'s axes, with ``Replicate()``
    on every mesh dim of size 1: sharding over one device is no sharding,
    as in JAX, and DTensor's propagation then never has to reshape a dim
    that is "sharded" one way (some versions refuse to flatten such a
    dim, e.g. ``x @ w`` over a (B, S, D) activation with S on a size-1
    ``model`` axis)."""
    from torch.distributed.tensor import Replicate
    return tuple(Replicate() if n == 1 else p for n, p in zip(
        mesh.shape, placements_for(spec, mesh.mesh_dim_names)))


def spec_of(placements, alias_name: Sequence[str], ndim: int):
    """The spec (one entry per tensor dim, as the reference's
    ``PartitionSpec`` entries) that ``placements`` over ``alias_name``
    realise; the inverse of :func:`placements_for`."""
    from torch.distributed.tensor import Shard
    axes = [[] for _ in range(ndim)]
    for name, p in zip(alias_name, placements):
        if isinstance(p, Shard):
            axes[p.dim % ndim].append(name)
    return tuple(None if not a else (a[0] if len(a) == 1 else tuple(a))
                 for a in axes)


def check_mesh(mesh, layout: Layout) -> None:
    names = tuple(mesh.mesh_dim_names or ())
    if names != layout.alias_name or \
            tuple(mesh.shape) != layout.device_matrix:
        raise LayoutError(
            f"mesh {tuple(mesh.shape)}/{names} does not match layout "
            f"{layout.device_matrix}/{layout.alias_name}")


def layout_for_mesh(mesh) -> Layout:
    """The Layout describing an existing mesh's device matrix."""
    return Layout(tuple(mesh.shape), tuple(mesh.mesh_dim_names))
