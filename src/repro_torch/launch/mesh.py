"""Device meshes over the current process group.

The port of ``repro.launch.mesh``.  A ``DeviceMesh`` spans the ranks of
the default process group (one device each: a card under NCCL, the CPU
under gloo), with the reference's axis names.
"""
from __future__ import annotations

import math

from repro_torch.api.errors import TopologyError


def make_host_mesh(shape=(1, 1), axes=("data", "model"), *, device=None):
    """A mesh of ``shape`` over the world's ranks, axes named ``axes``.
    ``(1, 1)`` widens to ``(1, world)``, as the reference widens it to
    ``(1, n)`` over its devices.  ``device`` is the device type (default:
    ``"cuda"`` under NCCL, else ``"cpu"``).  The process group must be
    initialised first."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise TopologyError("make_host_mesh needs an initialised process "
                            "group (torch.distributed.init_process_group)")
    n = dist.get_world_size()
    shape = tuple(shape)
    if shape == (1, 1) and n > 1:
        shape = (1, n)
    if math.prod(shape) != n:
        raise TopologyError(f"mesh {shape} needs {math.prod(shape)} ranks; "
                            f"the process group has {n}")
    if device is None:
        device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device, shape, mesh_dim_names=tuple(axes))
