"""Device meshes over the current process group.

The port of ``repro.launch.mesh``.  A ``DeviceMesh`` spans the ranks of
the default process group (one device each: a card under NCCL, the CPU
under gloo), with the reference's axis names.  :func:`join_mesh` is the
launchers' ``--mesh auto``.
"""
from __future__ import annotations

import math
import os

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


# the process group's rendezvous, for ranks started without torchrun: an
# init method such as file:///path/to/store (default: torchrun's env://)
INIT_METHOD_ENV = "REPRO_TORCH_INIT_METHOD"


def join_mesh(device):
    """``--mesh auto``: the ``(1, world)`` mesh over the launcher's ranks,
    or None for one rank (as the reference's ``Supernode.auto()`` gives).
    ``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK`` come from ``torchrun`` (or
    whoever starts the ranks), the rendezvous from torchrun's address or
    from :data:`INIT_METHOD_ENV`.  NCCL on the card (each rank on its
    ``LOCAL_RANK`` card), gloo with ``device="cpu"``.  Returns (mesh,
    device)."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1:
        return None, device
    import torch
    import torch.distributed as dist
    on_cpu = device is not None and str(device) == "cpu"
    if not on_cpu:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}"
        torch.cuda.set_device(device)
    dist.init_process_group("gloo" if on_cpu else "nccl",
                            init_method=os.environ.get(INIT_METHOD_ENV),
                            rank=int(os.environ.get("RANK", "0")),
                            world_size=world)
    return make_host_mesh((1, 1)), device
