"""Device meshes over the current process group.

The port of ``repro.launch.mesh``.  A ``DeviceMesh`` spans the ranks of
the default process group (one device each: a card under NCCL, the CPU
under gloo), with the reference's axis names.  :func:`join_mesh` is the
launchers' ``--mesh auto``; :func:`join_world` and :func:`role_groups`
carve the launcher's ranks into HyperMPMD role groups (``--disaggregate``,
``--plan rl_disagg``).
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


# every collective and receive of the launchers' process group waits at most
# this long, so that a rank whose peer died fails rather than hangs
TIMEOUT_S = 600


def join_world(device):
    """Join the launcher's ranks (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``
    from ``torchrun``, the rendezvous from torchrun's address or from
    :data:`INIT_METHOD_ENV`): NCCL on the cards (each rank on its
    ``LOCAL_RANK`` card), gloo with ``device="cpu"``; :data:`TIMEOUT_S`
    bounds every collective and every receive.  Returns this rank's
    device."""
    import datetime

    import torch
    import torch.distributed as dist
    world = int(os.environ.get("WORLD_SIZE", "1"))
    on_cpu = device is not None and str(device) == "cpu"
    if not on_cpu:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}"
        torch.cuda.set_device(device)
    dist.init_process_group("gloo" if on_cpu else "nccl",
                            init_method=os.environ.get(INIT_METHOD_ENV),
                            rank=int(os.environ.get("RANK", "0")),
                            world_size=world,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return device


def auto_roles(roles, n: int):
    """A role -> rank count mapping over ``n`` ranks, the reference's
    ``Supernode._role_groups``: a count of 0 auto-balances what the fixed
    counts leave over the auto roles, in order (the first ones take the
    remainder), and :class:`TopologyError` where the roles need more ranks
    than there are or resolve to an empty group."""
    roles = dict(roles)
    fixed = sum(c for c in roles.values() if c > 0)
    n_auto = sum(1 for c in roles.values() if c == 0)
    spare = n - fixed
    if spare < n_auto:
        raise TopologyError(
            f"plan roles {roles} need more devices than the session has "
            f"({n}); shrink the roles or grow the topology")
    mapping, auto_i = {}, 0
    for name, count in roles.items():
        if count == 0:
            count = spare // n_auto + (1 if auto_i < spare % n_auto else 0)
            auto_i += 1
        mapping[name] = count
    if any(c < 1 for c in mapping.values()):
        raise TopologyError(f"plan roles {roles} resolve to an empty group "
                            f"on {n} devices: {mapping}")
    return mapping


def role_groups(roles):
    """The role groups of :func:`auto_roles` over the world's ranks
    (:func:`repro_torch.core.mpmd.groups_from_mapping`; every rank calls
    this, in the same order)."""
    import torch.distributed as dist

    from repro_torch.core import mpmd
    n = dist.get_world_size() if dist.is_initialized() else 1
    return mpmd.groups_from_mapping(auto_roles(roles, n))


def join_mesh(device):
    """``--mesh auto``: the ``(1, world)`` mesh over the launcher's ranks,
    or None for one rank (as the reference's ``Supernode.auto()`` gives).
    ``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK`` come from ``torchrun`` (or
    whoever starts the ranks), the rendezvous from torchrun's address or
    from :data:`INIT_METHOD_ENV`.  NCCL on the card (each rank on its
    ``LOCAL_RANK`` card), gloo with ``device="cpu"``.  Returns (mesh,
    device)."""
    if int(os.environ.get("WORLD_SIZE", "1")) == 1:
        return None, device
    device = join_world(device)
    return make_host_mesh((1, 1)), device
