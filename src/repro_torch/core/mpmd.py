"""HyperMPMD (paper §3.3): role groups over the ranks of a process group.

The port of ``repro.core.mpmd``.  The reference is single-controller: one
Python process owns every device, ``MPMDScheduler.submit`` returns after
JAX's asynchronous dispatch and :func:`transfer` is a resharding
``device_put``.  The port runs one process per rank, so each role's ranks
run their own program and the roles meet by point-to-point messages over
the world's default group:

  - :class:`ProcessGroup` is a name, the group's ranks, its ``DeviceMesh``
    (``(1, n)`` over ``("data", "model")``; None for a group of one rank,
    which runs as the one-device engines do) and its
    ``torch.distributed`` group;
  - :func:`groups_from_mapping` carves the groups out of the world's ranks
    in the mapping's order (the paper's node-to-module mapping file,
    Listing 1).  ``dist.new_group`` and ``DeviceMesh`` are collective over
    the whole world, so EVERY rank builds every group, in the same order,
    the ranks outside a group included;
  - :func:`transfer` hands a tree of tensors from one group's layout to
    another's: the source group gathers each leaf in full (a collective on
    its mesh), its first rank sends the leaves to every destination rank
    as one byte buffer, and each destination rank keeps its own shard as
    ``placements`` say (no communication on the destination mesh).  A rank
    in both groups copies locally;
  - :class:`Handoff` is the pipeline's hand-off of one tensor whose shape
    and dtype the receiver already knows: no header, the send does not
    block (``dist.isend``; the handle and its buffer are kept until
    :meth:`Handoff.wait`), and each direction between two ranks has a
    process group of its own, so that two stages that send to each other
    at once (an activation one way, a cotangent the other) cannot wait on
    each other for ever;
  - :class:`MPMDScheduler` runs a task on the ranks of its group; the
    group's first rank then sends the task's window (submit, done) and
    name to every other rank, so that every rank records every role's
    tasks alike:
    ``mpmd.tasks.{group}``, ``mpmd.bubble_s.{group}``, the ``mpmd.bubble_s``
    histogram and a span a task on track ``mpmd:{group}``, and
    :meth:`MPMDScheduler.utilization_report` is the same on every rank.

Gloo cannot send a CUDA tensor: where the world's backend is gloo (two
processes on one card, as ``chip_smoke.py`` runs them; NCCL refuses two
ranks on one card) the bytes go through pinned host buffers, one copy off
the card before a send and one onto it after a receive.  Under NCCL they go
card to card.  Every call here but :meth:`Handoff.send` blocks until its
peer answers; the process group's timeout bounds the wait for a peer that
died.
"""
from __future__ import annotations

import dataclasses
import pickle
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.tree import tree_leaves, tree_map


@dataclasses.dataclass
class ProcessGroup:
    """A named slice of the world's ranks running its own program."""
    name: str
    ranks: Tuple[int, ...]
    mesh: Any = None                 # DeviceMesh, None for one rank
    group: Any = None                # the torch.distributed group

    @property
    def leader(self) -> int:
        """The group's first rank: it sends what the group hands over."""
        return self.ranks[0]

    def has(self, rank: Optional[int] = None) -> bool:
        """Whether ``rank`` (default: this process's) is in the group."""
        return (my_rank() if rank is None else rank) in self.ranks


def my_rank() -> int:
    """This process's rank in the world (0 without a process group)."""
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def _world_ranks() -> List[int]:
    import torch.distributed as dist
    return list(range(dist.get_world_size() if dist.is_initialized() else 1))


AXES = ("data", "model")           # every group's mesh: (1, n) over these


def groups_from_mapping(mapping: Dict[str, int],
                        shapes: Optional[Dict[str, Tuple[int, int]]] = None
                        ) -> Dict[str, ProcessGroup]:
    """Carve process groups out of the world's ranks (paper Listing 1).

    mapping: {"prefill": 2, "decode": 2, ...}, carved in order from the
    world's ranks; a group of n > 1 ranks gets a mesh over :data:`AXES`,
    of the shape ``shapes[name]`` (a (data, model) pair, as a pipeline
    stage's ``stage_mesh`` asks; default ``(1, n)``), on the cards under
    NCCL and on the host under gloo.  Every rank must call this with the
    same mapping."""
    ranks = _world_ranks()
    shapes = shapes or {}
    need = sum(mapping.values())
    if need > len(ranks):
        raise ValueError(f"mapping needs {need} devices, have {len(ranks)}")
    for name, shape in shapes.items():
        if int(np.prod(shape)) != mapping[name]:
            raise ValueError(f"group {name}: mesh {tuple(shape)} needs "
                             f"{int(np.prod(shape))} ranks, the mapping "
                             f"gives it {mapping[name]}")
    import torch.distributed as dist
    live = dist.is_initialized()
    device_type = "cuda" if live and dist.get_backend() == "nccl" else "cpu"
    groups: Dict[str, ProcessGroup] = {}
    off = 0
    for name, n in mapping.items():
        sub = tuple(ranks[off:off + n])
        off += n
        pg = mesh = None
        if live:
            pg = dist.new_group(list(sub))
            if n > 1:
                from torch.distributed.device_mesh import DeviceMesh
                mesh = DeviceMesh(device_type, torch.tensor(sub).reshape(
                    shapes.get(name, (1, n))), mesh_dim_names=AXES)
        groups[name] = ProcessGroup(name, sub, mesh, pg)
    return groups


def serving_groups(n_prefill: int, n_decode: int) -> Dict[str, ProcessGroup]:
    """Prefill/decode disaggregation split for HyperServe (paper §3.3):
    ``{"prefill": ..., "decode": ...}`` carved from the world's ranks,
    prefill first."""
    return groups_from_mapping({"prefill": n_prefill, "decode": n_decode})


# ---------------------------------------------------------------------------
# the wire: objects and tensor trees between two ranks of the world
# ---------------------------------------------------------------------------
def _wire_device() -> torch.device:
    """Where the bytes of a send live: the card under NCCL, else host."""
    import torch.distributed as dist
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _send_bytes(buf: torch.Tensor, dst: int) -> None:
    import torch.distributed as dist
    n = torch.tensor([buf.numel()], dtype=torch.int64, device=buf.device)
    dist.send(n, dst)
    if buf.numel():
        dist.send(buf, dst)


def _recv_bytes(src: int, device: torch.device, pin: bool = False):
    import torch.distributed as dist
    n = torch.zeros(1, dtype=torch.int64, device=device)
    dist.recv(n, src)
    buf = torch.empty(int(n.item()), dtype=torch.uint8, device=device,
                      pin_memory=pin)
    if buf.numel():
        dist.recv(buf, src)
    return buf


def send_obj(obj, dst: int) -> None:
    """Send a picklable object (a message header) to rank ``dst``."""
    data = np.frombuffer(pickle.dumps(obj), np.uint8)
    _send_bytes(torch.from_numpy(data.copy()).to(_wire_device()), dst)


def recv_obj(src: int):
    """Receive the object rank ``src`` sent with :func:`send_obj`."""
    return pickle.loads(_recv_bytes(src, _wire_device()).cpu().numpy()
                        .tobytes())


_ALIGN = 16                          # each leaf's bytes start aligned


def _nbytes(shape, dtype) -> int:
    return int(np.prod(shape, dtype=np.int64)) * torch.empty(
        (), dtype=dtype).element_size()


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    """A leaf's bytes, padded to a multiple of :data:`_ALIGN` so that the
    next leaf's view of the received buffer is aligned for its dtype."""
    b = t.detach().contiguous().reshape(-1).view(torch.uint8)
    pad = -b.numel() % _ALIGN
    return torch.cat([b, b.new_zeros(pad)]) if pad else b


def send_tree(tree, dst: int) -> None:
    """Send a tree of plain tensors to ``dst``: a header (the tree's
    skeleton, each leaf's shape and dtype) and ONE buffer of every leaf's
    bytes, exact.  Under gloo a buffer on the card is staged through pinned
    host memory first (gloo cannot send a CUDA tensor)."""
    leaves = tree_leaves(tree)
    idx = iter(range(len(leaves)))
    skeleton = tree_map(lambda _: next(idx), tree)
    send_obj((skeleton, [(tuple(t.shape), str(t.dtype).removeprefix("torch."))
                         for t in leaves]), dst)
    wire = _wire_device()
    buf = (torch.cat([_as_bytes(t) for t in leaves]) if leaves
           else torch.empty(0, dtype=torch.uint8, device=wire))
    if buf.device != wire:
        host = torch.empty(buf.numel(), dtype=torch.uint8,
                           pin_memory=buf.is_cuda)
        host.copy_(buf)
        buf = host
    _send_bytes(buf, dst)


def recv_tree(src: int, device):
    """Receive :func:`send_tree`'s tree from ``src``, its leaves on
    ``device`` (under gloo a card's leaves come from a pinned host buffer,
    copied asynchronously)."""
    skeleton, metas = recv_obj(src)
    device = torch.device(device)
    wire = _wire_device()
    buf = _recv_bytes(src, wire, pin=device.type == "cuda" and
                      wire.type == "cpu")
    buf = buf.to(device, non_blocking=True)
    leaves, off = [], 0
    for shape, dtype in metas:
        dt = getattr(torch, dtype)
        n = _nbytes(shape, dt)
        leaves.append(buf[off:off + n].view(dt).reshape(shape))
        off += n + (-n % _ALIGN)
    return tree_map(lambda i: leaves[i], skeleton)


def transfer(tree, src: ProcessGroup, dst: ProcessGroup, placements=None, *,
             device=None):
    """Hand a tree of tensors from ``src``'s ranks to ``dst``'s.

    Every rank of ``src`` and ``dst`` calls this in the same order; ``tree``
    is read on the ranks of ``src`` only (DTensors on ``src.mesh``, or
    plain tensors the same on each of its ranks).  Each leaf is gathered in
    full on ``src`` (a collective on its mesh), sent by ``src.leader`` to
    every rank of ``dst`` as one buffer (:func:`send_tree`), and kept on
    each rank of ``dst`` as ``placements(path, full)`` places it on
    ``dst.mesh`` (default: replicated) with no communication there, or as a
    plain tensor on ``device`` where ``dst`` has no mesh.  A rank in both
    groups copies its leaves locally.  Returns the tree on ``dst``'s ranks,
    None elsewhere."""
    from repro_torch.core.meshctx import full_tensor
    me = my_rank()
    full = None
    if src.has(me):
        full = tree_map(full_tensor, tree)
        if me == src.leader:
            for r in dst.ranks:
                if r != me:
                    send_tree(full, r)
    if not dst.has(me):
        return None
    got = (tree_map(lambda t: t.to(device).clone(), full)
           if me == src.leader else recv_tree(src.leader, device))
    if dst.mesh is None:
        return got
    from repro_torch.core.hypershard import distribute
    from repro_torch.core.tree import tree_map_with_path
    from torch.distributed.tensor import Replicate
    rep = [Replicate()] * dst.mesh.ndim
    return tree_map_with_path(
        lambda p, t: distribute(t, dst.mesh, placements(p, t)
                                if placements is not None else rep), got)


def _wire_buffer(t: torch.Tensor) -> torch.Tensor:
    """``t``'s bytes where the wire can send them: the tensor itself (a
    byte view) on the card under NCCL or on the host, else a pinned host
    copy, made before this returns."""
    b = t.detach().contiguous().reshape(-1).view(torch.uint8)
    wire = _wire_device()
    if b.device == wire:
        return b
    host = torch.empty(b.numel(), dtype=torch.uint8, pin_memory=b.is_cuda)
    host.copy_(b)
    return host


class Handoff:
    """Hand-offs of single tensors between two groups, for tensors whose
    shape and dtype the receiving ranks already know (a pipeline stage's
    activations and cotangents: the schedule fixes them), so no header
    goes before the bytes.

    :meth:`send` gathers the tensor in full on the source group (a
    collective on its mesh) and its first rank posts ``dist.isend`` of it
    to every rank of the destination group: it returns at once, and the
    handle and its buffer (under gloo a pinned host copy of a card's
    tensor) are kept until :meth:`wait`.  :meth:`recv` waits for the
    bytes and places them as the destination keeps them.  In steady 1F1B
    stage s sends the activation of a later micro-batch while stage s + 1
    sends the cotangent of an earlier one, and each then receives the
    other's.  A blocking send would make the two wait on each other for
    ever once a buffer outgrows what the transport takes before its
    receiver is there.  So would one process group for both directions
    under NCCL: a pair's sends and receives run in order on one stream
    there, each stage's send ahead of its receive.  Sends to a higher
    rank go over one group of the whole world and sends to a lower rank
    over another (each its own NCCL communicator and stream), so that the
    traffic of each direction between two ranks is one queue, received in
    the order it was sent.  Every rank of the world constructs a
    ``Handoff`` at the same point (the groups are made collectively) and
    keeps it for as many steps as it likes."""

    def __init__(self):
        import torch.distributed as dist
        self._up, self._down = dist.new_group(), dist.new_group()
        self._sends: List[Tuple[Any, torch.Tensor]] = []

    def _group(self, src: int, dst: int):
        return self._up if src < dst else self._down

    def send(self, t, src: ProcessGroup, dst: ProcessGroup) -> None:
        """Every rank of ``src`` calls this with its ``t`` (a DTensor on
        ``src.mesh`` or a plain tensor, the same on each of its ranks)."""
        import torch.distributed as dist
        from repro_torch.core.meshctx import full_tensor
        full = full_tensor(t)
        me = my_rank()
        if me != src.leader:
            return
        buf = _wire_buffer(full)
        for r in dst.ranks:
            if r == me:
                raise ValueError(f"Handoff.send: rank {me} is in both "
                                 f"{src.name} and {dst.name}")
            self._sends.append((dist.isend(buf, r, self._group(me, r)), buf))

    def recv(self, shape, dtype, src: ProcessGroup, dst: ProcessGroup,
             device, placements=None):
        """The tensor ``src`` sent, of ``shape`` and ``dtype``, on this rank
        of ``dst``: on ``device`` where ``dst`` has no mesh (under gloo a
        card's tensor comes from a pinned host buffer, copied
        asynchronously), else a DTensor on ``dst.mesh`` with
        ``placements`` (default: replicated), each rank keeping its chunk
        with no communication."""
        import torch.distributed as dist
        device = torch.device(device)
        wire = _wire_device()
        buf = torch.empty(_nbytes(tuple(shape), dtype), dtype=torch.uint8,
                          device=wire, pin_memory=device.type == "cuda"
                          and wire.type == "cpu")
        dist.recv(buf, src.leader, self._group(src.leader, my_rank()))
        t = buf.to(device, non_blocking=True).view(dtype).reshape(shape)
        if dst.mesh is None:
            return t
        from repro_torch.core.hypershard import distribute
        from torch.distributed.tensor import Replicate
        return distribute(t, dst.mesh, placements if placements is not None
                          else [Replicate()] * dst.mesh.ndim)

    def wait(self) -> None:
        """Wait for every send posted since the last call (the receivers
        have the bytes), then drop the handles and buffers."""
        for work, _ in self._sends:
            work.wait()
        self._sends.clear()


def send_to(group: ProcessGroup, obj) -> None:
    """``obj`` from this rank to every rank of ``group`` but itself."""
    for r in group.ranks:
        if r != my_rank():
            send_obj(obj, r)


def share(value, leader: int, ranks) -> Any:
    """``leader``'s ``value`` on every rank of ``ranks``: the leader sends
    it to the others and returns it, the others return what they receive
    (their own ``value`` is ignored), so that a call returns the same on
    every rank even where the ranks measured different times."""
    me = my_rank()
    if me == leader:
        for r in ranks:
            if r != me:
                send_obj(value, r)
        return value
    return recv_obj(leader)


def union_ranks(groups) -> List[int]:
    """Every rank of ``groups`` (a dict or a sequence of groups), sorted."""
    gs = groups.values() if isinstance(groups, dict) else groups
    return sorted({r for g in gs for r in g.ranks})


# ---------------------------------------------------------------------------
# the scheduler
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Task:
    group: str
    fn: Optional[Callable]
    args: tuple
    out: Any = None
    t_submit: float = 0.0
    t_done: float = 0.0
    local: bool = True               # run on this rank (else a peer's)


class MPMDScheduler:
    """Dispatch of whole programs onto role groups (Fig. 4c), one process
    per rank.

    ``submit(group, fn, *args)`` runs ``fn`` on the ranks of ``group`` and
    returns a placeholder :class:`Task` elsewhere; ``wait`` waits for the
    card (``device``) on the ranks that ran it, whose first rank then
    sends the task's window and the name of its function to every other
    rank of the groups, where ``wait`` receives them (:func:`share`).
    Every rank of the groups calls ``submit`` and ``wait`` for every task
    in the same order, so every rank counts every task alike:
    ``mpmd.tasks.{group}``, the idle gap of a group between its previous
    task's end and the next submit (``mpmd.bubble_s.{group}``, histogram
    ``mpmd.bubble_s``) and a span on track ``mpmd:{group}``, named as the
    reference names it, after the function."""

    def __init__(self, groups: Dict[str, ProcessGroup], obs=None,
                 device=None):
        from repro_torch.obs import Observability
        self.groups = groups
        self.obs = obs if obs is not None else Observability()
        self.device = torch.device(device) if device is not None else None
        self.log: List[Task] = []
        self._last_done: Dict[str, float] = {}

    def _bubble(self, group: str, t_submit: float) -> None:
        last = self._last_done.get(group)
        if last is not None and t_submit > last:
            # the group's devices sat idle between its previous task
            # draining and this dispatch: the role-level bubble
            gap = t_submit - last
            self.obs.metrics.counter(f"mpmd.bubble_s.{group}").inc(gap)
            self.obs.metrics.histogram("mpmd.bubble_s").observe(gap)

    def submit(self, group: str, fn: Optional[Callable], *args) -> Task:
        local = self.groups[group].has()
        t = Task(group, fn, args, t_submit=time.perf_counter(), local=local)
        if local:
            t.out = fn(*args)
        self.log.append(t)
        return t

    def wait(self, *tasks: Task):
        for t in tasks:
            g = self.groups[t.group]
            if t.local:
                if self.device is not None and self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                t.t_done = time.perf_counter()
            # the window the group's first rank measured and the name of
            # what it ran, on every rank
            name = getattr(t.fn, "__name__", None) or "task"
            t.t_submit, t.t_done, name = share(
                (t.t_submit, t.t_done, name), g.leader,
                union_ranks(self.groups))
            self._bubble(t.group, t.t_submit)
            self._last_done[t.group] = max(
                self._last_done.get(t.group, 0.0), t.t_done)
            self.obs.metrics.counter(f"mpmd.tasks.{t.group}").inc()
            self.obs.trace.complete(
                name, int(t.t_submit * 1e9), int(t.t_done * 1e9),
                track=f"mpmd:{t.group}", group=t.group)
        return [t.out for t in tasks]

    def utilization_report(self) -> Dict[str, float]:
        """Per-group busy seconds from the task log (every role's, on
        every rank)."""
        busy: Dict[str, float] = {}
        for t in self.log:
            if t.t_done:
                busy[t.group] = busy.get(t.group, 0.0) + (t.t_done
                                                          - t.t_submit)
        return busy


# ---------------------------------------------------------------------------
# Inter-sub-model concurrency (paper Fig. 4b): pipeline analytical model.
# With SPMD all submodules serialise; with MPMD groups sized proportionally
# to load, per-microbatch work overlaps.  Copied from the reference.
# ---------------------------------------------------------------------------
def spmd_step_time(module_times: Sequence[float]) -> float:
    """SPMD: every device runs every submodule in sequence."""
    return float(sum(module_times))


def mpmd_step_time(module_times: Sequence[float], n_micro: int) -> float:
    """MPMD pipeline over balanced groups: bubble only at fill/drain."""
    stage = max(module_times)
    return float(stage * (n_micro + len(module_times) - 1) / n_micro)


def pipeline_bubble_fraction(module_times: Sequence[float], n_micro: int) -> float:
    total = mpmd_step_time(module_times, n_micro) * n_micro
    useful = sum(module_times) * n_micro / len(module_times)
    return max(0.0, 1.0 - useful / total)


def pipeline_bubble_steps(n_stages: int, n_micro: int) -> int:
    """Closed-form idle-slot count of the synchronous 1F1B schedule.

    With uniform per-stage tick times the timeline spans
    ``2 * (n_micro + n_stages - 1)`` ticks, each stage does ``2 * n_micro``
    ticks of work, so the idle (stage, tick) slots are::

        n_stages * 2*(n_micro + n_stages - 1) - n_stages * 2*n_micro
          = 2 * n_stages * (n_stages - 1)

    Exactly consistent with :func:`pipeline_bubble_fraction`::

        bubble_steps / (n_stages * span) == (S - 1) / (M + S - 1)
          == pipeline_bubble_fraction([t] * S, M)     (any uniform t)
    """
    return 2 * n_stages * (n_stages - 1)
