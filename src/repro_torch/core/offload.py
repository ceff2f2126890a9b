"""HyperOffload (paper §3.2): compute/state decoupling through host memory.

The port of ``repro.core.offload``.  The supernode's pooled
DRAM is the host's pinned (page-locked) memory; the card's memory is the
managed cache.  What is here:

- :class:`OffloadConfig`, a copy of the reference's;
- :func:`spec_fully_sharded`, the reference's selectivity rule (only a
  leaf of rank >= 2 whose spec uses every mesh axis of size > 1 is
  host-placed).  On a mesh it is judged on a DTensor leaf's own spec and
  its mesh's axis sizes, and the leaf's local shard goes to host memory
  (:class:`HostShard`); with no mesh the port's one card stands for a
  one-device mesh, where every spec is fully sharded, so a leaf of rank
  >= 2 goes to host memory and a 1-D leaf stays on the card
  (:func:`host_placeable`);
- :func:`unstack_layers` / :func:`streamed_apply`, the per-layer cache
  pipeline: layer ``i``'s pinned host params are copied to the card with
  asynchronous copies on the current stream just before layer ``i`` runs,
  so the card holds one layer's params at a time;
- :func:`train_hbm_bytes` / :func:`serve_hbm_bytes`, the reference's
  first-order device-memory accounting, its arithmetic copied.

The train step's fetch and offload legs between steps are
``repro_torch.train.steps.fetch_state`` / ``offload_state``.  The
reference's activation-offload remat policy is used by none of its steps
and waits with the multi-device item in ROADMAP.md.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.core.kvcache import to_device
from repro_torch.core.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OffloadConfig:
    params_on_host: bool = False
    opt_state_on_host: bool = False
    activations_to_host: bool = False
    stream_layers: bool = False           # per-layer pipeline
    prefetch_depth: int = 2               # layers resident at once
    # HyperMem residency policy: "manual" keeps the flags above as the
    # source of truth; "graph" derives per-leaf tiers + a layer-keyed
    # prefetch schedule from the graph walk (repro_torch.mem.plan_residency)
    # under the per-tier byte budgets below (0 = unbounded)
    policy: str = "manual"
    hbm_budget_bytes: int = 0
    host_budget_bytes: int = 0
    disk_budget_bytes: int = 0


def spec_fully_sharded(spec, axis_sizes: dict) -> bool:
    """True if the spec uses every axis of size > 1 (and rank >= 2).

    The reference host-places only fully-sharded leaves (XLA SPMD rejects
    host annotations on replicated tensors), which are exactly the large
    ones worth offloading; norms and biases stay on the device.
    ``axis_sizes`` maps axis name -> size.
    """
    if len(spec) < 2:
        return False          # 1-D leaves stay on the device
    used = set()
    for e in spec:
        if e is None:
            continue
        for a in (e,) if isinstance(e, str) else e:
            used.add(a)
    need = {a for a, n in axis_sizes.items() if n > 1}
    return need <= used


def host_placeable(t) -> bool:
    """Whether the offload legs host-place ``t``: a :class:`HostShard`
    (already there); a DTensor whose spec is fully sharded over its mesh
    (``spec_fully_sharded`` of its placements' spec and the mesh's axis
    sizes, the reference's predicate on the leaf's real sharding); or, for
    a plain tensor, the one-device mesh's selectivity, ``spec_fully_sharded``
    of any spec of ``t``'s rank over ``{"data": 1, "model": 1}``."""
    if isinstance(t, HostShard):
        return True
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        from repro_torch.core.layout import spec_of
        mesh = t.device_mesh
        names = tuple(mesh.mesh_dim_names)
        return spec_fully_sharded(spec_of(t.placements, names, t.dim()),
                                  dict(zip(names, mesh.shape)))
    return spec_fully_sharded((None,) * t.dim(), {"data": 1, "model": 1})


class HostShard:
    """A DTensor leaf between steps: its local shard in pinned host memory
    (copied asynchronously on the current stream) and what rebuilds the
    DTensor on its mesh (:meth:`to_mesh`)."""

    def __init__(self, t):
        self.local = to_host_async(t.to_local())
        self.mesh, self.placements = t.device_mesh, t.placements
        self.shape, self.stride = t.shape, t.stride()

    def to_mesh(self, device):
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(to_device(self.local, device), self.mesh,
                                  self.placements, run_check=False,
                                  shape=self.shape, stride=self.stride)


def to_host_async(t):
    """``t`` copied into pinned host memory by an asynchronous copy on the
    current stream (a CPU tensor is returned as it is; a DTensor becomes a
    :class:`HostShard` of its local shard).  The copy is final once the
    stream reaches it: a later copy back to the card on the same stream is
    ordered after it, but a host read must synchronise first."""
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        return HostShard(t)
    if t.device.type == "cpu":
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host


def to_device_leaf(t, device):
    """The fetch leg of one leaf: a :class:`HostShard` back on its mesh,
    a host tensor on ``device``."""
    if isinstance(t, HostShard):
        return t.to_mesh(device)
    return to_device(t, device)


def local_nbytes(t) -> int:
    """Bytes of ``t`` on this rank: a DTensor's (or a
    :class:`HostShard`'s) local shard, a plain tensor whole."""
    from torch.distributed.tensor import DTensor
    if isinstance(t, HostShard):
        t = t.local
    elif isinstance(t, DTensor):
        t = t.to_local()
    return t.numel() * t.element_size()


def unstack_layers(stacked):
    """Split a stacked (L, ...) parameter tree into a list of L trees."""
    L = tree_leaves(stacked)[0].shape[0]
    return [tree_map(lambda a: a[i], stacked) for i in range(L)]


def streamed_apply(layer_fn: Callable, x, host_layer_params: list, device,
                   *extra):
    """The cache pipeline: fetch layer ``i``'s params to ``device``, apply.

    ``host_layer_params`` is a list of per-layer trees in pinned host
    memory.  Each fetch is an asynchronous copy on the current stream,
    queued ahead of layer ``i``'s kernels, so the host runs ahead and
    issues layer ``i + 1``'s copy while the card computes layer ``i``;
    a layer's device copy is freed once the next layer replaces it.
    """
    for lp in host_layer_params:
        lp_dev = tree_map(lambda a: to_device(a, device), lp)
        x = layer_fn(x, lp_dev, *extra)
    return x


# ---------------------------------------------------------------------------
# analytic device-memory model (the reference's arithmetic)
# ---------------------------------------------------------------------------
def train_hbm_bytes(cfg, batch_per_chip: int, seq: int, *,
                    offload: OffloadConfig, tp: int = 1) -> dict:
    """First-order device-memory accounting for one training step."""
    p = cfg.param_count()
    bytes_bf16, bytes_f32 = 2, 4
    params = p * bytes_bf16 / tp
    grads = p * bytes_bf16 / tp
    opt = 2 * p * bytes_f32 / tp
    master = p * bytes_f32 / tp
    resid = cfg.num_layers * batch_per_chip * seq * cfg.d_model * bytes_bf16
    out = {
        "params": 0.0 if offload.params_on_host and offload.stream_layers
        else params,
        "streamed_window": (offload.prefetch_depth / max(cfg.num_layers, 1))
        * params if offload.params_on_host and offload.stream_layers else 0.0,
        "grads": grads,
        "opt_state": 0.0 if offload.opt_state_on_host else opt + master,
        "activations": 0.0 if offload.activations_to_host else resid,
    }
    out["total"] = sum(out.values())
    return out


def serve_hbm_bytes(cfg, batch: int, seq: int, *,
                    kv_on_host_frac: float = 0.0, tp: int = 1,
                    window: Optional[int] = None) -> dict:
    """First-order device-memory accounting for decode with optional KV
    offload."""
    p = cfg.active_param_count()
    params = p * 2 / tp
    if cfg.mla is not None:
        per_tok = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim
    elif cfg.family == "ssm":
        per_tok = 0
    else:
        per_tok = 2 * cfg.num_kv_heads * cfg.resolved_head_dim
    eff = min(seq, window) if window else seq
    n_kv_layers = sum(1 for m, _ in cfg.block_kinds()
                      if m in ("attn", "local", "mla"))
    kv = n_kv_layers * batch * eff * per_tok * 2 / tp
    return {"params": params, "kv_device": kv * (1 - kv_on_host_frac),
            "kv_host": kv * kv_on_host_frac,
            "total": params + kv * (1 - kv_on_host_frac)}
