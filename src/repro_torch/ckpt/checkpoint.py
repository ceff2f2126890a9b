"""Checkpoints: params + optimizer state + step, npz-backed, in the
reference's format (``repro.ckpt.checkpoint``).

Arrays are stored by tree path under the reference's key strings:
``params/<path>`` and ``opt/<path>``, the path as JAX's flatten spells it
(dict keys sorted and joined by ``/``, tuple items by index, the
``AdamWState`` fields as ``.mu``, ``.nu`` and ``.count``), so a checkpoint
written by either package restores in the other.  npz cannot hold
bfloat16, so bf16 leaves are stored as f32 (lossless) and cast back to the
leaf's dtype on restore; a shape that differs from the model's raises
``ValueError``.

On a mesh, :func:`save` gathers each DTensor leaf in full on every rank
(a collective each, so every rank calls it) and rank 0 writes; a leaf the
offload leg left in host memory is gathered the same way.  :func:`restore`
distributes each leaf against the given ``shardings`` (a tree of
:class:`~repro_torch.core.hypershard.NamedSharding`, as the reference
takes a tree of ``NamedSharding``), so a checkpoint moves between meshes
and to and from the unsharded trainer.
"""
from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from repro_torch.core.tree import tree_flatten_with_path, tree_map_with_path


def _to_np(t) -> np.ndarray:
    from repro_torch.core.offload import HostShard
    from repro_torch.core.meshctx import full_tensor
    if isinstance(t, HostShard):
        t = t.to_mesh(t.mesh.device_type)
    t = full_tensor(t).detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def _flatten(tree):
    return dict(tree_flatten_with_path(tree))


def save(path: str, step: int, params, opt_state=None,
         extra: Optional[dict] = None):
    os.makedirs(path, exist_ok=True)
    arrays = {f"params/{k}": _to_np(v) for k, v in _flatten(params).items()}
    if opt_state is not None:
        arrays.update({f"opt/{k}": _to_np(v)
                       for k, v in _flatten(opt_state).items()})
    if _rank() != 0:
        return
    np.savez(os.path.join(path, f"step_{step}.npz"), **arrays)
    meta = {"step": step, **(extra or {})}
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def latest_step(path: str) -> Optional[int]:
    if not os.path.isdir(path):
        return None
    steps = [int(f[5:-4]) for f in os.listdir(path)
             if f.startswith("step_") and f.endswith(".npz")]
    return max(steps) if steps else None


def restore(path: str, step: int, params_like, opt_like=None, *,
            shardings=None, opt_shardings=None):
    """Restore into the structure of ``params_like`` (and ``opt_like``),
    each leaf on its template's device in its dtype (shapes validated);
    with ``shardings`` (``opt_shardings``) each leaf distributed by its
    :class:`~repro_torch.core.hypershard.NamedSharding`; a scalar (the
    AdamW count) stays a plain tensor, which the step's mesh context
    treats as replicated.  Every rank reads the file."""
    from repro_torch.core.hypershard import distribute
    data = np.load(os.path.join(path, f"step_{step}.npz"))

    def rebuild(like, prefix, shard_tree):
        flat_sh = _flatten(shard_tree) if shard_tree is not None else {}

        def one(key, v):
            arr = data[f"{prefix}/{key}"]
            if tuple(arr.shape) != tuple(v.shape):
                raise ValueError(f"shape mismatch for {key}: ckpt "
                                 f"{arr.shape} vs model {tuple(v.shape)}")
            t = torch.from_numpy(np.array(arr)).to(device=_device(v),
                                                   dtype=v.dtype)
            sh = flat_sh.get(key)
            if sh is None or t.dim() == 0:
                return t
            return distribute(t, sh.mesh, sh.placements)
        return tree_map_with_path(one, like)

    params = rebuild(params_like, "params", shardings)
    if opt_like is not None:
        return params, rebuild(opt_like, "opt", opt_shardings)
    return params


def _device(v):
    """The device a restored leaf lands on: its template's (a host-placed
    shard's mesh device)."""
    from repro_torch.core.offload import HostShard
    return v.mesh.device_type if isinstance(v, HostShard) else v.device
