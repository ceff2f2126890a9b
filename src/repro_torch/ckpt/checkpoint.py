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
"""
from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from repro_torch.core.tree import tree_flatten_with_path, tree_map_with_path


def _to_np(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
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
    np.savez(os.path.join(path, f"step_{step}.npz"), **arrays)
    meta = {"step": step, **(extra or {})}
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)


def latest_step(path: str) -> Optional[int]:
    if not os.path.isdir(path):
        return None
    steps = [int(f[5:-4]) for f in os.listdir(path)
             if f.startswith("step_") and f.endswith(".npz")]
    return max(steps) if steps else None


def restore(path: str, step: int, params_like, opt_like=None):
    """Restore into the structure of ``params_like`` (and ``opt_like``),
    each leaf on its template's device in its dtype (shapes validated)."""
    data = np.load(os.path.join(path, f"step_{step}.npz"))

    def rebuild(like, prefix):
        def one(key, v):
            arr = data[f"{prefix}/{key}"]
            if tuple(arr.shape) != tuple(v.shape):
                raise ValueError(f"shape mismatch for {key}: ckpt "
                                 f"{arr.shape} vs model {tuple(v.shape)}")
            return torch.from_numpy(np.array(arr)).to(device=v.device,
                                                      dtype=v.dtype)
        return tree_map_with_path(one, like)

    params = rebuild(params_like, "params")
    if opt_like is not None:
        return params, rebuild(opt_like, "opt")
    return params
