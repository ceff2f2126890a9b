"""Weight bridge: the reference's param pytree (as numpy) -> the port's,
and its AdamW state likewise.

The two packages share the stacked layout and the leaf names, so the
bridge maps leaf to leaf.  Call it with the JAX tree after
``jax.tree.map(np.asarray, params)``; this module imports no JAX.
bfloat16 leaves (numpy's ``ml_dtypes`` bfloat16, which torch cannot
wrap) pass through float32, which holds every bfloat16 value exactly —
the same route the reference's checkpoints take.  :func:`shard_params`
distributes bridged params over a mesh as the sharded train step places
them, and :func:`full_params` gathers them back.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _leaf(a, device, dtype: Optional[torch.dtype]) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))     # a writable copy
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


# leaves the reference keeps in float32 whatever the model's dtype (the MoE
# router runs in f32; Mamba-2's decay, skip and step-size bias; the RG-LRU's
# decay parameter)
F32_LEAVES = ("router", "A_log", "D", "dt_bias", "lambda")


def params_from_numpy(tree, device, dtype: Optional[torch.dtype] = None):
    """Port params from a numpy pytree of the reference's params.

    ``dtype`` casts floating leaves (None keeps each leaf's own type),
    except those named in :data:`F32_LEAVES`, which stay float32 as in the
    reference.
    """
    def convert(node, key=None):
        if isinstance(node, dict):
            return {k: convert(v, k) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return type(node)(convert(v, key) for v in node)
        return _leaf(node, device, None if key in F32_LEAVES else dtype)
    return convert(tree)


def adamw_state_from_numpy(state, device):
    """Port ``AdamWState`` from the reference's, as numpy (after
    ``jax.tree.map(np.asarray, state)``): any object with ``mu``, ``nu``
    and ``count`` fields.  The moments stay f32, ``count`` an int32
    scalar, as in both packages."""
    from repro_torch.optim.adamw import AdamWState
    return AdamWState(mu=params_from_numpy(state.mu, device),
                      nu=params_from_numpy(state.nu, device),
                      count=torch.tensor(int(np.asarray(state.count)),
                                         dtype=torch.int32, device=device))


def shard_params(params, mesh, plan=None):
    """Port params (e.g. from :func:`params_from_numpy`, the full tensors,
    the same on every rank) distributed over ``mesh`` as the sharded
    ``init_state`` places them: each leaf by
    :func:`~repro_torch.core.hypershard.derive_param` under ``plan``
    (default: the fsdp_tp ``ShardingPlan``)."""
    from repro_torch.core import hypershard as hs
    plan = plan or hs.ShardingPlan()
    return hs.shard_tree(params, hs.make_param_shardings(mesh, params, plan))


def full_params(params):
    """The full tensors of sharded params (a collective per DTensor leaf,
    so every rank calls it); plain leaves pass as they are."""
    from repro_torch.core.tree import tree_map
    from repro_torch.core.meshctx import full_tensor
    return tree_map(full_tensor, params)
