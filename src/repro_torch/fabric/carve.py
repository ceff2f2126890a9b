"""Replica -> rank-group carve arithmetic (pure, no torch).

The port of ``repro.fabric.carve``.  The fabric turns ONE Supernode's
ranks (a device each) into N disjoint replica groups.  This module owns
only the arithmetic — ``carve_counts`` decides how many devices each
replica gets, and ``describe_carve`` renders the decision for
``explain()`` — so plan validation and report generation never touch a
device.

Three regimes:

  - explicit ``split``: heterogeneous capacity (the H2 story — a big
    replica soaks batch traffic while small replicas keep interactive
    TTFT low).  Must fit the device budget exactly or under it.
  - even split: ``n_devices // replicas`` each, remainder spread over
    the lowest-index replicas (deterministic).
  - colocated: fewer devices than replicas (one card, or the
    one-process CPU tests).  Every replica gets count 0 = "share the
    session's default placement": all of them in this process, on its
    device; the router still exercises routing/SLO/affinity logic.
"""
from __future__ import annotations

from typing import List, Tuple

from repro_torch.configs.base import FabricConfig


def carve_counts(n_devices: int, fcfg: FabricConfig) -> List[int]:
    """Devices per replica.  A count of 0 means "colocated" (no submesh).

    Raises :class:`~repro_torch.api.errors.FabricPlanError` when an explicit
    split over-claims the device budget.
    """
    from repro_torch.api.errors import FabricPlanError
    if fcfg.split:
        if sum(fcfg.split) > n_devices:
            raise FabricPlanError(
                f"fabric.split={fcfg.split} claims {sum(fcfg.split)} devices "
                f"but the session has only {n_devices}; shrink the split or "
                "the replica count")
        return list(fcfg.split)
    base, rem = divmod(n_devices, fcfg.replicas)
    if base < 1:
        # fewer devices than replicas: colocate everything (tests, CPU)
        return [0] * fcfg.replicas
    return [base + (1 if i < rem else 0) for i in range(fcfg.replicas)]


def describe_carve(counts: List[int]) -> List[Tuple[str, str]]:
    """(replica label, device-range string) rows for explain()."""
    rows = []
    off = 0
    for i, c in enumerate(counts):
        if c == 0:
            rows.append((f"replica[{i}]", "colocated (shared default mesh)"))
        else:
            rows.append((f"replica[{i}]", f"devices[{off}:{off + c}]"))
            off += c
    return rows
