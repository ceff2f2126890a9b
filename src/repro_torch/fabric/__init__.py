"""repro_torch.fabric — HyperFabric: the multi-tenant serving tier.

The port of ``repro.fabric``.  A :class:`Router` fronts N HyperServe
replicas carved from one Supernode: per-tenant SLO classes with
weighted-fair dispatch, typed admission control + backpressure, CoW
prefix-affinity routing, and elastic replica drain/activate.  Built
through the facade::

    session = Supernode.auto()
    fab = session.fabric(cfg, params, plan=plans.fabric(replicas=2))
    fid = fab.submit(prompt, 32, tenant="chat")
    fab.join()

See :mod:`repro_torch.fabric.router` for the full contract (replicas in
processes included) and :mod:`repro_torch.fabric.carve` for the
replica->rank-group arithmetic.
"""
from repro_torch.configs.base import FabricConfig, TenantSpec
from repro_torch.fabric.carve import carve_counts, describe_carve
from repro_torch.fabric.router import SLO_POLICY, FabricRequest, Router

__all__ = [
    "Router", "FabricRequest", "FabricConfig", "TenantSpec",
    "carve_counts", "describe_carve", "SLO_POLICY",
]
