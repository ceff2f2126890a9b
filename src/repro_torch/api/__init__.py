"""repro_torch.api — the public session layer (one declarative front door).

The port of ``repro.api``::

    from repro_torch.api import Supernode, HyperPlan, plans

    session = Supernode.auto()                # the card; device="cpu" too
    params, hist = session.train(cfg, shape, plan=plans.fsdp_tp())
    serve = session.serve(cfg, params, plan=plans.serve())
    fab = session.fabric(cfg, params, plan=plans.fabric(replicas=2))
    print(session.explain(plans.offload_all(), cfg))

Everything else in the package (hypershard, offload, mpmd, serve, train,
rl, fabric) is an engine this layer resolves plans into.
"""
from repro_torch.api.errors import (FabricPlanError, HostMemoryError,
                                    IndivisibleError, PipelinePlanError,
                                    PlanError, ServePlanError, TopologyError,
                                    UnknownAxisError)
from repro_torch.api.explain import LeafReport, PlanReport, explain
from repro_torch.api.plan import HyperPlan
from repro_torch.api.session import Resolution, Supernode
from repro_torch.api import plans

__all__ = [
    "HyperPlan", "Supernode", "Resolution", "plans", "explain",
    "PlanReport", "LeafReport",
    "PlanError", "UnknownAxisError", "IndivisibleError", "HostMemoryError",
    "ServePlanError", "FabricPlanError", "PipelinePlanError", "TopologyError",
]
