"""Public error types of the port (the facade itself is not ported yet)."""
from repro_torch.api.errors import (FabricPlanError, HostMemoryError,
                                    IndivisibleError, PipelinePlanError,
                                    PlanError, ServePlanError, TopologyError,
                                    UnknownAxisError)

__all__ = ["PlanError", "UnknownAxisError", "IndivisibleError",
           "HostMemoryError", "ServePlanError", "FabricPlanError",
           "PipelinePlanError", "TopologyError"]
