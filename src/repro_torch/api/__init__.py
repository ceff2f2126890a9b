"""Public error types of the port (the facade itself is not ported yet)."""
from repro_torch.api.errors import PlanError, ServePlanError

__all__ = ["PlanError", "ServePlanError"]
