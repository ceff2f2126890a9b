"""Typed plan-validation errors (the port's copy of ``repro.api.errors``).

Every failure mode that would surface as a shape error deep inside a step
(or as a silently replicated tensor) gets a named exception, so callers
can catch the category, and the message carries the fix.

Hierarchy::

    PlanError (ValueError)
      +-- UnknownAxisError        plan names a mesh axis that cannot bind
      +-- IndivisibleError        a dim would silently replicate (strict mode)
      +-- HostMemoryError         host offload on a backend without a host tier
      +-- ServePlanError          plan is invalid for the serving runtime
      +-- FabricPlanError         multi-tenant fabric leg cannot be realised
      +-- PipelinePlanError       pipeline-parallel leg cannot be realised
      +-- TopologyError           session topology cannot be realised
"""
from __future__ import annotations


class PlanError(ValueError):
    """A plan cannot be resolved against the session topology."""


class UnknownAxisError(PlanError):
    """The plan references mesh axes that exist on no axis of the topology."""


class IndivisibleError(PlanError):
    """A sharded dim does not divide its mesh axes (strict validation)."""


class HostMemoryError(PlanError):
    """Host offload requested but the backend exposes no host memory."""


class ServePlanError(PlanError):
    """The plan cannot drive the serving runtime."""


class FabricPlanError(PlanError):
    """The multi-tenant fabric leg is malformed (replicas/split/tenants)."""


class PipelinePlanError(PlanError):
    """The pipeline-parallel leg is malformed (stage counts / layer split /
    micro-batching)."""


class TopologyError(PlanError):
    """The requested device matrix cannot be built from available devices."""
