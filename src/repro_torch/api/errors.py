"""Typed plan-validation errors (the port's copy of ``repro.api.errors``).

Only the classes the ported slice raises are here; the others arrive with
the facade (``HyperPlan``/``Supernode``).

Hierarchy::

    PlanError (ValueError)
      +-- ServePlanError          plan is invalid for the serving runtime
"""
from __future__ import annotations


class PlanError(ValueError):
    """A plan cannot be resolved against the session topology."""


class ServePlanError(PlanError):
    """The plan cannot drive the serving runtime."""
