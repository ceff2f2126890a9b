"""repro_torch.obs — HyperTrace: unified tracing + metrics (PyTorch port).

A copy of the reference's ``repro.obs`` so that counter, span and
compile-ledger names match it 1:1.  One :class:`Observability` hub
bundles the span tracer (:mod:`repro_torch.obs.trace`) and the typed
metrics registry (:mod:`repro_torch.obs.metrics`), plus the **compile
ledger**: every step callable in the serving stack reports the
``(callable, shape key)`` it is about to run under, and a key seen for the
first time counts as one event.  The port runs eagerly, so nothing is
compiled; the ledger keeps the reference's keys so the two stacks can be
compared key for key.

Engines constructed directly default to a private hub so per-engine
counters stay clean; ``default_obs()`` is the process-global fallback for
scripts and launchers.  Zero third-party dependencies.

    obs = serve.obs()
    obs.trace.enable()
    ... serve ...
    obs.trace.export("out.json")          # open at ui.perfetto.dev
    print(obs.metrics.dump_prometheus())
"""
from __future__ import annotations

import threading
from typing import Dict, Optional, Set, Tuple

from repro_torch.obs.metrics import (SCHEMA, Counter, Gauge, Histogram,
                               MetricsRegistry)
from repro_torch.obs.trace import NOOP_SPAN, Tracer, validate_perfetto


class Observability:
    """A tracer + metrics registry + jit compile ledger, one scope."""

    def __init__(self, *, trace_capacity: int = 65536):
        self.trace = Tracer(capacity=trace_capacity)
        self.metrics = MetricsRegistry()
        self._lock = threading.Lock()
        self._compiled: Dict[str, Set[Tuple]] = {}

    # -- jit compile ledger ------------------------------------------------
    def record_compile(self, callable_name: str, key: Tuple) -> bool:
        """Note that ``callable_name`` is about to run under shape ``key``.

        First sighting of a key counts as one compilation: bumps the
        global ``jit.recompiles`` counter, the per-callable counter, and
        drops a trace instant.  Returns True iff the key was new.
        """
        key = tuple(key)
        with self._lock:
            seen = self._compiled.setdefault(callable_name, set())
            if key in seen:
                return False
            seen.add(key)
        self.metrics.counter("jit.recompiles").inc()
        self.metrics.counter(f"jit.recompiles.{callable_name}").inc()
        self.trace.instant("jit.compile", track="jit",
                           fn=callable_name, key=str(key))
        return True

    def compiled_keys(self, callable_name: Optional[str] = None):
        """The ledger: {callable: sorted keys} or one callable's keys."""
        with self._lock:
            if callable_name is not None:
                return sorted(self._compiled.get(callable_name, ()))
            return {n: sorted(ks) for n, ks in sorted(self._compiled.items())}

    def recompiles(self) -> int:
        return int(self.metrics.counter("jit.recompiles").value)


_DEFAULT = Observability()


def default_obs() -> Observability:
    """The process-global hub (launchers, scripts, bare engines)."""
    return _DEFAULT


__all__ = [
    "Observability", "default_obs",
    "Tracer", "validate_perfetto", "NOOP_SPAN",
    "MetricsRegistry", "Counter", "Gauge", "Histogram", "SCHEMA",
]
