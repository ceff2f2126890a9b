"""HyperTrace span/event tracer (zero-dependency, Perfetto-exportable).

The framework-wide timeline substrate: every hot layer (serve scheduler
and engine loop, RL iteration phases, MPMD role dispatch, train steps)
emits **spans** (``with tracer.span("prefill", rid=3): ...``) and
**instants** (``tracer.instant("preempt", rid=3)``) into one thread-safe
ring buffer.  Export is Chrome/Perfetto ``trace_event`` JSON — load the
file at https://ui.perfetto.dev and the serve lifecycle, decode cadence,
publish boundaries and role-group bubbles render as tracks.

Disabled-by-default with near-zero cost: ``span()`` on a disabled tracer
returns one shared no-op context manager (no allocation, one attribute
read + branch), so instrumentation can live permanently on the hot paths
— the engine loop pays for tracing only while a trace is being captured.

Timestamps are ``time.perf_counter_ns`` relative to the tracer's epoch,
exported in microseconds (the trace_event unit).  Named **tracks**
(``track="actor"``) map to synthetic tids with thread_name metadata so
logical roles get their own swimlane; unnamed events use the emitting
thread's id — concurrent spans from different threads never interleave
into one nesting stack.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Dict, List, Optional


class _NoopSpan:
    """Shared do-nothing context manager (the disabled-tracer fast path)."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP_SPAN = _NoopSpan()


class _Span:
    __slots__ = ("_tracer", "name", "track", "args", "t0")

    def __init__(self, tracer: "Tracer", name: str, track, args):
        self._tracer = tracer
        self.name = name
        self.track = track
        self.args = args

    def __enter__(self):
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self._tracer.complete(self.name, self.t0, time.perf_counter_ns(),
                              track=self.track, **(self.args or {}))
        return False


class Tracer:
    """Thread-safe ring-buffer event tracer with Perfetto export."""

    def __init__(self, capacity: int = 65536, pid: int = 1):
        self.pid = pid
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._enabled = False
        self._epoch = time.perf_counter_ns()
        self._buf: List[dict] = []
        self._head = 0                       # ring insertion point
        self.emitted = 0                     # total events ever emitted
        self._tracks: Dict[str, int] = {}    # named track -> synthetic tid

    # -- lifecycle ---------------------------------------------------------
    @property
    def enabled(self) -> bool:
        return self._enabled

    def enable(self, capacity: Optional[int] = None) -> "Tracer":
        with self._lock:
            if capacity is not None:
                self.capacity = int(capacity)
                self._buf = []
                self._head = 0
            self._enabled = True
        return self

    def disable(self) -> "Tracer":
        self._enabled = False
        return self

    def clear(self) -> None:
        with self._lock:
            self._buf = []
            self._head = 0
            self.emitted = 0

    @property
    def dropped(self) -> int:
        """Events evicted by the ring (emitted beyond capacity)."""
        return max(0, self.emitted - self.capacity)

    # -- emission ----------------------------------------------------------
    def _tid(self, track) -> int:
        if track is None:
            return threading.get_ident() & 0x7FFFFFFF
        tid = self._tracks.get(track)
        if tid is None:
            # small stable ids so Perfetto sorts named tracks together
            tid = len(self._tracks) + 1
            self._tracks[track] = tid
        return tid

    def _push(self, ev: dict) -> None:
        with self._lock:
            if len(self._buf) < self.capacity:
                self._buf.append(ev)
            else:
                self._buf[self._head] = ev
                self._head = (self._head + 1) % self.capacity
            self.emitted += 1

    def span(self, name: str, *, track: Optional[str] = None, **args):
        """Context manager timing a region; no-op while disabled."""
        if not self._enabled:
            return NOOP_SPAN
        return _Span(self, name, track, args)

    def complete(self, name: str, t0_ns: int, t1_ns: int, *,
                 track: Optional[str] = None, **args) -> None:
        """A finished span with explicit timestamps (async dispatch windows)."""
        if not self._enabled:
            return
        ev = {"name": name, "ph": "X", "pid": self.pid,
              "tid": self._tid(track),
              "ts": (t0_ns - self._epoch) / 1e3,
              "dur": max(t1_ns - t0_ns, 0) / 1e3}
        if args:
            ev["args"] = args
        self._push(ev)

    def instant(self, name: str, *, track: Optional[str] = None,
                **args) -> None:
        if not self._enabled:
            return
        ev = {"name": name, "ph": "i", "s": "t", "pid": self.pid,
              "tid": self._tid(track),
              "ts": (time.perf_counter_ns() - self._epoch) / 1e3}
        if args:
            ev["args"] = args
        self._push(ev)

    def counter(self, name: str, value, *, track: Optional[str] = None) -> None:
        """A counter track sample (renders as a little graph in Perfetto)."""
        if not self._enabled:
            return
        self._push({"name": name, "ph": "C", "pid": self.pid,
                    "tid": self._tid(track),
                    "ts": (time.perf_counter_ns() - self._epoch) / 1e3,
                    "args": {"value": float(value)}})

    # -- inspection / export -----------------------------------------------
    def events(self) -> List[dict]:
        """Buffered events in emission order (oldest surviving first)."""
        with self._lock:
            if len(self._buf) < self.capacity:
                return list(self._buf)
            return self._buf[self._head:] + self._buf[:self._head]

    def to_perfetto(self) -> dict:
        """Chrome/Perfetto ``trace_event`` JSON object payload."""
        meta = [{"name": "thread_name", "ph": "M", "pid": self.pid,
                 "tid": tid, "args": {"name": track}}
                for track, tid in sorted(self._tracks.items(),
                                         key=lambda kv: kv[1])]
        return {"traceEvents": meta + self.events(),
                "displayTimeUnit": "ms",
                "otherData": {"producer": "repro_torch.obs (HyperTrace)",
                              "dropped_events": self.dropped}}

    def export(self, path: str) -> str:
        payload = self.to_perfetto()
        problems = validate_perfetto(payload)
        assert not problems, problems          # exporter must emit valid JSON
        with open(path, "w") as f:
            json.dump(payload, f)
        return path


_PHASES = {"X", "i", "I", "C", "M", "B", "E"}


def validate_perfetto(payload: dict) -> List[str]:
    """Schema check for a trace_event JSON object; [] means loadable.

    Verifies the invariants the Perfetto importer relies on: an event
    array under ``traceEvents``, every event carrying name/ph/pid/tid,
    timestamps and durations as non-negative numbers, complete events
    (``X``) carrying ``dur``, and metadata events (``M``) carrying args.
    """
    problems: List[str] = []
    evs = payload.get("traceEvents")
    if not isinstance(evs, list):
        return ["traceEvents missing or not a list"]
    for i, ev in enumerate(evs):
        where = f"event[{i}]"
        if not isinstance(ev, dict):
            problems.append(f"{where}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in _PHASES:
            problems.append(f"{where}: bad ph {ph!r}")
        for k in ("name", "pid", "tid"):
            if k not in ev:
                problems.append(f"{where} ({ev.get('name')!r}): missing {k}")
        if ph != "M":
            ts = ev.get("ts")
            if not isinstance(ts, (int, float)) or ts < 0:
                problems.append(f"{where} ({ev.get('name')!r}): bad ts {ts!r}")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"{where} ({ev.get('name')!r}): "
                                f"bad dur {dur!r}")
        if ph == "M" and "args" not in ev:
            problems.append(f"{where}: metadata without args")
    return problems
