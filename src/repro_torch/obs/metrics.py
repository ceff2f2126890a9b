"""HyperTrace typed metrics: counters, gauges, log2-bucket histograms.

One :class:`MetricsRegistry` per observability hub (per engine / session),
get-or-create by name, with two stable dump formats:

  - :meth:`MetricsRegistry.to_json` — a versioned JSON schema CI and the
    bench gate consume (``hypertrace.metrics/v1``);
  - :meth:`MetricsRegistry.dump_prometheus` — Prometheus text exposition
    for humans and scrapers.

:class:`Histogram` buckets are **fixed powers of two**: bucket ``k``
holds values in ``[2^(k-1), 2^k)`` over a configurable exponent range
(default 2^-20 .. 2^10 — one microsecond to ~17 minutes when observing
seconds).  Log2 bucketing keeps observation O(1) (one ``frexp``), makes
bucket math exactly testable (no float-boundary ambiguity: 2.0 lands in
the [2,4) bucket, nextafter(2,0) in [1,2)), and still yields useful
latency percentiles via within-bucket linear interpolation clamped to
the observed min/max.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional


class Counter:
    """Monotonic counter."""
    __slots__ = ("name", "value")
    kind = "counter"

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        assert n >= 0, f"counter {self.name} moved backwards ({n})"
        self.value += n

    def to_json(self):
        return self.value


class Gauge:
    """Point-in-time value."""
    __slots__ = ("name", "value")
    kind = "gauge"

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def to_json(self):
        return self.value


class Histogram:
    """Log2-bucket histogram: bucket k counts values in [2^(k-1), 2^k).

    ``lo_exp``/``hi_exp`` bound the resolved exponent range; values below
    ``2^lo_exp`` fall into the underflow bucket, values >= ``2^hi_exp``
    into the overflow bucket.  ``buckets`` has ``hi_exp - lo_exp + 2``
    entries: [underflow, one per exponent step, overflow].
    """
    kind = "histogram"

    def __init__(self, name: str, lo_exp: int = -20, hi_exp: int = 10):
        assert hi_exp > lo_exp, (lo_exp, hi_exp)
        self.name = name
        self.lo_exp = lo_exp
        self.hi_exp = hi_exp
        self.buckets: List[int] = [0] * (hi_exp - lo_exp + 2)
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def bucket_index(self, v: float) -> int:
        """0 = underflow (< 2^lo_exp), len-1 = overflow (>= 2^hi_exp)."""
        if v < 2.0 ** self.lo_exp:
            return 0
        if v >= 2.0 ** self.hi_exp:
            return len(self.buckets) - 1
        # frexp: v = m * 2^e with 0.5 <= m < 1, so v in [2^(e-1), 2^e)
        _, e = math.frexp(v)
        return e - self.lo_exp

    def bucket_bounds(self, idx: int):
        """(lo, hi) such that the bucket counts values in [lo, hi)."""
        if idx == 0:
            return 0.0, 2.0 ** self.lo_exp
        if idx == len(self.buckets) - 1:
            return 2.0 ** self.hi_exp, math.inf
        return 2.0 ** (self.lo_exp + idx - 1), 2.0 ** (self.lo_exp + idx)

    def observe(self, v: float) -> None:
        v = float(v)
        assert v >= 0 and not math.isnan(v), (self.name, v)
        self.buckets[self.bucket_index(v)] += 1
        self.count += 1
        self.sum += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)

    def percentile(self, q: float) -> float:
        """q-th percentile (0..100), interpolated within the bucket and
        clamped to the observed [min, max]; 0.0 when empty."""
        if self.count == 0:
            return 0.0
        rank = q / 100.0 * self.count
        seen = 0
        for idx, n in enumerate(self.buckets):
            if n == 0:
                continue
            if seen + n >= rank:
                lo, hi = self.bucket_bounds(idx)
                if math.isinf(hi):                     # overflow bucket
                    return float(self.max)
                frac = (rank - seen) / n
                v = lo + (hi - lo) * frac
                return min(max(v, self.min), self.max)
            seen += n
        return float(self.max)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def to_json(self):
        return {"count": self.count, "sum": self.sum,
                "min": self.min, "max": self.max,
                "lo_exp": self.lo_exp, "hi_exp": self.hi_exp,
                "buckets": list(self.buckets)}


SCHEMA = "hypertrace.metrics/v1"


class MetricsRegistry:
    """Get-or-create typed metrics by name; stable JSON + Prometheus dumps."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}

    def _get(self, name: str, factory):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = factory()
            return m

    def counter(self, name: str) -> Counter:
        m = self._get(name, lambda: Counter(name))
        assert isinstance(m, Counter), f"{name} is a {m.kind}, not a counter"
        return m

    def gauge(self, name: str) -> Gauge:
        m = self._get(name, lambda: Gauge(name))
        assert isinstance(m, Gauge), f"{name} is a {m.kind}, not a gauge"
        return m

    def histogram(self, name: str, lo_exp: int = -20,
                  hi_exp: int = 10) -> Histogram:
        m = self._get(name, lambda: Histogram(name, lo_exp, hi_exp))
        assert isinstance(m, Histogram), \
            f"{name} is a {m.kind}, not a histogram"
        return m

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def snapshot(self) -> Dict[str, float]:
        """Flat {name: value} for counters and gauges (rate deltas)."""
        with self._lock:
            return {n: m.value for n, m in self._metrics.items()
                    if isinstance(m, (Counter, Gauge))}

    def to_json(self) -> dict:
        """The stable machine-readable dump (sorted, versioned)."""
        out = {"schema": SCHEMA, "counters": {}, "gauges": {},
               "histograms": {}}
        with self._lock:
            items = sorted(self._metrics.items())
        for name, m in items:
            out[m.kind + "s"][name] = m.to_json()
        return out

    def dump_prometheus(self) -> str:
        """Prometheus text exposition (names sanitised to [a-zA-Z0-9_])."""
        def sane(n):
            return "".join(c if c.isalnum() or c == "_" else "_" for c in n)

        lines = []
        with self._lock:
            items = sorted(self._metrics.items())
        for name, m in items:
            pn = sane(name)
            lines.append(f"# TYPE {pn} {m.kind}")
            if isinstance(m, (Counter, Gauge)):
                lines.append(f"{pn} {m.value}")
                continue
            acc = 0
            for idx, n in enumerate(m.buckets):
                acc += n
                _, hi = m.bucket_bounds(idx)
                le = "+Inf" if math.isinf(hi) else repr(hi)
                lines.append(f'{pn}_bucket{{le="{le}"}} {acc}')
            lines.append(f"{pn}_sum {m.sum}")
            lines.append(f"{pn}_count {m.count}")
        return "\n".join(lines) + "\n"
