"""In-process metrics: counters, gauges, timers, histograms.

Counterpart of ``sitewhere_tpu/runtime/metrics.py`` as far as the
dispatcher binds it: a lock-light registry of counters, gauges, reservoir
timers and histograms with ``trace_id`` exemplars, under the reference's
instrument names, so ``metrics_snapshot()`` keeps its keys.  The
OpenMetrics exposition and the SLO burn-rate engine come with the
``Instance`` slice.

Naming convention: lowercase dotted ``subsystem.noun[_verb][_unit]``
segments (``pipeline.e2e_latency_s``, ``resilience.supervisor.x.restarts``)
— :data:`METRIC_NAME_RE` is the contract; registry accessors sanitize
dynamic segments into it.
"""

from __future__ import annotations

import bisect
import collections
import logging
import re
import threading
import time
from typing import Dict, List, Optional, Tuple

logger = logging.getLogger("sitewhere_tpu_torch.metrics")

# The linted naming contract: ≥2 lowercase dotted segments, each
# [a-z0-9_-] starting alphanumeric.  Dynamic segments are sanitized into
# this space by the registry accessors.
METRIC_NAME_RE = re.compile(r"^[a-z0-9][a-z0-9_-]*(\.[a-z0-9][a-z0-9_-]*)+$")

_SANITIZE_RE = re.compile(r"[^a-z0-9_.-]")


def sanitize_metric_name(name: str) -> str:
    """Map an arbitrary name into the dotted convention (lowercase;
    invalid chars → ``_``; empty or badly-led segments get an ``x``
    prefix) so dynamic segments — connector ids, receiver names like
    ``tcp-receiver:9090`` — can never mint an unlintable or
    un-exposable metric.  Idempotent.  Segment COUNT is the caller's
    concern: metric names are code-authored dotted paths; only the
    segments themselves may be dynamic."""
    segs = []
    for seg in name.lower().split("."):
        seg = _SANITIZE_RE.sub("_", seg)
        if not seg or not seg[0].isalnum():
            seg = "x" + seg   # segments must start [a-z0-9]
        segs.append(seg)
    return ".".join(segs)


class Counter:
    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.value += n


class Gauge:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v


class Timer:
    """Reservoir timer with p50/p95/p99 over a bounded sample ring.

    ``observe`` is O(1) — append to a ``deque(maxlen=reservoir)`` under
    the lock — and the sort is deferred to the READ side (percentile /
    snapshot), cached until the next observation.  The previous
    ``bisect.insort`` kept the reservoir sorted on every observation:
    O(n) memmove per sample *while holding the lock*, i.e. ~4096 element
    moves on the hot path per event at steady state.
    """

    def __init__(self, reservoir: int = 4096):
        self.reservoir = reservoir
        self._samples: collections.deque = collections.deque(maxlen=reservoir)
        self._sorted: Optional[List[float]] = None
        self._lock = threading.Lock()
        self.count = 0
        self.total = 0.0

    def observe(self, seconds: float) -> None:
        with self._lock:
            self.count += 1
            self.total += seconds
            self._samples.append(seconds)
            self._sorted = None

    def time(self):
        timer = self

        class _Ctx:
            def __enter__(self):
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                timer.observe(time.perf_counter() - self.t0)
                return False

        return _Ctx()

    def percentile(self, q: float) -> float:
        with self._lock:
            if not self._samples:
                return 0.0
            if self._sorted is None:
                self._sorted = sorted(self._samples)
            idx = min(len(self._sorted) - 1, int(q * len(self._sorted)))
            return self._sorted[idx]

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0


# Fixed latency buckets (seconds): 25us..10s around the <10ms p99 target,
# densest below a millisecond, where the host stages (batch assembly,
# H2D staging) are resolved.
DEFAULT_LATENCY_BUCKETS_S: Tuple[float, ...] = (
    0.000025, 0.0001, 0.00025, 0.0005,
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


class Histogram:
    """Fixed-bucket histogram with optional trace-id exemplars.

    Buckets are cumulative ``le`` (≤ upper bound) counts, Prometheus
    histogram semantics, so scrape deltas aggregate across hosts without
    a reservoir merge.  ``observe(v, trace_id=...)`` additionally pins
    the LAST exemplar per bucket — the exposition links a latency bucket
    to a concrete retained trace an operator can open.
    """

    __slots__ = ("buckets", "_counts", "count", "total", "_exemplars",
                 "_lock")

    def __init__(self, buckets: Tuple[float, ...] = DEFAULT_LATENCY_BUCKETS_S):
        self.buckets: Tuple[float, ...] = tuple(sorted(float(b) for b in buckets))
        self._counts = [0] * (len(self.buckets) + 1)   # +1: the +Inf bucket
        self.count = 0
        self.total = 0.0
        # bucket index → (trace_id, observed value, unix ts)
        self._exemplars: Dict[int, Tuple[str, float, float]] = {}
        self._lock = threading.Lock()

    def observe(self, value: float, trace_id: Optional[str] = None) -> None:
        value = float(value)
        idx = bisect.bisect_left(self.buckets, value)
        with self._lock:
            self._counts[idx] += 1
            self.count += 1
            self.total += value
            if trace_id:
                self._exemplars[idx] = (str(trace_id), value, time.time())

    def snapshot(self) -> dict:
        """Cumulative bucket counts keyed by the ``le`` bound."""
        with self._lock:
            counts = list(self._counts)
            count, total = self.count, self.total
        cum, out = 0, {}
        for bound, n in zip(self.buckets, counts):
            cum += n
            out[bound] = cum
        return {"count": count, "sum": total, "buckets": out}

    def _render_state(self):
        with self._lock:
            return (list(self._counts), self.count, self.total,
                    dict(self._exemplars))


class MetricsRegistry:
    """Named metrics, hierarchical dotted keys (sanitized on access)."""

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._timers: Dict[str, Timer] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._lock = threading.Lock()

    def counter(self, name: str) -> Counter:
        with self._lock:
            return self._counters.setdefault(sanitize_metric_name(name),
                                             Counter())

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            return self._gauges.setdefault(sanitize_metric_name(name),
                                           Gauge())

    def timer(self, name: str) -> Timer:
        with self._lock:
            return self._timers.setdefault(sanitize_metric_name(name),
                                           Timer())

    def histogram(self, name: str,
                  buckets: Optional[Tuple[float, ...]] = None) -> Histogram:
        name = sanitize_metric_name(name)
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram(
                    buckets or DEFAULT_LATENCY_BUCKETS_S)
            elif (buckets is not None
                  and tuple(sorted(float(b) for b in buckets)) != h.buckets):
                # silently bucketing B's observations under A's bounds
                # would corrupt the scrape surface — keep A's, but say so
                logger.warning(
                    "histogram %r already registered with different "
                    "buckets; keeping the existing bounds", name)
            return h

    def names(self) -> List[str]:
        """Every registered metric name (the lint surface)."""
        with self._lock:
            return sorted({*self._counters, *self._gauges, *self._timers,
                           *self._histograms})

    def remove(self, *names: str) -> int:
        """Unregister metrics by (sanitized) name across every instrument
        table; returns how many instruments were dropped.  Exists for
        bounded-lifetime DYNAMIC families — per-peer gauges pruned on a
        membership rebind, per-tenant gauges rotated out of the top-K —
        so departed label values stop haunting the scrape surface.
        Code-authored long-lived metrics are never removed; holders of a
        popped instrument keep a harmless orphan that no longer renders."""
        dropped = 0
        with self._lock:
            for name in names:
                key = sanitize_metric_name(name)
                for table in (self._counters, self._gauges, self._timers,
                              self._histograms):
                    if table.pop(key, None) is not None:
                        dropped += 1
        return dropped

    def snapshot(self) -> dict:
        """Serializable view for the REST/admin surface."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            timers = dict(self._timers)
            histograms = dict(self._histograms)
        return {
            "counters": {k: c.value for k, c in counters.items()},
            "gauges": {k: g.value for k, g in gauges.items()},
            "timers": {
                k: {
                    "count": t.count,
                    "mean_ms": t.mean * 1e3,
                    "p50_ms": t.percentile(0.50) * 1e3,
                    "p95_ms": t.percentile(0.95) * 1e3,
                    "p99_ms": t.percentile(0.99) * 1e3,
                }
                for k, t in timers.items()
            },
            "histograms": {k: h.snapshot() for k, h in histograms.items()},
        }


# Process-wide registry for cross-cutting counters (resilience: retries,
# breaker transitions, supervisor restarts, dead-letter totals).  Components
# with their own registries keep them; this one aggregates what must be
# observable without plumbing a registry through every constructor.
_GLOBAL = MetricsRegistry()


def global_registry() -> MetricsRegistry:
    return _GLOBAL
