"""In-process metrics: counters, gauges, timers, histograms.

Counterpart of ``sitewhere_tpu/runtime/metrics.py`` as far as the
dispatcher binds it: a lock-light registry of counters, gauges, reservoir
timers and histograms with ``trace_id`` exemplars, under the reference's
instrument names, so ``metrics_snapshot()`` keeps its keys, and the
SLO burn-rate engine (:class:`BurnRateEngine`, the reference's
:446-771), and the OpenMetrics exposition (the reference's :288-443):
:func:`render_openmetrics` serializes registries for
``/api/instance/metrics.prom``, first registry wins on a family name,
and :func:`parse_exposition` is the matching scrape-side parser.

Naming convention: lowercase dotted ``subsystem.noun[_verb][_unit]``
segments (``pipeline.e2e_latency_s``, ``resilience.supervisor.x.restarts``)
— :data:`METRIC_NAME_RE` is the contract; registry accessors sanitize
dynamic segments into it.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import logging
import math
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


# -- OpenMetrics exposition ---------------------------------------------------

_PROM_INVALID = re.compile(r"[^a-zA-Z0-9_]")


def _prom_name(name: str) -> str:
    return _PROM_INVALID.sub("_", name)


def _fmt(v: float) -> str:
    f = float(v)
    # non-finite first: int(nan) raises, int(inf) overflows — and one
    # bad sample must never take down the whole scrape surface
    if f != f:
        return "NaN"
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _exemplar(ex: Optional[Tuple[str, float, float]]) -> str:
    if not ex:
        return ""
    trace_id, value, ts = ex
    return f' # {{trace_id="{trace_id}"}} {_fmt(value)} {ts:.3f}'


def _claim(seen: Dict[str, Tuple[str, str]], prom_name: str, dotted: str,
           kind: str) -> bool:
    """Reserve a flattened family name; False = already emitted.  A
    DIFFERENT dotted name (e.g. ``x.a-1`` vs ``x.a.1``) or a different
    instrument kind (``counter('a.b')`` + ``gauge('a.b')``) collapsing
    onto one already-emitted family would silently hide the loser —
    warn.  Same dotted name + kind stays silent: that's the documented
    first-registry-wins shadowing."""
    prior = seen.get(prom_name)
    if prior is None:
        seen[prom_name] = (dotted, kind)
        return True
    if prior != (dotted, kind):
        logger.warning(
            "metric %r (%s) hidden from exposition: flattens to %r, "
            "already emitted as %s for %r",
            dotted, kind, prom_name, prior[1], prior[0])
    return False


def render_openmetrics(*registries: MetricsRegistry) -> str:
    """Serialize registries as OpenMetrics text (the ``.prom`` surface).

    Families merge first-registry-wins on name collisions (the instance
    registry shadows the process-global one).  Histogram buckets carry
    ``trace_id`` exemplars when the hot path supplied them; timers render
    as summaries (quantiles are host-local, not aggregatable — the
    histograms exist for cross-host aggregation).
    """
    lines: List[str] = []
    seen: Dict[str, Tuple[str, str]] = {}
    for reg in registries:
        with reg._lock:
            counters = dict(reg._counters)
            gauges = dict(reg._gauges)
            timers = dict(reg._timers)
            histograms = dict(reg._histograms)
        for name, c in sorted(counters.items()):
            n = _prom_name(name)
            if not _claim(seen, n, name, "counter"):
                continue
            lines.append(f"# TYPE {n} counter")
            lines.append(f"{n}_total {_fmt(c.value)}")
        for name, g in sorted(gauges.items()):
            n = _prom_name(name)
            if not _claim(seen, n, name, "gauge"):
                continue
            lines.append(f"# TYPE {n} gauge")
            lines.append(f"{n} {_fmt(g.value)}")
        for name, t in sorted(timers.items()):
            n = _prom_name(name)
            if not _claim(seen, n, name, "summary"):
                continue
            lines.append(f"# TYPE {n} summary")
            for q in (0.5, 0.95, 0.99):
                lines.append(f'{n}{{quantile="{q}"}} {_fmt(t.percentile(q))}')
            lines.append(f"{n}_sum {_fmt(t.total)}")
            lines.append(f"{n}_count {_fmt(t.count)}")
        for name, h in sorted(histograms.items()):
            n = _prom_name(name)
            if not _claim(seen, n, name, "histogram"):
                continue
            counts, count, total, exemplars = h._render_state()
            lines.append(f"# TYPE {n} histogram")
            cum = 0
            for i, bound in enumerate(h.buckets):
                cum += counts[i]
                lines.append(f'{n}_bucket{{le="{_fmt(bound)}"}} {cum}'
                             + _exemplar(exemplars.get(i)))
            lines.append(f'{n}_bucket{{le="+Inf"}} {count}'
                         + _exemplar(exemplars.get(len(h.buckets))))
            lines.append(f"{n}_sum {_fmt(total)}")
            lines.append(f"{n}_count {_fmt(count)}")
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?P<labels>\{[^}]*\})?"
    r" (?P<value>[^ #]+)"
    r"(?P<exemplar> # \{[^}]*\} [^ ]+( [^ ]+)?)?$"
)


def parse_exposition(text: str) -> Dict[str, dict]:
    """Minimal OpenMetrics scrape-side parser (smoke tooling + tests).

    Returns ``{family: {"type": ..., "samples": {sample_key: value}}}``
    where ``sample_key`` is the sample name plus its label string.
    Raises ``ValueError`` on malformed lines, samples without a
    preceding TYPE declaration, or a missing ``# EOF`` terminator —
    i.e. it VALIDATES, it doesn't best-effort skip.
    """
    families: Dict[str, dict] = {}
    stripped = text.rstrip("\n").split("\n")
    if not stripped or stripped[-1] != "# EOF":
        raise ValueError("exposition not terminated with # EOF")
    for line in stripped[:-1]:
        if not line:
            raise ValueError("blank line in exposition")
        if line.startswith("#"):
            parts = line.split(" ", 3)
            if len(parts) < 3 or parts[1] not in ("TYPE", "HELP", "UNIT"):
                raise ValueError(f"malformed comment line: {line!r}")
            if parts[1] == "TYPE":
                if len(parts) < 4:
                    raise ValueError(f"TYPE line missing type: {line!r}")
                families[parts[2]] = {"type": parts[3], "samples": {}}
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"malformed sample line: {line!r}")
        name = m.group("name")
        family = next(
            (f for f in (name, name.rsplit("_", 1)[0]) if f in families),
            None)
        if family is None:
            raise ValueError(f"sample {name!r} without a TYPE declaration")
        value = float(m.group("value"))
        families[family]["samples"][name + (m.group("labels") or "")] = value
    return families


# -- SLO burn-rate engine -----------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SloTargets:
    """The BASELINE.json objectives as runtime targets.

    - ``throughput_eps``: the capacity target (1M ev/s/chip).  Judged
      against min(target, OFFERED load): a healthy deployment receiving
      200k ev/s and completing all of it is meeting demand, not
      breaching — only completion falling behind what intake admitted
      (a wedge, or demand above capacity going unserved) burns.  0
      disables the objective.
    - ``p99_ms``: end-to-end p99 ceiling (<10 ms).
    - ``shed_rate``: admissible shed fraction of offered load.
    """

    throughput_eps: float = 1_000_000.0
    p99_ms: float = 10.0
    shed_rate: float = 0.01

    def names(self) -> Tuple[str, ...]:
        return tuple(f.name for f in dataclasses.fields(self))


class _BurnWindow:
    """One rolling window of (ts, bad?) samples per objective."""

    __slots__ = ("span_s", "samples")

    def __init__(self, span_s: float):
        self.span_s = float(span_s)
        self.samples: collections.deque = collections.deque()

    def add(self, now: float, bad: bool) -> None:
        self.samples.append((now, bool(bad)))
        self.prune(now)

    def prune(self, now: float) -> None:
        cutoff = now - self.span_s
        while self.samples and self.samples[0][0] < cutoff:
            self.samples.popleft()

    def bad_fraction(self) -> float:
        if not self.samples:
            return 0.0
        return sum(1 for _, bad in self.samples if bad) / len(self.samples)

    def __len__(self) -> int:
        return len(self.samples)


class BurnRateEngine:
    """Multi-window SLO burn-rate evaluation (the SRE playbook shape).

    Each :meth:`observe` sample is judged per objective (breaching or
    not); the breach fraction over a FAST and a SLOW rolling window,
    divided by ``error_budget``, is that window's burn rate — burn 1.0
    means "breaching at exactly the budgeted rate", N means N× too
    fast.  An alert arms when BOTH windows burn at ≥ ``alert_burn``
    (the fast window reacts, the slow window confirms it isn't a blip)
    with at least ``min_samples`` in the fast window, and clears when
    the fast window's burn drops below 1.0.

    Surfaces: ``slo.burn_rate.<objective>.{fast,slow}`` gauges +
    ``slo.alert.<objective>`` gauges (pre-registered so the families
    exist on the scrape surface before the first breach), an
    ``slo.burn`` alert span through the wired :class:`Tracer` on every
    arm/clear, and an ``on_alert(objective, burn)`` hook the instance
    points at the flight recorder.  Injectable clock; ``tick()`` is
    rate-limited so the dispatcher loop can call it every cycle.
    """

    def __init__(self, targets: Optional[SloTargets] = None,
                 windows_s: Tuple[float, float] = (60.0, 600.0),
                 error_budget: float = 0.05,
                 alert_burn: float = 2.0,
                 min_samples: int = 5,
                 lag_tolerance_s: float = 2.0,
                 sample_interval_s: float = 1.0,
                 sample_fn=None,
                 metrics: Optional[MetricsRegistry] = None,
                 tracer=None,
                 on_alert=None,
                 clock=time.monotonic):
        self.targets = targets or SloTargets()
        if len(windows_s) != 2 or windows_s[0] >= windows_s[1]:
            raise ValueError("windows_s must be (fast, slow), fast < slow")
        self.windows_s = (float(windows_s[0]), float(windows_s[1]))
        if not 0.0 < error_budget <= 1.0:
            raise ValueError("error_budget must be in (0, 1]")
        self.error_budget = float(error_budget)
        self.alert_burn = float(alert_burn)
        self.min_samples = max(1, int(min_samples))
        # throughput lag allowance, in seconds of demand: work in
        # flight (a full ring's chain) is not a breach until completion
        # falls further behind offered load than this
        self.lag_tolerance_s = float(lag_tolerance_s)
        self._tp_deficit = 0.0
        self.sample_interval_s = float(sample_interval_s)
        self.sample_fn = sample_fn
        self._metrics = metrics if metrics is not None else global_registry()
        if tracer is None:
            from sitewhere_tpu_torch.runtime.tracing import Tracer

            tracer = Tracer(sample_rate=0.0)
        self.tracer = tracer
        self.on_alert = on_alert
        self._clock = clock
        self._lock = threading.Lock()
        self._last_sample = float("-inf")
        self._windows: Dict[str, Tuple[_BurnWindow, _BurnWindow]] = {
            name: (_BurnWindow(self.windows_s[0]),
                   _BurnWindow(self.windows_s[1]))
            for name in self.targets.names()
        }
        self._alerting: Dict[str, bool] = {
            name: False for name in self.targets.names()}
        self.alerts_fired = 0
        self.last_sample: Dict[str, float] = {}
        # pre-register the gauge families: the scrape surface must show
        # burn 0.0, not an absent family, before the first breach
        self._g_burn = {
            (name, label): self._metrics.gauge(
                f"slo.burn_rate.{name}.{label}")
            for name in self.targets.names()
            for label in ("fast", "slow")
        }
        self._g_alert = {
            name: self._metrics.gauge(f"slo.alert.{name}")
            for name in self.targets.names()
        }

    # -- sampling ------------------------------------------------------------

    def tick(self, now: Optional[float] = None) -> None:
        """Pull one sample from ``sample_fn`` if one is due (cheap when
        not).  The dispatcher loop calls this every cycle."""
        if self.sample_fn is None:
            return
        now = self._clock() if now is None else now
        if now - self._last_sample < self.sample_interval_s:
            return
        self._last_sample = now
        try:
            sample = self.sample_fn()
        except Exception:
            logger.exception("SLO sample collection failed")
            return
        if sample is not None:
            self.observe(sample, now)

    def _judge(self, sample: Dict[str, float]) -> Dict[str, Optional[bool]]:
        """Per-objective breach verdicts for one sample; None = the
        objective has no evidence this sample (idle window, no latency
        percentile yet) — idleness is not burn."""
        t = self.targets
        verdicts: Dict[str, Optional[bool]] = {}
        events = float(sample.get("events", 0.0))
        elapsed = float(sample.get("elapsed_s", 0.0))
        shed = float(sample.get("shed", 0.0))
        admitted = float(sample.get("admitted", 0.0))
        offered = admitted + shed
        # Throughput judges completion against DEMAND, capped at the
        # capacity target: a healthy instance offered 200k ev/s that
        # completes 200k is meeting demand (never a breach), a wedged
        # pipeline (0 completed while intake keeps admitting) is the
        # highest-severity breach, and demand above capacity going
        # unserved burns against the target.  The comparison runs on a
        # RUNNING DEFICIT (offered minus completed, floored at zero),
        # not per-sample rates: egress completes in chain-granularity
        # bursts (a K-deep ring lands ~K·width rows at once), so
        # per-sample deltas alternate 0 / 2× and would read a healthy
        # full ring as 50% breaching.  The deficit tolerates
        # ``lag_tolerance_s`` worth of demand in flight and only judges
        # bad once completion has fallen further behind than that.  No
        # offered-load evidence → None: true idle is never burn, and
        # completion alone cannot prove under-delivery.
        backlog = float(sample.get("backlog", 0.0))
        if t.throughput_eps > 0 and elapsed > 0 and offered > 0:
            demand_eps = min(t.throughput_eps, offered / elapsed)
            # ADMITTED minus completed, not offered: shed rows are
            # refused at intake and can never become completions, so
            # counting them here would grow a deficit no healthy
            # operation could ever drain — a shedding episode is the
            # shed_rate objective's burn, not throughput's
            self._tp_deficit = max(0.0,
                                   self._tp_deficit + admitted - events)
            verdicts["throughput_eps"] = (
                self._tp_deficit > self.lag_tolerance_s * demand_eps)
        elif (t.throughput_eps > 0 and events == 0 and backlog > 0):
            # no admission-side evidence (deployments without the
            # overload controller alias admitted to completed, so a
            # wedge shows offered == events == 0) — but rows sitting in
            # the queue with NOTHING completing all sample is a stall
            # witness in its own right.  A queue SNAPSHOT, deliberately
            # not folded into the deficit: re-adding it every wedged
            # sample would double-count the same rows and leave a
            # residual lag no later sample could ever drain.
            verdicts["throughput_eps"] = True
        else:
            verdicts["throughput_eps"] = None
            if offered == 0 and events > 0:
                # completions with no new offered load drain the lag
                self._tp_deficit = max(0.0, self._tp_deficit - events)
        p99 = sample.get("p99_ms")
        verdicts["p99_ms"] = (float(p99) > t.p99_ms
                              if p99 is not None else None)
        verdicts["shed_rate"] = ((shed / offered) > t.shed_rate
                                 if offered > 0 else None)
        return verdicts

    def observe(self, sample: Dict[str, float],
                now: Optional[float] = None) -> Dict[str, float]:
        """Feed one sample dict (``events``, ``elapsed_s``, ``p99_ms``,
        ``shed``, ``admitted``) and run the alert evaluation.  Returns
        the per-objective fast-window burn rates."""
        now = self._clock() if now is None else now
        burns: Dict[str, float] = {}
        events: List[Tuple[str, str, float, float]] = []
        with self._lock:
            self.last_sample = dict(sample)
            for name, bad in self._judge(sample).items():
                fast, slow = self._windows[name]
                if bad is not None:
                    fast.add(now, bad)
                    slow.add(now, bad)
                else:
                    # no evidence this sample — but time still passes:
                    # old breach samples must age out or an armed alert
                    # on a now-idle instance would never clear
                    fast.prune(now)
                    slow.prune(now)
                burn_fast = fast.bad_fraction() / self.error_budget
                burn_slow = slow.bad_fraction() / self.error_budget
                self._g_burn[(name, "fast")].set(round(burn_fast, 4))
                self._g_burn[(name, "slow")].set(round(burn_slow, 4))
                burns[name] = burn_fast
                action = self._evaluate_locked(name, burn_fast,
                                               burn_slow, len(fast))
                if action is not None:
                    events.append((name, action, burn_fast, burn_slow))
        # spans + hooks OUTSIDE the lock: on_alert typically writes a
        # flight-recorder dump to disk — holding the lock through it
        # would wedge snapshot()/topology() (the read surface an
        # operator is refreshing) during the very incident being
        # reported, and pin the dispatcher loop thread with it
        for name, action, burn_fast, burn_slow in events:
            self._emit_span(name, action, burn_fast, burn_slow)
            if action == "arm":
                logger.warning(
                    "SLO burn alert: %s burning %.1fx budget "
                    "(slow %.1fx)", name, burn_fast, burn_slow)
                if self.on_alert is not None:
                    try:
                        self.on_alert(name, burn_fast)
                    except Exception:
                        logger.exception("SLO alert hook failed")
            else:
                logger.warning("SLO burn alert cleared: %s", name)
        return burns

    def _evaluate_locked(self, name: str, burn_fast: float,
                         burn_slow: float,
                         fast_n: int) -> Optional[str]:
        """Update the alert state machine for one objective; returns
        "arm"/"clear" when the state changed (the caller emits spans and
        hooks after releasing the lock), else None."""
        alerting = self._alerting[name]
        if (not alerting and fast_n >= self.min_samples
                and burn_fast >= self.alert_burn
                and burn_slow >= self.alert_burn):
            self._alerting[name] = True
            self.alerts_fired += 1
            self._g_alert[name].set(1)
            return "arm"
        if alerting and burn_fast < 1.0:
            self._alerting[name] = False
            self._g_alert[name].set(0)
            return "clear"
        return None

    def _emit_span(self, name: str, action: str,
                   burn_fast: float, burn_slow: float) -> None:
        """The alert as a span through the shared tracer: operators see
        WHEN the budget started burning in the same place as pipeline
        and overload-transition spans."""
        trace = self.tracer.trace("slo.burn")
        with trace.span(f"slo.{name}_{action}") as sp:
            sp.tag("objective", name)
            sp.tag("action", action)
            sp.tag("burn_fast", round(burn_fast, 3))
            sp.tag("burn_slow", round(burn_slow, 3))
            if action == "arm":
                sp.error = (f"{name} burning {burn_fast:.1f}x "
                            "error budget")
        trace.end()

    # -- read side -----------------------------------------------------------

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "targets": dataclasses.asdict(self.targets),
                "windows_s": list(self.windows_s),
                "error_budget": self.error_budget,
                "alert_burn": self.alert_burn,
                "alerts_fired": self.alerts_fired,
                "objectives": {
                    name: {
                        "burn_fast": round(
                            fast.bad_fraction() / self.error_budget, 4),
                        "burn_slow": round(
                            slow.bad_fraction() / self.error_budget, 4),
                        "samples_fast": len(fast),
                        "alerting": self._alerting[name],
                    }
                    for name, (fast, slow) in self._windows.items()
                },
                "last_sample": dict(self.last_sample),
            }


# Process-wide registry for cross-cutting counters (resilience: retries,
# breaker transitions, supervisor restarts, dead-letter totals).  Components
# with their own registries keep them; this one aggregates what must be
# observable without plumbing a registry through every constructor.
_GLOBAL = MetricsRegistry()


def global_registry() -> MetricsRegistry:
    return _GLOBAL
