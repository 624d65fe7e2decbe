"""Span tracing: head + tail sampling, cross-boundary context propagation.

Reference: OpenTracing + Jaeger with a 1% probabilistic sampler
(``microservice/MicroserviceConfiguration.java:53-57``), spans around
lifecycle ops and gRPC client/server interceptors
(``grpc/client/common/tracing/ClientTracingInterceptor.java``).  The
pipeline here is one process per host, so spans are the host stages
wrapped around the one device program: batch assemble (batcher wait),
step dispatch, and each egress leg — plus the RPC legs when a trace
crosses hosts.

Two samplers compose:

- **Head sampling** (the Jaeger 1% analog): the decision is made ONCE at
  the trace root, so a sampled trace carries every stage span.  Sampled
  spans land in the finished ring as they close.
- **Tail sampling**: every *unsampled* trace still records its spans into
  a bounded pending buffer; when the trace ends (or is evicted), it is
  RETAINED if any span errored or the trace exceeded the latency
  threshold, and dropped otherwise.  The traces an operator actually
  needs — the failed and the slow — are therefore always kept, at a
  per-plan (never per-event) bookkeeping cost.

Cross-boundary propagation: :meth:`Trace.propagate` stamps the trace
context into a header dict (the RPC fabric's JSON headers lane,
``rpc/wire.py``) and :meth:`Tracer.join` continues it on the far side,
so one trace spans ingest → dispatch → seal → fan-out → remote delivery
with the same ``trace_id`` on every host.
"""

from __future__ import annotations

import collections
import random
import threading
import time
from typing import Dict, List, Optional

# Trace-context header keys (carried in the RPC frame's JSON headers
# lane next to authorization/tenant — see rpc/wire.py).
TRACE_ID_HEADER = "trace-id"
PARENT_ID_HEADER = "parent-id"
TRACE_SAMPLED_HEADER = "trace-sampled"

_ids = random.Random()
_ids_lock = threading.Lock()


def _new_id() -> str:
    with _ids_lock:
        return f"{_ids.getrandbits(64):016x}"


class _NoopSpan:
    """Unsampled: every operation is a no-op (hot-path cost ≈ one branch)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def tag(self, key: str, value) -> "_NoopSpan":
        return self

    @property
    def error(self):
        return None

    @error.setter
    def error(self, value) -> None:
        pass   # unsampled: discard (callers may flag failures uniformly)


_NOOP = _NoopSpan()


class Span:
    __slots__ = ("tracer", "trace_id", "span_id", "parent_id", "name",
                 "start_s", "duration_s", "tags", "error", "trace", "_t0")

    def __init__(self, tracer: "Tracer", trace_id: str, name: str,
                 parent_id: Optional[str] = None,
                 trace: Optional["Trace"] = None):
        self.tracer = tracer
        self.trace_id = trace_id
        self.span_id = _new_id()
        self.parent_id = parent_id
        self.name = name
        self.start_s = time.time()
        self.duration_s: Optional[float] = None
        self.tags: Dict[str, object] = {}
        self.error: Optional[str] = None
        self.trace = trace

    def tag(self, key: str, value) -> "Span":
        self.tags[key] = value
        return self

    def __enter__(self) -> "Span":
        self._t0 = time.perf_counter()  # type: ignore[attr-defined]
        return self

    def __exit__(self, exc_type, exc, tb):
        self.duration_s = time.perf_counter() - self._t0  # type: ignore
        if exc is not None:
            self.error = f"{exc_type.__name__}: {exc}"
        self.tracer._finish(self)
        return False

    def to_dict(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "start_s": round(self.start_s, 6),
            "duration_ms": (round(self.duration_s * 1e3, 3)
                            if self.duration_s is not None else None),
            "tags": self.tags,
            "error": self.error,
        }


class Trace:
    """A live trace handle: spawn child spans under one trace id.

    ``sampled=True`` means retention is already decided (head-sampled
    here, or upstream on the propagating side): spans flush straight to
    the finished ring.  ``sampled=False`` means the trace is a
    tail-sampling candidate: spans buffer until :meth:`end` decides.
    """

    __slots__ = ("tracer", "trace_id", "root_id", "sampled", "decided")

    def __init__(self, tracer: "Tracer", trace_id: str,
                 root_id: Optional[str], sampled: bool = True):
        self.tracer = tracer
        self.trace_id = trace_id
        self.root_id = root_id
        self.sampled = sampled
        # retention state: head-sampled traces are born decided; tail
        # candidates flip decided (and maybe sampled) at end()/eviction
        # — guarded by the tracer's lock, so a late async span can
        # never re-open a decided trace's pending entry
        self.decided = sampled

    def span(self, name: str, parent: Optional[Span] = None):
        return Span(self.tracer, self.trace_id, name,
                    parent_id=(parent.span_id if isinstance(parent, Span)
                               else self.root_id),
                    trace=self)

    def record(self, name: str, duration_s: float, **tags) -> None:
        """Record an already-measured stage (e.g. batcher wait) as a span."""
        span = Span(self.tracer, self.trace_id, name, parent_id=self.root_id,
                    trace=self)
        span.start_s = time.time() - duration_s
        span.duration_s = duration_s
        span.tags.update(tags)
        self.tracer._finish(span)

    def propagate(self, headers: Dict[str, str],
                  parent: Optional[Span] = None) -> Dict[str, str]:
        """Stamp the trace context into ``headers`` (in place) so the
        receiving side can :meth:`Tracer.join` it.  ``parent`` names the
        client-side span the remote spans should hang off."""
        headers[TRACE_ID_HEADER] = self.trace_id
        parent_id = (parent.span_id if isinstance(parent, Span)
                     else self.root_id)
        if parent_id:
            headers[PARENT_ID_HEADER] = parent_id
        headers[TRACE_SAMPLED_HEADER] = "1" if self.sampled else "0"
        return headers

    def end(self) -> None:
        """Close the trace: applies the tail-sampling retention decision
        for pending traces (no-op for head-sampled ones).  Safe to call
        once per trace from the side that created it; spans finished
        AFTER end() (async egress legs) go straight to the ring when the
        trace was retained and are discarded when it was dropped — they
        never re-open the pending entry.  Exception: a late ERRORED span
        (with ``tail_errors`` on) re-opens retention, so an async
        delivery failure is never invisible."""
        self.tracer._end_trace(self)


class _NoopTrace:
    __slots__ = ()

    trace_id = None
    sampled = False
    decided = True

    def span(self, name: str, parent=None):
        return _NOOP

    def record(self, name: str, duration_s: float, **tags) -> None:
        pass

    def propagate(self, headers: Dict[str, str], parent=None) -> Dict[str, str]:
        return headers

    def end(self) -> None:
        pass


_NOOP_TRACE = _NoopTrace()


class _PendingTrace:
    __slots__ = ("spans", "started")

    def __init__(self):
        self.spans: List[Span] = []
        self.started = time.monotonic()


class Tracer:
    """Head + tail sampling tracer with a bounded finished-span ring.

    - ``sample_rate``: probabilistic head sampler (decision per trace).
    - ``tail_errors``: retain any unsampled trace with an errored span.
    - ``tail_latency_s``: retain any unsampled trace whose span extent
      meets/exceeds this many seconds (``None`` disables the check).
    - ``pending_capacity``: bound on concurrently-pending (undecided)
      traces; the oldest is evicted-and-decided when exceeded, so an
      abandoned trace can never leak.

    With both tail knobs off (the default), unsampled traces cost one
    branch — exactly the old head-only behavior.
    """

    def __init__(self, sample_rate: float = 0.01, capacity: int = 2048,
                 tail_latency_s: Optional[float] = None,
                 tail_errors: bool = False,
                 pending_capacity: int = 512,
                 tail_anomaly_window_s: float = 30.0,
                 seed: int = 0xC0FFEE):
        self.sample_rate = float(sample_rate)
        self.tail_latency_s = tail_latency_s
        self.tail_errors = bool(tail_errors)
        self.pending_capacity = int(pending_capacity)
        # anomaly-overlap retention: note_anomaly() stamps a moment
        # (an overload state transition, an SLO alert); any tail-
        # candidate trace whose span extent overlaps the window
        # [stamp, stamp + tail_anomaly_window_s] is retained regardless
        # of the error/latency rules — the traces surrounding a state
        # transition are exactly the forensic record an operator needs,
        # and before this only errored/slow traces were guaranteed.
        self.tail_anomaly_window_s = float(tail_anomaly_window_s)
        self._anomalies: collections.deque = collections.deque(maxlen=64)
        self.anomalies_noted = 0
        self.retained_anomaly = 0
        self._spans: collections.deque = collections.deque(maxlen=capacity)
        self._pending: "collections.OrderedDict[str, _PendingTrace]" = \
            collections.OrderedDict()
        self._lock = threading.Lock()
        self._rng = random.Random(seed)
        self.started = 0
        self.sampled = 0
        self.joined = 0
        self.retained_tail = 0
        self.dropped_tail = 0

    @property
    def _tail_enabled(self) -> bool:
        return (self.tail_errors or self.tail_latency_s is not None
                or bool(self._anomalies))

    def note_anomaly(self, ts: Optional[float] = None) -> None:
        """Stamp an anomaly moment (wall-clock ``time.time`` space, the
        same clock spans carry): tail candidates overlapping the
        retention window from this stamp are ALWAYS kept.  Called by the
        overload controller on every state transition and by the SLO
        burn engine on alert."""
        with self._lock:
            self._anomalies.append(time.time() if ts is None else ts)
            self.anomalies_noted += 1

    def trace(self, name: str):
        """Trace root: head-sample, else tail-candidate, else no-op.

        The head decision is per-trace (reference: Jaeger probabilistic
        1%, ``MicroserviceConfiguration.java:55``) so sampled traces
        carry every stage span; with tail sampling on, unsampled traces
        still buffer pending the end-of-trace retention decision.
        """
        self.started += 1
        if self._rng.random() < self.sample_rate:
            self.sampled += 1
            return Trace(self, _new_id(), None, sampled=True)
        if not self._tail_enabled:
            return _NOOP_TRACE
        return Trace(self, _new_id(), None, sampled=False)

    def join(self, headers: Optional[Dict[str, str]]):
        """Continue a propagated trace from ``headers``; None when no
        trace context rides them.  The upstream head decision carries
        over; tail candidates are decided locally too, so an error on
        EITHER side of the boundary retains that side's spans."""
        if not headers:
            return None
        trace_id = headers.get(TRACE_ID_HEADER)
        if not trace_id:
            return None
        self.joined += 1
        sampled = headers.get(TRACE_SAMPLED_HEADER) == "1"
        if not sampled and not self._tail_enabled:
            return _NOOP_TRACE
        return Trace(self, str(trace_id),
                     headers.get(PARENT_ID_HEADER) or None, sampled=sampled)

    # -- span / trace completion --------------------------------------------

    def _finish(self, span: Span) -> None:
        trace = span.trace
        if trace is None or trace.sampled:
            with self._lock:
                self._spans.append(span)
            return
        with self._lock:
            if trace.sampled:
                # retention decided between the check above and the lock
                self._spans.append(span)
                return
            if trace.decided:
                # decided-and-dropped: late async spans drop too — EXCEPT
                # an errored one (an outbound worker failing after the
                # plan's drop decision): the error guarantee must hold
                # for async legs, so retention re-opens from this span
                # on (the pre-decision clean spans are already gone)
                if self.tail_errors and span.error:
                    trace.sampled = True
                    self._spans.append(span)
                    self.retained_tail += 1
                    self.dropped_tail -= 1
                return
            entry = self._pending.get(trace.trace_id)
            if entry is None:
                entry = self._pending[trace.trace_id] = _PendingTrace()
                if len(self._pending) > self.pending_capacity:
                    # abandoned trace (owner crashed before end()):
                    # decide now so its error spans still survive
                    _, evicted = self._pending.popitem(last=False)
                    self._decide_locked(evicted)
            entry.spans.append(span)

    def _end_trace(self, trace: Trace) -> None:
        with self._lock:
            if trace.decided:
                return
            entry = self._pending.pop(trace.trace_id, None)
            if entry is None:
                # nothing buffered — nothing kept; still COUNTED as a
                # drop so a late errored span's re-open (retained += 1,
                # dropped -= 1) can never push dropped_tail negative
                trace.decided = True
                self.dropped_tail += 1
                return
            # late spans (async egress legs, outbound workers) of a
            # retained trace go straight to the ring; of a dropped one
            # they are discarded — either way, never re-pended
            trace.sampled = self._decide_locked(entry)
            trace.decided = True

    def _decide_locked(self, entry: _PendingTrace) -> bool:
        """Apply the tail retention rule to one pending trace and mark
        its handle decided.  Caller holds ``_lock``."""
        spans = entry.spans
        keep = self.tail_errors and any(s.error for s in spans)
        if not keep and spans and (self.tail_latency_s is not None
                                   or self._anomalies):
            starts = [s.start_s for s in spans]
            ends = [s.start_s + (s.duration_s or 0.0) for s in spans]
            if self.tail_latency_s is not None:
                keep = (max(ends) - min(starts)) >= self.tail_latency_s
            if not keep and self._anomalies:
                # expire stamps whose retention window closed long ago
                horizon = time.time() - 2 * self.tail_anomaly_window_s
                while self._anomalies and self._anomalies[0] < horizon:
                    self._anomalies.popleft()
                # overlap: the trace's span extent intersects
                # [stamp, stamp + window] for any noted anomaly
                window = self.tail_anomaly_window_s
                if any(min(starts) <= ts + window and max(ends) >= ts
                       for ts in self._anomalies):
                    keep = True
                    self.retained_anomaly += 1
        if keep:
            self._spans.extend(spans)
            self.retained_tail += 1
        else:
            self.dropped_tail += 1
        if spans and spans[0].trace is not None:
            spans[0].trace.sampled = keep
            spans[0].trace.decided = True
        return keep

    # -- read side ------------------------------------------------------------

    def recent(self, limit: int = 100) -> List[dict]:
        with self._lock:
            spans = list(self._spans)[-limit:]
        return [s.to_dict() for s in spans]

    def stats(self) -> dict:
        with self._lock:
            buffered = len(self._spans)
            pending = len(self._pending)
        return {
            "sample_rate": self.sample_rate,
            "traces_started": self.started,
            "traces_sampled": self.sampled,
            "traces_joined": self.joined,
            "traces_retained_tail": self.retained_tail,
            "traces_retained_anomaly": self.retained_anomaly,
            "traces_dropped_tail": self.dropped_tail,
            "traces_pending": pending,
            "spans_buffered": buffered,
            "anomalies_noted": self.anomalies_noted,
        }
