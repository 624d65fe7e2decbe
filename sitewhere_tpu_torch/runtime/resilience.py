"""Resilience primitives: retry, breaker, supervisor and dead letters.

Counterpart of the part of ``sitewhere_tpu/runtime/resilience.py`` this
slice runs, reporting through one metrics surface
(:func:`sitewhere_tpu_torch.runtime.metrics.global_registry`):

- :class:`RetryPolicy` — immutable exponential-backoff schedule with
  symmetric jitter, attempt- and deadline-capped.
- :class:`Backoff` — per-instance mutable cursor over a policy (the
  "when may I try again" state a connection keeps).
- :func:`call_with_retry` — run a callable under a policy (the command
  destinations' transient-failure retry); exhausting it raises
  :class:`RetriesExhausted`.
- :class:`CircuitBreaker` — closed/open/half-open with a failure-rate
  threshold over a sliding outcome window; an open breaker SHEDS load
  instead of queueing it unboundedly (the outbound connectors).
- :class:`Supervisor` — restart-with-backoff for worker threads (the
  dispatcher's egress worker), escalating to a terminal failure after N
  consecutive restarts instead of spinning forever.
- :class:`DeadLetterSink` — the protocol every dead-letter target speaks
  (``Journal.append_json`` already satisfies it); :func:`dead_letter`
  records one, and :class:`CollectingSink` is the in-memory one for
  tests and tools.

Metric names (counters):

- ``resilience.retries.<name>`` — retry attempts consumed
- ``resilience.breaker.<name>.to_<state>`` — breaker transitions
- ``resilience.breaker.<name>.shed`` — calls refused while open
- ``resilience.supervisor.<name>.restarts`` — worker restarts
- ``resilience.supervisor.<name>.escalated`` — terminal give-ups
- ``resilience.dead_letters.<kind>`` — dead-lettered records
"""

from __future__ import annotations

import dataclasses
import logging
import random
import threading
import time
from typing import Callable, List, Optional, Protocol, Tuple, runtime_checkable

from sitewhere_tpu_torch.runtime.metrics import MetricsRegistry, global_registry

logger = logging.getLogger("sitewhere_tpu_torch.resilience")

__all__ = [
    "RetryPolicy",
    "Backoff",
    "call_with_retry",
    "RetriesExhausted",
    "CircuitBreaker",
    "BreakerOpen",
    "Supervisor",
    "DeadLetterSink",
    "dead_letter",
    "CollectingSink",
]


# ---------------------------------------------------------------------------
# retry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff schedule: ``initial_s * factor**attempt``,
    capped at ``max_s`` per delay, ``max_attempts`` retries total, and
    (optionally) a wall-clock ``deadline_s`` across the whole sequence.
    ``jitter`` is a symmetric fraction (0.2 → ±20%) drawn from the rng
    the CALLER owns, so schedules stay reproducible under a seeded rng.
    """

    initial_s: float = 0.1
    max_s: float = 60.0
    factor: float = 2.0
    jitter: float = 0.0
    max_attempts: Optional[int] = None   # None = unbounded attempts
    deadline_s: Optional[float] = None   # None = no wall-clock cap

    def delay(self, attempt: int, rng: Optional[random.Random] = None) -> float:
        """Delay before retry ``attempt`` (0-based)."""
        try:
            d = min(self.initial_s * (self.factor ** attempt), self.max_s)
        except OverflowError:
            # factor**attempt exceeds float range (attempt ~1024 on a
            # long outage with an unbounded cursor): the schedule is
            # saturated at the cap, not an error
            d = self.max_s
        if self.jitter and rng is not None:
            d *= 1.0 + self.jitter * (2.0 * rng.random() - 1.0)
        return max(0.0, d)

    def exhausted(self, attempt: int, started_at: Optional[float] = None,
                  now: Optional[float] = None) -> bool:
        """True when retry ``attempt`` (0-based) may no longer run."""
        if self.max_attempts is not None and attempt >= self.max_attempts:
            return True
        if self.deadline_s is not None and started_at is not None:
            if (now if now is not None else time.monotonic()) \
                    - started_at >= self.deadline_s:
                return True
        return False


class Backoff:
    """Mutable cursor over a :class:`RetryPolicy`: the per-connection /
    per-connector "next retry due at" state.  Thread-safe.
    """

    def __init__(self, policy: RetryPolicy, seed: Optional[int] = None,
                 name: str = "backoff",
                 metrics: Optional[MetricsRegistry] = None):
        self.policy = policy
        self.name = name
        self._rng = random.Random(seed) if seed is not None else None
        self._lock = threading.Lock()
        self._attempt = 0
        self._retry_at = 0.0
        self._started_at: Optional[float] = None
        self._metrics = metrics if metrics is not None else global_registry()

    @property
    def attempt(self) -> int:
        return self._attempt

    def reset(self) -> None:
        """A success: start the schedule over."""
        with self._lock:
            self._attempt = 0
            self._retry_at = 0.0
            self._started_at = None

    def next_delay(self) -> float:
        """Consume one attempt, returning its delay."""
        with self._lock:
            if self._started_at is None:
                self._started_at = time.monotonic()
            d = self.policy.delay(self._attempt, self._rng)
            self._attempt += 1
        self._metrics.counter(f"resilience.retries.{self.name}").inc()
        return d

    def defer(self, now: Optional[float] = None) -> float:
        """Consume one attempt and stamp the not-before time; returns it."""
        d = self.next_delay()
        with self._lock:
            self._retry_at = (now if now is not None
                              else time.monotonic()) + d
            return self._retry_at

    def due(self, now: Optional[float] = None) -> bool:
        with self._lock:
            return (now if now is not None
                    else time.monotonic()) >= self._retry_at

    def remaining(self, now: Optional[float] = None) -> float:
        with self._lock:
            return max(0.0, self._retry_at - (
                now if now is not None else time.monotonic()))

    def exhausted(self, now: Optional[float] = None) -> bool:
        with self._lock:
            return self.policy.exhausted(
                self._attempt, self._started_at, now)


class RetriesExhausted(Exception):
    """``call_with_retry`` ran out of attempts; ``__cause__`` is the last
    underlying failure."""


def call_with_retry(fn: Callable[[], object], policy: RetryPolicy,
                    retry_on: Tuple[type, ...] = (Exception,),
                    name: str = "call",
                    on_retry: Optional[Callable[[int, BaseException], None]] = None,
                    sleep: Callable[[float], None] = time.sleep,
                    seed: Optional[int] = None,
                    metrics: Optional[MetricsRegistry] = None):
    """Run ``fn`` under ``policy``; non-``retry_on`` exceptions propagate
    immediately, exhausting the schedule raises :class:`RetriesExhausted`
    from the last failure.

    ``policy`` must be bounded (``max_attempts`` or ``deadline_s``):
    this call BLOCKS between attempts, so an unbounded schedule against
    a permanently failing target would never return.  Unbounded
    schedules belong to :class:`Backoff` loops that stay interruptible.
    """
    if policy.max_attempts is None and policy.deadline_s is None:
        raise ValueError(
            f"{name}: call_with_retry needs a bounded policy "
            "(set max_attempts or deadline_s)")
    reg = metrics if metrics is not None else global_registry()
    rng = random.Random(seed) if seed is not None else None
    started = time.monotonic()
    attempt = 0
    while True:
        try:
            return fn()
        except retry_on as e:
            if policy.exhausted(attempt, started):
                raise RetriesExhausted(
                    f"{name}: gave up after {attempt + 1} attempts") from e
            reg.counter(f"resilience.retries.{name}").inc()
            if on_retry is not None:
                on_retry(attempt, e)
            sleep(policy.delay(attempt, rng))
            attempt += 1


# ---------------------------------------------------------------------------
# circuit breaker
# ---------------------------------------------------------------------------

class BreakerOpen(Exception):
    """The breaker refused the call — shed, don't queue."""


class CircuitBreaker:
    """Closed / open / half-open breaker over a sliding outcome window.

    - CLOSED: calls flow; once at least ``min_calls`` of the last
      ``window`` outcomes exist and the failure rate reaches
      ``failure_threshold``, trip OPEN.
    - OPEN: every call is shed (``allow()`` False / :meth:`call` raises
      :class:`BreakerOpen`) until ``open_for_s`` elapses, then HALF_OPEN.
    - HALF_OPEN: up to ``half_open_probes`` trial calls pass; a success
      closes the breaker (window cleared), a failure re-opens it.

    Thread-safe; transitions and sheds tick metrics counters.
    """

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, name: str = "breaker", window: int = 32,
                 failure_threshold: float = 0.5, min_calls: int = 8,
                 open_for_s: float = 5.0, half_open_probes: int = 1,
                 clock: Callable[[], float] = time.monotonic,
                 metrics: Optional[MetricsRegistry] = None):
        self.name = name
        self.window = int(window)
        self.failure_threshold = float(failure_threshold)
        self.min_calls = int(min_calls)
        self.open_for_s = float(open_for_s)
        self.half_open_probes = int(half_open_probes)
        self._clock = clock
        self._metrics = metrics if metrics is not None else global_registry()
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._outcomes: List[bool] = []   # True = failure
        self._open_until = 0.0
        self._probes = 0
        self.shed = 0
        self.transitions = 0

    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open_locked()
            return self._state

    def _to(self, state: str) -> None:
        if state == self._state:
            return
        self._state = state
        self.transitions += 1
        self._metrics.counter(
            f"resilience.breaker.{self.name}.to_{state}").inc()
        logger.info("breaker %s -> %s", self.name, state)

    def _maybe_half_open_locked(self) -> None:
        if self._state == self.OPEN and self._clock() >= self._open_until:
            self._to(self.HALF_OPEN)
            self._probes = 0

    def allow(self) -> bool:
        """May one call proceed right now?  A False return IS the
        shedding decision (counted)."""
        with self._lock:
            self._maybe_half_open_locked()
            if self._state == self.CLOSED:
                return True
            if self._state == self.HALF_OPEN \
                    and self._probes < self.half_open_probes:
                self._probes += 1
                return True
            self.shed += 1
        self._metrics.counter(
            f"resilience.breaker.{self.name}.shed").inc()
        return False

    def record_success(self) -> None:
        with self._lock:
            if self._state == self.HALF_OPEN:
                self._to(self.CLOSED)
                self._outcomes = []
            elif self._state == self.CLOSED:
                self._push_locked(False)

    def record_failure(self) -> None:
        with self._lock:
            if self._state == self.HALF_OPEN:
                self._trip_locked()
                return
            if self._state != self.CLOSED:
                return
            self._push_locked(True)
            n = len(self._outcomes)
            if n >= self.min_calls \
                    and sum(self._outcomes) / n >= self.failure_threshold:
                self._trip_locked()

    def _push_locked(self, failed: bool) -> None:
        self._outcomes.append(failed)
        if len(self._outcomes) > self.window:
            del self._outcomes[0]

    def _trip_locked(self) -> None:
        self._to(self.OPEN)
        self._open_until = self._clock() + self.open_for_s
        self._outcomes = []

    def call(self, fn: Callable[[], object], *args, **kwargs):
        """Gate + record one call; raises :class:`BreakerOpen` when shed."""
        if not self.allow():
            raise BreakerOpen(self.name)
        try:
            out = fn(*args, **kwargs)
        except Exception:
            self.record_failure()
            raise
        self.record_success()
        return out


# ---------------------------------------------------------------------------
# supervisor
# ---------------------------------------------------------------------------

class Supervisor:
    """Restart-with-backoff for a worker thread.

    ``run`` is the worker body: returning normally is a clean exit (no
    restart); raising restarts it after the policy's backoff.  A worker
    that stays up at least ``min_uptime_s`` resets the consecutive-failure
    count, so a long-lived receiver that hiccups twice a day never
    escalates.  After ``max_restarts`` CONSECUTIVE failures the supervisor
    gives up: a terminal log line + ``escalated`` metric +
    ``on_escalate(exc)`` — it must stop, not spin forever.
    """

    def __init__(self, name: str, run: Callable[[], None],
                 policy: Optional[RetryPolicy] = None,
                 max_restarts: int = 8,
                 min_uptime_s: float = 5.0,
                 on_escalate: Optional[Callable[[BaseException], None]] = None,
                 on_restart: Optional[Callable[[BaseException], None]] = None,
                 seed: Optional[int] = None,
                 metrics: Optional[MetricsRegistry] = None):
        self.name = name
        self.run = run
        # observability hook: called (with the exception) on every crash
        # that leads to a restart — the flight recorder's
        # supervisor-restart anomaly trigger rides this
        self.on_restart = on_restart
        self.policy = policy if policy is not None else RetryPolicy(
            initial_s=0.1, max_s=30.0)
        self.max_restarts = int(max_restarts)
        self.min_uptime_s = float(min_uptime_s)
        self.on_escalate = on_escalate
        self._rng = random.Random(seed) if seed is not None else None
        self._metrics = metrics if metrics is not None else global_registry()
        self.stopping = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.restarts = 0
        self.escalated = False
        self.last_error: Optional[BaseException] = None
        # restart delays actually slept — observability for backoff tests
        self.restart_delays: List[float] = []

    def start(self) -> None:
        self.stopping.clear()
        self._thread = threading.Thread(
            target=self._supervise, daemon=True,
            name=f"supervised-{self.name}")
        self._thread.start()

    def stop(self, timeout_s: float = 5.0) -> None:
        self.stopping.set()
        t = self._thread
        if t is not None:
            t.join(timeout=timeout_s)
            self._thread = None

    @property
    def alive(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def _supervise(self) -> None:
        consecutive = 0
        while not self.stopping.is_set():
            t0 = time.monotonic()
            try:
                self.run()
                return   # clean exit
            except Exception as e:   # noqa: BLE001 — supervision boundary
                if self.stopping.is_set():
                    return
                self.last_error = e
                if time.monotonic() - t0 >= self.min_uptime_s:
                    consecutive = 0   # it WAS healthy; fresh schedule
                consecutive += 1
                if consecutive > self.max_restarts:
                    self.escalated = True
                    self._metrics.counter(
                        f"resilience.supervisor.{self.name}.escalated").inc()
                    logger.error(
                        "supervisor %s: giving up after %d consecutive "
                        "failures (terminal): %s",
                        self.name, consecutive, e)
                    if self.on_escalate is not None:
                        try:
                            self.on_escalate(e)
                        except Exception:
                            logger.exception(
                                "supervisor %s escalation hook failed",
                                self.name)
                    return
                self.restarts += 1
                self._metrics.counter(
                    f"resilience.supervisor.{self.name}.restarts").inc()
                if self.on_restart is not None:
                    try:
                        self.on_restart(e)
                    except Exception:
                        logger.exception(
                            "supervisor %s restart hook failed", self.name)
                delay = self.policy.delay(consecutive - 1, self._rng)
                self.restart_delays.append(delay)
                logger.warning(
                    "supervisor %s: worker died (%s); restart %d/%d in "
                    "%.3fs", self.name, e, consecutive, self.max_restarts,
                    delay)
                self.stopping.wait(delay)


# ---------------------------------------------------------------------------
# dead letters
# ---------------------------------------------------------------------------

@runtime_checkable
class DeadLetterSink(Protocol):
    """What every dead-letter target speaks —
    :class:`sitewhere_tpu_torch.ingest.journal.Journal` satisfies it natively."""

    def append_json(self, doc: dict) -> int: ...


def dead_letter(sink: Optional[DeadLetterSink], doc: dict,
                metrics: Optional[MetricsRegistry] = None) -> bool:
    """Record one dead-letter (best-effort: a broken sink is logged, never
    raised into the caller's data path) and tick the unified counters.

    The counters report records actually RECORDED: with no sink
    configured the counter is the only trace and ticks anyway, but a
    configured sink that fails ticks ``sink_errors`` instead — the
    dead-letter totals must never claim records that exist nowhere.
    """
    reg = metrics if metrics is not None else global_registry()
    kind = str(doc.get("kind", "unknown"))
    if sink is not None:
        try:
            sink.append_json(doc)
        except Exception:
            logger.exception("dead-letter sink failed for kind %s", kind)
            reg.counter("resilience.dead_letters.sink_errors").inc()
            return False
    reg.counter("resilience.dead_letters").inc()
    reg.counter(f"resilience.dead_letters.{kind}").inc()
    return sink is not None


class CollectingSink:
    """In-memory :class:`DeadLetterSink` for tests and tooling."""

    def __init__(self):
        self.records: List[dict] = []
        self._lock = threading.Lock()

    def append_json(self, doc: dict) -> int:
        with self._lock:
            self.records.append(doc)
            return len(self.records) - 1

    def __len__(self) -> int:
        with self._lock:
            return len(self.records)
