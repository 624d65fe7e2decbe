"""Overload control: watermark-driven admission, priority shedding, and a
graceful-degradation ladder.

Counterpart of ``sitewhere_tpu/runtime/overload.py``, copied whole with
the imports renamed; the port's dispatcher admits at its wire entry
points and its ``Instance`` wires the signals.

Stream-platform comparisons show the throughput cliff under sustained
overload is an architecture property, not a tuning one (HarmonicIO vs
Kafka vs Spark, arXiv:1807.07724), and enrichment-stage cost dominates
exactly when load spikes (arXiv:2307.14287).  Before this module the
pipeline had no behavior *between* "keeping up" and "bounded queues
full, every receiver stalled": alert events queued behind telemetry,
decode lanes backed up into broker redelivery storms, and p99 collapsed
for every traffic class at once.

:class:`OverloadController` is an explicit overload state machine

    NORMAL → DEGRADED → SHEDDING → EMERGENCY

driven by signals the system already exports (ingest→seal watermark
lag, decode-pool and egress in-flight depth, batcher backlog, journal
fsync latency — :class:`OverloadSignals`), with per-signal high
watermarks (:class:`Watermarks`), hysteresis on the way down (exit
thresholds are the enter thresholds scaled by ``hysteresis``), and a
cooldown: de-escalation happens only after the signals have stayed
below the exit watermarks for ``cooldown_s`` continuously, and then
drops straight to the level the signals justify — recovery completes
within ONE cooldown of the load dropping, never a multi-step crawl.

Three layers hang off the state:

1. **Admission control at ingest** (:meth:`OverloadController.admit`):
   per-(tenant, source) token buckets with priority classes.
   :data:`PriorityClass.CRITICAL` (alerts, command responses) is NEVER
   shed — not even in EMERGENCY; COMMAND (invocations) sheds only in
   EMERGENCY; TELEMETRY (measurements, locations) sheds first — rate
   limited in DEGRADED, refused in SHEDDING+.  A refusal is surfaced to
   the transport as :class:`OverloadShed` so shed ≠ silent drop: hosted
   MQTT withholds the PUBACK and pauses reads, HTTP answers 429 +
   ``Retry-After``, CoAP answers 5.03 with ``Max-Age``, STOMP leaves
   the MESSAGE unacked and AMQP nacks with requeue after a pacing
   pause — broker redelivery either way.  Shed intake is
   additionally dead-lettered (kind ``intake-shed``, with reason +
   class + payload) so shedding is auditable and replayable.
2. **A degradation ladder downstream**: optional work (analytics,
   label generation, outbound search indexing) switches off in
   DEGRADED (:meth:`allow_optional`); non-priority outbound fan-out
   sheds in SHEDDING (:meth:`allow_fanout`).  Journal append, seal and
   checkpoint are NEVER gated here — the fail-closed durability
   contract is preserved in every state.
3. **Observability**: ``overload.state`` gauge, per-class/per-tenant
   shed counters, an ``overload.shed_rows`` histogram whose exemplars
   link back to the trace of the state transition that armed the
   shedding, and every transition recorded as a span
   (``overload.transition``) plus dwell-time histogram.

Determinism: the controller takes an injectable ``clock`` and is driven
by explicit :meth:`observe` calls (the dispatcher loop ticks it), so
chaos tests verify hysteresis and cooldown with a fake clock —
bit-identical runs, no sleeps.
"""

from __future__ import annotations

import dataclasses
import enum
import logging
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from sitewhere_tpu_torch.runtime.metrics import MetricsRegistry, global_registry

logger = logging.getLogger("sitewhere_tpu_torch.overload")

__all__ = [
    "OverloadState",
    "PriorityClass",
    "classify_event_type",
    "OverloadShed",
    "OverloadSignals",
    "Watermarks",
    "TokenBucket",
    "TenantBudgets",
    "OverloadController",
]


class OverloadState(enum.IntEnum):
    """The overload ladder, ordered by severity."""

    NORMAL = 0
    DEGRADED = 1     # optional work off; telemetry rate-limited
    SHEDDING = 2     # telemetry refused; non-priority fan-out shed
    EMERGENCY = 3    # everything but CRITICAL refused


class PriorityClass(enum.IntEnum):
    """Intake priority, ordered by shed precedence (higher sheds first)."""

    CRITICAL = 0     # alerts, command responses: never shed
    COMMAND = 1      # command invocations: shed only in EMERGENCY
    TELEMETRY = 2    # measurements, locations: shed first


# EventType value → PriorityClass (EventType is a dense IntEnum 0..4:
# MEASUREMENT, LOCATION, ALERT, COMMAND_INVOCATION, COMMAND_RESPONSE).
# Kept as a plain tuple so the wire path can classify a whole column
# with one fancy-index instead of a per-row enum dance.
CLASS_OF_EVENT_TYPE: Tuple[PriorityClass, ...] = (
    PriorityClass.TELEMETRY,   # MEASUREMENT
    PriorityClass.TELEMETRY,   # LOCATION
    PriorityClass.CRITICAL,    # ALERT
    PriorityClass.COMMAND,     # COMMAND_INVOCATION
    PriorityClass.CRITICAL,    # COMMAND_RESPONSE
)


def classify_event_type(event_type: int) -> PriorityClass:
    """Priority class of one EventType value (unknown values — future
    types, derived STATE_CHANGE rows — default to COMMAND: shed late,
    but not never)."""
    if 0 <= event_type < len(CLASS_OF_EVENT_TYPE):
        return CLASS_OF_EVENT_TYPE[event_type]
    return PriorityClass.COMMAND


class OverloadShed(Exception):
    """An intake payload was refused by admission control.

    Receivers translate this into their protocol's native backpressure
    signal (429 + Retry-After, CoAP 5.03 + Max-Age, withheld
    PUBACK, unacked broker message) — it must never surface as a
    silent drop or be confused with a decode failure.
    """

    def __init__(self, priority_class: PriorityClass,
                 state: OverloadState, retry_after_s: float = 1.0,
                 reason: str = ""):
        self.priority_class = priority_class
        self.state = state
        self.retry_after_s = float(retry_after_s)
        self.reason = reason or (
            f"{priority_class.name.lower()} shed in {state.name}")
        super().__init__(self.reason)


@dataclasses.dataclass
class OverloadSignals:
    """One sample of the pressure signals the controller watches.

    Backlog/depth signals are FRACTIONS of their bound (0 = idle,
    1 = at the bound; egress may exceed 1 past a stall overflow),
    latency signals are seconds.
    """

    seal_lag_s: float = 0.0        # ingest→seal watermark lag
    decode_backlog: float = 0.0    # decode-pool pending / max_pending
    egress_inflight: float = 0.0   # in-flight window depth / bound
    batcher_backlog: float = 0.0   # batcher pending rows / width
    fsync_latency_s: float = 0.0   # last journal fsync duration

    def as_dict(self) -> Dict[str, float]:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class Watermarks:
    """Per-signal (DEGRADED, SHEDDING, EMERGENCY) enter thresholds.

    A signal at or above its level-N threshold votes for level N; the
    controller escalates to the MAX vote across signals.  Exit
    thresholds are these scaled by the controller's ``hysteresis``.
    """

    seal_lag_s: Tuple[float, float, float] = (0.10, 0.50, 2.0)
    decode_backlog: Tuple[float, float, float] = (0.50, 0.80, 0.95)
    egress_inflight: Tuple[float, float, float] = (0.75, 1.00, 1.50)
    batcher_backlog: Tuple[float, float, float] = (1.00, 4.00, 16.0)
    fsync_latency_s: Tuple[float, float, float] = (0.05, 0.20, 1.0)

    def level(self, signals: OverloadSignals,
              scale: float = 1.0) -> Tuple[int, str]:
        """Severity the signals justify (0..3) + the driving signal.
        ``scale`` < 1 evaluates against lowered (exit) thresholds."""
        worst, driver = 0, ""
        for name, thresholds in dataclasses.asdict(self).items():
            value = getattr(signals, name)
            lvl = 0
            for i, bound in enumerate(thresholds):
                if value >= bound * scale:
                    lvl = i + 1
            if lvl > worst:
                worst, driver = lvl, name
        return worst, driver

    def replace(self, overrides: Dict[str, object]) -> "Watermarks":
        """New Watermarks with config overrides (name → [d, s, e])."""
        fields = {}
        for name, bounds in (overrides or {}).items():
            if not hasattr(self, name):
                raise ValueError(f"unknown overload signal {name!r}")
            seq = tuple(float(b) for b in bounds)
            if len(seq) != 3 or sorted(seq) != list(seq):
                raise ValueError(
                    f"watermarks for {name!r} must be 3 ascending bounds")
            fields[name] = seq
        return dataclasses.replace(self, **fields)


class TokenBucket:
    """Classic token bucket; thread-safe, injectable clock."""

    def __init__(self, rate_per_s: float, burst: float,
                 clock: Callable[[], float] = time.monotonic):
        self.rate_per_s = float(rate_per_s)
        self.burst = float(burst)
        self._clock = clock
        self._tokens = self.burst
        self._at = clock()
        self._lock = threading.Lock()

    def set_rate(self, rate_per_s: float, burst: float) -> None:
        """Re-derive the bucket's rate IN PLACE (the budget-refresh
        path): accrued tokens clamp to the new burst — a tightened
        budget takes effect immediately, and a loosened one never
        grants a fresh full burst mid-episode."""
        with self._lock:
            self.rate_per_s = float(rate_per_s)
            self.burst = float(burst)
            self._tokens = min(self._tokens, self.burst)

    def try_take(self, n: float = 1.0,
                 now: Optional[float] = None) -> bool:
        now = self._clock() if now is None else now
        with self._lock:
            self._tokens = min(
                self.burst,
                self._tokens + (now - self._at) * self.rate_per_s)
            self._at = now
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False


class TenantBudgets:
    """Configured per-tenant overload budget overlays.

    Parsed from ``tenants.<token>.overload.*`` config sections (the
    per-tenant overlay namespace): a tenant may carry an
    explicit ``degraded_telemetry_rate_per_s`` / ``_burst`` ceiling.
    The controller COMPOSES this with the measured-share scaling from
    the usage ledger — the effective DEGRADED telemetry rate is

        min(configured budget, uniform rate × measured rate_scale)

    so a configured budget can only ever TIGHTEN a tenant's budget,
    never exempt it from fairness, and a tenant without an overlay is
    governed purely by measurement.  The fairness floor holds by
    construction: a quiet tenant (share ≤ fair_share_frac) has
    rate_scale 1.0 and no overlay, so its admitted rate never drops
    below the uniform budget while a noisy neighbor is clipped.
    """

    def __init__(self):
        self._budgets: Dict[str, Tuple[Optional[float],
                                       Optional[float]]] = {}

    def set_budget(self, tenant: str,
                   rate_per_s: Optional[float] = None,
                   burst: Optional[float] = None) -> None:
        if rate_per_s is None and burst is None:
            self._budgets.pop(tenant, None)
            return
        self._budgets[tenant] = (
            None if rate_per_s is None else float(rate_per_s),
            None if burst is None else float(burst))

    def get(self, tenant: str) -> Optional[Tuple[Optional[float],
                                                 Optional[float]]]:
        return self._budgets.get(tenant)

    def overlay(self, tenant: str) -> Optional[Dict[str, float]]:
        """REST drill-down form of one tenant's configured budget."""
        got = self._budgets.get(tenant)
        if got is None:
            return None
        out: Dict[str, float] = {}
        if got[0] is not None:
            out["degraded_telemetry_rate_per_s"] = got[0]
        if got[1] is not None:
            out["degraded_telemetry_burst"] = got[1]
        return out

    @classmethod
    def from_config(cls, tenants_cfg) -> "TenantBudgets":
        """Build from the ``tenants`` config mapping
        (``{token: {"overload": {...}}, ...}``)."""
        budgets = cls()
        if not isinstance(tenants_cfg, dict):
            return budgets
        for token, overlay in tenants_cfg.items():
            if not isinstance(overlay, dict):
                continue
            ov = overlay.get("overload")
            if not isinstance(ov, dict):
                continue
            rate = ov.get("degraded_telemetry_rate_per_s")
            burst = ov.get("degraded_telemetry_burst")
            if rate is not None or burst is not None:
                budgets.set_budget(
                    str(token),
                    None if rate is None else float(rate),
                    None if burst is None else float(burst))
        return budgets

    def __len__(self) -> int:
        return len(self._budgets)


class OverloadController:
    """The overload state machine + admission gate (module docstring).

    Thread-safe: ``admit`` runs on receiver/ingest threads while
    ``tick``/``observe`` run on the dispatcher loop.  All state reads
    are a single attribute load; transitions hold ``_lock``.
    """

    def __init__(
        self,
        watermarks: Optional[Watermarks] = None,
        cooldown_s: float = 2.0,
        hysteresis: float = 0.7,
        confirm_samples: int = 1,
        sample_interval_s: float = 0.1,
        retry_after_s: float = 1.0,
        degraded_telemetry_rate_per_s: float = 10_000.0,
        degraded_telemetry_burst: float = 20_000.0,
        shedding_command_rate_per_s: float = 1_000.0,
        shedding_command_burst: float = 2_000.0,
        budget_refresh_s: float = 5.0,
        signals_fn: Optional[Callable[[], OverloadSignals]] = None,
        clock: Callable[[], float] = time.monotonic,
        metrics: Optional[MetricsRegistry] = None,
        tracer=None,
        name: str = "overload",
    ):
        self.name = name
        self.watermarks = watermarks or Watermarks()
        self.cooldown_s = float(cooldown_s)
        if not 0.0 < hysteresis <= 1.0:
            raise ValueError("hysteresis must be in (0, 1]")
        self.hysteresis = float(hysteresis)
        # Escalation confirmation: the enter watermark must hold for
        # this many CONSECUTIVE samples before the state moves up — a
        # single slow plan (a jit compile, one disk stall) briefly
        # pinning a last-value gauge is a spike, not sustained
        # overload.  1 = escalate on the first sample (the
        # deterministic-test default); production wires 2+ so real
        # overload escalates within confirm_samples × sample_interval.
        self.confirm_samples = max(1, int(confirm_samples))
        self.sample_interval_s = float(sample_interval_s)
        self.base_retry_after_s = float(retry_after_s)
        self.degraded_telemetry_rate_per_s = float(
            degraded_telemetry_rate_per_s)
        self.degraded_telemetry_burst = float(degraded_telemetry_burst)
        self.shedding_command_rate_per_s = float(shedding_command_rate_per_s)
        self.shedding_command_burst = float(shedding_command_burst)
        self.signals_fn = signals_fn
        self._clock = clock
        self._metrics = metrics if metrics is not None else global_registry()
        if tracer is None:
            from sitewhere_tpu_torch.runtime.tracing import Tracer

            tracer = Tracer(sample_rate=0.0)
        self.tracer = tracer
        self._lock = threading.Lock()
        self._state = OverloadState.NORMAL
        self._entered_at = clock()
        self._below_since: Optional[float] = None
        self._escalate_level = 0      # pending escalation target...
        self._escalate_count = 0      # ...and its consecutive samples
        self._last_sample = float("-inf")
        self.last_signals = OverloadSignals()
        self.last_driver = ""
        self.transitions = 0
        self.shed_total = 0
        self.admitted_total = 0
        # per-(tenant, source) buckets, lazily built per state tier and
        # bounded so hostile tenant/source cardinality can't grow memory
        self._buckets: Dict[Tuple[str, str, int], TokenBucket] = {}
        self._listeners: List[Callable[[OverloadState, OverloadState,
                                        OverloadSignals], None]] = []
        # trace id of the transition that armed the current state — the
        # exemplar shed observations link back to
        self._transition_trace_id: Optional[str] = None
        self._m_state = self._metrics.gauge("overload.state")
        self._m_state.set(0)
        self._m_dwell = self._metrics.histogram("overload.state_dwell_s")
        self._m_shed_rows = self._metrics.histogram(
            "overload.shed_rows", buckets=(1, 2, 4, 8, 16, 32, 64, 128,
                                           256, 1024, 4096))
        self._m_shed_class = {
            cls: self._metrics.counter(f"overload.shed.{cls.name.lower()}")
            for cls in PriorityClass
        }
        # per-tenant shed counters, cached + cardinality-bounded: the
        # tenant string comes from request metadata, so a hostile
        # client could otherwise mint unbounded Counter objects (and a
        # registry lock + name-sanitize on the hottest path of an
        # already-overloaded system); overflow tenants aggregate under
        # ``tenant.shed.other`` (the governed tenant.* family)
        self._tenant_counters: Dict[str, object] = {}
        self._m_shed_other = self._metrics.counter("tenant.shed.other")
        # Tenant metering plane (runtime/metering.py, set_usage_ledger):
        # sheds charge the ledger per tenant, and DEGRADED telemetry
        # buckets derive their rate from the tenant's MEASURED share of
        # the windowed row stream instead of the uniform budget.
        self.usage_ledger = None
        self._ledger_resolve: Optional[Callable[[str], int]] = None
        # Configured per-tenant budget overlays (TenantBudgets): the
        # effective DEGRADED telemetry rate composes min(configured,
        # uniform × measured rate_scale).  Buckets record whether the
        # CONFIGURED overlay was the binding constraint (budget_bound)
        # — that flag routes sheds to the `tenant-budget` dead-letter
        # kind instead of the generic `intake-shed`.  Stale buckets
        # re-derive their rate in place every budget_refresh_s so a
        # share measured at episode start cannot pin a recovered
        # tenant's rate for a whole long episode.
        self.tenant_budgets = TenantBudgets()
        self.budget_refresh_s = float(budget_refresh_s)
        self._m_budget_clipped = self._metrics.counter(
            "tenant.budget.clipped_rows")

    def set_tenant_budgets(self, budgets: TenantBudgets) -> None:
        """Install the configured per-tenant budget overlay table
        (parsed from ``tenants.<token>.overload.*`` by the instance)."""
        self.tenant_budgets = budgets

    def set_usage_ledger(self, ledger,
                         resolve: Optional[Callable[[str], int]] = None
                         ) -> None:
        """Attach the tenant metering plane: ``ledger`` is a
        :class:`~sitewhere_tpu_torch.runtime.metering.UsageLedger`, ``resolve``
        maps the intake's tenant TOKEN to the dense id the ledger bills
        (the instance passes its identity mint).  From then on DEGRADED
        telemetry budgets scale by the tenant's measured share
        (:meth:`UsageLedger.rate_scale`) and every shed charges
        ``shed_rows`` to its tenant."""
        self.usage_ledger = ledger
        self._ledger_resolve = resolve

    def _tenant_id(self, tenant: str) -> Optional[int]:
        if self._ledger_resolve is None:
            return None
        try:
            return int(self._ledger_resolve(tenant))
        except Exception:
            return None

    # -- state machine -------------------------------------------------------

    @property
    def state(self) -> OverloadState:
        return self._state

    def on_transition(self, cb: Callable[..., None]) -> None:
        """Register ``cb(old, new, signals)`` for every transition."""
        self._listeners.append(cb)

    def tick(self, now: Optional[float] = None) -> OverloadState:
        """Sample the wired signals (rate-limited to
        ``sample_interval_s``) and run one evaluation.  The dispatcher
        loop calls this every cycle; it is cheap when not due."""
        if self.signals_fn is None:
            return self._state
        now = self._clock() if now is None else now
        if now - self._last_sample < self.sample_interval_s:
            return self._state
        self._last_sample = now
        try:
            signals = self.signals_fn()
        except Exception:
            logger.exception("overload signal sampling failed")
            return self._state
        return self.observe(signals, now)

    def observe(self, signals: OverloadSignals,
                now: Optional[float] = None) -> OverloadState:
        """Evaluate one signal sample; escalate immediately, de-escalate
        after ``cooldown_s`` below the (hysteresis-scaled) exit
        watermarks — straight to the justified level, so recovery takes
        one cooldown, not one per rung."""
        now = self._clock() if now is None else now
        with self._lock:
            self.last_signals = signals
            enter_level, enter_driver = self.watermarks.level(signals)
            if enter_level > self._state:
                # signals sit above the current state's watermark: any
                # de-escalation cooldown in progress restarts NOW —
                # "continuous calm" is the documented contract
                self._below_since = None
                # confirmation: an above-state level must hold for
                # confirm_samples consecutive observations before the
                # ladder moves — one stale-gauge spike must not jump
                # it.  The pending target tracks the MINIMUM level the
                # streak has sustained, so a noisy signal flapping
                # across a boundary (1,2,1,2,…) still escalates to the
                # level every sample justified instead of resetting
                # the count forever.
                if self._escalate_count == 0:
                    self._escalate_level = enter_level
                else:
                    self._escalate_level = min(self._escalate_level,
                                               enter_level)
                self._escalate_count += 1
                if self._escalate_count >= self.confirm_samples:
                    target = OverloadState(self._escalate_level)
                    self._escalate_level = 0
                    self._escalate_count = 0
                    self.last_driver = enter_driver
                    self._transition_locked(target, signals, now,
                                            enter_driver)
                return self._state
            self._escalate_level = 0
            self._escalate_count = 0
            exit_level, _ = self.watermarks.level(
                signals, scale=self.hysteresis)
            if exit_level < self._state:
                if self._below_since is None:
                    self._below_since = now
                elif now - self._below_since >= self.cooldown_s:
                    self._transition_locked(
                        OverloadState(exit_level), signals, now,
                        "cooldown")
            else:
                # still above an exit watermark: the cooldown restarts
                self._below_since = None
            return self._state

    def force(self, state: OverloadState, reason: str = "forced") -> None:
        """Ops/test hook: pin the state (the next observe may move it)."""
        with self._lock:
            self._transition_locked(OverloadState(state), self.last_signals,
                                    self._clock(), reason)

    def _transition_locked(self, new: OverloadState,
                           signals: OverloadSignals, now: float,
                           driver: str) -> None:
        old = self._state
        if new == old:
            return
        dwell = max(0.0, now - self._entered_at)
        self._state = new
        # every transition records its driver — forced moves (ops hooks,
        # the device breaker's DEGRADED ride-along) must be attributable
        # and releasable by the same check the observe path uses
        self.last_driver = driver
        self._entered_at = now
        self._below_since = None
        self.transitions += 1
        self._m_state.set(int(new))
        self._metrics.counter(
            f"overload.transitions.to_{new.name.lower()}").inc()
        # fresh buckets per episode: a tenant that burned its budget in
        # the last overload starts the new one with a full burst
        if new == OverloadState.NORMAL:
            self._buckets.clear()
        # the transition as a span: operators see WHEN the ladder moved
        # and WHICH signal drove it, in the same place as pipeline spans
        trace = self.tracer.trace("overload.transition")
        with trace.span(
                f"overload.{old.name.lower()}_to_{new.name.lower()}") as sp:
            sp.tag("from", old.name)
            sp.tag("to", new.name)
            sp.tag("driver", driver)
            for key, value in signals.as_dict().items():
                sp.tag(key, round(float(value), 4))
        trace.end()
        # tail-sampling anomaly stamp: every trace overlapping this
        # transition's window is retained, not only the errored/slow —
        # the batches surrounding a ladder move ARE the evidence
        note = getattr(self.tracer, "note_anomaly", None)
        if note is not None:
            note()
        self._transition_trace_id = (
            trace.trace_id if getattr(trace, "sampled", False) else None)
        self._m_dwell.observe(dwell, trace_id=self._transition_trace_id)
        logger.warning("overload %s -> %s (driver=%s, dwell=%.2fs)",
                       old.name, new.name, driver, dwell)
        for cb in self._listeners:
            try:
                cb(old, new, signals)
            except Exception:
                logger.exception("overload transition listener failed")

    # -- admission -----------------------------------------------------------

    def _telemetry_rate(self, tenant: str) -> Tuple[float, float, bool]:
        """Effective DEGRADED telemetry (rate, burst, budget_bound) for
        one tenant: ``min(configured budget, uniform × measured
        rate_scale)`` per component.  ``budget_bound`` is True when the
        CONFIGURED overlay is the binding constraint on the rate — the
        flag that routes that tenant's sheds to the ``tenant-budget``
        dead-letter kind."""
        rate = self.degraded_telemetry_rate_per_s
        burst = self.degraded_telemetry_burst
        # Measured-share scaling (tenant metering plane): a tenant above
        # its fair share of the windowed row stream gets a
        # proportionally tighter DEGRADED budget; a quiet tenant keeps
        # the full uniform one.
        if self.usage_ledger is not None:
            tid = self._tenant_id(tenant)
            if tid is not None:
                try:
                    scale = self.usage_ledger.rate_scale(tid)
                except Exception:
                    scale = 1.0
                rate *= scale
                burst *= scale
        budget_bound = False
        configured = self.tenant_budgets.get(tenant)
        if configured is not None:
            c_rate, c_burst = configured
            if c_rate is not None and c_rate < rate:
                rate = c_rate
                budget_bound = True
            if c_burst is not None and c_burst < burst:
                burst = c_burst
                budget_bound = True
        return rate, burst, budget_bound

    def _bucket(self, tenant: str, source: str, cls: PriorityClass,
                now: Optional[float] = None) -> TokenBucket:
        key = (tenant, source, int(cls))
        now = self._clock() if now is None else now
        bucket = self._buckets.get(key)
        if bucket is None:
            if len(self._buckets) >= 1024:
                self._buckets.clear()   # cardinality bound, not fairness
            if cls == PriorityClass.TELEMETRY:
                # composed budget, sampled at bucket build — buckets
                # clear on the NORMAL transition, so each overload
                # episode re-derives its rates from the share measured
                # as it begins (and refreshes below while it runs)
                rate, burst, budget_bound = self._telemetry_rate(tenant)
            else:
                rate = self.shedding_command_rate_per_s
                burst = self.shedding_command_burst
                budget_bound = False
            bucket = TokenBucket(rate, burst, clock=self._clock)
            bucket.budget_bound = budget_bound
            bucket.built_at = now
            self._buckets[key] = bucket
        elif (cls == PriorityClass.TELEMETRY
              and now - getattr(bucket, "built_at", now)
              >= self.budget_refresh_s):
            # stale-budget refresh: re-derive the composed rate IN
            # PLACE (tokens clamp to the new burst — no fresh-burst
            # exploit) so a share that shifted mid-episode, or an
            # operator budget change, takes effect within
            # budget_refresh_s instead of at the next episode
            rate, burst, budget_bound = self._telemetry_rate(tenant)
            bucket.set_rate(rate, burst)
            bucket.budget_bound = budget_bound
            bucket.built_at = now
        return bucket

    def admit(self, cls: PriorityClass, tenant: str = "default",
              source: str = "", n: int = 1,
              now: Optional[float] = None) -> bool:
        """May ``n`` events of ``cls`` from (tenant, source) enter the
        pipeline right now?  A False return IS the shedding decision —
        counted per class and per tenant; the caller must surface it as
        protocol-native backpressure (raise :class:`OverloadShed`) and
        dead-letter the payload for audit/replay.

        Shed order: CRITICAL is always admitted; TELEMETRY is
        rate-limited per (tenant, source) in DEGRADED and refused from
        SHEDDING; COMMAND is rate-limited in SHEDDING and refused only
        in EMERGENCY.
        """
        return self.admit_detail(cls, tenant, source, n, now)[0]

    def admit_detail(self, cls: PriorityClass, tenant: str = "default",
                     source: str = "", n: int = 1,
                     now: Optional[float] = None) -> Tuple[bool, str]:
        """:meth:`admit` plus the shed attribution: ``(ok, reason)``
        where reason is ``""`` on admit, ``"budget"`` when the refusal
        came from a bucket whose rate the tenant's CONFIGURED budget
        overlay bound (the dispatcher dead-letters those under the
        replayable ``tenant-budget`` kind), and ``"overload"`` for
        every other shed (state refusal or measured-share clip)."""
        state = self._state
        if cls == PriorityClass.CRITICAL or state == OverloadState.NORMAL:
            self.admitted_total += n
            return True, ""
        if cls == PriorityClass.TELEMETRY:
            if state >= OverloadState.SHEDDING:
                return self._shed(cls, tenant, n), "overload"
            bucket = self._bucket(tenant, source, cls, now)
            ok = bucket.try_take(n, now)
        else:   # COMMAND
            if state >= OverloadState.EMERGENCY:
                return self._shed(cls, tenant, n), "overload"
            if state < OverloadState.SHEDDING:
                self.admitted_total += n
                return True, ""
            bucket = self._bucket(tenant, source, cls, now)
            ok = bucket.try_take(n, now)
        if not ok:
            if getattr(bucket, "budget_bound", False):
                self._m_budget_clipped.inc(n)
                return self._shed(cls, tenant, n), "budget"
            return self._shed(cls, tenant, n), "overload"
        self.admitted_total += n
        return True, ""

    def _shed(self, cls: PriorityClass, tenant: str, n: int) -> bool:
        self.shed_total += n
        self._m_shed_class[cls].inc(n)
        counter = self._tenant_counters.get(tenant)
        if counter is None:
            if len(self._tenant_counters) < 64:
                counter = self._metrics.counter(f"tenant.shed.{tenant}")
                self._tenant_counters[tenant] = counter
            else:
                counter = self._m_shed_other
        counter.inc(n)
        if self.usage_ledger is not None:
            tid = self._tenant_id(tenant)
            if tid is not None:
                try:
                    self.usage_ledger.charge(tid, "shed_rows", n)
                except Exception:
                    logger.exception("usage ledger shed charge failed")
        self._m_shed_rows.observe(n, trace_id=self._transition_trace_id)
        return False

    def shed_exception(self, cls: PriorityClass,
                       reason: str = "") -> OverloadShed:
        """The exception an intake path raises after ``admit`` refused —
        carries the state + Retry-After hint the transports encode."""
        return OverloadShed(cls, self._state, self.retry_after(), reason)

    def retry_after(self) -> float:
        """Backpressure hint (seconds) for 429 Retry-After / CoAP
        Max-Age: scales with severity so clients back off harder the
        deeper the overload."""
        return self.base_retry_after_s * max(1, int(self._state))

    # -- degradation ladder --------------------------------------------------

    def allow_optional(self, feature: str = "") -> bool:
        """Optional work (analytics, label generation, outbound search
        indexing): switched OFF from DEGRADED up."""
        if self._state >= OverloadState.DEGRADED:
            self._metrics.counter("overload.optional_refused").inc()
            return False
        return True

    def allow_fanout(self, priority: bool = False) -> bool:
        """Outbound fan-out: non-priority connectors shed from SHEDDING
        up; priority connectors always flow."""
        if priority:
            return True
        if self._state >= OverloadState.SHEDDING:
            self._metrics.counter("overload.fanout_shed").inc()
            return False
        return True

    # -- introspection -------------------------------------------------------

    def snapshot(self) -> dict:
        """Admin-surface view (instance topology folds this in)."""
        return {
            "state": self._state.name,
            "since_s": round(max(0.0, self._clock() - self._entered_at), 3),
            "transitions": self.transitions,
            "shed_total": self.shed_total,
            "admitted_total": self.admitted_total,
            "driver": self.last_driver,
            "tenant_budgets": len(self.tenant_budgets),
            "signals": {k: round(v, 4)
                        for k, v in self.last_signals.as_dict().items()},
        }
