"""Device-tier guards: a dispatch circuit breaker and a hung-step watchdog.

Counterpart of ``sitewhere_tpu/runtime/devguard.py``: the policy half of
the dispatcher's containment protocol; the mechanism half (re-park,
re-lease, bisect, the CPU level) lives in
:mod:`sitewhere_tpu_torch.runtime.dispatcher`.

:class:`DeviceBreaker` -- repeated device faults across DISTINCT batches
demote dispatch down a ladder: chained (K-step rings over the leased
carry) -> single-step (one batch per dispatch, bisectable) -> CPU
fallback (the port's own torch step on ``device="cpu"``).  A one-off
fault never trips it; after ``cooldown_s`` a half-open probe re-admits
one chained dispatch, and a probe success restores chained dispatch.

:class:`DeviceWatchdog` -- refcounted in-flight dispatch tracking with a
soft and a hard wall-clock budget.  Past the soft budget the dispatcher
dumps the in-flight records to the flight recorder (the card is slow);
past the hard budget the device tier is marked unhealthy (the card is
wedged).  The flag self-clears when every tracked dispatch drains.

Both guards take an injectable ``clock``.  The reference's per-shard
breaker bank (``ShardBreakers``) comes with the mesh slice.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

__all__ = [
    "CHAINED",
    "SINGLE_STEP",
    "FALLBACK",
    "BREAKER_LEVELS",
    "DeviceBreaker",
    "DeviceWatchdog",
]

# Breaker ladder levels, most to least capable.
CHAINED = 0        # K-step chained rings over the leased carry
SINGLE_STEP = 1    # one plan per dispatch, bisectable
FALLBACK = 2       # the packed step on the CPU

BREAKER_LEVELS = ("chained", "single-step", "cpu-fallback")


class _Entry:
    __slots__ = ("started", "records", "parts", "soft_fired")

    def __init__(self, started: float, records, parts: int):
        self.started = started
        self.records = records
        self.parts = max(1, int(parts))
        self.soft_fired = False


class DeviceBreaker:
    """Demote dispatch after repeated device faults; probe back up.

    ``record_fault(seq)`` counts faults from DISTINCT batch sequence
    numbers inside a sliding ``window_s`` — the bisect protocol may
    re-fault the same batch several times while isolating poison rows,
    and that must count as ONE strike.  ``threshold`` distinct strikes
    escalate the level one rung (chained → single-step → cpu-fallback)
    and start the cooldown.  After ``cooldown_s`` the breaker half-opens:
    ``allow_chain`` admits chained dispatch again, and the next
    ``record_success(chained=True)`` restores :data:`CHAINED`; a fault
    during the probe re-closes it and restarts the cooldown.
    """

    def __init__(self, threshold: int = 3, window_s: float = 60.0,
                 cooldown_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic,
                 on_trip: Optional[Callable[[int], None]] = None,
                 on_restore: Optional[Callable[[], None]] = None):
        self.threshold = max(1, int(threshold))
        self.window_s = float(window_s)
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self.on_trip = on_trip
        self.on_restore = on_restore
        self._lock = threading.Lock()
        self._level = CHAINED
        self._strikes: List[tuple] = []    # (monotonic_s, batch_seq)
        self._tripped_at = 0.0
        self._probing = False
        self.trips = 0
        self.restores = 0

    @property
    def level(self) -> int:
        return self._level

    @property
    def level_name(self) -> str:
        return BREAKER_LEVELS[self._level]

    def allow_chain(self) -> bool:
        """True when chained (ring) dispatch is admitted.

        Closed-breaker fast path is one attribute read; a stale read
        merely lets one extra chain through, which the fault path then
        contains — same tolerance as the fault registry's fast gate.
        """
        if self._level == CHAINED:
            return True
        with self._lock:
            if self._level == CHAINED:
                return True
            if self._probing:
                return True
            if self._clock() - self._tripped_at >= self.cooldown_s:
                self._probing = True
                return True
            return False

    def record_fault(self, seq: int) -> bool:
        """Count one device fault for batch ``seq``; True if it tripped."""
        trip_to = None
        with self._lock:
            now = self._clock()
            if self._probing:
                # probe failed: re-close and restart the cooldown
                self._probing = False
                self._tripped_at = now
            horizon = now - self.window_s
            self._strikes = [s for s in self._strikes if s[0] >= horizon]
            if not any(s[1] == seq for s in self._strikes):
                self._strikes.append((now, int(seq)))
            if len(self._strikes) >= self.threshold \
                    and self._level < FALLBACK:
                self._level += 1
                self._strikes = []
                self._tripped_at = now
                self.trips += 1
                trip_to = self._level
        if trip_to is not None and self.on_trip is not None:
            self.on_trip(trip_to)
        return trip_to is not None

    def record_success(self, chained: bool = False) -> None:
        """A dispatch drained clean; a CHAINED success closes the breaker."""
        restored = False
        with self._lock:
            if chained and self._level != CHAINED:
                self._level = CHAINED
                self._probing = False
                self._strikes = []
                self.restores += 1
                restored = True
        if restored and self.on_restore is not None:
            self.on_restore()

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "level": self._level,
                "levelName": BREAKER_LEVELS[self._level],
                "strikes": len(self._strikes),
                "probing": self._probing,
                "trips": self.trips,
                "restores": self.restores,
            }


class DeviceWatchdog:
    """Budgeted wall-clock tracking of in-flight device dispatches.

    ``begin(records, parts)`` registers a dispatch (a ring of K plans
    passes ``parts=K``; each plan's egress calls :meth:`end` once) and
    returns a token; :meth:`check` — called from the dispatch loop's
    idle tick — compares the OLDEST live entry against the budgets:

    - past ``soft_s``: ``on_soft(records, elapsed_s)`` fires once per
      entry (flight-recorder anomaly with the in-flight slot records);
    - past ``hard_s``: the tier is marked :attr:`unhealthy` and
      ``on_unhealthy(records, elapsed_s)`` fires once per episode — the
      flag rides the heartbeat (rpc/health.py) so peers park forwards.

    The flag clears (``on_recovered``) when every tracked dispatch
    drains — a wedged chip that comes back needs no operator action.
    Budgets come from :meth:`calibrate` against the measured per-step
    latency, floored so a CPU test host never false-trips.
    """

    def __init__(self, soft_s: float = 1.0, hard_s: float = 10.0,
                 clock: Callable[[], float] = time.monotonic,
                 on_soft: Optional[Callable[[object, float], None]] = None,
                 on_unhealthy: Optional[Callable[[object, float], None]] = None,
                 on_recovered: Optional[Callable[[], None]] = None):
        self.soft_s = float(soft_s)
        self.hard_s = float(hard_s)
        self._clock = clock
        self.on_soft = on_soft
        self.on_unhealthy = on_unhealthy
        self.on_recovered = on_recovered
        self._lock = threading.Lock()
        self._entries: Dict[int, _Entry] = {}
        self._next_token = 0
        self._unhealthy = False
        self.soft_trips = 0
        self.hard_trips = 0

    @property
    def unhealthy(self) -> bool:
        return self._unhealthy

    def calibrate(self, stage_ms: float, *, soft_multiple: float = 50.0,
                  hard_multiple: float = 400.0, soft_floor_s: float = 0.25,
                  hard_floor_s: float = 2.0) -> None:
        """Derive budgets from the measured ``device.stage_ms``.

        Multiples are generous by design: the budgets exist to catch a
        WEDGED chip, not a slow batch — queueing, retrace, and host
        copies all legitimately stack on top of one stage time.
        """
        stage_s = max(0.0, float(stage_ms)) / 1000.0
        self.soft_s = max(float(soft_floor_s), stage_s * float(soft_multiple))
        self.hard_s = max(float(hard_floor_s), self.soft_s / max(
            float(soft_multiple), 1e-9) * float(hard_multiple))

    def begin(self, records, parts: int = 1) -> int:
        """Register one in-flight dispatch.  ``records`` is an OPAQUE
        payload handed back verbatim to ``on_soft``/``on_unhealthy`` —
        callers pass already-live objects (the plan, the ring's plan
        list) so the per-batch hot path allocates nothing here; the
        callback renders them only when a budget actually trips."""
        with self._lock:
            self._next_token += 1
            token = self._next_token
            self._entries[token] = _Entry(self._clock(), records, parts)
            return token

    def end(self, token: Optional[int]) -> None:
        if token is None:
            return
        recovered = False
        with self._lock:
            entry = self._entries.get(token)
            if entry is None:
                return
            entry.parts -= 1
            if entry.parts <= 0:
                del self._entries[token]
            if self._unhealthy and not self._entries:
                self._unhealthy = False
                recovered = True
        if recovered and self.on_recovered is not None:
            self.on_recovered()

    def check(self, now: Optional[float] = None) -> bool:
        """Evaluate budgets; returns the (possibly new) unhealthy flag."""
        soft_fire = None
        hard_fire = None
        with self._lock:
            if not self._entries:
                return self._unhealthy
            if now is None:
                now = self._clock()
            oldest = min(self._entries.values(), key=lambda e: e.started)
            elapsed = now - oldest.started
            if elapsed > self.soft_s and not oldest.soft_fired:
                oldest.soft_fired = True
                self.soft_trips += 1
                soft_fire = (oldest.records, elapsed)
            if elapsed > self.hard_s and not self._unhealthy:
                self._unhealthy = True
                self.hard_trips += 1
                hard_fire = (oldest.records, elapsed)
        if soft_fire is not None and self.on_soft is not None:
            self.on_soft(*soft_fire)
        if hard_fire is not None and self.on_unhealthy is not None:
            self.on_unhealthy(*hard_fire)
        return self._unhealthy

    def snapshot(self) -> dict:
        with self._lock:
            oldest_s = 0.0
            if self._entries:
                now = self._clock()
                oldest_s = now - min(e.started
                                     for e in self._entries.values())
            return {
                "inflight": len(self._entries),
                "oldestS": oldest_s,
                "softS": self.soft_s,
                "hardS": self.hard_s,
                "unhealthy": self._unhealthy,
                "softTrips": self.soft_trips,
                "hardTrips": self.hard_trips,
            }
