"""Deterministic fault injection: named points, seedable, off by default.

Stream-processing evaluations (HarmonicIO/Kafka, arXiv:1807.07724; DSP
enrichment, arXiv:2307.14287) show tail behavior under component failure
is what separates benchmark systems from deployable ones — but failure
paths are untestable unless failures can be produced ON DEMAND and
DETERMINISTICALLY.  This registry provides that: production code calls
:func:`fire` at named injection points (``"ingest.decode"``,
``"dispatcher.egress"``, ``"event_store.flush"``, ``"rpc.connect"``,
``"outbound.deliver"``, ``"commands.deliver"``, …) and tests arm those
points with :func:`inject`.

Zero-cost when disabled: with no faults armed, :func:`fire` is a single
function call guarded by one module-global check — no locks, no dict
lookups, nothing allocated.  The hot paths that call it do so at payload
/ plan / flush granularity, never per event row.

Determinism: ``after_n`` skips the first N hits of a point, ``times``
bounds how many calls raise (``None`` = every call once triggered), and
``probability`` draws from a PRIVATE ``random.Random(seed)`` so a chaos
run replays bit-identically from its seed.

Typical test usage::

    from sitewhere_tpu_torch.runtime import faults

    with faults.injected("ingest.decode", after_n=3,
                         exc=DecodeError("injected")):
        ...  # 4th decode raises; earlier/later ones pass

Crosspoints (kill points) are the harsher sibling of :func:`fire`: a
:func:`crosspoint` call SIGKILLs the whole process when armed — no
``finally`` blocks, no flushes, no atexit — which is exactly the failure
the crash-recovery contract promises to survive.  They are armed from
the ENVIRONMENT (``SW_CRASHPOINT="crash.mid_ring:3"`` = die on the 3rd
hit of that point), so a chaos harness can fork a child instance and
schedule its death without any cooperation from the child's code, or
programmatically via :func:`arm_crosspoint` for same-process tests that
only want the hit accounting.  Disarmed cost is one string compare.
"""

from __future__ import annotations

import contextlib
import os
import random
import signal
import threading
from typing import Dict, Iterator, Optional, Tuple, Union

__all__ = [
    "FaultInjected",
    "inject",
    "clear",
    "fire",
    "active",
    "hits",
    "fired",
    "injected",
    "crosspoint",
    "arm_crosspoint",
    "disarm_crosspoint",
    "crosspoint_hits",
    "net_inject",
    "net_clear",
    "net_active",
    "net_drops",
    "net_shape",
    "net_injected",
    "device_inject",
    "device_clear",
    "device_active",
    "device_hits",
    "device_fired",
    "device_fire",
    "device_injected",
    "device_poison_rows",
]


class FaultInjected(Exception):
    """Default exception raised at an armed injection point."""


ExcSpec = Union[BaseException, type]


class _Fault:
    __slots__ = ("point", "exc", "after_n", "times", "probability",
                 "rng", "hits", "fired")

    def __init__(self, point: str, exc: ExcSpec, after_n: int,
                 times: Optional[int], probability: float,
                 seed: Optional[int]):
        self.point = point
        self.exc = exc
        self.after_n = int(after_n)
        self.times = times if times is None else int(times)
        self.probability = float(probability)
        self.rng = random.Random(seed if seed is not None else 0)
        self.hits = 0      # every fire() that reached this point
        self.fired = 0     # fire() calls that actually raised

    def _make_exc(self) -> BaseException:
        if isinstance(self.exc, type):
            return self.exc(f"injected fault at {self.point!r}")
        return self.exc

    def check(self) -> Optional[BaseException]:
        """Count one hit; return the exception to raise, or None."""
        self.hits += 1
        if self.hits <= self.after_n:
            return None
        if self.times is not None and self.fired >= self.times:
            return None
        if self.probability < 1.0 and self.rng.random() >= self.probability:
            return None
        self.fired += 1
        return self._make_exc()


# Module-global fast gate: fire() checks this one name and returns.  It is
# only ever flipped under _lock, and a stale read merely delays a fault by
# one call — acceptable for chaos tooling, free for production.
_armed = False
_faults: Dict[str, _Fault] = {}
_lock = threading.Lock()


def inject(point: str, exc: ExcSpec = FaultInjected, *, after_n: int = 0,
           times: Optional[int] = 1, probability: float = 1.0,
           seed: Optional[int] = None) -> None:
    """Arm ``point``: the next ``fire(point)`` calls raise ``exc``.

    - ``after_n``: skip the first N hits (fail the N+1-th call).
    - ``times``: how many calls raise once triggered (``None`` = forever —
      a permanently dead component).
    - ``probability``: chance each eligible call raises, drawn from a
      private ``random.Random(seed)`` — fully reproducible.
    - ``exc``: exception instance or class to raise.
    """
    global _armed
    with _lock:
        _faults[point] = _Fault(point, exc, after_n, times, probability, seed)
        _armed = True


def clear(point: Optional[str] = None) -> None:
    """Disarm one point, or every point when ``point`` is None."""
    global _armed
    with _lock:
        if point is None:
            _faults.clear()
        else:
            _faults.pop(point, None)
        _armed = bool(_faults)


def active() -> bool:
    return _armed


def hits(point: str) -> int:
    """How many times ``fire(point)`` was reached (armed points only)."""
    with _lock:
        f = _faults.get(point)
        return f.hits if f is not None else 0


def fired(point: str) -> int:
    """How many times ``fire(point)`` actually raised."""
    with _lock:
        f = _faults.get(point)
        return f.fired if f is not None else 0


def fire(point: str) -> None:
    """Injection-point hook: raises when ``point`` is armed and due.

    The disabled path is one global check — call it freely from
    payload/plan-granularity code.
    """
    if not _armed:
        return
    with _lock:
        f = _faults.get(point)
        exc = f.check() if f is not None else None
    if exc is not None:
        raise exc


@contextlib.contextmanager
def injected(point: str, exc: ExcSpec = FaultInjected, *,
             after_n: int = 0, times: Optional[int] = 1,
             probability: float = 1.0,
             seed: Optional[int] = None) -> Iterator[None]:
    """Scoped :func:`inject` — disarms the point on exit, always."""
    inject(point, exc, after_n=after_n, times=times,
           probability=probability, seed=seed)
    try:
        yield
    finally:
        clear(point)


# ---------------------------------------------------------------------------
# network fault plane: injectable latency / drop / one-way partition
# ---------------------------------------------------------------------------

# The fleet-health contract (rpc/health.py) is only testable if the
# fabric itself can misbehave on demand: added latency (deadline budget
# burns in flight), symmetric partitions (connects and requests fail),
# and ONE-WAY partitions (the request is delivered and may execute, the
# reply is lost — the half-open link every distributed harness needs).
# RpcChannel consults this plane at its connect / send / receive seams;
# the disabled path is one module-global check, same contract as fire().


class _NetRule:
    __slots__ = ("latency_s", "jitter_s", "drop", "one_way", "rng",
                 "hits", "dropped")

    def __init__(self, latency_s: float, jitter_s: float, drop: float,
                 one_way: bool, seed: Optional[int]):
        self.latency_s = float(latency_s)
        self.jitter_s = float(jitter_s)
        self.drop = float(drop)
        self.one_way = bool(one_way)
        self.rng = random.Random(seed if seed is not None else 0)
        self.hits = 0
        self.dropped = 0


_net_armed = False
_net_rules: Dict[str, _NetRule] = {}    # endpoint ("host:port") or "*"


def net_inject(endpoint: str, *, latency_s: float = 0.0,
               jitter_s: float = 0.0, drop: float = 0.0,
               one_way: bool = False, seed: Optional[int] = None) -> None:
    """Shape the fabric toward ``endpoint`` (``"*"`` = every endpoint).

    - ``latency_s`` (+ uniform ``jitter_s``) delays each request send —
      real wall time, so propagated deadlines burn exactly as they
      would behind a slow fabric.
    - ``drop``: probability each connect/request is lost
      (``1.0`` = full partition), drawn from a private
      ``random.Random(seed)`` — reproducible.
    - ``one_way=True`` moves the drop to the RESPONSE direction: the
      request is delivered (the server may execute it!) but the reply
      is lost and the caller times out — the half-open partition.
    """
    global _net_armed
    with _lock:
        _net_rules[endpoint] = _NetRule(latency_s, jitter_s, drop,
                                        one_way, seed)
        _net_armed = True


def net_clear(endpoint: Optional[str] = None) -> None:
    """Heal one endpoint's rule, or the whole fabric when None."""
    global _net_armed
    with _lock:
        if endpoint is None:
            _net_rules.clear()
        else:
            _net_rules.pop(endpoint, None)
        _net_armed = bool(_net_rules)


def net_active() -> bool:
    return _net_armed


def _net_rule(endpoint: str) -> Optional[_NetRule]:
    rule = _net_rules.get(endpoint)
    return rule if rule is not None else _net_rules.get("*")


def net_shape(endpoint: str, direction: str) -> Tuple[bool, float]:
    """``(drop, delay_s)`` for one traversal of ``direction``
    (``"connect"`` / ``"request"`` / ``"response"``).  The disabled path
    is one global check and allocates nothing."""
    if not _net_armed:
        return False, 0.0
    with _lock:
        rule = _net_rule(endpoint)
        if rule is None:
            return False, 0.0
        rule.hits += 1
        delay = 0.0
        if direction == "request" and rule.latency_s > 0.0:
            delay = rule.latency_s
            if rule.jitter_s > 0.0:
                delay += rule.rng.uniform(0.0, rule.jitter_s)
        drop = False
        if rule.drop > 0.0:
            hit_direction = (direction == "response" if rule.one_way
                             else direction in ("connect", "request"))
            if hit_direction and (rule.drop >= 1.0
                                  or rule.rng.random() < rule.drop):
                drop = True
                rule.dropped += 1
        return drop, delay


def net_drops(endpoint: str, direction: str) -> bool:
    drop, _ = net_shape(endpoint, direction)
    return drop


@contextlib.contextmanager
def net_injected(endpoint: str, **kw) -> Iterator[None]:
    """Scoped :func:`net_inject` — heals the endpoint on exit, always."""
    net_inject(endpoint, **kw)
    try:
        yield
    finally:
        net_clear(endpoint)


# ---------------------------------------------------------------------------
# device fault plane: dispatch exceptions, NaN poisoning, artificial stalls
# ---------------------------------------------------------------------------

# Device-fault handling (in this slice a fault propagates and the plan
# stays outstanding; the reference's re-park → re-lease → bisect →
# quarantine containment comes with the device-guard slice) is only
# testable if the *device* can misbehave on demand.  Three failure
# shapes matter, and they compose:
#
# - a dispatch exception (device out of memory, a lost device): raise
#   ``exc`` from the dispatch seam, same after_n/times/probability
#   contract as :func:`fire`;
# - data-dependent failure (``when_nonfinite=True``): the point fires
#   ONLY when the staged float block carries a NaN/Inf in a valid column
#   — this is what gives the host-side bisect its exact semantics (a
#   masked half without the poison row dispatches clean);
# - a wedged chip (``stall_s``): the dispatch seam sleeps for real wall
#   time before (optionally) raising, which is what the hung-step
#   watchdog's budgets are calibrated against.
#
# Disabled cost is one module-global check, per plan — never per row.


class _DeviceFault:
    __slots__ = ("point", "exc", "after_n", "times", "probability",
                 "stall_s", "when_nonfinite", "rng", "hits", "fired")

    def __init__(self, point: str, exc: Optional[ExcSpec], after_n: int,
                 times: Optional[int], probability: float, stall_s: float,
                 when_nonfinite: bool, seed: Optional[int]):
        self.point = point
        self.exc = exc
        self.after_n = int(after_n)
        self.times = times if times is None else int(times)
        self.probability = float(probability)
        self.stall_s = float(stall_s)
        self.when_nonfinite = bool(when_nonfinite)
        self.rng = random.Random(seed if seed is not None else 0)
        self.hits = 0
        self.fired = 0

    def _make_exc(self) -> Optional[BaseException]:
        if self.exc is None:
            return None
        if isinstance(self.exc, type):
            return self.exc(f"injected device fault at {self.point!r}")
        return self.exc

    def check(self, nonfinite: bool) -> Tuple[float, Optional[BaseException]]:
        """Count one hit; return ``(stall_s, exc-or-None)``."""
        self.hits += 1
        if self.hits <= self.after_n:
            return 0.0, None
        if self.when_nonfinite and not nonfinite:
            return 0.0, None
        if self.times is not None and self.fired >= self.times:
            return 0.0, None
        if self.probability < 1.0 and self.rng.random() >= self.probability:
            return 0.0, None
        self.fired += 1
        return self.stall_s, self._make_exc()


_dev_armed = False
_dev_faults: Dict[str, _DeviceFault] = {}


def device_inject(point: str, exc: Optional[ExcSpec] = FaultInjected, *,
                  after_n: int = 0, times: Optional[int] = 1,
                  probability: float = 1.0, stall_s: float = 0.0,
                  when_nonfinite: bool = False,
                  seed: Optional[int] = None) -> None:
    """Arm a device-tier point (e.g. ``"device.dispatch"``).

    - ``exc``: exception to raise from the dispatch seam; ``None`` makes
      the fault stall-only (a slow chip, not a dead one).
    - ``stall_s``: real wall-time sleep before raising — the watchdog's
      soft/hard budgets are exercised against this.
    - ``when_nonfinite=True``: fire only when the plan's staged float
      block holds a NaN/Inf in a valid column; clean (sub-)batches pass.
    - ``after_n`` / ``times`` / ``probability`` / ``seed``: same
      deterministic contract as :func:`inject`.
    """
    global _dev_armed
    with _lock:
        _dev_faults[point] = _DeviceFault(point, exc, after_n, times,
                                          probability, stall_s,
                                          when_nonfinite, seed)
        _dev_armed = True


def device_clear(point: Optional[str] = None) -> None:
    """Disarm one device point, or all of them when ``point`` is None."""
    global _dev_armed
    with _lock:
        if point is None:
            _dev_faults.clear()
        else:
            _dev_faults.pop(point, None)
        _dev_armed = bool(_dev_faults)


def device_active() -> bool:
    return _dev_armed


def device_hits(point: str) -> int:
    with _lock:
        f = _dev_faults.get(point)
        return f.hits if f is not None else 0


def device_fired(point: str) -> int:
    with _lock:
        f = _dev_faults.get(point)
        return f.fired if f is not None else 0


def device_fire(point: str, values=None, valid=None) -> None:
    """Device seam hook: stall and/or raise when ``point`` is armed.

    ``values`` is the plan's staged float block (``[F, B]`` host array)
    and ``valid`` the per-column validity mask — both optional, consulted
    only by ``when_nonfinite`` rules so the disabled and clean paths
    allocate nothing.  The stall happens OUTSIDE the registry lock.
    """
    if not _dev_armed:
        return
    with _lock:
        f = _dev_faults.get(point)
        if f is None:
            return
        nonfinite = False
        if f.when_nonfinite and values is not None:
            import numpy as _np

            vals = _np.asarray(values, dtype=_np.float32)
            if valid is not None:
                mask = _np.asarray(valid, dtype=bool)
                vals = vals[..., mask] if vals.ndim > 1 else vals[mask]
            nonfinite = bool(_np.size(vals)) and not bool(
                _np.isfinite(vals).all())
        stall, exc = f.check(nonfinite)
    if stall > 0.0:
        import time as _time

        _time.sleep(stall)
    if exc is not None:
        raise exc


@contextlib.contextmanager
def device_injected(point: str, exc: Optional[ExcSpec] = FaultInjected,
                    **kw) -> Iterator[None]:
    """Scoped :func:`device_inject` — disarms the point on exit, always."""
    device_inject(point, exc, **kw)
    try:
        yield
    finally:
        device_clear(point)


def device_poison_rows(columns, rows, fields=("value",),
                       value=float("nan")) -> None:
    """Poison host-side staged columns in place (bench/test helper).

    ``columns`` maps field name -> numpy array; each index in ``rows``
    gets ``value`` written into every named field that exists.
    """
    for field in fields:
        col = columns.get(field)
        if col is None:
            continue
        for r in rows:
            col[int(r)] = value


# ---------------------------------------------------------------------------
# crosspoints: named SIGKILL points for the crash-recovery harness
# ---------------------------------------------------------------------------

# One armed point per process (a kill fires once, by definition).  The
# disarmed fast path in crosspoint() is a single `!=` against None.
_kill_point: Optional[str] = None
_kill_after = 1          # die on the Nth hit (1 = first)
_kill_hits = 0
_kill_signal = signal.SIGKILL
_kill_dry_run = False    # tests: count hits, don't die


def _parse_crosspoint_env() -> None:
    """Arm from ``SW_CRASHPOINT="point[:n]"`` — read once at import so a
    forked chaos child needs zero in-process cooperation."""
    spec = os.environ.get("SW_CRASHPOINT")
    if not spec:
        return
    point, _, n = spec.partition(":")
    try:
        after = max(1, int(n)) if n else 1
    except ValueError:
        after = 1
    arm_crosspoint(point.strip(), after_n=after)


def arm_crosspoint(point: str, after_n: int = 1, *,
                   dry_run: bool = False) -> None:
    """Arm ``point``: the ``after_n``-th :func:`crosspoint` hit SIGKILLs
    this process (``dry_run`` counts instead — unit tests)."""
    global _kill_point, _kill_after, _kill_hits, _kill_dry_run
    _kill_after = max(1, int(after_n))
    _kill_hits = 0
    _kill_dry_run = bool(dry_run)
    _kill_point = point


def disarm_crosspoint() -> None:
    global _kill_point
    _kill_point = None


def crosspoint_hits() -> int:
    return _kill_hits


def crosspoint(point: str) -> None:
    """Kill-point hook: SIGKILL self when ``point`` is the armed
    crosspoint and its hit count is due.  Safe to call from any hot
    path — disarmed cost is one comparison, and the armed path never
    raises (the process simply ceases)."""
    global _kill_hits
    if point != _kill_point:
        return
    _kill_hits += 1
    if _kill_hits < _kill_after:
        return
    if _kill_dry_run:
        return
    # flush nothing, close nothing: the contract under test is that the
    # durable state alone (journal + snapshot generations) recovers
    os.kill(os.getpid(), _kill_signal)


_parse_crosspoint_env()
