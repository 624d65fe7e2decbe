"""Fleet health plane: the per-host peer health table.

Counterpart of ``sitewhere_tpu/rpc/health.py``: the same code over the
port's modules (no JAX anywhere on this path).

The reference platform never detected failures itself — it leaned on
Consul health checks for service liveness and Kafka consumer-group
rebalances for partition liveness (SURVEY.md §1), and the stream-broker
comparisons our benchmarks cite (PAPERS.md 1807.07724) treat broker
failure semantics as table stakes.  This framework removed
both coordinators, which left :class:`~.forward.HostForwarder`
discovering a dead or SHEDDING peer only by burning per-batch connect
timeouts and retry backoffs, forever.  This module reconstitutes the
health plane over the fabric we already have:

- a lightweight ``fleet.heartbeat`` RPC every ``heartbeat_interval_s``
  carrying the sender's overload state, Retry-After hint, pending
  spool lag toward the receiver, and an **incarnation** number (a
  restart bumps it, so a rebooted peer's stale state is replaced, not
  merged);
- the same overload state **piggybacked on every RPC response header**
  (``x-overload`` / ``x-retry-after``, stamped by the server for free)
  so a busy fabric learns about pressure at call rate, faster than the
  heartbeat period;
- an interval-based failure detector per peer::

      ALIVE --(silence >= suspect_after_s, or a send-failure streak)-->
      SUSPECT --(silence >= down_after_s)--> DOWN --(heartbeat)--> ALIVE

  with **hysteresis**: after any state change the table refuses further
  changes for ``hysteresis_s`` — a peer flapping at exactly the
  heartbeat period cannot oscillate the table (and therefore cannot
  trigger park/resume/requeue storms) faster than the configured
  dwell.

Consumers read three questions off the table:

- :meth:`PeerHealthTable.can_drain` — may the forwarder run a full
  spool drain against this peer?  (ALIVE and not advertising
  SHEDDING+.)
- :meth:`PeerHealthTable.probe_due` — a parked peer gets ONE paced
  probe batch per probe interval (stretched by the peer's own
  Retry-After hint while it sheds) instead of a retry storm.
- :meth:`PeerHealthTable.owner_pressure` — the device-facing edge maps
  a remote owner's advertised overload into protocol-native
  backpressure (HTTP 429 / CoAP 5.03 / MQTT pause) so fleet-wide
  pressure reaches the device that can act on it.

Determinism: the table takes an injectable ``clock`` and is driven by
explicit ``observe_*``/``tick`` calls, so the hysteresis and detector
contracts are asserted with a fake clock — no sleeps.
"""

from __future__ import annotations

import enum
import logging
import threading
import time
from typing import Callable, Dict, Iterable, Optional

logger = logging.getLogger("sitewhere_tpu_torch.rpc")

__all__ = ["PeerState", "PeerHealthTable", "HEADER_OVERLOAD",
           "HEADER_RETRY_AFTER"]

# piggyback headers every RPC response carries (server.py stamps them,
# channel.py surfaces them to the registered header listener)
HEADER_OVERLOAD = "x-overload"
HEADER_RETRY_AFTER = "x-retry-after"

# OverloadState names by int value — kept local so the health table can
# render snapshots without importing the (numpy-bearing) overload module
_OVERLOAD_NAMES = ("NORMAL", "DEGRADED", "SHEDDING", "EMERGENCY")
_SHED_THRESHOLD = 2     # OverloadState.SHEDDING


class PeerState(enum.IntEnum):
    """Failure-detector verdict for one peer, ordered by severity."""

    ALIVE = 0
    SUSPECT = 1    # missed heartbeats / send failures: probe, don't drain
    DOWN = 2       # sustained silence: probe at the paced interval only


class _Peer:
    __slots__ = ("state", "last_heard", "last_transition", "incarnation",
                 "overload_state", "retry_after_s", "spool_lag",
                 "fail_streak", "next_probe_at", "transitions",
                 "suppressed", "device_unhealthy", "unhealthy_shards")

    def __init__(self, now: float):
        self.state = PeerState.ALIVE        # optimistic boot (grace)
        self.last_heard = now
        self.last_transition = now
        self.incarnation = 0
        self.overload_state = 0
        self.retry_after_s = 0.0
        self.spool_lag = 0                  # rows the PEER holds for us
        self.fail_streak = 0
        self.next_probe_at = now
        self.transitions = 0
        self.suppressed = 0                 # hysteresis-refused changes
        self.device_unhealthy = False       # peer's hung-step watchdog flag
        self.unhealthy_shards = ()          # mesh shards the wedge names
                                            # (empty = whole tier)


class PeerHealthTable:
    """Per-host view of every peer's liveness + overload state.

    Thread-safe; the internal lock is a LEAF — no method calls out of
    this module while holding it, so callers may consult the table from
    sender threads, the heartbeat loop, and RPC reader threads freely.
    """

    def __init__(self, peers: Iterable[int], *,
                 heartbeat_interval_s: float = 0.5,
                 suspect_after_s: Optional[float] = None,
                 down_after_s: Optional[float] = None,
                 hysteresis_s: Optional[float] = None,
                 probe_interval_s: Optional[float] = None,
                 suspect_failures: int = 3,
                 clock: Callable[[], float] = time.monotonic,
                 metrics=None):
        hb = float(heartbeat_interval_s) if heartbeat_interval_s > 0 else 0.5
        self.heartbeat_interval_s = hb
        # defaults scale with the heartbeat period: suspicion needs ~3
        # missed beats, death ~8; one dwell covers two periods so a
        # peer flapping at exactly the period cannot flap the table
        self.suspect_after_s = float(suspect_after_s
                                     if suspect_after_s is not None
                                     else 3.0 * hb)
        self.down_after_s = float(down_after_s if down_after_s is not None
                                  else 8.0 * hb)
        self.hysteresis_s = float(hysteresis_s if hysteresis_s is not None
                                  else 2.0 * hb)
        self.probe_interval_s = float(probe_interval_s
                                      if probe_interval_s is not None
                                      else 2.0 * hb)
        self.suspect_failures = max(1, int(suspect_failures))
        self._clock = clock
        self._metrics = metrics
        self._lock = threading.Lock()
        now = clock()
        self._peers: Dict[int, _Peer] = {int(p): _Peer(now) for p in peers}
        self._gauges: Dict[int, tuple] = {}
        if metrics is not None:
            for p in self._peers:
                self._gauges[p] = (
                    metrics.gauge(f"forward.peer_state.{p}"),
                    metrics.gauge(f"forward.peer_overload.{p}"),
                )

    # -- internals -----------------------------------------------------------

    def _now(self, now: Optional[float]) -> float:
        return self._clock() if now is None else now

    def _transition_locked(self, peer: int, rec: _Peer, new: PeerState,
                           now: float, why: str) -> None:
        """Apply a detector verdict, subject to the hysteresis dwell:
        after any change the table holds its verdict for
        ``hysteresis_s`` — flap damping IS the anti-storm contract."""
        if new == rec.state:
            return
        if now - rec.last_transition < self.hysteresis_s:
            rec.suppressed += 1
            return
        old, rec.state = rec.state, new
        rec.last_transition = now
        rec.transitions += 1
        gauges = self._gauges.get(peer)
        if gauges is not None:
            gauges[0].set(int(new))
        logger.log(
            logging.WARNING if new != PeerState.ALIVE else logging.INFO,
            "peer %d health %s -> %s (%s)", peer, old.name, new.name, why)

    def _overload_locked(self, peer: int, rec: _Peer, state: int,
                         retry_after_s: float) -> None:
        rec.overload_state = max(0, int(state))
        rec.retry_after_s = max(0.0, float(retry_after_s))
        gauges = self._gauges.get(peer)
        if gauges is not None:
            gauges[1].set(rec.overload_state)

    # -- observations --------------------------------------------------------

    def observe_heartbeat(self, peer: int, incarnation: int = 0,
                          overload_state: int = 0,
                          retry_after_s: float = 0.0,
                          spool_lag: int = 0,
                          device_unhealthy: bool = False,
                          unhealthy_shards: tuple = (),
                          now: Optional[float] = None) -> None:
        """A full heartbeat (request or response body) from ``peer``."""
        now = self._now(now)
        with self._lock:
            rec = self._peers.get(peer)
            if rec is None:
                return
            rec.last_heard = now
            # deliberately NOT clearing fail_streak: an INCOMING beat
            # proves the peer is up, not that WE can reach it — under a
            # one-way partition the streak must keep the peer parked
            # (only an answered outbound call clears it: observe_alive /
            # observe_piggyback)
            if incarnation and incarnation != rec.incarnation:
                if rec.incarnation:
                    logger.info("peer %d restarted (incarnation %d -> %d)",
                                peer, rec.incarnation, incarnation)
                rec.incarnation = incarnation
            self._overload_locked(peer, rec, overload_state, retry_after_s)
            rec.spool_lag = max(0, int(spool_lag))
            if bool(device_unhealthy) != rec.device_unhealthy:
                logger.warning("peer %d device tier %s", peer,
                               ("unhealthy (hung dispatch, shards "
                                f"{list(unhealthy_shards) or 'ALL'})")
                               if device_unhealthy else "recovered")
            rec.device_unhealthy = bool(device_unhealthy)
            # shard-scoped refinement: which mesh shards the peer's
            # wedge attributes to (empty = whole tier).  Tracked even
            # without a flag edge — attribution can sharpen mid-episode.
            rec.unhealthy_shards = (tuple(unhealthy_shards)
                                    if device_unhealthy else ())
            if rec.fail_streak < self.suspect_failures:
                self._transition_locked(peer, rec, PeerState.ALIVE, now,
                                        "heartbeat")

    def observe_alive(self, peer: int, now: Optional[float] = None) -> None:
        """Liveness-only evidence: a delivered batch, any answered RPC
        (even an application error — the peer computed a reply)."""
        now = self._now(now)
        with self._lock:
            rec = self._peers.get(peer)
            if rec is None:
                return
            rec.last_heard = now
            rec.fail_streak = 0
            self._transition_locked(peer, rec, PeerState.ALIVE, now,
                                    "answered")

    def observe_failure(self, peer: int, now: Optional[float] = None) -> None:
        """A transport failure toward ``peer`` (connect refused, timeout,
        dropped mid-call).  A streak escalates without waiting for
        heartbeat silence — the sender learns from its own traffic."""
        now = self._now(now)
        with self._lock:
            rec = self._peers.get(peer)
            if rec is None:
                return
            rec.fail_streak += 1
            if rec.fail_streak >= 3 * self.suspect_failures:
                self._transition_locked(peer, rec, PeerState.DOWN, now,
                                        f"{rec.fail_streak} send failures")
            elif rec.fail_streak >= self.suspect_failures:
                self._transition_locked(peer, rec, PeerState.SUSPECT, now,
                                        f"{rec.fail_streak} send failures")

    def observe_piggyback(self, peer: int, headers: Dict[str, str],
                          now: Optional[float] = None) -> None:
        """Overload state riding an ordinary response's headers — the
        fast path that beats the heartbeat period on a busy fabric."""
        raw = headers.get(HEADER_OVERLOAD)
        if raw is None:
            return
        try:
            state = int(raw)
            retry = float(headers.get(HEADER_RETRY_AFTER, 0.0))
        except (TypeError, ValueError):
            return
        now = self._now(now)
        with self._lock:
            rec = self._peers.get(peer)
            if rec is None:
                return
            rec.last_heard = now
            rec.fail_streak = 0
            self._overload_locked(peer, rec, state, retry)
            self._transition_locked(peer, rec, PeerState.ALIVE, now,
                                    "piggyback")

    def tick(self, now: Optional[float] = None) -> None:
        """Interval detector: silence since ``last_heard`` votes the
        state up; the hysteresis dwell in ``_transition_locked`` keeps
        the verdict stable."""
        now = self._now(now)
        with self._lock:
            for peer, rec in self._peers.items():
                silent = now - rec.last_heard
                if silent >= self.down_after_s:
                    by_silence = PeerState.DOWN
                elif silent >= self.suspect_after_s:
                    by_silence = PeerState.SUSPECT
                else:
                    by_silence = PeerState.ALIVE
                if rec.fail_streak >= 3 * self.suspect_failures:
                    by_streak = PeerState.DOWN
                elif rec.fail_streak >= self.suspect_failures:
                    by_streak = PeerState.SUSPECT
                else:
                    by_streak = PeerState.ALIVE
                desired = max(by_silence, by_streak)
                self._transition_locked(peer, rec, PeerState(desired), now,
                                        f"silent {silent:.2f}s")

    # -- consumer queries ----------------------------------------------------

    def state(self, peer: int) -> PeerState:
        with self._lock:
            rec = self._peers.get(peer)
            return rec.state if rec is not None else PeerState.ALIVE

    def overload_state(self, peer: int) -> int:
        with self._lock:
            rec = self._peers.get(peer)
            return rec.overload_state if rec is not None else 0

    def retry_after(self, peer: int) -> float:
        with self._lock:
            rec = self._peers.get(peer)
            return rec.retry_after_s if rec is not None else 0.0

    def can_drain(self, peer: int) -> bool:
        """Full-drain eligibility: ALIVE and not advertising SHEDDING+.
        Unknown peers drain (the table only restrains known trouble)."""
        with self._lock:
            rec = self._peers.get(peer)
            if rec is None:
                return True
            return (rec.state == PeerState.ALIVE
                    and rec.overload_state < _SHED_THRESHOLD
                    # the peer's RPC plane answers but its device tier
                    # is wedged (hung-step watchdog): forwarded rows
                    # would pile into a queue nothing drains — park
                    # them in the spool until the flag clears
                    and not rec.device_unhealthy)

    def probe_ready(self, peer: int, now: Optional[float] = None) -> bool:
        """Non-stamping peek: is a probe currently allowed?  (The flush
        loop uses this to avoid spawning a sender that would park.)"""
        now = self._now(now)
        with self._lock:
            rec = self._peers.get(peer)
            return rec is None or now >= rec.next_probe_at

    def probe_due(self, peer: int, now: Optional[float] = None) -> bool:
        """Claim the next probe slot for a PARKED peer: True at most
        once per probe interval — the interval stretches to the peer's
        own Retry-After hint while it sheds, honoring its backpressure."""
        now = self._now(now)
        with self._lock:
            rec = self._peers.get(peer)
            if rec is None:
                return True
            if now < rec.next_probe_at:
                return False
            interval = self.probe_interval_s
            if rec.overload_state >= _SHED_THRESHOLD:
                interval = max(interval, rec.retry_after_s)
            rec.next_probe_at = now + interval
            return True

    def owner_pressure(self, peer: int) -> Optional[tuple]:
        """``(overload_state, retry_after_s)`` when ``peer`` advertises
        SHEDDING+ — the device-facing edge turns this into 429 / 5.03 /
        pause hints; None when the owner can take traffic."""
        with self._lock:
            rec = self._peers.get(peer)
            if rec is None or rec.overload_state < _SHED_THRESHOLD:
                return None
            return rec.overload_state, max(rec.retry_after_s, 1.0)

    # -- membership / introspection ------------------------------------------

    def set_peers(self, peers: Iterable[int]) -> None:
        """Reconcile the tracked peer set after a membership change —
        existing records (and their dwell state) are kept."""
        wanted = {int(p) for p in peers}
        now = self._clock()
        with self._lock:
            for p in wanted - set(self._peers):
                self._peers[p] = _Peer(now)
                if self._metrics is not None:
                    self._gauges[p] = (
                        self._metrics.gauge(f"forward.peer_state.{p}"),
                        self._metrics.gauge(f"forward.peer_overload.{p}"),
                    )
            for p in set(self._peers) - wanted:
                del self._peers[p]
                gauges = self._gauges.pop(p, None)
                if gauges is not None:
                    # zero first (holders of the popped Gauge see a
                    # quiet value, dashboards stop alerting on a frozen
                    # DOWN), then unregister so a long-lived fleet that
                    # churns membership doesn't accrete one gauge pair
                    # per peer that ever existed
                    gauges[0].set(0)
                    gauges[1].set(0)
                    remove = getattr(self._metrics, "remove", None)
                    if remove is not None:
                        remove(f"forward.peer_state.{p}",
                               f"forward.peer_overload.{p}")

    def transitions(self, peer: int) -> int:
        with self._lock:
            rec = self._peers.get(peer)
            return rec.transitions if rec is not None else 0

    def snapshot(self) -> Dict[str, dict]:
        """Admin-surface view (instance topology folds this in)."""
        now = self._clock()
        with self._lock:
            out = {}
            for peer, rec in sorted(self._peers.items()):
                ov = rec.overload_state
                out[str(peer)] = {
                    "state": rec.state.name,
                    "overload": (_OVERLOAD_NAMES[ov]
                                 if 0 <= ov < len(_OVERLOAD_NAMES)
                                 else str(ov)),
                    "retry_after_s": round(rec.retry_after_s, 3),
                    "silent_s": round(max(0.0, now - rec.last_heard), 3),
                    "incarnation": rec.incarnation,
                    "spool_lag": rec.spool_lag,
                    "fail_streak": rec.fail_streak,
                    "transitions": rec.transitions,
                    "suppressed_flaps": rec.suppressed,
                    "device_unhealthy": rec.device_unhealthy,
                    "unhealthy_shards": list(rec.unhealthy_shards),
                }
            return out
