"""Cross-host event routing at the ingest boundary.

Counterpart of ``sitewhere_tpu/rpc/forward.py``: the same code over the
port's modules (no JAX anywhere on this path).

Reference scaling story (SURVEY.md §2.4): producers key every Kafka
record by device token (``MicroserviceKafkaProducer.java:106``,
``EventSourcesManager.java:166``), the key hash picks a partition, and
partition leadership pins that device's stream to one broker — giving
per-device ordering and horizontal scale-out.

Here each HOST in the multi-host mesh owns the shards its
local devices live on (``parallel/multihost.py``).  A device protocol
frontend, however, terminates wherever the device connected — so rows
that belong to another host's shards must cross the network exactly once, at the
host plane, before entering the owning host's batcher.  That hop is this
module: a stable token hash picks the owning process (the partition-key
analog), local rows go straight to the local dispatcher's columnar wire
intake, and remote rows ship over the RPC fabric's binary lane
(``events.ingest``) — journaled and processed by the OWNER, preserving
the reference's per-device ordering and at-least-once placement.

Durability of the network hop itself: with a ``data_dir``, remote-owned rows
spool to a per-peer :class:`~sitewhere_tpu_torch.ingest.journal.Journal` at
intake and the sender commits its reader offset only AFTER the owner
accepts the batch — the Kafka producer's replicated-ack, as a local
write-ahead spool.  A crash between intake and send replays the spool on
restart; a peer outage retains rows on disk (a down broker's partition
log, exactly).  Without a ``data_dir`` the buffer is memory-only and an
unreachable peer dead-letters after bounded retries — the
fire-and-forget producer profile, for tests and ephemeral toys.
"""

from __future__ import annotations

import json
import logging
import threading
import time
import zlib
from typing import Dict, List, Optional

from sitewhere_tpu_torch.ingest.journal import Journal, JournalReader
from sitewhere_tpu_torch.rpc.channel import (
    ChannelUnavailable,
    DeadlineExpired,
    RpcDemux,
    RpcError,
)
from sitewhere_tpu_torch.rpc.health import PeerHealthTable, PeerState
from sitewhere_tpu_torch.runtime import faults
from sitewhere_tpu_torch.runtime.lifecycle import LifecycleComponent
from sitewhere_tpu_torch.runtime.metrics import MetricsRegistry
from sitewhere_tpu_torch.runtime.overload import (
    OverloadShed,
    OverloadState,
    PriorityClass,
    classify_event_type,
)
from sitewhere_tpu_torch.runtime.tracing import _NOOP_TRACE

logger = logging.getLogger("sitewhere_tpu_torch.rpc")

SPOOL_POLL_RECORDS = 64    # batches per send drain

# delivery outcomes (_deliver): terminal-or-delivered / retain-and-pace
_OK = "ok"        # delivered, or non-retryable rejection (dead-lettered)
_DOWN = "down"    # unreachable / deadline lapsed: rows retained
_SHED = "shed"    # the owner's admission refused: rows retained, paced

# payload markers that exempt the device-facing owner-pressure gate: a
# payload that MIGHT carry an alert / command response is always
# forwarded (the owner's own admission never sheds CRITICAL) — false
# positives only skip the gate, never drop rows
_CRITICAL_MARKERS = (b"alert", b"acknowledge", b"commandresponse")


def _has_critical_marker(payload: bytes) -> bool:
    low = payload.lower()
    return any(m in low for m in _CRITICAL_MARKERS)


def _fmix32(h: int) -> int:
    """murmur3's 32-bit finalizer — the non-linear mixer rendezvous
    weights need.  CRC32 alone is LINEAR: crc(token+s1) and crc(token+s2)
    differ by a constant XOR for equal-length suffixes, so an argmax over
    raw CRCs is decided by those constants, not the token (measured: up
    to 2.3× load skew at P=12).  Two multiply-xorshift rounds destroy
    the linearity; measured skew ≤1.04 and P→P+1 remap ≈1/(P+1)."""
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & 0xFFFFFFFF
    h ^= h >> 16
    return h


def owning_process(device_token: str, n_processes: int) -> int:
    """Stable token → process mapping by rendezvous (highest-random-
    weight) hashing: owner = argmax_p fmix32(crc32(token) ^ crc32("|p")).

    Kafka's keyed partitioning analog, but with the elasticity property
    a plain ``hash % P`` lacks: growing the fleet from P to P+1 hosts
    remaps only ~1/(P+1) of devices instead of nearly all of them — the
    partition-reassignment story without a coordinator.  Ties break to
    the smallest process id (first maximum).  crc32 is stable across
    processes and Python runs — the builtin ``hash`` is salted per
    process and MUST NOT be used here.  The native scanner
    (``swwire.c`` ``hrw_owner``) computes the identical function; the
    two MUST stay in lock-step or one device's stream would split
    across hosts.

    VERSIONING: this function IS the cluster's data placement.  Any
    change to it (or to fmix32) remaps devices to different owners, so
    it must roll out as a coordinated full-fleet restart with registry
    re-registration — a mixed-version fleet splits streams exactly like
    a Python/C mismatch would.
    """
    if n_processes <= 1:
        return 0
    base = zlib.crc32(device_token.encode("utf-8"))
    best, best_h = 0, -1
    for p in range(n_processes):
        h = _fmix32(base ^ zlib.crc32(b"|%d" % p))
        if h > best_h:
            best, best_h = p, h
    return best


def split_lines(payload: bytes, n_processes: int) -> Dict[int, List[bytes]]:
    """Split one NDJSON wire payload into per-owner line lists.

    Lines that don't parse or carry no device token stay with the LOCAL
    intake (owner -1): the local dispatcher's decode path is the one
    that dead-letters them with full diagnostics, matching the
    failed-decode topic contract (``EventSourcesManager.java:189``).

    The native scanner (``native/swwire.c`` ``split_owner_lines``) reads
    each line's token without building objects; it bails to this Python
    path on anything whose ownership it could compute differently
    (escaped keys/tokens, non-string tokens) — routing must agree
    byte-for-byte cluster-wide or one device's stream would split
    across hosts.
    """
    # blank-line predicate MUST match the native scanner exactly (space/
    # tab/CR only — bytes.strip() would also drop \x0b/\x0c lines and
    # misalign the zip with the native owner array)
    lines = [ln for ln in payload.split(b"\n") if ln.strip(b" \t\r")]
    out: Dict[int, List[bytes]] = {}

    from sitewhere_tpu_torch.native import load_swwire

    sw = load_swwire()
    if sw is not None and hasattr(sw, "split_owner_lines"):
        owners = sw.split_owner_lines(payload, n_processes)
        # trust the alignment only when the enumerations provably agree —
        # a length mismatch (future predicate drift) must degrade to the
        # Python path, never zip-misroute rows cluster-wide
        if owners is not None and len(owners) == len(lines):
            for line, owner in zip(lines, owners):
                out.setdefault(owner, []).append(line)
            return out

    for line in lines:
        owner = -1
        try:
            env = json.loads(line)
            token = (env.get("deviceToken") or env.get("hardwareId")
                     if isinstance(env, dict) else None)
            if token:
                owner = owning_process(str(token), n_processes)
        except (ValueError, UnicodeDecodeError, RecursionError):
            # RecursionError: pathologically nested line (the native
            # scanner bails those to here at depth 128) — local intake
            pass
        out.setdefault(owner, []).append(line)
    return out


class HostForwarder(LifecycleComponent):
    """Per-host ingest boundary: local rows in-process, remote rows over
    the fabric, batched per peer under a flush deadline.

    ``peer_demuxes[p]`` is the :class:`RpcDemux` for process ``p``
    (``None`` at the local index).  Buffered remote rows flush when the
    buffer reaches ``max_buffer_bytes`` or ``deadline_ms`` elapses —
    the producer-side linger/batch knobs every Kafka producer has.  Each
    peer's sends run on their own thread, so a down peer's connect
    timeouts and backoffs delay only its own rows.  See the module
    docstring for the durable (``data_dir``) vs memory-only contract.

    Fleet health (``rpc/health.py``): the forwarder runs the
    ``fleet.heartbeat`` loop and keeps a :class:`PeerHealthTable` fed
    by heartbeats, per-call response piggybacks, and its own send
    failures.  A SUSPECT/DOWN/SHEDDING peer's sender parks its spool
    and sends ONE paced probe batch per interval (honoring the peer's
    Retry-After hint) instead of hammering full drains; a purely
    remote-owned payload whose owners advertise SHEDDING is refused at
    intake with the owner's hint so the device-facing edge (429 / 5.03
    / MQTT pause) reflects fleet-wide pressure.
    """

    def __init__(self, dispatcher, process_id: int,
                 peer_demuxes: Dict[int, Optional[RpcDemux]],
                 dead_letters=None,
                 deadline_ms: float = 25.0,
                 max_buffer_bytes: int = 1 << 20,
                 max_retries: int = 3,
                 data_dir: Optional[str] = None,
                 tracer=None,
                 metrics=None,
                 overload=None,
                 health: Optional[PeerHealthTable] = None,
                 heartbeat_interval_s: float = 0.5,
                 call_timeout_s: float = 10.0,
                 max_retained_bytes: Optional[int] = None,
                 device_unhealthy=None,
                 device_unhealthy_shards=None,
                 name: str = "host-forwarder"):
        super().__init__(name)
        self.dispatcher = dispatcher
        # span tracing of the DCN hop: each forwarded batch is one trace
        # whose client/server spans share a trace_id across hosts
        self.tracer = tracer
        # local handler for host-plane requests owned by this host
        # (set by the instance; see ingest_host_request)
        self.on_host_request = None
        self.process_id = process_id
        self.n_processes = len(peer_demuxes)
        self.peers = peer_demuxes
        self.dead_letters = dead_letters
        self.deadline_s = deadline_ms / 1000.0
        self.max_buffer_bytes = max_buffer_bytes
        self.max_retries = max_retries
        # this host's own overload controller: the heartbeat body and
        # response piggyback advertise ITS state to peers
        self.overload = overload
        self.heartbeat_interval_s = float(heartbeat_interval_s)
        # per-call budget: propagated as the deadline-ms header so the
        # owner rejects work this sender has already given up on
        self.call_timeout_s = float(call_timeout_s)
        # memory-mode retention bound for overload-shed rows (satellite
        # of the at-least-once contract: the owner WILL take them after
        # recovery, so they buffer instead of dead-lettering — until
        # this bound forces a replayable forward-shed drop)
        self.max_retained_bytes = (int(max_retained_bytes)
                                   if max_retained_bytes is not None
                                   else 4 * max_buffer_bytes)
        # restart epoch for the fleet heartbeat: a rebooted sender's
        # first beat replaces peers' stale view of us atomically
        self.incarnation = int(time.time())
        # zero-arg callable: this host's hung-step watchdog flag
        # (dispatcher.device_unhealthy) — advertised on every beat so
        # peers park forwards while OUR device tier is wedged
        self.device_unhealthy = device_unhealthy
        # zero-arg callable, mesh refinement of the flag above
        # (dispatcher.device_unhealthy_shards): which mesh shards the
        # wedge attributes to.  Empty = whole tier (single-chip, or an
        # unattributable wedge) — peers keep the conservative park.
        self.device_unhealthy_shards = device_unhealthy_shards
        # instance-scoped registry by default (a PRIVATE one when none
        # is injected — forwarders are per-instance objects and their
        # counters must never bleed across co-resident instances)
        self._metrics = metrics if metrics is not None else MetricsRegistry()
        # the forward.* family (analysis/metric_names.py): the canonical
        # observable surface — the legacy local_rows/forwarded_rows/
        # dead_lettered attributes are read-only VIEWS of these (one
        # source of truth; see the properties below)
        self._m_local = self._metrics.counter("forward.local_rows")
        self._m_forwarded = self._metrics.counter("forward.forwarded_rows")
        self._m_dead = self._metrics.counter("forward.dead_lettered")
        self._m_pending = self._metrics.gauge("forward.pending_rows")
        self._m_attempts = self._metrics.counter("forward.send_attempts")
        self._m_probes = self._metrics.counter("forward.probe_sends")
        self._m_shed_retained = self._metrics.counter(
            "forward.shed_retained")
        self._m_edge = self._metrics.counter("forward.edge_refusals")
        self._m_hb_sent = self._metrics.counter("forward.heartbeats_sent")
        self._m_hb_fail = self._metrics.counter("forward.heartbeats_failed")
        self._m_deadline = self._metrics.counter("forward.deadline_expired")
        # the peer health table (rpc/health.py): parked senders, paced
        # probes, and the device-facing owner-pressure gate all read it
        remote = [p for p, d in peer_demuxes.items() if d is not None]
        if health is None:
            if self.heartbeat_interval_s > 0:
                health = PeerHealthTable(
                    remote,
                    heartbeat_interval_s=self.heartbeat_interval_s,
                    metrics=self._metrics)
            else:
                # no heartbeat loop: silence means nothing (only
                # forward traffic refreshes last_heard), so the
                # interval detector must not declare idle peers dead —
                # the send-failure streak remains the liveness signal
                health = PeerHealthTable(
                    remote, metrics=self._metrics,
                    suspect_after_s=float("inf"),
                    down_after_s=float("inf"))
        self.health = health
        # response piggyback: every reply from peer p (any method, error
        # frames included) refreshes p's overload state in the table
        self._bind_piggyback(peer_demuxes)
        self._heartbeater: Optional[threading.Thread] = None
        self._lock = threading.Lock()     # buffers + counters + sender set
        # memory-mode buffers
        self._buffers: Dict[int, List[bytes]] = {}
        self._buffer_bytes: Dict[int, int] = {}
        self._buffer_since: Dict[int, float] = {}
        # durable-mode spools: write-ahead journal per remote peer, one
        # sender at a time per peer (the owner lock keeps the reader's
        # poll→send→commit sequence atomic)
        self._spools: Dict[int, Journal] = {}
        self._spool_readers: Dict[int, JournalReader] = {}
        self._owner_locks: Dict[int, threading.Lock] = {}
        self._spool_since: Dict[int, float] = {}
        # rows retained per owner in durable spools (records are
        # multi-row payloads; see the boot-time count below)
        self._pending_rows: Dict[int, int] = {}
        # consecutive deadline expiries per owner: a healthy-looking
        # peer rejecting every call pre-dispatch usually means host
        # clock skew larger than the call budget — surfaced loudly
        self._deadline_streaks: Dict[int, int] = {}
        self._data_dir = data_dir
        # membership generation: ownership is computed OUTSIDE the lock
        # (split_lines is the expensive part), then buffered atomically
        # against this counter — a membership swap mid-split makes the
        # caller recompute instead of appending under a stale map (and
        # possibly into a spool being retired).  In-flight LOCAL rows
        # count as processed-before-the-change (they complete locally).
        self._member_gen = 0
        if data_dir is not None:
            for p, demux in peer_demuxes.items():
                if demux is None:
                    continue
                # small segments so delivered traffic prunes promptly
                # (the spool's committed prefix has no future readers)
                spool = Journal(data_dir, name=f"forward-{p}",
                                fsync_every=64, segment_bytes=4 << 20)
                self._spools[p] = spool
                self._spool_readers[p] = JournalReader(spool, "sender")
                # ROW-accurate backlog: spool records are multi-row
                # joined payloads, so reader.lag (records) would
                # under-report; count the surviving uncommitted tail
                # once at boot, then track appends/commits
                self._pending_rows[p] = sum(
                    payload.count(b"\n") + 1 for _, payload in
                    spool.scan(self._spool_readers[p].committed))
        for p, demux in peer_demuxes.items():
            if demux is not None:
                self._owner_locks[p] = threading.Lock()
        self._senders: set = set()
        self._active_owners: set = set()
        self._flusher: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # legacy counter surface: read-only views of the registry counters
    # (one source of truth — an increment site cannot forget one half)

    @property
    def local_rows(self) -> int:
        return int(self._m_local.value)

    @property
    def forwarded_rows(self) -> int:
        return int(self._m_forwarded.value)

    @property
    def dead_lettered(self) -> int:
        return int(self._m_dead.value)

    @property
    def durable(self) -> bool:
        return bool(self._spools)

    def _bind_piggyback(self, peer_demuxes) -> None:
        """Tap every peer demux's response headers into the health
        table (the per-call overload piggyback intake)."""
        for p, demux in peer_demuxes.items():
            if demux is not None and hasattr(demux, "set_header_listener"):
                demux.set_header_listener(
                    lambda h, _p=p: self.health.observe_piggyback(_p, h))

    # -- intake --------------------------------------------------------------

    def _edge_backpressure(self, remote, n_local: int,
                           critical_fn) -> None:
        """Device-facing owner-pressure gate: a payload whose rows are
        ALL remote-owned by SHEDDING+ owners is refused with the
        OWNER's Retry-After hint — the receiving transport turns it
        into HTTP 429 / CoAP 5.03 / an MQTT pause, so fleet-wide
        backpressure reaches the device that can act on it.

        Refusal is whole-payload (the intake-shed granularity): nothing
        was accepted or buffered, the device owns the retry, and the
        owner's admission re-decides then.  Payloads with any local
        share, any possibly-CRITICAL row, or any healthy owner forward
        as usual — the spool absorbs the pressure instead."""
        if n_local or not remote:
            return
        worst: Optional[tuple] = None
        for owner in remote:
            pressure = self.health.owner_pressure(owner)
            if pressure is None:
                return          # at least one owner can take traffic
            if worst is None or pressure[0] > worst[0]:
                worst = pressure
        # the (comparatively pricey) critical scan runs LAST — only for
        # a purely remote payload whose owners all advertise SHEDDING
        if critical_fn():
            return
        state, retry_after_s = worst
        self._m_edge.inc()
        raise OverloadShed(
            PriorityClass.TELEMETRY,
            OverloadState(min(int(state), int(OverloadState.EMERGENCY))),
            retry_after_s,
            reason=f"remote owner(s) {sorted(remote)} shedding")

    def ingest_payload(self, payload: bytes, source_id: str = "wire",
                       raise_on_decode_error: bool = False) -> int:
        """Route one NDJSON payload.  Returns rows accepted LOCALLY
        (remote rows are accepted by their owner asynchronously).

        ``raise_on_decode_error`` passes through to the local columnar
        decode (see ``PipelineDispatcher.ingest_wire_lines``): malformed
        lines split to the local bucket, so a raw_wire source's failure
        accounting works unchanged in multi-host topologies."""
        while True:
            with self._lock:
                gen, n, pid = (self._member_gen, self.n_processes,
                               self.process_id)
            by_owner = split_lines(payload, n)
            local: List[bytes] = []
            remote: Dict[int, List[bytes]] = {}
            for owner, lines in by_owner.items():
                if owner in (-1, pid):
                    local.extend(lines)
                else:
                    remote[owner] = lines
            # BEFORE buffering anything: a purely-remote payload whose
            # owners advertise SHEDDING is refused outright with the
            # owners' hint (the device retries; nothing duplicates)
            self._edge_backpressure(
                remote, len(local),
                lambda p=payload: _has_critical_marker(p))
            if self._route_remote(remote, gen):
                break  # else: membership changed mid-split; recompute
        accepted = 0
        if local:
            accepted = self.dispatcher.ingest_wire_lines(
                b"\n".join(local), source_id=source_id,
                raise_on_decode_error=raise_on_decode_error)
            self._m_local.inc(accepted)
        return accepted

    def ingest_requests(self, reqs, payload: bytes = b"",
                        source_id: str = "wire") -> int:
        """Route one payload's already-decoded requests (the protocol
        sources' batch-forward path).  Local rows take the dispatcher's
        columnar intake; remote rows re-encode to the wire envelope and
        ship with the next batch to their owner.  Returns rows accepted
        locally."""
        from sitewhere_tpu_torch.ingest.decoders import encode_envelope

        while True:
            with self._lock:
                gen, n, pid = (self._member_gen, self.n_processes,
                               self.process_id)
            local = []
            remote: Dict[int, List[bytes]] = {}
            critical_possible = False
            for req in reqs:
                owner = owning_process(req.device_token, n)
                if (req.event_type is None
                        or classify_event_type(int(req.event_type))
                        != PriorityClass.TELEMETRY):
                    critical_possible = True   # decoded: classify exactly
                if owner == pid:
                    local.append(req)
                else:
                    remote.setdefault(owner, []).append(encode_envelope(req))
            self._edge_backpressure(remote, len(local),
                                    lambda c=critical_possible: c)
            if self._route_remote(remote, gen):
                break  # else: membership changed mid-split; recompute
        if local:
            # A split payload must NOT journal whole here: replaying it
            # would re-ingest the remote rows on the wrong host.  Journal
            # a local-only re-encoding instead (each owner's journal holds
            # exactly its partition's rows — a partition log, precisely).
            if remote:
                payload = b"\n".join(encode_envelope(r) for r in local)
            self.dispatcher.ingest_many(local, payload)
            self._m_local.inc(len(local))
        return len(local)

    def ingest_registration(self, req, payload: bytes = b"") -> None:
        """Registrations route like events: the owning host mints the
        device (dense handles are host-local, so registration MUST land
        where the device's shard lives)."""
        from sitewhere_tpu_torch.ingest.decoders import encode_envelope

        while True:
            with self._lock:
                gen, n, pid = (self._member_gen, self.n_processes,
                               self.process_id)
            owner = owning_process(req.device_token, n)
            if owner == pid:
                self.dispatcher.ingest_registration(req, payload)
                return
            if self._route_remote({owner: [encode_envelope(req)]}, gen):
                return  # else: membership changed; recompute the owner

    def ingest_host_request(self, req, payload: bytes = b"") -> None:
        """Host-plane requests (device streams) route like registrations:
        streams are assignment-scoped and the device model lives on the
        owning host, so the request must land there.  The owner handles
        it through ``on_host_request`` (set by the instance)."""
        from sitewhere_tpu_torch.ingest.decoders import encode_envelope

        while True:
            with self._lock:
                gen, n, pid = (self._member_gen, self.n_processes,
                               self.process_id)
            owner = owning_process(req.device_token, n)
            if owner == pid:
                if self.on_host_request is not None:
                    self.on_host_request(req, payload)
                return
            if self._route_remote({owner: [encode_envelope(req)]}, gen):
                return  # else: membership changed; recompute the owner

    def _route_remote(self, remote: Dict[int, List[bytes]],
                      gen: int) -> bool:
        """Atomically buffer per-owner line lists whose ownership was
        computed under membership generation ``gen``; False when the
        membership changed underneath (caller must recompute owners).
        """
        kicks: List[int] = []
        drops: List[tuple] = []
        with self._lock:
            if gen != self._member_gen:
                return False
            for owner, lines in remote.items():
                if self.durable:
                    # write-ahead: the spool IS the buffer, so a crash
                    # between intake and send replays on restart.  The
                    # append stays under the lock so a membership swap
                    # can never retire a spool with an append in flight.
                    spool = self._spools.get(owner)
                    if spool is None:
                        drops.append((owner, b"\n".join(lines),
                                      "no spool for peer"))
                        continue
                    spool.append(b"\n".join(lines))
                    self._pending_rows[owner] = (
                        self._pending_rows.get(owner, 0) + len(lines))
                    self._spool_since.setdefault(owner, time.monotonic())
                    if (self._spool_readers[owner].lag
                            >= SPOOL_POLL_RECORDS):
                        kicks.append(owner)
                    continue
                buf = self._buffers.setdefault(owner, [])
                if not buf:
                    self._buffer_since[owner] = time.monotonic()
                buf.extend(lines)
                self._buffer_bytes[owner] = (
                    self._buffer_bytes.get(owner, 0)
                    + sum(len(l) + 1 for l in lines))
                if self._buffer_bytes[owner] >= self.max_buffer_bytes:
                    kicks.append(owner)
        for owner, payload, reason in drops:
            self._dead_letter(owner, payload, reason)
        for owner in kicks:
            # off the ingest caller's thread: a slow/down peer must not
            # stall the frontend that happened to fill this buffer
            self._send_async(owner)
        return True

    def _drain_memory_locked(self, owner: int) -> Optional[bytes]:
        lines = self._buffers.pop(owner, None)
        self._buffer_bytes.pop(owner, None)
        self._buffer_since.pop(owner, None)
        if not lines:
            return None
        return b"\n".join(lines)

    # -- egress --------------------------------------------------------------

    def _send_async(self, owner: int) -> Optional[threading.Thread]:
        """Each peer's batches ship on their own thread: a down peer's
        connect timeouts + retry backoffs delay only ITS rows, never a
        healthy peer's (Kafka producers isolate brokers the same way).
        One sender per owner at a time — a down peer's still-retrying
        sender must not accrete a queue of blocked duplicates behind the
        owner lock on every flusher tick."""
        with self._lock:
            if owner in self._active_owners:
                return None
            self._active_owners.add(owner)

        def run():
            drained_clean = False
            try:
                drained_clean = self._drain_owner(owner)
            finally:
                with self._lock:
                    self._active_owners.discard(owner)
                    self._senders.discard(threading.current_thread())
                    rekick = drained_clean and self._owner_pending_locked(owner)
                # close the check-then-act window: rows buffered between
                # this sender's last empty poll and the discard above
                # would otherwise strand until the next flusher tick
                # (which may never come during stop).  Only after a CLEAN
                # drain — a peer-down exit must wait for the next tick,
                # not hot-loop.
                if rekick:
                    self._send_async(owner)

        t = threading.Thread(target=run,
                             name=f"{self.name}-send-{owner}", daemon=True)
        # started before it is published: ``flush(wait=True)`` joins
        # every thread of ``_senders``, and joining one not yet started
        # raises (the reference publishes first, a race its
        # flapping-membership test hits under load)
        with self._lock:
            t.start()
            self._senders.add(t)
        return t

    def _owner_pending_locked(self, owner: int) -> bool:
        if self.durable:
            reader = self._spool_readers.get(owner)
            return reader is not None and reader.lag > 0
        return bool(self._buffers.get(owner))

    def _drain_owner(self, owner: int) -> bool:
        """Send everything pending for one peer.  The per-owner lock
        serializes senders so the spool reader's poll→send→commit is
        atomic and batches stay ordered per peer.  Returns True on a
        clean drain (emptied), False when rows were retained (peer
        unreachable / shedding / parked).

        Health gate: a SUSPECT/DOWN/SHEDDING peer's sender PARKS — at
        most one paced probe batch per probe interval instead of a full
        drain — so an unhealthy peer costs the fleet a bounded trickle,
        not a retry storm.  A delivered probe whose piggyback shows
        recovery resumes the full drain in the same pass."""
        lock = self._owner_locks.get(owner)
        if lock is None:
            return True
        with lock:
            probing = False
            if not self.health.can_drain(owner):
                if not self.health.probe_due(owner):
                    return False     # parked: rows stay put, no attempt
                probing = True
                self._m_probes.inc()
            if not self.durable:
                with self._lock:
                    payload = self._drain_memory_locked(owner)
                if payload is not None:
                    outcome = self._deliver(owner, payload, probe=probing)
                    if outcome == _SHED:
                        # the owner WILL take these rows after recovery:
                        # keep them buffered (bounded) instead of
                        # dead-lettering work that isn't dead
                        self._retain_shed(owner, payload)
                        return False
                    if outcome == _DOWN:
                        if self._stop.is_set():
                            # stopping: fire-and-forget mode records the
                            # loss rather than silently vanishing with
                            # the process
                            self._dead_letter(
                                owner, payload,
                                f"peer {owner} unreachable at stop")
                            return True
                        self._dead_letter(
                            owner, payload,
                            f"peer {owner} unreachable after "
                            f"{self.max_retries} attempts")
                return True
            reader = self._spool_readers[owner]
            while True:
                start = reader.position
                records = reader.poll(1 if probing else SPOOL_POLL_RECORDS)
                if not records:
                    with self._lock:
                        self._spool_since.pop(owner, None)
                    return True
                # kill window under test: rows polled (reader.position
                # advanced in memory) but the peer has not acked — a
                # SIGKILL here must replay this tail from the committed
                # offset on restart (crashrec_bench crash.mid_forward)
                faults.crosspoint("crash.mid_forward")
                payload = b"\n".join(r for _, r in records)
                outcome = self._deliver(owner, payload, probe=probing)
                if outcome == _OK:
                    reader.commit()
                    with self._lock:
                        self._pending_rows[owner] = max(
                            0, self._pending_rows.get(owner, 0)
                            - (payload.count(b"\n") + 1))
                    # delivered prefix has no future readers: reclaim
                    # whole segments below the commit (Kafka retention
                    # at the commit frontier)
                    self._spools[owner].prune(reader.committed)
                    if probing and not self.health.can_drain(owner):
                        # probe landed but the owner still sheds (its
                        # piggyback said so): stay paced
                        return False
                    probing = False
                    continue
                # peer down or shedding: rows stay spooled (a down
                # broker's partition log); rewind and let the paced
                # probe schedule own the redelivery
                reader.seek(start)
                logger.warning(
                    "peer %d %s; %d spooled batches retained", owner,
                    "shedding" if outcome == _SHED else "unreachable",
                    reader.lag)
                return False

    def _retain_shed(self, owner: int, payload: bytes) -> None:
        """Memory-mode shed retention: push the refused lines back to
        the FRONT of the buffer (order preserved) under
        ``max_retained_bytes``; overflow dead-letters the OLDEST lines
        with the replayable ``forward-shed`` kind (mirroring the intake
        path's ``intake-shed`` contract — audit + requeue, not loss)."""
        lines = payload.split(b"\n")
        dropped: List[bytes] = []
        with self._lock:
            buf = self._buffers.setdefault(owner, [])
            self._buffer_since.setdefault(owner, time.monotonic())
            buf[:0] = lines
            size = self._buffer_bytes.get(owner, 0) \
                + sum(len(l) + 1 for l in lines)
            while size > self.max_retained_bytes and buf:
                line = buf.pop(0)
                size -= len(line) + 1
                dropped.append(line)
            self._buffer_bytes[owner] = size
        self._m_shed_retained.inc(max(0, len(lines) - len(dropped)))
        if dropped:
            self._dead_letter(
                owner, b"\n".join(dropped),
                f"shed-retention bound ({self.max_retained_bytes}B) "
                f"exceeded while peer {owner} sheds",
                kind="forward-shed")

    def _deliver(self, owner: int, payload: bytes,
                 probe: bool = False) -> str:
        """One batch to one peer with bounded retries.  ``_OK`` on
        success or non-retryable rejection (which dead-letters);
        ``_DOWN`` when the peer is unreachable; ``_SHED`` when the
        owner's admission refused the rows (both retain — the caller
        decides spool-rewind vs re-buffer vs dead-letter)."""
        demux = self.peers.get(owner)
        if demux is None:
            self._dead_letter(owner, payload, "no demux for peer")
            return _OK
        rows = payload.count(b"\n") + 1
        trace = (self.tracer.trace("forward.batch")
                 if self.tracer is not None else _NOOP_TRACE)
        try:
            # root span names the DCN hop; the per-attempt
            # rpc.client.events.ingest spans share its trace_id
            with trace.span("forward.batch") as span:
                span.tag("peer", owner).tag("rows", rows)
                if probe:
                    span.tag("probe", 1)
                outcome = self._deliver_traced(owner, payload, demux, rows,
                                               trace, probe)
                if outcome == _DOWN:
                    # exhausted retries: flag the hop so tail sampling
                    # retains the trace of an unreachable peer
                    span.error = "peer unreachable: retries exhausted"
                return outcome
        finally:
            trace.end()

    def _deliver_traced(self, owner: int, payload: bytes, demux,
                        rows: int, trace, probe: bool = False) -> str:
        attempts = 1 if probe else self.max_retries
        for attempt in range(attempts):
            self._m_attempts.inc()
            try:
                body, _ = demux.call(
                    "events.ingest",
                    {"sourceId": f"fwd:{self.process_id}"},
                    attachment=payload, trace=trace,
                    timeout_s=self.call_timeout_s,
                    deadline_s=self.call_timeout_s)
                self._m_forwarded.inc(int(body.get("accepted", rows)))
                self._deadline_streaks.pop(owner, None)
                self.health.observe_alive(owner)
                return _OK
            except ChannelUnavailable as e:
                logger.info("forward to %d failed (%d/%d): %s", owner,
                            attempt + 1, attempts, e)
                self.health.observe_failure(owner)
                # stop-aware backoff: stop() must not wait out 2s-grade
                # sleeps on sender threads — the wait aborts the moment
                # the stop event sets and the retry loop exits
                if self._stop.wait(min(0.1 * (2 ** attempt), 2.0)):
                    return _DOWN
            except DeadlineExpired as e:
                # the budget died, not the peer: rows are retained and
                # the next paced pass retries with a fresh budget
                logger.info("forward to %d deadline expired (%d/%d): %s",
                            owner, attempt + 1, attempts, e)
                self._m_deadline.inc()
                # deadline-ms is wall-clock: a peer that answers but
                # rejects EVERY call pre-dispatch usually means host
                # clock skew larger than call_timeout_s — without this
                # the spool grows silently (the peer looks ALIVE)
                streak = self._deadline_streaks.get(owner, 0) + 1
                self._deadline_streaks[owner] = streak
                if streak % 5 == 0:
                    logger.warning(
                        "%d consecutive deadline expiries toward peer "
                        "%d; if the peer is otherwise healthy, check "
                        "host clock sync (the deadline-ms header is "
                        "wall-clock epoch)", streak, owner)
                if self._stop.wait(min(0.1 * (2 ** attempt), 2.0)):
                    return _DOWN
            except RpcError as e:
                if getattr(e, "error", "") == "overloaded":
                    # the owner SHED the rows (admission backpressure):
                    # record its advertised state (the error frame's
                    # piggyback headers carried it) and PARK — the
                    # paced probe schedule redelivers once it recovers,
                    # never a dead-letter for rows the owner will take
                    logger.info("forward to %d shed by overload", owner)
                    self.health.observe_alive(owner)
                    pressure = self.health.owner_pressure(owner)
                    if pressure is None:
                        # no piggyback reached us (older peer): assume
                        # SHEDDING with the default hint so pacing holds
                        self.health.observe_heartbeat(
                            owner, overload_state=int(
                                OverloadState.SHEDDING),
                            retry_after_s=1.0)
                    return _SHED
                self.health.observe_alive(owner)   # it answered
                self._dead_letter(owner, payload, f"peer rejected: {e}")
                return _OK
        return _DOWN

    def _dead_letter(self, owner: int, payload: bytes, reason: str,
                     kind: str = "undeliverable-forward") -> None:
        self._m_dead.inc(payload.count(b"\n") + 1)
        logger.warning("dead-lettering forward batch for peer %d: %s",
                       owner, reason)
        if self.dead_letters is not None:
            doc = {
                "kind": kind,
                "peer": owner,
                "reason": reason,
            }
            if kind == "forward-shed":
                # replayable contract (mirrors intake-shed): hex payload
                # so Instance.requeue_dead_letter re-routes it through
                # ingest_payload once the owner recovers
                doc["payload"] = payload.hex()
                doc["state"] = self.health.snapshot().get(
                    str(owner), {}).get("overload", "SHEDDING")
            else:
                doc["payload"] = payload.decode("utf-8", "replace")
            self.dead_letters.append_json(doc)

    # -- lifecycle -----------------------------------------------------------

    def _flush_loop(self) -> None:
        while not self._stop.wait(self.deadline_s / 2):
            self.flush(only_expired=True)
            self.health.tick()

    def _heartbeat_loop(self) -> None:
        """The fleet heartbeat: every interval, one ``fleet.heartbeat``
        per remote peer carrying this host's overload state, Retry-After
        hint, per-peer pending spool lag, and incarnation; the RESPONSE
        body is the peer's same record, so one exchange teaches both
        directions.  Failures feed the failure detector — the heartbeat
        IS the liveness probe for peers with no traffic."""
        while not self._stop.wait(self.heartbeat_interval_s):
            with self._lock:
                peers = [(p, d) for p, d in self.peers.items()
                         if d is not None]
            for p, demux in peers:
                if self._stop.is_set():
                    return
                try:
                    body, _ = demux.call(
                        "fleet.heartbeat", self.heartbeat_body(p),
                        timeout_s=max(1.0, 2 * self.heartbeat_interval_s),
                        deadline_s=max(1.0, 2 * self.heartbeat_interval_s))
                    self._m_hb_sent.inc()
                    self.observe_peer_heartbeat(p, body)
                except ChannelUnavailable:
                    self._m_hb_fail.inc()
                    self.health.observe_failure(p)
                except DeadlineExpired:
                    # NEUTRAL: a client-side budget lapse (e.g. every
                    # replica's connect timeout burned it) is not
                    # liveness evidence — counting it as life would pin
                    # a dead peer ALIVE forever.  A server-side
                    # rejection DID answer, but its piggyback headers
                    # already fed observe_piggyback via the channel's
                    # header listener, so nothing is lost here.
                    self._m_hb_fail.inc()
                except RpcError:
                    # the peer ANSWERED (an old peer without the method
                    # says not_found): liveness evidence, no state
                    self._m_hb_sent.inc()
                    self.health.observe_alive(p)
            self.health.tick()
            self._m_pending.set(self.pending_rows())

    def heartbeat_body(self, target: int) -> Dict[str, object]:
        """This host's health record as the heartbeat wire shape."""
        state, retry_after = 0, 0.0
        if self.overload is not None:
            state = int(self.overload.state)
            retry_after = float(self.overload.retry_after())
        unhealthy = False
        if self.device_unhealthy is not None:
            try:
                unhealthy = bool(self.device_unhealthy())
            except Exception:
                logger.exception("device_unhealthy probe failed")
        shards: list = []
        if unhealthy and self.device_unhealthy_shards is not None:
            try:
                shards = [int(s) for s in self.device_unhealthy_shards()]
            except Exception:
                logger.exception("device_unhealthy_shards probe failed")
        return {
            "processId": int(self.process_id),
            "incarnation": int(self.incarnation),
            "state": state,
            "retryAfterS": round(retry_after, 3),
            "spoolLag": int(self.pending_for(target)),
            "deviceUnhealthy": unhealthy,
            "unhealthyShards": shards,
        }

    def observe_peer_heartbeat(self, peer: int, body) -> None:
        """Feed one heartbeat body (request or response side) into the
        health table — the ``fleet.heartbeat`` server handler calls this
        so receiving a beat teaches as much as sending one."""
        if not isinstance(body, dict):
            return
        try:
            self.health.observe_heartbeat(
                int(peer),
                incarnation=int(body.get("incarnation", 0)),
                overload_state=int(body.get("state", 0)),
                retry_after_s=float(body.get("retryAfterS", 0.0)),
                spool_lag=int(body.get("spoolLag", 0)),
                device_unhealthy=bool(body.get("deviceUnhealthy", False)),
                unhealthy_shards=tuple(
                    int(s) for s in body.get("unhealthyShards", ()) or ()))
        except (TypeError, ValueError):
            logger.warning("malformed heartbeat from peer %s ignored", peer)

    def pending_for(self, owner: int) -> int:
        """Rows currently retained toward one peer (spool or buffer —
        ROW units in both modes; spool records are multi-row payloads,
        so reader.lag would under-report)."""
        with self._lock:
            if self.durable:
                return int(self._pending_rows.get(owner, 0))
            return len(self._buffers.get(owner, ()))

    def pending_rows(self) -> int:
        with self._lock:
            if self.durable:
                return sum(self._pending_rows.get(o, 0)
                           for o in self._spool_readers)
            return sum(len(v) for v in self._buffers.values())

    def _pending_owners(self, only_expired: bool) -> List[int]:
        now = time.monotonic()
        with self._lock:
            if self.durable:
                since = self._spool_since
                owners = [o for o, r in self._spool_readers.items()
                          if r.lag > 0]
            else:
                since = self._buffer_since
                owners = list(self._buffers)
            if only_expired:
                owners = [o for o in owners
                          if now - since.get(o, 0.0) >= self.deadline_s]
        # parked peers whose probe slot hasn't come up yet are skipped
        # OUTSIDE the lock (health's lock is a leaf): no sender thread
        # is spawned just to park — the flusher tick stays O(healthy)
        return [o for o in owners
                if self.health.can_drain(o) or self.health.probe_ready(o)]

    def flush(self, only_expired: bool = False, wait: bool = False) -> None:
        for owner in self._pending_owners(only_expired):
            self._send_async(owner)
        if wait:
            with self._lock:
                threads = list(self._senders)
            for t in threads:
                t.join(timeout=self.max_retries * 5.0 + 5.0)

    def start(self) -> None:
        self._stop.clear()
        self._flusher = threading.Thread(
            target=self._flush_loop, name=f"{self.name}-flush", daemon=True)
        self._flusher.start()
        if self.heartbeat_interval_s > 0 and any(
                d is not None for d in self.peers.values()):
            self._heartbeater = threading.Thread(
                target=self._heartbeat_loop,
                name=f"{self.name}-heartbeat", daemon=True)
            self._heartbeater.start()
        # crash recovery: anything spooled-but-uncommitted from a prior
        # run ships now (replay-from-offset, MicroserviceKafkaConsumer
        # semantics applied to the producer side)
        if self.durable:
            self.flush()
        super().start()

    def stop(self) -> None:
        self._stop.set()
        if self._flusher is not None:
            self._flusher.join(timeout=5)
            self._flusher = None
        if self._heartbeater is not None:
            self._heartbeater.join(timeout=5)
            self._heartbeater = None
        self.flush(wait=True)
        if not self.durable:
            # fire-and-forget mode: rows still buffered for parked /
            # shedding peers die with the process — audit them as
            # replayable forward-shed records instead of vanishing
            with self._lock:
                leftovers = [o for o, buf in self._buffers.items() if buf]
            for owner in leftovers:
                with self._lock:
                    payload = self._drain_memory_locked(owner)
                if payload:
                    self._dead_letter(
                        owner, payload,
                        f"rows retained for parked peer {owner} at stop "
                        "(memory mode)", kind="forward-shed")
        for spool in self._spools.values():
            spool.close()
        super().stop()

    def apply_membership(
            self, peer_demuxes: Dict[int, Optional[RpcDemux]],
            process_id: Optional[int] = None) -> int:
        """Adopt a NEW peers map (count may change) and requeue every
        pending row under the new ownership — the consumer-rebalance
        analog: a departed peer's spooled rows go to their new owners
        (or the local intake) instead of waiting for a host that will
        never return.  Returns rows requeued.

        The caller (Instance.apply_membership_change) is responsible for
        record handoff (:mod:`sitewhere_tpu_torch.rpc.migration`); this method
        only moves the in-flight forwarding state.
        """
        # Drain-stop current senders: swap under a quiet fabric so no
        # sender is mid-poll on a spool we are about to requeue.
        with self._lock:
            old_locks = list(self._owner_locks.values())
        for lock in old_locks:
            lock.acquire()
        old_tails: List[tuple] = []  # (reader, journal, end_position)
        try:
            with self._lock:
                pending: List[bytes] = []
                # memory buffers
                for owner in list(self._buffers):
                    payload = self._drain_memory_locked(owner)
                    if payload:
                        pending.append(payload)
                # durable spools: read (but do NOT commit yet) every
                # uncommitted tail — the old offsets advance only after
                # the rows are durably re-placed, so a crash mid-requeue
                # replays them (at-least-once), never loses them
                for owner, reader in list(self._spool_readers.items()):
                    while True:
                        records = reader.poll(SPOOL_POLL_RECORDS)
                        if not records:
                            break
                        pending.extend(r for _, r in records)
                    old_tails.append(
                        (reader, self._spools[owner], reader.position))
                    self._spool_since.pop(owner, None)
                # every spool tail is in `pending` now: the row counts
                # rebuild as the re-ingest below re-routes them
                self._pending_rows = {}

                if process_id is not None:
                    self.process_id = process_id
                self.peers = dict(peer_demuxes)
                self.n_processes = len(peer_demuxes)
                # any split computed under the old map must recompute
                # (see _route_remote's generation check)
                self._member_gen += 1
                # spools/locks for the new peer set (existing Journal
                # objects are reused so their files stay continuous)
                new_spools: Dict[int, Journal] = {}
                new_readers: Dict[int, JournalReader] = {}
                new_locks: Dict[int, threading.Lock] = {}
                durable_root = self._data_dir
                for p, demux in peer_demuxes.items():
                    if demux is None:
                        continue
                    new_locks[p] = self._owner_locks.get(
                        p, threading.Lock())
                    if p in self._spools:
                        new_spools[p] = self._spools[p]
                        new_readers[p] = self._spool_readers[p]
                    elif durable_root is not None:
                        spool = Journal(durable_root, name=f"forward-{p}",
                                        fsync_every=64,
                                        segment_bytes=4 << 20)
                        new_spools[p] = spool
                        new_readers[p] = JournalReader(spool, "sender")
                # departed peers' spools close in the finalize phase
                # below, after their rows are durably re-placed
                self._spools = new_spools
                self._spool_readers = new_readers
                self._owner_locks = new_locks
        finally:
            for lock in old_locks:
                lock.release()

        # health plane follows the membership: departed peers drop out
        # of the table, joiners start optimistic; piggyback taps rebind
        self.health.set_peers(
            [p for p, d in peer_demuxes.items() if d is not None])
        self._bind_piggyback(peer_demuxes)

        # Re-ingest outside every lock: rows route freshly under the new
        # map (local rows journal in the dispatcher, remote rows spool
        # for their new owners) — durably re-placed BEFORE the old
        # offsets commit below.
        requeued = 0
        for payload in pending:
            requeued += payload.count(b"\n") + 1
            self.ingest_payload(payload, source_id="membership-requeue")
        for reader, journal, end in old_tails:
            try:
                if end > reader.committed:
                    reader.commit(end)
                journal.prune(reader.committed)
                if journal not in self._spools.values():
                    journal.close()  # departed peer's spool, fully drained
            except Exception:
                logger.exception("old spool finalize failed (harmless: "
                                 "its rows replay as duplicates)")
        if requeued:
            logger.info("membership change: requeued %d pending rows "
                        "under the new ownership", requeued)
        self.flush()
        return requeued

    def metrics(self) -> Dict[str, object]:
        """Topology/admin view.  The canonical observable surface is the
        registered ``forward.*`` metric family (counters, the pending
        gauge, per-peer health-state gauges) — this dict is a snapshot
        of the same numbers plus the health table."""
        with self._lock:
            if self.durable:
                pending = sum(self._pending_rows.get(o, 0)
                              for o in self._spool_readers)
            else:
                pending = sum(len(v) for v in self._buffers.values())
            out = {
                "local_rows": self.local_rows,
                "forwarded_rows": self.forwarded_rows,
                "dead_lettered": self.dead_lettered,
                "pending": pending,
                "durable": self.durable,
            }
        self._m_pending.set(pending)
        out["send_attempts"] = int(self._m_attempts.value)
        out["probe_sends"] = int(self._m_probes.value)
        out["edge_refusals"] = int(self._m_edge.value)
        out["peers"] = self.health.snapshot()
        return out
