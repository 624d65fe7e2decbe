"""Inbound event sources: protocol receivers + decode + dedupe + forward.

Reference: ``service-event-sources`` — an ``InboundEventSource`` composes a
list of ``IInboundEventReceiver`` s with one ``IDeviceEventDecoder`` and an
optional deduplicator (``sources/InboundEventSource.java:35-309``;
``onEncodedEventReceived:189-199`` → decode → dedupe → forward), and the
``EventSourcesManager`` forwards decoded events / registrations / failed
decodes to their Kafka topics (``EventSourcesManager.java:153-189``).

Here the forward targets are callables (wired to journals + batcher by the
runtime), and receivers are threads owning sockets:

- :class:`TcpReceiver` — raw TCP with pluggable framing (reference:
  ``socket/SocketInboundEventReceiver.java`` + interaction handlers).
- :class:`UdpReceiver` — one datagram = one raw payload.
- :class:`HttpReceiver` — HTTP POST endpoint (reference REST receivers).
- :class:`MqttReceiver` — broker subscription via the stdlib MQTT client
  (reference ``mqtt/MqttInboundEventReceiver.java``).
- :class:`PollingRestReceiver` — periodic HTTP GET poll (reference
  ``rest/PollingRestInboundEventReceiver.java``).
- :class:`WebSocketReceiver` — client pulling payloads from a remote WS
  endpoint with auto-reconnect (reference
  ``websocket/WebSocketEventReceiver.java``).
- :class:`sitewhere_tpu_torch.ingest.coap.CoapServerReceiver` — RFC 7252 CoAP
  server (reference ``coap/CoapServerEventReceiver.java``).
- :class:`sitewhere_tpu_torch.ingest.stomp.StompReceiver` — STOMP 1.2 broker
  subscription with per-message acks; ActiveMQ and RabbitMQ both speak
  STOMP natively, so this covers the reference's
  ``activemq/ActiveMQClientEventReceiver.java`` and
  ``rabbitmq/RabbitMqInboundEventReceiver.java`` without their client
  stacks.

Azure EventHub (proprietary AMQP dialect behind SAS auth) stays gated: its
role (durable broker buffering) is covered by the journal + the STOMP/MQTT
receivers, and the receiver SPI accepts new implementations.

Counterpart of ``sitewhere_tpu/ingest/sources.py``, whole: host code
of the standard library, which touches no tensor; the port's
``Instance.add_source`` wires it to the dispatcher.
"""

from __future__ import annotations

import collections
import errno
import http.server
import logging
import socket
import struct
import threading
import time
import urllib.request
from typing import Callable, Dict, List, Optional

logger = logging.getLogger("sitewhere_tpu_torch.ingest")

from sitewhere_tpu_torch.ingest.decoders import DecodedRequest, DecodeError, RequestKind
from sitewhere_tpu_torch.runtime import faults
from sitewhere_tpu_torch.runtime.lifecycle import LifecycleComponent
from sitewhere_tpu_torch.runtime.overload import OverloadShed
from sitewhere_tpu_torch.runtime.resilience import Backoff, RetryPolicy, Supervisor

Decoder = Callable[[bytes], List[DecodedRequest]]
Forward = Callable[[DecodedRequest, bytes], None]
FailedDecode = Callable[[bytes, str, Exception], None]


class _DecodeJob:
    __slots__ = ("work", "deliver", "result", "error", "done", "delivering")

    def __init__(self, work, deliver):
        self.work = work
        self.deliver = deliver
        self.result = None
        self.error: Optional[BaseException] = None
        self.done = False
        self.delivering = False


class DecodePool:
    """Ordered parallel decode: the host-pipeline stage that lets window
    N+1's payload decode while window N is on device.

    Payloads submitted under the same ``key`` (the source id — the
    sharded sequence key) DECODE on any worker concurrently but DELIVER
    strictly in submission order, so per-device event order and the
    journal's offset↔row correspondence survive the parallelism.  The
    per-key lane is a FIFO of jobs; whichever worker completes the lane's
    head drains every completed head job in order (the ``delivering``
    flag makes that drain single-threaded per lane without a dedicated
    delivery thread).

    ``max_pending`` bounds buffered payloads across all lanes —
    ``submit`` blocks the receiver thread when saturated, which is the
    backpressure that keeps a fast socket from outrunning the pipeline.
    """

    def __init__(self, workers: int = 2, max_pending: int = 128,
                 name: str = "ingest-decode", metrics=None):
        import queue as _queue

        self.name = name
        self.max_pending = int(max_pending)   # overload signal denominator
        self._q: "_queue.Queue" = _queue.Queue()
        self._sem = threading.BoundedSemaphore(max_pending)
        self._lanes: Dict[object, "collections.deque"] = {}
        self._lock = threading.Lock()
        self._alive = True
        self.submitted = 0
        self.delivered = 0
        self.delivery_errors = 0
        if metrics is not None:
            self._m_depth = metrics.gauge("ingest.decode_pool_depth")
            self._m_jobs = metrics.counter("ingest.decode_pool_jobs")
        else:
            self._m_depth = self._m_jobs = None
        self._threads = [
            threading.Thread(target=self._worker, daemon=True,
                             name=f"{name}-{i}")
            for i in range(max(1, int(workers)))
        ]
        for t in self._threads:
            t.start()

    def submit(self, key, work: Callable[[], object],
               deliver: Callable[[object, Optional[BaseException]], None],
               ) -> None:
        """Queue ``work`` (CPU-only, side-effect free) for parallel
        execution; ``deliver(result, error)`` runs later, in per-``key``
        submission order, on a pool thread.  Blocks when the pool's
        pending budget is exhausted (backpressure)."""
        if self._alive:
            self._sem.acquire()
            # Re-check under the lock: a stop() between the check above
            # and the enqueue would strand the job behind the worker
            # sentinels (never executed, permit leaked) — the atomic
            # check-and-enqueue makes every job land either ahead of the
            # sentinels or on the synchronous fallback below.
            with self._lock:
                queued = self._alive
                if queued:
                    job = _DecodeJob(work, deliver)
                    self._lanes.setdefault(key, collections.deque()).append(job)
                    self.submitted += 1
                    self._q.put((key, job))
            if queued:
                if self._m_jobs is not None:
                    self._m_jobs.inc()
                    self._m_depth.set(self.pending)
                return
            self._sem.release()
        # stopped pool: degrade to synchronous (never drop a payload)
        try:
            result = work()
        except Exception as e:  # noqa: BLE001 — mirrors worker path
            deliver(None, e)
            return
        deliver(result, None)

    @property
    def pending(self) -> int:
        with self._lock:
            return sum(len(lane) for lane in self._lanes.values())

    def _worker(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            key, job = item
            try:
                job.result = job.work()
            except BaseException as e:  # noqa: BLE001 — routed to deliver
                job.error = e
            job.done = True
            self._drain(key)

    def _drain(self, key) -> None:
        """Deliver completed head jobs of one lane in order; only one
        thread delivers per lane at a time (the head job it popped is
        gone before any sibling can see the next head)."""
        while True:
            with self._lock:
                lane = self._lanes.get(key)
                if not lane or not lane[0].done or lane[0].delivering:
                    return
                job = lane[0]
                job.delivering = True
            try:
                job.deliver(job.result, job.error)
            except BaseException:  # noqa: BLE001 — a deliver that re-raises
                # a non-Exception (sys.exit in a decoder, a C-extension
                # signal) must not kill the unsupervised worker thread:
                # with every worker dead the queue backs up until the
                # pending semaphore wedges all receiver threads
                self.delivery_errors += 1
                logger.exception("decode pool %s: delivery failed",
                                 self.name)
            finally:
                with self._lock:
                    lane.popleft()
                    if not lane:
                        self._lanes.pop(key, None)
                    self.delivered += 1
                self._sem.release()
                if self._m_depth is not None:
                    self._m_depth.set(self.pending)

    def flush(self, timeout_s: float = 10.0) -> bool:
        """Block until every submitted payload has DELIVERED (tests and
        shutdown: nothing may reach the pipeline after stop returns)."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self.pending == 0:
                return True
            time.sleep(0.001)
        return self.pending == 0

    def stop(self, timeout_s: float = 10.0) -> None:
        self.flush(timeout_s)
        with self._lock:  # pairs with submit's check-and-enqueue
            self._alive = False
        for _ in self._threads:
            self._q.put(None)
        for t in self._threads:
            t.join(timeout=timeout_s)
        self._threads = []


class InboundEventSource(LifecycleComponent):
    """receivers × decoder × dedup → forward (see module docstring)."""

    def __init__(
        self,
        source_id: str,
        receivers: List["Receiver"],
        decoder: Decoder,
        deduplicator=None,
        on_event: Optional[Forward] = None,
        on_registration: Optional[Forward] = None,
        on_failed_decode: Optional[FailedDecode] = None,
        on_host_request: Optional[Forward] = None,
        on_events: Optional[Callable[[List[DecodedRequest], bytes], None]] = None,
        raw_wire: bool = False,
    ):
        super().__init__(name=f"event-source:{source_id}")
        self.source_id = source_id
        self.receivers = receivers
        self.decoder = decoder
        self.deduplicator = deduplicator
        self.on_event = on_event
        # Batch forward: when set, all of one payload's pipeline events go
        # through a single columnar call (PipelineDispatcher.ingest_many)
        # instead of per-request on_event — the 1M events/sec intake edge.
        self.on_events = on_events
        self.on_registration = on_registration
        self.on_failed_decode = on_failed_decode
        self.on_host_request = on_host_request
        # Raw wire lane (opt-in, config `"raw_wire": true`): NDJSON
        # payloads skip this source's scalar decoder entirely and go to
        # ``on_wire_payload`` (PipelineDispatcher.ingest_wire_lines, or
        # the forwarder's owner-splitting ingest_payload in multi-host
        # topologies) — one C columnar decode + in-scanner token
        # resolution per payload instead of json.loads per line.  The
        # wire lane handles registration/host-plane lines and dead-
        # letters failed payloads itself.  Differences a deployment opts
        # into: no source-level deduplication (``dedup`` config is
        # rejected with it) and per-request ``metadata.tenant`` routing
        # is not applied (wire rows land in the default tenant).
        self.raw_wire = raw_wire
        self.on_wire_payload: Optional[Callable[[bytes, str], int]] = None
        # Overlapped decode (host-pipeline stage 1): with a DecodePool
        # attached, the CPU-heavy decode of each payload runs on a pool
        # worker while earlier windows are on device; the ordered
        # delivery stage (journal + forward) keeps per-source submission
        # order.  ``on_wire_decode``/``on_wire_decoded`` are the split
        # halves of the wire lane (PipelineDispatcher.decode_wire_lines /
        # ingest_wire_decoded).  On the fill-direct path the decode half
        # returns a batcher Reservation (scanned in place on the pool
        # worker, PRIVATE until commit) riding the same ``(columns,
        # host_reqs)`` tuple — the delivery half commits it in
        # submission order, so the zero-copy scan parallelizes without
        # reordering rows.  The pool is ONLY used when no receiver
        # gates a broker ack on the emit call returning
        # (``acks_on_emit``): for those (MQTT broker intake, STOMP
        # client-individual) an async decode would acknowledge a payload
        # the journal has not seen yet — a durability regression — so
        # they keep the synchronous path and their redelivery semantics.
        self.decode_pool: Optional[DecodePool] = None
        self.on_wire_decode: Optional[Callable[[bytes], object]] = None
        self.on_wire_decoded: Optional[Callable[..., int]] = None
        self.decoded_count = 0
        self.failed_count = 0
        self.duplicate_count = 0
        self.shed_count = 0
        self.dropped_host_requests = 0
        for r in receivers:
            r.sink = self.on_encoded_payload
            self.add_child(r)

    def _pool_usable(self) -> bool:
        """May this source decode asynchronously?  Requires an attached
        pool, the split wire callables (for the wire lane), and NO
        ack-gated receiver (see ``decode_pool`` comment above)."""
        if self.decode_pool is None:
            return False
        if any(getattr(r, "acks_on_emit", False) for r in self.receivers):
            return False
        if self.raw_wire:
            return self.on_wire_decode is not None \
                and self.on_wire_decoded is not None
        return True

    def on_encoded_payload(self, payload: bytes) -> None:
        """Receiver callback (reference ``onEncodedEventReceived:189-199``).

        Never lets an exception escape into the transport thread: decode
        failures dead-letter; forward-target failures are logged and
        counted (a broken sink must not kill the receiver).

        With a decode pool attached (and no ack-gated receiver) the
        CPU-heavy decode stage runs on a pool worker — window N+1
        decodes while window N is on device — and the forward stage
        (journal + batch) runs later in per-source submission order.
        """
        if self._pool_usable():
            self.decode_pool.submit(
                self.source_id,
                lambda: self._decode_stage(payload),
                lambda result, exc: self._pool_deliver(payload, result, exc),
            )
            return
        try:
            result = self._decode_stage(payload)
        except Exception as e:  # noqa: BLE001 — _forward_stage routes it
            self._forward_stage(payload, None, e)
            return
        self._forward_stage(payload, result, None)

    def _decode_stage(self, payload: bytes):
        """CPU-only decode (pool-worker safe: no shared mutation)."""
        faults.fire("ingest.decode")
        if self.raw_wire and self.on_wire_payload is not None:
            if self.on_wire_decode is not None:
                return self.on_wire_decode(payload)
            return None  # unsplit wire sink decodes inside forward
        return self.decoder(payload)

    def _pool_deliver(self, payload: bytes, decoded,
                      exc: Optional[BaseException]) -> None:
        """Pooled delivery: ``_forward_stage``'s re-raise of non-decode
        failures has no receiver thread to land on here — the pool would
        log-and-drop it — so the payload dead-letters instead."""
        try:
            self._forward_stage(payload, decoded, exc)
        except OverloadShed:
            # already counted + dead-lettered at the admission edge; the
            # pooled sources (UDP/TCP/WS) have no ack channel to signal
            # backpressure on, so the shed ends here
            return
        except BaseException as e:  # noqa: BLE001 — last stop before the
            # pool; BaseException because _forward_stage re-raises
            # whatever the decode stage threw
            self.failed_count += 1
            if self.on_failed_decode is not None:
                self.on_failed_decode(payload, self.source_id, e)
            else:
                logger.exception(
                    "pooled forward failed for source %s", self.source_id)

    def _forward_stage(self, payload: bytes, decoded,
                       exc: Optional[BaseException]) -> None:
        """Ordered delivery: counters, dead-letters, journal + forward."""
        if self.raw_wire and self.on_wire_payload is not None:
            try:
                if exc is not None:
                    raise exc
                if decoded is None:
                    self.decoded_count += self.on_wire_payload(
                        payload, self.source_id)
                else:
                    columns, host_reqs = decoded
                    # source_id rides along so overload admission
                    # buckets + intake-shed audit records attribute to
                    # THIS source, not a shared "wire" bucket
                    self.decoded_count += self.on_wire_decoded(
                        payload, columns, host_reqs,
                        source_id=self.source_id)
            except OverloadShed:
                # admission refused the payload: counted here, then
                # re-raised so the RECEIVER signals protocol-native
                # backpressure (429 / 5.03 / withheld PUBACK / unacked)
                self.shed_count += 1
                raise
            except DecodeError as e:
                # same observable failure path as the scalar decoder:
                # the source's counter ticks and its on_failed_decode
                # dead-letters the payload (once)
                self.failed_count += 1
                if self.on_failed_decode is not None:
                    self.on_failed_decode(payload, self.source_id, e)
            except Exception:
                self.failed_count += 1
                logger.exception(
                    "raw wire forward failed for source %s", self.source_id)
            return
        if exc is not None:
            if isinstance(exc, DecodeError):
                self.failed_count += 1
                if self.on_failed_decode is not None:
                    self.on_failed_decode(payload, self.source_id, exc)
                return
            # non-decode crash (an injected fault, a decoder bug):
            # synchronous callers see it on the receiver thread exactly
            # as before the split — the receiver's supervisor/broker
            # redelivery owns it; pooled delivery catches it in
            # _pool_deliver and dead-letters the payload
            raise exc
        requests = decoded
        events: List[DecodedRequest] = []
        forwarded = 0
        last_shed: Optional[OverloadShed] = None
        for req in requests:
            if self.deduplicator is not None and self.deduplicator.is_duplicate(req):
                self.duplicate_count += 1
                continue
            self.decoded_count += 1
            try:
                if req.kind == RequestKind.REGISTRATION:
                    if self.on_registration is not None:
                        self.on_registration(req, payload)
                    forwarded += 1
                elif req.event_type is None:
                    # Host-plane requests (stream data, mappings): never
                    # into the tensor batcher.
                    if self.on_host_request is not None:
                        self.on_host_request(req, payload)
                        forwarded += 1
                    else:
                        self.dropped_host_requests += 1
                elif self.on_events is not None:
                    events.append(req)  # forwarded in one batch below
                elif self.on_event is not None:
                    self.on_event(req, payload)
                    forwarded += 1
            except OverloadShed as e:
                # this request was refused by admission (counted + dead-
                # lettered there); siblings keep forwarding
                self.shed_count += 1
                last_shed = e
            except Exception:
                self.failed_count += 1
                logger.exception(
                    "forward failed for %s from source %s",
                    req.kind.name, self.source_id,
                )
        if events:
            try:
                self.on_events(events, payload)
                forwarded += len(events)
            except OverloadShed as e:
                # ingest_many raises only when EVERY row was shed —
                # partial sheds are absorbed inside it
                self.shed_count += 1
                last_shed = e
            except Exception:
                self.failed_count += 1
                logger.exception(
                    "batch forward failed for source %s", self.source_id,
                )
        if last_shed is not None and forwarded == 0:
            # the whole payload was shed: the receiver owns the
            # protocol-native backpressure signal
            raise last_shed


class Receiver(LifecycleComponent):
    """Base receiver: owns a transport, pushes raw payloads to ``sink``.

    Loop-owning receivers run their loops under a
    :class:`~sitewhere_tpu_torch.runtime.resilience.Supervisor`
    (:meth:`_spawn_supervised`): an unexpected exception restarts the
    loop with exponential backoff instead of silently killing the
    thread, and a receiver that fails ``max_restarts`` times in a row
    escalates — terminal log + metric + lifecycle ERROR state — rather
    than spinning forever.  ``restart_policy`` / ``max_restarts`` are
    plain attributes so deployments (and chaos tests) tune them without
    touching every subclass constructor.
    """

    def __init__(self, name: str):
        super().__init__(name=name)
        self.sink: Optional[Callable[[bytes], None]] = None
        self.received_count = 0
        self.sheds = 0
        self.restart_policy = RetryPolicy(initial_s=0.05, max_s=5.0)
        self.max_restarts = 8
        self.supervisor: Optional[Supervisor] = None
        # multi-loop receivers (EventHub partitions) supervise several
        # threads; `supervisor` stays the LAST spawned for back-compat
        self.supervisors: List[Supervisor] = []

    def _emit(self, payload: bytes) -> None:
        faults.fire("ingest.emit")
        self.received_count += 1
        if self.sink is None:
            return
        try:
            self.sink(payload)
        except OverloadShed:
            # admission refused the payload.  Ack-gated transports
            # (HTTP 202, CoAP ACK, QoS-1 PUBACK, STOMP/AMQP acks) see
            # the raise and answer with their native backpressure
            # signal; ack-less transports (UDP, TCP framing, WS, REST
            # poll) have nothing to signal on — the shed was counted +
            # dead-lettered at the admission edge, so it must NOT fall
            # into their supervisors as a crash.
            self.sheds += 1
            if getattr(self, "acks_on_emit", False):
                raise

    def _spawn_supervised(self, run: Callable[[], None],
                          name: Optional[str] = None) -> Supervisor:
        """Run ``run`` on a supervised thread; escalation marks this
        component failed (the operator-visible terminal state)."""
        self.supervisor = Supervisor(
            name or self.name, run, policy=self.restart_policy,
            max_restarts=self.max_restarts, min_uptime_s=5.0,
            on_escalate=self._on_escalate)
        self.supervisors.append(self.supervisor)
        self.supervisor.start()
        return self.supervisor

    def _on_escalate(self, exc: BaseException) -> None:
        logger.error("receiver %s failed permanently: %s", self.name, exc)
        self._fail(exc)

    def _stop_supervisor(self) -> None:
        for sup in self.supervisors:
            sup.stop()
        self.supervisors = []
        self.supervisor = None


def close_waking(sock: socket.socket) -> None:
    """Close a socket another thread may be blocked on.

    ``close`` alone does not wake a thread blocked in ``recvfrom`` or
    ``accept`` on Linux: it stays blocked, holding the port, and a
    supervisor's join of it waits out its whole timeout.  ``shutdown``
    wakes it (a datagram reader with an empty datagram, an acceptor with
    an error; an unconnected socket also raises ``ENOTCONN``, ignored)."""
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


def length_prefixed_frames(conn: socket.socket, emit: Callable[[bytes], None]) -> None:
    """Framing: u32-be length + body (the default interaction handler)."""
    buf = b""
    while True:
        data = conn.recv(65536)
        if not data:
            return
        buf += data
        while len(buf) >= 4:
            (ln,) = struct.unpack_from(">I", buf, 0)
            if ln > 16 << 20:
                raise ValueError(f"frame too large: {ln}")
            if len(buf) < 4 + ln:
                break
            emit(buf[4 : 4 + ln])
            buf = buf[4 + ln :]


def newline_frames(conn: socket.socket, emit: Callable[[bytes], None]) -> None:
    """Framing: newline-delimited payloads (e.g. JSON lines)."""
    buf = b""
    while True:
        data = conn.recv(65536)
        if not data:
            if buf.strip():
                emit(buf.strip())
            return
        buf += data
        while b"\n" in buf:
            line, buf = buf.split(b"\n", 1)
            if line.strip():
                emit(line.strip())


class WebSocketReceiver(Receiver):
    """Client pulling payloads from a remote WebSocket endpoint.

    Reference: ``websocket/WebSocketEventReceiver.java`` — a
    ``javax.websocket`` client session against a configured URL with
    optional headers; every received message's bytes feed the source's
    decoder.  Reconnects with capped exponential backoff when the remote
    closes or the connect fails (the reference restarts its session via
    the lifecycle).
    """

    def __init__(self, host: str, port: int, path: str = "/",
                 headers: Optional[dict] = None,
                 reconnect_delay_s: float = 0.5,
                 max_reconnect_delay_s: float = 30.0):
        super().__init__(name=f"ws-receiver:{host}:{port}{path}")
        self.host, self.port, self.path = host, port, path
        self.headers = dict(headers or {})
        self.reconnect_delay_s = reconnect_delay_s
        self.max_reconnect_delay_s = max_reconnect_delay_s
        self._alive = False
        self._stop_evt = threading.Event()
        self._client = None
        self.connects = 0
        # reconnect schedule on the shared primitive (was ad-hoc
        # delay-doubling state)
        self._backoff = Backoff(
            RetryPolicy(initial_s=reconnect_delay_s,
                        max_s=max_reconnect_delay_s),
            name="ingest.ws-reconnect")

    def start(self) -> None:
        self._alive = True
        self._stop_evt.clear()
        # Supervised: transport errors are handled by the reconnect loop
        # itself; the supervisor catches anything unexpected (a sink
        # exception, an injected fault) and restarts the whole loop.
        self._spawn_supervised(self._loop)
        super().start()

    def stop(self) -> None:
        self._alive = False
        self._stop_evt.set()
        client = self._client
        if client is not None:
            try:
                client.close()
            except OSError:
                pass
        self._stop_supervisor()
        super().stop()

    def _loop(self) -> None:
        from sitewhere_tpu_torch.web.ws import ClientWebSocket

        while self._alive:
            try:
                self._client = ClientWebSocket(
                    self.host, self.port, self.path, headers=self.headers
                )
                self.connects += 1
                self._backoff.reset()  # connected: fresh schedule
                while self._alive:
                    msg = self._client.recv()
                    if msg is None:
                        break  # remote closed — reconnect
                    _, payload = msg
                    if payload:
                        self._emit(payload)
            except (OSError, ConnectionError) as e:
                logger.debug("ws receiver %s: %s", self.name, e)
            finally:
                client, self._client = self._client, None
                if client is not None:
                    try:
                        client.close()
                    except OSError:
                        pass
            if self._alive:
                self._stop_evt.wait(self._backoff.next_delay())


class _EmitCrash(Exception):
    """Marker: the sink/emit path crashed inside a framing loop (as
    opposed to a framing violation raised by the framing itself)."""


# accept() errors that do NOT mean the listener died: ride them out in
# place (the old ThreadingTCPServer's per-request error handling) —
# tearing down + restarting on an fd-exhaustion storm would burn the
# supervisor's restart budget and escalate a transient flood into
# permanent receiver death
_TRANSIENT_ACCEPT_ERRNOS = frozenset({
    errno.ECONNABORTED, errno.EMFILE, errno.ENFILE,
    errno.ENOBUFS, errno.ENOMEM,
})


class TcpReceiver(Receiver):
    """Threaded TCP server with pluggable framing.

    The accept loop runs under the shared receiver supervisor (ROADMAP:
    remaining-receiver chaos coverage): an unexpected accept failure
    restarts the loop with backoff — re-binding the SAME port, so
    clients just reconnect — and repeated failures escalate to the
    terminal lifecycle ERROR state.  A sink/emit crash inside one
    connection's framing loop closes ONLY that connection (counted in
    ``connection_errors``): the un-acked stream is the client's cue to
    reconnect and resend, TCP's redelivery semantics.  The accept loop
    is never the casualty of one connection's poison payload.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 framing: Callable = length_prefixed_frames):
        super().__init__(name=f"tcp-receiver:{port}")
        self.host, self.port = host, port
        self.framing = framing
        self._sock: Optional[socket.socket] = None
        self._alive = False
        self.connection_errors = 0
        # live connection handlers: stop() must close + join them so no
        # emit reaches an already-stopped pipeline after stop() returns
        # (the contract ThreadingTCPServer.server_close used to provide)
        self._conn_lock = threading.Lock()
        self._conns: Dict[socket.socket, threading.Thread] = {}

    def _bind(self) -> None:
        if self._sock is None:
            sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            sock.bind((self.host, self.port))
            sock.listen(64)
            self._sock = sock
            self.port = sock.getsockname()[1]

    def _close_listener(self) -> None:
        sock, self._sock = self._sock, None
        if sock is not None:
            close_waking(sock)

    def start(self) -> None:
        self._bind()
        self._alive = True
        self._spawn_supervised(self._run)
        super().start()

    def _handle(self, conn: socket.socket) -> None:
        # wrap emit so a sink crash is distinguishable from a framing
        # violation — a sink ValueError must be COUNTED, not mistaken
        # for a malformed frame
        def emit(payload: bytes) -> None:
            try:
                self._emit(payload)
            except Exception as e:
                raise _EmitCrash() from e

        try:
            with conn:
                self.framing(conn, emit)
        except _EmitCrash:
            # sink crash: this connection dies (its client resends on
            # reconnect), the accept loop and sibling connections do not
            self.connection_errors += 1
            logger.exception("tcp receiver %s: connection crashed",
                             self.name)
        except (ValueError, OSError):
            pass   # framing violation / peer reset — connection-local
        finally:
            with self._conn_lock:
                self._conns.pop(conn, None)

    def _run(self) -> None:
        self._bind()   # restart after a crash that closed the socket
        if not self._alive:
            # stop() raced the supervised restart: its _close_listener
            # saw _sock=None mid-_bind, so the fresh socket is ours to
            # release — otherwise the port stays bound forever
            self._close_listener()
            return
        while self._alive:
            sock = self._sock
            if sock is None:
                return   # stop() tore the listener down mid-iteration
            try:
                conn, _ = sock.accept()
            except OSError as e:
                if not self._alive:
                    return   # clean shutdown closed the socket
                if e.errno in _TRANSIENT_ACCEPT_ERRNOS:
                    # fd exhaustion / aborted handshake: keep listening
                    logger.warning("tcp receiver %s: transient accept "
                                   "error, retrying: %s", self.name, e)
                    time.sleep(0.05)
                    continue
                # release the port before the supervised restart rebinds
                # it (same contract as UdpReceiver._run)
                self._close_listener()
                raise        # unexpected socket death → supervisor restarts
            t = threading.Thread(
                target=self._handle, args=(conn,),
                name=f"{self.name}-conn", daemon=True)
            with self._conn_lock:
                # registration and stop() flip _alive under the same
                # lock: a handler either registers before stop()'s
                # snapshot (so it is closed + joined) or sees the stop
                # and never starts — nothing can emit into a stopped
                # pipeline either way
                if not self._alive:
                    try:
                        conn.close()
                    except OSError:
                        pass
                    return
                self._conns[conn] = t
            t.start()

    def stop(self) -> None:
        with self._conn_lock:
            self._alive = False
        self._close_listener()
        # tear down established connections and JOIN their handlers:
        # nothing may emit into the stopped pipeline after this returns
        with self._conn_lock:
            conns = list(self._conns.items())
        for conn, thread in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass
            try:
                thread.join(timeout=2)
                if thread.is_alive():
                    # handler stuck in a slow emit: the no-emit-after-
                    # stop contract is broken — make it observable
                    logger.warning(
                        "tcp receiver %s: connection handler still "
                        "alive after stop() join timeout", self.name)
            except RuntimeError:
                pass   # raced the registration: thread not yet started
        self._stop_supervisor()
        super().stop()


class UdpReceiver(Receiver):
    """One datagram = one payload."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        super().__init__(name=f"udp-receiver:{port}")
        self.host, self.port = host, port
        self._sock: Optional[socket.socket] = None
        self._alive = False

    def _bind(self) -> None:
        if self._sock is None:
            self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            self._sock.bind((self.host, self.port))
            self.port = self._sock.getsockname()[1]

    def start(self) -> None:
        self._bind()
        self._alive = True
        # Supervised: a sink/emit exception restarts the loop with
        # backoff; the bound socket survives restarts, so datagrams sent
        # during the backoff window sit in the kernel buffer, not lost.
        self._spawn_supervised(self._run)
        super().start()

    def _run(self) -> None:
        self._bind()   # restart after a crash that closed the socket
        while self._alive:
            try:
                data, _ = self._sock.recvfrom(65536)
            except OSError:
                if not self._alive:
                    return   # clean shutdown closed the socket
                # release the port before the supervised restart rebinds
                # it — a leaked fd would turn every rebind into
                # EADDRINUSE and a transient recv error into terminal
                # receiver death
                sock, self._sock = self._sock, None
                if sock is not None:
                    try:
                        sock.close()
                    except OSError:
                        pass
                raise        # unexpected socket death → supervisor restarts
            if data:
                self._emit(data)

    def stop(self) -> None:
        self._alive = False
        if self._sock is not None:
            close_waking(self._sock)
            self._sock = None
        self._stop_supervisor()
        super().stop()


class HttpReceiver(Receiver):
    """POST <path> with the payload as body → one event payload."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 path: str = "/events"):
        super().__init__(name=f"http-receiver:{port}")
        # the 202 response is an ack gated on _emit returning: the
        # decode pool must keep this source synchronous or the 202
        # would precede the journal append (at-least-once)
        self.acks_on_emit = True
        self.host, self.port, self.path = host, port, path
        self._server: Optional[http.server.ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        receiver = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                if self.path != receiver.path:
                    self.send_error(404)
                    return
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length)
                try:
                    receiver._emit(body)
                except OverloadShed as e:
                    # HTTP-native backpressure: the client owns the
                    # retry (shed ≠ silent drop — the payload was also
                    # dead-lettered at the admission edge)
                    self.send_response(429)
                    self.send_header(
                        "Retry-After",
                        str(max(1, int(round(e.retry_after_s)))))
                    self.end_headers()
                    return
                self.send_response(202)
                self.end_headers()

            def log_message(self, *args):
                pass

        self._server = http.server.ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True, name=self.name
        )
        self._thread.start()
        super().start()

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        super().stop()


class MqttReceiver(Receiver):
    """Subscribe to a broker topic; every message is a payload."""

    def __init__(self, host: str, port: int = 1883, topic: str = "sitewhere/input",
                 qos: int = 0, client_id: str = "sw-tpu-ingest", **client_kw):
        super().__init__(name=f"mqtt-receiver:{topic}")
        from sitewhere_tpu_torch.ingest.mqtt import MqttClient

        self.topic, self.qos = topic, qos
        self.client = MqttClient(host, port, client_id=client_id, **client_kw)

    def start(self) -> None:
        self.client.on_message = lambda topic, payload: self._emit(payload)
        self.client.connect()
        self.client.subscribe(self.topic, self.qos)
        super().start()

    def stop(self) -> None:
        self.client.disconnect()
        super().stop()


class PollingRestReceiver(Receiver):
    """Poll an HTTP endpoint on an interval; non-empty bodies are payloads.

    Reference: ``rest/PollingRestInboundEventReceiver.java`` (scripted
    response→payload mapping there; a ``transform`` callable here).
    """

    def __init__(self, url: str, interval_s: float = 10.0,
                 transform: Optional[Callable[[bytes], List[bytes]]] = None):
        super().__init__(name=f"poll-receiver:{url}")
        self.url = url
        self.interval_s = interval_s
        self.transform = transform or (lambda body: [body] if body else [])
        self._alive = False
        self._wake = threading.Event()

    def start(self) -> None:
        self._alive = True
        # Supervised: HTTP errors are expected (the poll just skips a
        # tick); a transform/sink exception restarts the loop with
        # backoff instead of killing the poller silently.
        self._spawn_supervised(self._run)
        super().start()

    def _run(self) -> None:
        while self._alive:
            try:
                with urllib.request.urlopen(self.url, timeout=10) as resp:
                    body = resp.read()
                for payload in self.transform(body):
                    self._emit(payload)
            except OSError:
                pass
            self._wake.wait(self.interval_s)
            self._wake.clear()

    def stop(self) -> None:
        self._alive = False
        self._wake.set()
        self._stop_supervisor()
        super().stop()
