"""In-process MQTT 3.1.1 broker: device fleets connect with NO middleware.

Reference: ``service-event-sources/.../activemq/ActiveMQBrokerEventReceiver.java``
starts an ActiveMQ ``BrokerService`` inside the microservice so devices
connect directly to SiteWhere — no external broker process.  Every other
receiver here is *client-side* toward MQTT/AMQP/STOMP brokers; this module
closes that gap for the dominant device protocol: a from-scratch hosted
MQTT broker speaking the same 3.1.1 subset as the client
(:mod:`sitewhere_tpu_torch.ingest.mqtt`, whose wire primitives it reuses):

- CONNECT/CONNACK (client-id takeover: a reconnect under the same id
  replaces the old session, per MQTT-3.1.4-2), keepalive enforcement at
  1.5x the negotiated interval (MQTT-3.1.2-24);
- SUBSCRIBE/SUBACK + UNSUBSCRIBE/UNSUBACK with ``+``/``#`` wildcard
  matching (MQTT 4.7); granted QoS is capped at 1;
- PUBLISH QoS 0/1 (PUBACK to the publisher; fan-out to every matching
  subscriber at min(publish qos, subscription qos)); QoS 2 is refused by
  disconnecting the offender (subset contract, like the reference
  broker's transport rejecting an unsupported protocol level);
- PINGREQ/PINGRESP, DISCONNECT.  Will messages and retained messages
  are parsed and ignored (no state carried for them).

:class:`MqttBrokerReceiver` hosts the broker inside an event source and
taps every PUBLISH matching a topic filter as an inbound payload — the
``ActiveMQBrokerEventReceiver`` capability with MQTT as the hosted
protocol.

Counterpart of ``sitewhere_tpu/ingest/mqtt_broker.py``, whole, over
the port's ``ingest/mqtt.py``.
"""

from __future__ import annotations

import socket
import struct
import threading
import time
import uuid
from typing import Callable, Dict, List, Optional, Tuple

from sitewhere_tpu_torch.runtime.overload import OverloadShed

from sitewhere_tpu_torch.ingest.mqtt import (
    CONNACK,
    CONNECT,
    DISCONNECT,
    PINGREQ,
    PINGRESP,
    PUBACK,
    PUBLISH,
    SUBACK,
    SUBSCRIBE,
    UNSUBACK,
    UNSUBSCRIBE,
    MqttError,
    _encode_remaining,
    parse_publish,
    read_packet,
    write_publish,
)
from sitewhere_tpu_torch.ingest.sources import Receiver, close_waking, logger


def topic_matches(filt: str, topic: str) -> bool:
    """MQTT 4.7 wildcard match: ``+`` one level, ``#`` trailing multi.

    ``$``-prefixed topics never match a wildcard at the first level
    (MQTT-4.7.2-1)."""
    if topic.startswith("$") and filt[:1] in ("+", "#"):
        return False
    f_parts = filt.split("/")
    t_parts = topic.split("/")
    for i, fp in enumerate(f_parts):
        if fp == "#":
            return i == len(f_parts) - 1
        if i >= len(t_parts):
            return False
        if fp != "+" and fp != t_parts[i]:
            return False
    return len(f_parts) == len(t_parts)


def _parse_string(body: bytes, pos: int) -> Tuple[str, int]:
    (n,) = struct.unpack_from(">H", body, pos)
    return body[pos + 2: pos + 2 + n].decode("utf-8"), pos + 2 + n


class _Session:
    """One connected client: socket + subscriptions + a write lock
    (fan-out writes come from OTHER clients' reader threads)."""

    def __init__(self, client_id: str, sock: socket.socket,
                 keepalive: int = 0):
        self.client_id = client_id
        self.sock = sock
        self.keepalive = int(keepalive)  # negotiated seconds; 0 = none
        self.subs: Dict[str, int] = {}  # filter -> granted qos
        self.lock = threading.Lock()
        self.packet_id = 0

    def next_packet_id(self) -> int:
        self.packet_id = self.packet_id % 65535 + 1
        return self.packet_id

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


class MqttBroker:
    """Minimal hosted broker (see module docstring for the subset)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 max_keepalive_grace: float = 1.5):
        self.host = host
        self.port = port
        self.max_keepalive_grace = max_keepalive_grace
        # internal taps (the hosting receiver): called for EVERY publish
        # before subscriber fan-out, on the publisher's reader thread
        self.on_publish: List[Callable[[str, bytes], None]] = []
        self._srv: Optional[socket.socket] = None
        self._sessions: Dict[str, _Session] = {}
        self._lock = threading.Lock()
        self._alive = False
        self._accept_thread: Optional[threading.Thread] = None
        self.connects = 0
        self.published = 0
        self.delivered = 0
        self.tap_failures = 0
        self.sheds = 0
        # floor cap on the per-shed read pause; sessions that negotiated
        # a keepalive get a LONGER per-session deadline derived from it
        # (see shed_pause_s) — chatty devices pause longer without
        # tripping the 1.5x keepalive reaper
        self.max_shed_pause_s = 0.25

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        srv = socket.socket()
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((self.host, self.port))
        srv.listen(64)
        self.port = srv.getsockname()[1]
        self._srv = srv
        self._alive = True
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name=f"mqtt-broker:{self.port}")
        self._accept_thread.start()

    def stop(self) -> None:
        self._alive = False
        if self._srv is not None:
            close_waking(self._srv)     # wakes the accept loop
            self._srv = None
        with self._lock:
            sessions = list(self._sessions.values())
            self._sessions.clear()
        for s in sessions:
            s.close()
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5)
            self._accept_thread = None

    @property
    def session_count(self) -> int:
        with self._lock:
            return len(self._sessions)

    # -- accept / session ----------------------------------------------------

    def _accept_loop(self) -> None:
        while self._alive:
            try:
                conn, addr = self._srv.accept()
            except OSError:
                return
            threading.Thread(
                target=self._serve, args=(conn,), daemon=True,
                name=f"mqtt-broker-session:{addr[0]}:{addr[1]}").start()

    def _handle_connect(self, conn: socket.socket) -> Optional[_Session]:
        conn.settimeout(10.0)
        ptype, _, body = read_packet(conn)
        if ptype != CONNECT:
            raise MqttError(f"expected CONNECT, got {ptype}")
        proto, pos = _parse_string(body, 0)
        level = body[pos]
        flags = body[pos + 1]
        (keepalive,) = struct.unpack_from(">H", body, pos + 2)
        pos += 4
        client_id, pos = _parse_string(body, pos)
        if flags & 0x04:  # will flag: parse + ignore (no will state kept)
            _, pos = _parse_string(body, pos)   # will topic
            (wn,) = struct.unpack_from(">H", body, pos)
            pos += 2 + wn                       # will message
        if flags & 0x80:
            _, pos = _parse_string(body, pos)   # username (unauthenticated
        if flags & 0x40:                        # hosting; parse + ignore)
            (pn,) = struct.unpack_from(">H", body, pos)
            pos += 2 + pn
        if proto != "MQTT" or level != 4:
            # 0x01 = unacceptable protocol level
            conn.sendall(bytes([CONNACK << 4, 2, 0, 0x01]))
            return None
        if not client_id:
            if not flags & 0x02:  # empty id REQUIRES clean session
                conn.sendall(bytes([CONNACK << 4, 2, 0, 0x02]))
                return None
            client_id = f"auto-{uuid.uuid4().hex[:12]}"
        session = _Session(client_id, conn, keepalive=keepalive)
        with self._lock:
            old = self._sessions.pop(client_id, None)
            self._sessions[client_id] = session
        if old is not None:
            old.close()  # MQTT-3.1.4-2: same client id takes over
        # keepalive enforcement: 1.5x grace, else drop the session
        conn.settimeout(keepalive * self.max_keepalive_grace
                        if keepalive else None)
        # Bounded SENDS even for keepalive-0 (blocking-mode) sessions: a
        # subscriber that stops reading fills its buffers, and an
        # unbounded sendall to it would wedge whichever publisher thread
        # is fanning out (SO_SNDTIMEO only applies in blocking mode; the
        # keepalive>0 path's settimeout already bounds sends).
        conn.setsockopt(socket.SOL_SOCKET, socket.SO_SNDTIMEO,
                        struct.pack("ll", 5, 0))
        conn.sendall(bytes([CONNACK << 4, 2, 0, 0]))  # session-present=0
        self.connects += 1
        return session

    def _serve(self, conn: socket.socket) -> None:
        session: Optional[_Session] = None
        try:
            session = self._handle_connect(conn)
            if session is None:
                return
            while self._alive:
                # interruptible: an idle-timeout (keepalive * grace with
                # no inbound packet) propagates and reaps the session;
                # a timeout MID-packet keeps waiting for the remainder
                ptype, flags, body = read_packet(conn, interruptible=True)
                if ptype == PUBLISH:
                    self._handle_publish(session, flags, body)
                elif ptype == SUBSCRIBE:
                    self._handle_subscribe(session, body)
                elif ptype == UNSUBSCRIBE:
                    self._handle_unsubscribe(session, body)
                elif ptype == PINGREQ:
                    with session.lock:
                        conn.sendall(bytes([PINGRESP << 4, 0]))
                elif ptype == DISCONNECT:
                    return
                elif ptype == PUBACK:
                    pass  # subscriber acks for our QoS1 fan-out
                else:
                    raise MqttError(f"unsupported packet type {ptype}")
        except (MqttError, OSError, socket.timeout, struct.error,
                IndexError, UnicodeDecodeError):
            pass  # dead/violating client: drop the session
        finally:
            if session is not None:
                with self._lock:
                    if self._sessions.get(session.client_id) is session:
                        del self._sessions[session.client_id]
            try:
                conn.close()
            except OSError:
                pass

    def shed_pause_s(self, session: _Session, hint_s: float) -> float:
        """Per-session shed-pause deadline, tied to the NEGOTIATED
        keepalive.

        The pause blocks the session's reader thread, so its bound is
        what keeps backpressure from looking like death: a keepalive-0
        session has no liveness contract, so only the conservative
        broker-wide floor applies; a session with keepalive K may pause
        up to the reaper's slack — ``(grace - 1) * K`` (grace is the
        MQTT-3.1.2-24 1.5x multiplier, so half a keepalive) — because
        the device's next scheduled packet still lands inside the
        ``K * grace`` silence window the reaper enforces.  Chatty
        high-keepalive devices therefore absorb a long Retry-After as
        one pause instead of a redelivery storm, while short-keepalive
        devices keep their snappy reap behavior."""
        cap = self.max_shed_pause_s
        if session.keepalive > 0:
            cap = max(cap, (self.max_keepalive_grace - 1.0)
                      * session.keepalive)
        return min(float(hint_s), cap)

    # -- packet handlers -----------------------------------------------------

    def _handle_publish(self, session: _Session, flags: int,
                        body: bytes) -> None:
        topic, payload, qos, pid = parse_publish(flags, body)
        if qos > 1:
            raise MqttError("QoS 2 not supported by the hosted broker")
        # Deliver FIRST, ack LAST (at-least-once): a device that fires
        # its publishes and closes immediately can make the PUBACK send
        # fail with EPIPE — the message it successfully delivered must
        # not be dropped with the session.
        self.published += 1
        for tap in self.on_publish:
            try:
                tap(topic, payload)
            except OverloadShed as e:
                # MQTT-native backpressure: withhold the PUBACK (the
                # device's unacked QoS-1 publish is its redelivery cue)
                # and PAUSE reading this session briefly — the TCP
                # receive window fills behind the paused read, slowing
                # the publisher at the socket layer.  The session stays
                # up: shedding is flow control, not a fault.
                self.sheds += 1
                time.sleep(self.shed_pause_s(session, e.retry_after_s))
                return
            except Exception as e:
                # At-least-once REQUIRES withholding the PUBACK when the
                # tap (the platform's intake) failed: dropping the
                # session makes the publisher's drain time out and the
                # device redeliver — acking here would silently lose the
                # event.  Contract: taps must swallow PAYLOAD-level
                # errors themselves (InboundEventSource.on_encoded_payload
                # does — decode failures dead-letter, forward failures
                # are counted), so what reaches here is crash-grade or
                # injected; a tap that raised deterministically per
                # payload would otherwise make the device redeliver the
                # same poison forever.
                self.tap_failures += 1
                logger.warning("mqtt broker tap failed for topic %s: %s "
                               "(withholding PUBACK; publisher retries)",
                               topic, e)
                raise MqttError(f"tap failed: {e}") from e
        # ack after the taps (the at-least-once state that matters) but
        # BEFORE subscriber fan-out: a stalled subscriber's full send
        # buffer must not block the publisher's PUBACK
        if qos == 1:
            with session.lock:
                session.sock.sendall(
                    bytes([PUBACK << 4, 2]) + struct.pack(">H", pid))
        self._fanout(topic, payload, qos, exclude=None)

    def _fanout(self, topic: str, payload: bytes, qos: int,
                exclude: Optional[_Session]) -> None:
        with self._lock:
            targets = [
                (s, min(qos, sub_qos))
                for s in self._sessions.values() if s is not exclude
                for filt, sub_qos in list(s.subs.items())
                if topic_matches(filt, topic)
            ]
        for s, out_qos in targets:
            try:
                with s.lock:
                    write_publish(s.sock, topic, payload, out_qos,
                                  s.next_packet_id() if out_qos else 0)
                self.delivered += 1
            except OSError:
                # A send failure/timeout means the subscriber is dead or
                # not reading (full buffers) — and a timed-out sendall
                # may have written a PARTIAL frame, corrupting its
                # stream.  Close the socket so its reader thread reaps
                # the session; otherwise every future matching publish
                # would stall the full send timeout on it, forever.
                s.close()

    def _handle_subscribe(self, session: _Session, body: bytes) -> None:
        (pid,) = struct.unpack_from(">H", body, 0)
        pos = 2
        granted = bytearray()
        while pos < len(body):
            filt, pos = _parse_string(body, pos)
            want_qos = body[pos] & 0x03
            pos += 1
            qos = min(want_qos, 1)  # QoS 2 capped (subset)
            session.subs[filt] = qos
            granted.append(qos)
        if not granted:
            raise MqttError("SUBSCRIBE with no topic filters")
        out = struct.pack(">H", pid) + bytes(granted)
        with session.lock:
            session.sock.sendall(
                bytes([SUBACK << 4]) + _encode_remaining(len(out)) + out)

    def _handle_unsubscribe(self, session: _Session, body: bytes) -> None:
        (pid,) = struct.unpack_from(">H", body, 0)
        pos = 2
        while pos < len(body):
            filt, pos = _parse_string(body, pos)
            session.subs.pop(filt, None)
        with session.lock:
            session.sock.sendall(
                bytes([UNSUBACK << 4, 2]) + struct.pack(">H", pid))


class MqttBrokerReceiver(Receiver):
    """Event receiver that HOSTS the broker (no external middleware).

    Devices connect straight to this port and publish; every PUBLISH
    whose topic matches ``topic_filter`` feeds the source's decoder.
    Reference: ``ActiveMQBrokerEventReceiver.java`` (embedded
    BrokerService + consumer), with MQTT as the hosted protocol.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 topic_filter: str = "sitewhere/input/#"):
        super().__init__(name=f"mqtt-broker-receiver:{host}:{port}")
        self.topic_filter = topic_filter
        self.broker = MqttBroker(host=host, port=port)
        self.broker.on_publish.append(self._tap)
        # QoS-1 PUBACK is withheld when the intake tap crashes — the ack
        # is gated on emit returning, so the ingest decode pool must keep
        # this source synchronous (see InboundEventSource.decode_pool)
        self.acks_on_emit = True

    @property
    def port(self) -> int:
        return self.broker.port

    def _tap(self, topic: str, payload: bytes) -> None:
        if topic_matches(self.topic_filter, topic):
            self._emit(payload)

    def start(self) -> None:
        self.broker.start()
        super().start()

    def stop(self) -> None:
        self.broker.stop()
        super().stop()
