"""Minimal MQTT 3.1.1 client over stdlib sockets (QoS 0/1).

Counterpart of ``sitewhere_tpu/ingest/mqtt.py``, whole (the broker,
``mqtt_broker.py``, comes with the event sources).

The reference wraps the fusesource mqtt-client in
``sitewhere-communication/.../mqtt/MqttLifecycleComponent.java`` and builds
event receivers (``sources/mqtt/MqttInboundEventReceiver.java:39``) and
command destinations (``destination/mqtt/MqttCommandDestination.java``) on
it.  No MQTT library is available in this image, so this module implements
the small protocol subset both sides need: CONNECT/CONNACK,
SUBSCRIBE/SUBACK, PUBLISH (+PUBACK for QoS 1), PINGREQ/PINGRESP,
DISCONNECT.  TLS wraps the socket via ``ssl.SSLContext`` when given
(reference supports TLS brokers).
"""

from __future__ import annotations

import socket
import ssl
import struct
import threading
import time
from typing import Callable, Optional, Tuple

# Packet types (<<4 in the fixed header).
CONNECT, CONNACK = 1, 2
PUBLISH, PUBACK = 3, 4
SUBSCRIBE, SUBACK = 8, 9
UNSUBSCRIBE, UNSUBACK = 10, 11
PINGREQ, PINGRESP = 12, 13
DISCONNECT = 14


class MqttError(Exception):
    pass


def _encode_remaining(n: int) -> bytes:
    out = bytearray()
    while True:
        byte = n % 128
        n //= 128
        out.append(byte | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _utf8(s: str) -> bytes:
    b = s.encode("utf-8")
    return struct.pack(">H", len(b)) + b


def _read_exact(sock: socket.socket, n: int, interruptible: bool = False) -> bytes:
    """Read exactly n bytes.  With ``interruptible`` a timeout before the
    FIRST byte propagates (idle poll); a timeout mid-read keeps waiting so
    a slow sender can't desynchronize the packet stream."""
    buf = b""
    while len(buf) < n:
        try:
            chunk = sock.recv(n - len(buf))
        except socket.timeout:
            if interruptible and not buf:
                raise
            continue
        if not chunk:
            raise MqttError("connection closed")
        buf += chunk
    return buf


def read_packet(sock: socket.socket, interruptible: bool = False) -> Tuple[int, int, bytes]:
    """Read one packet: returns (type, flags, payload)."""
    head = _read_exact(sock, 1, interruptible=interruptible)[0]
    remaining, shift = 0, 0
    while True:
        byte = _read_exact(sock, 1)[0]
        remaining |= (byte & 0x7F) << shift
        if not byte & 0x80:
            break
        shift += 7
        if shift > 21:
            raise MqttError("bad remaining length")
    body = _read_exact(sock, remaining) if remaining else b""
    return head >> 4, head & 0x0F, body


def write_publish(
    sock: socket.socket, topic: str, payload: bytes, qos: int = 0,
    packet_id: int = 1, retain: bool = False,
) -> None:
    flags = (qos << 1) | (1 if retain else 0)
    var = _utf8(topic)
    if qos > 0:
        var += struct.pack(">H", packet_id)
    body = var + payload
    sock.sendall(bytes([PUBLISH << 4 | flags]) + _encode_remaining(len(body)) + body)


def parse_publish(flags: int, body: bytes) -> Tuple[str, bytes, int, int]:
    """Returns (topic, payload, qos, packet_id)."""
    (tlen,) = struct.unpack_from(">H", body, 0)
    topic = body[2 : 2 + tlen].decode("utf-8")
    pos = 2 + tlen
    qos = (flags >> 1) & 0x3
    packet_id = 0
    if qos:
        (packet_id,) = struct.unpack_from(">H", body, pos)
        pos += 2
    return topic, body[pos:], qos, packet_id


class MqttClient:
    """Blocking MQTT client; a background thread pumps inbound packets.

    ``on_message(topic, payload)`` runs on the pump thread — hand off to a
    worker pool for slow work (the reference uses a processing pool for the
    same reason, ``MqttInboundEventReceiver.java:194``).
    """

    def __init__(
        self,
        host: str,
        port: int = 1883,
        client_id: str = "sitewhere-tpu",
        keepalive: int = 60,
        username: Optional[str] = None,
        password: Optional[str] = None,
        tls: Optional[ssl.SSLContext] = None,
        connect_timeout: float = 10.0,
    ):
        self.host, self.port = host, port
        self.client_id = client_id
        self.keepalive = keepalive
        self.username, self.password = username, password
        self.tls = tls
        self.connect_timeout = connect_timeout
        self.on_message: Optional[Callable[[str, bytes], None]] = None
        self._sock: Optional[socket.socket] = None
        self._pump: Optional[threading.Thread] = None
        self._alive = False
        self._packet_id = 0
        self._suback = threading.Event()
        self._lock = threading.Lock()
        # QoS-1 publishes outstanding (pid → sent): the publisher half of
        # at-least-once — disconnect() drains these so closing the socket
        # can never race the broker out of handling a still-buffered
        # publish (an early close RSTs the connection and poisons the
        # broker's receive buffer).
        self._unacked: set = set()
        self._acked = threading.Condition(self._lock)
        self._last_send = time.monotonic()

    # -- connection ---------------------------------------------------------

    def connect(self) -> None:
        sock = socket.create_connection(
            (self.host, self.port), timeout=self.connect_timeout
        )
        if self.tls is not None:
            sock = self.tls.wrap_socket(sock, server_hostname=self.host)
        flags = 0x02  # clean session
        if self.username:
            flags |= 0x80
            if self.password:
                flags |= 0x40
        body = _utf8("MQTT") + bytes([4, flags]) + struct.pack(">H", self.keepalive)
        body += _utf8(self.client_id)
        if self.username:
            body += _utf8(self.username)
            if self.password:
                body += _utf8(self.password)
        sock.sendall(bytes([CONNECT << 4]) + _encode_remaining(len(body)) + body)
        ptype, _, ack = read_packet(sock)
        if ptype != CONNACK or len(ack) < 2 or ack[1] != 0:
            raise MqttError(f"CONNACK refused: {ack!r}")
        # Short poll timeout so keepalive pings fire even under steady
        # inbound traffic (MQTT keepalive counts CLIENT→server packets).
        sock.settimeout(max(0.5, min(self.keepalive / 4, 10.0)))
        self._sock = sock
        # clean session: a pid a dead prior session never got acked can
        # never be acked by THIS session — carrying it over would stall
        # every later drain_publishes for its full timeout
        self._unacked.clear()
        self._alive = True
        self._last_send = time.monotonic()
        self._pump = threading.Thread(target=self._pump_loop, daemon=True,
                                      name=f"mqtt-pump-{self.client_id}")
        self._pump.start()

    def disconnect(self) -> None:
        if self._sock is not None and self._alive:
            # publisher-side at-least-once: don't close under in-flight
            # QoS-1 publishes (see _unacked)
            self.drain_publishes(timeout=5.0)
        self._alive = False
        if self._sock is not None:
            try:
                self._sock.sendall(bytes([DISCONNECT << 4, 0]))
            except OSError:
                pass
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
        if self._pump is not None:
            self._pump.join(timeout=2.0)
            self._pump = None

    # -- pub/sub ------------------------------------------------------------

    def _next_packet_id(self) -> int:
        self._packet_id = self._packet_id % 65535 + 1
        return self._packet_id

    def subscribe(self, topic: str, qos: int = 0, timeout: float = 10.0) -> None:
        if self._sock is None:
            raise MqttError("not connected")
        self._suback.clear()
        pid = self._next_packet_id()
        body = struct.pack(">H", pid) + _utf8(topic) + bytes([qos])
        with self._lock:
            self._sock.sendall(
                bytes([SUBSCRIBE << 4 | 0x02]) + _encode_remaining(len(body)) + body
            )
            self._last_send = time.monotonic()
        if not self._suback.wait(timeout):
            raise MqttError(f"no SUBACK for {topic!r}")

    def publish(self, topic: str, payload: bytes, qos: int = 0,
                retain: bool = False) -> None:
        if self._sock is None:
            raise MqttError("not connected")
        with self._lock:
            pid = self._next_packet_id()
            if qos:
                self._unacked.add(pid)
            try:
                write_publish(self._sock, topic, payload, qos, pid, retain)
            except BaseException:
                # never sent → never acked: leaking the pid would stall
                # every later drain_publishes/disconnect for its timeout
                self._unacked.discard(pid)
                raise
            self._last_send = time.monotonic()

    def drain_publishes(self, timeout: float = 5.0) -> bool:
        """Wait until every QoS-1 publish has been PUBACKed (or timeout);
        returns True when fully drained."""
        deadline = time.monotonic() + timeout
        with self._acked:
            while self._unacked:
                left = deadline - time.monotonic()
                if left <= 0 or not self._alive:
                    return not self._unacked
                self._acked.wait(left)
        return True

    # -- inbound pump -------------------------------------------------------

    def _maybe_ping(self) -> None:
        if self.keepalive <= 0 or self._sock is None:
            return
        now = time.monotonic()
        if now - self._last_send >= self.keepalive / 2:
            with self._lock:
                self._sock.sendall(bytes([PINGREQ << 4, 0]))
                self._last_send = now

    def _pump_loop(self) -> None:
        try:
            self._pump_packets()
        finally:
            # a dead pump can never see another PUBACK: wake any drain
            # waiter immediately instead of letting it sleep its timeout
            with self._acked:
                self._alive = False
                self._acked.notify_all()

    def _pump_packets(self) -> None:
        while self._alive and self._sock is not None:
            try:
                self._maybe_ping()
                ptype, flags, body = read_packet(self._sock, interruptible=True)
            except socket.timeout:
                continue  # idle poll window — loop for the keepalive check
            except (MqttError, OSError):
                break
            if ptype == PUBLISH:
                topic, payload, qos, pid = parse_publish(flags, body)
                if qos == 1:
                    with self._lock:
                        self._sock.sendall(
                            bytes([PUBACK << 4, 2]) + struct.pack(">H", pid)
                        )
                        self._last_send = time.monotonic()
                if self.on_message is not None:
                    try:
                        self.on_message(topic, payload)
                    except Exception:
                        # A broken callback must not kill inbound MQTT.
                        import logging

                        logging.getLogger("sitewhere_tpu_torch.ingest").exception(
                            "mqtt on_message failed for topic %s", topic
                        )
            elif ptype == SUBACK:
                self._suback.set()
            elif ptype == PUBACK:
                if len(body) >= 2:  # short body: tolerate, don't kill pump
                    (pid,) = struct.unpack_from(">H", body, 0)
                    with self._acked:
                        self._unacked.discard(pid)
                        self._acked.notify_all()
            elif ptype == PINGRESP:
                pass
