"""STOMP 1.2 client: broker-subscription ingest (ActiveMQ/RabbitMQ analog).

Reference: ``service-event-sources`` terminates broker protocols with
client libraries — ``activemq/ActiveMQClientEventReceiver.java`` (JMS) and
``rabbitmq/RabbitMqInboundEventReceiver.java`` (AMQP).  Neither client
stack exists in this image, but both brokers natively speak STOMP (Simple
Text Oriented Messaging Protocol), so the capability — subscribe to a
broker queue/topic, feed every message body to the decoder, acknowledge
for at-least-once redelivery — is implemented here as a from-scratch
STOMP 1.2 client (https://stomp.github.io/stomp-specification-1.2.html):

- full frame codec (header escaping, ``content-length`` binary bodies,
  NUL termination, heart-beat LFs between frames);
- ``client-individual`` ack mode by default: a message is ACKed only
  after the sink accepts its payload, so a crash between delivery and
  journal append redelivers (the broker plays the Kafka-offset role the
  reference relies on, ``MicroserviceKafkaConsumer.java:94``);
- negotiated bidirectional heart-beats with a dead-connection cutoff;
- capped-exponential reconnect like the other socket receivers.

Counterpart of ``sitewhere_tpu/ingest/stomp.py``, whole.
"""

from __future__ import annotations

import socket
import threading
import time
from typing import Dict, List, Optional, Tuple

from sitewhere_tpu_torch.ingest.sources import Receiver, logger
from sitewhere_tpu_torch.runtime.overload import OverloadShed
from sitewhere_tpu_torch.runtime.resilience import Backoff, RetryPolicy

_ESCAPES = {"\\": "\\\\", "\r": "\\r", "\n": "\\n", ":": "\\c"}
_UNESCAPES = {"\\\\": "\\", "\\r": "\r", "\\n": "\n", "\\c": ":"}


class StompError(Exception):
    """Protocol violation or broker ERROR frame."""


def _escape(value: str) -> str:
    return "".join(_ESCAPES.get(ch, ch) for ch in value)


def _unescape(value: str) -> str:
    out: List[str] = []
    i = 0
    while i < len(value):
        if value[i] == "\\":
            pair = value[i:i + 2]
            if pair not in _UNESCAPES:
                raise StompError(f"invalid header escape {pair!r}")
            out.append(_UNESCAPES[pair])
            i += 2
        else:
            out.append(value[i])
            i += 1
    return "".join(out)


def encode_frame(command: str, headers: Dict[str, str], body: bytes = b"",
                 escape: bool = True) -> bytes:
    """One STOMP frame.  ``CONNECT``/``CONNECTED`` never escape headers
    (spec: 1.0 compatibility); every other frame does."""
    esc = (lambda s: s) if not escape else _escape
    lines = [command]
    for k, v in headers.items():
        lines.append(f"{esc(str(k))}:{esc(str(v))}")
    if body and "content-length" not in headers:
        lines.append(f"content-length:{len(body)}")
    head = ("\n".join(lines) + "\n\n").encode("utf-8")
    return head + body + b"\x00"


class FrameReader:
    """Incremental STOMP frame parser (handles heart-beat LFs and
    ``content-length`` bodies containing NULs)."""

    def __init__(self, max_frame: int = 16 << 20):
        self._buf = bytearray()
        self.max_frame = max_frame

    def feed(self, data: bytes) -> List[Tuple[str, Dict[str, str], bytes]]:
        self._buf += data
        if len(self._buf) > self.max_frame:
            raise StompError(f"frame exceeds {self.max_frame} bytes")
        frames = []
        while True:
            frame = self._try_parse()
            if frame is None:
                return frames
            frames.append(frame)

    def _try_parse(self):
        buf = self._buf
        # skip heart-beat EOLs between frames
        start = 0
        while start < len(buf) and buf[start:start + 1] in (b"\n", b"\r"):
            start += 1
        if start:
            del buf[:start]
        if not buf:
            return None
        head_end = buf.find(b"\n\n")
        crlf = buf.find(b"\r\n\r\n")
        if crlf != -1 and (head_end == -1 or crlf < head_end):
            head_end, sep = crlf, 4
        elif head_end != -1:
            sep = 2
        else:
            return None
        head = buf[:head_end].decode("utf-8", "replace").replace("\r\n", "\n")
        lines = head.split("\n")
        command = lines[0]
        headers: Dict[str, str] = {}
        unescape = command not in ("CONNECTED",)
        for line in lines[1:]:
            if not line:
                continue
            if ":" not in line:
                raise StompError(f"malformed header line {line!r}")
            k, v = line.split(":", 1)
            if unescape:
                k, v = _unescape(k), _unescape(v)
            headers.setdefault(k, v)  # spec: first occurrence wins
        body_start = head_end + sep
        if "content-length" in headers:
            try:
                length = int(headers["content-length"])
            except ValueError as e:
                raise StompError("bad content-length") from e
            if len(buf) < body_start + length + 1:
                return None
            body = bytes(buf[body_start:body_start + length])
            if buf[body_start + length:body_start + length + 1] != b"\x00":
                raise StompError("frame body not NUL-terminated")
            del buf[:body_start + length + 1]
        else:
            nul = buf.find(b"\x00", body_start)
            if nul == -1:
                return None
            body = bytes(buf[body_start:nul])
            del buf[:nul + 1]
        return command, headers, body


class StompReceiver(Receiver):
    """Subscribe to a broker destination over STOMP; every MESSAGE body is
    an encoded event payload.

    ``ack="client-individual"`` (default) acknowledges each message only
    after the sink returns, giving broker-side redelivery on crash;
    ``ack="auto"`` trades that for throughput.
    """

    def __init__(self, host: str, port: int = 61613,
                 destination: str = "/queue/sitewhere.input",
                 login: Optional[str] = None, passcode: Optional[str] = None,
                 ack: str = "client-individual",
                 heartbeat_ms: int = 10_000,
                 reconnect_delay_s: float = 0.5,
                 max_reconnect_delay_s: float = 30.0):
        super().__init__(name=f"stomp-receiver:{host}:{port}{destination}")
        if ack not in ("auto", "client", "client-individual"):
            raise ValueError(f"bad ack mode {ack!r}")
        self.host, self.port = host, port
        self.destination = destination
        self.login, self.passcode = login, passcode
        self.ack = ack
        self.heartbeat_ms = heartbeat_ms
        self.reconnect_delay_s = reconnect_delay_s
        self.max_reconnect_delay_s = max_reconnect_delay_s
        self._alive = False
        self._stop_evt = threading.Event()
        self._sock: Optional[socket.socket] = None
        self.connects = 0
        self.acked = 0
        self.emit_errors = 0
        # Broker-ack semantics: with per-message acks, the ACK is gated
        # on the sink accepting the payload — the ingest decode pool must
        # not run this source's decode asynchronously (an async ack would
        # acknowledge a payload the journal has not seen).
        self.acks_on_emit = ack != "auto"
        # reconnect schedule on the shared primitive (was ad-hoc
        # delay-doubling state)
        self._backoff = Backoff(
            RetryPolicy(initial_s=reconnect_delay_s,
                        max_s=max_reconnect_delay_s),
            name="ingest.stomp-reconnect")

    def start(self) -> None:
        self._alive = True
        self._stop_evt.clear()
        # Supervised (ROADMAP: remaining-receiver chaos coverage):
        # transport errors are handled by the reconnect loop itself; the
        # supervisor catches anything unexpected — a frame-codec bug, an
        # injected fault escaping the per-message emit guard — and
        # restarts the whole loop with backoff instead of silently
        # killing the thread, escalating terminally after max_restarts.
        self._spawn_supervised(self._loop)
        super().start()

    def stop(self) -> None:
        self._alive = False
        self._stop_evt.set()
        sock = self._sock
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass
        self._stop_supervisor()
        super().stop()

    # -- session ------------------------------------------------------------

    def _connect(self) -> Tuple[socket.socket, float, float]:
        sock = socket.create_connection((self.host, self.port), timeout=10)
        try:
            return self._handshake(sock)
        except BaseException:
            # _loop only closes self._sock, which isn't assigned until the
            # handshake succeeds — close here or a refusing broker leaks
            # one fd per reconnect attempt
            try:
                sock.close()
            except OSError:
                pass
            raise

    def _handshake(self, sock: socket.socket) -> Tuple[socket.socket, float, float]:
        headers = {
            "accept-version": "1.2",
            "host": self.host,
            "heart-beat": f"{self.heartbeat_ms},{self.heartbeat_ms}",
        }
        if self.login is not None:
            headers["login"] = self.login
        if self.passcode is not None:
            headers["passcode"] = self.passcode
        sock.sendall(encode_frame("CONNECT", headers, escape=False))
        reader = FrameReader()
        sock.settimeout(10)
        while True:
            data = sock.recv(65536)
            if not data:
                raise StompError("broker closed during CONNECT")
            frames = reader.feed(data)
            if frames:
                break
        command, headers, body = frames[0]
        if command == "ERROR":
            raise StompError(
                f"broker refused connection: {headers.get('message', body)}")
        if command != "CONNECTED":
            raise StompError(f"expected CONNECTED, got {command}")
        # negotiate heart-beats: we send every max(ours, their-wanted);
        # we expect traffic every max(theirs, our-wanted); 0 disables
        sx, sy = 0, 0
        hb = headers.get("heart-beat", "0,0")
        try:
            sx, sy = (int(x) for x in hb.split(",", 1))
        except ValueError:
            pass
        send_every = max(self.heartbeat_ms, sy) / 1e3 if (
            self.heartbeat_ms and sy) else 0.0
        expect_every = max(sx, self.heartbeat_ms) / 1e3 if (
            sx and self.heartbeat_ms) else 0.0
        sock.sendall(encode_frame("SUBSCRIBE", {
            "id": "0", "destination": self.destination, "ack": self.ack,
        }))
        self._reader = reader
        return sock, send_every, expect_every

    def _loop(self) -> None:
        while self._alive:
            try:
                self._sock, send_every, expect_every = self._connect()
                self.connects += 1
                self._backoff.reset()  # connected: fresh schedule
                self._session(self._sock, send_every, expect_every)
            except (OSError, StompError) as e:
                if self._alive:
                    logger.debug("stomp receiver %s: %s", self.name, e)
            finally:
                sock, self._sock = self._sock, None
                if sock is not None:
                    try:
                        sock.close()
                    except OSError:
                        pass
            if self._alive:
                self._stop_evt.wait(self._backoff.next_delay())

    def _session(self, sock: socket.socket, send_every: float,
                 expect_every: float) -> None:
        last_sent = last_seen = time.monotonic()
        sock.settimeout(min(send_every or 1.0, 1.0))
        while self._alive:
            now = time.monotonic()
            if send_every and now - last_sent >= send_every:
                sock.sendall(b"\n")
                last_sent = now
            if expect_every and now - last_seen > 2 * expect_every:
                raise StompError("heart-beat timeout: broker silent")
            try:
                data = sock.recv(65536)
            except socket.timeout:
                continue
            if not data:
                raise StompError("broker closed the connection")
            last_seen = time.monotonic()
            for command, headers, body in self._reader.feed(data):
                if command == "MESSAGE":
                    delivered = True
                    if body:
                        try:
                            self._emit(body)
                        except OverloadShed:
                            # STOMP-native backpressure: leave the
                            # MESSAGE unacked — the broker redelivers
                            # once the subscription recovers (shed ≠
                            # loss; the payload is also dead-lettered
                            # at the admission edge for audit/replay)
                            delivered = False
                        except Exception:
                            # a poison message must not kill the receiver
                            # thread; leaving it unacked makes the broker
                            # redeliver (the at-least-once contract)
                            delivered = False
                            self.emit_errors += 1
                            logger.exception(
                                "%s: sink failed; message left unacked",
                                self.name)
                    if self.ack != "auto" and delivered:
                        ack_id = headers.get("ack")
                        if ack_id:
                            sock.sendall(
                                encode_frame("ACK", {"id": ack_id}))
                            last_sent = time.monotonic()
                            self.acked += 1
                elif command == "ERROR":
                    raise StompError(
                        headers.get("message", "broker ERROR"))
                # RECEIPT and others: ignore
