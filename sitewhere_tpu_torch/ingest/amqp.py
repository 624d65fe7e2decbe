"""AMQP 0-9-1 client: native RabbitMQ ingest without broker plugins.

Reference: ``service-event-sources/.../rabbitmq/RabbitMqInboundEventReceiver.java``
consumes a RabbitMQ queue through the Java AMQP client.  The STOMP
receiver (:mod:`sitewhere_tpu_torch.ingest.stomp`) reaches RabbitMQ only when
its STOMP plugin is enabled; this module speaks the broker's NATIVE
protocol — a from-scratch consume-side AMQP 0-9-1 client
(https://www.rabbitmq.com/resources/specs/amqp0-9-1.pdf):

- protocol handshake (``AMQP\\x00\\x00\\x09\\x01``), PLAIN
  authentication, tune negotiation (frame-max + heartbeat), vhost open;
- one channel: ``basic.qos`` prefetch, ``queue.declare`` (idempotent),
  ``basic.consume`` with explicit acks;
- every delivery (method + content header + body frames, multi-frame
  bodies reassembled) feeds the sink and is ``basic.ack``ed ONLY after
  the sink accepts — a crash between delivery and journal append
  redelivers (the broker plays the Kafka-offset role the reference
  relies on, ``MicroserviceKafkaConsumer.java:94``);
- negotiated heartbeats with a dead-connection cutoff and
  capped-exponential reconnect, like the other socket receivers.

Consume-side only by design: command egress uses the MQTT/CoAP/HTTP
destinations; publishing to AMQP would go through an outbound connector.

Counterpart of ``sitewhere_tpu/ingest/amqp.py``, whole.
"""

from __future__ import annotations

import socket
import struct
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

from sitewhere_tpu_torch.ingest.sources import Receiver, logger
from sitewhere_tpu_torch.runtime.overload import OverloadShed

PROTOCOL_HEADER = b"AMQP\x00\x00\x09\x01"

FRAME_METHOD = 1
FRAME_HEADER = 2
FRAME_BODY = 3
FRAME_HEARTBEAT = 8
FRAME_END = 0xCE

# (class, method) ids used by the consume path
CONNECTION_START = (10, 10)
CONNECTION_START_OK = (10, 11)
CONNECTION_TUNE = (10, 30)
CONNECTION_TUNE_OK = (10, 31)
CONNECTION_OPEN = (10, 40)
CONNECTION_OPEN_OK = (10, 41)
CONNECTION_CLOSE = (10, 50)
CONNECTION_CLOSE_OK = (10, 51)
CHANNEL_OPEN = (20, 10)
CHANNEL_OPEN_OK = (20, 11)
CHANNEL_CLOSE = (20, 40)
CHANNEL_CLOSE_OK = (20, 41)
QUEUE_DECLARE = (50, 10)
QUEUE_DECLARE_OK = (50, 11)
BASIC_QOS = (60, 10)
BASIC_QOS_OK = (60, 11)
BASIC_CONSUME = (60, 20)
BASIC_CONSUME_OK = (60, 21)
BASIC_DELIVER = (60, 60)
BASIC_ACK = (60, 80)
BASIC_NACK = (60, 120)


class AmqpError(Exception):
    """Protocol violation or broker-initiated close."""


# -- wire primitives --------------------------------------------------------

def shortstr(s: str) -> bytes:
    b = s.encode("utf-8")
    if len(b) > 255:
        raise AmqpError(f"shortstr too long ({len(b)})")
    return bytes([len(b)]) + b


def longstr(b: bytes) -> bytes:
    return struct.pack(">I", len(b)) + b


def field_table(d: Dict[str, object]) -> bytes:
    """Encode a field table (the subset the handshake needs: longstr,
    bool, signed 32-bit int, nested table)."""
    out = bytearray()
    for k, v in d.items():
        out += shortstr(k)
        if isinstance(v, bool):
            out += b"t" + (b"\x01" if v else b"\x00")
        elif isinstance(v, int):
            out += b"I" + struct.pack(">i", v)
        elif isinstance(v, dict):
            out += b"F" + field_table(v)
        else:
            raw = v if isinstance(v, bytes) else str(v).encode("utf-8")
            out += b"S" + longstr(raw)
    return longstr(bytes(out))


def frame(ftype: int, channel: int, payload: bytes) -> bytes:
    return (struct.pack(">BHI", ftype, channel, len(payload))
            + payload + bytes([FRAME_END]))


def method_frame(channel: int, cm: Tuple[int, int], args: bytes = b"") -> bytes:
    return frame(FRAME_METHOD, channel,
                 struct.pack(">HH", cm[0], cm[1]) + args)


def parse_shortstr(buf: bytes, off: int) -> Tuple[str, int]:
    n = buf[off]
    return buf[off + 1: off + 1 + n].decode("utf-8"), off + 1 + n


class FrameReader:
    """Incremental AMQP frame parser → (type, channel, payload) tuples."""

    def __init__(self, max_frame: int = 16 << 20):
        self._buf = bytearray()
        self.max_frame = max_frame

    def feed(self, data: bytes) -> List[Tuple[int, int, bytes]]:
        self._buf += data
        frames: List[Tuple[int, int, bytes]] = []
        while len(self._buf) >= 7:
            ftype, channel, size = struct.unpack_from(">BHI", self._buf, 0)
            if size > self.max_frame:
                raise AmqpError(f"frame too large: {size}")
            if len(self._buf) < 7 + size + 1:
                break
            end = self._buf[7 + size]
            if end != FRAME_END:
                raise AmqpError(f"bad frame end 0x{end:02x}")
            frames.append((ftype, channel,
                           bytes(self._buf[7: 7 + size])))
            del self._buf[: 7 + size + 1]
        return frames


class AmqpReceiver(Receiver):
    """Consume one AMQP queue; every delivery body is an encoded event
    payload, acked only after the sink accepts it."""

    CHANNEL = 1

    def __init__(self, host: str, port: int = 5672, vhost: str = "/",
                 queue: str = "sitewhere.input",
                 username: str = "guest", password: str = "guest",
                 prefetch: int = 64, declare: bool = True,
                 durable: bool = True, heartbeat_s: int = 10,
                 reconnect_delay_s: float = 0.5,
                 max_reconnect_delay_s: float = 30.0):
        super().__init__(name=f"amqp-receiver:{host}:{port}/{queue}")
        # basic.ack is sent only AFTER the sink accepts the delivery:
        # the ingest decode pool must keep this source synchronous or
        # the ack would precede the journal append (at-least-once)
        self.acks_on_emit = True
        self.host, self.port = host, port
        self.vhost = vhost
        self.queue = queue
        self.username, self.password = username, password
        self.prefetch = prefetch
        self.declare = declare
        self.durable = durable
        self.heartbeat_s = heartbeat_s
        self.reconnect_delay_s = reconnect_delay_s
        self.max_reconnect_delay_s = max_reconnect_delay_s
        self._alive = False
        self._stop_evt = threading.Event()
        self._sock: Optional[socket.socket] = None
        self.connects = 0
        self.acked = 0
        self.nacked = 0
        self.emit_errors = 0
        # consecutive sink failures → escalating pre-nack delay, so a
        # persistently failing sink (nack → broker requeues near the
        # head → instant redelivery to this sole consumer) degrades to a
        # slow retry loop, not a CPU-burning redeliver/nack spin
        self._nack_streak = 0
        # same pacing for overload sheds (tracked separately: a shed is
        # backpressure, not a fault — no error counters, no logs)
        self._shed_streak = 0
        # Frames parsed past the one a handshake step awaited (the broker
        # may coalesce e.g. consume-ok + the first deliver into one TCP
        # segment); _consume drains these before its first recv.
        self._pending: Deque[Tuple[int, int, bytes]] = deque()

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        self._alive = True
        self._stop_evt.clear()
        # Supervised (ROADMAP: remaining-receiver chaos coverage):
        # transport errors are handled by the reconnect loop itself;
        # the supervisor catches anything unexpected — a frame-codec
        # bug (struct.error/IndexError from a malformed frame), an
        # injected fault escaping the per-delivery guard — and restarts
        # the whole loop with backoff instead of silently killing the
        # consumer thread, escalating terminally after max_restarts.
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

    # -- session -------------------------------------------------------------

    def _expect(self, sock: socket.socket, reader: FrameReader,
                cm: Tuple[int, int]) -> bytes:
        """Read frames until the wanted method arrives on any channel;
        heartbeats are tolerated, anything else is a protocol error.

        Frames the broker coalesced into the same TCP segment AFTER the
        awaited method (e.g. a basic.deliver right behind consume-ok)
        stay on ``self._pending`` for the consume loop — returning
        mid-batch must not drop them, or they would sit unacked at the
        broker forever while eating prefetch window."""
        while True:
            while self._pending:
                ftype, channel, payload = self._pending.popleft()
                if ftype == FRAME_HEARTBEAT:
                    continue
                if ftype != FRAME_METHOD or len(payload) < 4:
                    raise AmqpError(f"unexpected frame type {ftype}")
                got = struct.unpack_from(">HH", payload, 0)
                if got == CONNECTION_CLOSE:
                    code, off = struct.unpack_from(">H", payload, 4)[0], 6
                    text, off = parse_shortstr(payload, off)
                    raise AmqpError(f"broker closed: {code} {text}")
                if got != cm:
                    raise AmqpError(f"expected {cm}, got {got}")
                return payload[4:]
            data = sock.recv(65536)
            if not data:
                raise AmqpError("broker closed during handshake")
            self._pending.extend(reader.feed(data))

    def _connect(self) -> Tuple[socket.socket, FrameReader, float]:
        sock = socket.create_connection((self.host, self.port), timeout=10)
        try:
            return self._handshake(sock)
        except BaseException:
            try:
                sock.close()
            except OSError:
                pass
            raise

    def _handshake(self, sock) -> Tuple[socket.socket, FrameReader, float]:
        sock.settimeout(10)
        reader = FrameReader()
        self._pending.clear()  # nothing carried over from a dead session
        sock.sendall(PROTOCOL_HEADER)
        self._expect(sock, reader, CONNECTION_START)
        response = b"\x00" + self.username.encode() + b"\x00" + \
            self.password.encode()
        sock.sendall(method_frame(0, CONNECTION_START_OK,
                     field_table({"product": "sitewhere-tpu",
                                  "platform": "python"})
                     + shortstr("PLAIN") + longstr(response)
                     + shortstr("en_US")))
        tune = self._expect(sock, reader, CONNECTION_TUNE)
        channel_max, frame_max, hb = struct.unpack_from(">HIH", tune, 0)
        # negotiate DOWN: 0 from either side means "no limit"/"disabled"
        frame_max = min(frame_max or 1 << 20, 1 << 20)
        heartbeat = (min(hb, self.heartbeat_s) if hb and self.heartbeat_s
                     else (hb or self.heartbeat_s))
        sock.sendall(method_frame(0, CONNECTION_TUNE_OK, struct.pack(
            ">HIH", min(channel_max or 2047, 2047), frame_max, heartbeat)))
        sock.sendall(method_frame(0, CONNECTION_OPEN,
                                  shortstr(self.vhost) + shortstr("")
                                  + b"\x00"))
        self._expect(sock, reader, CONNECTION_OPEN_OK)

        ch = self.CHANNEL
        sock.sendall(method_frame(ch, CHANNEL_OPEN, shortstr("")))
        self._expect(sock, reader, CHANNEL_OPEN_OK)
        sock.sendall(method_frame(ch, BASIC_QOS, struct.pack(
            ">IHB", 0, self.prefetch, 0)))
        self._expect(sock, reader, BASIC_QOS_OK)
        if self.declare:
            flags = 0x02 if self.durable else 0  # durable bit
            sock.sendall(method_frame(ch, QUEUE_DECLARE, struct.pack(
                ">H", 0) + shortstr(self.queue) + bytes([flags])
                + field_table({})))
            self._expect(sock, reader, QUEUE_DECLARE_OK)
        # no-local=0 no-ack=0 exclusive=0 no-wait=0 → explicit acks
        sock.sendall(method_frame(ch, BASIC_CONSUME, struct.pack(
            ">H", 0) + shortstr(self.queue) + shortstr("") + b"\x00"
            + field_table({})))
        self._expect(sock, reader, BASIC_CONSUME_OK)
        return sock, reader, float(heartbeat)

    # -- consume loop --------------------------------------------------------

    def _loop(self) -> None:
        delay = self.reconnect_delay_s
        while self._alive:
            try:
                sock, reader, heartbeat = self._connect()
            except (OSError, AmqpError) as e:
                if not self._alive:
                    return
                logger.warning("%s: connect failed (%s); retry in %.1fs",
                               self.name, e, delay)
                if self._stop_evt.wait(delay):
                    return
                delay = min(delay * 2, self.max_reconnect_delay_s)
                continue
            self._sock = sock
            self.connects += 1
            delay = self.reconnect_delay_s
            try:
                self._consume(sock, reader, heartbeat)
            except (OSError, AmqpError) as e:
                if self._alive:
                    logger.warning("%s: session lost (%s); reconnecting",
                                   self.name, e)
            finally:
                self._sock = None
                try:
                    sock.close()
                except OSError:
                    pass

    def _consume(self, sock, reader: FrameReader, heartbeat: float) -> None:
        # in-flight delivery assembly state
        delivery_tag: Optional[int] = None
        body_size = 0
        body = bytearray()
        last_rx = time.monotonic()
        last_tx = time.monotonic()
        sock.settimeout(max(0.2, heartbeat / 4 if heartbeat else 5.0))
        while self._alive:
            now = time.monotonic()
            if heartbeat:
                if now - last_rx > 2 * heartbeat:
                    raise AmqpError("heartbeat timeout")
                if now - last_tx >= heartbeat:
                    sock.sendall(frame(FRAME_HEARTBEAT, 0, b""))
                    last_tx = now
            if self._pending:
                # deliveries the handshake's _expect already parsed
                frames = list(self._pending)
                self._pending.clear()
            else:
                try:
                    data = sock.recv(65536)
                except socket.timeout:
                    continue
                if not data:
                    raise AmqpError("connection closed by broker")
                last_rx = time.monotonic()
                frames = reader.feed(data)
            for ftype, channel, payload in frames:
                if ftype == FRAME_HEARTBEAT:
                    continue
                if ftype == FRAME_METHOD:
                    cm = struct.unpack_from(">HH", payload, 0)
                    if cm == BASIC_DELIVER:
                        off = 4
                        _tag, off = parse_shortstr(payload, off)
                        delivery_tag = struct.unpack_from(
                            ">Q", payload, off)[0]
                        body = bytearray()
                        body_size = -1  # header frame pending
                    elif cm == CONNECTION_CLOSE:
                        sock.sendall(method_frame(0, CONNECTION_CLOSE_OK))
                        raise AmqpError("broker closed connection")
                    elif cm == CHANNEL_CLOSE:
                        sock.sendall(method_frame(
                            channel, CHANNEL_CLOSE_OK))
                        raise AmqpError("broker closed channel")
                    # consume-path replies (qos-ok etc. mid-stream): ignore
                elif ftype == FRAME_HEADER and delivery_tag is not None:
                    body_size = struct.unpack_from(">Q", payload, 4)[0]
                    if body_size == 0:
                        last_tx = self._finish(sock, delivery_tag, bytes(body),
                                               last_tx)
                        delivery_tag = None
                elif ftype == FRAME_BODY and delivery_tag is not None:
                    body += payload
                    if body_size >= 0 and len(body) >= body_size:
                        last_tx = self._finish(sock, delivery_tag, bytes(body),
                                               last_tx)
                        delivery_tag = None

    def _finish(self, sock, delivery_tag: int, payload: bytes,
                last_tx: float) -> float:
        """Sink the payload; ack ONLY on acceptance (redelivery covers a
        crash; a poison payload dead-letters in the sink and is acked so
        it does not loop forever).

        A sink that RAISES (transient failure: journal full, downstream
        stall) gets ``basic.nack`` with requeue — leaving the delivery
        unacked would strand it until connection close and, after
        ``prefetch`` such failures, stall the consumer forever on an
        otherwise-healthy session.  Consecutive failures back off
        (50 ms doubling to 1 s) before the nack, because the broker
        redelivers a requeued message to this sole consumer immediately.

        An admission SHED is different from a failure but takes the
        same wire action, separately paced and counted: an escalating
        pause, then ``basic.nack`` with requeue.  Leaving the delivery
        unacked instead would eat the prefetch window on a
        heartbeat-healthy session that never recycles — after
        ``prefetch`` sheds the broker stops delivering and the consumer
        is wedged FOREVER, even after overload clears (the exact stall
        documented above).  The pre-nack pause is the backpressure; the
        requeued message redelivers (at-least-once) and lands once
        admission reopens."""
        try:
            self._emit(payload)
        except OverloadShed as e:
            self._shed_streak += 1
            delay = min(max(0.05, e.retry_after_s / 16)
                        * (2 ** min(self._shed_streak - 1, 6)), 1.0)
            self._stop_evt.wait(delay)
            sock.sendall(method_frame(
                self.CHANNEL, BASIC_NACK,
                struct.pack(">QB", delivery_tag, 0x02)))
            return time.monotonic()
        except Exception:
            self.emit_errors += 1
            self.nacked += 1
            self._nack_streak += 1
            logger.exception("%s: sink rejected payload; nack + requeue "
                             "(streak %d)", self.name, self._nack_streak)
            delay = min(0.05 * (2 ** min(self._nack_streak - 1, 10)), 1.0)
            self._stop_evt.wait(delay)
            # bits: 0x01 multiple, 0x02 requeue → requeue only
            sock.sendall(method_frame(
                self.CHANNEL, BASIC_NACK,
                struct.pack(">QB", delivery_tag, 0x02)))
            return time.monotonic()
        self._nack_streak = 0
        self._shed_streak = 0
        sock.sendall(method_frame(
            self.CHANNEL, BASIC_ACK,
            struct.pack(">QB", delivery_tag, 0)))
        self.acked += 1
        return time.monotonic()
