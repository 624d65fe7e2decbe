"""CoAP server receiver — RFC 7252 message codec over UDP.

Reference: ``service-event-sources/src/main/java/com/sitewhere/sources/
coap/CoapServerEventReceiver.java`` (+ ``CoapMessageDeliverer.java``): a
Californium CoAP server terminates constrained-device traffic; devices
POST JSON event payloads and the payload bytes flow into the source's
decoder exactly like any other receiver's.

This is a from-scratch RFC 7252 implementation (no CoAP library in the
image): 4-byte header (Ver|Type|TKL, Code, Message ID), token, delta-
encoded options with 13/14 extended forms, 0xFF payload marker.  The
server accepts POST/PUT (CON → piggybacked ACK 2.04, NON → no reply),
answers GET/DELETE with 4.05 Method Not Allowed, and RSTs malformed or
non-request messages per §4.2/§4.3.  The codec is symmetric so the
command-delivery CoAP destination and tests reuse it as a client.

Counterpart of ``sitewhere_tpu/ingest/coap.py``, whole: the codec
and :class:`CoapServerReceiver`.
"""

from __future__ import annotations

import dataclasses
import logging
import socket
import struct
from collections import OrderedDict
from typing import List, Optional, Tuple

from sitewhere_tpu_torch.ingest.sources import Receiver, close_waking
from sitewhere_tpu_torch.runtime.overload import OverloadShed

logger = logging.getLogger("sitewhere_tpu_torch.ingest.coap")

# Message types (§3)
CON, NON, ACK, RST = 0, 1, 2, 3

# Method / response codes as (class, detail) → the on-wire c.dd byte
GET, POST, PUT, DELETE = 0x01, 0x02, 0x03, 0x04
CHANGED_204 = (2 << 5) | 4       # 2.04 Changed
CREATED_201 = (2 << 5) | 1       # 2.01 Created
BAD_REQUEST_400 = (4 << 5) | 0   # 4.00
NOT_ALLOWED_405 = (4 << 5) | 5   # 4.05
UNAVAILABLE_503 = (5 << 5) | 3   # 5.03 Service Unavailable

OPT_URI_PATH = 11
OPT_CONTENT_FORMAT = 12
OPT_MAX_AGE = 14


def _uint_option(value: int) -> bytes:
    """Encode a CoAP uint option value (§3.2: minimal big-endian)."""
    value = max(0, int(value))
    out = b""
    while value:
        out = bytes([value & 0xFF]) + out
        value >>= 8
    return out


class CoapError(Exception):
    pass


@dataclasses.dataclass
class CoapMessage:
    """One parsed/encodable CoAP message (§3 framing)."""

    mtype: int                      # CON/NON/ACK/RST
    code: int                       # method or response code byte
    message_id: int
    token: bytes = b""
    options: List[Tuple[int, bytes]] = dataclasses.field(default_factory=list)
    payload: bytes = b""
    version: int = 1

    @property
    def uri_path(self) -> str:
        return "/" + "/".join(
            v.decode("utf-8", "replace")
            for n, v in self.options if n == OPT_URI_PATH
        )

    def option(self, number: int) -> Optional[bytes]:
        for n, v in self.options:
            if n == number:
                return v
        return None


def _ext(value: int) -> Tuple[int, bytes]:
    """Encode an option delta/length nibble + extension bytes (§3.1)."""
    if value < 13:
        return value, b""
    if value < 269:
        return 13, bytes([value - 13])
    return 14, struct.pack("!H", value - 269)


def encode_message(msg: CoapMessage) -> bytes:
    if not 0 <= len(msg.token) <= 8:
        raise CoapError("token length 0..8")
    out = bytearray()
    out.append((msg.version << 6) | (msg.mtype << 4) | len(msg.token))
    out.append(msg.code)
    out += struct.pack("!H", msg.message_id)
    out += msg.token
    prev = 0
    for number, value in sorted(msg.options, key=lambda o: o[0]):
        dn, dext = _ext(number - prev)
        ln, lext = _ext(len(value))
        out.append((dn << 4) | ln)
        out += dext + lext + value
        prev = number
    if msg.payload:
        out.append(0xFF)
        out += msg.payload
    return bytes(out)


def _read_ext(nibble: int, data: bytes, pos: int) -> Tuple[int, int]:
    if nibble < 13:
        return nibble, pos
    if nibble == 13:
        if pos >= len(data):
            raise CoapError("truncated option extension")
        return data[pos] + 13, pos + 1
    if nibble == 14:
        if pos + 2 > len(data):
            raise CoapError("truncated option extension")
        return struct.unpack_from("!H", data, pos)[0] + 269, pos + 2
    raise CoapError("reserved option nibble 15")


def parse_message(data: bytes) -> CoapMessage:
    if len(data) < 4:
        raise CoapError("short datagram")
    b0 = data[0]
    version = b0 >> 6
    if version != 1:
        raise CoapError(f"unsupported version {version}")
    mtype = (b0 >> 4) & 0x3
    tkl = b0 & 0xF
    if tkl > 8:
        raise CoapError("token length > 8")
    code = data[1]
    (message_id,) = struct.unpack_from("!H", data, 2)
    pos = 4
    if pos + tkl > len(data):
        raise CoapError("truncated token")
    token = data[pos:pos + tkl]
    pos += tkl
    options: List[Tuple[int, bytes]] = []
    number = 0
    payload = b""
    while pos < len(data):
        byte = data[pos]
        pos += 1
        if byte == 0xFF:
            payload = data[pos:]
            if not payload:
                raise CoapError("payload marker with empty payload")
            break
        delta, pos = _read_ext(byte >> 4, data, pos)
        length, pos = _read_ext(byte & 0xF, data, pos)
        if pos + length > len(data):
            raise CoapError("truncated option value")
        number += delta
        options.append((number, data[pos:pos + length]))
        pos += length
    return CoapMessage(mtype=mtype, code=code, message_id=message_id,
                       token=token, options=options, payload=payload,
                       version=version)


class CoapServerReceiver(Receiver):
    """RFC 7252 UDP server: device POSTs become source payloads.

    Piggybacked responses (§5.2.1): CON POST/PUT → ACK 2.04 with the
    request's message id + token; NON POST/PUT → processed silently;
    other methods → 4.05; malformed CON/NON → RST; stray ACK/RST from
    clients are ignored (§4.2).
    """

    # Retransmission dedup window (RFC 7252 §4.5): EXCHANGE_LIFETIME is
    # ~247s; a bounded LRU keyed on (endpoint, message id) covers it at
    # realistic rates while bounding memory.
    DEDUP_CAPACITY = 4096

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        super().__init__(name=f"coap-receiver:{port}")
        # the piggybacked ACK 2.04 is sent only after _emit returns: the
        # client's CON retransmission is the redelivery cue, so the
        # ingest decode pool must keep this source synchronous
        self.acks_on_emit = True
        self.host, self.port = host, port
        self._sock: Optional[socket.socket] = None
        self._alive = False
        self.bad_messages = 0
        self.duplicates = 0
        self.emit_errors = 0
        # (addr, message_id) → cached reply bytes (None for NON, §4.5:
        # the dup is silently ignored when there is nothing to retransmit)
        self._seen: "OrderedDict[tuple, Optional[bytes]]" = OrderedDict()

    def _bind(self) -> None:
        if self._sock is None:
            self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            self._sock.bind((self.host, self.port))
            self.port = self._sock.getsockname()[1]

    def start(self) -> None:
        self._bind()
        self._alive = True
        # Supervised (ROADMAP: remaining-receiver chaos coverage): an
        # unexpected socket death restarts the loop with backoff and
        # rebinds the SAME port (datagrams sent during the backoff sit
        # in the kernel buffer); repeated failures escalate terminally.
        self._spawn_supervised(self._run)
        super().start()

    def stop(self) -> None:
        self._alive = False
        if self._sock is not None:
            close_waking(self._sock)
            self._sock = None
        self._stop_supervisor()
        super().stop()

    def _run(self) -> None:
        self._bind()   # restart after a crash that closed the socket
        while self._alive:
            sock = self._sock
            if sock is None:
                return   # stop() tore the socket down mid-iteration
            try:
                data, addr = sock.recvfrom(65536)
            except OSError:
                if not self._alive:
                    return   # clean shutdown closed the socket
                # release the port before the supervised restart rebinds
                # it (same contract as UdpReceiver._run)
                sock, self._sock = self._sock, None
                if sock is not None:
                    try:
                        sock.close()
                    except OSError:
                        pass
                raise        # unexpected socket death → supervisor restarts
            if not data:
                continue
            try:
                reply = self._handle(data, addr)
            except CoapError as e:
                self.bad_messages += 1
                reply = self._rst_for(data)
                logger.debug("bad CoAP datagram from %s: %s", addr, e)
            except Exception:
                # sink/emit crash: datagram-local, like a TCP
                # connection-local crash — NO reply goes out and the
                # (addr, mid) is NOT cached, so the client's CON
                # retransmission re-emits the payload (CoAP's
                # redelivery semantics); the server loop keeps serving
                self.emit_errors += 1
                logger.exception("CoAP handler failed")
                continue
            if reply is not None:
                try:
                    sock.sendto(reply, addr)
                except OSError:
                    if not self._alive:
                        return
                    raise

    def _handle(self, data: bytes, addr) -> Optional[bytes]:
        msg = parse_message(data)
        if msg.mtype in (ACK, RST):
            return None  # client-side message; nothing to do (§4.2)
        # Retransmission dedup (§4.5): a retried CON whose ACK was lost
        # must get the SAME response back without re-emitting the payload.
        key = (addr, msg.message_id)
        if key in self._seen:
            self.duplicates += 1
            self._seen.move_to_end(key)
            return self._seen[key]
        options: List[Tuple[int, bytes]] = []
        if msg.code in (POST, PUT):
            if msg.payload:
                try:
                    self._emit(msg.payload)
                    code = CHANGED_204
                except OverloadShed as e:
                    # CoAP-native backpressure (§5.9.3.4): 5.03 with
                    # Max-Age as the retry hint — the constrained
                    # client backs off instead of retransmitting hot
                    code = UNAVAILABLE_503
                    options.append((OPT_MAX_AGE, _uint_option(
                        max(1, int(round(e.retry_after_s))))))
            else:
                code = BAD_REQUEST_400
        elif msg.code in (GET, DELETE):
            code = NOT_ALLOWED_405
        else:
            # response code in a CON/NON request slot: reject
            raise CoapError(f"unexpected code {msg.code:#x}")
        reply = None
        if msg.mtype == CON:
            reply = encode_message(CoapMessage(
                mtype=ACK, code=code, message_id=msg.message_id,
                token=msg.token, options=options,
            ))
        self._seen[key] = reply
        while len(self._seen) > self.DEDUP_CAPACITY:
            self._seen.popitem(last=False)
        return reply

    @staticmethod
    def _rst_for(data: bytes) -> Optional[bytes]:
        """Best-effort RST echoing the (possibly torn) message id (§4.3)."""
        if len(data) < 4 or data[0] >> 6 != 1:
            return None
        (mid,) = struct.unpack_from("!H", data, 2)
        return encode_message(CoapMessage(mtype=RST, code=0, message_id=mid))


def encode_post(path: str, payload: bytes, message_id: int,
                token: bytes = b"", confirmable: bool = True,
                content_format: int = 50) -> bytes:
    """Client-side helper: a POST request datagram (50 = application/json)."""
    options: List[Tuple[int, bytes]] = [
        (OPT_URI_PATH, seg.encode()) for seg in path.strip("/").split("/")
        if seg
    ]
    if content_format is not None:
        options.append((
            OPT_CONTENT_FORMAT,
            bytes([content_format]) if content_format < 256
            else struct.pack("!H", content_format),
        ))
    return encode_message(CoapMessage(
        mtype=CON if confirmable else NON, code=POST,
        message_id=message_id, token=token, options=options,
        payload=payload,
    ))
