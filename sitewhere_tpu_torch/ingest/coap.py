"""CoAP — the RFC 7252 message codec over UDP.

Counterpart of the codec of ``sitewhere_tpu/ingest/coap.py`` (:48-172
and ``encode_post`` :323-341): :class:`CoapMessage`,
:func:`encode_message`, :func:`parse_message` and :func:`encode_post`,
which the command-delivery CoAP destination speaks as a client.  The
reference's ``CoapServerReceiver`` (:173) needs the event sources'
``Receiver`` and the overload controller, and comes with the event
sources.

A from-scratch RFC 7252 implementation (no CoAP library in the image):
4-byte header (Ver|Type|TKL, Code, Message ID), token, delta-encoded
options with 13/14 extended forms, 0xFF payload marker.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import List, Optional, Tuple

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
