"""Binary frame protocol for the cross-host RPC fabric.

Counterpart of ``sitewhere_tpu/rpc/wire.py``, byte for byte: a
frame either package encodes, the other decodes.

Reference: the gRPC fabric (``sitewhere-grpc-client``, SURVEY.md §1 L3)
moves protobuf request/reply frames over HTTP/2 with JWT + tenant-token
metadata headers (``JwtClientInterceptor.java``,
``TenantTokenClientInterceptor.java``).  The redesign keeps RPC
strictly at the host boundary (SURVEY.md §2.4: in-slice lookups are
tensor gathers; "out-of-pod: plain RPC only at the boundary"), so the
fabric here is deliberately small: one length-delimited frame layout on a
plain TCP stream, no HTTP/2 machinery, no generated stubs.

Frame layout (big-endian)::

    magic     4s   b"SWR1"
    flags     u8   bit0 = response, bit1 = error response
    reserved  u8
    request_id u64 correlates a response to its request on one connection
    method    u16-prefixed utf-8   (request frames; empty on responses)
    headers   u32-prefixed JSON    (authorization / tenant / trace ids)
    body      u32-prefixed JSON    (the structured payload)
    attach    u32-prefixed bytes   (bulk lane: columnar event payloads,
                                    checkpoint blobs — kept OUT of JSON so
                                    forwarding a 1M-row NDJSON batch never
                                    round-trips through text encoding)

The separate binary attachment lane is the design point: the reference
ships Kafka payloads as protobuf ``bytes`` next to its gRPC metadata for
the same reason (``EventModelMarshaler.java``).
"""

from __future__ import annotations

import json
import socket
import struct
from typing import Dict, Optional, Tuple

# Trace context rides the JSON headers lane next to authorization/tenant
# (the reference's tracing interceptors stamp gRPC metadata the same
# way): ``trace-id`` + ``parent-id`` + ``trace-sampled`` headers —
# written by Trace.propagate, read by Tracer.join (runtime/tracing.py);
# the wire layer itself treats them as opaque headers.  The same lane
# carries the call's deadline budget (``deadline-ms``, absolute unix
# epoch milliseconds — the gRPC grpc-timeout analog; channel.py writes
# it, server.py rejects already-expired work before dispatch) and the
# response-side overload piggyback (``x-overload``/``x-retry-after``).

MAGIC = b"SWR1"
FLAG_RESPONSE = 0x01
FLAG_ERROR = 0x02

_HEADER = struct.Struct(">4sBBQ")  # magic, flags, reserved, request_id

MAX_METHOD = 256
MAX_HEADERS = 1 << 16
MAX_BODY = 1 << 24          # 16 MiB structured payload
MAX_ATTACH = 1 << 26        # 64 MiB bulk lane


class WireError(Exception):
    """Malformed frame on the stream (protocol violation — fatal for
    the connection, like an HTTP/2 GOAWAY)."""


class Frame:
    __slots__ = ("flags", "request_id", "method", "headers", "body", "attachment")

    def __init__(self, flags: int, request_id: int, method: str,
                 headers: Dict[str, str], body: object,
                 attachment: bytes = b""):
        self.flags = flags
        self.request_id = request_id
        self.method = method
        self.headers = headers
        self.body = body
        self.attachment = attachment

    @property
    def is_response(self) -> bool:
        return bool(self.flags & FLAG_RESPONSE)

    @property
    def is_error(self) -> bool:
        return bool(self.flags & FLAG_ERROR)


def request_frame(request_id: int, method: str, body: object,
                  headers: Optional[Dict[str, str]] = None,
                  attachment: bytes = b"") -> Frame:
    return Frame(0, request_id, method, headers or {}, body, attachment)


def response_frame(request_id: int, body: object,
                   attachment: bytes = b"", error: bool = False,
                   headers: Optional[Dict[str, str]] = None) -> Frame:
    """``headers`` is the response metadata lane: the server piggybacks
    its overload state (``x-overload`` / ``x-retry-after``) on every
    reply so clients learn fleet pressure at call rate — see
    ``rpc/health.py``."""
    flags = FLAG_RESPONSE | (FLAG_ERROR if error else 0)
    return Frame(flags, request_id, "", headers or {}, body, attachment)


def encode(frame: Frame) -> bytes:
    method = frame.method.encode("utf-8")
    headers = json.dumps(frame.headers, separators=(",", ":")).encode("utf-8")
    body = json.dumps(frame.body, separators=(",", ":")).encode("utf-8")
    if len(method) > MAX_METHOD:
        raise WireError(f"method too long: {len(method)}")
    if len(headers) > MAX_HEADERS:
        raise WireError(f"headers too large: {len(headers)}")
    if len(body) > MAX_BODY:
        raise WireError(f"body too large: {len(body)}")
    if len(frame.attachment) > MAX_ATTACH:
        raise WireError(f"attachment too large: {len(frame.attachment)}")
    return b"".join((
        _HEADER.pack(MAGIC, frame.flags, 0, frame.request_id),
        struct.pack(">H", len(method)), method,
        struct.pack(">I", len(headers)), headers,
        struct.pack(">I", len(body)), body,
        struct.pack(">I", len(frame.attachment)), frame.attachment,
    ))


def _read_exact(sock: socket.socket, n: int) -> bytes:
    """Read exactly ``n`` bytes or raise ConnectionError on EOF."""
    parts = []
    remaining = n
    while remaining:
        chunk = sock.recv(min(remaining, 1 << 20))
        if not chunk:
            raise ConnectionError("connection closed mid-frame"
                                  if parts or remaining != n else
                                  "connection closed")
        parts.append(chunk)
        remaining -= len(chunk)
    return b"".join(parts)


def read_frame(sock: socket.socket) -> Frame:
    """Read one frame off ``sock``; raises ConnectionError on clean or
    mid-frame EOF, WireError on protocol violations."""
    head = _read_exact(sock, _HEADER.size)
    magic, flags, _reserved, request_id = _HEADER.unpack(head)
    if magic != MAGIC:
        raise WireError(f"bad magic {magic!r}")
    (method_len,) = struct.unpack(">H", _read_exact(sock, 2))
    if method_len > MAX_METHOD:
        raise WireError(f"method too long: {method_len}")
    try:
        method = (_read_exact(sock, method_len).decode("utf-8")
                  if method_len else "")
    except UnicodeDecodeError as e:
        raise WireError(f"undecodable method name: {e}") from e
    (headers_len,) = struct.unpack(">I", _read_exact(sock, 4))
    if headers_len > MAX_HEADERS:
        raise WireError(f"headers too large: {headers_len}")
    headers_raw = _read_exact(sock, headers_len) if headers_len else b"{}"
    (body_len,) = struct.unpack(">I", _read_exact(sock, 4))
    if body_len > MAX_BODY:
        raise WireError(f"body too large: {body_len}")
    body_raw = _read_exact(sock, body_len) if body_len else b""
    try:
        headers = json.loads(headers_raw)
        body = json.loads(body_raw) if body_raw else None
    except (ValueError, UnicodeDecodeError) as e:
        # version-skewed or buggy peer: surface as a protocol violation so
        # readers drop the connection instead of dying un-handled
        raise WireError(f"undecodable frame payload: {e}") from e
    (attach_len,) = struct.unpack(">I", _read_exact(sock, 4))
    if attach_len > MAX_ATTACH:
        raise WireError(f"attachment too large: {attach_len}")
    attachment = _read_exact(sock, attach_len) if attach_len else b""
    if not isinstance(headers, dict):
        raise WireError("headers must be a JSON object")
    return Frame(flags, request_id, method, headers, body, attachment)


def write_frame(sock: socket.socket, frame: Frame) -> None:
    sock.sendall(encode(frame))


def parse_endpoint(endpoint: str) -> Tuple[str, int]:
    """``host:port`` → tuple; the static-topology discovery format
    (Consul replaced by explicit endpoint lists, SURVEY.md §2.4)."""
    host, _, port = endpoint.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"bad endpoint {endpoint!r} (want host:port)")
    return host, int(port)
