"""Minimal RFC 6455 WebSocket server support (stdlib only).

Two consumers:
- the admin topology feed (reference: ``web/ws/components/
  TopologyBroadcaster.java`` pushes live microservice/tenant-engine state
  over STOMP WebSocket to the admin UI);
- :class:`ClientWebSocket` backs the ingest
  :class:`~sitewhere_tpu_torch.ingest.sources.WebSocketReceiver`.

Implements the server handshake (Sec-WebSocket-Accept), frame
encode/decode with client masking, text/binary/ping/pong/close opcodes,
and fragmented-message reassembly with interleaved control frames
(RFC 6455 §5.4).  No extensions (permessage-deflate etc.).

Counterpart of ``sitewhere_tpu/web/ws.py``, whole; the port's
``WebServer`` serves ``/ws/topology`` over it and the ingest
``WebSocketReceiver`` connects with it.
"""

from __future__ import annotations

import base64
import hashlib
import socket
import struct
import threading
from typing import Optional, Tuple

_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

OP_CONT, OP_TEXT, OP_BINARY, OP_CLOSE, OP_PING, OP_PONG = 0, 1, 2, 8, 9, 10


def accept_key(client_key: str) -> str:
    digest = hashlib.sha1((client_key + _GUID).encode()).digest()
    return base64.b64encode(digest).decode()


def encode_frame(opcode: int, payload: bytes, mask: bool = False) -> bytes:
    """Build one frame (server frames are unmasked; client frames masked)."""
    head = bytearray([0x80 | opcode])
    n = len(payload)
    mask_bit = 0x80 if mask else 0
    if n < 126:
        head.append(mask_bit | n)
    elif n < (1 << 16):
        head.append(mask_bit | 126)
        head += struct.pack(">H", n)
    else:
        head.append(mask_bit | 127)
        head += struct.pack(">Q", n)
    if mask:
        key = struct.pack(">I", 0x12345678)
        head += key
        payload = bytes(b ^ key[i % 4] for i, b in enumerate(payload))
    return bytes(head) + payload


def _read_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("websocket peer closed")
        buf += chunk
    return buf


def read_frame(sock: socket.socket) -> Tuple[int, bytes, bool]:
    """Read one frame → (opcode, payload, fin)."""
    b0, b1 = _read_exact(sock, 2)
    fin = bool(b0 & 0x80)
    opcode = b0 & 0x0F
    masked = bool(b1 & 0x80)
    length = b1 & 0x7F
    if length == 126:
        (length,) = struct.unpack(">H", _read_exact(sock, 2))
    elif length == 127:
        (length,) = struct.unpack(">Q", _read_exact(sock, 8))
    key = _read_exact(sock, 4) if masked else None
    payload = _read_exact(sock, length) if length else b""
    if key is not None:
        payload = bytes(b ^ key[i % 4] for i, b in enumerate(payload))
    return opcode, payload, fin


class ServerWebSocket:
    """One accepted server-side connection.

    Sends are serialized with a per-socket lock: the broadcaster thread's
    ``send_text`` and the recv thread's PONG replies share the socket, and
    interleaved partial writes would desync the client's frame parser.
    """

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.open = True
        self._send_lock = threading.Lock()

    def _send_frame(self, frame: bytes) -> None:
        with self._send_lock:
            self.sock.sendall(frame)

    @classmethod
    def handshake(cls, handler) -> Optional["ServerWebSocket"]:
        """Upgrade from a BaseHTTPRequestHandler; None if not a WS request."""
        key = handler.headers.get("Sec-WebSocket-Key")
        if not key or handler.headers.get("Upgrade", "").lower() != "websocket":
            handler.send_response(400)
            handler.end_headers()
            return None
        handler.send_response(101, "Switching Protocols")
        handler.send_header("Upgrade", "websocket")
        handler.send_header("Connection", "Upgrade")
        handler.send_header("Sec-WebSocket-Accept", accept_key(key))
        handler.end_headers()
        handler.wfile.flush()
        sock = handler.connection
        sock.settimeout(None)
        return cls(sock)

    @classmethod
    def handshake_raw(cls, sock: socket.socket, request_head: bytes
                      ) -> Optional["ServerWebSocket"]:
        """Upgrade from a raw socket given the full HTTP request head
        (used by the standalone ingest receiver)."""
        headers = {}
        for line in request_head.split(b"\r\n")[1:]:
            if b":" in line:
                name, _, value = line.partition(b":")
                headers[name.decode().strip().lower()] = value.decode().strip()
        key = headers.get("sec-websocket-key")
        if not key or headers.get("upgrade", "").lower() != "websocket":
            sock.sendall(b"HTTP/1.1 400 Bad Request\r\nContent-Length: 0\r\n\r\n")
            return None
        sock.sendall(
            b"HTTP/1.1 101 Switching Protocols\r\n"
            b"Upgrade: websocket\r\nConnection: Upgrade\r\n"
            b"Sec-WebSocket-Accept: " + accept_key(key).encode() + b"\r\n\r\n"
        )
        return cls(sock)

    def send_text(self, text: str) -> None:
        self._send_frame(encode_frame(OP_TEXT, text.encode("utf-8")))

    def send_binary(self, data: bytes) -> None:
        self._send_frame(encode_frame(OP_BINARY, data))

    def recv(self) -> Optional[Tuple[int, bytes]]:
        """Next data message → (opcode, payload); None on close.
        Transparently answers pings and concatenates continuations."""
        opcode, payload, fin = read_frame(self.sock)
        while True:
            if opcode == OP_PING:
                self._send_frame(encode_frame(OP_PONG, payload))
            elif opcode == OP_CLOSE:
                self.close()
                return None
            elif opcode == OP_CONT:
                # continuation with no message in progress: protocol error
                self.close(code=1002)
                return None
            elif opcode in (OP_TEXT, OP_BINARY):
                data = payload
                first = opcode
                # RFC 6455 §5.4: control frames may interleave between
                # fragments — handle them without ending reassembly, and
                # track fin only from continuation frames.
                while not fin:
                    opcode, payload, cfin = read_frame(self.sock)
                    if opcode == OP_CONT:
                        data += payload
                        fin = cfin
                    elif opcode == OP_PING:
                        self._send_frame(encode_frame(OP_PONG, payload))
                    elif opcode == OP_CLOSE:
                        self.close()
                        return None
                    elif opcode in (OP_TEXT, OP_BINARY):
                        # RFC 6455 §5.4: a new data frame before the prior
                        # message's FIN is a protocol error — fail fast
                        # (1002) instead of silently desynchronizing.
                        self.close(code=1002)
                        return None
                return first, data
            opcode, payload, fin = read_frame(self.sock)

    def close(self, code: Optional[int] = None) -> None:
        """Close the connection; a ``code`` fails it (RFC 6455 §7.1.7)."""
        if self.open:
            self.open = False
            payload = struct.pack("!H", code) if code is not None else b""
            try:
                self._send_frame(encode_frame(OP_CLOSE, payload))
            except OSError:
                pass
            try:
                self.sock.close()
            except OSError:
                pass


class _BufferedSock:
    """Socket adapter replaying bytes over-read during the handshake —
    a server pushing its first frame in the same TCP segment as the 101
    response must not lose it."""

    def __init__(self, sock: socket.socket, initial: bytes = b""):
        self._sock = sock
        self._buf = initial

    def recv(self, n: int) -> bytes:
        if self._buf:
            out, self._buf = self._buf[:n], self._buf[n:]
            return out
        return self._sock.recv(n)

    def sendall(self, data: bytes) -> None:
        self._sock.sendall(data)

    def close(self) -> None:
        self._sock.close()


class ClientWebSocket:
    """Tiny client for the ingest WebSocket receiver, tests, and the
    polling/bridge paths."""

    def __init__(self, host: str, port: int, path: str = "/",
                 timeout: float = 10.0, headers=None):
        raw = socket.create_connection((host, port), timeout=timeout)
        key = base64.b64encode(b"sitewhere-tpu-cli").decode()
        extra = "".join(f"{k}: {v}\r\n" for k, v in (headers or {}).items())
        raw.sendall(
            f"GET {path} HTTP/1.1\r\nHost: {host}:{port}\r\n"
            f"Upgrade: websocket\r\nConnection: Upgrade\r\n"
            f"Sec-WebSocket-Key: {key}\r\nSec-WebSocket-Version: 13\r\n"
            f"{extra}\r\n"
            .encode()
        )
        head = b""
        while b"\r\n\r\n" not in head:
            chunk = raw.recv(4096)
            if not chunk:
                raise ConnectionError("handshake failed")
            head += chunk
        head, _, remainder = head.partition(b"\r\n\r\n")
        status = head.split(b"\r\n", 1)[0]
        if b"101" not in status:
            raise ConnectionError(f"handshake rejected: {status!r}")
        expect = accept_key(key).encode()
        if expect not in head:
            raise ConnectionError("bad Sec-WebSocket-Accept")
        # `timeout` bounds connect+handshake only; a long-lived feed may
        # legitimately sit idle, so recv must block until data or close()
        # (which unblocks it with an OSError).
        raw.settimeout(None)
        self.sock = _BufferedSock(raw, remainder)

    def send_text(self, text: str) -> None:
        self.sock.sendall(encode_frame(OP_TEXT, text.encode(), mask=True))

    def send_binary(self, data: bytes) -> None:
        self.sock.sendall(encode_frame(OP_BINARY, data, mask=True))

    def recv(self) -> Optional[Tuple[int, bytes]]:
        opcode, payload, fin = read_frame(self.sock)
        while True:
            if opcode == OP_CLOSE:
                return None
            if opcode == OP_PING:
                self.sock.sendall(encode_frame(OP_PONG, payload, mask=True))
            if opcode in (OP_TEXT, OP_BINARY):
                data = payload
                first = opcode
                while not fin:
                    opcode, payload, cfin = read_frame(self.sock)
                    if opcode == OP_CONT:
                        data += payload
                        fin = cfin
                    elif opcode == OP_PING:
                        self.sock.sendall(
                            encode_frame(OP_PONG, payload, mask=True))
                    elif opcode == OP_CLOSE:
                        return None
                return first, data
            opcode, payload, fin = read_frame(self.sock)

    def close(self) -> None:
        try:
            self.sock.sendall(encode_frame(OP_CLOSE, b"", mask=True))
        except OSError:
            pass
        self.sock.close()
