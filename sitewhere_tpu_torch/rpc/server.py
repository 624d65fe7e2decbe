"""Server side of the RPC fabric: framed-TCP dispatch with interceptors.

Counterpart of ``sitewhere_tpu/rpc/server.py``: the same code over the
port's modules (no JAX anywhere on this path).

Reference: ``GrpcServer.java:70-78`` builds a Netty server with a JWT
interceptor, a tenant-token interceptor, and tracing interceptors;
``EventManagementRouter.java:62`` then routes each call to the right
tenant engine off the tenant header.  Here the same three concerns —
authn, tenant scoping, span tracing — wrap every registered handler, and
routing stays a dict lookup because one process hosts every domain
service (SURVEY.md §1 L2: the 19 boot shells collapse into one
composition root).

Handlers receive ``(ctx, body)`` and return ``result`` or
``(result, attachment_bytes)``; service-layer exceptions map onto typed
error frames the client re-raises as :class:`~.channel.RpcError`.
"""

from __future__ import annotations

import logging
import socket
import socketserver
import threading
from typing import Callable, Dict, Optional, Tuple

from sitewhere_tpu_torch.rpc import wire
from sitewhere_tpu_torch.rpc.channel import (
    DEADLINE_ERROR_CODE,
    deadline_remaining_s,
)
from sitewhere_tpu_torch.rpc.health import HEADER_OVERLOAD, HEADER_RETRY_AFTER
from sitewhere_tpu_torch.runtime.lifecycle import LifecycleComponent
from sitewhere_tpu_torch.runtime.metrics import global_registry
from sitewhere_tpu_torch.runtime.overload import OverloadShed
from sitewhere_tpu_torch.services.common import (
    AuthError,
    DuplicateToken,
    EntityNotFound,
    ForbiddenError,
    InvalidReference,
    ServiceError,
    ValidationError,
)

logger = logging.getLogger("sitewhere_tpu_torch.rpc")

_ERROR_CODES = (
    # an overloaded host's admission refusal is RETRYABLE backpressure
    # for the forwarding peer (its spool redelivers), never "internal"
    (OverloadShed, "overloaded"),
    (EntityNotFound, "not_found"),
    (DuplicateToken, "duplicate"),
    (InvalidReference, "invalid_reference"),
    (ValidationError, "validation"),
    (ForbiddenError, "forbidden"),
    (AuthError, "unauthorized"),
    (ServiceError, "service_error"),
)


class CallContext:
    """Per-call context handed to handlers (the interceptor outputs)."""

    __slots__ = ("method", "headers", "username", "authorities", "tenant",
                 "attachment", "peer")

    def __init__(self, method: str, headers: Dict[str, str],
                 username: Optional[str], authorities: Tuple[str, ...],
                 tenant: Optional[str], attachment: bytes, peer: str):
        self.method = method
        self.headers = headers
        self.username = username
        self.authorities = authorities
        self.tenant = tenant
        self.attachment = attachment
        self.peer = peer


class _Handler:
    __slots__ = ("fn", "authority", "auth_required")

    def __init__(self, fn, authority: Optional[str], auth_required: bool):
        self.fn = fn
        self.authority = authority
        self.auth_required = auth_required


class RpcServer(LifecycleComponent):
    """Framed-TCP RPC endpoint as a lifecycle component.

    ``tokens`` (a :class:`~sitewhere_tpu_torch.security.jwt.TokenManagement`)
    enables the JWT interceptor; when set, every handler registered with
    ``auth_required=True`` (the default) rejects calls without a valid
    ``authorization`` header — matching ``JwtServerInterceptor`` fail-
    closed semantics.  ``tracer`` records a span per dispatched call.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 tokens=None, tracer=None, name: str = "rpc-server",
                 max_inflight_per_conn: int = 32, metrics=None):
        super().__init__(name)
        self._host = host
        self._port = port
        self._tokens = tokens
        self._tracer = tracer
        # instance-scoped registry when provided (co-resident instances
        # must not share counters); process-global otherwise
        self._metrics = metrics if metrics is not None else global_registry()
        self.max_inflight_per_conn = max_inflight_per_conn
        # overload piggyback source: a callable returning
        # ``(overload_state_int, retry_after_s)`` stamped into EVERY
        # response's headers (success, error, even deadline rejections)
        # so callers' health tables learn pressure at call rate — set by
        # the instance when an OverloadController exists
        self.overload_provider: Optional[
            Callable[[], Tuple[int, float]]] = None
        self._handlers: Dict[str, _Handler] = {}
        self._server: Optional[socketserver.ThreadingTCPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._conns: set = set()
        self._conns_lock = threading.Lock()

    # -- registry ------------------------------------------------------------

    def register(self, method: str, fn: Callable,
                 authority: Optional[str] = None,
                 auth_required: bool = True) -> None:
        if method in self._handlers:
            raise ValueError(f"method already registered: {method}")
        self._handlers[method] = _Handler(fn, authority, auth_required)

    @property
    def port(self) -> int:
        if self._server is None:
            raise RuntimeError("server not started")
        return self._server.server_address[1]

    @property
    def endpoint(self) -> str:
        return f"{self._host}:{self.port}"

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        outer = self

        class ConnectionHandler(socketserver.BaseRequestHandler):
            def handle(self):
                peer = "%s:%d" % self.client_address[:2]
                self.request.setsockopt(
                    socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                with outer._conns_lock:
                    outer._conns.add(self.request)
                # Clients multiplex concurrent calls on one connection
                # (channel.py correlates by request id) — so each frame
                # dispatches on its own worker and only the response
                # sendall serializes; a slow events.query never blocks a
                # state.get behind it on the same socket.  The semaphore
                # bounds in-flight dispatches per connection: when a
                # client outruns the handlers, the read loop stalls
                # (TCP backpressure) instead of spawning unboundedly.
                send_lock = threading.Lock()
                slots = threading.Semaphore(outer.max_inflight_per_conn)
                workers = []

                def dispatch_one(frame):
                    try:
                        outer._dispatch(self.request, frame, peer,
                                        send_lock)
                    finally:
                        slots.release()

                try:
                    while True:
                        frame = wire.read_frame(self.request)
                        slots.acquire()
                        w = threading.Thread(
                            target=dispatch_one, args=(frame,),
                            name=f"rpc-call-{frame.method}", daemon=True)
                        workers.append(w)
                        w.start()
                        workers = [t for t in workers if t.is_alive()]
                except ConnectionError:
                    pass   # client went away — normal
                except wire.WireError as e:
                    logger.warning("rpc %s: protocol violation: %s", peer, e)
                except OSError:
                    pass
                finally:
                    for w in workers:
                        w.join(timeout=5)
                    with outer._conns_lock:
                        outer._conns.discard(self.request)

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((self._host, self._port), ConnectionHandler)
        self._thread = threading.Thread(
            target=self._server.serve_forever, kwargs={"poll_interval": 0.1},
            name=f"{self.name}-accept", daemon=True)
        self._thread.start()
        super().start()

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        # drop established connections too — a stopped replica must not
        # keep answering (clients fail over, ApiDemux semantics)
        with self._conns_lock:
            conns, self._conns = set(self._conns), set()
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        super().stop()

    # -- dispatch ------------------------------------------------------------

    def _authenticate(self, handler: _Handler, headers: Dict[str, str]):
        """JWT interceptor: returns (username, authorities) or raises."""
        if self._tokens is None or not handler.auth_required:
            return None, ()
        token = headers.get("authorization", "")
        if token.startswith("Bearer "):
            token = token[7:]
        if not token:
            raise AuthError("authorization header required")
        username = self._tokens.username(token)          # raises on bad/expired
        authorities = tuple(self._tokens.authorities(token))
        if handler.authority and handler.authority not in authorities:
            raise ForbiddenError(
                f"{handler.authority} required for {username}")
        return username, authorities

    def _piggyback_headers(self) -> Dict[str, str]:
        """Overload state for the response metadata lane (empty when no
        provider is wired — single-host instances pay nothing)."""
        provider = self.overload_provider
        if provider is None:
            return {}
        try:
            state, retry_after = provider()
        except Exception:   # noqa: BLE001 — telemetry must not fail replies
            logger.exception("overload provider failed")
            return {}
        return {HEADER_OVERLOAD: str(int(state)),
                HEADER_RETRY_AFTER: f"{float(retry_after):.3f}"}

    def _dispatch(self, sock, frame: wire.Frame, peer: str,
                  send_lock: Optional[threading.Lock] = None) -> None:
        send_lock = send_lock or threading.Lock()
        if frame.is_response:
            logger.warning("rpc %s: response frame on server side", peer)
            return
        # Deadline gate BEFORE any work (auth included): a call whose
        # propagated budget lapsed in flight is answered with the
        # retryable deadline_expired code without executing the handler
        # — work a slow fabric already made useless is refused, not run.
        remaining = deadline_remaining_s(frame.headers)
        if remaining is not None and remaining <= 0:
            self._metrics.counter("rpc.deadline_rejected").inc()
            try:
                payload = wire.encode(wire.response_frame(
                    frame.request_id,
                    {"error": DEADLINE_ERROR_CODE,
                     "message": (f"{frame.method}: deadline expired "
                                 f"{-remaining:.3f}s before dispatch")},
                    error=True, headers=self._piggyback_headers()))
                with send_lock:
                    sock.sendall(payload)
            except OSError:
                pass
            return
        try:
            handler = self._handlers.get(frame.method)
            if handler is None:
                raise EntityNotFound(f"no such method: {frame.method}")
            username, authorities = self._authenticate(handler, frame.headers)
            ctx = CallContext(frame.method, frame.headers, username,
                              authorities, frame.headers.get("tenant"),
                              frame.attachment, peer)
            if self._tracer is not None:
                # Continue the CALLER's trace when the headers carry one
                # (the reference's server tracing interceptor reads the
                # propagated gRPC metadata) — same trace_id on both sides
                # of the boundary; start a fresh trace otherwise.
                trace = self._tracer.join(frame.headers)
                if trace is None:
                    trace = self._tracer.trace(f"rpc.{frame.method}")
                try:
                    with trace.span(f"rpc.server.{frame.method}") as span:
                        span.tag("peer", peer)
                        result = handler.fn(ctx, frame.body)
                finally:
                    # the server owns its side's retention decision: an
                    # error HERE retains these spans even when the caller
                    # drops its own (tail sampling is per-side)
                    trace.end()
            else:
                result = handler.fn(ctx, frame.body)
            attachment = b""
            if isinstance(result, tuple):
                result, attachment = result
            payload = wire.encode(wire.response_frame(
                frame.request_id, result, attachment,
                headers=self._piggyback_headers()))
            with send_lock:
                sock.sendall(payload)
        except Exception as e:     # noqa: BLE001 — every fault must answer
            code = "internal"
            for exc_type, exc_code in _ERROR_CODES:
                if isinstance(e, exc_type):
                    code = exc_code
                    break
            if code == "internal":
                logger.exception("rpc %s: %s failed", peer, frame.method)
            try:
                payload = wire.encode(wire.response_frame(
                    frame.request_id,
                    {"error": code, "message": str(e)}, error=True,
                    headers=self._piggyback_headers()))
                with send_lock:
                    sock.sendall(payload)
            except OSError:
                pass
