"""Client side of the RPC fabric: channels + replica demux.

Counterpart of ``sitewhere_tpu/rpc/channel.py``: the same code over the
port's modules (no JAX anywhere on this path).

Reference: ``ApiDemux.java:42-110`` keeps one ``ApiChannel`` per
discovered replica hostname, routes calls round-robin
(``RoundRobinDemuxRoutingStrategy.java``), re-resolves topology every 5s,
and ``waitForApiChannel`` backs off 100ms→60s until a replica is
reachable.  ``MultitenantGrpcChannel`` stamps JWT + tenant tokens onto
every call (``JwtClientInterceptor.java``,
``TenantTokenClientInterceptor.java:53-57``).

This module keeps those *semantics* — per-replica channels, round-robin
with failover, exponential reconnect backoff, header stamping — over the
plain framed-TCP wire (`wire.py`) instead of gRPC/HTTP2.  One channel
multiplexes concurrent calls by request id (a reader thread correlates
responses), so callers never queue behind each other's round trips.
"""

from __future__ import annotations

import itertools
import logging
import socket
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from sitewhere_tpu_torch.rpc import wire
from sitewhere_tpu_torch.runtime import faults
from sitewhere_tpu_torch.runtime.metrics import global_registry
from sitewhere_tpu_torch.runtime.resilience import Backoff, RetryPolicy
from sitewhere_tpu_torch.runtime.tracing import _NOOP_TRACE

logger = logging.getLogger("sitewhere_tpu_torch.rpc")

BACKOFF_INITIAL_S = 0.1
BACKOFF_MAX_S = 60.0   # ApiDemux.java:47-52

# The reconnect schedule every channel follows (100ms → 60s, ApiDemux
# semantics).  No jitter: replica reconnects are per-endpoint, not a
# thundering herd, and deterministic schedules keep the tests exact.
RECONNECT_POLICY = RetryPolicy(
    initial_s=BACKOFF_INITIAL_S, max_s=BACKOFF_MAX_S, factor=2.0)


class RpcError(Exception):
    """Server-side failure surfaced to the caller.

    ``headers`` carries the error response's metadata lane (notably the
    overload piggyback ``x-overload``/``x-retry-after``) so callers can
    learn the peer's pressure even from a refusal."""

    def __init__(self, error: str, message: str,
                 headers: Optional[Dict[str, str]] = None):
        super().__init__(f"{error}: {message}")
        self.error = error
        self.message = message
        self.headers = headers or {}


class DeadlineExpired(RpcError):
    """The call's propagated deadline lapsed — client-side before the
    send, or server-side before the handler ran (no work was executed).

    RETRYABLE and deliberately distinct from :class:`ChannelUnavailable`:
    the peer is healthy, the *budget* died (usually behind a slow
    fabric).  Callers retry with a fresh budget; failure detectors must
    NOT count it as peer death."""

    def __init__(self, message: str,
                 headers: Optional[Dict[str, str]] = None):
        super().__init__("deadline_expired", message, headers)


# error code the server answers for pre-dispatch deadline rejections;
# the client re-raises it as DeadlineExpired (kept in one place so the
# two sides cannot drift)
DEADLINE_ERROR_CODE = "deadline_expired"
HEADER_DEADLINE = "deadline-ms"     # absolute unix epoch milliseconds


def deadline_header(budget_s: float) -> str:
    """Absolute-epoch encoding of a remaining budget.  Wall clock, not
    monotonic: the value must be comparable on the RECEIVING host."""
    return str(int((time.time() + budget_s) * 1000.0))


def deadline_remaining_s(headers: Dict[str, str]) -> Optional[float]:
    """Remaining budget encoded in ``headers`` (negative = expired);
    None when the call carries no deadline."""
    raw = headers.get(HEADER_DEADLINE)
    if raw is None:
        return None
    try:
        return int(raw) / 1000.0 - time.time()
    except (TypeError, ValueError):
        return None


class ChannelUnavailable(Exception):
    """No connection could be established / the connection died mid-call."""


class _Pending:
    __slots__ = ("event", "frame", "sock")

    def __init__(self, sock=None):
        self.event = threading.Event()
        self.frame: Optional[wire.Frame] = None
        self.sock = sock   # the connection this call went out on


class RpcChannel:
    """One connection to one replica, multiplexing concurrent calls.

    ``token_provider`` supplies the JWT stamped into the
    ``authorization`` header per call (the ``JwtClientInterceptor``
    analog — a provider, not a fixed string, so token refresh needs no
    channel restart); ``tenant`` rides the ``tenant`` header
    (``TenantTokenClientInterceptor`` analog).
    """

    def __init__(self, endpoint: str,
                 token_provider: Optional[Callable[[], str]] = None,
                 tenant: Optional[str] = None,
                 connect_timeout_s: float = 5.0,
                 header_listener: Optional[
                     Callable[[Dict[str, str]], None]] = None):
        self.endpoint = endpoint
        self._addr = wire.parse_endpoint(endpoint)
        self._token_provider = token_provider
        self._tenant = tenant
        self._connect_timeout_s = connect_timeout_s
        # response-header tap: the health table's piggyback intake (a
        # listener crash must never fail the call it rode on)
        self.header_listener = header_listener
        self._sock: Optional[socket.socket] = None
        self._reader: Optional[threading.Thread] = None
        self._lock = threading.Lock()          # connection state transitions
        self._write_lock = threading.Lock()    # frame sendall only
        self._pending: Dict[int, _Pending] = {}
        self._pending_lock = threading.Lock()
        self._next_id = itertools.count(1)
        self._closed = False
        # reconnect backoff (exponential, 100ms → 60s) — the shared
        # resilience primitive; retries tick resilience.retries.rpc.connect
        self._backoff = Backoff(RECONNECT_POLICY, name="rpc.connect")

    # -- connection management ---------------------------------------------

    @property
    def connected(self) -> bool:
        return self._sock is not None

    def in_backoff(self) -> bool:
        return not self.connected and not self._backoff.due()

    def _connect_locked(self, timeout_s: Optional[float] = None) -> None:
        if self._sock is not None or self._closed:
            return
        if not self._backoff.due():
            raise ChannelUnavailable(
                f"{self.endpoint} in backoff for "
                f"{self._backoff.remaining():.1f}s")
        try:
            faults.fire("rpc.connect")
            if faults.net_drops(self.endpoint, "connect"):
                # injected partition: unreachable exactly like a refused
                # connect (backoff advances, caller fails over)
                raise OSError("injected network partition")
            sock = socket.create_connection(
                self._addr, timeout=(timeout_s if timeout_s is not None
                                     else self._connect_timeout_s))
        except OSError as e:
            self._backoff.defer()
            raise ChannelUnavailable(f"{self.endpoint}: {e}") from e
        sock.settimeout(None)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock = sock
        self._backoff.reset()
        self._reader = threading.Thread(
            target=self._read_loop, args=(sock,),
            name=f"rpc-reader-{self.endpoint}", daemon=True)
        self._reader.start()

    def ensure_connected(self) -> None:
        with self._lock:
            self._connect_locked()

    def _read_loop(self, sock: socket.socket) -> None:
        try:
            while True:
                frame = wire.read_frame(sock)
                if not frame.is_response:
                    logger.warning("%s: unexpected request frame from server",
                                   self.endpoint)
                    continue
                with self._pending_lock:
                    pending = self._pending.pop(frame.request_id, None)
                if pending is not None:
                    pending.frame = frame
                    pending.event.set()
        except (ConnectionError, OSError, wire.WireError) as e:
            self._drop(sock, e)

    def _drop(self, sock: socket.socket, exc: Exception) -> None:
        """Connection died: fail the in-flight calls THAT WENT OUT ON IT
        so their callers fail over — calls already riding a newer
        reconnected socket are untouched (they are still answerable)."""
        with self._lock:
            if self._sock is sock:
                self._sock = None
        try:
            sock.close()
        except OSError:
            pass
        with self._pending_lock:
            stranded = {rid: p for rid, p in self._pending.items()
                        if p.sock is sock}
            for rid in stranded:
                del self._pending[rid]
        for p in stranded.values():
            p.event.set()   # frame stays None → ChannelUnavailable
        if stranded and not self._closed:
            logger.info("%s: connection dropped (%s); %d calls failed over",
                        self.endpoint, exc, len(stranded))

    # -- calls ---------------------------------------------------------------

    def call(self, method: str, body: object = None,
             attachment: bytes = b"",
             headers: Optional[Dict[str, str]] = None,
             timeout_s: float = 30.0, trace=None,
             deadline_s: Optional[float] = None) -> Tuple[object, bytes]:
        """One request/reply round trip.  Returns ``(body, attachment)``.

        ``trace`` (a :class:`~sitewhere_tpu_torch.runtime.tracing.Trace`) wraps
        the round trip in an ``rpc.client.<method>`` span and stamps the
        trace context into the frame headers so the server continues the
        SAME trace — the client tracing interceptor analog.

        ``deadline_s`` is the call's remaining BUDGET in seconds: it is
        stamped into the ``deadline-ms`` header (absolute epoch ms, the
        grpc-timeout analog), the client wait timeout derives from it
        (never longer than the budget), and a server receiving it
        already expired rejects the call before executing the handler —
        no wasted work behind a slow fabric.

        Raises :class:`RpcError` for server-reported failures
        (:class:`DeadlineExpired` for a lapsed budget — retryable,
        distinct from peer-down), :class:`ChannelUnavailable` for
        transport failures (the demux catches the latter and fails
        over).
        """
        trace = trace or _NOOP_TRACE
        with trace.span(f"rpc.client.{method}") as span:
            span.tag("endpoint", self.endpoint)
            hdrs = trace.propagate(dict(headers or {}), parent=span)
            return self._call(method, body, attachment, hdrs, timeout_s,
                              deadline_s)

    def _call(self, method: str, body: object, attachment: bytes,
              hdrs: Dict[str, str], timeout_s: float,
              deadline_s: Optional[float] = None) -> Tuple[object, bytes]:
        if deadline_s is not None:
            if deadline_s <= 0:
                # budget already burned (an upstream hop ate it): fail
                # here, client-side — the wire would only spread the lapse
                raise DeadlineExpired(
                    f"{self.endpoint}: budget exhausted before {method}")
            hdrs.setdefault(HEADER_DEADLINE, deadline_header(deadline_s))
            timeout_s = min(timeout_s, deadline_s)
        if self._token_provider is not None and "authorization" not in hdrs:
            hdrs["authorization"] = self._token_provider()
        if self._tenant is not None and "tenant" not in hdrs:
            hdrs["tenant"] = self._tenant
        # injected network faults (runtime/faults.py net plane): latency
        # delays the send (consuming real deadline budget, exactly like
        # a slow fabric); a request-direction drop is a transport fault
        drop, delay = faults.net_shape(self.endpoint, "request")
        if drop:
            raise ChannelUnavailable(
                f"{self.endpoint}: injected partition on {method}")
        if delay > 0.0:
            time.sleep(delay)
        # Encode BEFORE taking any lock, and connect under the state lock
        # only (bounded by connect_timeout — itself capped by the call's
        # remaining budget, so a blackholed peer cannot overrun the
        # deadline by a 5s SYN timeout); the write lock serializes just
        # the sendall so a slow large-attachment writer never stalls
        # other callers' connect/registration — their own timeout_s
        # governs.
        with self._lock:
            self._connect_locked(
                min(self._connect_timeout_s, deadline_s)
                if deadline_s is not None else None)
            sock = self._sock
        if sock is None:
            raise ChannelUnavailable(f"{self.endpoint}: not connected")
        pending = _Pending(sock)
        request_id = next(self._next_id)
        frame_bytes = wire.encode(wire.request_frame(
            request_id, method, body, hdrs, attachment))
        with self._pending_lock:
            self._pending[request_id] = pending
        try:
            with self._write_lock:
                sock.sendall(frame_bytes)
        except OSError as e:
            with self._pending_lock:
                self._pending.pop(request_id, None)
            self._drop(sock, e)
            raise ChannelUnavailable(f"{self.endpoint}: {e}") from e
        if faults.net_drops(self.endpoint, "response"):
            # one-way partition: the request REACHED the server (it may
            # execute!) but the reply is lost — drop the pending slot so
            # the read loop discards the response and the caller times
            # out, exactly the ambiguity a real half-open link produces
            with self._pending_lock:
                self._pending.pop(request_id, None)
        if not pending.event.wait(timeout_s):
            with self._pending_lock:
                self._pending.pop(request_id, None)
            raise ChannelUnavailable(
                f"{self.endpoint}: timeout after {timeout_s}s on {method}")
        frame = pending.frame
        if frame is None:
            raise ChannelUnavailable(f"{self.endpoint}: connection lost")
        if frame.headers and self.header_listener is not None:
            try:
                self.header_listener(frame.headers)
            except Exception:   # noqa: BLE001 — a tap must not fail the call
                logger.exception("%s: response header listener failed",
                                 self.endpoint)
        if frame.is_error:
            err = frame.body if isinstance(frame.body, dict) else {}
            code = err.get("error", "internal")
            message = err.get("message", "unknown error")
            if code == DEADLINE_ERROR_CODE:
                raise DeadlineExpired(message, frame.headers)
            raise RpcError(code, message, frame.headers)
        return frame.body, frame.attachment

    def close(self) -> None:
        self._closed = True
        with self._lock:
            sock, self._sock = self._sock, None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass
        with self._pending_lock:
            stranded, self._pending = self._pending, {}
        for p in stranded.values():
            p.event.set()


class RpcDemux:
    """Round-robin demux over replica channels with failover.

    Reference semantics preserved from ``ApiDemux.java``: a channel per
    replica, round-robin routing, calls fail over to the next replica on
    transport errors, ``wait_for_channel`` blocks until any replica is
    reachable, and ``set_endpoints`` is the discovery-update hook (the
    Consul watch analog — topology is pushed in, not polled here).
    """

    def __init__(self, endpoints: List[str],
                 token_provider: Optional[Callable[[], str]] = None,
                 tenant: Optional[str] = None,
                 connect_timeout_s: float = 5.0,
                 header_listener: Optional[
                     Callable[[Dict[str, str]], None]] = None):
        self._token_provider = token_provider
        self._tenant = tenant
        self._connect_timeout_s = connect_timeout_s
        self._header_listener = header_listener
        self._lock = threading.Lock()
        self._channels: Dict[str, RpcChannel] = {}
        self._rr = 0
        self.set_endpoints(endpoints)

    def _make_channel(self, endpoint: str) -> RpcChannel:
        return RpcChannel(endpoint, token_provider=self._token_provider,
                          tenant=self._tenant,
                          connect_timeout_s=self._connect_timeout_s,
                          header_listener=self._header_listener)

    def set_header_listener(
            self, listener: Optional[Callable[[Dict[str, str]], None]],
    ) -> None:
        """Install the response-header tap on every current and future
        channel (the forwarder's health table registers its piggyback
        intake here)."""
        with self._lock:
            self._header_listener = listener
            for chan in self._channels.values():
                chan.header_listener = listener

    def set_endpoints(self, endpoints: List[str]) -> None:
        """Reconcile the channel set against a new replica list
        (add/remove, existing connections kept — ApiDemux discovery
        monitor semantics)."""
        with self._lock:
            for ep in endpoints:
                if ep not in self._channels:
                    self._channels[ep] = self._make_channel(ep)
            for ep in list(self._channels):
                if ep not in endpoints:
                    self._channels.pop(ep).close()

    @property
    def endpoints(self) -> List[str]:
        with self._lock:
            return list(self._channels)

    def _rotation(self) -> List[RpcChannel]:
        with self._lock:
            chans = list(self._channels.values())
            if not chans:
                return []
            start = self._rr % len(chans)
            self._rr += 1
        return chans[start:] + chans[:start]

    def call(self, method: str, body: object = None,
             attachment: bytes = b"",
             headers: Optional[Dict[str, str]] = None,
             timeout_s: float = 30.0, trace=None,
             deadline_s: Optional[float] = None) -> Tuple[object, bytes]:
        """Round-robin call with failover: transport failures rotate to
        the next replica; server-reported errors (RpcError) do NOT fail
        over — the reference likewise retries only channel faults, not
        application faults.  ``trace`` propagates per attempt, so a
        failed-over call shows one client span per replica tried.

        ``deadline_s`` is ONE budget for the whole rotation: each
        failover attempt gets only what the previous attempts left, so
        k dead replicas cannot multiply the caller's wait."""
        rotation = self._rotation()
        if not rotation:
            raise ChannelUnavailable("no endpoints configured")
        deadline_at = (time.monotonic() + deadline_s
                       if deadline_s is not None else None)
        last: Optional[Exception] = None
        for chan in rotation:
            if chan.in_backoff() and len(rotation) > 1:
                last = last or ChannelUnavailable(
                    f"{chan.endpoint} in backoff")
                continue
            remaining = (deadline_at - time.monotonic()
                         if deadline_at is not None else None)
            if remaining is not None and remaining <= 0:
                if isinstance(last, ChannelUnavailable):
                    # transport failures ate the budget: surface THEM —
                    # a caller's failure detector must count this
                    # toward peer death, not file it as a benign
                    # budget lapse
                    raise last
                raise DeadlineExpired(
                    f"budget exhausted during failover on {method}")
            try:
                return chan.call(method, body, attachment, headers, timeout_s,
                                 trace=trace, deadline_s=remaining)
            except ChannelUnavailable as e:
                last = e
                global_registry().counter(
                    "resilience.retries.rpc.failover").inc()
        raise last if last is not None else ChannelUnavailable("no replicas")

    def wait_for_channel(self, timeout_s: float = 60.0) -> RpcChannel:
        """Block until any replica is connectable
        (``ApiDemux.waitForApiChannel`` — backoff handled per-channel)."""
        deadline = time.monotonic() + timeout_s
        attempt = 0
        while True:
            for chan in self._rotation():
                try:
                    chan.ensure_connected()
                    return chan
                except ChannelUnavailable:
                    continue
            if time.monotonic() >= deadline:
                raise ChannelUnavailable(
                    f"no replica reachable within {timeout_s}s")
            sleep = RECONNECT_POLICY.delay(attempt)
            attempt += 1
            time.sleep(min(sleep, max(0.0, deadline - time.monotonic())))

    def close(self) -> None:
        with self._lock:
            chans = list(self._channels.values())
            self._channels.clear()
        for chan in chans:
            chan.close()
