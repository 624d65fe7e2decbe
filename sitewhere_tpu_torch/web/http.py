"""Minimal HTTP server core for the REST gateway: router + JSON + auth.

Reference: ``service-web-rest`` runs Spring MVC controllers behind a JWT
filter (``web/security/jwt/TokenAuthenticationFilter.java``) issuing
tokens via ``web/auth/controllers/JwtService.java:75``.  Stdlib-only here
(no Spring/FastAPI in the image): a ``ThreadingHTTPServer`` with a
pattern router (``/api/devices/{token}``), JSON marshaling of service
dataclasses, and ServiceError → HTTP status mapping from
:mod:`sitewhere_tpu_torch.services.common`.

Counterpart of ``sitewhere_tpu/web/http.py``, whole, with one addition:
:func:`jsonable` refuses a torch tensor.  The services marshal host
values at their boundary; a card tensor reaching the gateway would sync
the card once per scalar, and one with dimensions would fail inside
``json.dumps``.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import logging
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

import torch

from sitewhere_tpu_torch.services.common import AuthError, ServiceError

logger = logging.getLogger("sitewhere_tpu_torch.web")


def jsonable(obj):
    """Marshal service-layer objects to JSON-ready structures."""
    if isinstance(obj, torch.Tensor):
        raise TypeError(
            f"a tensor ({tuple(obj.shape)} on {obj.device}) reached the "
            "REST boundary; the service must return host values")
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {k: jsonable(v) for k, v in dataclasses.asdict(obj).items()}
    if isinstance(obj, enum.Enum):
        return obj.value
    if isinstance(obj, dict):
        return {str(k): jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [jsonable(v) for v in obj]
    if isinstance(obj, bytes):
        return obj.hex()
    if hasattr(obj, "item") and callable(obj.item) and getattr(obj, "ndim", None) == 0:
        return obj.item()  # numpy scalars
    return obj


def page_response(results) -> dict:
    """Marshal SearchResults the way the reference pages do
    (``numResults`` + ``results``)."""
    return {"numResults": results.total, "results": jsonable(results.results)}


@dataclasses.dataclass
class Request:
    method: str
    path: str
    params: Dict[str, str]          # path template captures
    query: Dict[str, List[str]]
    headers: Dict[str, str]
    body: bytes
    claims: Optional[Dict[str, object]] = None  # JWT claims when authed

    def json(self) -> dict:
        if not self.body:
            return {}
        try:
            doc = json.loads(self.body)
        except ValueError as e:
            raise ServiceError(f"invalid JSON body: {e}")
        if not isinstance(doc, dict):
            raise ServiceError("JSON body must be an object")
        return doc

    def q1(self, name: str, default: Optional[str] = None) -> Optional[str]:
        values = self.query.get(name)
        return values[0] if values else default

    def criteria(self):
        from sitewhere_tpu_torch.services.common import SearchCriteria

        def _int(name, default):
            raw = self.q1(name)
            try:
                return int(raw) if raw is not None else default
            except ValueError:
                return default

        return SearchCriteria(
            page=_int("page", 1),
            page_size=_int("pageSize", 100),
            start_s=_int("startDate", None),
            end_s=_int("endDate", None),
        )


Handler = Callable[[Request], object]
_CAPTURE = re.compile(r"\{(\w+)\}")


class Router:
    """Pattern router: ``GET /api/devices/{token}`` → handler(req)."""

    def __init__(self):
        self._routes: List[Tuple[str, re.Pattern, Handler, bool, Optional[str]]] = []
        # (method, pattern, auth_required, authority, summary) — the
        # self-describing surface behind /api/openapi.json (the
        # reference's Swagger listing, SURVEY.md §2.3 service-web-rest)
        self.descriptors: List[Tuple[str, str, bool, Optional[str], str]] = []

    def add(self, method: str, pattern: str, handler: Handler,
            auth_required: bool = True,
            authority: Optional[str] = None) -> None:
        """``authority`` additionally requires that granted authority in
        the caller's JWT claims (403 otherwise) — e.g. script upload is
        arbitrary code execution and demands ROLE_ADMIN."""
        # literal segments are escaped so metachars in paths (e.g. the
        # '.' in /api/openapi.json) match only themselves
        parts = _CAPTURE.split(pattern)
        regex = re.compile(
            "^" + "".join(
                f"(?P<{part}>[^/]+)" if i % 2 else re.escape(part)
                for i, part in enumerate(parts)
            ) + "$"
        )
        self._routes.append(
            (method.upper(), regex, handler, auth_required, authority))
        summary = (handler.__doc__ or "").strip().split("\n")[0]
        self.descriptors.append(
            (method.upper(), pattern, auth_required, authority, summary))

    def route(self, method: str, path: str):
        """Returns (handler, params, auth_required, authority)."""
        path_exists = False
        for m, regex, handler, auth, authority in self._routes:
            match = regex.match(path)
            if match:
                path_exists = True
                if m == method.upper():
                    return handler, match.groupdict(), auth, authority
        if path_exists:
            raise MethodNotAllowed(method)
        raise KeyError(path)


class MethodNotAllowed(Exception):
    pass


def openapi_spec(router: Router, title: str, version: str = "3.0.0") -> dict:
    """OpenAPI 3 document generated from the live route table.

    Reference: service-web-rest ships Swagger so every controller is
    self-describing (SURVEY.md §2.3).  Here the router IS the single
    source of truth — paths, methods, path parameters, and the JWT
    security requirement come straight from what was registered, so the
    document can never drift from the actual surface."""
    paths: Dict[str, dict] = {}
    for method, pattern, auth_required, authority, summary in router.descriptors:
        op: Dict[str, object] = {
            "summary": summary or f"{method} {pattern}",
            "responses": {"200": {"description": "OK"},
                          "400": {"description": "Validation error"},
                          "404": {"description": "Not found"}},
        }
        params = _CAPTURE.findall(pattern)
        if params:
            op["parameters"] = [
                {"name": p, "in": "path", "required": True,
                 "schema": {"type": "string"}} for p in params
            ]
        if auth_required:
            op["security"] = [{"bearerAuth": []}]
            op["responses"]["401"] = {"description": "Unauthorized"}
        if authority:
            op["x-required-authority"] = authority
            op["responses"]["403"] = {"description": "Forbidden"}
        paths.setdefault(pattern, {})[method.lower()] = op
    return {
        "openapi": "3.0.3",
        "info": {"title": title, "version": version},
        "components": {"securitySchemes": {
            "bearerAuth": {"type": "http", "scheme": "bearer",
                           "bearerFormat": "JWT"}}},
        "paths": paths,
    }


class RestGateway:
    """The HTTP server shell.  Controllers register routes; the JWT filter
    guards everything except routes registered with ``auth_required=False``
    (the reference exempts only the auth endpoint)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 token_management=None):
        self.router = Router()
        self.tokens = token_management
        self._ws_routes: Dict[str, Tuple[Callable, bool]] = {}
        gateway = self

        class _Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # route through logging
                logger.debug("%s %s", self.address_string(), fmt % args)

            def _dispatch(self, method: str) -> None:
                try:
                    gateway._handle(self, method)
                except BrokenPipeError:
                    pass
                except Exception:
                    logger.exception("unhandled gateway error")
                    try:
                        gateway._send(self, 500, {"error": "internal error"})
                    except Exception:
                        pass

            def do_GET(self):  # noqa: N802
                self._dispatch("GET")

            def do_POST(self):  # noqa: N802
                self._dispatch("POST")

            def do_PUT(self):  # noqa: N802
                self._dispatch("PUT")

            def do_DELETE(self):  # noqa: N802
                self._dispatch("DELETE")

        self._server = ThreadingHTTPServer((host, port), _Handler)
        self._server.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    # -- ws ------------------------------------------------------------------

    def add_ws(self, path: str, handler: Callable,
               auth_required: bool = True) -> None:
        """Register a WebSocket endpoint: ``handler(websock)`` runs on the
        connection thread after the RFC6455 handshake.  The JWT filter
        guards the upgrade request like any REST route (the reference's
        STOMP topology feed is authenticated) unless ``auth_required=False``;
        browsers can't set headers on WS connects, so a ``token`` query
        param is accepted alongside the Authorization header."""
        self._ws_routes[path] = (handler, auth_required)

    # -- request plumbing ----------------------------------------------------

    def _handle(self, h: BaseHTTPRequestHandler, method: str) -> None:
        parsed = urlparse(h.path)
        path = parsed.path

        if method == "GET" and path in self._ws_routes \
                and "upgrade" in h.headers.get("Connection", "").lower():
            ws_handler, ws_auth = self._ws_routes[path]
            if ws_auth:
                # Authenticate BEFORE the handshake: an unauthenticated
                # client must get 401, not a live socket.
                query = parse_qs(parsed.query)
                headers = {k: v for k, v in h.headers.items()}
                # ?token= exists for browser WebSocket clients that cannot
                # set headers.  SECURITY: bearer tokens in URLs can leak
                # into access logs and proxies — if access logging is ever
                # added, redact the query string; prefer the Authorization
                # header (or short-lived one-time tickets) elsewhere.
                token_q = query.get("token", [None])[0]
                if token_q and not headers.get("Authorization"):
                    headers["Authorization"] = f"Bearer {token_q}"
                probe = Request(method=method, path=path, params={},
                                query=query, headers=headers, body=b"")
                try:
                    self._authenticate(probe)
                except ServiceError as e:
                    self._send(h, e.http_status, {"error": str(e)})
                    return
            from sitewhere_tpu_torch.web.ws import ServerWebSocket

            sock = ServerWebSocket.handshake(h)
            if sock is not None:
                ws_handler(sock)
            return

        try:
            handler, params, auth_required, authority = self.router.route(
                method, path)
        except MethodNotAllowed:
            self._send(h, 405, {"error": f"method {method} not allowed"})
            return
        except KeyError:
            self._send(h, 404, {"error": f"no route {path}"})
            return

        length = int(h.headers.get("Content-Length") or 0)
        body = h.rfile.read(length) if length else b""
        req = Request(
            method=method,
            path=path,
            params=params,
            query=parse_qs(parsed.query),
            headers={k: v for k, v in h.headers.items()},
            body=body,
        )

        try:
            if auth_required:
                req.claims = self._authenticate(req)
                if authority is not None:
                    from sitewhere_tpu_torch.security.jwt import (
                        GRANTED_AUTHORITIES_CLAIM,
                    )
                    from sitewhere_tpu_torch.services.common import ForbiddenError

                    granted = req.claims.get(GRANTED_AUTHORITIES_CLAIM, [])
                    if authority not in granted:
                        raise ForbiddenError(
                            f"requires authority {authority}")
            result = handler(req)
        except ServiceError as e:
            self._send(h, e.http_status, {"error": str(e)})
            return
        except MethodNotAllowed:
            self._send(h, 405, {"error": "method not allowed"})
            return
        except Exception as e:
            # an admission refusal escaping a write-side handler (e.g.
            # a command invocation during EMERGENCY) is backpressure,
            # not a server bug: 503, never an opaque 500
            from sitewhere_tpu_torch.runtime.overload import OverloadShed

            if isinstance(e, OverloadShed):
                self._send(h, 503, {"error": str(e),
                                    "retryAfterSeconds": e.retry_after_s})
                return
            raise

        if isinstance(result, RawResponse):
            self._send_raw(h, result)
        else:
            self._send(h, 200, result if result is not None else {"ok": True})

    def _authenticate(self, req: Request) -> Dict[str, object]:
        if self.tokens is None:
            return {}
        header = req.headers.get("Authorization", "")
        if not header.startswith("Bearer "):
            raise AuthError("missing bearer token")
        try:
            return self.tokens.claims(header[len("Bearer "):])
        except Exception as e:
            raise AuthError(f"invalid token: {e}") from e

    def _send(self, h: BaseHTTPRequestHandler, status: int, payload) -> None:
        data = json.dumps(jsonable(payload)).encode()
        h.send_response(status)
        h.send_header("Content-Type", "application/json")
        h.send_header("Content-Length", str(len(data)))
        h.end_headers()
        h.wfile.write(data)

    def _send_raw(self, h: BaseHTTPRequestHandler, resp: "RawResponse") -> None:
        h.send_response(resp.status)
        h.send_header("Content-Type", resp.content_type)
        h.send_header("Content-Length", str(len(resp.body)))
        h.end_headers()
        h.wfile.write(resp.body)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="rest-gateway", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._server.shutdown()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        self._server.server_close()


@dataclasses.dataclass
class RawResponse:
    """Non-JSON response (label PNGs, stream downloads)."""

    body: bytes
    content_type: str = "application/octet-stream"
    status: int = 200
