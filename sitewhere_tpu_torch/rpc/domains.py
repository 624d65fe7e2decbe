"""Per-domain remote facades over the RPC fabric.

Counterpart of ``sitewhere_tpu/rpc/domains.py``: the same code over the
port's modules (no JAX anywhere on this path).

Reference: the client fabric exposes EVERY management domain remotely —
per-domain ApiChannel/ApiDemux/converters for asset/batch/device/
devicestate/event/label/schedule/tenant/user
(``sitewhere-grpc-client/.../ApiDemux.java:42-110`` + the ten per-domain
packages) — so the web-rest gateway can run on a host that owns none of
the stores.  Round 3 remoted only device-management/search/topology/
commands; this module completes the surface: a declarative per-domain
method table is bound onto the RpcServer (reusing its JWT/authority
machinery), and :class:`RemoteDomain` is the duck-typed client facade a
gateway instance swaps in for the local service object.

Marshalling: entities cross as ``jsonable`` dicts (the same wire shape
the REST layer emits), re-wrapped client-side in :class:`DotDict` so
attribute-style consumers (``user.username``) keep working;
``SearchResults`` pages cross as ``numResults``/``results`` and come
back as real ``SearchResults`` so ``page_response`` composes.  A
leading :class:`SearchCriteria` argument is carried structurally.
``EntityNotFound`` round-trips (server maps it to the ``not_found``
error frame; the facade re-raises it) so REST 404s survive remoting.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from sitewhere_tpu_torch.rpc.channel import RpcDemux, RpcError
from sitewhere_tpu_torch.services.common import (
    AuthError,
    DuplicateToken,
    EntityNotFound,
    ForbiddenError,
    InvalidReference,
    SearchCriteria,
    SearchResults,
    ValidationError,
)

# Typed error frames re-raise as the service exception the REST error
# mapper already understands — remoting must not change status codes.
_RAISE_BY_CODE = {
    "not_found": EntityNotFound,
    "validation": ValidationError,
    "duplicate": DuplicateToken,
    "invalid_reference": InvalidReference,
    "unauthorized": AuthError,
    "forbidden": ForbiddenError,
}
from sitewhere_tpu_torch.web.http import jsonable

_A = "ROLE_ADMIN"

# domain -> (Instance attribute, {method: required authority or None}).
# The surface is what the REST gateway and pipeline services actually
# call — the cross-host subset, mirroring the reference's per-domain
# gRPC services (SURVEY.md §2.3), not every SPI method.
DOMAIN_SURFACE: Dict[str, tuple] = {
    "assets": ("assets", {
        "create_asset_type": _A, "get_asset_type": None,
        "update_asset_type": _A, "list_asset_types": None,
        "delete_asset_type": _A,
        "create_asset": _A, "get_asset": None, "update_asset": _A,
        "list_assets": None, "delete_asset": _A,
    }),
    "schedules": ("schedules", {
        "create_schedule": _A, "get_schedule": None, "list_schedules": None,
        "delete_schedule": _A,
        "create_job": _A, "get_job": None, "list_jobs": None,
        "delete_job": _A, "fire": _A,
    }),
    "batch": ("batch_ops", {
        "create_batch_command_invocation": _A, "get_operation": None,
        "list_operations": None, "list_elements": None, "process_now": _A,
    }),
    "users": ("users", {
        "create_user": _A, "get_user": None, "update_user": _A,
        "delete_user": _A, "list_users": None, "authenticate": None,
        "create_granted_authority": _A, "get_granted_authority": None,
        "list_granted_authorities": None, "authorities_for": None,
    }),
    "tenants": ("tenants", {
        "create_tenant": _A, "get_tenant": None, "update_tenant": _A,
        "delete_tenant": _A, "list_tenants": None, "authorized_for": None,
        "list_tenant_templates": None, "list_dataset_templates": None,
    }),
    # Token-form methods only: dense device ids are meaningful solely
    # inside their minting host's identity map and must not cross hosts.
    "devicestate": ("device_state", {
        "get_device_state": None, "missing_device_tokens": None,
        "seen_since_tokens": None, "summary": None,
    }),
}

# Credential material must never cross a marshalling boundary — neither
# REST nor the fabric (the reference's REST marshalers drop it too).
_SCRUB_KEYS = frozenset({"hashed_password"})


def scrub(doc):
    """Drop credential fields from a marshalled entity (recursive)."""
    if isinstance(doc, dict):
        return {k: scrub(v) for k, v in doc.items() if k not in _SCRUB_KEYS}
    if isinstance(doc, list):
        return [scrub(v) for v in doc]
    return doc


def bind_domains(server, inst) -> None:
    """Register every DOMAIN_SURFACE method as ``{domain}.{method}``."""
    for domain, (attr, methods) in DOMAIN_SURFACE.items():
        svc = getattr(inst, attr, None)
        if svc is None:
            continue
        for method, authority in methods.items():
            server.register(
                f"{domain}.{method}",
                _make_handler(svc, method),
                authority=authority,
            )


def _make_handler(svc, method):
    import inspect

    fn = getattr(svc, method)
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        sig = None

    def handler(ctx, body):
        body = body or {}
        args = list(body.get("args") or [])
        kwargs = dict(body.get("kwargs") or {})
        if body.get("_criteria") is not None:
            args.insert(0, SearchCriteria(**body["_criteria"]))
        if sig is not None:
            # Bad remote ARGUMENTS answer a typed validation frame; a
            # TypeError raised inside the service stays an internal
            # fault (logged server-side) — binding first separates them.
            try:
                sig.bind(*args, **kwargs)
            except TypeError as e:
                raise ValidationError(str(e)) from e
        out = fn(*args, **kwargs)
        if isinstance(out, SearchResults):
            return {"_page": {"numResults": out.total,
                              "results": scrub(jsonable(out.results))}}
        return {"_value": scrub(jsonable(out))}

    return handler


class DotDict(dict):
    """A dict whose keys read as attributes (marshalled entities keep
    working for attribute-style consumers like ``user.username``)."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None


def _revive(value):
    if isinstance(value, dict):
        return DotDict({k: _revive(v) for k, v in value.items()})
    if isinstance(value, list):
        return [_revive(v) for v in value]
    return value


class RemoteDomain:
    """Client facade for one domain: ``facade.method(...)`` becomes an
    RPC to the owning host, with criteria/page/entity marshalling and
    ``EntityNotFound`` re-raised for REST 404 parity."""

    # Consumed by e.g. the checkpointer: a facade holds no store to
    # snapshot/restore — the owning host does that.
    _remote_facade_ = True

    def __init__(self, demux: RpcDemux, domain: str,
                 methods: Optional[frozenset] = None):
        self._demux = demux
        self._domain = domain
        self._methods = frozenset(
            methods if methods is not None
            else DOMAIN_SURFACE[domain][1].keys())

    def __getattr__(self, name: str):
        if name.startswith("_") or name not in self._methods:
            raise AttributeError(f"{self._domain}.{name} is not remoted")

        def call(*args, **kwargs):
            body: dict = {}
            args_l = list(args)
            if args_l and isinstance(args_l[0], SearchCriteria):
                body["_criteria"] = dataclasses.asdict(args_l.pop(0))
            elif args_l and args_l[0] is None and name.startswith("list_"):
                args_l.pop(0)  # list_x(None) — the default-criteria idiom
            if args_l:
                body["args"] = jsonable(args_l)
            if kwargs:
                body["kwargs"] = jsonable(kwargs)
            try:
                resp, _ = self._demux.call(f"{self._domain}.{name}", body)
            except RpcError as e:
                exc = _RAISE_BY_CODE.get(e.error)
                if exc is not None:
                    raise exc(e.message) from None
                raise
            if "_page" in resp:
                page = resp["_page"]
                return SearchResults(
                    results=_revive(page.get("results") or []),
                    total=int(page.get("numResults", 0)))
            return _revive(resp.get("_value"))

        return call


def remote_domains(demux: RpcDemux) -> Dict[str, RemoteDomain]:
    """Facades for every domain in DOMAIN_SURFACE, keyed by domain."""
    return {d: RemoteDomain(demux, d) for d in DOMAIN_SURFACE}


def attach_remote_domains(inst, demux: RpcDemux,
                          domains: Optional[list] = None) -> None:
    """Turn ``inst`` into a gateway for the given domains: its service
    attributes are swapped for remote facades over ``demux``, so every
    REST route (late-bound ``inst.<attr>``) transparently serves against
    the owning host's stores.  Reference: web-rest consuming every
    domain through ApiDemux channels instead of local persistence."""
    for domain in domains or list(DOMAIN_SURFACE):
        attr, _ = DOMAIN_SURFACE[domain]
        setattr(inst, attr, RemoteDomain(demux, domain))
