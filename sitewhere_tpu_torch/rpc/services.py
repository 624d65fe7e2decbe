"""Domain services over the RPC fabric + cached remote facades.

Counterpart of ``sitewhere_tpu/rpc/services.py``: the same code over the
port's modules (no JAX anywhere on this path).

Reference: each domain microservice exposes its L0 SPI over gRPC
(``DeviceManagementImpl.java``, ``EventManagementImpl.java:109-584``) and
clients consume it through per-domain ApiChannels, with device/assignment
lookups near-cached (``CachedDeviceManagementApiChannel.java`` +
``cache/CacheProvider.java``).  Here :func:`bind_instance` publishes the
instance's already-composed services over one :class:`~.server.RpcServer`
(in-process composition made cross-host reachable at the boundary), and
:class:`RemoteDeviceManagement` is the near-cached client facade.

The event intake method ``events.ingest`` carries the columnar NDJSON
wire payload in the binary attachment lane and lands directly on
``PipelineDispatcher.ingest_wire_lines`` — so a forwarded cross-host
batch takes the exact same journaled, columnar path as local wire
traffic (Kafka's "the pipeline bus IS the intake" property).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Tuple

from sitewhere_tpu_torch.rpc.channel import RpcDemux, RpcError
from sitewhere_tpu_torch.rpc.server import CallContext, RpcServer
from sitewhere_tpu_torch.services.common import EntityNotFound, SearchCriteria
from sitewhere_tpu_torch.web.http import jsonable, page_response


def _criteria(body: dict) -> SearchCriteria:
    return SearchCriteria(
        page=int(body.get("page", 1)),
        page_size=int(body.get("pageSize", 100)),
        start_s=body.get("start"),
        end_s=body.get("end"),
    )


def bind_instance(server: RpcServer, inst) -> None:
    """Register the instance's domain surface on ``server``.

    Method names mirror the reference's per-domain gRPC services
    (SURVEY.md §2.3); the surface is the cross-host subset — what the
    reference's web-rest and pipeline services actually call over the
    fabric, not every SPI method (in-process callers keep the direct
    Python SPI).
    """
    dm = inst.device_management

    def reg(method, fn, authority=None, auth_required=True):
        server.register(method, fn, authority=authority,
                        auth_required=auth_required)

    # ---- device management (DeviceManagementImpl analog) -------------------
    reg("device.get", lambda c, b: jsonable(dm.get_device(b["token"])))
    reg("device.create", lambda c, b: jsonable(dm.create_device(**b)),
        authority="ROLE_ADMIN")
    reg("device.update",
        lambda c, b: jsonable(dm.update_device(b.pop("token"), **b)),
        authority="ROLE_ADMIN")
    reg("device.delete", lambda c, b: jsonable(dm.delete_device(b["token"])),
        authority="ROLE_ADMIN")
    reg("device.list",
        lambda c, b: page_response(dm.list_devices(_criteria(b))))
    reg("assignment.get",
        lambda c, b: jsonable(dm.get_device_assignment(b["token"])))
    reg("assignment.active",
        lambda c, b: jsonable(_active_assignment(dm, b["deviceToken"])))
    reg("assignment.create",
        lambda c, b: jsonable(dm.create_device_assignment(**b)),
        authority="ROLE_ADMIN")
    reg("devicetype.get",
        lambda c, b: jsonable(dm.get_device_type(b["token"])))
    reg("devicetype.create",
        lambda c, b: jsonable(dm.create_device_type(**b)),
        authority="ROLE_ADMIN")

    # ---- events (EventManagementImpl + intake boundary) --------------------
    def events_ingest(ctx: CallContext, body):
        if not ctx.attachment:
            return {"accepted": 0}
        n = inst.dispatcher.ingest_wire_lines(
            ctx.attachment,
            source_id=(body or {}).get("sourceId", f"rpc:{ctx.peer}"))
        # replicated-ack: the SENDER commits its spool cursor (and later
        # prunes the spool) on this reply, so the ack must mean durably
        # journaled — fsync before answering, or a kill of both hosts
        # in the ack window loses the batch from both sides
        # (crashrec_bench crash.mid_forward pins this)
        inst.ingest_journal.flush()
        return {"accepted": int(n)}

    reg("events.ingest", events_ingest)

    def events_query(ctx: CallContext, body):
        # Unknown tokens return an EMPTY page, not an error: in a
        # sharded topology most hosts don't know most tokens, and a
        # federated fan-out must be able to tell "not here" (normal)
        # from a peer actually failing.
        body = body or {}
        kwargs = {}
        token = body.get("deviceToken")
        if token is not None:
            dense = inst.identity.device.lookup(token)
            if dense < 0:
                return {"numResults": 0, "results": []}
            kwargs["device_id"] = int(dense)
        token = body.get("assignmentToken")
        if token is not None:
            handle = dm.handle_for("assignment", token)
            if handle < 0:
                return {"numResults": 0, "results": []}
            kwargs["assignment_id"] = int(handle)
        if body.get("eventType") is not None:
            kwargs["event_type"] = int(body["eventType"])
        inst.event_store.flush()
        results = inst.event_store.query(_criteria(body), **kwargs)
        return page_response(results)

    reg("events.query", events_query)

    # ---- state / topology (DeviceStateImpl + TopologyStateAggregator) ------
    reg("state.get", lambda c, b: jsonable(
        inst.device_state.get_device_state(b["deviceToken"])))

    # ---- command delivery (federated invocation; SURVEY.md §3.4) ----------
    # Deliberately create_command_invocation, NOT invoke_command: the
    # owner must answer not_found for an assignment it doesn't hold, or
    # two peers would ping-pong an unknown token forever.  The caller's
    # initiator rides through so audit data doesn't depend on placement.
    reg("command.invoke", lambda c, b: inst.create_command_invocation(
        b["assignmentToken"],
        command_token=str(b["commandToken"]),
        parameter_values=dict(b.get("parameterValues") or {}),
        initiator=str(b.get("initiator") or "RPC"),
        initiator_id=b.get("initiatorId"),
        ts_s=b.get("ts")))
    reg("instance.topology", lambda c, b: inst.topology())
    reg("instance.ping", lambda c, b: {"instance": inst.instance_id,
                                       "ts": time.time()},
        auth_required=False)

    # ---- fleet health plane (rpc/health.py) --------------------------------
    def fleet_heartbeat(ctx: CallContext, body):
        """One heartbeat exchange teaches both directions: the request
        body is the SENDER's health record (fed into our table), the
        response body is OURS — overload state, Retry-After hint,
        pending spool lag toward the sender, incarnation."""
        body = body if isinstance(body, dict) else {}
        fwd = inst.forwarder
        try:
            sender = int(body.get("processId"))
        except (TypeError, ValueError):
            # malformed beats are ignored, never an 'internal' error —
            # a buggy/fuzzing peer must not flood logs at beat rate
            sender = None
        if fwd is not None and sender is not None:
            fwd.observe_peer_heartbeat(sender, body)
        if fwd is not None:
            return fwd.heartbeat_body(sender if sender is not None else -1)
        ov = inst.overload
        return {
            "processId": -1, "incarnation": 0,
            "state": int(ov.state) if ov is not None else 0,
            "retryAfterS": (round(float(ov.retry_after()), 3)
                            if ov is not None else 0.0),
            "spoolLag": 0,
        }

    reg("fleet.heartbeat", fleet_heartbeat)

    # ---- the remaining management domains (per-domain ApiDemux analog) -----
    from sitewhere_tpu_torch.rpc.domains import bind_domains

    bind_domains(server, inst)

    # ---- ownership migration (membership-change handoff target) -----------
    from sitewhere_tpu_torch.rpc.migration import bind_migration

    bind_migration(server, inst)


def _active_assignment(dm, device_token: str):
    assignment = dm.get_active_assignment(device_token)
    if assignment is None:
        raise EntityNotFound(f"no active assignment for {device_token}")
    return assignment


class _CacheEntry:
    __slots__ = ("value", "expires_at")

    def __init__(self, value, expires_at: float):
        self.value = value
        self.expires_at = expires_at


class RemoteDeviceManagement:
    """Near-cached device-management client facade.

    Reference: ``CachedDeviceManagementApiChannel.java`` wraps the gRPC
    channel with TTL near-caches for device and assignment lookups so the
    inbound hot path (``InboundPayloadProcessingLogic.java:285-288``)
    pays a network hop only on cold tokens.  Mutations through this
    facade invalidate their own token's entry; remote writers are covered
    by the TTL, as in the reference.
    """

    def __init__(self, demux: RpcDemux, cache_ttl_s: float = 30.0,
                 max_entries: int = 10000):
        self._demux = demux
        self._ttl = cache_ttl_s
        self._max = max_entries
        self._cache: Dict[Tuple[str, str], _CacheEntry] = {}
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    # -- cache plumbing ------------------------------------------------------

    def _get_cached(self, kind: str, token: str):
        key = (kind, token)
        with self._lock:
            entry = self._cache.get(key)
            if entry is not None and entry.expires_at > time.monotonic():
                self.hits += 1
                return entry.value
            if entry is not None:
                del self._cache[key]
            self.misses += 1
        return None

    def _put(self, kind: str, token: str, value) -> None:
        with self._lock:
            if len(self._cache) >= self._max:
                # drop the stalest ~10% (bounded cache, no LRU bookkeeping
                # on the hot path — the reference cache is size-capped too)
                for key in sorted(self._cache,
                                  key=lambda k: self._cache[k].expires_at)[
                                      : max(1, self._max // 10)]:
                    del self._cache[key]
            self._cache[(kind, token)] = _CacheEntry(
                value, time.monotonic() + self._ttl)

    def _invalidate(self, kind: str, token: str) -> None:
        with self._lock:
            self._cache.pop((kind, token), None)

    # -- lookups (cached) ----------------------------------------------------

    def get_device(self, token: str) -> dict:
        cached = self._get_cached("device", token)
        if cached is not None:
            return cached
        body, _ = self._demux.call("device.get", {"token": token})
        self._put("device", token, body)
        return body

    def get_active_assignment(self, token: str) -> dict:
        cached = self._get_cached("assignment", token)
        if cached is not None:
            return cached
        body, _ = self._demux.call("assignment.active",
                                   {"deviceToken": token})
        self._put("assignment", token, body)
        return body

    # -- mutations (write-through invalidation) ------------------------------

    def create_device(self, **fields) -> dict:
        body, _ = self._demux.call("device.create", fields)
        return body

    def update_device(self, token: str, **fields) -> dict:
        body, _ = self._demux.call("device.update",
                                   {"token": token, **fields})
        self._invalidate("device", token)
        self._invalidate("assignment", token)
        return body

    def delete_device(self, token: str) -> dict:
        body, _ = self._demux.call("device.delete", {"token": token})
        self._invalidate("device", token)
        self._invalidate("assignment", token)
        return body
