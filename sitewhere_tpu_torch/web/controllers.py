"""REST controllers: the reference's web-rest surface over one Instance.

Reference: ``service-web-rest/src/main/java/com/sitewhere/web/rest/
controllers/`` — 25 Spring controllers (Devices, DeviceTypes, Assignments
incl. event create/list ``Assignments.java:319-576``, Areas, AreaTypes,
Customers, CustomerTypes, Zones, DeviceGroups, Assets, AssetTypes,
BatchOperations, Schedules, Tenants, Users, Instance topology, External
search…) plus JWT issuing (``web/auth/controllers/JwtService.java:75``).

Route shapes follow the reference's ``/api/...`` layout.  Event creation
goes through the dispatcher (the full validate→enrich→rules→state pipeline)
rather than straight into storage — same as the reference where REST event
creation flows into event management and the Kafka pipeline.

Counterpart of ``sitewhere_tpu/web/controllers.py``, whole: the same
routes, methods, authorities and order.  ``/api/instance/cluster``
polls the port ``Instance``'s peers, a membership change reaches
``apply_membership_change`` and ``/api/search/federated`` the federated
provider over the fabric.  Every route reads host values: the services copy card tensors off the card on
their own stream before they return.
"""

from __future__ import annotations

import base64
from typing import Optional

from sitewhere_tpu_torch.ids import NULL_ID
from sitewhere_tpu_torch.ingest.decoders import DecodedRequest, RequestKind
from sitewhere_tpu_torch.schema import AlertLevel, ComparisonOp, EventType, RuleKind
from sitewhere_tpu_torch.services.common import (
    AuthError,
    EntityNotFound,
    ValidationError,
    require,
)
from sitewhere_tpu_torch.web.http import (
    RawResponse,
    Request,
    RestGateway,
    jsonable,
    page_response,
)

def _enum_arg(enum_cls, raw, field: str):
    """Name ('GT'/'window_mean') or value (0) → enum member, 400 on junk
    (GET serializes enums as ints, so round-tripping a doc must work).
    Non-integral numbers are junk, not a truncation candidate: 2.7 must
    400, never silently become severity 2."""
    try:
        if isinstance(raw, str) and not raw.isdigit():
            return enum_cls[raw.upper()]
        value = int(raw)
        if float(raw) != value:
            raise ValueError(raw)
        return enum_cls(value)
    except (KeyError, ValueError, TypeError):
        raise ValidationError(f"bad {field}: {raw!r}")


def _float_arg(raw, field: str) -> float:
    try:
        return float(raw)
    except (TypeError, ValueError):
        raise ValidationError(f"bad {field}: {raw!r}")


_EVENT_TYPE_NAMES = {
    "measurements": EventType.MEASUREMENT,
    "locations": EventType.LOCATION,
    "alerts": EventType.ALERT,
    "invocations": EventType.COMMAND_INVOCATION,
    "responses": EventType.COMMAND_RESPONSE,
    "statechanges": EventType.STATE_CHANGE,
}


def register_routes(gw: RestGateway, inst) -> None:
    """Wire every controller against ``inst`` (an Instance)."""
    r = gw.router.add
    dm = inst.device_management

    def _optional_capacity(feature: str) -> None:
        """Degradation-ladder gate (runtime/overload.py): optional
        read-side work — analytics, external search — answers 503 from
        DEGRADED up so its cycles go to the event path.  The durable
        core (ingest, event queries, management) is never gated."""
        from sitewhere_tpu_torch.services.common import ServiceUnavailable

        ov = getattr(inst, "overload", None)
        require(ov is None or ov.allow_optional(feature),
                ServiceUnavailable(
                    f"{feature} is switched off while the instance is "
                    "overloaded; retry after it recovers"))

    # ---- auth (reference JwtService; unauthenticated route) ---------------
    def issue_jwt(req: Request):
        body = req.json()
        username = body.get("username")
        password = body.get("password")
        if not username:  # Basic auth fallback, as in the reference
            header = req.headers.get("Authorization", "")
            if header.startswith("Basic "):
                try:
                    raw = base64.b64decode(header[6:]).decode()
                    username, _, password = raw.partition(":")
                except Exception as e:
                    raise AuthError(f"bad basic auth: {e}") from e
        require(bool(username), AuthError("credentials required"))
        user = inst.users.authenticate(username, password or "")
        token = inst.tokens.mint(user.username, user.authorities)
        return {"token": token, "username": user.username,
                "authorities": user.authorities}

    r("POST", "/api/jwt", issue_jwt, auth_required=False)

    # ---- users ------------------------------------------------------------
    # scrub: credential hashes must never reach a REST response
    # (rpc/domains.py applies the same rule at the fabric boundary)
    from sitewhere_tpu_torch.rpc.domains import scrub

    r("GET", "/api/users", lambda q: scrub(page_response(
        inst.users.list_users(q.criteria()))))
    r("POST", "/api/users",
      lambda q: scrub(jsonable(inst.users.create_user(**q.json()))))
    r("GET", "/api/users/{name}",
      lambda q: scrub(jsonable(inst.users.get_user(q.params["name"]))))
    r("PUT", "/api/users/{name}",
      lambda q: scrub(jsonable(
          inst.users.update_user(q.params["name"], **q.json()))))
    r("DELETE", "/api/users/{name}",
      lambda q: scrub(jsonable(inst.users.delete_user(q.params["name"]))))
    r("GET", "/api/authorities",
      lambda q: page_response(inst.users.list_granted_authorities(q.criteria())))

    # ---- tenants ----------------------------------------------------------
    r("GET", "/api/tenants",
      lambda q: page_response(inst.tenants.list_tenants(q.criteria())))
    r("POST", "/api/tenants", lambda q: inst.tenants.create_tenant(**q.json()))

    # ---- tenant usage metering (runtime/metering.py ledger) ---------------
    # registered BEFORE /api/tenants/{token}: the router is first-match,
    # so "usage" must not be swallowed by the {token} capture
    def _ledger():
        ledger = getattr(inst, "usage_ledger", None)
        require(ledger is not None,
                EntityNotFound("tenant metering is disabled"))
        return ledger

    def tenants_usage(q):
        """Ranked top-K tenant usage (rows, shed, time, bytes) with the
        long-tail aggregate, totals, window shares and sketch config."""
        ledger = _ledger()
        try:
            k = int(q.q1("top", "0")) or None
        except ValueError:
            k = None
        return ledger.snapshot(resolve=inst.identity.tenant.token_of, k=k)
    r("GET", "/api/tenants/usage", tenants_usage)

    def tenant_usage_one(q):
        """Drill-down for one tenant: exact row when top-K-tracked, else
        the count-min lifetime estimate (flagged ``estimated``)."""
        from sitewhere_tpu_torch.ids import NULL_ID

        ledger = _ledger()
        token = q.params["token"]
        tid = inst.identity.tenant.lookup(token)
        require(tid != NULL_ID, EntityNotFound(f"no tenant {token!r}"))
        body = ledger.usage_of(tid)
        body.update(tenant=token, tenant_id=int(tid),
                    window_share=round(ledger.shares().get(int(tid), 0.0), 6),
                    rate_scale=round(ledger.rate_scale(tid), 6))
        # configured budget overlay (overload ladder) and metered-quota
        # consumption ride along so one GET answers "why am I clipped?"
        ov = getattr(inst, "overload", None)
        if ov is not None:
            budget = ov.tenant_budgets.overlay(token)
            if budget:
                body["budget"] = budget
        quotas = getattr(inst, "quotas", None)
        if quotas is not None:
            body["quota"] = quotas.consumption(tid)
        return body
    r("GET", "/api/tenants/usage/{token}", tenant_usage_one)

    r("GET", "/api/tenants/{token}",
      lambda q: inst.tenants.get_tenant(q.params["token"]))
    r("PUT", "/api/tenants/{token}",
      lambda q: inst.tenants.update_tenant(q.params["token"], **q.json()))
    r("DELETE", "/api/tenants/{token}",
      lambda q: inst.tenants.delete_tenant(q.params["token"]))

    # ---- tenant engines (MultitenantMicroservice.java:242-260,358-380) ----
    def engine_state(q):
        e = inst.engines.get_engine(q.params["token"])
        # state casing matches status_tree()/topology (enum .value)
        return {"tenant": e.tenant.token, "tenant_id": e.tenant_id,
                "state": e.state.value,
                "components": e.status_tree()}
    r("GET", "/api/tenants/{token}/engine", engine_state)

    def engine_restart(q):
        e = inst.engines.restart_engine(q.params["token"])
        return {"tenant": e.tenant.token, "state": e.state.value,
                "restarted": True}
    r("POST", "/api/tenants/{token}/engine/restart", engine_restart)

    def tenant_state(q):
        """Per-tenant device-state partition summary: device count, the
        pow2 capacity rung, and the compile counter the churn-storm
        invariant pins (untouched tenants must stay flat)."""
        token = q.params["token"]
        tid = inst.identity.tenant.lookup(token)
        require(tid != NULL_ID, EntityNotFound(f"no tenant {token!r}"))
        sm = getattr(inst, "device_state", None)
        require(sm is not None and sm.partitions is not None,
                EntityNotFound("tenant state partitioning is disabled"))
        body = sm.tenant_state_summary(int(tid))
        body.update(tenant=token, tenant_id=int(tid))
        return body
    r("GET", "/api/tenants/{token}/state", tenant_state)

    # ---- bring-your-own-rules (rules/ subsystem) --------------------------
    # per-tenant declarative rule & enrichment programs; a POST validates
    # + compiles (warming any novel kernel shape) BEFORE the new operand
    # epoch publishes, so traffic never pays a compile
    def _programs():
        eng = getattr(inst, "rule_engine", None)
        require(eng is not None,
                EntityNotFound("rule programs are disabled on this "
                               "instance (rules.programs_enabled)"))
        return eng

    def _rules_tenant(q):
        token = q.params["token"]
        tid = inst.identity.tenant.lookup(token)
        require(tid != NULL_ID, EntityNotFound(f"no tenant {token!r}"))
        return int(tid)

    def _put_rule(q, rtoken=None):
        from sitewhere_tpu_torch.rules.dsl import RuleProgramError

        eng = _programs()
        tid = _rules_tenant(q)
        # a program PUT triggers validate+compile — metered eval work,
        # so an over-quota tenant is refused (429) before compiling
        quotas = getattr(inst, "quotas", None)
        if quotas is not None:
            quotas.check_eval(tid)
        doc = q.json()
        if rtoken is not None:
            doc["token"] = rtoken
        try:
            return eng.put_program(tid, doc)
        except RuleProgramError as e:
            raise ValidationError(str(e)) from e

    def _get_rule(q):
        eng = _programs()
        body = eng.registry.get_program(_rules_tenant(q),
                                        q.params["rule"])
        require(body is not None,
                EntityNotFound(f"no rule program {q.params['rule']!r}"))
        return body

    def _delete_rule(q):
        eng = _programs()
        found = eng.delete_program(_rules_tenant(q), q.params["rule"])
        require(found,
                EntityNotFound(f"no rule program {q.params['rule']!r}"))
        return {"deleted": q.params["rule"]}

    r("GET", "/api/tenants/{token}/rules",
      lambda q: {"programs":
                 _programs().registry.list_programs(_rules_tenant(q))})
    r("POST", "/api/tenants/{token}/rules", _put_rule)
    r("GET", "/api/tenants/{token}/rules/{rule}", _get_rule)
    r("PUT", "/api/tenants/{token}/rules/{rule}",
      lambda q: _put_rule(q, q.params["rule"]))
    r("DELETE", "/api/tenants/{token}/rules/{rule}", _delete_rule)

    def rules_engine_stats(q):
        return _programs().stats()
    r("GET", "/api/rules/programs", rules_engine_stats)

    def put_rule_attribute(q):
        """Set one enrichment attribute (device or asset table) the
        programs' metadata-join predicates compare against."""
        from sitewhere_tpu_torch.rules.dsl import RuleProgramError

        eng = _programs()
        body = q.json()
        table = str(body.get("table", "device"))
        token = body.get("token")
        require(token, ValidationError("attribute needs entity 'token'"))
        space = (inst.identity.asset if table == "asset"
                 else inst.identity.device)
        eid = space.lookup(str(token))
        require(eid != NULL_ID,
                EntityNotFound(f"no {table} {token!r}"))
        require("column" in body and "value" in body,
                ValidationError("attribute needs 'column' and 'value'"))
        try:
            eng.attributes.set(table, int(eid), str(body["column"]),
                               int(body["value"]))
        except RuleProgramError as e:
            raise ValidationError(str(e)) from e
        except (TypeError, ValueError) as e:
            raise ValidationError(f"bad attribute value: {e}") from e
        eng.refresh()
        return {"table": table, "token": token,
                "column": str(body["column"]),
                "value": int(body["value"])}
    r("POST", "/api/rules/attributes", put_rule_attribute)

    # ---- tracing (Jaeger-sampling analog; spans over REST) ----------------
    def get_traces(q):
        try:
            limit = int(q.query.get("limit", ["100"])[0])
        except ValueError:
            limit = 100
        return {"stats": inst.tracer.stats(),
                "spans": inst.tracer.recent(limit)}
    r("GET", "/api/traces", get_traces)

    # ---- runtime scripts (ScriptSynchronizer analog) ----------------------
    r("GET", "/api/scripts", lambda q: inst.scripts.list_scripts())
    r("GET", "/api/scripts/{name}",
      lambda q: {**inst.scripts.describe(q.params["name"]),
                 "source": inst.scripts.get_source(q.params["name"])})

    def _actor(q) -> str:
        return str((q.claims or {}).get("sub", "anonymous"))

    def upload_script(q):
        body = q.json()
        require("source" in body,
                ValidationError("body must carry 'source'"))
        return inst.scripts.upload(
            q.params["name"], str(body.get("kind", "decoder")),
            str(body["source"]),
            activate=bool(body.get("activate", True)),
            actor=_actor(q))
    # script upload is arbitrary code execution — admin only
    r("PUT", "/api/scripts/{name}", upload_script, authority="ROLE_ADMIN")

    def activate_script(q):
        body = q.json()
        try:
            version = int(body["version"])
        except (KeyError, TypeError, ValueError):
            raise ValidationError("body must carry an integer 'version'")
        return inst.scripts.activate(q.params["name"], version,
                                     actor=_actor(q))
    r("POST", "/api/scripts/{name}/activate", activate_script,
      authority="ROLE_ADMIN")

    def script_audit(q):
        try:
            limit = int(q.q1("limit", "100"))
        except ValueError:
            limit = 100
        return {"entries": inst.scripts.audit_log(limit)}
    # who uploaded/activated what, when — admin-visible audit trail
    r("GET", "/api/scripts-audit", script_audit, authority="ROLE_ADMIN")

    # ---- device types + commands + statuses -------------------------------
    r("GET", "/api/devicetypes",
      lambda q: page_response(dm.list_device_types(q.criteria())))
    r("POST", "/api/devicetypes", lambda q: dm.create_device_type(**q.json()))
    r("GET", "/api/devicetypes/{token}",
      lambda q: dm.get_device_type(q.params["token"]))
    r("PUT", "/api/devicetypes/{token}",
      lambda q: dm.update_device_type(q.params["token"], **q.json()))
    r("DELETE", "/api/devicetypes/{token}",
      lambda q: dm.delete_device_type(q.params["token"]))
    r("GET", "/api/devicetypes/{token}/commands",
      lambda q: dm.list_device_commands(q.params["token"]))
    r("POST", "/api/devicetypes/{token}/commands",
      lambda q: dm.create_device_command(q.params["token"], **q.json()))
    r("DELETE", "/api/devicetypes/{token}/commands/{cmd}",
      lambda q: dm.delete_device_command(q.params["token"], q.params["cmd"]))
    r("GET", "/api/devicetypes/{token}/statuses",
      lambda q: dm.list_device_statuses(q.params["token"]))
    r("POST", "/api/devicetypes/{token}/statuses",
      lambda q: dm.create_device_status(q.params["token"], **q.json()))

    # ---- devices ----------------------------------------------------------
    def list_devices(q: Request):
        return page_response(dm.list_devices(
            q.criteria(),
            device_type=q.q1("deviceType"),
        ))

    r("GET", "/api/devices", list_devices)
    r("POST", "/api/devices", lambda q: dm.create_device(**q.json()))
    r("GET", "/api/devices/{token}", lambda q: dm.get_device(q.params["token"]))
    r("PUT", "/api/devices/{token}",
      lambda q: dm.update_device(q.params["token"], **q.json()))
    r("DELETE", "/api/devices/{token}",
      lambda q: dm.delete_device(q.params["token"]))
    r("GET", "/api/devices/{token}/assignments",
      lambda q: page_response(dm.list_device_assignments(
          q.criteria(), device=q.params["token"])))

    # ---- assignments + event create/list (Assignments.java:319-576) -------
    r("POST", "/api/assignments", lambda q: dm.create_device_assignment(**q.json()))
    r("GET", "/api/assignments/{token}",
      lambda q: dm.get_device_assignment(q.params["token"]))
    r("DELETE", "/api/assignments/{token}",
      lambda q: dm.delete_device_assignment(q.params["token"]))
    r("POST", "/api/assignments/{token}/end",
      lambda q: dm.release_device_assignment(q.params["token"]))
    r("POST", "/api/assignments/{token}/missing",
      lambda q: dm.mark_missing(q.params["token"]))

    def _assignment_device(token: str):
        a = dm.get_device_assignment(token)
        return dm.get_device(a.device), a

    def create_event(q: Request):
        """POST /api/assignments/{token}/{kind} → pipeline ingest."""
        kind = q.params["kind"]
        etype = _EVENT_TYPE_NAMES.get(kind)
        require(etype is not None, EntityNotFound(f"no event kind {kind!r}"))
        if etype == EventType.COMMAND_INVOCATION:
            # before the local assignment lookup: invocations federate to
            # the assignment's owning host when it isn't here
            return create_invocation(q)
        device, _ = _assignment_device(q.params["token"])
        body = q.json()
        from sitewhere_tpu_torch.services.common import now_s

        common = dict(
            device_token=device.token,
            ts_s=int(body.get("ts", now_s())),
            ts_ns=int(body.get("tsNs", 0)),
            update_state=bool(body.get("updateState", True)),
            metadata=body.get("metadata"),
        )
        if etype == EventType.MEASUREMENT:
            req_ = DecodedRequest(
                kind=RequestKind.MEASUREMENT,
                mtype=str(body.get("name", body.get("measurementId", ""))),
                value=float(body.get("value", 0.0)), **common)
        elif etype == EventType.LOCATION:
            req_ = DecodedRequest(
                kind=RequestKind.LOCATION,
                lat=float(body.get("latitude", 0.0)),
                lon=float(body.get("longitude", 0.0)),
                elevation=float(body.get("elevation", 0.0)), **common)
        elif etype == EventType.ALERT:
            req_ = DecodedRequest(
                kind=RequestKind.ALERT,
                alert_type=str(body.get("type", "alert")),
                alert_level=int(body.get("level", AlertLevel.INFO)),
                alert_message=body.get("message"), **common)
        else:
            req_ = DecodedRequest(kind=RequestKind.STATE_CHANGE, **common)
        inst.dispatcher.ingest(req_)
        inst.dispatcher.flush()
        return {"queued": True, "deviceToken": device.token,
                "eventType": kind}

    def create_invocation(q: Request):
        """Command invocation, federated: the assignment's owner runs the
        one delivery path (invocation event → pipeline → command-row
        egress).  Locally-unknown assignments are routed over the fabric
        to the host that owns them — the web gateway demuxes management
        calls to the right service instance exactly as the reference's
        web-rest does over its ApiDemux (SURVEY.md §3.3-3.4)."""
        body = q.json()
        require("commandToken" in body,
                ValidationError("commandToken required"))
        return inst.invoke_command(
            q.params["token"],
            command_token=str(body["commandToken"]),
            parameter_values=dict(body.get("parameterValues", {})),
            initiator="REST",
            initiator_id=(q.claims or {}).get("sub"),
            ts_s=body.get("ts"),
        )

    # ---- responses for one invocation (reference:
    # listCommandResponsesForInvocation, correlated by originatingEventId) -
    def invocation_responses(q: Request):
        handle = inst.identity.invocation.lookup(q.params["token"])
        require(handle != NULL_ID,
                EntityNotFound(f"invocation {q.params['token']}"))
        return page_response(inst.event_store.query(
            q.criteria(), command_id=handle,
            event_type=int(EventType.COMMAND_RESPONSE)))

    r("GET", "/api/invocations/{token}/responses", invocation_responses)

    # Stream routes must precede the generic {kind} event routes or
    # GET .../streams would match {kind} and 404 as an unknown event kind
    # (the handlers are defined below; the lambdas bind late).
    r("GET", "/api/assignments/{token}/streams",
      lambda q: list_streams(q))
    r("GET", "/api/assignments/{token}/streams/",
      lambda q: list_streams(q))

    # chart series (reference: Assignments measurements/series endpoints
    # over ChartBuilder) — also before the generic {kind} route
    def chart_series(q: Request):
        from sitewhere_tpu_torch.analytics.charts import build_chart_series

        _optional_capacity("analytics")
        a = dm.get_device_assignment(q.params["token"])
        aid = dm.handle_for("assignment", a.token)
        # repeated params AND comma-separated lists accepted
        names = [
            n for raw in q.query.get("measurementIds", [])
            for n in raw.split(",") if n
        ]
        mtype_ids = None
        if names:
            mtype_ids = [
                h for h in (inst.identity.mtype.lookup(n) for n in names)
                if h != NULL_ID
            ]
            if not mtype_ids:
                return []  # requested names don't exist: empty, not ALL

        def _int_q(key):
            raw = q.query.get(key, [None])[0]
            try:
                return int(raw) if raw is not None else None
            except ValueError:
                return None

        from sitewhere_tpu_torch.analytics.windows import AGGREGATES

        agg = (q.q1("agg") or "mean").lower()
        require(agg in AGGREGATES, ValidationError(f"bad agg: {agg!r}"))
        return build_chart_series(
            inst.event_store,
            assignment_id=aid,
            mtype_ids=mtype_ids,
            start_s=_int_q("startDate"),
            end_s=_int_q("endDate"),
            mtype_name_of=inst.identity.mtype.token_of,
            # bucketS downsamples through the shared window kernels —
            # the same aggregation path the streaming queries compile
            bucket_s=_int_q("bucketS"),
            agg=agg,
            # the window kernels run on the instance's device, from host
            # columns the store hands out
            device=inst.device,
        )
    r("GET", "/api/assignments/{token}/measurements/series", chart_series)

    r("POST", "/api/assignments/{token}/{kind}", create_event)

    def list_events(q: Request):
        kind = q.params["kind"]
        etype = _EVENT_TYPE_NAMES.get(kind)
        require(etype is not None, EntityNotFound(f"no event kind {kind!r}"))
        a = dm.get_device_assignment(q.params["token"])
        aid = dm.handle_for("assignment", a.token)
        inst.event_store.flush()
        return page_response(inst.event_store.query(
            q.criteria(), assignment_id=aid, event_type=int(etype)))

    r("GET", "/api/assignments/{token}/{kind}", list_events)

    # ---- events (cross-entity indexes, reference DeviceEvents ctrl) -------
    def search_events(q: Request):
        inst.event_store.flush()
        filters = {}
        device = q.q1("device")
        if device:
            handle = inst.identity.device.lookup(device)
            require(handle != NULL_ID, EntityNotFound(f"no device {device!r}"))
            filters["device_id"] = handle
        for qname, fname in (
            ("assignment", "assignment_id"),
            ("area", "area_id"),
            ("customer", "customer_id"),
            ("asset", "asset_id"),
        ):
            token = q.q1(qname)
            if token:
                handle = dm.handle_for(qname, token)
                require(handle != NULL_ID, EntityNotFound(f"no {qname} {token!r}"))
                filters[fname] = handle
        kind = q.q1("eventType")
        if kind:
            etype = _EVENT_TYPE_NAMES.get(kind.lower())
            require(etype is not None, EntityNotFound(f"no event kind {kind!r}"))
            filters["event_type"] = int(etype)
        return page_response(inst.event_store.query(q.criteria(), **filters))

    r("GET", "/api/events", search_events)

    # ---- areas / area types / zones ---------------------------------------
    r("GET", "/api/areatypes",
      lambda q: page_response(dm.list_area_types(q.criteria())))
    r("POST", "/api/areatypes", lambda q: dm.create_area_type(**q.json()))
    r("GET", "/api/areatypes/{token}",
      lambda q: dm.get_area_type(q.params["token"]))
    r("GET", "/api/areas", lambda q: page_response(dm.list_areas(q.criteria())))
    r("GET", "/api/areas/tree", lambda q: dm.area_tree())
    r("POST", "/api/areas", lambda q: dm.create_area(**q.json()))
    r("GET", "/api/areas/{token}", lambda q: dm.get_area(q.params["token"]))
    r("PUT", "/api/areas/{token}",
      lambda q: dm.update_area(q.params["token"], **q.json()))
    r("DELETE", "/api/areas/{token}", lambda q: dm.delete_area(q.params["token"]))
    r("GET", "/api/zones", lambda q: page_response(
        dm.list_zones(q.criteria(), area=q.q1("area"))))
    r("POST", "/api/zones", lambda q: dm.create_zone(**q.json()))
    r("GET", "/api/zones/{token}", lambda q: dm.get_zone(q.params["token"]))
    r("PUT", "/api/zones/{token}",
      lambda q: dm.update_zone(q.params["token"], **q.json()))
    r("DELETE", "/api/zones/{token}", lambda q: dm.delete_zone(q.params["token"]))

    # ---- customers --------------------------------------------------------
    r("GET", "/api/customertypes",
      lambda q: page_response(dm.list_customer_types(q.criteria())))
    r("POST", "/api/customertypes", lambda q: dm.create_customer_type(**q.json()))
    r("GET", "/api/customers",
      lambda q: page_response(dm.list_customers(q.criteria())))
    r("POST", "/api/customers", lambda q: dm.create_customer(**q.json()))
    r("GET", "/api/customers/{token}",
      lambda q: dm.get_customer(q.params["token"]))
    r("DELETE", "/api/customers/{token}",
      lambda q: dm.delete_customer(q.params["token"]))

    # ---- device groups ----------------------------------------------------
    r("GET", "/api/devicegroups",
      lambda q: page_response(dm.list_device_groups(q.criteria())))
    r("POST", "/api/devicegroups", lambda q: dm.create_device_group(**q.json()))
    r("GET", "/api/devicegroups/{token}",
      lambda q: dm.get_device_group(q.params["token"]))
    r("DELETE", "/api/devicegroups/{token}",
      lambda q: dm.delete_device_group(q.params["token"]))
    r("POST", "/api/devicegroups/{token}/elements",
      lambda q: dm.add_device_group_elements(
          q.params["token"], q.json().get("elements", [])))

    # ---- assets -----------------------------------------------------------
    r("GET", "/api/assettypes",
      lambda q: page_response(inst.assets.list_asset_types(q.criteria())))
    r("POST", "/api/assettypes",
      lambda q: inst.assets.create_asset_type(**q.json()))
    r("GET", "/api/assets",
      lambda q: page_response(inst.assets.list_assets(q.criteria())))
    r("POST", "/api/assets", lambda q: inst.assets.create_asset(**q.json()))
    r("GET", "/api/assets/{token}",
      lambda q: inst.assets.get_asset(q.params["token"]))
    r("DELETE", "/api/assets/{token}",
      lambda q: inst.assets.delete_asset(q.params["token"]))

    # ---- batch operations -------------------------------------------------
    r("GET", "/api/batch",
      lambda q: page_response(inst.batch_ops.list_operations(q.criteria())))
    r("GET", "/api/batch/{token}",
      lambda q: inst.batch_ops.get_operation(q.params["token"]))
    r("GET", "/api/batch/{token}/elements",
      lambda q: page_response(inst.batch_ops.list_elements(
          q.params["token"], q.criteria())))

    def create_batch_command(q: Request):
        body = q.json()
        return inst.batch_ops.create_batch_command_invocation(
            command_token=str(body["commandToken"]),
            parameter_values=dict(body.get("parameterValues", {})),
            devices=body.get("deviceTokens"),
            group=body.get("groupToken"),
            token=body.get("token"),
        )

    r("POST", "/api/batch/command", create_batch_command)

    # ---- schedules --------------------------------------------------------
    r("GET", "/api/schedules",
      lambda q: page_response(inst.schedules.list_schedules(q.criteria())))
    r("POST", "/api/schedules",
      lambda q: inst.schedules.create_schedule(**q.json()))
    r("GET", "/api/schedules/{token}",
      lambda q: inst.schedules.get_schedule(q.params["token"]))
    r("DELETE", "/api/schedules/{token}",
      lambda q: inst.schedules.delete_schedule(q.params["token"]))
    r("POST", "/api/jobs", lambda q: inst.schedules.create_job(**q.json()))
    r("GET", "/api/jobs", lambda q: page_response(
        inst.schedules.list_jobs(q.criteria())))
    r("DELETE", "/api/jobs/{token}",
      lambda q: inst.schedules.delete_job(q.params["token"]))

    # ---- rules (TPU threshold catalog; reference rule processors) ---------
    # Both wire casings are accepted for every field ("alertType" and
    # "alert_type") because GET serves the dataclass's snake_case keys —
    # a GET→edit→PUT round trip must apply the edit, and a typo'd field
    # must 400, never 200-and-ignore.
    _RULE_KEYS = {
        "mtype": "mtype", "op": "op", "threshold": "threshold",
        "alertType": "alert_type", "alert_type": "alert_type",
        "alertLevel": "alert_level", "alert_level": "alert_level",
        "kind": "kind", "windowS": "window_s", "window_s": "window_s",
        "tenant": "tenant", "token": "token",
    }
    _RULE_READONLY = {"created_s"}   # present in GET docs; ignored on write

    def _rule_fields(body: dict) -> dict:
        fields = {}
        for key, raw in body.items():
            canon = _RULE_KEYS.get(key)
            if canon is None:
                if key in _RULE_READONLY:
                    continue
                raise ValidationError(f"unknown rule field {key!r}")
            if canon == "op":
                raw = _enum_arg(ComparisonOp, raw, "op")
            elif canon == "alert_level":
                raw = _enum_arg(AlertLevel, raw, "alertLevel")
            elif canon == "kind":
                raw = _enum_arg(RuleKind, raw, "kind")
            elif canon == "threshold":
                raw = _float_arg(raw, "threshold")
            elif canon == "window_s" and raw is not None:
                raw = _float_arg(raw, "windowS")
            fields[canon] = raw
        return fields

    def create_rule(q: Request):
        fields = _rule_fields(q.json())
        fields.setdefault("mtype", None)
        fields.setdefault("op", ComparisonOp.GT)
        fields.setdefault("threshold", 0.0)
        fields.setdefault("alert_type", "")
        return inst.rules.create_rule(**fields)

    def update_rule(q):
        fields = _rule_fields(q.json())
        fields.pop("token", None)   # path param is authoritative
        return inst.rules.update_rule(q.params["token"], **fields)

    r("GET", "/api/rules", lambda q: inst.rules.list_rules(q.q1("tenant")))
    r("POST", "/api/rules", create_rule)
    r("GET", "/api/rules/{token}",
      lambda q: inst.rules.get_rule(q.params["token"]))
    r("PUT", "/api/rules/{token}", update_rule)
    r("DELETE", "/api/rules/{token}",
      lambda q: inst.rules.delete_rule(q.params["token"]))

    # ---- streaming analytics & CEP (sitewhere-spark/Siddhi analog) --------
    # Window/Session/Pattern queries compile once; live matches stream
    # from the dispatcher, retrospective runs replay the event store
    # through the SAME operator.  Retrospective scans are optional
    # capacity — refused from DEGRADED like the chart/search endpoints;
    # registration and match fetches stay cheap and ungated.
    def _analytics():
        mgr = getattr(inst, "analytics", None)
        require(mgr is not None,
                EntityNotFound("analytics is disabled on this instance"))
        return mgr

    r("GET", "/api/analytics/queries",
      lambda q: {"queries": _analytics().list_queries()})
    r("POST", "/api/analytics/queries",
      lambda q: _analytics().register(q.json()))
    r("GET", "/api/analytics/queries/{name}",
      lambda q: _analytics().describe(q.params["name"]))
    r("DELETE", "/api/analytics/queries/{name}",
      lambda q: _analytics().remove(q.params["name"]))

    def run_query_retrospective(q: Request):
        _optional_capacity("analytics")
        body = q.json()
        # metered quota: a retrospective replay is pure eval compute, so
        # a tenant that exhausted its eval_s window gets a retryable 429
        # here (check_eval raises QuotaExceeded) before the scan starts
        quotas = getattr(inst, "quotas", None)
        tok = body.get("tenant", q.q1("tenant"))
        if quotas is not None and tok:
            tid = inst.identity.tenant.lookup(str(tok))
            require(tid != NULL_ID, EntityNotFound(f"no tenant {tok!r}"))
            quotas.check_eval(int(tid))

        def _opt_int(key):
            raw = body.get(key, q.q1(key))
            if raw is None:
                return None
            try:
                return int(raw)
            except (TypeError, ValueError):
                raise ValidationError(f"{key} must be an integer: {raw!r}")

        mgr = _analytics()
        inst.event_store.flush()
        return mgr.run_retrospective(
            q.params["name"],
            start_s=_opt_int("startDate"),
            end_s=_opt_int("endDate"))

    r("POST", "/api/analytics/queries/{name}/run", run_query_retrospective)

    def query_matches(q: Request):
        try:
            limit = int(q.q1("limit", "100"))
        except ValueError:
            limit = 100
        return {"matches": _analytics().recent_matches(
            q.params["name"], limit)}

    r("GET", "/api/analytics/queries/{name}/matches", query_matches)
    # finalize open windows/sessions of the live state (ops/test hook —
    # live matches otherwise wait for the next window to arrive)
    r("POST", "/api/analytics/queries/{name}/flush",
      lambda q: {"emitted": _analytics().flush_live(q.params["name"])})

    # ---- device state (reference service-device-state RPCs) ---------------
    r("GET", "/api/devicestates/{token}",
      lambda q: inst.device_state.get_device_state(q.params["token"]))
    # token form: correct on a gateway whose device_state is a remote
    # facade (dense ids never leave their minting host)
    r("GET", "/api/devicestates",
      lambda q: {"missing": inst.device_state.missing_device_tokens()})

    # ---- streams (service-streaming-media REST analog) --------------------
    def list_streams(q: Request):
        a = dm.get_device_assignment(q.params["token"])
        return page_response(inst.streams.list_device_streams(
            a.token, q.criteria()))

    def stream_download(q: Request):
        a = dm.get_device_assignment(q.params["token"])
        stream = inst.streams.get_assignment_stream(a.token, q.params["sid"])
        require(stream is not None,
                EntityNotFound(f"no stream {q.params['sid']!r}"))
        return RawResponse(inst.streams.stream_content(stream.token),
                           content_type=stream.content_type)

    r("GET", "/api/assignments/{token}/streams/{sid}", stream_download)

    # ---- labels (service-label-generation REST analog) --------------------
    def label_png(q: Request):
        data = inst.labels.generate_png(
            q.q1("generator", "default"), q.params["kind"], q.params["token"]
        )
        return RawResponse(data, content_type="image/png")

    r("GET", "/api/labels/{kind}/{token}", label_png)

    # ---- instance admin (topology/config/metrics; reference Instance ctrl) -
    r("GET", "/api/instance/topology", lambda q: inst.topology())
    r("GET", "/api/instance/configuration", lambda q: inst.config.as_dict())
    r("GET", "/api/instance/metrics",
      lambda q: inst.dispatcher.metrics_snapshot())

    def metrics_prom(q):
        """OpenMetrics exposition of the instance + process registries."""
        from sitewhere_tpu_torch.runtime.metrics import (
            global_registry,
            render_openmetrics,
        )

        ledger = getattr(inst, "usage_ledger", None)
        if ledger is not None:
            # refresh the governed tenant.* gauges so a scrape always
            # sees the current top-K even between dispatcher publishes
            ledger.publish()
        text = render_openmetrics(inst.metrics, global_registry())
        return RawResponse(
            text.encode("utf-8"),
            content_type=("application/openmetrics-text; "
                          "version=1.0.0; charset=utf-8"))
    # unauthenticated like /api/openapi.json: scrapers (Prometheus, the
    # smoke tooling) don't carry JWTs.  Deliberate exposure tradeoff:
    # the surface is metric names/values, connector ids embedded in
    # per-connector gauge names, and opaque trace-id exemplars — the
    # trace ids are random handles only dereferenceable through the
    # JWT-protected topology/trace surface
    r("GET", "/api/instance/metrics.prom", metrics_prom,
      auth_required=False)

    # ---- flight recorder + SLO + on-demand profiling ----------------------
    def _flightrec():
        rec = getattr(inst, "flightrec", None)
        require(rec is not None,
                EntityNotFound("flight recorder is disabled"))
        return rec

    def flightrecorder(q: Request):
        try:
            limit = int(q.q1("limit", "100"))
        except ValueError:
            limit = 100
        rec = _flightrec()
        return {"stats": rec.stats(), "records": rec.recent(limit),
                "snapshots": rec.snapshots()}

    r("GET", "/api/instance/flightrecorder", flightrecorder)

    def flightrec_snapshot_download(q: Request):
        try:
            data = _flightrec().read_snapshot(q.params["name"])
        except KeyError:
            raise EntityNotFound(f"no snapshot {q.params['name']!r}")
        return RawResponse(data, content_type="application/jsonl")

    r("GET", "/api/instance/flightrecorder/snapshots/{name}",
      flightrec_snapshot_download)

    def flightrec_dump(q: Request):
        from sitewhere_tpu_torch.services.common import ServiceError

        body = q.json()
        rec = _flightrec()
        require(rec.dir is not None,
                ValidationError("snapshots are disabled (no data dir)"))
        path = rec.snapshot(reason=str(body.get("reason", "manual")))
        # dir configured but no file: the WRITE failed (disk full,
        # permissions) — a server-side fault, not a config 400
        require(path is not None,
                ServiceError("snapshot write failed; see server logs"))
        import os as _os

        return {"snapshot": _os.path.basename(path)}

    # operator-forced dump — a write to the data dir, admin-only
    r("POST", "/api/instance/flightrecorder/snapshot", flightrec_dump,
      authority="ROLE_ADMIN")

    def slo_status(q):
        engine = getattr(inst, "slo", None)
        require(engine is not None,
                EntityNotFound("SLO engine is disabled"))
        return engine.snapshot()

    r("GET", "/api/instance/slo", slo_status)

    def device_profile(q: Request):
        """Fori-chain device-stage calibration at the instance's width
        — compiles probe chains (seconds of work), so admin-only."""
        body = q.json()

        def _pos_int(key, default, cap):
            # ceiling too: iters is a STATIC fori_loop trip count at
            # production width — an unbounded value would occupy the
            # shared device for hours with no way to cancel
            try:
                return min(cap, max(1, int(body.get(key, default))))
            except (TypeError, ValueError):
                raise ValidationError(f"{key} must be an integer")

        return inst.run_device_profile(
            iters=_pos_int("iters", 16, 1024),
            repeats=_pos_int("repeats", 3, 32))

    r("POST", "/api/instance/profile/device", device_profile,
      authority="ROLE_ADMIN")

    def profiler_capture(q: Request):
        action = str(q.json().get("action", "")).lower()
        if action == "start":
            return inst.start_profiler_capture()
        if action == "stop":
            return inst.stop_profiler_capture()
        raise ValidationError("body must carry action: start|stop")

    # on-demand jax.profiler capture (TensorBoard/XProf trace dump)
    r("POST", "/api/instance/profile/xla", profiler_capture,
      authority="ROLE_ADMIN")

    # ---- dead letters: inspect + requeue (reprocess-topic analog) ---------
    def _int_arg(raw, field: str) -> int:
        try:
            return int(raw)
        except (TypeError, ValueError):
            raise ValidationError(f"{field} must be an integer: {raw!r}")

    def list_dead_letters(q: Request):
        limit = _int_arg(q.q1("limit", "100"), "limit")
        raw_start = q.q1("start")
        start = _int_arg(raw_start, "start") if raw_start is not None else None
        return {"results": inst.list_dead_letters(limit=limit, start=start)}

    r("GET", "/api/deadletters", list_dead_letters)
    r("POST", "/api/deadletters/{offset}/requeue",
      lambda q: inst.requeue_dead_letter(
          _int_arg(q.params["offset"], "offset")),
      authority="ROLE_ADMIN")

    # ---- external search providers (service-event-search analog) ----------
    def external_search(q: Request):
        _optional_capacity("search")
        mgr = getattr(inst, "search_providers", None)
        require(mgr is not None, EntityNotFound("no search providers configured"))
        provider = mgr.get_provider(q.params["provider"])
        return page_response(provider.search(q.criteria()))

    r("GET", "/api/search/{provider}", external_search)
    r("GET", "/api/instance/cluster", lambda q: inst.cluster_topology())

    def change_membership(q):
        body = q.json()
        peers = body.get("peers")
        require(isinstance(peers, list) and peers,
                ValidationError("body must carry a non-empty 'peers' list"))
        return inst.apply_membership_change(
            [str(p) for p in peers],
            process_id=(int(body["processId"])
                        if body.get("processId") is not None else None))
    # cluster grow/shrink (rebalance + record handoff) — every host must
    # be told the same list; admin-only ops action
    r("POST", "/api/instance/cluster/membership", change_membership,
      authority="ROLE_ADMIN")

    # ---- self-describing API listing (reference: Swagger) -----------------
    from sitewhere_tpu_torch.web.http import openapi_spec

    r("GET", "/api/openapi.json",
      lambda q: openapi_spec(gw.router,
                             f"sitewhere-tpu ({inst.instance_id})"),
      auth_required=False)
