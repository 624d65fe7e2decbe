"""Ownership migration on cluster membership change.

Counterpart of ``sitewhere_tpu/rpc/migration.py``: the same code over the
port's modules (no JAX anywhere on this path).

Reference: when Kafka consumer-group membership changes, partitions
rebalance to the surviving/new members and each consumer resumes from
the committed offset (``MicroserviceKafkaConsumer.java:116-139``); the
gRPC demux tracks replica add/remove through its DiscoveryMonitor
(``ApiDemux.java:42-110``).  Here device placement is the rendezvous
hash over the peers list (``rpc/forward.py``), so changing the peer
COUNT remaps ~1/(P+1) of devices — and the rows behind them must move:

1. **Spool requeue** (:meth:`HostForwarder.apply_membership`): every
   spooled-but-unsent batch re-splits line-by-line under the NEW
   ownership — rows for a departed peer land on their new owner (or the
   local intake) instead of waiting for a host that will never return.
2. **Record handoff** (:func:`migrate_out`): each host exports the
   devices it owns whose new owner is elsewhere — device type, device,
   active assignment, and the full DeviceState row — to
   ``migration.import`` on the new owner, which creates missing records
   idempotently and merges state newest-wins.  The exporter KEEPS its
   rows (historical events stay queryable locally and through federated
   search); new traffic routes by the new ownership.

A device whose old owner died unmigrated is not lost: its spooled
events replay to the new owner, whose auto-registration re-mints the
device (``service-device-registration`` semantics) — state rebuilds
from the stream, which is the Kafka-rebalance story exactly.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional

from sitewhere_tpu_torch.rpc.forward import owning_process
from sitewhere_tpu_torch.services.common import (
    DuplicateToken,
    EntityNotFound,
    InvalidReference,
    ValidationError,
)

logger = logging.getLogger("sitewhere_tpu_torch.migration")


def plan_outgoing(inst, old_n: int, new_n: int,
                  process_id: int) -> Dict[int, List[str]]:
    """Tokens THIS host owns (old map) that move elsewhere (new map),
    grouped by their new owner."""
    from sitewhere_tpu_torch.services.common import SearchCriteria

    out: Dict[int, List[str]] = {}
    everything = SearchCriteria(page_size=0)  # unlimited sentinel
    for device in inst.device_management.list_devices(everything):
        token = device.token
        if owning_process(token, old_n) != process_id:
            continue  # not ours to hand off
        new_owner = owning_process(token, new_n)
        if new_owner != process_id:
            out.setdefault(new_owner, []).append(token)
    return out


def export_devices(inst, tokens: List[str]) -> List[dict]:
    """Marshal the movable records for ``tokens`` (tokens-only entity
    references, so the import side resolves against ITS stores)."""
    dm = inst.device_management
    docs: List[dict] = []
    for token in tokens:
        device = dm.get_device(token)
        dtype = dm.get_device_type(device.device_type)
        assignment = dm.get_active_assignment(token)
        doc: dict = {
            "token": token,
            "deviceType": {"token": dtype.token, "name": dtype.name},
            "device": {"comments": device.comments,
                       "status": device.status},
        }
        if assignment is not None:
            doc["assignment"] = {
                "token": assignment.token,
                "customer": assignment.customer,
                "area": assignment.area,
                "asset": assignment.asset,
                "status": assignment.status,
                "active_date_s": assignment.active_date_s,
            }
        dense = inst.identity.device.lookup(token)
        if dense >= 0:
            try:
                doc["state"] = inst.device_state.export_row(int(dense))
            except Exception:
                logger.exception("state export failed for %s", token)
        docs.append(doc)
    return docs


def import_devices(inst, docs: List[dict]) -> dict:
    """Idempotently adopt exported records (the ``migration.import``
    handler): create what is absent, merge state newest-wins, never
    fail the whole batch for one bad doc."""
    created = 0
    states = 0
    errors = 0
    dm = inst.device_management
    for doc in docs or []:
        try:
            token = str(doc["token"])
            dt = doc.get("deviceType") or {}
            dt_token = str(dt.get("token") or "migrated")
            try:
                dm.get_device_type(dt_token)
            except EntityNotFound:
                dm.create_device_type(token=dt_token,
                                      name=str(dt.get("name") or dt_token))
            try:
                dm.get_device(token)
            except EntityNotFound:
                dev = doc.get("device") or {}
                dm.create_device(token=token, device_type=dt_token,
                                 comments=str(dev.get("comments") or ""),
                                 status=str(dev.get("status") or ""))
                created += 1
            a = doc.get("assignment")
            if a and dm.get_active_assignment(token) is None:
                # container references resolve against THIS host's
                # stores — drop any the importer does not hold rather
                # than fail the device handoff
                for ref, get in (("customer", dm.get_customer),
                                 ("area", dm.get_area)):
                    tok = a.get(ref)
                    if not tok:
                        continue
                    try:
                        get(tok)
                    except EntityNotFound:
                        a[ref] = None
                try:
                    dm.create_device_assignment(
                        token=(str(a["token"]) if a.get("token") else None),
                        device=token,
                        customer=a.get("customer"),
                        area=a.get("area"),
                        asset=a.get("asset"),
                        status=str(a.get("status") or "Active"))
                except (DuplicateToken, ValidationError, InvalidReference):
                    dm.create_device_assignment(device=token)
            state = doc.get("state")
            if state is not None:
                dense = inst.identity.device.lookup(token)
                if dense >= 0:
                    # under the step barrier: an in-flight pipeline step
                    # computed from the pre-import epoch would otherwise
                    # clobber this row at its commit
                    with inst.dispatcher.step_barrier():
                        applied = inst.device_state.import_row(
                            int(dense), state)
                    if applied:
                        states += 1
        except Exception:
            errors += 1
            logger.exception("migration import failed for %r",
                             doc.get("token"))
    return {"created": created, "states": states, "errors": errors}


def bind_migration(server, inst) -> None:
    server.register(
        "migration.import",
        lambda ctx, body: import_devices(inst, (body or {}).get("docs")),
        authority="ROLE_ADMIN")


def migrate_out(inst, old_n: int, new_n: int, process_id: int,
                demuxes: Dict[int, Optional[object]],
                batch: int = 256) -> dict:
    """Hand off every locally-owned device whose new owner is elsewhere.
    Unreachable owners are logged and skipped — their devices re-mint
    from the event stream via auto-registration (module docstring)."""
    plan = plan_outgoing(inst, old_n, new_n, process_id)
    moved = 0
    failed = 0
    for owner, tokens in sorted(plan.items()):
        demux = demuxes.get(owner)
        if demux is None:
            failed += len(tokens)
            logger.warning("no demux for new owner %d; %d devices not "
                           "handed off", owner, len(tokens))
            continue
        for lo in range(0, len(tokens), batch):
            part = tokens[lo:lo + batch]
            try:
                # export inside the try: a device deleted between plan
                # and export must not abort the remaining handoff
                docs = export_devices(inst, part)
                body, _ = demux.call("migration.import", {"docs": docs})
                moved += int(body.get("created", 0))
            except Exception:
                failed += len(part)
                logger.exception("handoff to %d failed (%d devices)",
                                 owner, len(part))
    return {"planned": sum(len(v) for v in plan.values()),
            "moved": moved, "failed": failed}
