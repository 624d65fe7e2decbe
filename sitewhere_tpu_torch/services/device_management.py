"""Device management: the system of record and its registry mirror.

Counterpart of ``sitewhere_tpu/services/device_management.py``, whole.
The reference's ``service-device-management`` implements the
``IDeviceManagement`` SPI (device types with commands and statuses,
devices, assignments, areas and area types, customers and customer types,
zones, device groups and their elements, alarms); here:

- the entity records (:class:`DeviceType`, :class:`Device`,
  :class:`DeviceAssignment` and the rest) are host dataclasses keyed by
  token, each naming the reference's class in ``_PICKLE_AS`` so the
  checkpoint's ``stores`` section reads the same in both packages;
- :class:`RegistryMirror` is the hot-path projection of those records:
  host numpy rows published to the device as immutable
  :class:`~sitewhere_tpu_torch.schema.Registry` /
  :class:`~sitewhere_tpu_torch.schema.ZoneTable` epochs whenever they are
  dirty, so the streaming step always reads a consistent epoch and a new
  one becomes visible between batches, never within one;
- :class:`DeviceManagement` is the per-tenant service over a shared
  :class:`~sitewhere_tpu_torch.ids.IdentityMap` and mirror: every write
  that changes what a step reads (a device's liveness and type, its
  active assignment's area, customer and asset, a zone's polygon and
  firing config) lands in the mirror's rows.

Listeners registered through :meth:`DeviceManagement.add_listener`
receive ``(kind, entity)`` callbacks (the reference's
``DeviceManagementTriggers``).
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import threading
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from sitewhere_tpu_torch.device import DeviceLike, resolve_device
from sitewhere_tpu_torch.ids import NULL_ID, IdentityMap
from sitewhere_tpu_torch.ops.geo import pad_polygon
from sitewhere_tpu_torch.schema import (
    AlertLevel,
    AssignmentStatus,
    Registry,
    ZoneTable,
    pow2_at_least,
)
from sitewhere_tpu_torch.services.common import (
    DuplicateToken,
    Entity,
    EntityNotFound,
    InvalidReference,
    SearchCriteria,
    SearchResults,
    ValidationError,
    mint_token,
    now_s,
    paged,
    require,
)

logger = logging.getLogger("sitewhere_tpu_torch.services")

# ---------------------------------------------------------------------------
# Entity records (host-authoritative; the java-model analog)
# ---------------------------------------------------------------------------

#: the reference module the entities pickle under (``_PICKLE_AS``)
_REF = "sitewhere_tpu.services.device_management"


@dataclasses.dataclass
class DeviceCommand(Entity):
    """Reference: ``IDeviceCommand`` — namespaced command with typed params."""

    _PICKLE_AS = (_REF, "DeviceCommand")

    name: str = ""
    namespace: str = ""
    description: str = ""
    # [(name, type, required)] — types: 'string'|'double'|'int32'|'int64'|'bool'|'bytes'
    parameters: List[Tuple[str, str, bool]] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class DeviceStatus(Entity):
    """Reference: ``IDeviceStatus`` — named visual status per device type."""

    _PICKLE_AS = (_REF, "DeviceStatus")

    code: str = ""
    name: str = ""
    background_color: str = "#ffffff"
    foreground_color: str = "#000000"
    border_color: str = "#000000"
    icon: str = ""


@dataclasses.dataclass
class DeviceType(Entity):
    _PICKLE_AS = (_REF, "DeviceType")

    name: str = ""
    description: str = ""
    image_url: str = ""
    container_policy: str = "Standalone"  # or "Composite" (reference enum)
    commands: Dict[str, DeviceCommand] = dataclasses.field(default_factory=dict)
    statuses: Dict[str, DeviceStatus] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Device(Entity):
    _PICKLE_AS = (_REF, "Device")

    device_type: str = ""
    comments: str = ""
    status: str = ""
    parent_device: Optional[str] = None  # composite containment
    # path within parent's composition schema → child device token
    element_mappings: Dict[str, str] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class DeviceAssignment(Entity):
    _PICKLE_AS = (_REF, "DeviceAssignment")

    device: str = ""
    customer: Optional[str] = None
    area: Optional[str] = None
    asset: Optional[str] = None
    status: str = "Active"  # Active | Missing | Released
    active_date_s: int = dataclasses.field(default_factory=now_s)
    released_date_s: Optional[int] = None


@dataclasses.dataclass
class AreaType(Entity):
    _PICKLE_AS = (_REF, "AreaType")

    name: str = ""
    description: str = ""
    icon: str = ""
    contained_area_types: List[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Area(Entity):
    _PICKLE_AS = (_REF, "Area")

    area_type: str = ""
    name: str = ""
    description: str = ""
    parent_area: Optional[str] = None
    bounds: List[Tuple[float, float]] = dataclasses.field(default_factory=list)  # (lat, lon)


@dataclasses.dataclass
class CustomerType(Entity):
    _PICKLE_AS = (_REF, "CustomerType")

    name: str = ""
    description: str = ""
    icon: str = ""
    contained_customer_types: List[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Customer(Entity):
    _PICKLE_AS = (_REF, "Customer")

    customer_type: str = ""
    name: str = ""
    description: str = ""
    parent_customer: Optional[str] = None


@dataclasses.dataclass
class Zone(Entity):
    _PICKLE_AS = (_REF, "Zone")

    area: str = ""
    name: str = ""
    bounds: List[Tuple[float, float]] = dataclasses.field(default_factory=list)  # (lat, lon)
    border_color: str = "#ff0000"
    fill_color: str = "#ff0000"
    opacity: float = 0.3
    # Rule attachment (ZoneTestRuleProcessor config lives on the processor in
    # the reference; here the zone row carries its firing config):
    condition: str = "inside"  # 'inside' | 'outside'
    alert_type: str = "zone.violation"
    alert_level: int = int(AlertLevel.WARNING)


@dataclasses.dataclass
class DeviceGroupElement:
    """Reference: ``IDeviceGroupElement`` — a device or nested group + roles."""

    _PICKLE_AS = (_REF, "DeviceGroupElement")

    device: Optional[str] = None
    nested_group: Optional[str] = None
    roles: List[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class DeviceGroup(Entity):
    _PICKLE_AS = (_REF, "DeviceGroup")

    name: str = ""
    description: str = ""
    roles: List[str] = dataclasses.field(default_factory=list)
    elements: List[DeviceGroupElement] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class DeviceAlarm(Entity):
    """Reference: ``IDeviceAlarm`` — triggered/acknowledged/resolved alarm."""

    _PICKLE_AS = (_REF, "DeviceAlarm")

    device: str = ""
    assignment: Optional[str] = None
    message: str = ""
    state: str = "Triggered"  # Triggered | Acknowledged | Resolved
    triggered_date_s: int = dataclasses.field(default_factory=now_s)
    acknowledged_date_s: Optional[int] = None
    resolved_date_s: Optional[int] = None
    triggering_event_id: Optional[int] = None



# ---------------------------------------------------------------------------
# Registry mirror — incremental numpy projection, published as epochs
# ---------------------------------------------------------------------------


class RegistryMirror:
    """Host-side numpy mirror of the device-resident Registry + ZoneTable.

    Mutations are O(1) row writes under a lock; :meth:`publish_registry`
    and :meth:`publish_zones` hand the dispatcher a fresh immutable epoch
    on ``device`` (``None`` = the card) only when something changed.
    """

    def __init__(self, capacity: int, max_zones: int = 256,
                 max_verts: int = 32, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.capacity = capacity
        self.max_zones = max_zones
        self.max_verts = max_verts
        self._lock = threading.Lock()
        # Serializes device creation across service instances.  Distinct
        # from _lock, which only guards row writes and is taken inside it.
        self.creation_lock = threading.Lock()
        self.epoch = 0
        self._dirty = True
        self._zones_dirty = True
        self._registry_cache: Optional[Registry] = None
        self._zones_cache: Optional[ZoneTable] = None

        self.active = np.zeros(capacity, np.bool_)
        self.tenant_id = np.full(capacity, NULL_ID, np.int32)
        self.device_type_id = np.full(capacity, NULL_ID, np.int32)
        self.assignment_id = np.full(capacity, NULL_ID, np.int32)
        self.assignment_status = np.full(capacity, AssignmentStatus.NONE,
                                         np.int32)
        self.area_id = np.full(capacity, NULL_ID, np.int32)
        self.customer_id = np.full(capacity, NULL_ID, np.int32)
        self.asset_id = np.full(capacity, NULL_ID, np.int32)

        self.z_active = np.zeros(max_zones, np.bool_)
        self.z_tenant = np.full(max_zones, NULL_ID, np.int32)
        self.z_area = np.full(max_zones, NULL_ID, np.int32)
        self.z_verts = np.zeros((max_zones, max_verts, 2), np.float32)
        self.z_nvert = np.zeros(max_zones, np.int32)
        # highest zone slot ever written + 1: the published table trims
        # to the next power of two above this (zone ids mint low-first)
        self.z_hi = 0
        self.z_condition = np.zeros(max_zones, np.int32)
        self.z_alert_code = np.full(max_zones, NULL_ID, np.int32)
        self.z_alert_level = np.full(max_zones, AlertLevel.WARNING, np.int32)

    # -- device rows --------------------------------------------------------

    def set_device_row(
        self,
        device_id: int,
        *,
        active: bool,
        tenant_id: int,
        device_type_id: int,
        assignment_id: int = NULL_ID,
        assignment_status: int = int(AssignmentStatus.NONE),
        area_id: int = NULL_ID,
        customer_id: int = NULL_ID,
        asset_id: int = NULL_ID,
    ) -> None:
        if not 0 <= device_id < self.capacity:
            raise ValidationError(
                f"device handle {device_id} outside registry capacity "
                f"{self.capacity}")
        with self._lock:
            self.active[device_id] = active
            self.tenant_id[device_id] = tenant_id
            self.device_type_id[device_id] = device_type_id
            self.assignment_id[device_id] = assignment_id
            self.assignment_status[device_id] = assignment_status
            self.area_id[device_id] = area_id
            self.customer_id[device_id] = customer_id
            self.asset_id[device_id] = asset_id
            self._dirty = True

    def clear_device_row(self, device_id: int) -> None:
        self.set_device_row(
            device_id,
            active=False,
            tenant_id=NULL_ID,
            device_type_id=NULL_ID,
        )

    # -- zone rows ----------------------------------------------------------

    def set_zone_row(
        self,
        zone_id: int,
        *,
        active: bool,
        tenant_id: int,
        area_id: int,
        verts_lonlat: Optional[np.ndarray] = None,
        condition: int = 0,
        alert_code: int = NULL_ID,
        alert_level: int = int(AlertLevel.WARNING),
    ) -> None:
        if not 0 <= zone_id < self.max_zones:
            raise ValidationError(
                f"zone handle {zone_id} outside capacity {self.max_zones}")
        # validate/pad before mutating anything, so a bad polygon can't
        # leave a half-written active row in the geofence table
        padded = None
        if verts_lonlat is not None:
            try:
                padded = pad_polygon(verts_lonlat, self.max_verts)
            except ValueError as e:
                raise ValidationError(str(e)) from e
        with self._lock:
            self.z_active[zone_id] = active
            self.z_tenant[zone_id] = tenant_id
            self.z_area[zone_id] = area_id
            if padded is not None:
                self.z_verts[zone_id] = padded
                self.z_nvert[zone_id] = len(verts_lonlat)
            self.z_condition[zone_id] = condition
            self.z_alert_code[zone_id] = alert_code
            self.z_alert_level[zone_id] = alert_level
            self.z_hi = max(self.z_hi, zone_id + 1)
            self._zones_dirty = True

    def clear_zone_row(self, zone_id: int) -> None:
        with self._lock:
            self.z_active[zone_id] = False
            self._zones_dirty = True

    # -- publication --------------------------------------------------------

    @property
    def dirty(self) -> bool:
        return self._dirty or self._zones_dirty

    def _tensor(self, rows: np.ndarray) -> torch.Tensor:
        # torch.tensor copies: a later row write never reaches a
        # published epoch, on the CPU as on the card
        return torch.tensor(rows, device=self.device)

    def publish_registry(self) -> Registry:
        """Current Registry epoch (rebuilt only when dirty, so
        steady-state steps reuse the resident tensors)."""
        with self._lock:
            if not self._dirty and self._registry_cache is not None:
                return self._registry_cache
            self.epoch += 1
            self._dirty = False
            t = self._tensor
            self._registry_cache = Registry(
                active=t(self.active),
                tenant_id=t(self.tenant_id),
                device_type_id=t(self.device_type_id),
                assignment_id=t(self.assignment_id),
                assignment_status=t(self.assignment_status),
                area_id=t(self.area_id),
                customer_id=t(self.customer_id),
                asset_id=t(self.asset_id),
                epoch=t(np.int32(self.epoch)),
            )
            return self._registry_cache

    def publish_zones(self) -> ZoneTable:
        """Current ZoneTable epoch (rebuilt only when dirty), trimmed to
        the smallest power of two covering every written slot, so a small
        zone set never pays the full-capacity geofence."""
        with self._lock:
            if not self._zones_dirty and self._zones_cache is not None:
                return self._zones_cache
            self._zones_dirty = False
            z = pow2_at_least(self.z_hi, cap=self.max_zones)
            t = self._tensor
            self._zones_cache = ZoneTable(
                active=t(self.z_active[:z]),
                tenant_id=t(self.z_tenant[:z]),
                area_id=t(self.z_area[:z]),
                verts=t(self.z_verts[:z]),
                nvert=t(self.z_nvert[:z]),
                condition=t(self.z_condition[:z]),
                alert_code=t(self.z_alert_code[:z]),
                alert_level=t(self.z_alert_level[:z]),
            )
            return self._zones_cache



# ---------------------------------------------------------------------------
# The management service
# ---------------------------------------------------------------------------

Listener = Callable[[str, object], None]


def _locked(fn):
    """Hold the service RLock for the duration of a read that iterates the
    entity dicts — ingest frontends read concurrently while management
    mutates, and ``sorted(dict.values())`` during an insert raises
    ``RuntimeError: dictionary changed size during iteration``."""

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        with self._lock:
            return fn(self, *args, **kwargs)

    return wrapper

_ASSIGN_STATUS = {
    "Active": AssignmentStatus.ACTIVE,
    "Missing": AssignmentStatus.MISSING,
    "Released": AssignmentStatus.RELEASED,
}



def _check_fields(entity, fields) -> None:
    """Reject unknown field names BEFORE any mutation, so a bad update
    cannot leave an entity half-modified."""
    for k in fields:
        if not hasattr(entity, k):
            raise ValidationError(f"unknown {type(entity).__name__} field {k}")


class DeviceManagement:
    """Per-tenant device model service over a shared mirror + identity map.

    Reference: one ``MongoDeviceManagement`` per tenant engine
    (``MultitenantMicroservice.java:242-260`` spins engines per tenant);
    here tenants share the identity map and registry tensors (tenant id is a
    column), and each ``DeviceManagement`` instance is the scoped API for
    one tenant.
    """

    def __init__(self, tenant: str, identity: IdentityMap, mirror: RegistryMirror):
        self.tenant = tenant
        self.tenant_id = identity.tenant.mint(tenant)
        self.identity = identity
        self.mirror = mirror
        self._lock = threading.RLock()
        self._listeners: List[Listener] = []

        self.device_types: Dict[str, DeviceType] = {}
        self.devices: Dict[str, Device] = {}
        self.assignments: Dict[str, DeviceAssignment] = {}
        self.area_types: Dict[str, AreaType] = {}
        self.areas: Dict[str, Area] = {}
        self.customer_types: Dict[str, CustomerType] = {}
        self.customers: Dict[str, Customer] = {}
        self.zones: Dict[str, Zone] = {}
        self.device_groups: Dict[str, DeviceGroup] = {}
        self.alarms: Dict[str, DeviceAlarm] = {}
        # device token -> its assignment tokens, in the insertion order of
        # ``assignments`` (see _active_assignment)
        self._device_assignments: Dict[str, List[str]] = {}

    # -- listeners (DeviceManagementTriggers analog) ------------------------

    def add_listener(self, listener: Listener) -> None:
        self._listeners.append(listener)

    def _notify(self, kind: str, entity: object) -> None:
        for listener in self._listeners:
            try:
                listener(kind, entity)
            except Exception:  # listener failures never poison the store
                logger.exception(
                    "device-management listener failed for %s", kind
                )

    # -- device types -------------------------------------------------------

    def create_device_type(self, token: Optional[str] = None, **fields) -> DeviceType:
        with self._lock:
            token = token or mint_token("type")
            require(token not in self.device_types, DuplicateToken(f"device type {token}"))
            dt = DeviceType(token=token, **fields)
            require(bool(dt.name), ValidationError("device type requires a name"))
            self.device_types[token] = dt
            self.identity.device_type.mint(self._scoped(token))
            self._notify("deviceType.created", dt)
            return dt

    def get_device_type(self, token: str) -> DeviceType:
        dt = self.device_types.get(token)
        require(dt is not None, EntityNotFound(f"device type {token}"))
        return dt

    def update_device_type(self, token: str, **fields) -> DeviceType:
        with self._lock:
            dt = self.get_device_type(token)
            _check_fields(dt, fields)
            for k, v in fields.items():
                setattr(dt, k, v)
            dt.touch()
            self._notify("deviceType.updated", dt)
            return dt

    @_locked
    def list_device_types(self, criteria: Optional[SearchCriteria] = None) -> SearchResults[DeviceType]:
        return paged(sorted(self.device_types.values(), key=lambda d: d.token), criteria)

    def delete_device_type(self, token: str) -> DeviceType:
        with self._lock:
            dt = self.get_device_type(token)
            used = [d for d in self.devices.values() if d.device_type == token]
            require(not used, ValidationError(f"device type {token} in use by {len(used)} devices"))
            del self.device_types[token]
            self._notify("deviceType.deleted", dt)
            return dt

    # commands (reference IDeviceManagement.createDeviceCommand etc.)

    def create_device_command(
        self, type_token: str, token: Optional[str] = None, **fields
    ) -> DeviceCommand:
        with self._lock:
            dt = self.get_device_type(type_token)
            token = token or mint_token("cmd")
            require(token not in dt.commands, DuplicateToken(f"command {token}"))
            cmd = DeviceCommand(token=token, **fields)
            require(bool(cmd.name), ValidationError("command requires a name"))
            dt.commands[token] = cmd
            self.identity.command.mint(self._scoped(token))
            self._notify("deviceCommand.created", cmd)
            return cmd

    def get_device_command(self, type_token: str, token: str) -> DeviceCommand:
        dt = self.get_device_type(type_token)
        cmd = dt.commands.get(token)
        require(cmd is not None, EntityNotFound(f"command {token}"))
        return cmd

    @_locked
    def list_device_commands(self, type_token: str) -> List[DeviceCommand]:
        return sorted(self.get_device_type(type_token).commands.values(), key=lambda c: c.token)

    def delete_device_command(self, type_token: str, token: str) -> DeviceCommand:
        with self._lock:
            dt = self.get_device_type(type_token)
            cmd = dt.commands.pop(token, None)
            require(cmd is not None, EntityNotFound(f"command {token}"))
            return cmd

    # statuses

    def create_device_status(
        self, type_token: str, token: Optional[str] = None, **fields
    ) -> DeviceStatus:
        with self._lock:
            dt = self.get_device_type(type_token)
            token = token or mint_token("status")
            require(token not in dt.statuses, DuplicateToken(f"status {token}"))
            st = DeviceStatus(token=token, **fields)
            dt.statuses[token] = st
            return st

    @_locked
    def list_device_statuses(self, type_token: str) -> List[DeviceStatus]:
        return sorted(self.get_device_type(type_token).statuses.values(), key=lambda s: s.token)

    # -- devices ------------------------------------------------------------

    def create_device(self, token: Optional[str] = None, **fields) -> Device:
        with self._lock:
            token = token or mint_token("dev")
            dev = Device(token=token, **fields)
            require(
                dev.device_type in self.device_types,
                InvalidReference(f"device type {dev.device_type}"),
            )
            if dev.parent_device is not None:
                require(
                    dev.parent_device in self.devices,
                    InvalidReference(f"parent device {dev.parent_device}"),
                )
            # Device tokens are GLOBAL (the ingest edge resolves raw tokens
            # with no tenant context, like Kafka keying on the raw token).
            # All device creations — across every tenant's service instance —
            # serialize on the mirror's creation lock so the uniqueness
            # check, the mint and the liveness write are one atomic step
            # (two tenants racing on one token cannot both claim the
            # handle).  A handle whose mirror row is inactive is a tombstone
            # of a deleted device: recreating that token reuses the handle
            # (same token == same device; tenant-scoped queries keep the old
            # tenant's history invisible to the new owner).
            with self.mirror.creation_lock:
                existing = self.identity.device.lookup(token)
                require(
                    existing == NULL_ID or not self.mirror.active[existing],
                    DuplicateToken(f"device {token}"),
                )
                device_id = self.identity.device.mint(token)
                # Mirror-write before committing to the store so a capacity
                # failure can't leave a device without a registry row.
                self.mirror.set_device_row(
                    device_id,
                    active=True,
                    tenant_id=self.tenant_id,
                    device_type_id=self.identity.device_type.lookup(
                        self._scoped(dev.device_type)
                    ),
                )
            self.devices[token] = dev
            self._notify("device.created", dev)
            return dev

    def get_device(self, token: str) -> Device:
        dev = self.devices.get(token)
        require(dev is not None, EntityNotFound(f"device {token}"))
        return dev

    def get_device_by_id(self, device_id: int) -> Device:
        token = self.identity.device.token_of(device_id)
        require(token is not None, EntityNotFound(f"device handle {device_id}"))
        return self.get_device(token)

    def update_device(self, token: str, **fields) -> Device:
        with self._lock:
            dev = self.get_device(token)
            _check_fields(dev, fields)
            if "device_type" in fields:
                require(
                    fields["device_type"] in self.device_types,
                    InvalidReference(f"device type {fields['device_type']}"),
                )
            for k, v in fields.items():
                setattr(dev, k, v)
            dev.touch()
            device_id = self.identity.device.lookup(token)
            self.mirror.set_device_row(
                device_id,
                active=True,
                tenant_id=self.tenant_id,
                device_type_id=self.identity.device_type.lookup(self._scoped(dev.device_type)),
                **self._assignment_cols(dev),
            )
            self._notify("device.updated", dev)
            return dev

    @_locked
    def list_devices(
        self,
        criteria: Optional[SearchCriteria] = None,
        device_type: Optional[str] = None,
        group: Optional[str] = None,
        excluding_assigned: bool = False,
    ) -> SearchResults[Device]:
        items = sorted(self.devices.values(), key=lambda d: d.token)
        if device_type is not None:
            items = [d for d in items if d.device_type == device_type]
        if group is not None:
            tokens = {t for t in self._group_device_tokens(group)}
            items = [d for d in items if d.token in tokens]
        if excluding_assigned:
            assigned = {
                a.device for a in self.assignments.values() if a.status != "Released"
            }
            items = [d for d in items if d.token not in assigned]
        return paged(items, criteria)

    def delete_device(self, token: str) -> Device:
        with self._lock:
            dev = self.get_device(token)
            active = self._active_assignment(token)
            require(active is None, ValidationError(f"device {token} has an active assignment"))
            del self.devices[token]
            device_id = self.identity.device.lookup(token)
            if device_id != NULL_ID:
                # Tombstone, don't free: the event store holds immutable rows
                # keyed by this handle, so recycling it onto an unrelated
                # token would graft the old device's history onto the new
                # one.  The handle stays bound to this token forever.
                self.mirror.clear_device_row(device_id)
            self._notify("device.deleted", dev)
            return dev

    # -- assignments --------------------------------------------------------

    def _active_assignment(self, device_token: str) -> Optional[DeviceAssignment]:
        """The device's first Active or Missing assignment in the
        insertion order of ``assignments``: what the reference's scan over
        every assignment returns, read from the per-device index (an
        assignment never moves to another device, so each device's list
        keeps the dict's order)."""
        for token in self._device_assignments.get(device_token, ()):
            a = self.assignments[token]
            if a.status in ("Active", "Missing"):
                return a
        return None

    def reindex(self) -> None:
        """Rebuild the per-device assignment index from ``assignments``
        (after the checkpoint restores the dict in place)."""
        with self._lock:
            index: Dict[str, List[str]] = {}
            for token, a in self.assignments.items():
                index.setdefault(a.device, []).append(token)
            self._device_assignments = index

    def create_device_assignment(
        self, token: Optional[str] = None, **fields
    ) -> DeviceAssignment:
        with self._lock:
            token = token or mint_token("asgn")
            require(token not in self.assignments, DuplicateToken(f"assignment {token}"))
            a = DeviceAssignment(token=token, **fields)
            require(a.device in self.devices, InvalidReference(f"device {a.device}"))
            require(
                self._active_assignment(a.device) is None,
                ValidationError(f"device {a.device} already has an active assignment"),
            )
            if a.customer is not None:
                require(a.customer in self.customers, InvalidReference(f"customer {a.customer}"))
            if a.area is not None:
                require(a.area in self.areas, InvalidReference(f"area {a.area}"))
            require(a.status in _ASSIGN_STATUS, ValidationError(f"bad status {a.status}"))
            self.assignments[token] = a
            self._device_assignments.setdefault(a.device, []).append(token)
            self.identity.assignment.mint(self._scoped(token))
            self._sync_device_row(a.device)
            # Reference: DeviceManagementTriggers fires a StateChange event
            # into the pipeline on assignment create.
            self._notify("assignment.created", a)
            return a

    def get_device_assignment(self, token: str) -> DeviceAssignment:
        a = self.assignments.get(token)
        require(a is not None, EntityNotFound(f"assignment {token}"))
        return a

    @_locked
    def get_active_assignment(self, device_token: str) -> Optional[DeviceAssignment]:
        self.get_device(device_token)
        return self._active_assignment(device_token)

    def update_device_assignment(self, token: str, **fields) -> DeviceAssignment:
        with self._lock:
            a = self.get_device_assignment(token)
            # An assignment is bound to its device for life (reference
            # invariant: reassignment = release + create).
            require(
                "device" not in fields or fields["device"] == a.device,
                ValidationError("assignment cannot move to another device"),
            )
            if fields.get("customer") is not None:
                require(
                    fields["customer"] in self.customers,
                    InvalidReference(f"customer {fields['customer']}"),
                )
            if fields.get("area") is not None:
                require(fields["area"] in self.areas, InvalidReference(f"area {fields['area']}"))
            _check_fields(a, fields)
            require(
                fields.get("status", a.status) in _ASSIGN_STATUS,
                ValidationError(f"bad status {fields.get('status')}"),
            )
            for k, v in fields.items():
                setattr(a, k, v)
            a.touch()
            self._sync_device_row(a.device)
            self._notify("assignment.updated", a)
            return a

    def release_device_assignment(self, token: str) -> DeviceAssignment:
        """End an assignment (reference: ``endDeviceAssignment``)."""
        with self._lock:
            a = self.get_device_assignment(token)
            a.status = "Released"
            a.released_date_s = now_s()
            a.touch()
            self._sync_device_row(a.device)
            self._notify("assignment.released", a)
            return a

    def mark_missing(self, token: str) -> DeviceAssignment:
        """Presence manager hook (reference: DevicePresenceManager state change)."""
        return self.update_device_assignment(token, status="Missing")

    @_locked
    def list_device_assignments(
        self,
        criteria: Optional[SearchCriteria] = None,
        device: Optional[str] = None,
        customer: Optional[str] = None,
        area: Optional[str] = None,
        asset: Optional[str] = None,
        status: Optional[str] = None,
    ) -> SearchResults[DeviceAssignment]:
        items = sorted(self.assignments.values(), key=lambda a: a.token)
        if device is not None:
            items = [a for a in items if a.device == device]
        if customer is not None:
            items = [a for a in items if a.customer == customer]
        if area is not None:
            items = [a for a in items if a.area == area]
        if asset is not None:
            items = [a for a in items if a.asset == asset]
        if status is not None:
            items = [a for a in items if a.status == status]
        return paged(items, criteria)

    def delete_device_assignment(self, token: str) -> DeviceAssignment:
        with self._lock:
            a = self.get_device_assignment(token)
            del self.assignments[token]
            tokens = self._device_assignments[a.device]
            tokens.remove(token)
            if not tokens:
                del self._device_assignments[a.device]
            self._sync_device_row(a.device)
            self._notify("assignment.deleted", a)
            return a

    def _assignment_cols(self, dev: Device) -> dict:
        a = self._active_assignment(dev.token)
        if a is None:
            return dict(
                assignment_id=NULL_ID,
                assignment_status=int(AssignmentStatus.NONE),
                area_id=NULL_ID,
                customer_id=NULL_ID,
                asset_id=NULL_ID,
            )
        return dict(
            assignment_id=self.identity.assignment.lookup(self._scoped(a.token)),
            assignment_status=int(_ASSIGN_STATUS[a.status]),
            area_id=(
                self.identity.area.lookup(self._scoped(a.area)) if a.area else NULL_ID
            ),
            customer_id=(
                self.identity.customer.lookup(self._scoped(a.customer))
                if a.customer
                else NULL_ID
            ),
            asset_id=(
                self.identity.asset.mint(self._scoped(a.asset)) if a.asset else NULL_ID
            ),
        )

    def _sync_device_row(self, device_token: str) -> None:
        dev = self.devices.get(device_token)
        if dev is None:
            return
        device_id = self.identity.device.lookup(device_token)
        if device_id == NULL_ID:
            return
        self.mirror.set_device_row(
            device_id,
            active=True,
            tenant_id=self.tenant_id,
            device_type_id=self.identity.device_type.lookup(self._scoped(dev.device_type)),
            **self._assignment_cols(dev),
        )

    # -- areas + area types -------------------------------------------------

    def create_area_type(self, token: Optional[str] = None, **fields) -> AreaType:
        with self._lock:
            token = token or mint_token("areatype")
            require(token not in self.area_types, DuplicateToken(f"area type {token}"))
            at = AreaType(token=token, **fields)
            self.area_types[token] = at
            self.identity.area_type.mint(self._scoped(token))
            return at

    def get_area_type(self, token: str) -> AreaType:
        at = self.area_types.get(token)
        require(at is not None, EntityNotFound(f"area type {token}"))
        return at

    @_locked
    def list_area_types(self, criteria: Optional[SearchCriteria] = None) -> SearchResults[AreaType]:
        return paged(sorted(self.area_types.values(), key=lambda a: a.token), criteria)

    def create_area(self, token: Optional[str] = None, **fields) -> Area:
        with self._lock:
            token = token or mint_token("area")
            require(token not in self.areas, DuplicateToken(f"area {token}"))
            area = Area(token=token, **fields)
            require(
                area.area_type in self.area_types,
                InvalidReference(f"area type {area.area_type}"),
            )
            if area.parent_area is not None:
                require(
                    area.parent_area in self.areas,
                    InvalidReference(f"parent area {area.parent_area}"),
                )
            self.areas[token] = area
            self.identity.area.mint(self._scoped(token))
            return area

    def get_area(self, token: str) -> Area:
        area = self.areas.get(token)
        require(area is not None, EntityNotFound(f"area {token}"))
        return area

    def update_area(self, token: str, **fields) -> Area:
        with self._lock:
            area = self.get_area(token)
            _check_fields(area, fields)
            for k, v in fields.items():
                setattr(area, k, v)
            area.touch()
            return area

    @_locked
    def list_areas(
        self,
        criteria: Optional[SearchCriteria] = None,
        parent: Optional[str] = None,
        root_only: bool = False,
    ) -> SearchResults[Area]:
        items = sorted(self.areas.values(), key=lambda a: a.token)
        if parent is not None:
            items = [a for a in items if a.parent_area == parent]
        elif root_only:
            items = [a for a in items if a.parent_area is None]
        return paged(items, criteria)

    @_locked
    def area_tree(self) -> List[dict]:
        """Nested area hierarchy (reference: ``getAreasTree`` REST helper)."""

        def node(area: Area) -> dict:
            children = [a for a in self.areas.values() if a.parent_area == area.token]
            return {
                "token": area.token,
                "name": area.name,
                "children": [node(c) for c in sorted(children, key=lambda a: a.token)],
            }

        roots = [a for a in self.areas.values() if a.parent_area is None]
        return [node(a) for a in sorted(roots, key=lambda a: a.token)]

    def delete_area(self, token: str) -> Area:
        with self._lock:
            area = self.get_area(token)
            kids = [a for a in self.areas.values() if a.parent_area == token]
            require(not kids, ValidationError(f"area {token} has child areas"))
            used = [a for a in self.assignments.values() if a.area == token]
            require(not used, ValidationError(f"area {token} referenced by assignments"))
            for z in [z for z in self.zones.values() if z.area == token]:
                self.delete_zone(z.token)
            del self.areas[token]
            return area

    # -- customers + customer types -----------------------------------------

    def create_customer_type(self, token: Optional[str] = None, **fields) -> CustomerType:
        with self._lock:
            token = token or mint_token("custtype")
            require(token not in self.customer_types, DuplicateToken(f"customer type {token}"))
            ct = CustomerType(token=token, **fields)
            self.customer_types[token] = ct
            self.identity.customer_type.mint(self._scoped(token))
            return ct

    def get_customer_type(self, token: str) -> CustomerType:
        ct = self.customer_types.get(token)
        require(ct is not None, EntityNotFound(f"customer type {token}"))
        return ct

    @_locked
    def list_customer_types(
        self, criteria: Optional[SearchCriteria] = None
    ) -> SearchResults[CustomerType]:
        return paged(sorted(self.customer_types.values(), key=lambda c: c.token), criteria)

    def create_customer(self, token: Optional[str] = None, **fields) -> Customer:
        with self._lock:
            token = token or mint_token("cust")
            require(token not in self.customers, DuplicateToken(f"customer {token}"))
            c = Customer(token=token, **fields)
            require(
                c.customer_type in self.customer_types,
                InvalidReference(f"customer type {c.customer_type}"),
            )
            if c.parent_customer is not None:
                require(
                    c.parent_customer in self.customers,
                    InvalidReference(f"parent customer {c.parent_customer}"),
                )
            self.customers[token] = c
            self.identity.customer.mint(self._scoped(token))
            return c

    def get_customer(self, token: str) -> Customer:
        c = self.customers.get(token)
        require(c is not None, EntityNotFound(f"customer {token}"))
        return c

    @_locked
    def list_customers(
        self, criteria: Optional[SearchCriteria] = None, parent: Optional[str] = None
    ) -> SearchResults[Customer]:
        items = sorted(self.customers.values(), key=lambda c: c.token)
        if parent is not None:
            items = [c for c in items if c.parent_customer == parent]
        return paged(items, criteria)

    def delete_customer(self, token: str) -> Customer:
        with self._lock:
            c = self.get_customer(token)
            kids = [x for x in self.customers.values() if x.parent_customer == token]
            require(not kids, ValidationError(f"customer {token} has children"))
            used = [a for a in self.assignments.values() if a.customer == token]
            require(not used, ValidationError(f"customer {token} referenced by assignments"))
            del self.customers[token]
            return c

    # -- zones ---------------------------------------------------------------

    def create_zone(self, token: Optional[str] = None, **fields) -> Zone:
        with self._lock:
            token = token or mint_token("zone")
            require(token not in self.zones, DuplicateToken(f"zone {token}"))
            z = Zone(token=token, **fields)
            require(z.area in self.areas, InvalidReference(f"area {z.area}"))
            self._validate_zone_bounds(z.bounds)
            # Mirror-write before committing to the store (a capacity
            # failure must not leave a zone without a geofence row).
            zone_id = self.identity.zone.mint(self._scoped(token))
            try:
                self._sync_zone_row(zone_id, z)
            except ValidationError:
                self.identity.zone.free(self._scoped(token))
                raise
            self.zones[token] = z
            self._notify("zone.created", z)
            return z

    def get_zone(self, token: str) -> Zone:
        z = self.zones.get(token)
        require(z is not None, EntityNotFound(f"zone {token}"))
        return z

    def update_zone(self, token: str, **fields) -> Zone:
        with self._lock:
            z = self.get_zone(token)
            _check_fields(z, fields)
            if "bounds" in fields:
                self._validate_zone_bounds(fields["bounds"])
            if "area" in fields:
                require(fields["area"] in self.areas, InvalidReference(f"area {fields['area']}"))
            for k, v in fields.items():
                setattr(z, k, v)
            z.touch()
            self._sync_zone_row(self.identity.zone.lookup(self._scoped(token)), z)
            self._notify("zone.updated", z)
            return z

    def _validate_zone_bounds(self, bounds) -> None:
        require(len(bounds) >= 3, ValidationError("zone needs >= 3 bound points"))
        require(
            len(bounds) <= self.mirror.max_verts,
            ValidationError(
                f"zone has {len(bounds)} points > max {self.mirror.max_verts}"
            ),
        )

    @_locked
    def list_zones(
        self, criteria: Optional[SearchCriteria] = None, area: Optional[str] = None
    ) -> SearchResults[Zone]:
        items = sorted(self.zones.values(), key=lambda z: z.token)
        if area is not None:
            items = [z for z in items if z.area == area]
        return paged(items, criteria)

    def delete_zone(self, token: str) -> Zone:
        with self._lock:
            z = self.zones.pop(token, None)
            require(z is not None, EntityNotFound(f"zone {token}"))
            scoped = self._scoped(token)
            zone_id = self.identity.zone.lookup(scoped)
            if zone_id != NULL_ID:
                self.mirror.clear_zone_row(zone_id)
                self.identity.zone.free(scoped)
            self._notify("zone.deleted", z)
            return z

    def _sync_zone_row(self, zone_id: int, z: Zone) -> None:
        # bounds are (lat, lon); device verts are (lon, lat) == (x, y).
        verts = np.asarray([(lon, lat) for (lat, lon) in z.bounds], np.float32)
        self.mirror.set_zone_row(
            zone_id,
            active=True,
            tenant_id=self.tenant_id,
            area_id=self.identity.area.lookup(self._scoped(z.area)),
            verts_lonlat=verts,
            condition=0 if z.condition == "inside" else 1,
            alert_code=self.identity.alert_type.mint(self._scoped(z.alert_type)),
            alert_level=int(z.alert_level),
        )

    # -- device groups -------------------------------------------------------

    def create_device_group(self, token: Optional[str] = None, **fields) -> DeviceGroup:
        with self._lock:
            token = token or mint_token("group")
            require(token not in self.device_groups, DuplicateToken(f"group {token}"))
            g = DeviceGroup(token=token, **fields)
            self.device_groups[token] = g
            self.identity.device_group.mint(self._scoped(token))
            return g

    def get_device_group(self, token: str) -> DeviceGroup:
        g = self.device_groups.get(token)
        require(g is not None, EntityNotFound(f"group {token}"))
        return g

    @_locked
    def list_device_groups(
        self, criteria: Optional[SearchCriteria] = None, role: Optional[str] = None
    ) -> SearchResults[DeviceGroup]:
        items = sorted(self.device_groups.values(), key=lambda g: g.token)
        if role is not None:
            items = [g for g in items if role in g.roles]
        return paged(items, criteria)

    def add_device_group_elements(
        self, token: str, elements: List[DeviceGroupElement]
    ) -> DeviceGroup:
        with self._lock:
            g = self.get_device_group(token)
            for el in elements:
                if el.device is not None:
                    require(el.device in self.devices, InvalidReference(f"device {el.device}"))
                elif el.nested_group is not None:
                    require(
                        el.nested_group in self.device_groups,
                        InvalidReference(f"group {el.nested_group}"),
                    )
                    require(el.nested_group != token, ValidationError("group cannot nest itself"))
                else:
                    raise ValidationError("element needs a device or nested group")
                g.elements.append(el)
            g.touch()
            return g

    def remove_device_group_elements(
        self, token: str, elements: List[DeviceGroupElement]
    ) -> DeviceGroup:
        with self._lock:
            g = self.get_device_group(token)
            keys = {(e.device, e.nested_group) for e in elements}
            g.elements = [e for e in g.elements if (e.device, e.nested_group) not in keys]
            g.touch()
            return g

    def delete_device_group(self, token: str) -> DeviceGroup:
        with self._lock:
            g = self.device_groups.pop(token, None)
            require(g is not None, EntityNotFound(f"group {token}"))
            scoped = self._scoped(token)
            if self.identity.device_group.lookup(scoped) != NULL_ID:
                self.identity.device_group.free(scoped)
            return g

    def _group_device_tokens(self, token: str, _seen=None) -> List[str]:
        """Flatten a group (recursing nested groups) into device tokens.

        Reference: ``BatchUtils.getDevicesFromGroup`` expands groups for
        batch command targeting.
        """
        _seen = _seen if _seen is not None else set()
        if token in _seen:
            return []
        _seen.add(token)
        g = self.get_device_group(token)
        out: List[str] = []
        for el in g.elements:
            if el.device is not None:
                out.append(el.device)
            elif el.nested_group is not None and el.nested_group in self.device_groups:
                out.extend(self._group_device_tokens(el.nested_group, _seen))
        return out

    @_locked
    def group_devices(self, token: str) -> List[Device]:
        return [self.devices[t] for t in self._group_device_tokens(token) if t in self.devices]

    # -- alarms --------------------------------------------------------------

    def create_device_alarm(self, token: Optional[str] = None, **fields) -> DeviceAlarm:
        with self._lock:
            token = token or mint_token("alarm")
            require(token not in self.alarms, DuplicateToken(f"alarm {token}"))
            al = DeviceAlarm(token=token, **fields)
            require(al.device in self.devices, InvalidReference(f"device {al.device}"))
            self.alarms[token] = al
            self._notify("alarm.created", al)
            return al

    def get_device_alarm(self, token: str) -> DeviceAlarm:
        al = self.alarms.get(token)
        require(al is not None, EntityNotFound(f"alarm {token}"))
        return al

    def acknowledge_alarm(self, token: str) -> DeviceAlarm:
        with self._lock:
            al = self.get_device_alarm(token)
            al.state = "Acknowledged"
            al.acknowledged_date_s = now_s()
            al.touch()
            return al

    def resolve_alarm(self, token: str) -> DeviceAlarm:
        with self._lock:
            al = self.get_device_alarm(token)
            al.state = "Resolved"
            al.resolved_date_s = now_s()
            al.touch()
            return al

    @_locked
    def list_device_alarms(
        self,
        criteria: Optional[SearchCriteria] = None,
        device: Optional[str] = None,
        state: Optional[str] = None,
    ) -> SearchResults[DeviceAlarm]:
        items = sorted(self.alarms.values(), key=lambda a: a.token)
        if device is not None:
            items = [a for a in items if a.device == device]
        if state is not None:
            items = [a for a in items if a.state == state]
        return paged(items, criteria)

    def delete_device_alarm(self, token: str) -> DeviceAlarm:
        with self._lock:
            al = self.alarms.pop(token, None)
            require(al is not None, EntityNotFound(f"alarm {token}"))
            return al

    # -- helpers -------------------------------------------------------------

    def _scoped(self, token: str) -> str:
        """Tenant-scope a token for the shared handle spaces.

        Device tokens stay global (the ingest edge resolves raw device
        tokens without knowing the tenant — same as Kafka keying on the raw
        token); every other namespace is tenant-scoped so tenants can reuse
        names (reference: per-tenant Mongo databases give the same isolation).
        """
        return f"{self.tenant}:{token}"

    def handle_for(self, space: str, token: str) -> int:
        """Dense handle of a tenant-scoped entity (assignment/area/customer/
        asset/device_type…) — what the enrichment columns carry.  Device
        tokens are global: use ``identity.device.lookup`` directly.
        Returns ``NULL_ID`` if unknown."""
        return getattr(self.identity, space).lookup(self._scoped(token))

    def alert_type_handle(self, name: str) -> int:
        return self.identity.alert_type.mint(self._scoped(name))
