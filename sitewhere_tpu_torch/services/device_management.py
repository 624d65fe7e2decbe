"""Device management: the registry mirror.

Counterpart of :class:`RegistryMirror` in
``sitewhere_tpu/services/device_management.py`` (:204-385): the
hot-path projection of the device and zone records, kept as host numpy
rows and published to the device as immutable
:class:`~sitewhere_tpu_torch.schema.Registry` /
:class:`~sitewhere_tpu_torch.schema.ZoneTable` epochs whenever they are
dirty, so the streaming step always reads a consistent epoch and a new
one becomes visible between batches, never within one.  The entity
service (``DeviceManagement``) waits for a later slice.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from sitewhere_tpu_torch.device import DeviceLike, resolve_device
from sitewhere_tpu_torch.ids import NULL_ID
from sitewhere_tpu_torch.ops.geo import pad_polygon
from sitewhere_tpu_torch.schema import (
    AlertLevel,
    AssignmentStatus,
    Registry,
    ZoneTable,
    pow2_at_least,
)
from sitewhere_tpu_torch.services.common import ValidationError


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
