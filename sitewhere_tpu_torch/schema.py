"""Core tensor schema: the data model the fused step computes over.

Counterpart of ``sitewhere_tpu/schema.py``.  The enums keep the same
integer values; the struct-of-array pytrees become dataclasses of
tensors, each with ``.empty(..., device=)`` and ``.replace(**fields)``.
Dtypes follow the reference: int32 ids and times, float32 values, bool
masks.  Index operands are widened to int64 only where a torch index op
needs them, never in the stored columns.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import torch

from sitewhere_tpu_torch.device import DeviceLike, resolve_device
from sitewhere_tpu_torch.ids import NULL_ID


class EventType(enum.IntEnum):
    MEASUREMENT = 0
    LOCATION = 1
    ALERT = 2
    COMMAND_INVOCATION = 3
    COMMAND_RESPONSE = 4
    STATE_CHANGE = 5


class AssignmentStatus(enum.IntEnum):
    NONE = 0
    ACTIVE = 1
    MISSING = 2
    RELEASED = 3


class AlertLevel(enum.IntEnum):
    INFO = 0
    WARNING = 1
    ERROR = 2
    CRITICAL = 3


class ComparisonOp(enum.IntEnum):
    GT = 0
    LT = 1
    GTE = 2
    LTE = 3
    EQ = 4
    NEQ = 5


class RuleKind(enum.IntEnum):
    INSTANT = 0       # current sample vs threshold
    WINDOW_MEAN = 1   # irregular-sampling EWMA (per-rule time-scale slot)
    RATE_PER_S = 2    # (v - prev_v) / dt vs threshold


class ZoneCondition(enum.IntEnum):
    ALERT_IF_INSIDE = 0
    ALERT_IF_OUTSIDE = 1


# Default EWMA half-lives (seconds), converted once to e-folding taus.
DEFAULT_EWMA_HALFLIVES_S = (60.0, 600.0, 3600.0)
_LN2 = 0.6931471805599453
DEFAULT_EWMA_TAUS = tuple(h / _LN2 for h in DEFAULT_EWMA_HALFLIVES_S)


def _i32(shape, fill, device):
    return torch.full(shape, int(fill), dtype=torch.int32, device=device)


def _f32(shape, fill, device):
    return torch.full(shape, float(fill), dtype=torch.float32, device=device)


def _bool(shape, fill, device):
    return torch.full(shape, bool(fill), dtype=torch.bool, device=device)


class _Tensors:
    """``replace`` and ``to`` for the schema dataclasses."""

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)

    def to(self, device: DeviceLike):
        device = resolve_device(device)
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)})


@dataclasses.dataclass(frozen=True)
class EventBatch(_Tensors):
    """A fixed-width batch of decoded device events (one row per event)."""

    valid: torch.Tensor        # bool[B]
    device_id: torch.Tensor    # int32[B]
    tenant_id: torch.Tensor    # int32[B]
    event_type: torch.Tensor   # int32[B]
    ts_s: torch.Tensor         # int32[B]
    ts_ns: torch.Tensor        # int32[B]
    mtype_id: torch.Tensor     # int32[B]
    value: torch.Tensor        # float32[B]
    lat: torch.Tensor          # float32[B]
    lon: torch.Tensor          # float32[B]
    elevation: torch.Tensor    # float32[B]
    alert_code: torch.Tensor   # int32[B]
    alert_level: torch.Tensor  # int32[B]
    command_id: torch.Tensor   # int32[B]
    payload_ref: torch.Tensor  # int32[B]
    update_state: torch.Tensor  # bool[B]

    @property
    def width(self) -> int:
        return self.valid.shape[-1]

    @classmethod
    def empty(cls, width: int, device: DeviceLike = None) -> "EventBatch":
        d = resolve_device(device)
        w = (width,)
        return cls(
            valid=_bool(w, False, d),
            device_id=_i32(w, NULL_ID, d),
            tenant_id=_i32(w, NULL_ID, d),
            event_type=_i32(w, 0, d),
            ts_s=_i32(w, 0, d),
            ts_ns=_i32(w, 0, d),
            mtype_id=_i32(w, NULL_ID, d),
            value=_f32(w, 0.0, d),
            lat=_f32(w, 0.0, d),
            lon=_f32(w, 0.0, d),
            elevation=_f32(w, 0.0, d),
            alert_code=_i32(w, NULL_ID, d),
            alert_level=_i32(w, 0, d),
            command_id=_i32(w, NULL_ID, d),
            payload_ref=_i32(w, NULL_ID, d),
            update_state=_bool(w, True, d),
        )


@dataclasses.dataclass(frozen=True)
class Registry(_Tensors):
    """Device + assignment columns, indexed by dense device id."""

    active: torch.Tensor             # bool[D]
    tenant_id: torch.Tensor          # int32[D]
    device_type_id: torch.Tensor     # int32[D]
    assignment_id: torch.Tensor      # int32[D]
    assignment_status: torch.Tensor  # int32[D]
    area_id: torch.Tensor            # int32[D]
    customer_id: torch.Tensor        # int32[D]
    asset_id: torch.Tensor           # int32[D]
    epoch: torch.Tensor              # int32[]

    @property
    def capacity(self) -> int:
        return self.active.shape[-1]

    @classmethod
    def empty(cls, capacity: int, device: DeviceLike = None) -> "Registry":
        d = resolve_device(device)
        c = (capacity,)
        return cls(
            active=_bool(c, False, d),
            tenant_id=_i32(c, NULL_ID, d),
            device_type_id=_i32(c, NULL_ID, d),
            assignment_id=_i32(c, NULL_ID, d),
            assignment_status=_i32(c, AssignmentStatus.NONE, d),
            area_id=_i32(c, NULL_ID, d),
            customer_id=_i32(c, NULL_ID, d),
            asset_id=_i32(c, NULL_ID, d),
            epoch=_i32((), 0, d),
        )


@dataclasses.dataclass(frozen=True)
class DeviceState(_Tensors):
    """Last-known state per device (+ per measurement slot, + per EWMA
    time-scale)."""

    last_event_ts_s: torch.Tensor      # int32[D]
    last_event_ts_ns: torch.Tensor     # int32[D]
    last_event_type: torch.Tensor      # int32[D]
    last_values: torch.Tensor          # float32[D, M]
    last_value_ts_s: torch.Tensor      # int32[D, M]
    last_value_ts_ns: torch.Tensor     # int32[D, M]
    last_lat: torch.Tensor             # float32[D]
    last_lon: torch.Tensor             # float32[D]
    last_elevation: torch.Tensor       # float32[D]
    last_location_ts_s: torch.Tensor   # int32[D]
    last_location_ts_ns: torch.Tensor  # int32[D]
    last_alert_code: torch.Tensor      # int32[D]
    last_alert_ts_s: torch.Tensor      # int32[D]
    last_alert_ts_ns: torch.Tensor     # int32[D]
    presence_missing: torch.Tensor     # bool[D]
    ewma_values: torch.Tensor          # float32[D, M, K]
    nonfinite_count: torch.Tensor      # int32[D]

    @property
    def capacity(self) -> int:
        return self.last_event_ts_s.shape[-1]

    @property
    def num_mtype_slots(self) -> int:
        return self.last_values.shape[-1]

    @property
    def num_ewma_scales(self) -> int:
        return self.ewma_values.shape[-1]

    @classmethod
    def empty(cls, capacity: int, num_mtype_slots: int = 8,
              num_ewma_scales: int = 3,
              device: DeviceLike = None) -> "DeviceState":
        d = resolve_device(device)
        c, cm = (capacity,), (capacity, num_mtype_slots)
        return cls(
            last_event_ts_s=_i32(c, 0, d),
            last_event_ts_ns=_i32(c, 0, d),
            last_event_type=_i32(c, NULL_ID, d),
            last_values=_f32(cm, 0.0, d),
            last_value_ts_s=_i32(cm, 0, d),
            last_value_ts_ns=_i32(cm, 0, d),
            last_lat=_f32(c, 0.0, d),
            last_lon=_f32(c, 0.0, d),
            last_elevation=_f32(c, 0.0, d),
            last_location_ts_s=_i32(c, 0, d),
            last_location_ts_ns=_i32(c, 0, d),
            last_alert_code=_i32(c, NULL_ID, d),
            last_alert_ts_s=_i32(c, 0, d),
            last_alert_ts_ns=_i32(c, 0, d),
            presence_missing=_bool(c, False, d),
            ewma_values=_f32(cm + (num_ewma_scales,), 0.0, d),
            nonfinite_count=_i32(c, 0, d),
        )


@dataclasses.dataclass(frozen=True)
class RuleTable(_Tensors):
    """Threshold rules, evaluated as one dense ``[B, R]`` pass."""

    active: torch.Tensor       # bool[R]
    tenant_id: torch.Tensor    # int32[R] — NULL_ID = all tenants
    mtype_id: torch.Tensor     # int32[R] — NULL_ID = all measurement types
    op: torch.Tensor           # int32[R] — ComparisonOp
    threshold: torch.Tensor    # float32[R]
    alert_code: torch.Tensor   # int32[R]
    alert_level: torch.Tensor  # int32[R]
    kind: torch.Tensor         # int32[R] — RuleKind
    window_idx: torch.Tensor   # int32[R] — EWMA time-scale slot
    ewma_tau_s: torch.Tensor   # float32[K]

    @property
    def capacity(self) -> int:
        return self.active.shape[-1]

    @property
    def num_ewma_scales(self) -> int:
        return self.ewma_tau_s.shape[-1]

    @classmethod
    def empty(cls, capacity: int, ewma_taus: tuple = DEFAULT_EWMA_TAUS,
              device: DeviceLike = None) -> "RuleTable":
        d = resolve_device(device)
        c = (capacity,)
        return cls(
            active=_bool(c, False, d),
            tenant_id=_i32(c, NULL_ID, d),
            mtype_id=_i32(c, NULL_ID, d),
            op=_i32(c, 0, d),
            threshold=_f32(c, 0.0, d),
            alert_code=_i32(c, NULL_ID, d),
            alert_level=_i32(c, 0, d),
            kind=_i32(c, 0, d),
            window_idx=_i32(c, 0, d),
            ewma_tau_s=torch.tensor(ewma_taus, dtype=torch.float32, device=d),
        )


@dataclasses.dataclass(frozen=True)
class ZoneTable(_Tensors):
    """Zone polygons padded to ``V`` vertices by repeating the last one."""

    active: torch.Tensor       # bool[Z]
    tenant_id: torch.Tensor    # int32[Z] — NULL_ID = all tenants
    area_id: torch.Tensor      # int32[Z] — NULL_ID = all areas
    verts: torch.Tensor        # float32[Z, V, 2] — (lon, lat)
    nvert: torch.Tensor        # int32[Z]
    condition: torch.Tensor    # int32[Z] — ZoneCondition
    alert_code: torch.Tensor   # int32[Z]
    alert_level: torch.Tensor  # int32[Z]

    @property
    def capacity(self) -> int:
        return self.active.shape[-1]

    @property
    def max_verts(self) -> int:
        return self.verts.shape[-2]

    @classmethod
    def empty(cls, capacity: int, max_verts: int = 16,
              device: DeviceLike = None) -> "ZoneTable":
        d = resolve_device(device)
        c = (capacity,)
        return cls(
            active=_bool(c, False, d),
            tenant_id=_i32(c, NULL_ID, d),
            area_id=_i32(c, NULL_ID, d),
            verts=_f32((capacity, max_verts, 2), 0.0, d),
            nvert=_i32(c, 0, d),
            condition=_i32(c, ZoneCondition.ALERT_IF_INSIDE, d),
            alert_code=_i32(c, NULL_ID, d),
            alert_level=_i32(c, AlertLevel.WARNING, d),
        )


def time_lt(a_s: torch.Tensor, a_ns: torch.Tensor, b_s: torch.Tensor,
            b_ns: torch.Tensor) -> torch.Tensor:
    """Lexicographic ``(s, ns) < (s, ns)`` without int64."""
    return (a_s < b_s) | ((a_s == b_s) & (a_ns < b_ns))


def pow2_at_least(n: int, floor: int = 8, cap: Optional[int] = None) -> int:
    """Smallest power of two >= max(n, floor), clamped to ``cap``."""
    p = floor
    while p < n:
        p *= 2
    return min(p, cap) if cap is not None else p
