"""DeviceStateManager: owner of the DeviceState epoch and its packed twin.

Counterpart of the epoch plumbing of ``sitewhere_tpu/state/manager.py``:
``current`` / ``current_packed``, the lease and commit of the packed
carry that the K-deep ring threads through its steps, the presence
reconciliation on commit (``_merge_presence`` :198), the presence sweep
with its tenant lookup and the single-device and summary queries.  ``TenantPartitions`` and the
migration import/export wait for later slices.

Epochs are immutable: a commit or a sweep replaces the held tensors and
never writes into them, so a snapshot taken under the lock stays valid
after the lock is released.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from sitewhere_tpu_torch.device import DeviceLike, resolve_device
from sitewhere_tpu_torch.ids import NULL_ID, IdentityMap
from sitewhere_tpu_torch.pipeline.packed import (
    PRESENCE_ROW,
    PackedState,
    pack_state,
    unpack_state,
)
from sitewhere_tpu_torch.schema import DeviceState, EventBatch
from sitewhere_tpu_torch.state.presence import presence_sweep, state_changes_for


def _merge_presence(new_si: torch.Tensor, cur_si: torch.Tensor,
                    present_now: torch.Tensor) -> torch.Tensor:
    """Packed-form presence reconciliation: a concurrent sweep's missing
    flags survive unless the step merged an event for the device."""
    merged = (new_si[PRESENCE_ROW] != 0) | (
        (cur_si[PRESENCE_ROW] != 0) & ~present_now)
    out = new_si.clone()
    out[PRESENCE_ROW] = merged.to(new_si.dtype)
    return out


class DeviceStateManager:
    """Holds the authoritative :class:`DeviceState` epoch.

    Exactly one of the unpacked epoch and its packed twin may be stale
    (None); each is rebuilt from the other on demand.
    ``tenant_id_of_device`` maps device ids (an int32 numpy array) to
    their tenants for the presence STATE_CHANGE rows; the registry
    mirror's tenant column is the source of truth.  Without it those
    rows carry tenant 0.
    """

    def __init__(self, capacity: int, identity: Optional[IdentityMap] = None,
                 num_mtype_slots: int = 8,
                 tenant_id_of_device: Optional[
                     Callable[[np.ndarray], np.ndarray]] = None,
                 num_ewma_scales: int = 3,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.identity = identity if identity is not None else IdentityMap()
        self._tenant_id_of_device = tenant_id_of_device
        self._lock = threading.RLock()
        self._state: Optional[DeviceState] = DeviceState.empty(
            capacity, num_mtype_slots, num_ewma_scales, device=self.device)
        self._packed: Optional[PackedState] = None
        # count of lease_packed() calls
        self.lease_generation = 0

    # -- epoch plumbing ----------------------------------------------------

    @property
    def current(self) -> DeviceState:
        with self._lock:
            if self._state is None:
                self._state = unpack_state(self._packed)
            return self._state

    @property
    def current_packed(self) -> PackedState:
        """The packed epoch (packed lazily after an unpacked commit)."""
        with self._lock:
            if self._packed is None:
                self._packed = pack_state(self.current)
            return self._packed

    def lease_packed(self) -> Tuple[PackedState, DeviceState]:
        """Hand the packed epoch to a chain: ``(packed, lease_token)``.

        The unpacked twin is materialized first (views of the packed
        buffers, which no step writes into), so readers arriving during
        the chain see the pre-chain epoch.  Pass the token to
        :meth:`commit_packed`; it tells whether anything (a presence
        sweep, a commit) replaced the epoch during the chain.  If the
        chain fails before its commit, the manager still holds the
        pre-chain epoch.
        """
        with self._lock:
            packed = self.current_packed
            if self._state is None:
                self._state = unpack_state(packed)
            self._packed = None
            self.lease_generation += 1
            return packed, self._state

    def commit_packed(self, new_packed: PackedState,
                      present_now: torch.Tensor,
                      read_epoch: Optional[PackedState] = None,
                      lease_token: Optional[DeviceState] = None) -> None:
        """Adopt a packed step's (or chain's) output carry, re-applying the
        ``presence_missing`` flags a concurrent sweep set for devices the
        step did not merge (``present_now``: its presence map, OR'd over
        a chain).

        Pass ``read_epoch`` (the packed epoch a single step read, from
        :attr:`current_packed`) or ``lease_token`` (from
        :meth:`lease_packed`, for a chain): when the epoch is still the one
        the step started from, nothing intervened and the merge is
        skipped."""
        with self._lock:
            unchanged = (
                (read_epoch is not None and self._packed is read_epoch)
                or (lease_token is not None and self._state is lease_token))
            if not unchanged:
                cur = self.current_packed
                new_packed = new_packed.replace(
                    si=_merge_presence(new_packed.si, cur.si, present_now))
            self._packed = new_packed
            self._state = None

    def commit(self, new_state: DeviceState,
               batch: Optional[EventBatch] = None,
               accepted: Optional[torch.Tensor] = None,
               present_now: Optional[torch.Tensor] = None) -> None:
        """Adopt an unpacked step's output state, keeping a concurrent
        sweep's missing flags for devices the step did not merge: pass the
        step's ``present_now`` (``bool[capacity]``), or the ``batch`` it
        consumed plus its ``accepted`` mask to re-derive it; with neither,
        no merge."""
        with self._lock:
            current = self.current
            if current is not new_state and (
                    present_now is not None or batch is not None):
                cap = new_state.capacity
                if present_now is not None:
                    touched = present_now
                else:
                    # the step's merge mask: rejected and update_state=False
                    # rows never cleared presence in the step
                    merged_rows = (batch.valid & (batch.device_id >= 0)
                                   & batch.update_state)
                    if accepted is not None:
                        merged_rows = merged_rows & accepted
                    ids = torch.where(merged_rows & (batch.device_id < cap),
                                      batch.device_id, cap)
                    touched = torch.zeros(cap + 1, dtype=torch.bool,
                                          device=ids.device)
                    touched[ids.to(torch.int64)] = True
                    touched = touched[:cap]
                merged = new_state.presence_missing | (
                    current.presence_missing & ~touched)
                new_state = new_state.replace(presence_missing=merged)
            self._state = new_state
            self._packed = None

    # -- presence ----------------------------------------------------------

    def apply_presence_sweep(self, now_s: int,
                             missing_after_s: int) -> Optional[EventBatch]:
        """Run the sweep, adopt the flagged state, and build the
        STATE_CHANGE batch for newly-missing devices (None if none), each
        row carrying its device's tenant."""
        with self._lock:
            new_state, newly_missing = presence_sweep(
                self.current, now_s, missing_after_s)
            self._state = new_state
            self._packed = None
        idx = torch.nonzero(newly_missing).flatten().cpu().numpy()
        if idx.size == 0:
            return None
        idx = idx.astype(np.int32)
        if self._tenant_id_of_device is not None:
            tenant_ids = np.asarray(self._tenant_id_of_device(idx), np.int32)
        else:
            tenant_ids = np.zeros(idx.size, np.int32)
        return state_changes_for(idx, tenant_ids, now_s, device=self.device)

    # -- queries -----------------------------------------------------------

    def get_device_state(self, device_token: str) -> Dict[str, object]:
        device_id = self.identity.device.lookup(device_token)
        if device_id == NULL_ID:
            raise KeyError(f"no device {device_token!r}")
        return self.get_device_state_by_id(int(device_id))

    def get_device_state_by_id(self, device_id: int) -> Dict[str, object]:
        """Last-known state for one device, as a host dict."""
        with self._lock:
            s = self.current
        if not 0 <= device_id < s.capacity:
            raise KeyError(f"bad device id {device_id}")
        r = {f: getattr(s, f)[device_id].cpu().numpy()
             for f in s.__dataclass_fields__}
        row = {
            "device_id": device_id,
            "last_event_ts_s": int(r["last_event_ts_s"]),
            "last_event_type": int(r["last_event_type"]),
            "presence_missing": bool(r["presence_missing"]),
            "last_location": {
                "lat": float(r["last_lat"]),
                "lon": float(r["last_lon"]),
                "elevation": float(r["last_elevation"]),
                "ts_s": int(r["last_location_ts_s"]),
            },
            "last_alert": {
                "code": int(r["last_alert_code"]),
                "ts_s": int(r["last_alert_ts_s"]),
            },
            "last_values": r["last_values"].tolist(),
            "last_value_ts_s": r["last_value_ts_s"].tolist(),
        }
        if row["last_event_type"] == NULL_ID:
            row["last_event_type"] = None
        return row

    def summary(self) -> Dict[str, int]:
        with self._lock:
            s = self.current
        return {
            "devices_with_state": int((s.last_event_type != NULL_ID).sum()),
            "devices_missing": int(s.presence_missing.sum()),
        }
