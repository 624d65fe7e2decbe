"""Presence detection: the vectorized missing-device sweep.

Counterpart of ``sitewhere_tpu/state/presence.py`` (``presence_sweep``
:44, ``state_changes_for`` :61).  A device is *newly missing* when it has
seen at least one event, is not already flagged, and its last event is
older than the missing interval.  The background ``PresenceManager``
thread waits for the slice that ports the runtime.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from sitewhere_tpu_torch.device import DeviceLike, resolve_device
from sitewhere_tpu_torch.ids import NULL_ID
from sitewhere_tpu_torch.schema import DeviceState, EventBatch, EventType

STATE_CHANGE_PRESENCE_MISSING = 1


def presence_sweep(state: DeviceState, now_s: int,
                   missing_after_s: int) -> Tuple[DeviceState, torch.Tensor]:
    """One presence pass: ``(new_state, newly_missing bool[D])``."""
    has_events = state.last_event_type != NULL_ID
    overdue = (now_s - state.last_event_ts_s) > missing_after_s
    newly_missing = has_events & overdue & ~state.presence_missing
    return (state.replace(
        presence_missing=state.presence_missing | newly_missing),
        newly_missing)


def state_changes_for(device_ids: np.ndarray, tenant_ids: np.ndarray,
                      now_s: int, device: DeviceLike = None) -> EventBatch:
    """A presence STATE_CHANGE batch for ``device_ids`` (aligned row for
    row with ``tenant_ids``), system-generated (``update_state=False``)."""
    device = resolve_device(device)
    width = int(np.asarray(device_ids).size)
    full = lambda v: torch.full((width,), int(v), dtype=torch.int32,  # noqa: E731
                                device=device)
    return EventBatch.empty(width, device=device).replace(
        valid=torch.ones(width, dtype=torch.bool, device=device),
        device_id=torch.as_tensor(np.asarray(device_ids, np.int32),
                                  device=device),
        tenant_id=torch.as_tensor(np.asarray(tenant_ids, np.int32),
                                  device=device),
        event_type=full(EventType.STATE_CHANGE),
        ts_s=full(now_s),
        alert_code=full(STATE_CHANGE_PRESENCE_MISSING),
        update_state=torch.zeros(width, dtype=torch.bool, device=device),
    )
