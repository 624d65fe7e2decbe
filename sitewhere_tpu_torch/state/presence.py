"""Presence detection: the vectorized missing-device sweep.

Counterpart of ``sitewhere_tpu/state/presence.py`` (``presence_sweep``
:44, ``state_changes_for`` :61).  A device is *newly missing* when it has
seen at least one event, is not already flagged, and its last event is
older than the missing interval.  :class:`PresenceManager` (:86) runs
the sweep on a background thread.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from sitewhere_tpu_torch.device import DeviceLike, resolve_device
from sitewhere_tpu_torch.ids import NULL_ID
from sitewhere_tpu_torch.runtime.lifecycle import LifecycleComponent
from sitewhere_tpu_torch.schema import DeviceState, EventBatch, EventType

logger = logging.getLogger("sitewhere_tpu_torch.state.presence")

# StateChange codes carried in the alert_code column of STATE_CHANGE events.
STATE_CHANGE_PRESENCE_MISSING = 1
# Device crossed the numeric-integrity quarantine threshold (cumulative
# NaN/Inf rows, the dispatcher's _scan_quarantine).
STATE_CHANGE_QUARANTINED = 2


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
                      now_s: int, device: DeviceLike = None,
                      code: int = STATE_CHANGE_PRESENCE_MISSING
                      ) -> EventBatch:
    """A STATE_CHANGE batch for ``device_ids`` (aligned row for row with
    ``tenant_ids``) carrying ``code`` in its ``alert_code`` column,
    system-generated (``update_state=False``)."""
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
        alert_code=full(code),
        update_state=torch.zeros(width, dtype=torch.bool, device=device),
    )


class PresenceManager(LifecycleComponent):
    """Background presence checker over a
    :class:`~sitewhere_tpu_torch.state.manager.DeviceStateManager`.

    ``on_state_changes`` receives the STATE_CHANGE :class:`EventBatch` of
    each sweep that found newly-missing devices; wire it to the
    dispatcher's ``inject_batch`` for re-injection.  The sweep runs under
    the manager's lock, on the CUDA stream its epoch was committed from.
    ``clock`` (seconds) is injectable, as in the reference.
    """

    def __init__(
        self,
        state_manager,  # DeviceStateManager
        check_interval_s: float = 600.0,  # reference default "10m"
        missing_after_s: int = 8 * 3600,  # reference default "8h"
        on_state_changes: Optional[Callable[[EventBatch], None]] = None,
        clock: Optional[Callable[[], float]] = None,
    ):
        super().__init__(name="presence-manager")
        self.state_manager = state_manager
        self.check_interval_s = check_interval_s
        self.missing_after_s = missing_after_s
        self.on_state_changes = on_state_changes
        self._clock = clock or time.time
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.sweeps = 0
        self.total_marked_missing = 0

    def sweep_once(self, now_s: Optional[int] = None) -> int:
        """Run one sweep; returns how many devices were newly marked."""
        now = int(self._clock()) if now_s is None else now_s
        marked = self.state_manager.apply_presence_sweep(
            now, self.missing_after_s)
        self.sweeps += 1
        if marked is not None:
            count = int(marked.valid.sum())
            self.total_marked_missing += count
            if self.on_state_changes is not None:
                self.on_state_changes(marked)
            return count
        return 0

    def _loop(self) -> None:
        while not self._stop.wait(self.check_interval_s):
            try:
                self.sweep_once()
            except Exception:
                logger.exception("presence sweep failed")

    def start(self) -> None:
        super().start()
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="presence-checker", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        super().stop()
