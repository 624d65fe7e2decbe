"""Device auto-registration — turning unknown-device dead-letters into devices.

Reference: ``service-device-registration`` consumes the unregistered-events
and registration-request dead-letter topics and creates the device (+
assignment) through device management
(``DeviceRegistrationManager.java:81-139``), falling back to a configured
default device type / customer / area when the request doesn't name one
(``:56-68``); the original event is then replayed via the reprocess topic
(``KafkaTopicNaming.java:172-174``, SURVEY.md §3.5).

Counterpart of ``sitewhere_tpu/services/registration.py``, whole.  Here
the dead letters arrive as the pipeline's ``unregistered`` mask rows:
the dispatcher hands this manager the raw :class:`DecodedRequest`s it
diverted (via their journal payload refs), the manager registers them
through :class:`~sitewhere_tpu_torch.services.device_management.DeviceManagement`
(which publishes a fresh registry epoch), and returns the requests so the
caller re-injects them into the batcher — the reprocess path.
"""

from __future__ import annotations

import logging
import threading
from typing import List, Optional

from sitewhere_tpu_torch.ingest.decoders import DecodedRequest, RequestKind
from sitewhere_tpu_torch.runtime.lifecycle import LifecycleComponent
from sitewhere_tpu_torch.services.common import ServiceError
from sitewhere_tpu_torch.services.device_management import DeviceManagement

logger = logging.getLogger("sitewhere_tpu_torch.registration")


class RegistrationManager(LifecycleComponent):
    """Auto-register unknown devices and replay their events.

    ``allow_new_devices=False`` mirrors the reference's
    ``isAllowNewDevices`` switch: unknown devices stay dead-lettered.
    """

    def __init__(
        self,
        device_management: DeviceManagement,
        default_device_type: Optional[str] = None,
        default_customer: Optional[str] = None,
        default_area: Optional[str] = None,
        allow_new_devices: bool = True,
        auto_assign: bool = True,
        name: str = "registration-manager",
    ):
        super().__init__(name)
        self.dm = device_management
        self.default_device_type = default_device_type
        self.default_customer = default_customer
        self.default_area = default_area
        self.allow_new_devices = allow_new_devices
        self.auto_assign = auto_assign
        self._lock = threading.Lock()
        self.registered = 0
        self.rejected = 0

    def handle_registration(self, req: DecodedRequest) -> bool:
        """Process one explicit registration request (device announces itself).

        Reference: ``DeviceRegistrationManager.handleDeviceRegistration:81-105``.
        Returns True if the device exists (already or newly registered).
        """
        token = req.device_token
        if token in self.dm.devices:
            return True  # already registered — idempotent, like the reference
        if not self.allow_new_devices:
            with self._lock:
                self.rejected += 1
            return False
        device_type = req.device_type_token or self.default_device_type
        if device_type is None or device_type not in self.dm.device_types:
            logger.warning("registration for %s names no known device type", token)
            with self._lock:
                self.rejected += 1
            return False
        try:
            self.dm.create_device(
                token=token, device_type=device_type, metadata=dict(req.metadata or {})
            )
            if self.auto_assign:
                customer = req.customer_token or self.default_customer
                area = req.area_token or self.default_area
                self.dm.create_device_assignment(
                    device=token,
                    customer=customer if customer in self.dm.customers else None,
                    area=area if area in self.dm.areas else None,
                )
        except ServiceError:
            logger.exception("auto-registration of %s failed", token)
            with self._lock:
                self.rejected += 1
            return False
        with self._lock:
            self.registered += 1
        return True

    def process_unregistered(
        self, requests: List[DecodedRequest]
    ) -> List[DecodedRequest]:
        """Register the senders of dead-lettered events; return the events
        that can now be replayed (the reprocess-topic analog)."""
        replay: List[DecodedRequest] = []
        for req in requests:
            synthetic = DecodedRequest(
                kind=RequestKind.REGISTRATION,
                device_token=req.device_token,
                ts_s=req.ts_s,
                metadata=req.metadata,
            )
            if self.handle_registration(synthetic):
                replay.append(req)
        return replay
