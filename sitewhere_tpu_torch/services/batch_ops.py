"""Batch operations — fan one command over many devices with throttling.

Counterpart of ``sitewhere_tpu/services/batch_ops.py``, whole.

Reference: ``service-batch-operations`` — ``BatchOperationManager.java:61-70,
349,419`` consumes unprocessed-batch-operations, emits one element per
device, paces with ``throttleDelayMs``, and records per-element + overall
processing status; ``BatchCommandInvocationHandler`` performs the
per-element command invocation; ``BatchUtils`` expands device groups into
device lists; ``BatchManagementTriggers`` notifies on status changes.

Here the batch operation is a host record, elements invoke through
:class:`~sitewhere_tpu_torch.commands.CommandProcessor`, and processing runs on a
worker thread with the same throttle semantic.
"""

from __future__ import annotations

import dataclasses
import logging
import queue
import threading
import time
from typing import Callable, Dict, List, Optional

from sitewhere_tpu_torch.commands.model import CommandInvocation
from sitewhere_tpu_torch.commands.processing import CommandProcessor
from sitewhere_tpu_torch.runtime.lifecycle import LifecycleComponent
from sitewhere_tpu_torch.services.common import (
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
from sitewhere_tpu_torch.services.device_management import DeviceManagement

logger = logging.getLogger("sitewhere_tpu_torch.batch")

#: the reference module the records pickle under (``_PICKLE_AS``)
_REF = "sitewhere_tpu.services.batch_ops"

# Reference enums: BatchOperationStatus / ElementProcessingStatus.
OP_UNPROCESSED = "Unprocessed"
OP_INITIALIZING = "Initializing"
OP_PROCESSING = "InProcessing"
OP_DONE = "FinishedSuccessfully"
OP_DONE_ERRORS = "FinishedWithErrors"

EL_UNPROCESSED = "Unprocessed"
EL_SUCCEEDED = "Succeeded"
EL_FAILED = "Failed"


@dataclasses.dataclass
class BatchElement:
    """Per-device slice of a batch operation (reference ``IBatchElement``)."""

    _PICKLE_AS = (_REF, "BatchElement")

    device: str
    index: int
    status: str = EL_UNPROCESSED
    processed_s: Optional[int] = None
    error: Optional[str] = None


@dataclasses.dataclass
class BatchOperation(Entity):
    _PICKLE_AS = (_REF, "BatchOperation")

    operation_type: str = "InvokeCommand"
    parameters: Dict[str, object] = dataclasses.field(default_factory=dict)
    status: str = OP_UNPROCESSED
    started_s: Optional[int] = None
    finished_s: Optional[int] = None
    elements: List[BatchElement] = dataclasses.field(default_factory=list)

    @property
    def counts(self) -> Dict[str, int]:
        out = {EL_UNPROCESSED: 0, EL_SUCCEEDED: 0, EL_FAILED: 0}
        for el in self.elements:
            out[el.status] = out.get(el.status, 0) + 1
        return out


Listener = Callable[[str, BatchOperation], None]


class BatchOperationManager(LifecycleComponent):
    """Create + process batch operations (see module docstring)."""

    def __init__(
        self,
        device_management: DeviceManagement,
        command_processor: CommandProcessor,
        throttle_delay_ms: int = 0,
        name: str = "batch-operations",
    ):
        super().__init__(name)
        self.dm = device_management
        self.commands = command_processor
        self.throttle_delay_ms = throttle_delay_ms
        self.operations: Dict[str, BatchOperation] = {}
        self._lock = threading.RLock()
        self._queue: "queue.Queue[Optional[str]]" = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._listeners: List[Listener] = []

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        super().start()
        self._stop.clear()
        self._worker = threading.Thread(
            target=self._process_loop, name=self.name, daemon=True
        )
        self._worker.start()
        # Requeue operations interrupted by a previous shutdown.
        with self._lock:
            for op in self.operations.values():
                if op.status == OP_UNPROCESSED:
                    self._queue.put(op.token)

    def stop(self) -> None:
        self._stop.set()
        self._queue.put(None)
        if self._worker is not None:
            self._worker.join(timeout=5)
            self._worker = None
        super().stop()

    def add_listener(self, listener: Listener) -> None:
        self._listeners.append(listener)

    def _notify(self, kind: str, op: BatchOperation) -> None:
        for listener in self._listeners:
            try:
                listener(kind, op)
            except Exception:
                logger.exception("batch listener failed")

    # -- creation ------------------------------------------------------------

    def create_batch_command_invocation(
        self,
        command_token: str,
        parameter_values: Optional[Dict[str, object]] = None,
        devices: Optional[List[str]] = None,
        group: Optional[str] = None,
        token: Optional[str] = None,
    ) -> BatchOperation:
        """Queue a command invocation over a device list or group.

        Reference: REST ``createBatchCommandInvocation`` +
        ``BatchUtils.getDevicesFromGroup`` group expansion.
        """
        with self._lock:
            token = token or mint_token("batch")
            require(token not in self.operations, ValidationError(f"batch {token} exists"))
            targets = list(devices or [])
            if group is not None:
                targets.extend(d.token for d in self.dm.group_devices(group))
            # de-dup, preserve order
            seen = set()
            targets = [t for t in targets if not (t in seen or seen.add(t))]
            require(bool(targets), ValidationError("batch has no target devices"))
            for t in targets:
                require(t in self.dm.devices, InvalidReference(f"device {t}"))
            op = BatchOperation(
                token=token,
                operation_type="InvokeCommand",
                parameters={
                    "commandToken": command_token,
                    "parameterValues": dict(parameter_values or {}),
                },
                elements=[BatchElement(device=t, index=i) for i, t in enumerate(targets)],
            )
            self.operations[token] = op
            self.identity_mint(token)
            self._queue.put(token)
            self._notify("batch.created", op)
            return op

    def identity_mint(self, token: str) -> None:
        self.dm.identity.batch_operation.mint(f"{self.dm.tenant}:{token}")

    # -- queries -------------------------------------------------------------

    def get_operation(self, token: str) -> BatchOperation:
        op = self.operations.get(token)
        require(op is not None, EntityNotFound(f"batch operation {token}"))
        return op

    def list_operations(
        self, criteria: Optional[SearchCriteria] = None, status: Optional[str] = None
    ) -> SearchResults[BatchOperation]:
        with self._lock:
            items = sorted(self.operations.values(), key=lambda o: o.token)
        if status is not None:
            items = [o for o in items if o.status == status]
        return paged(items, criteria)

    def list_elements(
        self, token: str, criteria: Optional[SearchCriteria] = None,
        status: Optional[str] = None,
    ) -> SearchResults[BatchElement]:
        op = self.get_operation(token)
        items = op.elements
        if status is not None:
            items = [e for e in items if e.status == status]
        return paged(items, criteria)

    # -- processing ----------------------------------------------------------

    def process_now(self, token: str) -> BatchOperation:
        """Synchronously process one operation (worker calls this too)."""
        op = self.get_operation(token)
        with self._lock:
            if op.status not in (OP_UNPROCESSED,):
                return op
            op.status = OP_INITIALIZING
        op.started_s = now_s()
        op.status = OP_PROCESSING
        self._notify("batch.started", op)

        command_token = str(op.parameters.get("commandToken", ""))
        values = dict(op.parameters.get("parameterValues", {}))
        failures = 0
        interrupted = False
        for el in op.elements:
            if self._stop.is_set():
                interrupted = True
                break
            if el.status != EL_UNPROCESSED:
                continue  # resume path: already-processed elements keep status
            a = self.dm.get_active_assignment(el.device) if el.device in self.dm.devices else None
            if a is None:
                el.status, el.error = EL_FAILED, "no active assignment"
                failures += 1
            else:
                ok = self.commands.invoke(
                    CommandInvocation(
                        command_token=command_token,
                        target_assignment=a.token,
                        parameter_values=values,
                        initiator="BatchOperation",
                        initiator_id=op.token,
                    )
                )
                el.status = EL_SUCCEEDED if ok else EL_FAILED
                if not ok:
                    el.error = "undelivered"
                    failures += 1
            el.processed_s = now_s()
            if self.throttle_delay_ms and el is not op.elements[-1]:
                # Reference: BatchOperationManager throttleDelayMs pacing so
                # a huge fleet doesn't stampede the delivery path.
                time.sleep(self.throttle_delay_ms / 1000.0)
        if interrupted:
            # Shutdown mid-batch: mark unprocessed so a restart resumes the
            # remaining elements (the Kafka-offset-replay analog).
            op.status = OP_UNPROCESSED
            return op
        op.finished_s = now_s()
        op.status = OP_DONE_ERRORS if failures else OP_DONE
        self._notify("batch.finished", op)
        return op

    def _process_loop(self) -> None:
        while not self._stop.is_set():
            token = self._queue.get()
            if token is None:
                continue
            try:
                self.process_now(token)
            except Exception:
                logger.exception("batch %s processing failed", token)

    def wait_idle(self, timeout: float = 30.0) -> bool:
        """Block until the queue is drained and operations settle (tests)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                busy = any(
                    op.status in (OP_UNPROCESSED, OP_INITIALIZING, OP_PROCESSING)
                    for op in self.operations.values()
                )
            if not busy and self._queue.empty():
                return True
            time.sleep(0.01)
        return False
