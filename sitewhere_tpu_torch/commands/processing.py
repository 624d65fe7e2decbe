"""Command processing strategy: resolve target → build execution → route →
deliver, with undelivered dead-lettering.

Counterpart of ``sitewhere_tpu/commands/processing.py``, whole.

Reference: ``DefaultCommandProcessingStrategy.java:61-102`` +
``CommandRoutingLogic.routeCommand:38-55`` (SURVEY.md §3.4).  The reference
consumes enriched command-invocation events from Kafka; here the pipeline
dispatcher hands :class:`CommandProcessor` the command-invocation rows it
diverted (they are also persisted as events, preserving the
invocation-is-an-event model).
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, Dict, List, Optional

from sitewhere_tpu_torch.commands.destinations import CommandDestination
from sitewhere_tpu_torch.commands.model import CommandExecution, CommandInvocation
from sitewhere_tpu_torch.runtime.lifecycle import LifecycleComponent, LifecycleState
from sitewhere_tpu_torch.runtime.tracing import _NOOP_TRACE
from sitewhere_tpu_torch.services.common import EntityNotFound, ServiceError
from sitewhere_tpu_torch.services.device_management import DeviceManagement

logger = logging.getLogger("sitewhere_tpu_torch.commands")

Undelivered = Callable[[CommandInvocation, str], None]


class CommandProcessor(LifecycleComponent):
    """The command-delivery service head.

    ``invoke`` is the full path; partial failures dead-letter through
    ``on_undelivered`` (reference: undelivered-command-invocations topic,
    ``KafkaTopicNaming.java:70-73``).
    """

    def __init__(
        self,
        device_management: DeviceManagement,
        destinations: Optional[List[CommandDestination]] = None,
        router: Optional[Callable[[CommandExecution], str]] = None,
        on_undelivered: Optional[Undelivered] = None,
        metrics=None,
        name: str = "command-processor",
    ):
        super().__init__(name)
        self.dm = device_management
        self.destinations: Dict[str, CommandDestination] = {}
        for d in destinations or []:
            self.add_destination(d)
        self.router = router
        self.on_undelivered = on_undelivered
        self._lock = threading.Lock()
        self.delivered = 0
        self.undelivered = 0
        # registry surface (scraped via /api/instance/metrics.prom)
        self._m_delivered = (metrics.counter("commands.delivered")
                             if metrics is not None else None)
        self._m_undelivered = (metrics.counter("commands.undelivered")
                               if metrics is not None else None)

    def add_destination(self, destination: CommandDestination) -> None:
        replaced = self.destinations.get(destination.destination_id)
        self.destinations[destination.destination_id] = destination
        if replaced is not None and isinstance(replaced.provider, LifecycleComponent):
            # Providers can be shared across destinations (one broker
            # connection, many routes) — only retire one no longer
            # referenced by any destination.
            still_used = any(
                d.provider is replaced.provider for d in self.destinations.values()
            )
            if not still_used:
                if replaced.provider.state == LifecycleState.STARTED:
                    replaced.provider.stop()
                self._children.remove(replaced.provider)
        # Providers with a lifecycle (e.g. MqttDeliveryProvider owning a
        # broker connection) start/stop with the processor — including ones
        # registered after the processor is already running.
        if isinstance(destination.provider, LifecycleComponent):
            if destination.provider not in self._children:  # shared providers register once
                self.add_child(destination.provider)
            if (self.state == LifecycleState.STARTED
                    and destination.provider.state != LifecycleState.STARTED):
                destination.provider.start()

    # -- target resolution + execution build --------------------------------

    def resolve_target(self, invocation: CommandInvocation) -> CommandInvocation:
        """Fill device/type/tenant from the target assignment.

        Reference: ``ICommandTargetResolver`` (invocation → assignments).
        """
        a = self.dm.get_device_assignment(invocation.target_assignment)
        dev = self.dm.get_device(a.device)
        invocation.device_token = dev.token
        invocation.device_type_token = dev.device_type
        invocation.tenant = self.dm.tenant
        return invocation

    def build_execution(self, invocation: CommandInvocation) -> CommandExecution:
        """Join invocation with its command definition.

        Reference: ``ICommandExecutionBuilder.createExecution``.  Parameter
        values are validated against the declared specs: required params
        must be present, unknown params are rejected, and values are coerced
        to their declared types — the schema comes from the device type's
        data, not from compiled code.
        """
        if invocation.device_type_token is None:
            self.resolve_target(invocation)
        dt = self.dm.get_device_type(invocation.device_type_token)
        cmd = dt.commands.get(invocation.command_token)
        if cmd is None:
            raise EntityNotFound(
                f"command {invocation.command_token} not in type {dt.token}"
            )
        declared = {name for (name, _t, _r) in cmd.parameters}
        unknown = set(invocation.parameter_values) - declared
        if unknown:
            raise ServiceError(f"unknown parameters {sorted(unknown)}")
        params = []
        for name, ptype, required in cmd.parameters:
            if name in invocation.parameter_values:
                params.append(
                    (name, ptype, _coerce(ptype, invocation.parameter_values[name]))
                )
            elif required:
                raise ServiceError(f"missing required parameter {name}")
        device_metadata: dict = {}
        if invocation.device_token:
            try:
                device_metadata = dict(
                    self.dm.get_device(invocation.device_token).metadata)
            except Exception:  # metadata is best-effort delivery hints
                device_metadata = {}
        return CommandExecution(
            invocation=invocation,
            command_name=cmd.name,
            namespace=cmd.namespace,
            parameters=params,
            device_metadata=device_metadata,
        )

    # -- routing + delivery --------------------------------------------------

    def route(self, execution: CommandExecution) -> CommandDestination:
        if not self.destinations:
            raise ServiceError("no command destinations registered")
        if self.router is not None:
            dest_id = self.router(execution)
        elif len(self.destinations) == 1:
            dest_id = next(iter(self.destinations))
        else:
            raise ServiceError("multiple destinations but no router configured")
        dest = self.destinations.get(dest_id)
        if dest is None:
            raise EntityNotFound(f"destination {dest_id}")
        return dest

    def invoke(self, invocation: CommandInvocation, trace=None) -> bool:
        """Full delivery path; returns True when the device got the bytes.

        ``trace`` (the originating pipeline plan's trace, when the
        invocation came through the dispatcher's command egress) wraps
        the destination delivery in a ``commands.deliver`` span so a
        retained trace shows the command fan-out leg too."""
        # the span covers resolve/build/route too: a routing or encoding
        # failure must error the span just like a destination failure,
        # or tail sampling would drop the trace of an undelivered command
        span = (trace or _NOOP_TRACE).span("commands.deliver")
        span.tag("command", invocation.command_token)
        with span:
            try:
                self.resolve_target(invocation)
                execution = self.build_execution(invocation)
                dest = self.route(execution)
                span.tag("destination", dest.destination_id)
                dest.deliver(execution)
            except Exception as e:
                # EVERY failure dead-letters (reference: undelivered
                # topic) — including coercion/encoding surprises
                # (ValueError/TypeError), so one bad invocation can never
                # abort a batch.  The exception is handled (not re-raised
                # through __exit__), so flag the span by hand.
                span.error = f"{type(e).__name__}: {e}"
                with self._lock:
                    self.undelivered += 1
                if self._m_undelivered is not None:
                    self._m_undelivered.inc()
                logger.warning("command %s undelivered: %s",
                               invocation.token, e)
                if self.on_undelivered is not None:
                    self.on_undelivered(invocation, str(e))
                return False
        with self._lock:
            self.delivered += 1
        if self._m_delivered is not None:
            self._m_delivered.inc()
        return True

    def invoke_many(self, invocations: List[CommandInvocation],
                    trace=None) -> int:
        """Batch path used by the dispatcher; returns delivered count."""
        return sum(1 for inv in invocations if self.invoke(inv, trace=trace))


_INT_RANGES = {"int32": (-(1 << 31), (1 << 31) - 1), "int64": (-(1 << 63), (1 << 63) - 1)}


def _coerce(ptype: str, value):
    if ptype == "double":
        return float(value)
    if ptype in ("int32", "int64"):
        n = int(value)
        lo, hi = _INT_RANGES[ptype]
        if not lo <= n <= hi:
            raise ServiceError(f"value {n} out of range for {ptype}")
        return n
    if ptype == "bool":
        if isinstance(value, str):
            return value.lower() in ("1", "true", "yes")
        return bool(value)
    if ptype == "bytes":
        return value if isinstance(value, (bytes, bytearray)) else str(value).encode()
    return str(value)
