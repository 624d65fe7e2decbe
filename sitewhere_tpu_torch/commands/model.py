"""Command invocation/execution records.

Counterpart of ``sitewhere_tpu/commands/model.py``, whole.

Reference model: ``IDeviceCommandInvocation`` (a device event carrying a
command token + parameter values + initiator/target) and
``IDeviceCommandExecution`` (invocation joined with its ``IDeviceCommand``
definition, built by ``ICommandExecutionBuilder``
(``service-command-delivery/.../DefaultCommandProcessingStrategy.java:61-84``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from sitewhere_tpu_torch.services.common import mint_token, now_s


@dataclasses.dataclass
class CommandInvocation:
    """A request to run one command on one target assignment."""

    command_token: str
    target_assignment: str
    parameter_values: Dict[str, object] = dataclasses.field(default_factory=dict)
    initiator: str = "REST"          # reference enum: REST/TOOL/SCRIPT/SCHEDULER
    initiator_id: Optional[str] = None
    target: str = "Assignment"
    token: str = dataclasses.field(default_factory=lambda: mint_token("inv"))
    created_s: int = dataclasses.field(default_factory=now_s)
    # Filled during processing:
    device_token: Optional[str] = None
    device_type_token: Optional[str] = None
    tenant: Optional[str] = None


@dataclasses.dataclass
class CommandExecution:
    """Invocation + resolved command definition, ready to encode."""

    invocation: CommandInvocation
    command_name: str
    namespace: str
    # [(name, type, value)] in the command's declared parameter order —
    # the encoding schema is *derived from the device-type data*, the
    # ProtobufMessageBuilder semantic (sitewhere-communication/.../
    # protobuf/DeviceTypeProtoBuilder.java:27).
    parameters: list = dataclasses.field(default_factory=list)
    # the target device's metadata — per-device delivery parameters
    # (e.g. coap_host/coap_port, MetadataCoapParameterExtractor.java)
    device_metadata: dict = dataclasses.field(default_factory=dict)
