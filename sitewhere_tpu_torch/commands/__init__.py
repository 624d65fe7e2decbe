"""Command delivery — invocations out to devices.

Counterpart of ``sitewhere_tpu/commands/__init__.py``, whole.

Reference: ``service-command-delivery`` (SURVEY.md §2.2, §3.4): enriched
command-invocation events flow through a processing strategy (target
resolver → execution builder), a router picks a destination, and the
destination encodes + parameter-extracts + delivers (MQTT/CoAP/SMS).
Failures land on the undelivered dead-letter topic.
"""

from sitewhere_tpu_torch.commands.model import CommandExecution, CommandInvocation
from sitewhere_tpu_torch.commands.encoders import (
    BinaryCommandEncoder,
    JsonCommandEncoder,
    decode_binary_execution,
)
from sitewhere_tpu_torch.commands.destinations import (
    CallbackDeliveryProvider,
    CoapDeliveryProvider,
    CoapParameterExtractor,
    CommandDestination,
    HttpDeliveryProvider,
    MqttDeliveryProvider,
    SmsParameterExtractor,
    TopicParameterExtractor,
)
from sitewhere_tpu_torch.commands.routing import (
    DeviceTypeMappingRouter,
    SingleDestinationRouter,
)
from sitewhere_tpu_torch.commands.processing import CommandProcessor

__all__ = [
    "CommandExecution",
    "CommandInvocation",
    "BinaryCommandEncoder",
    "JsonCommandEncoder",
    "decode_binary_execution",
    "CallbackDeliveryProvider",
    "CommandDestination",
    "HttpDeliveryProvider",
    "MqttDeliveryProvider",
    "SmsParameterExtractor",
    "TopicParameterExtractor",
    "DeviceTypeMappingRouter",
    "SingleDestinationRouter",
    "CommandProcessor",
]
