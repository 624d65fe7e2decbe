"""Outbound delivery of enriched events to external systems.

Counterpart of ``sitewhere_tpu/outbound/``: the dispatcher hands every
accepted (enriched) batch to the
:class:`~sitewhere_tpu_torch.outbound.manager.OutboundConnectorsManager`,
which offers it to each connector's worker; filters are vectorized
column masks over the batch, not per-event predicates.  Host code only
(numpy and the standard library): the columns reach it on the host.
"""

from sitewhere_tpu_torch.outbound.filters import (
    AreaFilter,
    CallbackFilter,
    DeviceFilter,
    DeviceTypeFilter,
    EventTypeFilter,
)
from sitewhere_tpu_torch.outbound.connectors import (
    CallbackConnector,
    FileConnector,
    HttpConnector,
    IndexPushConnector,
    MqttOutboundConnector,
    OutboundConnector,
)
from sitewhere_tpu_torch.outbound.manager import OutboundConnectorsManager
from sitewhere_tpu_torch.outbound.search import EventSearchProvider, SearchProvidersManager

__all__ = [
    "AreaFilter",
    "CallbackFilter",
    "DeviceFilter",
    "DeviceTypeFilter",
    "EventTypeFilter",
    "CallbackConnector",
    "FileConnector",
    "HttpConnector",
    "IndexPushConnector",
    "MqttOutboundConnector",
    "OutboundConnector",
    "OutboundConnectorsManager",
    "EventSearchProvider",
    "SearchProvidersManager",
]
