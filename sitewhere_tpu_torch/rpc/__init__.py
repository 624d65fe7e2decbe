"""Cross-host RPC fabric (the ``sitewhere-grpc-client`` analog).

Counterpart of ``sitewhere_tpu/rpc/__init__.py``, with the same
``__all__``.

The reference moves every cross-service call over gRPC channels with
round-robin demux, JWT/tenant metadata, and near-caches
(SURVEY.md §1 L3).  In the port, in-step "calls" are tensor gathers inside
the fused step; RPC survives only at the host boundary (§2.4) — this
package is that boundary: framed-TCP wire (`wire`), multiplexing
channels + replica demux with backoff/failover (`channel`), the
lifecycle server with JWT/tenant/tracing interceptors (`server`), the
instance's domain surface + cached client facades (`services`), and
keyed cross-host event forwarding (`forward`).
"""

from sitewhere_tpu_torch.rpc.channel import (
    ChannelUnavailable,
    DeadlineExpired,
    RpcChannel,
    RpcDemux,
    RpcError,
)
from sitewhere_tpu_torch.rpc.health import PeerHealthTable, PeerState
from sitewhere_tpu_torch.rpc.domains import (
    DOMAIN_SURFACE,
    RemoteDomain,
    attach_remote_domains,
    bind_domains,
    remote_domains,
)
from sitewhere_tpu_torch.rpc.forward import HostForwarder, owning_process, split_lines
from sitewhere_tpu_torch.rpc.server import CallContext, RpcServer
from sitewhere_tpu_torch.rpc.services import RemoteDeviceManagement, bind_instance

__all__ = [
    "CallContext",
    "ChannelUnavailable",
    "DeadlineExpired",
    "HostForwarder",
    "PeerHealthTable",
    "PeerState",
    "RemoteDeviceManagement",
    "RpcChannel",
    "RpcDemux",
    "RpcError",
    "RpcServer",
    "bind_instance",
    "owning_process",
    "split_lines",
]
