"""Command routers: pick a destination for an execution.

Counterpart of ``sitewhere_tpu/commands/routing.py``, whole.

Reference: ``ICommandRouter`` impls — ``DeviceTypeMappingCommandRouter``
(device-type token → destination id with a default fallback) and the
scripted router (``service-command-delivery/.../routing/``).  The scripted
variant is any callable taking an execution and returning a destination
id, such as a router script's live handle from
:meth:`sitewhere_tpu_torch.runtime.scripting.ScriptManager.as_router`.
"""

from __future__ import annotations

from typing import Dict, Optional

from sitewhere_tpu_torch.commands.model import CommandExecution
from sitewhere_tpu_torch.services.common import EntityNotFound


class SingleDestinationRouter:
    """Route everything to the one configured destination."""

    def __init__(self, destination_id: str):
        self.destination_id = destination_id

    def __call__(self, execution: CommandExecution) -> str:
        return self.destination_id


class DeviceTypeMappingRouter:
    """Map device-type token → destination id, with optional default.

    Reference: ``DeviceTypeMappingCommandRouter.java``.
    """

    def __init__(self, mappings: Dict[str, str], default: Optional[str] = None):
        self.mappings = dict(mappings)
        self.default = default

    def __call__(self, execution: CommandExecution) -> str:
        dt = execution.invocation.device_type_token
        dest = self.mappings.get(dt or "", self.default)
        if dest is None:
            raise EntityNotFound(f"no destination mapped for device type {dt}")
        return dest
