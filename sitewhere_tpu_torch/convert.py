"""Carrying state across: arrays of the JAX package, as numpy, become the
port's tensors.

Each ``*_from`` takes any object with the reference dataclass's attributes
(a ``sitewhere_tpu`` pytree, or a namespace of numpy arrays) and returns
the port's dataclass on ``device``, with the same dtypes.  Nothing here
imports JAX: values go through ``numpy.array``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sitewhere_tpu_torch.device import DeviceLike, resolve_device
from sitewhere_tpu_torch.pipeline.packed import PackedState, PackedTables
from sitewhere_tpu_torch.schema import (
    DeviceState,
    EventBatch,
    Registry,
    RuleTable,
    ZoneTable,
)


def tensor_from(x, device: DeviceLike = None) -> torch.Tensor:
    """One array (anything ``numpy.array`` takes) as a tensor on ``device``."""
    return torch.from_numpy(np.array(x)).to(resolve_device(device))


def _convert(cls, obj, device: DeviceLike):
    device = resolve_device(device)
    return cls(**{f.name: tensor_from(getattr(obj, f.name), device)
                  for f in dataclasses.fields(cls)})


def registry_from(obj, device: DeviceLike = None) -> Registry:
    return _convert(Registry, obj, device)


def device_state_from(obj, device: DeviceLike = None) -> DeviceState:
    return _convert(DeviceState, obj, device)


def rule_table_from(obj, device: DeviceLike = None) -> RuleTable:
    return _convert(RuleTable, obj, device)


def zone_table_from(obj, device: DeviceLike = None) -> ZoneTable:
    return _convert(ZoneTable, obj, device)


def event_batch_from(obj, device: DeviceLike = None) -> EventBatch:
    return _convert(EventBatch, obj, device)


def packed_tables_from(obj, device: DeviceLike = None) -> PackedTables:
    return _convert(PackedTables, obj, device)


def packed_state_from(obj, device: DeviceLike = None) -> PackedState:
    return PackedState(si=tensor_from(obj.si, device),
                       sf=tensor_from(obj.sf, device),
                       num_mtype_slots=int(obj.num_mtype_slots),
                       num_ewma_scales=int(obj.num_ewma_scales))
