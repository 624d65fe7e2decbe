"""Vectorized outbound event filters.

Counterpart of ``sitewhere_tpu/outbound/filters.py``.  A filter maps a
column batch to a boolean mask in one numpy expression;
``include=True`` passes only matching events, ``include=False``
(exclude) blocks them.  A connector's chain ANDs its filters.
:class:`CallbackFilter` takes any callable over the columns (the
script filter).  The scripted processor is the other outbound extension
point: the handle of
:meth:`sitewhere_tpu_torch.runtime.scripting.ScriptManager.as_processor`
is a ``CallbackConnector``'s ``fn``.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import numpy as np

Columns = Dict[str, np.ndarray]


class _IdColumnFilter:
    """Match rows whose ``column`` is one of ``ids``."""

    column: str

    def __init__(self, ids: Sequence[int], include: bool = False):
        self.ids = np.asarray(list(ids), np.int32)
        self.include = include

    def __call__(self, cols: Columns) -> np.ndarray:
        match = np.isin(cols[self.column], self.ids)
        return match if self.include else ~match


class AreaFilter(_IdColumnFilter):
    """Pass/block events by enriched area id (reference ``AreaFilter``)."""

    column = "area_id"


class DeviceTypeFilter(_IdColumnFilter):
    """Pass/block by device type id (reference ``DeviceTypeFilter``)."""

    column = "device_type_id"


class DeviceFilter(_IdColumnFilter):
    """Pass/block by device id."""

    column = "device_id"


class EventTypeFilter(_IdColumnFilter):
    """Pass/block by event type (connectors often want only alerts)."""

    column = "event_type"


class CallbackFilter:
    """Script filter: any callable columns → bool mask (Groovy analog)."""

    def __init__(self, fn: Callable[[Columns], np.ndarray]):
        self.fn = fn

    def __call__(self, cols: Columns) -> np.ndarray:
        return np.asarray(self.fn(cols), np.bool_)


def apply_filters(filters, cols: Columns, base_mask: np.ndarray) -> np.ndarray:
    """AND a filter chain over a column batch."""
    mask = base_mask.copy()
    for f in filters:
        if not mask.any():
            break
        mask &= f(cols)
    return mask
