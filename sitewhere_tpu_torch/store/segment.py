"""The stored event row's column schema.

Counterpart of the schema half of ``sitewhere_tpu/store/segment.py``
(``COLUMNS`` / ``COLUMN_NAMES``, :46-68), from which the dispatcher's
``EgressColumns`` derives its split into host and enrichment columns.
The segment store itself waits for a later slice.
"""

from __future__ import annotations

import numpy as np

# Column schema of one stored event row: the EventBatch columns that
# matter post-pipeline, plus the enrichment context and the server-side
# receive time.
COLUMNS = (
    ("device_id", np.int32),
    ("tenant_id", np.int32),
    ("event_type", np.int32),
    ("ts_s", np.int32),
    ("ts_ns", np.int32),
    ("mtype_id", np.int32),
    ("value", np.float32),
    ("lat", np.float32),
    ("lon", np.float32),
    ("elevation", np.float32),
    ("alert_code", np.int32),
    ("alert_level", np.int32),
    ("command_id", np.int32),
    ("payload_ref", np.int32),
    ("device_type_id", np.int32),
    ("assignment_id", np.int32),
    ("area_id", np.int32),
    ("customer_id", np.int32),
    ("asset_id", np.int32),
    ("received_s", np.int32),  # server-side receive time (receivedDate)
)
COLUMN_NAMES = tuple(name for name, _ in COLUMNS)
COLUMN_DTYPES = dict(COLUMNS)
