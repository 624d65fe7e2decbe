"""The geofence kernel's least time, frozen from ``chip_smoke.py``
(``pip_bound_ms`` :928, its peak constants :483-485 and per-test counts
:579-580).

Published NVIDIA H100 SXM peaks (data sheet, dense, at the 700 W power
limit).  The 67 TFLOP/s float32 rate counts an FMA as two operations; the
kernel, built with ``-fmad=false``, issues none, so an instruction runs
at half of it.  The INT32/logic units issue at half the FP32 lanes' rate.
The least an edge test needs is 4 float32 instructions and 1.5 logic
instructions, whatever implements it; the count is over all B·Z·V pairs,
so a change that skips pairs needs the work recounted here first.
"""

from __future__ import annotations

PEAK_FP32_INSTR = 67e12 / 2  # float32 instructions/s
PEAK_INT32_INSTR = PEAK_FP32_INSTR / 2
PEAK_HBM_BYTES = 3.35e12     # bytes/s
PIP_FLOAT_PER_TEST = 4
PIP_LOGIC_PER_TEST = 1.5


def pip_bound_ms(b: int, z: int, v: int):
    """The geofence's least time at (B, Z, V): (operations, bytes) ms.
    Bytes: the points and the rings read once, ``out`` written once."""
    tests = b * z * v
    ops_ms = max(PIP_FLOAT_PER_TEST * tests / PEAK_FP32_INSTR,
                 PIP_LOGIC_PER_TEST * tests / PEAK_INT32_INSTR) * 1e3
    bytes_ms = (b * 2 * 4 + z * v * 2 * 4 + b * z) / PEAK_HBM_BYTES * 1e3
    return ops_ms, bytes_ms
