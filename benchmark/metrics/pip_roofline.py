"""Geofence kernel (``ops/geo_cuda.py``, ``csrc/pip_kernel.cu``): its least
time at the step's (B, Z, V) (``roofline.pip_bound_ms``: B*Z*V edge tests
at 4 float + 1.5 logic instructions, the points, rings and [B, Z] out
moved once, against the published H100 peaks) over the profiler's mean
time a launch of ``pip_parity_kernel``, in %."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "bench_roofline", Path(__file__).resolve().parent.parent / "roofline.py")
_roofline = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_roofline)


def read(ctx):
    tr = ctx["trace"]
    if not tr or tr["pip_launches"] <= 0 or tr["pip_s"] <= 0:
        return None
    cfg = ctx["config"]
    bound_ms = max(_roofline.pip_bound_ms(ctx["width"], cfg["zones"],
                                          cfg["zone_verts"]))
    return bound_ms / (tr["pip_s"] / tr["pip_launches"] * 1e3) * 100.0
