#!/usr/bin/env python
"""Per-stage device time of the port's fused pipeline step.

Counterpart of ``tools/profile_step.py``: the command-line front end over
``sitewhere_tpu_torch.pipeline.telemetry.profile_device_stages``, the one
implementation the ``Instance``'s ``device.stage_ms.*`` histograms and
``run_device_profile`` also use.  On the card each stage's ``iters``
launches are timed between two CUDA events on a stream of the profile's
own; on the CPU with the host clock.  The ``zones`` and ``full`` stages
launch the geofence kernel (``csrc/pip_kernel.cu``) on a card.

Usage::

    python tools/torch_profile_step.py                  # the card
    python tools/torch_profile_step.py --device cpu     # plain versions
    python tools/torch_profile_step.py --width 16384 --json

Prints one line per stage (validate+enrich, threshold rules, zone rules,
state update, the full step) and the derived events/s; ``--json`` prints
the result dict (the reference's ``profile_device_stages`` keys).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

STAGE_LABELS = (
    ("validate", "validate+enrich"),
    ("rules", "threshold rules"),
    ("zones", "zone rules (geofence)"),
    ("state", "state update"),
    ("full", "FULL pipeline step"),
)


def run(width: int = 131_072, capacity: int = 16_384, active: int = 10_000,
        iters: int = 64, repeats: int = 3, device="cuda") -> dict:
    """``profile_device_stages`` at the given sizes on ``device`` (the
    card unless ``"cpu"`` is named)."""
    from sitewhere_tpu_torch.device import resolve_device
    from sitewhere_tpu_torch.pipeline.telemetry import profile_device_stages

    dev = resolve_device(device)
    result = profile_device_stages(width=width, capacity=capacity,
                                   active=active, iters=iters,
                                   repeats=repeats, device=dev)
    result["device"] = str(dev)
    result["capacity"] = capacity
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="per-stage device time of the fused step")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("--width", type=int, default=131_072)
    parser.add_argument("--capacity", type=int, default=16_384)
    parser.add_argument("--active", type=int, default=10_000)
    parser.add_argument("--iters", type=int, default=64)
    parser.add_argument("--repeats", type=int, default=3,
                        help="timed runs per stage (median)")
    parser.add_argument("--json", action="store_true",
                        help="print the result dict as JSON")
    args = parser.parse_args(argv)
    result = run(width=args.width, capacity=args.capacity,
                 active=args.active, iters=args.iters, repeats=args.repeats,
                 device=args.device)
    if args.json:
        print(json.dumps(result))
        return 0
    rtt_ms = result["host_rtt_ms"]
    print(f"device={result['device']} width={args.width} "
          f"capacity={args.capacity} iters={args.iters}")
    for stage, label in STAGE_LABELS:
        print(f"{label:<24} {result[f'{stage}_ms']:8.3f} ms/iter   "
              f"(rtt {rtt_ms:.3f} ms)")
    if result.get("device_events_per_s"):
        print(f"device-side rate: {result['device_events_per_s']:,.0f} "
              "events/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
