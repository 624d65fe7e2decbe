#!/usr/bin/env python3
"""Where a full-size ring's device time goes, for the PyTorch port.

Builds the deployment ``chip_smoke.py`` drives (registry of 2^20 slots,
1,000,000 devices, 64 rules, 512 zones of 16 vertices, batches of 131072
events), runs warm-up rings, then profiles ``--rings`` rings of K=8 with
``torch.profiler`` and prints one JSON line: wall time per step, the
device's busy share of that wall time, and the device time per step of
the top operators and kernels by self device time.  Needs a CUDA card.

    python3 tools/torch_ring_profile.py [--rings 3] [--top 25]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rings", type=int, default=3)
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_ring_profile: no CUDA card is present", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from sitewhere_tpu_torch.pipeline.packed import pack_tables
    from sitewhere_tpu_torch.runtime.ring import RingRunner
    from sitewhere_tpu_torch.state.manager import DeviceStateManager

    device = torch.device("cuda", 0)
    world = cs.make_world(device, cs.CAPACITY, cs.N_ACTIVE, cs.N_RULES,
                          cs.FULL_Z, cs.FULL_V, cs.SEED + 1)
    mgr = DeviceStateManager(cs.CAPACITY, num_mtype_slots=cs.M_SLOTS,
                             num_ewma_scales=cs.K_SCALES, device=device)
    runner = RingRunner(mgr, pack_tables(*world), cs.RING_K)
    rings = cs.make_rings(2 + args.rings, cs.FULL_B, cs.N_ACTIVE,
                          cs.CAPACITY, cs.SEED + 2)

    def run(ring):
        for view in runner.dispatch(ring):
            view.metrics

    for ring in rings[:2]:
        run(ring)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for ring in rings[2:]:
            run(ring)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    steps = args.rings * cs.RING_K
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0.0)

    # device-side entries (kernels, copies) carry the device time once;
    # host-side operator entries carry the same time as "self device" time
    on_dev = [e for e in events
              if "CUDA" in str(e.device_type) and dev_us(e) > 0]
    ops = [e for e in events
           if "CUDA" not in str(e.device_type) and dev_us(e) > 0]
    device_us = sum(dev_us(e) for e in on_dev)

    def table(entries):
        return [{"name": e.key[:90], "ms": dev_us(e) / steps / 1e3,
                 "calls_per_step": e.count / steps}
                for e in sorted(entries, key=dev_us, reverse=True)[:args.top]]

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({
        "card": smi, "rings": args.rings, "ring_k": cs.RING_K,
        "width": cs.FULL_B, "wall_ms_per_step": wall / steps * 1e3,
        "device_ms_per_step": device_us / steps / 1e3,
        "device_busy_share": device_us / 1e6 / wall,
        "device_entries": len(on_dev),
        "top_ops_ms_per_step": table(ops),
        "top_kernels_ms_per_step": table(on_dev),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
