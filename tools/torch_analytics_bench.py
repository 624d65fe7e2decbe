#!/usr/bin/env python
"""Analytics bench of the PyTorch port: windowed-query throughput and
CEP match latency.

Counterpart of ``tools/analytics_bench.py`` over
``sitewhere_tpu_torch.analytics``.  Over a synthetic fleet it measures:

1. **Grid aggregation**: events/s through the ``[D, W]`` window grid
   (``aggregate_windows``), the substrate charts and retrospective
   estimates share.
2. **Windowed-query operator**: events/s through one compiled
   ``WindowQuery`` (sort, segment reduction and carry merge per batch),
   the live-mode cost the dispatcher's egress offer pays.
3. **CEP match latency**: wall time for a compiled two-step pattern
   (window-mean cross, then an alert) to evaluate the batch carrying the
   completing alert and surface the match.

The operators run on ``--device``: the card by default, the CPU when
named.

Usage::

    python tools/torch_analytics_bench.py [--devices 1024]
        [--events 200000] [--batch 8192] [--json] [--device cpu]

Exit status is always 0 (a reporting tool).
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def _fleet(n_devices: int, n_events: int, t0: int = 1_753_800_000,
           seed: int = 7):
    """Synthetic fleet telemetry: per-device random-walk measurements in
    (device, time)-interleaved arrival order."""
    rng = np.random.default_rng(seed)
    dev = rng.integers(0, n_devices, n_events).astype(np.int32)
    ts = (t0 + np.arange(n_events) // max(1, n_events // 3600)).astype(
        np.int32)
    val = (20.0 + rng.normal(0, 2.0, n_events)).astype(np.float32)
    return dev, ts, val


def run(n_devices: int = 1024, n_events: int = 200_000,
        batch: int = 8192, window_s: int = 300, device="cuda"):
    """The bench's result dict (the reference's keys); the operators run
    on ``device``, the card unless ``"cpu"`` is named."""
    import torch

    from sitewhere_tpu_torch.device import resolve_device
    from sitewhere_tpu_torch.schema import ComparisonOp, EventType
    from sitewhere_tpu_torch.analytics.query import (
        PatternQuery,
        WindowQuery,
        compile_query,
    )
    from sitewhere_tpu_torch.analytics.cep import PatternStep
    from sitewhere_tpu_torch.analytics.windows import aggregate_windows

    on = resolve_device(device)

    def sync():
        if on.type == "cuda":
            torch.cuda.synchronize(on)

    dev, ts, val = _fleet(n_devices, n_events)
    result = {"device": str(on), "devices": n_devices, "events": n_events,
              "batch": batch}

    # ---- 1. grid kernel throughput
    win = ((ts - ts.min()) // window_s).astype(np.int32)
    n_windows = max(64, int(win.max()) + 1)
    args = (torch.from_numpy(dev).to(on), torch.from_numpy(win).to(on),
            torch.from_numpy(val).to(on),
            torch.ones(n_events, dtype=torch.bool, device=on))
    grid = aggregate_windows(*args, n_devices=n_devices,
                             n_windows=n_windows)  # warm
    sync()
    t0 = time.perf_counter()
    reps = 5
    for _ in range(reps):
        grid = aggregate_windows(*args, n_devices=n_devices,
                                 n_windows=n_windows)
    sync()
    dt = (time.perf_counter() - t0) / reps
    result["grid_events_per_s"] = round(n_events / dt, 1)
    result["grid_occupancy"] = round(float(grid.occupancy()), 4)

    # ---- 2. windowed-query operator throughput (live-mode eval)
    q = WindowQuery(name="bench-mean", threshold=21.0, agg="mean",
                    window_s=window_s)
    compiled = compile_query(q, capacity=n_devices, device=on)
    mt = np.ones(n_events, np.int32)
    et = np.full(n_events, int(EventType.MEASUREMENT), np.int32)
    # warm the (pow2-bucketed) batch shape
    cols0 = {"device_id": dev[:batch], "ts_s": ts[:batch],
             "event_type": et[:batch], "mtype_id": mt[:batch],
             "value": val[:batch]}
    compiled.eval_cols(cols0)
    compiled.reset()
    matches = 0
    t0 = time.perf_counter()
    for lo in range(0, n_events, batch):
        cols = {"device_id": dev[lo:lo + batch], "ts_s": ts[lo:lo + batch],
                "event_type": et[lo:lo + batch],
                "mtype_id": mt[lo:lo + batch],
                "value": val[lo:lo + batch]}
        matches += len(compiled.eval_cols(cols))
    matches += len(compiled.flush())
    dt = time.perf_counter() - t0
    result["window_query_events_per_s"] = round(n_events / dt, 1)
    result["window_query_matches"] = matches

    # ---- 3. CEP match latency (arm, then time the completing batch)
    pat = PatternQuery(
        name="bench-pattern",
        steps=[PatternStep(window_cross=True),
               PatternStep(event_type=int(EventType.ALERT), within_s=60)],
        window_s=window_s, cross_op=int(ComparisonOp.GT),
        cross_threshold=21.0)
    cep = compile_query(pat, capacity=n_devices, device=on)
    lat_ms = []
    cep_matches = 0
    for trial in range(5):
        cep.reset()
        arm = {"device_id": np.asarray([3], np.int32),
               "ts_s": np.asarray([1_753_900_000 + trial * 1000], np.int32),
               "event_type": np.asarray([int(EventType.MEASUREMENT)],
                                        np.int32),
               "mtype_id": np.asarray([-1], np.int32),
               "value": np.asarray([50.0], np.float32)}
        cep.eval_cols(arm)   # window-cross arms the machine
        fire = dict(arm)
        fire["ts_s"] = arm["ts_s"] + 10
        fire["event_type"] = np.asarray([int(EventType.ALERT)], np.int32)
        fire["value"] = np.asarray([0.0], np.float32)
        t0 = time.perf_counter()
        out = cep.eval_cols(fire)
        lat_ms.append((time.perf_counter() - t0) * 1e3)
        cep_matches += len(out)
    result["cep_match_latency_ms"] = round(min(lat_ms), 3)
    result["cep_matches"] = cep_matches
    return result


def _render(result) -> str:
    lines = [
        f"analytics bench — {result['devices']} devices, "
        f"{result['events']} events, batch {result['batch']}",
        f"  grid aggregation : {result['grid_events_per_s']:>12,.0f} ev/s "
        f"(occupancy {result['grid_occupancy']})",
        f"  window query     : "
        f"{result['window_query_events_per_s']:>12,.0f} ev/s "
        f"({result['window_query_matches']} matches)",
        f"  cep match latency: {result['cep_match_latency_ms']:>8.3f} ms "
        f"({result['cep_matches']} matches)",
    ]
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--devices", type=int, default=1024)
    ap.add_argument("--events", type=int, default=200_000)
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    result = run(args.devices, args.events, args.batch, device=args.device)
    if args.json:
        print(json.dumps(result, indent=2))
    else:
        print(_render(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
