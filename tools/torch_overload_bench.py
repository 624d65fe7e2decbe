#!/usr/bin/env python
"""Overload bench of the PyTorch port: goodput against offered load.

Counterpart of ``tools/overload_bench.py`` over the port ``Instance``.
A system without overload control collapses past saturation (goodput
falls as offered load rises, every class starves together); one with
admission and priority shedding degrades gracefully (goodput plateaus
near capacity, critical traffic keeps flowing, the excess is shed
loudly).  Mixed telemetry and alert wire traffic is offered at multiples
of the measured base capacity, and per multiple the goodput (rows that
sealed), sheds, alert delivery and the worst overload state are
reported.  Every step of the ``Instance`` runs on ``--device``: the card
by default, where it launches the geofence kernel, or the CPU when named.

Usage::

    python tools/torch_overload_bench.py [--width 256] [--duration 0.5]
        [--multipliers 0.5,1,2,4] [--smoke] [--json] [--out OUT.json]
        [--device cpu]

``--smoke`` is the reference case's sizing: width 64, 0.2 s a phase,
multiples 1 and 4, an alert every second payload.

Exit status 0 = graceful (goodput at the top multiple held at least
``--collapse-floor`` of peak goodput and no alert-class shed); 1 =
collapse or alert loss.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _measurement_lines(token, base, n, ts=1_753_800_000):
    return "\n".join(
        json.dumps({"deviceToken": token, "type": "Measurement",
                    "request": {"name": "temp", "value": float(base + i),
                                "eventDate": ts}})
        for i in range(n)).encode()


def _alert_line(token, ts=1_753_800_000):
    return json.dumps({
        "deviceToken": token, "type": "Alert",
        "request": {"type": "overheat", "level": "warning",
                    "message": "hot", "eventDate": ts}}).encode()


def _make_instance(data_dir, width, device):
    from sitewhere_tpu_torch.instance import Instance
    from sitewhere_tpu_torch.runtime.config import Config

    cfg = Config({
        "instance": {"id": "overload-bench", "data_dir": data_dir},
        "pipeline": {"width": width, "registry_capacity": 1024,
                     "mtype_slots": 4, "deadline_ms": 2.0, "n_shards": 1},
        "presence": {"scan_interval_s": 3600.0, "missing_after_s": 1800},
        "overload": {
            "enabled": True,
            # bench-tight loop: sample every controller tick, recover
            # fast enough that per-multiplier phases stay independent
            "cooldown_s": 0.2,
            "sample_interval_s": 0.0,
            # the batcher emits full plans inline at width, so pending
            # oscillates around 1.0×width under sustained overload —
            # put the DEGRADED/SHEDDING watermarks around that pivot
            "watermarks": {"batcher_backlog": [0.75, 1.05, 8.0]},
        },
    }, apply_env=False)
    return Instance(cfg, device=device)


def run(width=256, duration_s=0.5, multipliers=(0.5, 1.0, 2.0, 4.0),
        lines_per_payload=8, alert_every=10, data_dir=None, device="cuda"):
    """Run the sweep on ``device`` (the card unless ``"cpu"`` is named);
    returns {capacity_rows_per_s, rows: [...]}."""
    from sitewhere_tpu_torch.device import resolve_device
    from sitewhere_tpu_torch.runtime.overload import OverloadShed, OverloadState

    dev = resolve_device(device)

    root = data_dir or tempfile.mkdtemp(prefix="overload-bench-")
    owns_root = data_dir is None
    inst = _make_instance(os.path.join(root, "data"), width, dev)
    inst.start()
    try:
        inst.device_management.create_device_type(token="sensor",
                                                  name="Sensor")
        inst.device_management.create_device(token="dev-0",
                                             device_type="sensor")
        inst.device_management.create_device_assignment(device="dev-0")

        disp = inst.dispatcher

        def sealed():
            return disp.totals["accepted"]

        # ---- base capacity: unpaced blast with admission OFF — this
        # phase measures the DRAIN side (decode → step → seal), and the
        # controller shedding its own yardstick would corrupt it.  The
        # warm pass (allocator, kernel loads) runs outside the timed window.
        disp.overload = None
        for w in range(4):
            disp.ingest_wire_lines(_measurement_lines("dev-0", w, width))
        disp.flush()
        t0 = time.perf_counter()
        sealed0 = sealed()
        i = 0
        while time.perf_counter() - t0 < max(duration_s, 0.2):
            disp.ingest_wire_lines(
                _measurement_lines("dev-0", i, lines_per_payload))
            i += 1
        disp.flush()
        elapsed = time.perf_counter() - t0
        capacity = max(1.0, (sealed() - sealed0) / elapsed)
        disp.overload = inst.overload
        # DEGRADED telemetry budget tracks the measured drain rate with
        # headroom for critical traffic + recovery: the bucket admits
        # ~80% of capacity and sheds the overhang cheaply — the
        # graceful-degradation shape this bench exists to demonstrate
        inst.overload.degraded_telemetry_rate_per_s = capacity * 0.8
        inst.overload.degraded_telemetry_burst = lines_per_payload * 2.0

        rows = []
        for mult in multipliers:
            # let the controller recover between phases
            disp.flush()
            t_rec = time.monotonic()
            while inst.overload.state != OverloadState.NORMAL \
                    and time.monotonic() - t_rec < 5.0:
                inst.overload.tick()
                time.sleep(0.01)

            target_rate = capacity * mult     # rows/s offered
            interval = lines_per_payload / target_rate
            sealed_before = sealed()
            shed_before = inst.overload.shed_total
            crit_before = inst.metrics.counter(
                "overload.shed.critical").value
            offered = 0
            alerts_offered = 0
            signalled = 0
            worst = OverloadState.NORMAL
            t0 = time.perf_counter()
            next_send = t0
            i = 0
            while time.perf_counter() - t0 < duration_s:
                now = time.perf_counter()
                if now < next_send:
                    time.sleep(min(next_send - now, 0.001))
                    continue
                next_send += interval
                try:
                    # alerts lead the cadence so even a starved phase
                    # (contended box, short duration) offers at least one
                    if alert_every and i % alert_every == 0:
                        disp.ingest_wire_lines(_alert_line("dev-0"))
                        alerts_offered += 1
                        offered += 1
                    else:
                        disp.ingest_wire_lines(
                            _measurement_lines("dev-0", i,
                                               lines_per_payload))
                        offered += lines_per_payload
                except OverloadShed:
                    signalled += 1
                    offered += lines_per_payload
                i += 1
                worst = max(worst, inst.overload.tick())
            disp.flush()
            elapsed = time.perf_counter() - t0
            row = {
                "multiplier": mult,
                "offered_rows_per_s": round(offered / elapsed, 1),
                "goodput_rows_per_s": round(
                    (sealed() - sealed_before) / elapsed, 1),
                "shed_rows": inst.overload.shed_total - shed_before,
                "alert_sheds": inst.metrics.counter(
                    "overload.shed.critical").value - crit_before,
                "alerts_offered": alerts_offered,
                "backpressure_signals": signalled,
                "worst_state": OverloadState(worst).name,
            }
            snap = disp.metrics_snapshot()
            if "latency_p99_ms" in snap:
                row["p99_ms"] = snap["latency_p99_ms"]
            rows.append(row)
        return {"capacity_rows_per_s": round(capacity, 1),
                "width": width, "device": str(dev), "rows": rows}
    finally:
        inst.stop()
        inst.terminate()
        if owns_root:
            shutil.rmtree(root, ignore_errors=True)


def _render(result) -> str:
    rows = result["rows"]
    peak = max(r["goodput_rows_per_s"] for r in rows) or 1.0
    out = [f"overload_bench: base capacity ≈ "
           f"{result['capacity_rows_per_s']:.0f} rows/s "
           f"(width {result['width']})",
           f"{'offered':>10} {'goodput':>10} {'shed':>8} "
           f"{'alerts':>7} {'state':>10}  goodput vs offered"]
    for r in rows:
        bar = "#" * max(1, int(30 * r["goodput_rows_per_s"] / peak))
        alerts = f"{r['alerts_offered'] - r['alert_sheds']}" \
                 f"/{r['alerts_offered']}"
        out.append(
            f"{r['offered_rows_per_s']:>10.0f} "
            f"{r['goodput_rows_per_s']:>10.0f} "
            f"{r['shed_rows']:>8d} {alerts:>7} "
            f"{r['worst_state']:>10}  {bar} ({r['multiplier']}x)")
    return "\n".join(out)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="goodput vs offered load under overload control")
    parser.add_argument("--width", type=int, default=256)
    parser.add_argument("--duration", type=float, default=0.5,
                        help="seconds per offered-load phase")
    parser.add_argument("--multipliers", default="0.5,1,2,4",
                        help="offered-load multiples of base capacity")
    parser.add_argument("--collapse-floor", type=float, default=0.3,
                        help="min goodput fraction of peak at the top "
                             "multiplier before the run counts as a "
                             "throughput collapse")
    parser.add_argument("--smoke", action="store_true",
                        help="the reference case's sizing")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("--json", action="store_true")
    parser.add_argument("--out", help="write the JSON result here")
    args = parser.parse_args(argv)
    multipliers = tuple(float(m) for m in args.multipliers.split(","))
    kw = dict(width=args.width, duration_s=args.duration,
              multipliers=multipliers)
    if args.smoke:
        kw.update(width=64, duration_s=0.2, multipliers=(1.0, 4.0),
                  alert_every=2)
    result = run(device=args.device, **kw)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)
    if args.json:
        print(json.dumps(result, indent=2))
    else:
        print(_render(result))
    rows = result["rows"]
    peak = max(r["goodput_rows_per_s"] for r in rows)
    top = rows[-1]
    if any(r["alert_sheds"] for r in rows):
        print("FAIL: alert-class events were shed", file=sys.stderr)
        return 1
    if peak > 0 and top["goodput_rows_per_s"] < args.collapse_floor * peak:
        print(f"FAIL: goodput collapsed at {top['multiplier']}x "
              f"({top['goodput_rows_per_s']:.0f} < "
              f"{args.collapse_floor:.0%} of peak {peak:.0f})",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
