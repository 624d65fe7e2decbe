#!/usr/bin/env python
"""Host-path micro-benchmark of the PyTorch port: decode / batch /
dispatch / egress in isolation, with a printed stage breakdown.

Counterpart of ``tools/hostpath_bench.py`` over ``sitewhere_tpu_torch``.
The overlapped host pipeline only pays off when the slowest stage, not
the sum of stages, bounds throughput.  This tool measures each stage
alone on the same synthetic traffic, so a regression localizes to one
stage instead of hiding in an end-to-end number:

- **decode**: ``decode_json_lines`` over an NDJSON measurement payload
  (the decode-pool worker's unit of work), with the fill-direct, native
  and pure-Python lanes A/B;
- **batch**: ``Batcher.add_arrays`` intake and packed emission (the
  dispatch thread's assembly stage);
- **h2d**: the copy of one packed batch to the device (the ring slot
  fill a staged ring hides behind compute);
- **dispatch**: one packed step from host columns (h2d, the step, the
  wait for it): the single-step host view;
- **dwell**: the device-side step time alone, from a ``ring_k``-step
  chain (``build_packed_chain``) timed between CUDA events on a card,
  with the host clock less the measured round trip on the CPU;
- **d2h**: blocking fetch of one step's output block and metrics;
- **egress**: ``SegmentStore.append_columns`` of one batch (the egress
  worker's unit of work);
- **seal split**: the segment store's hand-off against the background
  seal (``seal_perceived_s`` against ``seal_background_s``, the
  ``store.seal_s`` stage timer).

Also reports ``host_rtt_s`` (a trivial launch and its fetch) and
``host_syncs_per_batch`` for the single-step (1.0) and ring (1/ring_k)
paths, the flight recorder's per-batch record cost and the tenant
ledger's per-plan charge.  The dispatch and dwell steps launch the
geofence kernel (``csrc/pip_kernel.cu``) on a card.

Usage::

    python tools/torch_hostpath_bench.py                   # the card
    python tools/torch_hostpath_bench.py --device cpu --width 4096
    python tools/torch_hostpath_bench.py --json            # the dict
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _time_stage(fn, iters: int) -> float:
    """Median-of-iters wall seconds for one call of ``fn``."""
    samples = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        samples.append(time.perf_counter() - t0)
    samples.sort()
    return samples[len(samples) // 2]


def _payload(width: int) -> bytes:
    lines = [
        json.dumps({
            "deviceToken": f"dev-{i}", "type": "Measurement",
            "request": {"name": "temp", "value": 20.0 + (i % 7),
                        "eventDate": 1_753_800_000 + i},
        })
        for i in range(width)
    ]
    return ("\n".join(lines)).encode()


def _measure_rtt(device) -> float:
    """Median round trip of a trivial launch and its fetch (seconds): the
    shared probe from the telemetry library."""
    from sitewhere_tpu_torch.pipeline.telemetry import measure_rtt

    return measure_rtt(device=device)


def run(width: int = 2048, iters: int = 16, capacity: int = 16_384,
        ring_k: int = 8, data_dir: str | None = None,
        device="cuda") -> dict:
    """Every stage's median seconds and the derived bounds (the
    reference's keys); the device stages run on ``device``, the card
    unless ``"cpu"`` is named."""
    import numpy as np
    import torch

    from sitewhere_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    from sitewhere_tpu_torch.ids import NULL_ID, HandleSpace
    from sitewhere_tpu_torch.ingest.batcher import Batcher
    from sitewhere_tpu_torch.ingest.columnar import decode_json_lines, space_of

    results: dict = {"width": width, "iters": iters, "device": str(dev)}

    # -- decode --------------------------------------------------------------
    # Three-way A/B over the same payload (the zero-copy ingest story):
    #   fill    — fill-direct C scan straight into a batcher reservation
    #             (the production hot path; zero intermediate copies)
    #   native  — the classic C scanners returning intermediate buffers
    #             that Python re-materializes (the pre-fill-direct path,
    #             still the fallback; SW_NATIVE_FILL=0 forces it live)
    #   python  — the pure-Python columnar decoder (SW_NATIVE=0 behavior)
    from sitewhere_tpu_torch.ingest.columnar import (
        CopyTally,
        _decode_lines_inner,
        decode_fill_direct,
        parse_envelopes,
    )

    devices = HandleSpace("device", capacity)
    for i in range(width):
        devices.mint(f"dev-{i}")
    payload = _payload(width)
    results["payload_bytes"] = len(payload)
    space = space_of(devices.lookup)
    decode_json_lines(payload, device_space=space)  # warm (native build)
    results["decode_native_s"] = _time_stage(
        lambda: decode_json_lines(payload, device_space=space), iters)
    native_tally = CopyTally()
    decode_json_lines(payload, device_space=space, copied=native_tally)
    results["bytes_copied_per_event_native"] = native_tally.n / width
    results["decode_python_s"] = _time_stage(
        lambda: _decode_lines_inner(parse_envelopes(payload)), iters)

    fill_batcher = Batcher(
        width=width, n_shards=1, registry_capacity=capacity,
        resolve_device=devices.lookup, resolve_mtype=lambda n: 0,
        resolve_alert=lambda n: 0, deadline_ms=1e9, emit_packed=True)
    cap = payload.count(b"\n") + 1

    def decode_fill_once():
        res = fill_batcher.reserve(cap)
        if res is None or decode_fill_direct(
                payload, space, res, lambda n: 0) is None:
            raise RuntimeError("fill-direct path unavailable")
        res.abort()

    try:
        decode_fill_once()
        results["decode_s"] = results["decode_fill_s"] = _time_stage(
            decode_fill_once, iters)
        results["fill_direct"] = True
    except RuntimeError:
        # no native toolchain: the production decode stage IS the
        # classic path — keep the A/B keys meaningful
        results["decode_s"] = results["decode_fill_s"] = \
            results["decode_native_s"]
        results["fill_direct"] = False
    results["bytes_copied_per_event_fill"] = 0.0 if results["fill_direct"] \
        else results["bytes_copied_per_event_native"]
    results["decode_speedup_fill_vs_native"] = (
        results["decode_native_s"] / results["decode_fill_s"]
        if results["decode_fill_s"] else 0.0)

    # full fill-direct ingest (decode + commit + ADOPTED zero-copy
    # emission — what the dispatcher's hot path pays per payload)
    if results["fill_direct"]:
        def ingest_fill_once():
            res = fill_batcher.reserve(cap)
            n = decode_fill_direct(payload, space, res, lambda n: 0)
            res.set_const(tenant_id=0, payload_ref=1)
            plans = res.commit()
            if n != width or len(plans) != 1:
                raise RuntimeError("adoption did not engage")

        ingest_fill_once()
        before = fill_batcher.copied_bytes
        ingest_fill_once()
        results["bytes_copied_per_event_fill_ingest"] = (
            fill_batcher.copied_bytes - before) / width
        results["ingest_fill_s"] = _time_stage(ingest_fill_once, iters)

    # -- batch (packed emission, the dispatch-thread assembly) ---------------
    batcher = Batcher(
        width=width, n_shards=1, registry_capacity=capacity,
        resolve_device=devices.lookup, resolve_mtype=lambda n: 0,
        resolve_alert=lambda n: 0, deadline_ms=1e9, emit_packed=True)
    ids = np.arange(width, dtype=np.int32) % capacity
    vals = np.linspace(0.0, 1.0, width).astype(np.float32)

    def batch_once():
        plans = batcher.add_arrays(_copy=False, device_id=ids.copy(),
                                   value=vals)
        if not plans:
            batcher.flush()

    batch_once()
    before = batcher.copied_bytes
    batch_once()
    results["bytes_copied_per_event_batch"] = \
        (batcher.copied_bytes - before) / width
    results["batch_s"] = _time_stage(batch_once, iters)

    # end-to-end copy accounting (decode + batch assembly), the
    # "bytes copied per event" acceptance column: the classic path pays
    # intermediate decode buffers + the emission memcpy; the fill path
    # pays zero on both (adopted full-width reservation)
    native_total = (results["bytes_copied_per_event_native"]
                    + results["bytes_copied_per_event_batch"])
    fill_total = results.get("bytes_copied_per_event_fill_ingest",
                             results["bytes_copied_per_event_fill"])
    results["bytes_copied_per_event_native_total"] = native_total
    results["bytes_copied_per_event_fill_total"] = fill_total
    results["bytes_copied_reduction"] = (
        native_total / fill_total if fill_total > 0 else None)
    results["bytes_copied_3x"] = bool(
        fill_total == 0 or native_total / fill_total >= 3.0)

    # -- dispatch (one packed step from host columns) -------------------------
    from sitewhere_tpu_torch.pipeline.packed import (
        build_packed_chain,
        pack_state,
        pack_tables,
        packed_pipeline_step,
    )
    from sitewhere_tpu_torch.schema import (
        DeviceState,
        Registry,
        RuleTable,
        ZoneTable,
    )

    registry = Registry.empty(capacity, device=dev).replace(
        active=torch.arange(capacity, device=dev) < width,
        assignment_status=torch.ones(capacity, dtype=torch.int32,
                                     device=dev))
    tables = pack_tables(registry, RuleTable.empty(8, device=dev),
                         ZoneTable.empty(8, device=dev))
    state = pack_state(DeviceState.empty(capacity, device=dev))
    plan = batcher.add_arrays(_copy=False, device_id=ids.copy(),
                              value=vals) or [batcher.flush()]
    bi, bf = plan[0].packed_i, plan[0].packed_f

    def stage():
        return (torch.from_numpy(np.ascontiguousarray(bi)).to(dev),
                torch.from_numpy(np.ascontiguousarray(bf)).to(dev))

    packed_pipeline_step(tables, state, *stage())  # warm
    sync()

    def dispatch_once():
        packed_pipeline_step(tables, state, *stage())
        sync()

    results["dispatch_s"] = _time_stage(dispatch_once, iters)

    # -- h2d (the copy of one packed batch, the ring slot fill) --------------
    def h2d_once():
        stage()
        sync()

    h2d_once()
    results["h2d_stage_s"] = _time_stage(h2d_once, iters)

    # -- dwell (device-side step time from a chained ring_k-step run) --------
    rtt = _measure_rtt(dev)
    results["host_rtt_s"] = rtt
    staged_bi, staged_bf = stage()
    chain = build_packed_chain(ring_k)
    carry = pack_state(DeviceState.empty(capacity, device=dev))
    slots = [staged_bi] * ring_k + [staged_bf] * ring_k
    carry, ois, mets, present = chain(tables, carry, *slots)  # warm
    sync()
    samples = []
    for _ in range(max(2, iters // 4)):
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            carry, ois, mets, present = chain(tables, carry, *slots)
            end.record()
            end.synchronize()
            samples.append(start.elapsed_time(end) * 1e-3 / ring_k)
        else:
            t0 = time.perf_counter()
            carry, ois, mets, present = chain(tables, carry, *slots)
            int(mets[0][0])  # the whole chain has run
            samples.append(max(0.0, time.perf_counter() - t0 - rtt)
                           / ring_k)
    samples.sort()
    results["device_dwell_s"] = samples[len(samples) // 2]
    results["ring_chain_k"] = ring_k
    # how often the host must touch the device per dispatched batch
    results["host_syncs_per_batch_single"] = 1.0
    results["host_syncs_per_batch_ring"] = 1.0 / ring_k

    # -- d2h (blocking fetch of one step's outputs: the per-sync cost) -------
    # fresh outputs per sample
    outs = []
    for _ in range(iters):
        o = packed_pipeline_step(tables, state, staged_bi, staged_bf)
        outs.append((o[1], o[2]))
    sync()
    samples = []
    for oi_dev, met_dev in outs:
        t0 = time.perf_counter()
        oi_dev.cpu()
        met_dev.cpu()
        samples.append(time.perf_counter() - t0)
    samples.sort()
    results["d2h_fetch_s"] = samples[len(samples) // 2]

    # -- egress (segment-store append: the hot path's whole seal cost) -------
    from sitewhere_tpu_torch.runtime.metrics import MetricsRegistry
    from sitewhere_tpu_torch.store.segmented import SegmentStore

    tmp = data_dir or tempfile.mkdtemp(prefix="hostpath-bench-")
    try:
        store_metrics = MetricsRegistry()
        store = SegmentStore(tmp, flush_rows=1 << 30, flush_interval_s=1e9,
                             compact_interval_s=0.0, metrics=store_metrics)
        cols = {
            "device_id": ids, "tenant_id": np.zeros(width, np.int32),
            "event_type": np.zeros(width, np.int32),
            "ts_s": np.full(width, 1_753_800_000, np.int32),
            "ts_ns": np.zeros(width, np.int32),
            "mtype_id": np.zeros(width, np.int32), "value": vals,
            "lat": np.zeros(width, np.float32),
            "lon": np.zeros(width, np.float32),
            "elevation": np.zeros(width, np.float32),
            "alert_code": np.full(width, NULL_ID, np.int32),
            "alert_level": np.zeros(width, np.int32),
            "command_id": np.full(width, NULL_ID, np.int32),
            "payload_ref": np.full(width, NULL_ID, np.int32),
            "device_type_id": np.zeros(width, np.int32),
            "assignment_id": ids, "area_id": np.zeros(width, np.int32),
            "customer_id": np.zeros(width, np.int32),
            "asset_id": np.zeros(width, np.int32),
        }
        mask = np.ones(width, bool)

        def egress_once():
            # the offload worker's per-batch work is the append: a
            # shard-routed packed row copy (segment seal happens on the
            # background worker pool, off this path)
            store.append_columns(cols, mask=mask)

        egress_once()
        results["egress_s"] = _time_stage(egress_once, iters)
        t0 = time.perf_counter()
        store.flush()
        results["seal_s"] = time.perf_counter() - t0

        # -- seal hand-off vs background seal (the segment-store split) ------
        # perceived: a store whose buffers fill EVERY batch, with the
        # worker pool live — each append closes a shard buffer and
        # enqueues a seal job, so this measures the full hot-path seal
        # cost (copy + O(1) enqueue), never the npz write/fsync.
        seal_dir = os.path.join(tmp, "seal-split")
        pool_metrics = MetricsRegistry()
        pool_store = SegmentStore(
            seal_dir, flush_rows=width, flush_interval_s=1e9,
            compact_interval_s=0.0, metrics=pool_metrics)
        pool_store.sealer.start()
        try:
            pool_store.append_columns(cols, mask=mask)  # warm buffers
            results["seal_perceived_s"] = _time_stage(
                lambda: pool_store.append_columns(cols, mask=mask), iters)
            pool_store.flush()
            # the background stage timer: store.seal_s observes each
            # worker's build+write wall time, off the perceived path
            hist = pool_metrics.histogram("store.seal_s")
            results["seal_background_s"] = (
                hist.total / hist.count if hist.count else 0.0)
            results["seal_background_segments"] = int(hist.count)
        finally:
            pool_store.sealer.stop()
    finally:
        if data_dir is None:
            shutil.rmtree(tmp, ignore_errors=True)

    # -- flight recorder (the always-on per-batch record cost) ---------------
    # The recorder's acceptance bar is <1% of per-batch host budget: one
    # dict build + deque append, memory-only here (snapshot I/O happens
    # only on anomaly, off the steady-state path).
    from sitewhere_tpu_torch.runtime.flightrec import FlightRecorder

    rec = FlightRecorder(data_dir=None, capacity=2048)

    def record_once():
        rec.record(seq=1, reason="fill", rows=width, fill=1.0, slot=0,
                   replay_depth=0, wait_ms=0.1, dispatch_ms=0.2,
                   egress_ms=0.3, e2e_ms=1.0, overload="NORMAL",
                   trace_id=None, commit="ok")

    record_once()
    results["flightrec_record_s"] = _time_stage(
        record_once, max(iters, 256))

    # -- tenant metering (the per-plan ledger charge cost) -------------------
    # Same acceptance bar as the recorder: <1% of the per-batch host
    # budget.  The device already bucketed rows/writes/nonfinite per
    # tenant inside the step (zero extra syncs); the host-side
    # residue measured here is one bucket→tenant attribution over the
    # retained tenant column plus the sketch/window fold.
    from sitewhere_tpu_torch.pipeline.packed import (
        TENANT_METER_COUNTERS,
        TENANT_METER_SLOTS,
    )
    from sitewhere_tpu_torch.runtime.metering import UsageLedger

    ledger = UsageLedger()
    meter_tenants = (np.arange(width, dtype=np.int32) % 7).astype(np.int32)
    meter_block = np.zeros(
        (len(TENANT_METER_COUNTERS), TENANT_METER_SLOTS), np.int64)
    counts = np.bincount(meter_tenants % TENANT_METER_SLOTS,
                         minlength=TENANT_METER_SLOTS)
    meter_block[0] = counts          # rows
    meter_block[1] = counts          # state_writes

    def meter_once():
        ledger.charge_device_block(meter_block, meter_tenants,
                                   decode_s=1e-4)

    meter_once()
    results["metering_charge_s"] = _time_stage(meter_once, max(iters, 256))

    serial = sum(results[k] for k in
                 ("decode_s", "batch_s", "dispatch_s", "egress_s"))
    bound = max(results[k] for k in
                ("decode_s", "batch_s", "dispatch_s", "egress_s"))
    results["serial_s"] = serial
    results["pipeline_bound_s"] = bound
    results["serial_events_per_s"] = width / serial if serial else 0.0
    results["overlapped_events_per_s"] = width / bound if bound else 0.0
    # per-batch recorder cost over the stage that bounds throughput —
    # the "<1% throughput delta" acceptance number
    results["flightrec_overhead_frac"] = (
        results["flightrec_record_s"] / bound if bound else 0.0)
    results["metering_overhead_frac"] = (
        results["metering_charge_s"] / bound if bound else 0.0)
    return results


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="host-path stage breakdown (decode/batch/dispatch/egress)")
    parser.add_argument("--width", type=int, default=2048,
                        help="events per payload/batch")
    parser.add_argument("--iters", type=int, default=16,
                        help="timing iterations per stage (median)")
    parser.add_argument("--capacity", type=int, default=16_384)
    parser.add_argument("--ring-k", type=int, default=8,
                        help="chain depth for the device-dwell probe "
                             "(the dispatcher ring's K)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("--json", action="store_true",
                        help="print the raw results dict as JSON")
    args = parser.parse_args(argv)

    r = run(width=args.width, iters=args.iters, capacity=args.capacity,
            ring_k=args.ring_k, device=args.device)
    if args.json:
        print(json.dumps(r, indent=2))
        return 0
    print(f"host-path stage breakdown  (width={r['width']}, "
          f"iters={r['iters']}, median)")
    for stage, key in (("decode", "decode_s"), ("batch", "batch_s"),
                       ("h2d", "h2d_stage_s"), ("dispatch", "dispatch_s"),
                       ("dwell", "device_dwell_s"), ("d2h", "d2h_fetch_s"),
                       ("egress", "egress_s")):
        s = r[key]
        rate = r["width"] / s if s else float("inf")
        print(f"  {stage:<9} {s * 1e3:9.3f} ms/batch   {rate:12,.0f} events/s")
    # zero-copy ingest A/B (decode stage + copy accounting)
    mode = "fill-direct" if r.get("fill_direct") else "no native toolchain"
    print(f"  decode A/B ({mode}): fill {r['decode_fill_s'] * 1e3:.3f} ms"
          f" | native {r['decode_native_s'] * 1e3:.3f} ms"
          f" | python {r['decode_python_s'] * 1e3:.3f} ms"
          f"  → {r['decode_speedup_fill_vs_native']:.2f}x vs native")
    red = r.get("bytes_copied_reduction")
    print(f"  bytes copied/event: fill "
          f"{r['bytes_copied_per_event_fill_total']:.1f} B"
          f" | native {r['bytes_copied_per_event_native_total']:.1f} B"
          f" ({'∞' if red is None else f'{red:.1f}x'} reduction)")
    print(f"  {'serial':<9} {r['serial_s'] * 1e3:9.3f} ms/batch   "
          f"{r['serial_events_per_s']:12,.0f} events/s")
    print(f"  pipeline bound (max stage): "
          f"{r['pipeline_bound_s'] * 1e3:.3f} ms/batch → "
          f"{r['overlapped_events_per_s']:,.0f} events/s overlapped")
    print(f"  host sync floor: rtt {r['host_rtt_s'] * 1e3:.3f} ms — "
          f"host_syncs/batch 1.0 single-step, "
          f"{r['host_syncs_per_batch_ring']:.3f} ring "
          f"(K={r['ring_chain_k']} chained)")
    print(f"  flight recorder: {r['flightrec_record_s'] * 1e6:.2f} "
          f"µs/batch record — "
          f"{r['flightrec_overhead_frac'] * 100:.4f}% of the pipeline "
          f"bound (<1% = always-on is free)")
    print(f"  tenant metering: {r['metering_charge_s'] * 1e6:.2f} "
          f"µs/batch charge — "
          f"{r['metering_overhead_frac'] * 100:.4f}% of the pipeline "
          f"bound (<1% = metering-on is free)")
    print(f"  (one-time seal of {r['iters'] + 1} buffered batches: "
          f"{r['seal_s'] * 1e3:.3f} ms — amortized at commit points)")
    print(f"  seal split: perceived {r['seal_perceived_s'] * 1e3:.3f} "
          f"ms/batch on the hot path (copy + enqueue) | background "
          f"{r['seal_background_s'] * 1e3:.3f} ms/segment on the worker "
          f"pool ({r['seal_background_segments']} segments sealed)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
