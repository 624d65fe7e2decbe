#!/usr/bin/env python
"""The port's packed-step latency against batch width.

Counterpart of ``tools/width_sweep.py``.  For each width it chains
``chain_k`` packed steps over pre-staged batches (the ring's K-chain,
``pipeline/packed.py build_packed_chain``) and reports ``step_ms``, the
chain's time per step, and beside it the host side a ring slot adds: the
host-to-device staging of one packed batch (``h2d_ms``), the blocking
device-to-host fetch of one step's outputs and metrics (``d2h_ms``), and
the per-batch host budget ``rtt/K + h2d + d2h``.

On the card ``step_ms`` is the time between two CUDA events recorded
around the chain (no round trip to subtract; ``rtt_ms`` is still measured
and reported).  The port's chain is eager: the host launches each of its
kernels, so that time is bound by the host's launches and is not the
device's busy time; ``device_eps`` is ``width / step_ms``.  On the CPU
the chain is timed with the host clock.  Every step launches the geofence
kernel (``csrc/pip_kernel.cu``) on a card.  The workload builders are
this tool's own copies of the reference bench's ``build_tables`` and
``host_batches``.

Usage::

    python tools/torch_width_sweep.py [width ...]
    python tools/torch_width_sweep.py --device cpu 1024 4096
    python tools/torch_width_sweep.py --capacity 1048576 --active 1000000 \\
        --json 16384 65536 131072

Prints one ``width=...`` line per width (the reference's keys);
``--json`` prints one JSON object with every width's record.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

DEFAULT_WIDTHS = (4_096, 16_384, 131_072, 262_144)


def build_tables(capacity: int, n_active: int, device, n_tenants: int = 1,
                 n_zones: int = 1):
    """``(registry, state, rules, zones)``: ``n_active`` assigned devices,
    one threshold rule, ``n_zones`` square zones in a 64-zone table of 16
    vertices (the reference bench's ``build_tables``)."""
    import torch

    from sitewhere_tpu_torch.ops.geo import pad_polygon
    from sitewhere_tpu_torch.schema import (
        AssignmentStatus,
        DeviceState,
        Registry,
        RuleTable,
        ZoneTable,
    )

    idx = torch.arange(capacity, device=device)
    on = idx < n_active

    def where(v):
        return torch.where(on, v, torch.full_like(idx, -1)).to(torch.int32)

    registry = Registry.empty(capacity, device=device).replace(
        active=on,
        tenant_id=where(idx % n_tenants),
        device_type_id=where(torch.zeros_like(idx)),
        assignment_id=where(idx),
        assignment_status=torch.where(
            on, int(AssignmentStatus.ACTIVE), 0).to(torch.int32),
        area_id=where(torch.ones_like(idx)),
        customer_id=where(torch.full_like(idx, 2)),
        asset_id=where(torch.full_like(idx, 3)),
    )
    state = DeviceState.empty(capacity, device=device)
    rules = RuleTable.empty(64, device=device)
    rules.active[0] = True
    rules.mtype_id[0] = 0
    rules.op[0] = 0
    rules.threshold[0] = 90.0
    rules.alert_code[0] = 7
    zones = ZoneTable.empty(64, max_verts=16, device=device)
    for z in range(n_zones):
        lo, hi = z * 2.0, z * 2.0 + 10.0
        padded = pad_polygon([[lo, lo], [hi, lo], [hi, hi], [lo, hi]], 16)
        zones.active[z] = True
        zones.verts[z] = torch.from_numpy(padded).to(device)
        zones.nvert[z] = 4
        zones.alert_code[z] = 9
    return registry, state, rules, zones


def host_batches(width: int, n_active: int, n_batches: int,
                 n_tenants: int = 1, seed: int = 0):
    """``n_batches`` distinct host (numpy) event batches (the reference
    bench's ``host_batches``)."""
    rng = np.random.default_rng(seed)
    batches = []
    for _ in range(n_batches):
        device_id = rng.integers(0, n_active, width).astype(np.int32)
        batches.append(dict(
            valid=np.ones(width, bool),
            device_id=device_id,
            tenant_id=(device_id % n_tenants).astype(np.int32),
            event_type=(rng.random(width) < 0.5).astype(np.int32),
            ts_s=np.full(width, 1_753_800_000, np.int32),
            ts_ns=rng.integers(0, 1_000_000_000, width).astype(np.int32),
            mtype_id=np.zeros(width, np.int32),
            value=rng.uniform(0, 100, width).astype(np.float32),
            lat=rng.uniform(-20, 20, width).astype(np.float32),
            lon=rng.uniform(-20, 20, width).astype(np.float32),
            elevation=np.zeros(width, np.float32),
            alert_code=np.full(width, -1, np.int32),
            alert_level=np.zeros(width, np.int32),
            command_id=np.full(width, -1, np.int32),
            payload_ref=np.arange(width, dtype=np.int32),
            update_state=np.ones(width, bool),
        ))
    return batches


def _median(fn, n=3):
    samples = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        samples.append(time.perf_counter() - t0)
    samples.sort()
    return samples[len(samples) // 2]


def sweep_width(width, tables, state, n_active, chain_k, n_batches, rtt_s,
                device):
    """One width's record (the reference's printed keys)."""
    import torch

    from sitewhere_tpu_torch.pipeline.packed import (
        build_packed_chain,
        pack_batch_host,
        pack_state,
        packed_pipeline_step,
    )

    on_card = device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    raw = host_batches(width, n_active, n_batches)
    packed = [pack_batch_host(b, width) for b in raw]

    # H2D stage: one packed (bi, bf) pair to the device, the ring slot
    # fill a staged ring hides behind compute
    def h2d_once(pair=packed[0]):
        for a in pair:
            torch.from_numpy(a).to(device)
        sync()

    h2d_once()
    h2d_ms = _median(h2d_once) * 1e3

    staged = [tuple(torch.from_numpy(a).to(device) for a in pair)
              for pair in packed]
    slots = ([staged[i % n_batches][0] for i in range(chain_k)]
             + [staged[i % n_batches][1] for i in range(chain_k)])
    chain = build_packed_chain(chain_k)
    carry = pack_state(state)
    carry, ois, mets, present = chain(tables, carry, *slots)  # settle
    sync()
    best = None
    for _ in range(3):
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            carry, ois, mets, present = chain(tables, carry, *slots)
            end.record()
            end.synchronize()
            step_ms = start.elapsed_time(end) / chain_k
        else:
            t0 = time.perf_counter()
            carry, ois, mets, present = chain(tables, carry, *slots)
            step_ms = (time.perf_counter() - t0) / chain_k * 1e3
        best = step_ms if best is None else min(best, step_ms)

    # D2H fetch: one step's output block and metrics, fresh buffers per
    # sample
    d2h = []
    for _ in range(3):
        _, oi, met, _present = packed_pipeline_step(tables, carry,
                                                    *staged[0])
        sync()
        t0 = time.perf_counter()
        oi.cpu()
        met.cpu()
        d2h.append(time.perf_counter() - t0)
    d2h.sort()
    d2h_ms = d2h[1] * 1e3

    # a K-deep ring slot's host cost: one dispatch-and-fetch round trip
    # amortised over K, plus its own staging and fetch
    ring_host_ms = rtt_s * 1e3 / chain_k + h2d_ms + d2h_ms
    return {"width": width, "step_ms": best,
            "device_eps": width / best * 1e3 if best > 0 else None,
            "h2d_ms": h2d_ms, "d2h_ms": d2h_ms,
            "ring_host_ms_per_batch": ring_host_ms,
            "host_syncs_per_batch": 1.0 / chain_k, "chain_k": chain_k}


def run(widths=DEFAULT_WIDTHS, capacity: int = 16_384, active: int = 10_000,
        chain_k: int = 64, n_batches: int = 4, device="cuda",
        out=None) -> dict:
    """Sweep ``widths``; returns ``{"device", "capacity", "active",
    "rtt_ms", "widths": [record, ...]}``.  ``out`` (a callable) gets each
    width's record as it lands."""
    from sitewhere_tpu_torch.device import resolve_device
    from sitewhere_tpu_torch.pipeline.packed import pack_tables
    from sitewhere_tpu_torch.pipeline.telemetry import measure_rtt

    dev = resolve_device(device)
    registry, state, rules, zones = build_tables(capacity, active, dev)
    tables = pack_tables(registry, rules, zones)
    rtt = measure_rtt(device=dev)
    result = {"device": str(dev), "capacity": capacity, "active": active,
              "rtt_ms": rtt * 1e3, "widths": []}
    for width in widths:
        rec = sweep_width(width, tables, state, active, chain_k, n_batches,
                          rtt, dev)
        result["widths"].append(rec)
        if out is not None:
            out(rec)
    return result


def _line(rec) -> str:
    return (f"width={rec['width']} step_ms={rec['step_ms']:.3f} "
            f"device_eps={rec['device_eps'] / 1e6:.2f}M "
            f"h2d_ms={rec['h2d_ms']:.3f} d2h_ms={rec['d2h_ms']:.3f} "
            f"ring_host_ms_per_batch={rec['ring_host_ms_per_batch']:.3f} "
            f"host_syncs_per_batch={rec['host_syncs_per_batch']:.4f}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="packed-step latency against batch width")
    parser.add_argument("widths", nargs="*", type=int)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("--capacity", type=int, default=16_384)
    parser.add_argument("--active", type=int, default=10_000)
    parser.add_argument("--chain-k", type=int, default=64)
    parser.add_argument("--batches", type=int, default=4)
    parser.add_argument("--json", action="store_true",
                        help="print one JSON object instead of lines")
    args = parser.parse_args(argv)
    widths = tuple(args.widths) or DEFAULT_WIDTHS
    printer = None if args.json else (lambda r: print(_line(r), flush=True))
    if not args.json:
        print(f"device: {args.device}", flush=True)
    result = run(widths, capacity=args.capacity, active=args.active,
                 chain_k=args.chain_k, n_batches=args.batches,
                 device=args.device, out=printer)
    if args.json:
        print(json.dumps(result))
    else:
        print(f"rtt_ms={result['rtt_ms']:.3f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
