#!/usr/bin/env python3
"""Drive the PyTorch port (``sitewhere_tpu_torch``) on one CUDA card.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, each printing one JSON line; any failed check raises and the
script exits non-zero without printing a result:

1. the card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build the geofence kernel (``csrc/pip_kernel.cu``) with ``nvcc`` and,
   at the same time, the native wire tier's C scanners
   (``native/swwire.c``) with ``cc``;
3. hold the kernel against its plain PyTorch version, bitwise, at the main
   path's shape (B=131072 points, Z=512 zones, V=16) and at edge shapes,
   and time both with CUDA events;
4. the main path at full size: a registry of 2^20 slots with 1,000,000
   assigned devices over 8 tenants, 64 rules, 512 zones, batches of
   131072 events, rings of K=8 through ``runtime/ring.py``; events/s,
   ms per ring, host syncs per batch, and the kernel's launch count;
5. one ring rerun from the same carry with the plain geofence: every
   output and the new carry must be identical;
6. the dispatcher's wire path (``dispatcher_wire``) on the same
   deployment, written through ``RegistryMirror`` and ``RuleManager``:
   NDJSON bytes -> journal -> native decode -> batcher -> step -> egress
   -> offset commit.  First the proof that the native tier is on the
   path (run ``native``): the scanner library's path and build seconds,
   ``native.build_fallbacks`` 0, and on one full-size payload of each
   kind the C lane (fill-direct into a reservation for measurements,
   the event-family scanner for the 60/30/10 mix) equal, column for
   column, to the pure-Python decode of the same bytes, with each lane's
   ms per payload.  Then full-width payloads (131072 lines, 60/30/10
   measurements/locations/alerts), 3 rings' worth, at the deployment's
   5 ms batcher deadline with the ring at K=8 and with it off: events/s,
   latency per plan from the payload's receipt (before its decode) to
   egress, p50 and max, host ms per stage, bytes copied per event by
   decode and batch, host syncs per batch, and the summed CUDA-event
   span of the card's steps.  Then a diagnostic run with a 60 s deadline,
   where the ring forms; the same 5 ms ring-off run over measurement-only
   payloads (fill-direct, every plan adopted); a paced region at width
   4096 (deadline 3.5 ms, 50% of the measured capacity, latency from each
   payload's scheduled arrival); and short profiled reruns for the card's
   busy share.  Checks: kernel launches == dispatcher steps, accepted
   rows == registered lines + derived alerts, committed offset == journal
   records; in the diagnostic run, host syncs per batch == 1/8 over the
   ring's steps and the last dispatched ring rerun with the plain
   geofence from its carry, bitwise; in the measurement-only run, adopted
   plans == full-width measurement plans and 0 bytes copied per event by
   decode and batch;
7. persistence and restart through the port ``Instance`` (phase
   ``persist_recover``), its segment store and journal at the Config
   defaults, under a temporary directory that is removed afterwards.
   ``persist_throughput``: the same two kinds of full-width payloads,
   ring off at 5 ms, with the real store: events/s, latency, persist ms
   per plan, ``flush`` ms per commit, segments sealed, bytes on disk and
   the step span; checks: rows stored == rows accepted (registered lines
   + derived alerts), committed offset == journal records, and after
   ``stop()`` the stored rows equal the accepted rows exactly once (an
   order-independent checksum).  ``checkpoint_full``: one save of the
   loaded instance and a restore into a fresh one, seconds and bytes per
   section; check: the restored state bitwise equal to the saved.
   ``kill_recover``: golden children and one child per crash point
   (``crash.mid_egress`` at full size; ``crash.mid_ring``,
   ``crash.post_journal``, ``crash.mid_seal`` and ``crash.pre_manifest``
   at 2^16 slots, 50,000 devices, width 4096) run measurement payloads
   with a checkpoint every 8, the killed ones under
   ``SW_CRASHPOINT=<point>:<n>``; a fresh process restarts on each
   survivor's directory and completes the workload; checks: no journaled
   row lost, rows below the committed offset at the kill stored once,
   the device state equal to the golden run's (ints exact, EWMA within 4
   ULPs of the value scale, other floats bitwise), kernel launches ==
   steps; reports the boot, restore, warm-up and replay seconds;
8. bring-your-own rule programs (phase ``byo_rules``).  ``rules_engine``:
   a ``RuleEngineRunner`` at the deployment's size (2^20 slots, 8
   measurement slots, K=3) with 4 programs of each of the five structure
   keys (c2p4, c2p4g, c4p4, c4p4g, c4p8) for each of the 8 world
   tenants, set to fire on about 1% of rows, the device ``tier`` of
   every active device and the ``grade`` of every asset, and a
   population of 20,000 programs from ``tools/rulebench.py``'s mix over
   5,000 more tenants; 24 full-width 60/30/10 batches straight into
   ``_eval_batch``: ms per batch of the prepare pass and of each group
   pass (CUDA events), each pass's transient peak, engine events/s, and
   6 more under the profiler for the card's busy share; checks at 8192
   rows, the passes on the card against the port's CPU run from the same
   trail (fired/code/level/pid and trail ints exact, EWMA within 4 ULPs
   of the value scale, rate within 4 ULPs), and at 2048 rows the card's
   alerts against the port's numpy ``interp``.  ``rules_wire``: the
   60/30/10 payloads through the port ``Instance`` as in
   ``persist_throughput``, without programs and with them (the default
   tenant's 20, the population, the attributes): events/s, latency, the
   step span and the ``rules.*`` metrics; checks: every program alert
   the engine injected is stored exactly once, stored = accepted
   (registered lines + derived alerts, program alerts among them);
   ``checkpoint_full`` with the ``rule-programs`` section: programs and
   attributes come back as saved;
9. streaming analytics (phase ``streaming_analytics``), four queries: a
   60 s tumbling mean, a 60 s x 4 sliding max, a count >= 3 session with
   a 120 s gap, and a window-mean cross then an alert within 60 s, with
   thresholds where about 1% of windows match; event time advances at
   one report per device per 60 s and values lie on a 1/8 grid.
   ``analytics_engine``: a ``QueryRunner`` at the deployment's size
   (2^20 slots, 1,000,000 devices), 24 full-width batches straight into
   ``_eval_batch``: card ms per batch of each query (CUDA events) beside
   its HBM bound, CEP passes, host copies and transient peak per batch,
   state bytes, events/s, and the busy share under the profiler;
   ``card_vs_cpu``: 8192 rows in two batches through the four queries on
   the card and on the CPU, matches and state bitwise equal;
   ``analytics_wire``: rules_wire.on's run with the four queries
   registered, on payloads of the same shape regenerated with this
   phase's event time: the ``analytics.*`` metrics, and every query's
   live matches equal to ``run_retrospective`` over the sealed store
   (``analytics.live_dropped`` must be 0); ``checkpoint_full.analytics``:
   the operator state restored bitwise;
10. a small input run on the card and on the CPU: identical int outputs.

The line before the last is the card's ``nvidia-smi`` name and power
limit; before it, the kernels' JSON record.  The last line is
``{"ok": true, "device": {...}}``.  Without a CUDA card the script exits
non-zero and prints no result.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import functools
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W).  The 67
# TFLOP/s float32 rate counts an FMA as two operations: an instruction
# that is not an FMA (the kernel, built with -fmad=false, issues none) runs
# at half of it.  The INT32/logic units issue at half the FP32 lanes' rate.
PEAK_FP32_INSTR = 67e12 / 2  # float32 instructions/s
PEAK_INT32_INSTR = PEAK_FP32_INSTR / 2
PEAK_HBM_BYTES = 3.35e12     # bytes/s

FULL_B, FULL_Z, FULL_V = 131072, 512, 16
CAPACITY, N_ACTIVE, N_TENANTS = 1 << 20, 1_000_000, 8
M_SLOTS, K_SCALES, N_RULES = 8, 3, 64
RING_K, TIMED_RINGS = 8, 16
SEED = 20261016
# the wire path (phase dispatcher_wire)
WIRE_PAYLOADS = 3 * RING_K        # full-width payloads: 3 rings at K=8
WIRE_GHOSTS = 0.005               # share of lines from unregistered tokens
# The deployment's batcher deadline (README.md:99-105).  A ring lingers
# one deadline at most, and even the native decode takes far longer than
# that for K full payloads, so at this deadline every ring drains
# single-step.
WIRE_DEADLINE_MS = 5.0
# Diagnostic only, not the deployment: a deadline long enough for K
# payloads to decode, so the ring forms and its checks run.
RING_DIAG_DEADLINE_MS = 60_000.0
PACED_WIDTH, PACED_LINES, PACED_DEADLINE_MS = 4096, 1024, 3.5
PACED_PAYLOADS, PACED_BURST, PACED_UTIL = 128, 32, 0.5
# payloads of the profiled reruns (the card's kernel and copy time)
PROFILED_PAYLOADS, PROFILED_PACED = RING_K, 32
WIRE_TS0_MS = 1_700_000_000_000
WIRE_STAGES = ("decode", "batch", "dispatch", "ring_dispatch", "egress")
# Measurement values of the measurement-only run: a band where no rule of
# the world fires (instant rules sit below 0.1 and above 99.9, window
# means above 99, rates above 95/s; a 20-wide band over >= 0.25 s gaps
# stays under 80/s), so no derived-alert rows join the batcher between
# the payloads and every full-width payload can be adopted as its plan.
MEAS_VALUE_BAND = (20.0, 40.0)
# bring-your-own rule programs (phase byo_rules): every world tenant holds
# RULE_PER_KEY programs of each structure key RULEBENCH_r01.json lists,
# which fills every group's S = 4 slots for every row; on top, a
# population from tools/rulebench.py's mix, cut from that tool's 100,000
# programs over 25,000 tenants
RULE_KEYS = ("c2p4", "c2p4g", "c4p4", "c4p4g", "c4p8")
RULE_PER_KEY = 4
RULE_POP_PROGRAMS, RULE_POP_TENANTS = 20_000, 5_000
RULE_ASSET_CAPACITY = 8192        # the world's 5000 assets, pow2
RULE_BATCHES, RULE_PROFILED = 24, 6
RULE_CPU_ROWS, RULE_INTERP_ROWS = 8192, 2048
# the share of traffic rows the world programs fire on (the wire world's
# built-in derived-alert rate is 1.1%): a geofence square's side is
# sqrt(RULE_SQUARE_SHARE) of the traffic's box
RULE_SQUARE_SHARE = 0.0011
RATE_MAX_ULP = 4.0
# streaming analytics (phase streaming_analytics): event time advances at
# the fleet's reporting rate, each device once per AN_REPORT_S on average,
# so a full-width batch spans FULL_B / N_ACTIVE * AN_REPORT_S seconds
AN_REPORT_S = 60.0
AN_BATCHES, AN_PROFILED = 24, 4
AN_CPU_ROWS, AN_CPU_DEVICES = 8192, 4096
# values: a set point and signed deviations on a 1/8 grid (a sensor of
# 0.125 resolution), 50 +- 48: every window sum and sum of squares is exact
# in float32 whatever the order, and the world's instant rules (below 0.1,
# above 99.9) never fire
AN_SET_POINT, AN_SPREAD_EIGHTHS = 50.0, 384
# the cross feature's prefix sums stay exact while every |prefix| is under
# 2^21 (2^24 eighths); each generated batch is checked against it
AN_PREFIX_BOUND = float(1 << 21)
# thresholds where about 1% of windows match: a window's mean (mostly one
# sample) above 97.0 is 1.04% of a uniform 2..98; the trailing 4-hop max
# above 97.75 about 1% at ~4 samples
AN_QUERIES = (
    {"kind": "window", "name": "temp-mean", "mtype": "m0", "agg": "mean",
     "op": "gt", "threshold": 97.0, "windowS": 60},
    {"kind": "window", "name": "temp-max4", "mtype": "m0", "agg": "max",
     "op": "gt", "threshold": 97.75, "windowS": 60, "length": 4},
    {"kind": "session", "name": "burst", "gapS": 120, "agg": "count",
     "op": "gte", "threshold": 3.0},
    {"kind": "pattern", "name": "cross-alert", "windowS": 60,
     "crossOp": "gt", "crossThreshold": 97.0, "crossMtype": "m0",
     "steps": [{"windowCross": True},
               {"eventType": "alert", "withinS": 60}]},
)
# instructions per edge test in the kernel: float32 - 2 compares
# (straddle), sub, mul, add, 1 compare (px < x_cross); logic - the
# straddle xor and the and-xor into the parity
PIP_FLOAT_PER_TEST = 6
PIP_LOGIC_PER_TEST = 2


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# -- inputs -------------------------------------------------------------------


def random_polygons(gen, z, v, lo, hi, rmin, rmax, device):
    """``z`` random convex polygons of 3..v vertices in the box
    ``[lo, hi]^2``, padded to ``v`` by repeating the last vertex."""
    import torch

    n = torch.randint(3, v + 1, (z,), generator=gen, device=device)
    ang = torch.sort(torch.rand((z, v), generator=gen, device=device)
                     * (2 * math.pi), dim=1).values
    keep = torch.minimum(torch.arange(v, device=device)[None, :], n[:, None] - 1)
    ang = torch.gather(ang, 1, keep)
    center = lo + (hi - lo) * torch.rand((z, 1, 2), generator=gen, device=device)
    radius = rmin + (rmax - rmin) * torch.rand((z, 1), generator=gen,
                                               device=device)
    ring = torch.stack([torch.cos(ang), torch.sin(ang)], dim=-1) * radius[..., None]
    return (center + ring).to(torch.float32).contiguous()


def edge_cases(gen, device):
    """(name, points, verts) shapes off the tile grid and edge geometry."""
    import torch

    cases = []
    pts = lambda b, lo, hi: (lo + (hi - lo) * torch.rand(  # noqa: E731
        (b, 2), generator=gen, device=device)).contiguous()
    cases.append(("B1000_Z130_V16", pts(1000, -60, 60),
                  random_polygons(gen, 130, 16, -50, 50, 1, 20, device)))
    cases.append(("B4097_Z1_V8", pts(4097, -30, 30),
                  random_polygons(gen, 1, 8, -5, 5, 10, 20, device)))
    cases.append(("B777_Z33_V32", pts(777, -60, 60),
                  random_polygons(gen, 33, 32, -50, 50, 1, 30, device)))
    cases.append(("B300_Z40_V40", pts(300, -60, 60),
                  random_polygons(gen, 40, 40, -50, 50, 1, 30, device)))
    cases.append(("B513_Z70_V3", pts(513, -60, 60),
                  random_polygons(gen, 70, 3, -50, 50, 5, 30, device)))
    # axis-aligned rectangles (horizontal edges), lattice points on their
    # edges and corners, V=5 (planes padded to 8)
    lo = torch.randint(-8, 8, (37, 2), generator=gen, device=device).float()
    size = torch.randint(1, 6, (37, 2), generator=gen, device=device).float()
    x0, y0 = lo[:, 0], lo[:, 1]
    x1, y1 = x0 + size[:, 0], y0 + size[:, 1]
    rect = torch.stack([torch.stack([x0, y0], -1), torch.stack([x1, y0], -1),
                        torch.stack([x1, y1], -1), torch.stack([x0, y1], -1),
                        torch.stack([x0, y1], -1)], dim=1)
    g = torch.arange(-10, 14.5, 0.5, device=device)
    lattice = torch.cartesian_prod(g, g).to(torch.float32).contiguous()
    cases.append(("rects_lattice_V5", lattice, rect.contiguous()))
    # padded degenerate (all-zero) zones among real ones, points at origin
    verts = random_polygons(gen, 64, 16, -20, 20, 1, 15, device)
    verts[::3] = 0.0
    p = pts(2000, -25, 25)
    p[:100] = 0.0
    cases.append(("degenerate_zones", p, verts))
    return cases


def make_world(device, capacity, n_active, n_rules, n_zones, n_verts, seed):
    """Registry, rules and zones of the main-path deployment, on device."""
    import torch

    from sitewhere_tpu_torch.schema import (
        AssignmentStatus, Registry, RuleTable, ZoneTable)

    gen = torch.Generator(device=device).manual_seed(seed)
    ids = torch.arange(capacity, dtype=torch.int32, device=device)
    on = ids < n_active
    null = torch.full_like(ids, -1)
    registry = Registry(
        active=on,
        tenant_id=torch.where(on, ids % N_TENANTS, null),
        device_type_id=torch.where(on, ids % 16, null),
        assignment_id=torch.where(on, ids, null),
        assignment_status=torch.where(
            on, int(AssignmentStatus.ACTIVE), int(AssignmentStatus.NONE)
        ).to(torch.int32),
        area_id=torch.where(on, ids % 64, null),
        customer_id=torch.where(on, ids % 1000, null),
        asset_id=torch.where(on, ids % 5000, null),
        epoch=torch.zeros((), dtype=torch.int32, device=device),
    )

    r = torch.arange(n_rules, dtype=torch.int32, device=device)
    kind = r % 3                       # INSTANT, WINDOW_MEAN, RATE_PER_S
    u = torch.rand(n_rules, generator=gen, device=device)
    threshold = torch.where(kind == 2, (u - 0.5) * 160.0, u * 100.0)
    rules = RuleTable(
        active=torch.ones(n_rules, dtype=torch.bool, device=device),
        tenant_id=torch.where(r % 2 == 0, -1, (r // 2) % N_TENANTS).to(torch.int32),
        mtype_id=torch.where(r % 4 == 1, -1, r % M_SLOTS).to(torch.int32),
        op=((r // 3) % 6).to(torch.int32),
        threshold=threshold.to(torch.float32),
        alert_code=1000 + r,
        alert_level=r % 4,
        kind=kind,
        window_idx=(r // 3) % K_SCALES,
        ewma_tau_s=torch.tensor([60.0, 600.0, 3600.0], device=device),
    )

    z = torch.arange(n_zones, dtype=torch.int32, device=device)
    zones = ZoneTable(
        active=torch.ones(n_zones, dtype=torch.bool, device=device),
        tenant_id=torch.where(z % 2 == 0, -1, z % N_TENANTS).to(torch.int32),
        area_id=torch.where(z % 4 == 3, z % 64, -1).to(torch.int32),
        verts=random_polygons(gen, n_zones, n_verts, -10, 10, 0.2, 3, device),
        nvert=torch.full((n_zones,), n_verts, dtype=torch.int32, device=device),
        condition=(z % 4 == 1).to(torch.int32),  # 1/4 ALERT_IF_OUTSIDE
        alert_code=2000 + z,
        alert_level=z % 4,
    )
    return registry, rules, zones


def make_batch_cols(rng, width, n_active, capacity, ts_s):
    """One batch of decoded host columns: ~60% measurements, 30% locations,
    10% alerts; a few invalid, unregistered, tenant-mismatched and NaN
    rows."""
    dev = rng.integers(0, n_active, width).astype(np.int32)
    unreg = rng.random(width) < 0.005
    dev[unreg] = rng.integers(n_active, capacity + 100, int(unreg.sum()))
    tenant = (dev % N_TENANTS).astype(np.int32)
    mism = rng.random(width) < 0.002
    tenant[mism] = (tenant[mism] + 1) % N_TENANTS
    etype = rng.choice(3, width, p=[0.6, 0.3, 0.1]).astype(np.int32)
    value = rng.uniform(0, 100, width).astype(np.float32)
    value[rng.random(width) < 0.0005] = np.nan
    return dict(
        valid=rng.random(width) < 0.998,
        device_id=dev,
        tenant_id=tenant,
        event_type=etype,
        ts_s=np.full(width, ts_s, np.int32),
        ts_ns=rng.integers(0, 1_000_000_000, width).astype(np.int32),
        mtype_id=rng.integers(0, M_SLOTS, width).astype(np.int32),
        value=value,
        lat=rng.uniform(-12, 12, width).astype(np.float32),
        lon=rng.uniform(-12, 12, width).astype(np.float32),
        elevation=rng.uniform(0, 100, width).astype(np.float32),
        alert_code=np.where(etype == 2, rng.integers(0, 20, width),
                            -1).astype(np.int32),
        alert_level=rng.integers(0, 4, width).astype(np.int32),
        command_id=np.full(width, -1, np.int32),
        payload_ref=np.arange(width, dtype=np.int32),
        update_state=np.ones(width, bool),
    )


def make_rings(n_rings, width, n_active, capacity, seed, ts0=1_700_000_000):
    from sitewhere_tpu_torch.pipeline.packed import pack_batch_host

    rng = np.random.default_rng(seed)
    rings = []
    for ring in range(n_rings):
        rings.append([pack_batch_host(
            make_batch_cols(rng, width, n_active, capacity,
                            ts0 + ring * RING_K + slot), width)
            for slot in range(RING_K)])
    return rings


# -- phases -------------------------------------------------------------------


def plain_chunked(points, verts, rows=8192):
    """The plain geofence in row chunks ([B, Z, V] is 4 GiB at full size)."""
    import torch

    from sitewhere_tpu_torch.ops.geo import points_in_polygons

    return torch.cat([points_in_polygons(points[i:i + rows], verts)
                      for i in range(0, points.shape[0], rows)])


def cuda_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def phase_kernel(device, geo_cuda):
    """Kernel vs plain, bitwise, at the full and the edge shapes."""
    import torch

    gen = torch.Generator(device=device).manual_seed(SEED)
    verts = random_polygons(gen, FULL_Z, FULL_V, -50, 50, 1, 20, device)
    points = (-60 + 120 * torch.rand((FULL_B, 2), generator=gen,
                                     device=device)).contiguous()
    got = geo_cuda.points_in_polygons_cuda(points, verts)
    ref = plain_chunked(points, verts)
    torch.cuda.synchronize()
    mismatches = int((got != ref).sum())
    check(mismatches == 0, f"kernel != plain at full shape: {mismatches}")
    check(bool(ref.any()) and not bool(ref.all()), "degenerate full case")
    edge = {}
    for name, p, v in edge_cases(gen, device):
        k, r = geo_cuda.points_in_polygons_cuda(p, v), plain_chunked(p, v)
        edge[name] = int((k != r).sum())
        check(edge[name] == 0, f"kernel != plain at {name}: {edge[name]}")

    # ``ms``: the kernel alone, on inputs laid out in advance;
    # ``wrapper_ms``: the wrapper's whole call (edge planes, point columns)
    px, py = points[:, 0].contiguous(), points[:, 1].contiguous()
    planes = geo_cuda.edge_planes(verts)
    out = torch.empty((FULL_B, FULL_Z), dtype=torch.bool, device=device)
    ms = cuda_ms(lambda: geo_cuda.launch_pip(px, py, planes, out), 50)
    check(torch.equal(out, ref), "timed launch != plain")
    wrapper_ms = cuda_ms(
        lambda: geo_cuda.points_in_polygons_cuda(points, verts), 50)
    plain_ms = cuda_ms(lambda: plain_chunked(points, verts), 3)
    tests = FULL_B * FULL_Z * FULL_V
    bytes_moved = FULL_B * 2 * 4 + 4 * FULL_V * FULL_Z * 4 + FULL_B * FULL_Z
    ops_ms = max(PIP_FLOAT_PER_TEST * tests / PEAK_FP32_INSTR,
                 PIP_LOGIC_PER_TEST * tests / PEAK_INT32_INSTR) * 1e3
    bytes_ms = bytes_moved / PEAK_HBM_BYTES * 1e3
    rec = {
        "name": "pip_parity", "route": "cuda",
        "source": "sitewhere_tpu_torch/csrc/pip_kernel.cu",
        "replaces": "sitewhere_tpu/ops/geo_pallas.py:41",
        "max_abs_err": float(mismatches), "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": None,
    }
    emit({"phase": "kernel_vs_plain", "shape": [FULL_B, FULL_Z, FULL_V],
          "mismatches": mismatches, "inside_share": float(ref.float().mean()),
          "edge_shapes": edge, "ms": ms, "wrapper_ms": wrapper_ms,
          "plain_ms": plain_ms,
          "bound_ms": rec["bound_ms"], "ops_bound_ms": ops_ms,
          "bytes_bound_ms": bytes_ms, "edge_tests": tests})
    return rec


def phase_main_path(device, geo_cuda):
    """The full-size ring loop, then one ring rerun with the plain
    geofence from the same carry."""
    import torch

    from sitewhere_tpu_torch.pipeline.packed import (
        BATCH_I, build_packed_chain, pack_tables, stage_packed_batch)
    from sitewhere_tpu_torch.runtime.ring import RingRunner
    from sitewhere_tpu_torch.state.manager import DeviceStateManager

    t0 = time.perf_counter()
    registry, rules, zones = make_world(device, CAPACITY, N_ACTIVE, N_RULES,
                                        FULL_Z, FULL_V, SEED + 1)
    tables = pack_tables(registry, rules, zones)
    mgr = DeviceStateManager(CAPACITY, num_mtype_slots=M_SLOTS,
                             num_ewma_scales=K_SCALES, device=device)
    runner = RingRunner(mgr, tables, RING_K)
    rings = make_rings(1 + TIMED_RINGS, FULL_B, N_ACTIVE, CAPACITY, SEED + 2)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    for view in runner.dispatch(rings[0]):      # warm-up ring
        view.metrics
    torch.cuda.synchronize()

    carry_before_last = None
    per_step = []
    geo_cuda.reset_launch_counts()
    t0 = time.perf_counter()
    for ring in rings[1:]:
        carry_before_last = mgr.current_packed
        views = runner.dispatch(ring)
        for view in views:
            m = view.metrics
            per_step.append((int(m.processed), int(m.accepted),
                             int(m.threshold_alerts), int(m.zone_alerts)))
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = geo_cuda.launch_counts["pip_parity"]

    n_steps = TIMED_RINGS * RING_K
    check(len(per_step) == n_steps, "missing step outputs")
    check(runner.host_syncs_per_batch == 1 / RING_K,
          f"host_syncs_per_batch {runner.host_syncs_per_batch}")
    check(launches == n_steps, f"kernel launched {launches}x in {n_steps} steps")
    processed = sum(s[0] for s in per_step)
    for (p, a, _, _), (bi, _) in zip(per_step, [b for r in rings[1:] for b in r]):
        check(p == int(bi[BATCH_I.index("valid")].sum()), "processed count")
        check(0 < a <= p, "accepted count")
    check(sum(s[2] for s in per_step) > 0, "no threshold alert fired")
    check(sum(s[3] for s in per_step) > 0, "no zone alert fired")
    # the carry is finite where it should be
    st = mgr.current
    check(bool(torch.isfinite(st.ewma_values).all()), "non-finite EWMA state")
    summary = mgr.summary()
    check(0 < summary["devices_with_state"] <= N_ACTIVE, "state summary")

    emit({"phase": "main_path", "capacity": CAPACITY, "active": N_ACTIVE,
          "rules": N_RULES, "zones": FULL_Z, "verts": FULL_V,
          "width": FULL_B, "ring_k": RING_K, "rings": TIMED_RINGS,
          "setup_s": setup_s, "elapsed_s": elapsed,
          "events_per_s": processed / elapsed,
          "ms_per_ring": elapsed / TIMED_RINGS * 1e3,
          "ms_per_step": elapsed / n_steps * 1e3,
          "host_syncs_per_batch": runner.host_syncs_per_batch,
          "pip_launches": launches,
          "processed": [s[0] for s in per_step],
          "accepted": [s[1] for s in per_step],
          "threshold_alerts": [s[2] for s in per_step],
          "zone_alerts": [s[3] for s in per_step],
          "summary": summary,
          "max_memory_gib": torch.cuda.max_memory_allocated() / 2**30})

    # -- the last ring again, from the same carry, with the plain geofence
    staged = [stage_packed_batch(bi, bf, device) for bi, bf in rings[-1]]
    plain_chain = build_packed_chain(RING_K, geofence=plain_chunked)
    ps, ois, mets, _ = plain_chain(tables, carry_before_last,
                                   *[s[0] for s in staged],
                                   *[s[1] for s in staged])
    kern = mgr.current_packed
    same_out = all(np.array_equal(v.oi, ois[i].cpu().numpy())
                   and np.array_equal(v.metrics_vector, mets[i].cpu().numpy())
                   for i, v in enumerate(views))
    same_state = (torch.equal(ps.si, kern.si) and torch.equal(ps.sf, kern.sf))
    check(same_out, "plain-geofence rerun: outputs differ")
    check(same_state, "plain-geofence rerun: carry differs")
    check(geo_cuda.launch_counts["pip_parity"] == launches,
          "plain rerun launched the kernel")
    emit({"phase": "plain_rerun", "identical_outputs": same_out,
          "identical_carry": same_state})
    return launches


# -- the wire path -------------------------------------------------------------


class CountingStore:
    """Event-store stand-in: counts accepted rows and reads the five
    enrichment columns, as the segment store's append does."""

    def __init__(self):
        self.rows = 0

    def append_columns(self, cols, mask=None):
        for name in ("device_type_id", "assignment_id", "area_id",
                     "customer_id", "asset_id"):
            cols[name]
        self.rows += int(mask.sum())

    def flush(self):
        pass


def make_wire_world(device):
    """The main-path deployment written through the port's services: 2^20
    registry slots with 1,000,000 assigned devices (one tenant: wire rows
    land in the default tenant), 64 rules and 512 zones of 16 vertices.
    Rule thresholds and zones sit where real alerts are rare."""
    from sitewhere_tpu_torch.ids import IdentityMap
    from sitewhere_tpu_torch.pipeline.rules import RuleManager
    from sitewhere_tpu_torch.services.device_management import (
        RegistryMirror)

    identity = IdentityMap()
    mirror = RegistryMirror(CAPACITY, max_zones=FULL_Z, max_verts=FULL_V,
                            device=device)
    rules = RuleManager(identity, capacity=N_RULES, device=device)
    populate_world(identity, mirror, rules, N_ACTIVE)
    return identity, mirror, rules


def populate_world(identity, mirror, rules, n_active):
    """Write the deployment's devices (``n_active`` of them), zones and
    rules into the given identity map, registry mirror and rule manager."""
    import torch

    from sitewhere_tpu_torch.schema import (
        AssignmentStatus, ComparisonOp, RuleKind, ZoneCondition)

    identity.tenant.mint("default")
    for m in range(M_SLOTS):
        identity.mtype.mint(f"m{m}")
    active = int(AssignmentStatus.ACTIVE)
    for i in range(n_active):
        d = identity.device.mint(f"d-{i}")
        mirror.set_device_row(
            d, active=True, tenant_id=0, device_type_id=i % 16,
            assignment_id=i, assignment_status=active, area_id=i % 64,
            customer_id=i % 1000, asset_id=i % 5000)
    gen = torch.Generator(device="cpu").manual_seed(SEED + 5)
    polys = random_polygons(gen, FULL_Z, FULL_V, -80, 80, 0.3, 2.0,
                            "cpu").numpy()
    for z in range(FULL_Z):
        mirror.set_zone_row(
            z, active=True, tenant_id=-1 if z % 2 else 0,
            area_id=z % 64 if z % 4 == 3 else -1, verts_lonlat=polys[z],
            condition=int(ZoneCondition.ALERT_IF_INSIDE),
            alert_code=identity.alert_type.mint(f"zone-{z % 8}"),
            alert_level=z % 4)
    for r in range(N_RULES):
        kind = (RuleKind.INSTANT, RuleKind.WINDOW_MEAN,
                RuleKind.RATE_PER_S)[r % 3]
        if kind == RuleKind.INSTANT:
            op, thr = ((ComparisonOp.GT, 99.9) if r % 2
                       else (ComparisonOp.LT, 0.1))
        elif kind == RuleKind.WINDOW_MEAN:
            op, thr = ComparisonOp.GT, 99.0
        else:
            op, thr = ComparisonOp.GT, 95.0
        rules.create_rule(f"m{r % M_SLOTS}", op, thr, f"rule-{r % 4}",
                          alert_level=r % 4,
                          tenant=None if r % 2 == 0 else "default",
                          kind=kind, window_s=(60.0, 600.0, 3600.0)[r % 3])


_M_LINE = ('{"deviceToken":"%s","type":"DeviceMeasurements","request":'
           '{"name":"m%d","value":%.3f,"eventDate":%d}}')
_L_LINE = ('{"deviceToken":"%s","type":"DeviceLocation","request":'
           '{"latitude":%.5f,"longitude":%.5f,"elevation":%.1f,'
           '"eventDate":%d}}')
_A_LINE = ('{"deviceToken":"%s","type":"DeviceAlert","request":'
           '{"type":"device-%d","level":"warning","eventDate":%d}}')


def wire_payloads(rng, n_payloads, lines, ts0_ms):
    """NDJSON payloads of ``lines`` lines, 60/30/10 measurements,
    locations and alerts, a share of unregistered tokens; one second of
    event time per payload.  Returns ``[(bytes, registered_lines)]``."""
    out = []
    for p in range(n_payloads):
        dev = rng.integers(0, N_ACTIVE, lines)
        ghost = rng.random(lines) < WIRE_GHOSTS
        kind = rng.choice(3, lines, p=[0.6, 0.3, 0.1])
        value = rng.uniform(0, 100, lines)
        lat = rng.uniform(-85, 85, lines)
        lon = rng.uniform(-175, 175, lines)
        ts = ts0_ms + 1000 * p + 250 * rng.integers(0, 4, lines)
        body = []
        for d, g, k, v, la, lo, t in zip(
                dev.tolist(), ghost.tolist(), kind.tolist(), value.tolist(),
                lat.tolist(), lon.tolist(), ts.tolist()):
            tok = f"x-{d}" if g else f"d-{d}"
            if k == 0:
                body.append(_M_LINE % (tok, d % M_SLOTS, v, t))
            elif k == 1:
                body.append(_L_LINE % (tok, la, lo, v, t))
            else:
                body.append(_A_LINE % (tok, d % 4, t))
        out.append(("\n".join(body).encode(), lines - int(ghost.sum())))
    return out


def measurement_payloads(rng, n_payloads, lines, ts0_ms):
    """Measurement-only NDJSON payloads of ``lines`` lines (the fleet's
    dominant shape), values in MEAS_VALUE_BAND, the same share of
    unregistered tokens; one second of event time per payload.  Returns
    ``[(bytes, registered_lines)]``."""
    out = []
    lo, hi = MEAS_VALUE_BAND
    for p in range(n_payloads):
        dev = rng.integers(0, N_ACTIVE, lines)
        ghost = rng.random(lines) < WIRE_GHOSTS
        value = rng.uniform(lo, hi, lines)
        ts = ts0_ms + 1000 * p + 250 * rng.integers(0, 4, lines)
        body = [_M_LINE % (f"x-{d}" if g else f"d-{d}", d % M_SLOTS, v, t)
                for d, g, v, t in zip(dev.tolist(), ghost.tolist(),
                                      value.tolist(), ts.tolist())]
        out.append(("\n".join(body).encode(), lines - int(ghost.sum())))
    return out


def make_wire_dispatcher(device, world, width, ring_depth, deadline_ms,
                         journal_dir):
    """A started dispatcher over the world's epochs, with its own state,
    journal and store (start() runs the warm-up dispatch)."""
    from sitewhere_tpu_torch.ingest.batcher import Batcher
    from sitewhere_tpu_torch.ingest.journal import Journal, JournalReader
    from sitewhere_tpu_torch.runtime.dispatcher import PipelineDispatcher
    from sitewhere_tpu_torch.state.manager import DeviceStateManager

    identity, mirror, rules = world
    state = DeviceStateManager(
        CAPACITY, identity, num_mtype_slots=M_SLOTS,
        tenant_id_of_device=lambda ids: mirror.tenant_id[ids],
        num_ewma_scales=K_SCALES, device=device)
    batcher = Batcher(
        width=width, n_shards=1, registry_capacity=CAPACITY,
        resolve_device=identity.device.lookup,
        resolve_mtype=identity.mtype.mint,
        resolve_alert=identity.alert_type.mint,
        invocations=identity.invocation, deadline_ms=deadline_ms,
        emit_packed=True)
    journal = Journal(journal_dir, "events", fsync_every=1 << 30,
                      segment_bytes=1 << 30)
    disp = PipelineDispatcher(
        batcher=batcher, registry_provider=mirror.publish_registry,
        state_manager=state, rules_provider=rules.publish,
        zones_provider=mirror.publish_zones, event_store=CountingStore(),
        journal=journal, journal_reader=JournalReader(journal, "pipeline"),
        resolve_tenant=identity.tenant.mint, ring_depth=ring_depth,
        egress_offload=True, device=device)
    disp.start()
    return disp


def _stage_totals(disp):
    return {s: (disp.metrics.timer(f"pipeline.stage_{s}_s").total,
                disp.metrics.timer(f"pipeline.stage_{s}_s").count)
            for s in WIRE_STAGES}


def _stage_ms(disp, before):
    out = {}
    for s, (total0, count0) in before.items():
        t = disp.metrics.timer(f"pipeline.stage_{s}_s")
        if t.count > count0:
            out[s] = (t.total - total0) / (t.count - count0) * 1e3
    return out


def _wait_egress_idle(disp, timeout_s=120.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        with disp._step_lock:
            if not disp._inflight and not disp._egress_busy:
                return
        time.sleep(0.001)
    raise RuntimeError("chip_smoke: egress did not drain")


class DeviceSpans:
    """CUDA events around every step and chain a started dispatcher
    launches.  Their summed span bounds the card's busy time from above:
    a span also holds any gap in which the card waits for the host's next
    launch.  None of it on the CPU."""

    def __init__(self, disp):
        import torch

        self._torch = torch
        self.pairs = []
        self.on = disp.device.type == "cuda"
        if self.on:
            disp._packed_step = self.wrap(disp._packed_step)
            for k, chain in list(disp._ring_chains.items()):
                disp._ring_chains[k] = self.wrap(chain)

    def wrap(self, fn):
        torch = self._torch

        def timed(*args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args)
            end.record()
            self.pairs.append((start, end))
            return out

        return timed

    def total_ms(self):
        if not self.on:
            return None
        self._torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.pairs)


def _device_profile(on: bool):
    """``torch.profiler`` over the card's activity only (kernels and
    copies, from every thread), or nothing (and always on the CPU)."""
    if not on:
        return contextlib.nullcontext(None)
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CUDA])


def _device_ms(prof):
    """The card's kernel and copy time in a profile, in ms: one stream, so
    the entries never overlap and their sum is the busy time."""
    if prof is None:
        return None

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0.0)

    return sum(dev_us(e) for e in prof.key_averages()
               if "CUDA" in str(e.device_type)) / 1e3


def _device_launches(prof):
    """Kernels and copies the card ran in a profile (None without one)."""
    if prof is None:
        return None
    return sum(e.count for e in prof.key_averages()
               if "CUDA" in str(e.device_type))


def _busy(rec, span_ms, device_ms, elapsed, steps):
    """The card's share of the wall time: the CUDA-event span's bound and,
    in a profiled run, the measured kernel and copy time."""
    rec["device_span_ms"] = span_ms
    rec["device_busy_share_max"] = (
        None if span_ms is None else span_ms / 1e3 / elapsed)
    rec["device_span_ms_per_step"] = (
        None if span_ms is None else span_ms / max(1, steps))
    if device_ms is not None:
        rec["device_ms"] = device_ms
        rec["device_ms_per_step"] = device_ms / max(1, steps)
        rec["device_busy_share"] = device_ms / 1e3 / elapsed
    return rec


def _latency(disp, tail: str):
    """p50 and the tail of the dispatcher's per-plan latencies, in ms:
    the max (``tail="max"``) or the p99 and the max."""
    lat = np.asarray(list(disp.latencies_s)) * 1e3
    rec = {"plans": int(lat.size),
           "latency_p50_ms": float(np.percentile(lat, 50)),
           "latency_max_ms": float(lat.max())}
    if tail == "p99":
        rec["latency_p99_ms"] = float(np.percentile(lat, 99))
    return rec


def _time_into(fn, acc):
    """``fn`` with its host seconds added to ``acc[0]``."""

    def timed(*args, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kw)
        finally:
            acc[0] += time.perf_counter() - t0

    return timed


def count_adopted(batcher):
    """Record the sequence number of every plan the batcher emits by
    adopting a full-width reservation (zero-copy)."""
    adopted = []
    emit_adopted = batcher._emit_adopted

    def counted(reason):
        plan = emit_adopted(reason)
        adopted.append(plan.seq)
        return plan

    batcher._emit_adopted = counted
    return adopted


def wire_throughput(device, geo_cuda, world, payloads, ring_depth,
                    deadline_ms, root, run, profile=False, meas=False):
    """ingest_wire_lines over every payload, then flush(), timed from the
    first byte to the flush's return.  With ``deadline_ms`` at
    RING_DIAG_DEADLINE_MS the ring forms: its sync count is read once the
    ring's plans have egressed, before the flush's partial, and the last
    dispatched ring is rerun with the plain geofence.  ``meas``: the
    payloads are full-width measurement-only ones, each of which must
    decode fill-direct and be adopted as its plan.  ``profile`` runs the
    region under the profiler (its numbers then carry its cost)."""
    import torch

    import sitewhere_tpu_torch.runtime.dispatcher as dispatcher_mod
    from sitewhere_tpu_torch.pipeline.packed import build_packed_chain

    diag = deadline_ms == RING_DIAG_DEADLINE_MS
    disp = make_wire_dispatcher(device, world, FULL_B, ring_depth,
                                deadline_ms, os.path.join(root, "j"))
    adopted = count_adopted(disp.batcher)
    decode_copied = disp.metrics.counter("pipeline.bytes_copied.decode")
    # two host steps no stage timer covers: the token and name resolution
    # of decoded columns, and the journal append
    resolve_s, journal_s = [0.0], [0.0]
    resolve_columns = dispatcher_mod.resolve_columns
    dispatcher_mod.resolve_columns = _time_into(resolve_columns, resolve_s)
    disp.journal.append = _time_into(disp.journal.append, journal_s)
    recorded = {}
    if diag:
        real_chain = disp._ring_chain(ring_depth)

        def recording_chain(tables, ps, *slots):
            out = real_chain(tables, ps, *slots)
            recorded.update(tables=tables, ps=ps, slots=slots, out=out)
            return out

        disp._ring_chains[ring_depth] = recording_chain
    spans = DeviceSpans(disp)
    try:
        torch.cuda.synchronize()
        snap0 = disp.metrics_snapshot()
        stages0 = _stage_totals(disp)
        copied0 = (decode_copied.value, disp.batcher.copied_bytes)
        adopted.clear()
        resolve_s[0] = journal_s[0] = 0.0
        disp.latencies_s.clear()
        geo_cuda.reset_launch_counts()
        with _device_profile(profile and device.type == "cuda") as prof:
            t0 = time.perf_counter()
            for payload, _ in payloads:
                disp.ingest_wire_lines(payload)
            _wait_egress_idle(disp)
            mid = disp.metrics_snapshot()
            disp.flush()
            elapsed = time.perf_counter() - t0
        launches = geo_cuda.launch_counts["pip_parity"]
        snap = disp.metrics_snapshot()
        stage_ms = _stage_ms(disp, stages0)
        copied = (decode_copied.value - copied0[0],
                  disp.batcher.copied_bytes - copied0[1])
        build_fallbacks = disp.metrics.gauge("native.build_fallbacks").value
        committed = disp.journal_reader.committed
        records = disp.journal.end_offset
        latency = _latency(disp, "max")
        span_ms = spans.total_ms()
    finally:
        dispatcher_mod.resolve_columns = resolve_columns
        disp.stop()
        disp.journal.close()
    stage_ms["resolve_per_payload"] = resolve_s[0] * 1e3 / len(payloads)
    stage_ms["journal_per_payload"] = journal_s[0] * 1e3 / len(payloads)
    delta = {k: snap[k] - snap0[k] for k in (
        "steps", "host_syncs", "ring_chains", "ring_flushed_plans",
        "processed", "accepted", "unregistered", "derived_alerts")}
    lines = sum(p.count(b"\n") + 1 for p, _ in payloads)
    registered = sum(r for _, r in payloads)
    ring_steps = mid["steps"] - snap0["steps"]
    ring_syncs = mid["host_syncs"] - snap0["host_syncs"]
    rec = {"phase": "dispatcher_wire", "run": run,
           "traffic": "measurements" if meas else "60/30/10",
           "ring_depth": ring_depth, "deadline_ms": deadline_ms,
           "payloads": len(payloads), "lines": lines, "elapsed_s": elapsed,
           "events_per_s": lines / elapsed,
           "rows_per_s_with_derived": delta["processed"] / elapsed,
           **latency, "stage_ms": stage_ms,
           "decode_bytes_copied_per_event": copied[0] / lines,
           "batch_bytes_copied_per_event": copied[1] / lines,
           "adopted_plans": len(adopted),
           "native_build_fallbacks": build_fallbacks,
           "host_syncs_per_batch": delta["host_syncs"] / delta["steps"],
           "ring_region_steps": ring_steps,
           "ring_region_host_syncs_per_batch": ring_syncs / ring_steps,
           "pip_launches": launches, "committed": committed,
           "journal_records": records, **delta}
    emit(_busy(rec, span_ms, _device_ms(prof), elapsed, delta["steps"]))
    check(launches == delta["steps"],
          f"kernel launched {launches}x in {delta['steps']} dispatcher steps")
    check(delta["accepted"] == registered + delta["derived_alerts"],
          f"accepted {delta['accepted']} != registered {registered} + "
          f"derived {delta['derived_alerts']}")
    check(delta["processed"] == lines + delta["derived_alerts"],
          "processed rows")
    check(delta["unregistered"] == lines - registered, "unregistered rows")
    check(committed == records == len(payloads),
          f"committed offset {committed}, journal records {records}")
    check(build_fallbacks == 0, f"native.build_fallbacks {build_fallbacks}")
    if meas:
        # every payload is one full-width measurement plan, decoded
        # fill-direct and adopted: nothing copied by decode or batch
        check(delta["steps"] == len(payloads) and delta["derived_alerts"] == 0,
              f"{delta['steps']} steps, {delta['derived_alerts']} derived")
        check(len(adopted) == len(payloads),
              f"{len(adopted)} adopted plans of {len(payloads)}")
        check(copied == (0, 0), f"bytes copied (decode, batch) {copied}")
    if diag:
        check(delta["ring_chains"] == len(payloads) // ring_depth,
              f"{delta['ring_chains']} ring chains")
        check(ring_syncs * ring_depth == ring_steps,
              f"ring host syncs {ring_syncs} over {ring_steps} steps")
        # the last dispatched ring again, from its carry, plain geofence
        plain = build_packed_chain(ring_depth, geofence=plain_chunked)
        ps, ois, mets, present = plain(recorded["tables"], recorded["ps"],
                                       *recorded["slots"])
        kps, kois, kmets, kpresent = recorded["out"]
        same = (torch.equal(ois, kois) and torch.equal(mets, kmets)
                and torch.equal(ps.si, kps.si) and torch.equal(ps.sf, kps.sf)
                and torch.equal(present, kpresent))
        emit({"phase": "dispatcher_wire", "run": "plain_rerun",
              "identical": same})
        check(same, "dispatcher ring != plain-geofence rerun")
        check(geo_cuda.launch_counts["pip_parity"] == launches,
              "plain rerun launched the kernel")
    return rec


def wire_paced(device, world, payloads, root, run="paced_ring0",
               profile=False):
    """A latency region as the reference's bench runs one: width 4096,
    deadline 3.5 ms, ring off; a burst measures this dispatcher's
    capacity, then payloads are offered at PACED_UTIL of it on a
    drift-free schedule.  Each payload's latency counts from its scheduled
    arrival, so time the host spends behind schedule is inside it.
    ``profile`` runs the offered region under the profiler."""
    import torch

    disp = make_wire_dispatcher(device, world, PACED_WIDTH, 0,
                                PACED_DEADLINE_MS, os.path.join(root, "p"))
    spans = DeviceSpans(disp)
    try:
        rows = PACED_LINES
        tb = time.perf_counter()
        for payload, _ in payloads[:PACED_BURST]:
            disp.ingest_wire_lines(payload)
        disp.flush()
        capacity = rows * PACED_BURST / (time.perf_counter() - tb)
        gap_s = rows / (capacity * PACED_UTIL)
        torch.cuda.synchronize()
        spans.pairs.clear()
        disp.latencies_s.clear()
        snap0 = disp.metrics_snapshot()
        with _device_profile(profile and device.type == "cuda") as prof:
            t0 = time.perf_counter()
            m0 = time.monotonic()
            for i, (payload, _) in enumerate(payloads[PACED_BURST:]):
                due = m0 + i * gap_s
                delay = due - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
                disp.ingest_wire_lines(payload, received_at=due)
            disp.flush()
            elapsed = time.perf_counter() - t0
        snap = disp.metrics_snapshot()
        latency = _latency(disp, "p99")
        span_ms = spans.total_ms()
    finally:
        disp.stop()
        disp.journal.close()
    n = rows * (len(payloads) - PACED_BURST)
    steps = snap["steps"] - snap0["steps"]
    rec = {"phase": "dispatcher_wire", "run": run,
           "ring_depth": 0, "width": PACED_WIDTH,
           "deadline_ms": PACED_DEADLINE_MS,
           "capacity_events_per_s": capacity, "offered_util": PACED_UTIL,
           "events_per_s": n / elapsed, **latency,
           "steps": steps,
           "host_syncs_per_batch":
           (snap["host_syncs"] - snap0["host_syncs"]) / max(1, steps)}
    emit(_busy(rec, span_ms, _device_ms(prof), elapsed, steps))
    return rec


def _columns_equal(a, b):
    """Column dicts equal key for key: lists exactly, arrays by dtype and
    raw bytes (float32 bitwise)."""
    if sorted(a) != sorted(b):
        return False
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            x, y = np.asarray(x), np.asarray(y)
            if x.dtype != y.dtype or x.tobytes() != y.tobytes():
                return False
        elif list(x) != list(y):
            return False
    return True


def _best_ms(fn, reps):
    best = None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        dt = (time.perf_counter() - t0) * 1e3
        best = dt if best is None else min(best, dt)
    return best, out


def native_proof(world, meas_payload, mixed_payload):
    """The native tier on this machine: where the library was built and
    how long it took, ``native.build_fallbacks``, and one full-size
    payload of each kind through its C lane and through the pure-Python
    lane (column for column equal), with each lane's ms per payload
    (best of 3 for the C lanes, one pure-Python run)."""
    from sitewhere_tpu_torch import native
    from sitewhere_tpu_torch.ingest import columnar
    from sitewhere_tpu_torch.ingest.batcher import Batcher
    from sitewhere_tpu_torch.ingest.decoders import parse_envelopes

    identity = world[0]
    library = native.library_path
    check(library is not None and library.parent == native.BUILD_DIR
          and library.name.startswith("_swwire_torch-"),
          f"scanner library {library}")
    t0 = time.perf_counter()
    identity.device.native_table()
    table_s = time.perf_counter() - t0
    batcher = Batcher(width=FULL_B, n_shards=1, registry_capacity=CAPACITY,
                      resolve_device=identity.device.lookup,
                      resolve_mtype=identity.mtype.mint,
                      resolve_alert=identity.alert_type.mint,
                      emit_packed=True)

    def fill():
        res = batcher.reserve(meas_payload.count(b"\n") + 1)
        n = columnar.decode_fill_direct(meas_payload, identity.device, res,
                                        identity.mtype.mint)
        return n, res

    def python(payload):
        return columnar._decode_lines_inner(parse_envelopes(payload))

    fill_ms, (n, res) = _best_ms(fill, 3)
    check(n == FULL_B, f"fill-direct returned {n} for {FULL_B} lines")
    py_meas_ms, (py_cols, _) = _best_ms(lambda: python(meas_payload), 1)
    ref = columnar.resolve_columns(
        py_cols, identity.device.lookup, identity.mtype.mint,
        identity.alert_type.mint)
    got = {f: getattr(res, f)[:n] for f in ("device_id", "mtype_id", "ts_s",
                                            "ts_ns", "value")}
    got["update_state"] = res.update_state[:n] != 0
    fill_equal = _columns_equal(got, {f: ref[f] for f in got})
    check(fill_equal, "fill-direct decode != pure-Python decode")
    family_ms, family = _best_ms(
        lambda: columnar._native_decode(mixed_payload), 3)
    check(family is not None, "the event-family scanner bailed")
    py_mixed_ms, py_mixed = _best_ms(lambda: python(mixed_payload), 1)
    family_equal = (_columns_equal(family[0], py_mixed[0])
                    and family[1] == py_mixed[1] == [])
    check(family_equal, "event-family decode != pure-Python decode")
    check(native.build_fallbacks == 0,
          f"native.build_fallbacks {native.build_fallbacks}")
    lines = FULL_B
    rec = {"phase": "dispatcher_wire", "run": "native",
           "library": str(library.relative_to(native.PKG_DIR.parent)),
           "build_s": native.build_seconds,
           "build_fallbacks": native.build_fallbacks,
           "token_table_s": table_s, "lines": lines,
           "fill_direct_rows": n, "fill_direct_equal_python": fill_equal,
           "family_rows": columnar.n_rows(family[0]),
           "family_equal_python": family_equal,
           "decode_ms": {"fill_direct": fill_ms,
                         "python_measurements": py_meas_ms,
                         "event_family": family_ms,
                         "python_60_30_10": py_mixed_ms},
           "decode_us_per_line": {
               "fill_direct": fill_ms * 1e3 / lines,
               "python_measurements": py_meas_ms * 1e3 / lines,
               "event_family": family_ms * 1e3 / lines,
               "python_60_30_10": py_mixed_ms * 1e3 / lines}}
    emit(rec)
    return rec


def phase_dispatcher_wire(device, geo_cuda):
    """The wire path through the port's dispatcher; returns the kernel's
    launches in each throughput run, by run name, and the full-width
    payloads (60/30/10, measurement-only) for the persistence phase."""
    t0 = time.perf_counter()
    world = make_wire_world(device)
    rng = np.random.default_rng(SEED + 6)
    payloads = wire_payloads(rng, WIRE_PAYLOADS, FULL_B, WIRE_TS0_MS)
    paced = wire_payloads(rng, PACED_PAYLOADS + PACED_BURST, PACED_LINES,
                          WIRE_TS0_MS + 10_000_000)
    meas = measurement_payloads(rng, WIRE_PAYLOADS, FULL_B,
                                WIRE_TS0_MS + 20_000_000)
    emit({"phase": "dispatcher_wire", "run": "setup", "capacity": CAPACITY,
          "active": N_ACTIVE, "rules": N_RULES, "zones": FULL_Z,
          "verts": FULL_V, "width": FULL_B,
          "setup_s": time.perf_counter() - t0})
    native_proof(world, meas[0][0], payloads[0][0])
    root = tempfile.mkdtemp(prefix="wire-", dir=geo_cuda.BUILD_DIR)
    launches = {}
    try:
        for ring, deadline_ms, run in (
                (RING_K, WIRE_DEADLINE_MS, f"throughput_ring{RING_K}"),
                (0, WIRE_DEADLINE_MS, "throughput_ring0"),
                (RING_K, RING_DIAG_DEADLINE_MS,
                 f"diagnostic_ring{RING_K}_deadline60s")):
            rec = wire_throughput(device, geo_cuda, world, payloads, ring,
                                  deadline_ms, os.path.join(root, run), run)
            launches[run] = rec["pip_launches"]
        run = "measurements_ring0"
        rec = wire_throughput(device, geo_cuda, world, meas, 0,
                              WIRE_DEADLINE_MS, os.path.join(root, run), run,
                              meas=True)
        launches[run] = rec["pip_launches"]
        wire_paced(device, world, paced, os.path.join(root, "paced"))
        # the card's busy time, measured apart from the timed regions
        wire_throughput(device, geo_cuda, world,
                        payloads[:PROFILED_PAYLOADS], 0, WIRE_DEADLINE_MS,
                        os.path.join(root, "prof"), "profiled_ring0",
                        profile=True)
        wire_throughput(device, geo_cuda, world, meas[:PROFILED_PAYLOADS], 0,
                        WIRE_DEADLINE_MS, os.path.join(root, "prof_meas"),
                        "profiled_measurements_ring0", profile=True,
                        meas=True)
        wire_paced(device, world, paced[:PACED_BURST + PROFILED_PACED],
                   os.path.join(root, "prof_paced"), "profiled_paced_ring0",
                   profile=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "dispatcher_wire", "run": "done",
          "seconds": time.perf_counter() - t0})
    return launches, payloads, meas


# -- persistence and restart ---------------------------------------------------

# The kill runs other than crash.mid_egress run at a reduced size so the
# phase stays within a few minutes: 2^16 registry slots, 50,000 devices,
# width 4096, 24 payloads of 4096 lines (same rules and zones).
SMALL_CAPACITY, SMALL_ACTIVE, SMALL_WIDTH = 1 << 16, 50_000, 4096
KILL_PAYLOADS, KILL_SAVE_EVERY = 24, 8
KILL_TS0_MS = WIRE_TS0_MS + 30_000_000
# (point, hit, size, ring depth, deadline ms): where each child dies
KILLS = (
    ("crash.mid_egress", 13, "full", 0, WIRE_DEADLINE_MS),
    ("crash.mid_ring", 2, "small", RING_K, RING_DIAG_DEADLINE_MS),
    ("crash.post_journal", 13, "small", 0, WIRE_DEADLINE_MS),
    ("crash.mid_seal", 12, "small", 0, WIRE_DEADLINE_MS),
    ("crash.pre_manifest", 3, "small", 0, WIRE_DEADLINE_MS),
)
SIZES = {"full": (CAPACITY, N_ACTIVE, FULL_B),
         "small": (SMALL_CAPACITY, SMALL_ACTIVE, SMALL_WIDTH)}
EWMA_MAX_ULP, EWMA_SCALE = 4.0, 128.0


def instance_config(data_dir, capacity, width, ring_depth, deadline_ms):
    """The deployment as an ``Instance`` config: the reference's keys; the
    journal and the segment store at the Config defaults."""
    from sitewhere_tpu_torch.runtime.config import Config

    return Config({
        "instance": {"id": "chip-smoke", "data_dir": data_dir},
        "pipeline": {"width": width, "registry_capacity": capacity,
                     "mtype_slots": M_SLOTS, "deadline_ms": deadline_ms,
                     "adaptive_deadline": False, "ring_depth": ring_depth,
                     "max_zones": FULL_Z, "max_zone_verts": FULL_V},
        "checkpoint": {"interval_s": 0},
        # the rule engine's asset table covers the world's 5000 assets
        "rules": {"asset_capacity": RULE_ASSET_CAPACITY},
        # every live match of a run is kept for the live == retrospective
        # check
        "analytics": {"max_matches": 1 << 21},
    }, apply_env=False)


def world_checkpoint(device, root, size):
    """Write the deployment through an ``Instance``'s own identity, mirror
    and rules, save it as checkpoint generation 0 (empty device state) and
    return its directory: every later instance restores the world from a
    copy of it."""
    from sitewhere_tpu_torch.instance import Instance

    capacity, n_active, width = SIZES[size]
    data_dir = os.path.join(root, f"world-{size}")
    inst = Instance(instance_config(data_dir, capacity, width, 0,
                                    WIRE_DEADLINE_MS), device=device)
    populate_world(inst.identity, inst.mirror, inst.rules, n_active)
    inst.checkpointer.save()
    inst.terminate()
    return os.path.join(data_dir, "checkpoint")


def instance_from_world(device, world_ckpt, data_dir, capacity, width,
                        ring_depth, deadline_ms):
    """A fresh instance whose checkpoint directory is a copy of the
    world's: construction restores the deployment."""
    from sitewhere_tpu_torch.instance import Instance

    shutil.copytree(world_ckpt, os.path.join(data_dir, "checkpoint"))
    inst = Instance(instance_config(data_dir, capacity, width, ring_depth,
                                    deadline_ms), device=device)
    check(inst.restored, f"world checkpoint not restored in {data_dir}")
    return inst


_MIX = (np.uint64(0x9E3779B97F4A7C15), np.uint64(0xC2B2AE3D27D4EB4F),
        np.uint64(0x165667B19E3779F9), np.uint64(0x27D4EB2F165667C5))


def row_checksum(cols, mask=None):
    """(rows, order-independent uint64 checksum) of the stored identity of
    each row: device, type, time, measurement and value bits."""
    def col(name):
        a = np.asarray(cols[name])
        return a if mask is None else a[mask]

    dev = col("device_id").astype(np.uint64)
    with np.errstate(over="ignore"):
        h = (dev * _MIX[0]
             ^ col("event_type").astype(np.uint64) * _MIX[1]
             ^ (col("ts_s").astype(np.uint64) << np.uint64(30))
             ^ col("ts_ns").astype(np.uint64) * _MIX[2]
             ^ col("mtype_id").astype(np.uint64) * _MIX[3]
             ^ col("value").view(np.uint32).astype(np.uint64))
        return int(dev.size), int(h.sum(dtype=np.uint64))


def persist_throughput(device, geo_cuda, world_ckpt, payloads, root, run,
                       meas=False, rules=None, phase="persist_recover",
                       name=None, analytics=None):
    """The wire path through the port ``Instance``: its ``SegmentStore``
    and journal at the Config defaults, ring off, the deployment's 5 ms
    deadline.  Timed from the first byte to the return of the
    dispatcher's flush (every row egressed, sealed and committed) and,
    with tenant programs, to the point where every program alert they
    fired has been injected and stored too (:func:`settle`).

    ``rules(inst)`` loads tenant programs before the instance starts and
    returns a record of the load; the run then records every alert the
    engine injects and checks each is stored exactly once.  A 60/30/10
    run ends with checkpoint_full.

    ``analytics``: streaming queries registered before the instance
    starts; the run then waits for the runner to drain, reports the
    ``analytics.*`` metrics, and after ``flush_live()`` and ``stop()``
    checks every query's live matches against ``run_retrospective`` over
    the sealed store (which needs ``analytics.live_dropped`` 0)."""
    import torch

    data_dir = os.path.join(root, run)
    inst = instance_from_world(device, world_ckpt, data_dir, CAPACITY,
                               FULL_B, 0, WIRE_DEADLINE_MS)
    store, disp, eng = inst.event_store, inst.dispatcher, inst.rule_engine
    load = rules(inst) if rules is not None else None
    runner = inst.analytics
    live_matches = collections.defaultdict(list)
    if analytics is not None:
        for doc in analytics:
            runner.register(doc)
        real_record = runner._record

        def record(entry, matches, live):
            if live:
                live_matches[entry.spec.name].extend(
                    m.to_dict() for m in matches)
            return real_record(entry, matches, live=live)

        runner._record = record
        order = OfferOrder(runner, CAPACITY)
    fired = collections.Counter()
    if load is not None:
        real_inject = eng.inject

        def inject(cols):
            fired.update(zip(*(np.asarray(cols[k]).tolist() for k in (
                "device_id", "ts_s", "ts_ns", "alert_code",
                "alert_level"))))
            return real_inject(cols)

        eng.inject = inject
    byo_codes = np.asarray(sorted(load["alert_codes"]) if load else [],
                           np.int64)
    stored_alerts = collections.Counter()
    persist_s, commits = [0.0], []
    appended = {"rows": 0, "sum": 0}
    real_append, real_flush = store.append_columns, store.flush

    def append(cols, mask=None):
        t0 = time.perf_counter()
        out = real_append(cols, mask=mask)
        persist_s[0] += time.perf_counter() - t0
        n, h = row_checksum(cols, None if mask is None else np.asarray(mask))
        appended["rows"] += n
        appended["sum"] = (appended["sum"] + h) % (1 << 64)
        return out

    def flush(sync=True):
        t0 = time.perf_counter()
        try:
            return real_flush(sync=sync)
        finally:
            if sync:
                commits.append(time.perf_counter() - t0)

    store.append_columns, store.flush = append, flush
    inst.start()
    spans = DeviceSpans(disp)
    try:
        torch.cuda.synchronize()
        snap0 = disp.metrics_snapshot()
        sealed0 = store.sealer.sealed_segments
        commits.clear()
        persist_s[0] = 0.0
        disp.latencies_s.clear()
        rules0 = rules_metrics(inst)
        geo_cuda.reset_launch_counts()
        t0 = time.perf_counter()
        for payload, _ in payloads:
            disp.ingest_wire_lines(payload)
        settle(inst)
        elapsed = time.perf_counter() - t0
        if analytics is not None:
            runner.drain(timeout_s=600.0)
        drained = time.perf_counter() - t0
        launches = geo_cuda.launch_counts["pip_parity"]
        snap = disp.metrics_snapshot()
        rules1 = rules_metrics(inst)
        committed = disp.journal_reader.committed
        records = inst.ingest_journal.end_offset
        latency = _latency(disp, "max")
        span_ms = spans.total_ms()
        commit_ms = [c * 1e3 for c in commits]
        store.append_columns, store.flush = real_append, real_flush
        # checkpoint_full: one save of the loaded instance, then a fresh
        # instance restores it; the state must come back bitwise
        an = analytics_metrics(inst) if analytics is not None else None
        if not meas:
            saved_state = inst.device_state.snapshot_host()
            saved_analytics = {n: e.compiled.export_state()
                               for n, e in runner._queries.items()}
            saved_rules = (eng.registry.snapshot_payload()[0],
                           eng.attributes.snapshot_payload())
            inst.checkpointer.save()
            save_stats = dict(inst.checkpointer.last_save_stats)
        inst.stop()
        retro = {}
        if analytics is not None:
            # after stop(): its final generation holds the open windows
            # checkpoint_full compares; then every open window finalizes
            runner.flush_live()
            t1 = time.perf_counter()
            for doc in analytics:
                retro[doc["name"]] = runner.run_retrospective(
                    doc["name"])["matches"]
            retro_s = time.perf_counter() - t1
        sealed = store.sealer.sealed_segments - sealed0
        stats = store.store_stats()
        disk = sum(os.path.getsize(os.path.join(store.dir, f))
                   for f in os.listdir(store.dir))
        stored = {"rows": 0, "sum": 0}
        for cols in store.iter_chunks():
            n, h = row_checksum(cols)
            stored["rows"] += n
            stored["sum"] = (stored["sum"] + h) % (1 << 64)
            if byo_codes.size:
                mine = ((np.asarray(cols["event_type"]) == 2)
                        & np.isin(np.asarray(cols["alert_code"]), byo_codes))
                stored_alerts.update(zip(*(
                    np.asarray(cols[k])[mine].tolist() for k in (
                        "device_id", "ts_s", "ts_ns", "alert_code",
                        "alert_level"))))
        parked = store.sealer.parked_count()
        dead = store.sealed_dead_lettered
    finally:
        inst.terminate()
    delta = {k: snap[k] - snap0[k] for k in (
        "steps", "processed", "accepted", "unregistered", "derived_alerts")}
    lines = sum(p.count(b"\n") + 1 for p, _ in payloads)
    registered = sum(r for _, r in payloads)
    plans = len(disp.latencies_s)
    rec = {"phase": phase, "run": name or f"persist_throughput.{run}",
           "traffic": "measurements" if meas else "60/30/10",
           "ring_depth": 0, "deadline_ms": WIRE_DEADLINE_MS,
           "payloads": len(payloads), "lines": lines, "elapsed_s": elapsed,
           "events_per_s": lines / elapsed, **latency,
           "persist_ms_per_plan": persist_s[0] * 1e3 / max(1, plans),
           "flush_ms_per_commit": (float(np.mean(commit_ms))
                                   if commit_ms else None),
           "flush_ms_max": max(commit_ms) if commit_ms else None,
           "commits": len(commit_ms), "segments_sealed": sealed,
           "segments_on_disk": stats["segments"], "bytes_on_disk": disk,
           "rows_stored": stored["rows"], "store_shards": store.n_shards,
           "seal_workers": store.sealer.n_workers,
           "pip_launches": launches, "committed": committed,
           "journal_records": records, **delta,
           "rules": {k: rules1[k] - rules0[k] for k in rules1},
           "rule_program_alerts": (snap.get("rule_program_alerts", 0)
                                   - snap0.get("rule_program_alerts", 0))}
    if analytics is not None:
        rec["analytics_drain_s"] = drained - elapsed
        rec["analytics"] = an
        rec["analytics_matches"] = {n: len(v)
                                    for n, v in live_matches.items()}
        rec["retrospective_s"] = retro_s
        rec["disordered_devices"] = order.counts()
        rec["live_equals_retrospective"] = {}
        rec["matches_outside_the_contract"] = {}
        for doc in analytics:
            n = doc["name"]
            keep = order.ordered_devices(doc)
            got = [m for m in live_matches[n] if keep[m["device_id"]]]
            want = [m for m in retro[n] if keep[m["device_id"]]]
            rec["live_equals_retrospective"][n] = (
                sorted(got, key=_match_key) == sorted(want, key=_match_key))
            rec["matches_outside_the_contract"][n] = {
                "live": len(live_matches[n]) - len(got),
                "retrospective": len(retro[n]) - len(want)}
            if not rec["live_equals_retrospective"][n]:
                a = {tuple(sorted(m.items())) for m in got}
                b = {tuple(sorted(m.items())) for m in want}
                rec.setdefault("differences", {})[n] = {
                    "live_only": [dict(m) for m in sorted(a - b)[:4]],
                    "retrospective_only": [dict(m) for m in sorted(b - a)[:4]]}
    if load is not None:
        rec["rules"]["eval_ms_per_batch"] = (
            rec["rules"]["eval_s"] * 1e3
            / max(1, rec["rules"]["eval_batches"]))
        rec["rules_load"] = {k: v for k, v in load.items()
                             if k != "alert_codes"}
        rec["program_alerts_stored"] = sum(stored_alerts.values())
    emit(_busy(rec, span_ms, None, elapsed, delta["steps"]))
    check(launches == delta["steps"],
          f"kernel launched {launches}x in {delta['steps']} dispatcher steps")
    if load is not None:
        n_fired = sum(fired.values())
        check(n_fired > 0 and rec["rule_program_alerts"] == n_fired
              == rec["rules"]["alerts"],
              f"program alerts: injected {n_fired}, dispatcher "
              f"{rec['rule_program_alerts']}, engine {rec['rules']['alerts']}")
        check(stored_alerts == fired,
              f"{sum(stored_alerts.values())} program alerts stored for "
              f"{n_fired} fired: one lost or stored twice")
    check(delta["accepted"] == registered + delta["derived_alerts"],
          f"accepted {delta['accepted']} != registered {registered} + "
          f"derived {delta['derived_alerts']}")
    check(appended["rows"] == delta["accepted"],
          f"rows appended {appended['rows']} != accepted {delta['accepted']}")
    check(committed == records == len(payloads),
          f"committed offset {committed}, journal records {records}")
    check(parked == 0 and dead == 0,
          f"{parked} seal jobs parked, {dead} rows dead-lettered")
    check(stored == appended,
          f"stored rows {stored} != accepted rows {appended}: a row lost "
          "or stored twice")
    if analytics is not None:
        check(an["live_dropped"] == 0,
              f"analytics dropped {an['live_dropped']} live batches: live "
              "and retrospective matches cannot agree")
        check(rec["disordered_devices"]["m0"]["rows"] == 0,
              "measurement rows reached the runner out of time order")
        check(all(rec["live_equals_retrospective"].values()),
              f"live != retrospective matches: "
              f"{rec['live_equals_retrospective']}")
        check(all(live_matches.get(n) for n in retro),
              f"a query never matched: {rec['analytics_matches']}")
    if not meas:
        restore_full(device, data_dir, saved_state, save_stats, saved_rules,
                     phase=phase,
                     run="checkpoint_full" + (".analytics" if analytics
                                              else ".rules" if load else ""),
                     saved_analytics=saved_analytics)
    shutil.rmtree(data_dir, ignore_errors=True)
    return rec


def settle(inst):
    """Flush the dispatcher, then until the rule engine is idle: drain it
    (its worker injects the program alerts it fires) and flush again, so
    every program alert is stored."""
    disp, eng = inst.dispatcher, inst.rule_engine
    disp.flush()
    while eng is not None:
        eng.drain(timeout_s=120.0)
        disp.flush()
        with eng._q.all_tasks_done:
            idle = eng._q.unfinished_tasks == 0
        if idle and disp.batcher.pending == 0:
            return


class OfferOrder:
    """Which devices' rows reached the analytics runner out of time order.

    Live and retrospective evaluation agree by construction only for a
    per-device time-ordered stream (the operators' split invariance): the
    store keeps each device's rows in the order they were offered, but
    splits them into other batches.  A derived or program alert
    re-enters the pipeline after its source plan's egress, so it can
    follow a later row of the same device.  Every offered row is checked,
    in offer order, against the newest row offered before it for its
    device: over all rows, and over the measurement rows of ``m0`` alone
    (what the window queries read)."""

    def __init__(self, runner, capacity):
        self.newest = {"all": np.full(capacity, -1, np.int64),
                       "m0": np.full(capacity, -1, np.int64)}
        self.late = {k: np.zeros(capacity, bool) for k in self.newest}
        self.rows = {k: 0 for k in self.newest}
        real = runner.submit_live

        def submit(cols, mask, trace=None, committed=None):
            m = np.asarray(mask)
            dev = np.asarray(cols["device_id"])[m].astype(np.int64)
            ts = np.asarray(cols["ts_s"])[m].astype(np.int64)
            m0 = ((np.asarray(cols["event_type"])[m] == 0)
                  & (np.asarray(cols["mtype_id"])[m] == 0))
            for key, sel in (("all", slice(None)), ("m0", m0)):
                d, t = dev[sel], ts[sel]
                ok = (d >= 0) & (d < capacity)
                self._scan(key, d[ok], t[ok])
            return real(cols, mask, trace=trace, committed=committed)

        runner.submit_live = submit

    def _scan(self, key, d, t):
        """Rows older than the newest earlier row of their device, in this
        batch's order: a running max over each device's rows (sorted by
        device, stably), seeded with the newest of earlier batches."""
        order = np.argsort(d, kind="stable")
        ds, ts = d[order], t[order]
        run = np.maximum.accumulate((ds << 32) | ts)
        prev = np.concatenate([[-1], run[:-1]])
        same = (prev >> 32) == ds
        before = np.maximum(np.where(same, prev & 0xFFFFFFFF, -1),
                            self.newest[key][ds])
        late = ts < before
        self.rows[key] += int(late.sum())
        self.late[key][ds[late]] = True
        np.maximum.at(self.newest[key], ds, ts)

    def counts(self):
        return {k: {"devices": int(self.late[k].sum()),
                    "rows": self.rows[k]} for k in self.late}

    def ordered_devices(self, doc):
        """The devices whose rows the query reads all arrived in time
        order (a boolean mask over device ids)."""
        key = "m0" if doc["kind"] == "window" and doc.get("mtype") == "m0" \
            else "all"
        return ~self.late[key]


def _match_key(m):
    return (m["ts_s"], m["device_id"], m["start_ts_s"], m["value"],
            m["count"])


def analytics_metrics(inst):
    """The ``analytics.*`` family: live batches, drops, replay skips, and
    each query's eval seconds (timer total and count) and matches."""
    m = inst.metrics
    out = {k: m.counter(f"analytics.{k}").value for k in (
        "live_batches", "live_dropped", "live_shed", "replay_rows_skipped")}
    out["queries"] = {}
    for name, entry in inst.analytics._queries.items():
        t = entry.timer
        out["queries"][name] = {
            "eval_s": t.total, "eval_batches": t.count,
            "eval_ms_per_batch": t.total * 1e3 / max(1, t.count),
            "matches": entry.counter.value}
    return out


def rules_metrics(inst):
    """The ``rules.*`` family's totals (zeros without an engine)."""
    m = inst.metrics
    t = m.timer("rules.eval_s")
    return {"eval_s": t.total, "eval_batches": t.count,
            "live_batches": m.counter("rules.live_batches").value,
            "live_dropped": m.counter("rules.live_dropped").value,
            "alerts": m.counter("rules.alerts").value}


def restore_full(device, data_dir, saved_state, save_stats, saved_rules,
                 phase="persist_recover", run="checkpoint_full",
                 saved_analytics=None):
    """checkpoint_full: a fresh instance restores the saved instance's
    newest generation; the state must equal the saved one bitwise, the
    rule programs and attribute tables must come back as saved, and so
    must every analytics query's operator state."""
    from sitewhere_tpu_torch.instance import Instance

    ckpt = os.path.join(data_dir, "checkpoint")
    t0 = time.perf_counter()
    inst = Instance(instance_config(data_dir, CAPACITY, FULL_B, 0,
                                    WIRE_DEADLINE_MS), device=device)
    construct_s = time.perf_counter() - t0
    try:
        check(inst.restored, "checkpoint_full: nothing restored")
        got = inst.device_state.snapshot_host()
        unequal = sorted(k for k in saved_state
                         if got[k].dtype != saved_state[k].dtype
                         or got[k].tobytes() != saved_state[k].tobytes())
        restore = dict(inst.checkpointer.restore_stats)
        restore_s = inst.checkpointer.restore_s
        eng = inst.rule_engine
        got_attrs = eng.attributes.snapshot_payload()
        rules_equal = (
            eng.registry.snapshot_payload()[0] == saved_rules[0]
            and got_attrs[0] == saved_rules[1][0]
            and all(np.array_equal(got_attrs[1][t], saved_rules[1][1][t])
                    for t in ("device", "asset")))
        programs = eng.registry.program_count()
        got_an = {n: e.compiled.export_state()
                  for n, e in inst.analytics._queries.items()}
        an_unequal = sorted(
            f"{n}.{k}" for n, arrays in (saved_analytics or {}).items()
            for k, a in arrays.items()
            if n not in got_an or got_an[n][k].dtype != a.dtype
            or got_an[n][k].tobytes() != a.tobytes())
        an_bytes = int(sum(a.nbytes for arrays in got_an.values()
                           for a in arrays.values()))
    finally:
        inst.terminate()
    gen = max(int(f.split("-")[1].split(".")[0]) for f in os.listdir(ckpt)
              if f.startswith("manifest-"))
    emit({"phase": phase, "run": run,
          "capacity": CAPACITY, "devices": N_ACTIVE,
          "rule_programs": programs, "rule_programs_equal": rules_equal,
          "state_fields": len(saved_state),
          "state_bytes_in_memory": int(sum(a.nbytes
                                           for a in saved_state.values())),
          "save": save_stats, "restore_s": restore_s,
          "restore": restore, "instance_construct_s": construct_s,
          "generation": gen, "unequal_fields": unequal,
          "analytics_queries": len(got_an),
          "analytics_state_bytes": an_bytes,
          "analytics_unequal_fields": an_unequal})
    check(not unequal, f"restored state differs from the saved: {unequal}")
    check(not an_unequal and len(got_an) == len(saved_analytics or {}),
          f"restored analytics state differs from the saved: {an_unequal}")
    check(rules_equal, "restored rule programs or attributes differ")


# -- kill -9 and restart --------------------------------------------------------


def keyed_payloads(n_payloads, lines, n_active, ts0_ms, seed):
    """Measurement-only NDJSON payloads in which every line has its own
    eventDate (one second apart: its second is the row's key), values
    where no rule fires (so no derived alerts, and every payload is one
    plan whatever the timing) and the share of unregistered tokens.
    Returns ``(payloads, registered keys per payload)``."""
    rng = np.random.default_rng(seed)
    lo, hi = MEAS_VALUE_BAND
    out, keys = [], []
    for p in range(n_payloads):
        dev = rng.integers(0, n_active, lines)
        ghost = rng.random(lines) < WIRE_GHOSTS
        value = rng.uniform(lo, hi, lines)
        ts = ts0_ms + 1000 * (p * lines + np.arange(lines))
        out.append("\n".join(
            _M_LINE % (f"x-{d}" if g else f"d-{d}", d % M_SLOTS, v, t)
            for d, g, v, t in zip(dev.tolist(), ghost.tolist(),
                                  value.tolist(), ts.tolist())).encode())
        keys.append(ts[~ghost] // 1000)
    return out, keys


def stored_key_counts(store):
    """(unique keys, their counts) of the stored rows, and how many of
    them are not measurements."""
    parts, others = [], 0
    for c in store.iter_chunks():
        meas = np.asarray(c["event_type"]) == 0
        others += int((~meas).sum())
        parts.append(np.asarray(c["ts_s"], np.int64)[meas])
    keys = np.concatenate(parts) if parts else np.zeros(0, np.int64)
    uniq, counts = np.unique(keys, return_counts=True)
    return uniq, counts, others


def kill_child(spec):
    """One instance life in its own process (``--kill-child``).

    ``role`` golden / kill: restore the world, start, save an anchor
    checkpoint, ingest the payloads with a quiesced checkpoint every
    KILL_SAVE_EVERY, flush; the golden one writes its final state and
    stops.  Under ``SW_CRASHPOINT`` a kill child dies on the way.
    ``role`` verify: restart on the survivor's directory (restore in the
    constructor, replay in ``start``), ingest the payloads that never
    reached the journal, and check the recovery contract."""
    import torch

    from sitewhere_tpu_torch.device import resolve_device
    from sitewhere_tpu_torch.ingest.journal import Journal
    from sitewhere_tpu_torch.instance import Instance
    from sitewhere_tpu_torch.ops import geo_cuda

    device = resolve_device(spec["device"])
    torch.set_num_threads(2)
    if device.type == "cuda":
        torch.ones(1, device=device)
        torch.cuda.synchronize()
    boot_s = time.time() - spec["spawned_at"]
    data_dir = spec["data_dir"]
    capacity, n_active, width = spec["capacity"], spec["n_active"], \
        spec["width"]
    ring, deadline = spec["ring_depth"], spec["deadline_ms"]
    payloads, keys = keyed_payloads(KILL_PAYLOADS, width, n_active,
                                    KILL_TS0_MS, SEED + 7)
    out = {"role": spec["role"], "point": spec.get("point"),
           "boot_s": boot_s}
    if spec["role"] in ("golden", "kill"):
        inst = instance_from_world(device, spec["world_ckpt"], data_dir,
                                   capacity, width, ring, deadline)
        inst.start()
        disp = inst.dispatcher
        disp.flush()
        inst.checkpointer.save()
        for k, payload in enumerate(payloads):
            disp.ingest_wire_lines(payload)
            if (k + 1) % KILL_SAVE_EVERY == 0:
                disp.flush()
                inst.checkpointer.save()
        disp.flush()
        np.savez(spec["state_out"], **inst.device_state.snapshot_host())
        inst.stop()
        inst.terminate()
        with open(spec["result_out"], "w") as f:
            json.dump(out, f)
        return
    # verify: what survived, read before the restart opens it
    journal = Journal(data_dir, name="ingest")
    journaled = set()
    for _, p in journal.scan(0):
        first = p[:p.index(b"\n")] if b"\n" in p else p
        t = json.loads(first)["request"]["eventDate"]
        journaled.add((t - KILL_TS0_MS) // 1000 // width)
    journal.close()
    committed_at_kill = spec["committed_at_kill"]
    t0 = time.perf_counter()
    inst = Instance(instance_config(data_dir, capacity, width, ring,
                                    deadline), device=device)
    construct_s = time.perf_counter() - t0
    check(inst.restored, "restart restored no checkpoint")
    launches0 = geo_cuda.launch_counts["pip_parity"]
    t0 = time.perf_counter()
    inst.start()
    start_s = time.perf_counter() - t0
    disp = inst.dispatcher
    gauges = inst.metrics.snapshot()["gauges"]
    missing = [k for k in range(KILL_PAYLOADS) if k not in journaled]
    for k in missing:
        disp.ingest_wire_lines(payloads[k])
    disp.flush()
    launches = geo_cuda.launch_counts["pip_parity"] - launches0
    warm = ring if ring else 1
    uniq, counts, not_measurements = stored_key_counts(inst.event_store)
    expected = np.unique(np.concatenate(keys))
    below = np.unique(np.concatenate(keys[:committed_at_kill])) \
        if committed_at_kill else np.zeros(0, np.int64)
    lost = np.setdiff1d(expected, uniq)
    extra = np.setdiff1d(uniq, expected)
    twice = np.intersect1d(below, uniq[counts > 1])
    out.update({
        "restored_generation": inst.checkpointer.restored_generation,
        "replay_floor": inst.checkpointer.replay_floor,
        "committed_at_kill": committed_at_kill,
        "journaled_payloads": len(journaled),
        "resumed_payloads": len(missing),
        "instance_construct_s": construct_s,
        "restore_s": float(gauges["recovery.restore_s"]),
        "restore": dict(inst.checkpointer.restore_stats),
        "start_s": start_s,
        "warm_up_s": start_s - float(gauges["recovery.replay_s"]),
        "replay_s": float(gauges["recovery.replay_s"]),
        "replay_events": int(gauges["recovery.replay_events"]),
        "steps": disp.steps, "pip_launches": launches - warm,
        "rows_expected": int(expected.size), "rows_stored": int(counts.sum()),
        "lost": int(lost.size), "extra": int(extra.size),
        "below_committed_twice": int(twice.size),
        "rows_not_measurements": not_measurements,
        "stored_twice_above": int((counts > 1).sum()) - int(twice.size),
        "catalog_problems": inst.event_store.verify_catalog(),
        "dedup_floor_after": disp.store_dedup_floor,
    })
    np.savez(spec["state_out"], **inst.device_state.snapshot_host())
    inst.stop()
    inst.terminate()
    with open(spec["result_out"], "w") as f:
        json.dump(out, f)


def _spawn(spec, env_extra=None):
    """Start one ``--kill-child`` process; its stderr goes to a file next
    to its result (a pipe nobody reads could fill and stall it)."""
    spec = dict(spec, spawned_at=time.time())
    env = dict(os.environ)
    env.pop("SW_CRASHPOINT", None)
    env.update(env_extra or {})
    with open(spec["result_out"] + ".err", "wb") as err:
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--kill-child",
             json.dumps(spec)], env=env, stdout=subprocess.DEVNULL,
            stderr=err, cwd=os.path.dirname(os.path.abspath(__file__)))
    proc.err_path = spec["result_out"] + ".err"
    return proc


def _wait_all(procs, timeout_s):
    """Wait for every child; on a timeout kill every one still running.
    Returns ``{name: (returncode, stderr tail)}``."""
    deadline = time.monotonic() + timeout_s
    out = {}
    try:
        for name, proc in procs.items():
            proc.wait(timeout=max(1.0, deadline - time.monotonic()))
            with open(proc.err_path, "rb") as f:
                err = f.read()[-3000:].decode(errors="replace")
            out[name] = (proc.returncode, err)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


def _read_result(path):
    with open(path) as f:
        return json.load(f)


def _state_close(golden_npz, got_npz):
    """Device state against the golden run's: ints exact, EWMA within
    EWMA_MAX_ULP of the value scale, other floats bitwise.  Returns the
    unequal fields and the EWMA's largest error in ULPs of the scale."""
    a, b = np.load(golden_npz), np.load(got_npz)
    unequal, worst = [], 0.0
    for k in a.files:
        x, y = a[k], b[k]
        if x.dtype != y.dtype or x.shape != y.shape:
            unequal.append(k)
        elif k == "ewma_values":
            err = np.abs(x.astype(np.float64) - y.astype(np.float64))
            scale = np.maximum(np.abs(x), EWMA_SCALE) * 2.0 ** -23
            fin = np.isfinite(x)
            if not np.array_equal(x[~fin], y[~fin], equal_nan=True):
                unequal.append(k)
            worst = max(worst, float((err[fin] / scale[fin]).max()))
            if worst > EWMA_MAX_ULP:
                unequal.append(k)
        elif x.tobytes() != y.tobytes():
            unequal.append(k)
    return unequal, worst


def committed_offset(data_dir):
    try:
        with open(os.path.join(data_dir, "ingest", "pipeline.offset")) as f:
            return int(f.read().strip() or 0)
    except OSError:
        return 0


def kill_recover(device, worlds, root):
    """Golden children and one killed child per crash point, then one
    restart per kill on the survivor's directory (crashrec's protocol).
    The small children run side by side; the full-size restart runs
    alone, so its recovery times are those users would see."""
    def spec(role, name, size, ring, deadline, **kw):
        d = os.path.join(root, name)
        capacity, n_active, width = SIZES[size]
        return dict(role=role, size=size, capacity=capacity,
                    n_active=n_active, width=width, ring_depth=ring,
                    deadline_ms=deadline, data_dir=d,
                    world_ckpt=worlds[size], device=str(device),
                    state_out=os.path.join(root, f"{name}-state.npz"),
                    result_out=os.path.join(root, f"{name}.json"), **kw)

    os.makedirs(root, exist_ok=True)
    specs, procs = {}, {}
    for size in ("full", "small"):
        name = f"golden-{size}"
        specs[name] = spec("golden", name, size, 0, WIRE_DEADLINE_MS)
        procs[name] = _spawn(specs[name])
    for point, hit, size, ring, deadline in KILLS:
        name = f"kill-{point.split('.')[1]}"
        specs[name] = spec("kill", name, size, ring, deadline, point=point)
        procs[name] = _spawn(specs[name],
                             {"SW_CRASHPOINT": f"{point}:{hit}"})
    t0 = time.perf_counter()
    done = _wait_all(procs, 600)
    children_s = time.perf_counter() - t0
    for name, (rc, err) in done.items():
        if name.startswith("golden"):
            check(rc == 0, f"{name} failed (rc {rc}): {err}")
        else:
            check(rc == -signal.SIGKILL,
                  f"{name} was not killed at its point (rc {rc}): {err}")
    # restarts: the small ones side by side, then the full-size one alone
    verify = {}
    for point, hit, size, ring, deadline in KILLS:
        kname = f"kill-{point.split('.')[1]}"
        d = specs[kname]["data_dir"]
        verify[kname] = spec("verify", f"verify-{kname}", size, ring,
                             deadline, point=point,
                             committed_at_kill=committed_offset(d))
        verify[kname]["data_dir"] = d
    order = ([k for k in verify if specs[k]["size"] == "small"],
             [k for k in verify if specs[k]["size"] == "full"])
    for group in order:
        procs = {k: _spawn(verify[k]) for k in group}
        for name, (rc, err) in _wait_all(procs, 600).items():
            check(rc == 0, f"restart after {name} failed (rc {rc}): {err}")
    runs = []
    for point, hit, size, ring, deadline in KILLS:
        kname = f"kill-{point.split('.')[1]}"
        res = _read_result(verify[kname]["result_out"])
        unequal, ulp = _state_close(specs[f"golden-{size}"]["state_out"],
                                    verify[kname]["state_out"])
        capacity, n_active, width = SIZES[size]
        res.update({"kill_hit": hit, "size": size, "capacity": capacity,
                    "devices": n_active, "width": width,
                    "payloads": KILL_PAYLOADS, "ring_depth": ring,
                    "deadline_ms": deadline,
                    "state_unequal_fields": unequal,
                    "ewma_max_ulp_of_scale": ulp})
        emit({"phase": "persist_recover", "run": f"kill_recover.{point}",
              **res})
        runs.append(res)
        check(res["lost"] == 0, f"{point}: {res['lost']} committed rows lost")
        check(res["extra"] == 0 and res["rows_not_measurements"] == 0,
              f"{point}: {res['extra']} unknown rows, "
              f"{res['rows_not_measurements']} not measurements")
        check(res["below_committed_twice"] == 0,
              f"{point}: {res['below_committed_twice']} rows below the "
              "committed offset stored twice")
        check(res["catalog_problems"] == [],
              f"{point}: catalog {res['catalog_problems']}")
        check(res["dedup_floor_after"] == 0, f"{point}: dedup floor kept")
        check(res["pip_launches"] == res["steps"],
              f"{point}: kernel launched {res['pip_launches']}x in "
              f"{res['steps']} steps")
        check(not unequal, f"{point}: state differs from golden: {unequal}")
    emit({"phase": "persist_recover", "run": "kill_recover.done",
          "children_s": children_s, "kills": len(runs)})
    return runs


def phase_persist_recover(device, geo_cuda, mixed, meas):
    """Persistence and restart on the wire path: the throughput runs with
    the real segment store over the payloads of ``dispatcher_wire``
    (``mixed``, ``meas``), one full-size checkpoint save and restore, and
    kill -9 recovery at five crash points.  Returns the kernel's launches
    in each throughput run, by run name."""
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="persist-", dir=geo_cuda.BUILD_DIR)
    launches = {}
    try:
        worlds = {size: world_checkpoint(device, root, size)
                  for size in ("full", "small")}
        emit({"phase": "persist_recover", "run": "setup",
              "world_s": time.perf_counter() - t0})
        rec = persist_throughput(device, geo_cuda, worlds["full"], mixed,
                                 root, "ring0")
        launches["persist_throughput.ring0"] = rec["pip_launches"]
        rec = persist_throughput(device, geo_cuda, worlds["full"], meas,
                                 root, "measurements_ring0", meas=True)
        launches["persist_throughput.measurements_ring0"] = \
            rec["pip_launches"]
        kill_recover(device, worlds, os.path.join(root, "kills"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "persist_recover", "run": "done",
          "seconds": time.perf_counter() - t0})
    return launches


# -- bring-your-own rule programs ------------------------------------------------

_RULEBENCH_POLY = [[0.0, 0.0], [10.0, 0.0], [10.0, 10.0], [0.0, 10.0]]


def rulebench_program_doc(rng, idx):
    """One program of ``tools/rulebench.py``'s skewed mix (its
    ``_program_doc``, copied: that tool imports JAX)."""
    token = f"p{idx}"
    thr = float(rng.uniform(10.0, 90.0))
    op = str(rng.choice(["gt", "lt", "gte", "lte"]))
    level = str(rng.choice(["info", "warning", "error", "critical"]))
    alert = {"type": f"byo.kind{int(rng.integers(0, 16))}",
             "level": level}
    shape = rng.random()
    if shape < 0.55:
        when = {"pred": "value", "op": op, "value": thr}
    elif shape < 0.70:
        when = {"all": [
            {"pred": "ewma", "op": op, "value": thr,
             "window_s": float(rng.choice([60, 600, 3600]))},
            {"pred": "rate", "op": "gt",
             "value": float(rng.uniform(0.1, 5.0))}]}
    elif shape < 0.82:
        when = {"any": [
            {"pred": "value", "op": "gt", "value": thr},
            {"pred": "value", "op": "lt", "value": thr - 30.0},
            {"all": [{"pred": "rate", "op": "gt", "value": 1.0},
                     {"pred": "value", "op": "gt", "value": thr - 10.0}]}]}
    elif shape < 0.90:
        jx, jy = rng.uniform(-2, 2, 2)
        poly = [[x + jx, y + jy] for x, y in _RULEBENCH_POLY]
        when = {"pred": "geo", "polygon": poly,
                "inside": bool(rng.random() < 0.5)}
    elif shape < 0.95:
        when = {"any": [
            {"all": [
                {"pred": "value", "op": "gt", "value": thr},
                {"pred": "attr", "table": "device", "column": "tier",
                 "value": int(rng.integers(0, 4)), "op": "eq"},
                {"pred": "event_type", "value": "measurement"},
                {"pred": "ewma", "op": "gt", "value": thr - 5.0,
                 "window_s": 600.0},
                {"pred": "rate", "op": "gt", "value": 0.5}]},
            {"all": [{"pred": "value", "op": "lt", "value": 5.0}]},
            {"all": [{"pred": "value", "op": "gt", "value": 95.0}]}]}
    else:
        when = {"any": [
            {"all": [{"pred": "geo", "polygon": _RULEBENCH_POLY,
                      "inside": True},
                     {"pred": "value", "op": "gt", "value": thr}]},
            {"all": [{"pred": "rate", "op": "gt", "value": 2.0}]},
            {"all": [{"pred": "value", "op": "lt", "value": 2.0}]}]}
    return {"token": token, "name": f"bench-{idx}", "alert": alert,
            "when": when}


def world_program_docs(tenant, box):
    """The world tenant's RULE_PER_KEY programs of each structure key,
    set to fire on about 1% of the traffic's rows: measurements above 99
    or below 0.3 (values are uniform on [0, 100]) and locations inside
    eight small squares of the traffic's ``box`` (lon0, lon1, lat0,
    lat1).  Every predicate kind appears; some clauses never fire (a
    rate of 1e6/s), as in tenants' real programs."""
    lon0, lon1, lat0, lat1 = box
    side = math.sqrt(RULE_SQUARE_SHARE * (lon1 - lon0) * (lat1 - lat0))

    def square(k):
        cx = lon0 + (lon1 - lon0) * ((3 * k + tenant) % 8 + 0.5) / 8
        cy = lat0 + (lat1 - lat0) * ((5 * k + tenant) % 8 + 0.5) / 8
        h = side / 2
        return [[cx - h, cy - h], [cx + h, cy - h], [cx + h, cy + h],
                [cx - h, cy + h]]

    levels = ("info", "warning", "error", "critical")
    docs = []
    for j in range(RULE_PER_KEY):
        whens = {
            "c2p4": {"pred": "value", "op": "gt", "value": 99.9 + 0.02 * j},
            "c2p4g": {"pred": "geo", "polygon": square(j), "inside": True},
            "c4p4": {"any": [
                {"pred": "value", "op": "lt", "value": 0.3 - 0.05 * j},
                {"pred": "value", "op": "gt", "value": 99.95},
                {"all": [{"pred": "rate", "op": "gt", "value": 1e6},
                         {"pred": "value", "op": "gt", "value": 99.0}]}]},
            "c4p4g": {"any": [
                {"all": [{"pred": "geo", "polygon": square(4 + j),
                          "inside": True},
                         {"pred": "event_type", "value": "location"}]},
                {"all": [{"pred": "ewma", "op": "lt", "value": -1.0,
                          "window_s": 60.0}]},
                {"all": [{"pred": "value", "op": "gt", "value": 99.97}]}]},
            "c4p8": {"any": [
                {"all": [
                    {"pred": "value", "op": "gt", "value": 99.0},
                    {"pred": "attr", "table": "device", "column": "tier",
                     "op": "eq", "value": j},
                    {"pred": "event_type", "value": "measurement"},
                    {"pred": "ewma", "op": "gt", "value": 95.0,
                     "window_s": 600.0},
                    {"pred": "attr", "table": "asset", "column": "grade",
                     "op": "gte", "value": 0},
                    {"pred": "value", "op": "lt", "value": 1000.0}]},
                {"all": [{"pred": "value", "op": "lt", "value": 0.02}]},
                {"all": [{"pred": "rate", "op": "lt", "value": -1e6}]}]},
        }
        for key in RULE_KEYS:
            docs.append({"token": f"w{tenant}-{key}-{j}",
                         "alert": {"type": f"world.{key}.{j}",
                                   "level": levels[j]},
                         "when": whens[key]})
    return docs


def load_rule_programs(eng, world_tenants, box, n_devices, seed):
    """The world tenants' programs, the rulebench population over tenants
    after them, and the attribute columns (``tier`` for every active
    device, ``grade`` for every asset), through the registry and one
    publish.  Returns a record of the load."""
    from sitewhere_tpu_torch.rules import compile as rcompile

    t0 = time.perf_counter()
    for tenant in world_tenants:
        for doc in world_program_docs(tenant, box):
            eng.registry.put_program(tenant, doc)
    rng = np.random.default_rng(seed)
    rejected = 0
    base = max(world_tenants) + 1
    for i in range(RULE_POP_PROGRAMS):
        doc = rulebench_program_doc(rng, i)
        try:
            eng.registry.put_program(
                base + int(rng.integers(0, RULE_POP_TENANTS)), doc)
        except ValueError:
            # a per-tenant structure-slot collision of the random draw
            rejected += 1
    ids = np.arange(n_devices)
    eng.attributes.set_many("device", ids, "tier", ids % 4)
    assets = np.arange(5000)
    eng.attributes.set_many("asset", assets, "grade", assets % 3)
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    epoch = eng.refresh()
    publish_s = time.perf_counter() - t0
    world = sorted(world_tenants)
    codes = {p.alert_code for g in eng.registry._groups.values()
             for (t, _), p in g.programs.items() if t in world}
    keys = eng.registry.structure_keys()
    check(keys == sorted(RULE_KEYS), f"structure keys {keys}")
    return {"programs": eng.registry.program_count(),
            "world_programs": len(world) * RULE_PER_KEY * len(RULE_KEYS),
            "population_rejected": rejected, "structure_keys": keys,
            "tables": {g.key: {n: list(t.shape) for n, t in
                               zip(g.tables._fields, g.tables)}
                       for g in epoch.groups},
            "signatures": rcompile.compile_count(),
            "load_s": load_s, "publish_s": publish_s,
            "alert_codes": codes}


def rule_batches(n, width, seed, ts0=1_700_000_000):
    """Engine batches: the main path's 60/30/10 columns with the accepted
    mask the step would give (valid, registered, tenant matching) and the
    registry's asset id."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        c = make_batch_cols(rng, width, N_ACTIVE, CAPACITY, ts0 + i)
        dev = c["device_id"]
        reg = dev < N_ACTIVE
        out.append({
            "device_id": dev, "tenant_id": c["tenant_id"],
            "event_type": c["event_type"], "mtype_id": c["mtype_id"],
            "value": c["value"], "lon": c["lon"], "lat": c["lat"],
            "ts_s": c["ts_s"], "ts_ns": c["ts_ns"],
            "asset_id": np.where(reg, dev % 5000, -1).astype(np.int32),
            "accepted": c["valid"] & reg & (c["tenant_id"] == dev % N_TENANTS),
        })
    return out


class PassClock:
    """CUDA events and the allocator's peak around the engine's prepare
    pass and each group pass (by structure key), on the stream they run
    on.  Nothing on the CPU."""

    def __init__(self, eng, device):
        import torch

        from sitewhere_tpu_torch.rules import compile as rcompile

        self.torch, self.rcompile = torch, rcompile
        self.on = device.type == "cuda"
        self.eng = eng
        self.keys = {g.tables.kind.data_ptr(): g.key
                     for g in eng.registry.current_epoch().groups}
        self.pairs = collections.defaultdict(list)
        self.peak = collections.defaultdict(float)
        self.max_allocated = 0
        self._group = rcompile.rules_group_eval
        self._prepare = eng._prepare

    def _timed(self, name, fn, *args, **kw):
        torch = self.torch
        if not self.on:
            return fn(*args, **kw)
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args, **kw)
        end.record()
        self.pairs[name].append((start, end))
        top = torch.cuda.max_memory_allocated()
        self.peak[name] = max(self.peak[name], top - base)
        self.max_allocated = max(self.max_allocated, top)
        return out

    def __enter__(self):
        def group(tables, *args, **kw):
            return self._timed(self.keys[tables.kind.data_ptr()],
                               self._group, tables, *args, **kw)

        self.rcompile.rules_group_eval = group
        self.eng._prepare = lambda *a: self._timed("prepare",
                                                   self._prepare, *a)
        return self

    def __exit__(self, *exc):
        self.rcompile.rules_group_eval = self._group
        self.eng._prepare = self._prepare
        return False

    def ms_per_batch(self, batches):
        if not self.on:
            return None
        self.torch.cuda.synchronize()
        return {k: sum(s.elapsed_time(e) for s, e in v) / batches
                for k, v in self.pairs.items()}


def _run_passes(eng, batch, trail, device, tables_of):
    """The prepare and group passes of ``_eval_batch``, called directly on
    ``device`` with the given trail (updated in place) and the current
    epoch's tables as ``tables_of(group)`` gives them.  Returns the
    features and ``{key: (fired, code, level, pid)}`` on the host."""
    import torch

    from sitewhere_tpu_torch.rules import compile as rcompile

    attrs = eng.attributes.publish()
    t = {k: torch.from_numpy(np.ascontiguousarray(batch[k])).to(device)
         for k in ("device_id", "asset_id", "ts_s", "ts_ns", "mtype_id",
                   "event_type", "tenant_id", "value", "lon", "lat",
                   "accepted")}
    feats, _ = rcompile.rules_prepare_batch(
        *trail, attrs.device.to(device), attrs.asset.to(device),
        t["device_id"], t["asset_id"], t["ts_s"], t["ts_ns"], t["mtype_id"],
        t["value"], t["event_type"], t["accepted"], eng.taus.to(device))
    outs = {}
    for g in eng.registry.current_epoch().groups:
        out = rcompile.rules_group_eval(
            tables_of(g), feats, t["tenant_id"], t["event_type"],
            t["mtype_id"], t["value"], t["lon"], t["lat"], t["accepted"],
            has_geo=g.has_geo)
        outs[g.key] = tuple(x.cpu().numpy() for x in out)
    return {k: v.cpu().numpy() for k, v in feats._asdict().items()}, outs


def _ulp_of(ref, got, floor):
    """Largest ``|ref - got|`` in ULPs of ``max(|ref|, floor)`` (finite
    entries; non-finite ones must match)."""
    fin = np.isfinite(ref)
    check(np.array_equal(ref[~fin], got[~fin], equal_nan=True),
          "non-finite entries differ")
    if not fin.any():
        return 0.0
    err = np.abs(ref[fin].astype(np.float64) - got[fin].astype(np.float64))
    unit = np.spacing(np.maximum(np.abs(ref[fin]), np.float32(floor)))
    return float((err / unit).max())


def rules_card_vs_cpu(eng, device, batches):
    """At RULE_CPU_ROWS rows: the passes on the card and on the CPU, from
    the same trail (a copy of the engine's), over two consecutive
    batches: fired/code/level/pid and the trail's ints exact, features
    within the ULP bounds."""
    import torch

    cpu = torch.device("cpu")
    card_trail = tuple(x.clone() for x in eng._trail)
    cpu_trail = tuple(x.to(cpu, copy=True) for x in card_trail)
    worst = {"ewma": 0.0, "rate": 0.0}
    fired = 0
    for batch in batches:
        fc, oc = _run_passes(eng, batch, card_trail, device,
                             lambda g: g.tables)
        fh, oh = _run_passes(
            eng, batch, cpu_trail, cpu,
            lambda g: type(g.tables)(*(x.cpu() for x in g.tables)))
        for key in oc:
            for name, a, b in zip(("fired", "code", "level", "pid"),
                                  oh[key], oc[key]):
                check(np.array_equal(a, b),
                      f"card != CPU: {key} {name} "
                      f"({int((a != b).sum())} entries)")
            fired += int(oc[key][0].sum())
        for name in ("rate_valid", "dev_attr", "asset_attr"):
            check(np.array_equal(fh[name], fc[name]), f"card != CPU: {name}")
        worst["ewma"] = max(worst["ewma"], _ulp_of(fh["ewma"], fc["ewma"],
                                                   EWMA_SCALE))
        worst["rate"] = max(worst["rate"], _ulp_of(fh["rate"], fc["rate"],
                                                   np.finfo(np.float32).tiny))
    for i, (a, b) in enumerate(zip(cpu_trail, card_trail)):
        if i < 3:
            # bitwise (NaN measurements are stored as they came)
            check(a.numpy().tobytes() == b.cpu().numpy().tobytes(),
                  f"card != CPU: trail {i}")
        else:
            worst["ewma"] = max(worst["ewma"], _ulp_of(
                a.numpy(), b.cpu().numpy(), EWMA_SCALE))
    check(worst["ewma"] <= EWMA_MAX_ULP, f"EWMA off by {worst['ewma']} ULP")
    check(worst["rate"] <= RATE_MAX_ULP, f"rate off by {worst['rate']} ULP")
    check(fired > 0, "nothing fired in the card-vs-CPU batches")
    return {"rows": len(batches[0]["device_id"]), "batches": len(batches),
            "fired": fired, "ewma_max_ulp_of_scale": worst["ewma"],
            "rate_max_ulp": worst["rate"]}


def rules_card_vs_interp(eng, device, batch):
    """At RULE_INTERP_ROWS rows: the card's alerts, (row, code, level) as
    a multiset, against the port's numpy interpreter over the world
    tenants' programs, from the same trail."""
    from sitewhere_tpu_torch.rules.interp import (
        InterpTrail, interp_eval, interp_features)

    card_trail = tuple(x.clone() for x in eng._trail)
    trail = InterpTrail(*card_trail[3].shape)
    trail.ts_s, trail.ts_ns, trail.value, trail.ewma = (
        x.to("cpu", copy=True).numpy() for x in card_trail)
    _, outs = _run_passes(eng, batch, card_trail, device, lambda g: g.tables)
    card = collections.Counter()
    for fired, code, level, _pid in outs.values():
        rows, slots = np.nonzero(fired)
        card.update(zip(rows.tolist(), code[rows, slots].tolist(),
                        level[rows, slots].tolist()))
    _, arrays = eng.attributes.snapshot_payload()
    tenants = set(np.unique(batch["tenant_id"]).tolist())
    progs = [(t, p.canonical, p.alert_code)
             for g in eng.registry._groups.values()
             for (t, _tok), p in sorted(g.programs.items()) if t in tenants]
    t0 = time.perf_counter()
    feats = interp_features(trail, batch, eng.taus.cpu().tolist(),
                            arrays["device"], arrays["asset"])
    golden = collections.Counter(
        (row, code, lvl) for row, _tok, code, lvl in
        interp_eval(progs, batch, feats))
    interp_s = time.perf_counter() - t0
    check(card == golden,
          f"card != interp: {sum((card - golden).values())} extra, "
          f"{sum((golden - card).values())} missing alerts")
    check(sum(card.values()) > 0, "nothing fired in the interp batch")
    return {"rows": len(batch["device_id"]), "programs": len(progs),
            "alerts": sum(card.values()), "interp_s": interp_s}


def rules_engine_run(device):
    """``rules_engine``: RULE_BATCHES full-width 60/30/10 batches straight
    into the engine's ``_eval_batch``: ms per batch of each pass, engine
    events/s, the allocator's peak, the card's busy share under the
    profiler; then the card against the CPU and against ``interp``."""
    import torch

    from sitewhere_tpu_torch.rules.engine import RuleEngineRunner

    t0 = time.perf_counter()
    eng = RuleEngineRunner(capacity=CAPACITY, n_mtype_slots=M_SLOTS,
                           asset_capacity=RULE_ASSET_CAPACITY, device=device)
    alerts = []
    eng.inject = lambda cols: alerts.append(len(cols["device_id"]))
    load = load_rule_programs(eng, range(N_TENANTS), (-12, 12, -12, 12),
                              N_ACTIVE, SEED + 8)
    batches = rule_batches(1 + RULE_BATCHES + RULE_PROFILED, FULL_B,
                           SEED + 9)
    setup_s = time.perf_counter() - t0
    eng._eval_batch(dict(batches[0]))                 # seeds the trail
    sync = torch.cuda.synchronize if device.type == "cuda" else (
        lambda: None)
    sync()
    alerts.clear()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    timed = batches[1:1 + RULE_BATCHES]
    with PassClock(eng, device) as clock:
        t0 = time.perf_counter()
        for b in timed:
            eng._eval_batch(dict(b))
        sync()
        elapsed = time.perf_counter() - t0
    pass_ms = clock.ms_per_batch(len(timed))
    rows = sum(len(b["device_id"]) for b in timed)
    accepted = sum(int(b["accepted"].sum()) for b in timed)
    n_alerts = sum(alerts)
    with _device_profile(device.type == "cuda") as prof:
        t1 = time.perf_counter()
        for b in batches[1 + RULE_BATCHES:]:
            eng._eval_batch(dict(b))
        sync()
        prof_s = time.perf_counter() - t1
    dev_ms = _device_ms(prof)
    rec = {"phase": "byo_rules", "run": "rules_engine",
           "capacity": CAPACITY, "width": FULL_B, "batches": len(timed),
           "world_tenants": N_TENANTS, **{k: v for k, v in load.items()
                                          if k != "alert_codes"},
           "setup_s": setup_s, "elapsed_s": elapsed,
           "engine_events_per_s": rows / elapsed,
           "ms_per_batch": elapsed / len(timed) * 1e3,
           "pass_ms_per_batch": pass_ms,
           "pass_transient_peak_mib": (
               {k: v / 2**20 for k, v in clock.peak.items()}
               if clock.on else None),
           "peak_allocated_gib": (clock.max_allocated / 2**30
                                  if clock.on else None),
           "run_base_allocated_gib": (base / 2**30 if device.type == "cuda"
                                      else None),
           "alerts": n_alerts, "alerts_per_accepted_row": n_alerts / accepted,
           "profiled_batches": RULE_PROFILED, "profiled_s": prof_s,
           "device_ms_per_batch": (None if dev_ms is None
                                   else dev_ms / RULE_PROFILED),
           "device_busy_share": (None if dev_ms is None
                                 else dev_ms / 1e3 / prof_s),
           "device_ops_per_batch": (None if prof is None
                                    else _device_launches(prof)
                                    / RULE_PROFILED)}
    emit(rec)
    check(n_alerts > 0, "no program fired in rules_engine")
    # the checks, on batches the timed run never saw
    tail = rule_batches(3, RULE_CPU_ROWS, SEED + 10,
                        ts0=1_700_000_000 + 2 * len(batches))
    cpu_rec = rules_card_vs_cpu(eng, device, tail[:2])
    interp_batch = {k: v[:RULE_INTERP_ROWS] for k, v in tail[2].items()}
    interp_rec = rules_card_vs_interp(eng, device, interp_batch)
    emit({"phase": "byo_rules", "run": "rules_engine.checks",
          "card_vs_cpu": cpu_rec, "card_vs_interp": interp_rec})
    return rec


def phase_byo_rules(device, geo_cuda, mixed):
    """Bring-your-own rule programs on the port: ``rules_engine`` (the
    engine alone at full width), then ``rules_wire``: the 60/30/10
    payloads of ``dispatcher_wire`` through the port ``Instance`` with
    its segment store, ring off at 5 ms, without programs and with them
    (the world tenant's programs, the population, the attributes), each
    program alert checked stored exactly once, and checkpoint_full with
    the ``rule-programs`` section.  Returns the kernel's launches in each
    wire run, by run name."""
    t0 = time.perf_counter()
    rules_engine_run(device)
    root = tempfile.mkdtemp(prefix="rules-", dir=geo_cuda.BUILD_DIR)
    launches = {}
    try:
        world = world_checkpoint(device, root, "full")

        def programs(inst):
            return load_rule_programs(
                inst.rule_engine, [inst.identity.tenant.mint("default")],
                (-175, 175, -85, 85), N_ACTIVE, SEED + 11)

        for run, rules in (("off", None), ("on", programs)):
            rec = persist_throughput(
                device, geo_cuda, world, mixed, root, f"rules_{run}",
                rules=rules, phase="byo_rules", name=f"rules_wire.{run}")
            launches[f"rules_wire.{run}"] = rec["pip_launches"]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "byo_rules", "run": "done",
          "seconds": time.perf_counter() - t0})
    return launches


# -- streaming analytics ---------------------------------------------------------


def an_span_ms(rows=None, devices=None):
    """Event time of one batch of ``rows`` rows over ``devices`` devices
    at one report per device per AN_REPORT_S (full width: ~7.9 s)."""
    rows = FULL_B if rows is None else rows
    devices = N_ACTIVE if devices is None else devices
    return int(round(rows / devices * AN_REPORT_S * 1000))


def an_values(rng, n):
    """Measurement values: AN_SET_POINT +- AN_SPREAD_EIGHTHS / 8, on the
    1/8 grid."""
    k = rng.integers(-AN_SPREAD_EIGHTHS, AN_SPREAD_EIGHTHS + 1, n)
    return (AN_SET_POINT + k / 8).astype(np.float32)


def an_check_prefix(value, cross_rows):
    """The window-cross feature's prefix sums over one batch stay exact in
    float32: the sum of |value| over its rows is under 2^21."""
    bound = float(np.abs(value[cross_rows].astype(np.float64)).sum())
    check(bound < AN_PREFIX_BOUND,
          f"a batch's cross-feature prefix reaches {bound} >= 2^21")


def an_payloads(rng, n_payloads, lines, ts0_ms):
    """rules_wire's payload shape (60/30/10 measurements, locations and
    alerts, WIRE_GHOSTS unregistered tokens) on this phase's event time:
    payload p spans ``an_span_ms()`` from ``ts0_ms + p * span``, its lines
    in time order (a gateway's batch); values on the 1/8 grid print as
    exact decimals.  Returns ``[(bytes, registered_lines)]``."""
    span = an_span_ms()
    out = []
    for p in range(n_payloads):
        dev = rng.integers(0, N_ACTIVE, lines)
        ghost = rng.random(lines) < WIRE_GHOSTS
        kind = rng.choice(3, lines, p=[0.6, 0.3, 0.1])
        value = an_values(rng, lines)
        lat = rng.uniform(-85, 85, lines)
        lon = rng.uniform(-175, 175, lines)
        ts = ts0_ms + span * p + np.sort(rng.integers(0, span, lines))
        an_check_prefix(value, (kind == 0) & (dev % M_SLOTS == 0) & ~ghost)
        body = []
        for d, g, k, v, la, lo, t in zip(
                dev.tolist(), ghost.tolist(), kind.tolist(), value.tolist(),
                lat.tolist(), lon.tolist(), ts.tolist()):
            tok = f"x-{d}" if g else f"d-{d}"
            if k == 0:
                body.append(_M_LINE % (tok, d % M_SLOTS, v, t))
            elif k == 1:
                body.append(_L_LINE % (tok, la, lo, v, t))
            else:
                body.append(_A_LINE % (tok, d % 4, t))
        out.append(("\n".join(body).encode(), lines - int(ghost.sum())))
    return out


def an_batches(rng, n, width, ts0_s, devices=None):
    """Runner batches: the accepted rows of payloads shaped as
    :func:`an_payloads`'s, as the egress offer hands them over (device,
    time, type, measurement, value, journal ref); batch b spans
    ``an_span_ms(width, devices)`` from ``ts0_s + b * span``."""
    devices = N_ACTIVE if devices is None else devices
    span = an_span_ms(width, devices)
    out = []
    for b in range(n):
        dev = rng.integers(0, devices, width).astype(np.int32)
        kind = rng.choice(3, width, p=[0.6, 0.3, 0.1]).astype(np.int32)
        ts_ms = ts0_s * 1000 + span * b + np.sort(rng.integers(0, span,
                                                               width))
        mt = np.where(kind == 0, dev % M_SLOTS, -1).astype(np.int32)
        value = np.where(kind == 0, an_values(rng, width), 0.0)
        an_check_prefix(value, mt == 0)
        out.append({"device_id": dev, "ts_s": (ts_ms // 1000).astype(np.int32),
                    "event_type": kind, "mtype_id": mt,
                    "value": value.astype(np.float32),
                    "payload_ref": np.full(width, -1, np.int32)})
    return out


def an_resolve():
    return {f"m{m}": m for m in range(M_SLOTS)}.__getitem__


class QueryClock:
    """CUDA events and the allocator's peak around each query's share of a
    batch (its operator and its one host copy), on the runner's stream
    where it runs.  Nothing on the CPU."""

    def __init__(self, runner, device):
        import torch

        self.torch = torch
        self.on = device.type == "cuda"
        self.compiled = {n: e.compiled for n, e in runner._queries.items()}
        self.pairs = collections.defaultdict(list)
        self.peak = collections.defaultdict(float)
        self.max_allocated = 0

    def _timed(self, name, fn, staged):
        torch = self.torch
        if not self.on:
            return fn(staged)
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(staged)
        end.record()
        self.pairs[name].append((start, end))
        top = torch.cuda.max_memory_allocated()
        self.peak[name] = max(self.peak[name], top - base)
        self.max_allocated = max(self.max_allocated, top)
        return out

    def __enter__(self):
        for name, c in self.compiled.items():
            c.eval_staged = functools.partial(self._timed, name,
                                              c.eval_staged)
        return self

    def __exit__(self, *exc):
        for c in self.compiled.values():
            del c.eval_staged
        return False

    def ms_per_batch(self, batches):
        if not self.on:
            return None
        self.torch.cuda.synchronize()
        return {k: sum(s.elapsed_time(e) for s, e in v) / batches
                for k, v in self.pairs.items()}


def an_bound_ms(doc, batch):
    """The least card time of one query's batch: the bytes it must move
    over the HBM rate (its columns read once; the state rows of the
    devices it touches read and written once; the matches are a few
    rows).  Its operations (a few compares and adds per row) bound it far
    lower."""
    dev = batch["device_id"]
    n = dev.size
    if doc["kind"] == "window":
        rows = (batch["event_type"] == 0) & (batch["mtype_id"] == 0)
        length = doc.get("length", 1)
        state = 24 + (24 * length if length > 1 else 0)
        cols = 21        # device, time, type, measurement, value, valid
    elif doc["kind"] == "session":
        rows, state, cols = np.ones(n, bool), 12, 9
    else:
        rows, state, cols = np.ones(n, bool), 28, 21
    touched = np.unique(dev[rows]).size
    return (n * cols + 2 * touched * state) / PEAK_HBM_BYTES * 1e3


def analytics_engine_run(device):
    """``analytics_engine``: the ``QueryRunner`` alone at the deployment's
    size, AN_BATCHES full-width batches straight into ``_eval_batch``:
    card ms per batch of each query (CUDA events) beside its HBM bound,
    CEP passes, host copies and the transient peak per batch, the
    operators' state bytes, events/s, and the card's busy share under
    the profiler in AN_PROFILED more batches."""
    import torch

    from sitewhere_tpu_torch.analytics.runner import QueryRunner

    t0 = time.perf_counter()
    runner = QueryRunner(CAPACITY, resolve_mtype=an_resolve(),
                         device=device)
    for doc in AN_QUERIES:
        runner.register(doc)
    batches = an_batches(np.random.default_rng(SEED + 12),
                         1 + AN_BATCHES + AN_PROFILED, FULL_B, 1_700_000_000)
    setup_s = time.perf_counter() - t0
    sync = torch.cuda.synchronize if device.type == "cuda" else (
        lambda: None)
    runner._eval_batch(dict(batches[0]))
    sync()
    entries = runner._queries
    cep = entries["cross-alert"].compiled.evaluator
    copies0 = {n: e.compiled.copies[0] for n, e in entries.items()}
    matches0 = {n: e.counter.value for n, e in entries.items()}
    passes0 = cep.passes
    timed = batches[1:1 + AN_BATCHES]
    with QueryClock(runner, device) as clock:
        t0 = time.perf_counter()
        for b in timed:
            runner._eval_batch(dict(b))
        sync()
        elapsed = time.perf_counter() - t0
    query_ms = clock.ms_per_batch(len(timed))
    nb = len(timed)
    bounds = {d["name"]: sum(an_bound_ms(d, b) for b in timed) / nb
              for d in AN_QUERIES}
    rows = sum(b["device_id"].size for b in timed)
    with _device_profile(device.type == "cuda") as prof:
        t1 = time.perf_counter()
        for b in batches[1 + AN_BATCHES:]:
            runner._eval_batch(dict(b))
        sync()
        prof_s = time.perf_counter() - t1
    dev_ms = _device_ms(prof)
    state_bytes = {n: int(sum(a.nbytes for a in e.compiled.export_state()
                              .values())) for n, e in entries.items()}
    rec = {"phase": "streaming_analytics", "run": "analytics_engine",
           "capacity": CAPACITY, "devices": N_ACTIVE, "width": FULL_B,
           "batches": nb, "batch_span_ms": an_span_ms(),
           "setup_s": setup_s, "elapsed_s": elapsed,
           "engine_events_per_s": rows / elapsed,
           "ms_per_batch": elapsed / nb * 1e3,
           "query_ms_per_batch": query_ms,
           "query_bound_ms": bounds, "bound_by": "bytes",
           "query_bound_share": (None if query_ms is None else {
               n: bounds[n] / ms for n, ms in query_ms.items()}),
           "cep_passes_per_batch": (cep.passes - passes0) / nb,
           "d2h_copies_per_batch": {
               n: (e.compiled.copies[0] - copies0[n]) / nb
               for n, e in entries.items()},
           "transient_peak_mib": ({k: v / 2**20 for k, v in
                                   clock.peak.items()} if clock.on else None),
           "peak_allocated_gib": (clock.max_allocated / 2**30
                                  if clock.on else None),
           "state_bytes": state_bytes,
           "matches": {n: e.counter.value - matches0[n]
                       for n, e in entries.items()},
           "window_occupancy": runner._m_occupancy.value,
           "profiled_batches": AN_PROFILED, "profiled_s": prof_s,
           "device_ms_per_batch": (None if dev_ms is None
                                   else dev_ms / AN_PROFILED),
           "device_busy_share": (None if dev_ms is None
                                 else dev_ms / 1e3 / prof_s),
           "device_ops_per_batch": (None if prof is None
                                    else _device_launches(prof)
                                    / AN_PROFILED)}
    emit(rec)
    # a 120 s-gap session closes only after two minutes of silence, rare
    # in the run's ~3 minutes of event time: its matches come at flush
    check(all(v for n, v in rec["matches"].items() if n != "burst"),
          f"a query never matched in analytics_engine: {rec['matches']}")
    return rec


def analytics_card_vs_cpu(device):
    """AN_CPU_ROWS rows in two batches over AN_CPU_DEVICES devices
    through the four queries on the card and on the port's CPU path: the
    matches (the flush's too) and the exported state bitwise equal."""
    import torch

    from sitewhere_tpu_torch.analytics.query import compile_query, parse_query

    resolve = an_resolve()
    batches = an_batches(np.random.default_rng(SEED + 14), 2, AN_CPU_ROWS,
                         1_700_000_000, devices=AN_CPU_DEVICES)
    out = {}
    for doc in AN_QUERIES:
        runs = []
        for dev in (device, torch.device("cpu")):
            c = compile_query(parse_query(doc, resolve), CAPACITY,
                              resolve_mtype=resolve, device=dev)
            matches = [m.to_dict() for b in batches for m in c.eval_cols(b)]
            state = c.export_state()
            matches += [m.to_dict() for m in c.flush()]
            runs.append((matches, state))
        (gm, gs), (cm, cs) = runs
        unequal = sorted(k for k in gs if gs[k].dtype != cs[k].dtype
                         or gs[k].tobytes() != cs[k].tobytes())
        out[doc["name"]] = {"matches": len(gm), "matches_equal": gm == cm,
                            "unequal_state": unequal}
    emit({"phase": "streaming_analytics", "run": "card_vs_cpu",
          "rows": AN_CPU_ROWS, "batches": 2, "devices": AN_CPU_DEVICES,
          "queries": out})
    for name, r in out.items():
        check(r["matches_equal"] and not r["unequal_state"],
              f"card != CPU for {name}: {r}")
    check(sum(r["matches"] for r in out.values()) > 0,
          "card_vs_cpu: no query matched")


def phase_streaming_analytics(device, geo_cuda):
    """Streaming analytics on the port: ``analytics_engine`` (the runner
    alone at full width), ``card_vs_cpu`` (8192 rows, bitwise), then
    ``analytics_wire``: rules_wire.on's run through the ``Instance`` with
    the four queries registered, on payloads regenerated with this
    phase's event time and 1/8-grid values; every query's live matches
    checked equal to ``run_retrospective`` over the sealed store, and
    checkpoint_full with the ``analytics`` section.  Returns the kernel's
    launches in the wire run, by run name."""
    t0 = time.perf_counter()
    analytics_engine_run(device)
    analytics_card_vs_cpu(device)
    root = tempfile.mkdtemp(prefix="analytics-", dir=geo_cuda.BUILD_DIR)
    launches = {}
    try:
        world = world_checkpoint(device, root, "full")

        def programs(inst):
            return load_rule_programs(
                inst.rule_engine, [inst.identity.tenant.mint("default")],
                (-175, 175, -85, 85), N_ACTIVE, SEED + 11)

        payloads = an_payloads(np.random.default_rng(SEED + 13),
                               WIRE_PAYLOADS, FULL_B, WIRE_TS0_MS)
        rec = persist_throughput(
            device, geo_cuda, world, payloads, root, "analytics",
            rules=programs, phase="streaming_analytics",
            name="analytics_wire", analytics=AN_QUERIES)
        launches["analytics_wire"] = rec["pip_launches"]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "streaming_analytics", "run": "done",
          "seconds": time.perf_counter() - t0})
    return launches


def phase_small_reference(device):
    """A small deployment stepped on the card (kernel) and on the CPU
    (plain versions): int outputs and metrics identical, EWMAs close."""
    import torch

    from sitewhere_tpu_torch.pipeline.packed import (
        pack_batch_host, pack_state, pack_tables, packed_pipeline_step)
    from sitewhere_tpu_torch.schema import DeviceState

    cap, active, width = 8192, 6000, 4096
    world = make_world(device, cap, active, N_RULES, 40, FULL_V, SEED + 3)
    devices = (device, torch.device("cpu"))   # card first, CPU second
    tables = [pack_tables(*(t.to(d) for t in world)) for d in devices]
    carry = [pack_state(DeviceState.empty(cap, M_SLOTS, K_SCALES, device=d))
             for d in devices]
    rng = np.random.default_rng(SEED + 4)
    n_exact = 3 + M_SLOTS
    worst = 0.0
    for step in range(3):
        bi, bf = pack_batch_host(make_batch_cols(
            rng, width, active, cap, 1_700_000_000 + step), width)
        outs = []
        for i, d in enumerate(devices):
            carry[i], oi, met, _ = packed_pipeline_step(
                tables[i], carry[i], torch.from_numpy(bi).to(d),
                torch.from_numpy(bf).to(d))
            outs.append((oi.cpu(), met.cpu()))
        (g_oi, g_met), (c_oi, c_met) = outs
        check(torch.equal(g_oi, c_oi), f"small step {step}: outputs differ")
        check(torch.equal(g_met, c_met), f"small step {step}: metrics differ")
        g, c = carry
        check(torch.equal(g.si.cpu(), c.si), f"small step {step}: int carry")
        check(torch.equal(g.sf[:n_exact].cpu(), c.sf[:n_exact]),
              f"small step {step}: float carry")
        err = (g.sf[n_exact:].cpu().double() - c.sf[n_exact:].double()).abs()
        scale = torch.maximum(c.sf[n_exact:].abs(), torch.tensor(128.0))
        worst = max(worst, float((err / (scale * 2.0 ** -23)).max()))
    check(worst <= 4.0, f"small-step EWMA off by {worst} ULP of scale")
    emit({"phase": "small_reference", "capacity": cap, "width": width,
          "steps": 3, "ewma_max_ulp_of_scale": worst})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is present", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from sitewhere_tpu_torch.device import resolve_device
    from sitewhere_tpu_torch.ops import geo_cuda

    t_start = time.perf_counter()
    device = resolve_device()
    smi = nvidia_smi_line()
    emit({"phase": "card", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    from sitewhere_tpu_torch import native

    t0 = time.perf_counter()
    # the kernel (nvcc) and the wire scanners (cc), built side by side
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        builds = [pool.submit(geo_cuda.library), pool.submit(
            native.load_swwire)]
        for b in builds:
            b.result()
    ptxas = [ln.strip() for ln in geo_cuda.build_log.get("pip_kernel", "")
             .splitlines() if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": ptxas, "native_library": str(native.library_path),
          "native_build_s": native.build_seconds})

    rec = phase_kernel(device, geo_cuda)
    main_launches = phase_main_path(device, geo_cuda)
    wire_launches, mixed, meas = phase_dispatcher_wire(device, geo_cuda)
    persist_launches = phase_persist_recover(device, geo_cuda, mixed, meas)
    del meas
    rules_launches = phase_byo_rules(device, geo_cuda, mixed)
    del mixed
    an_launches = phase_streaming_analytics(device, geo_cuda)
    # this slice's path: the Instance with its segment store, the tenant
    # programs and the four analytics queries, ring off, the deployment's
    # deadline
    rec["launches"] = an_launches["analytics_wire"]
    rec["launches_by_path"] = {"main_path": main_launches,
                               **{f"dispatcher_wire.{k}": v
                                  for k, v in wire_launches.items()},
                               **{f"persist_recover.{k}": v
                                  for k, v in persist_launches.items()},
                               **{f"byo_rules.{k}": v
                                  for k, v in rules_launches.items()},
                               **{f"streaming_analytics.{k}": v
                                  for k, v in an_launches.items()}}
    phase_small_reference(device)

    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    emit({"kernels": [rec]})
    print(nvidia_smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def child_main(spec_json: str) -> int:
    """``--kill-child``: one instance life of the kill_recover runs."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    kill_child(json.loads(spec_json))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--kill-child"]:
        sys.exit(child_main(sys.argv[2]))
    sys.exit(main())
