#!/usr/bin/env python3
"""Drive the PyTorch port (``sitewhere_tpu_torch``) on one CUDA card.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, each printing one JSON line; any failed check raises and the
script exits non-zero without printing a result:

1. the card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build the geofence kernel (``csrc/pip_kernel.cu``) with ``nvcc``;
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
   NDJSON bytes -> journal -> columnar decode -> batcher -> step -> egress
   -> offset commit.  Full-width payloads (131072 lines, 60/30/10
   measurements/locations/alerts), 3 rings' worth, at the deployment's
   5 ms batcher deadline with the ring at K=8 and with it off: events/s,
   latency per plan from the payload's receipt (before its decode) to
   egress, p50 and max, host ms per stage, host syncs per batch, and the
   summed CUDA-event span of the card's steps.  Then a diagnostic run
   with a 60 s deadline, where the ring forms, and a paced region at
   width 4096 (deadline 3.5 ms, 50% of the measured capacity, latency
   from each payload's scheduled arrival).  Checks: kernel launches ==
   dispatcher steps, accepted rows == valid registered rows, committed
   offset == journal records; in the diagnostic run, host syncs per batch
   == 1/8 over the ring's steps and the last dispatched ring rerun with
   the plain geofence from its carry, bitwise;
7. a small input run on the card and on the CPU: identical int outputs.

The line before the last is the card's ``nvidia-smi`` name and power
limit; before it, the kernels' JSON record.  The last line is
``{"ok": true, "device": {...}}``.  Without a CUDA card the script exits
non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import shutil
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
# one deadline at most, and at the pure-Python decode's pace K payloads
# take seconds, so at this deadline every ring drains single-step.
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
    import torch

    from sitewhere_tpu_torch.ids import IdentityMap
    from sitewhere_tpu_torch.pipeline.rules import RuleManager
    from sitewhere_tpu_torch.schema import (
        AssignmentStatus, ComparisonOp, RuleKind, ZoneCondition)
    from sitewhere_tpu_torch.services.device_management import (
        RegistryMirror)

    identity = IdentityMap()
    identity.tenant.mint("default")
    for m in range(M_SLOTS):
        identity.mtype.mint(f"m{m}")
    mirror = RegistryMirror(CAPACITY, max_zones=FULL_Z, max_verts=FULL_V,
                            device=device)
    active = int(AssignmentStatus.ACTIVE)
    for i in range(N_ACTIVE):
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
    rules = RuleManager(identity, capacity=N_RULES, device=device)
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
    return identity, mirror, rules


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


def wire_throughput(device, geo_cuda, world, payloads, ring_depth,
                    deadline_ms, root, run, profile=False):
    """ingest_wire_lines over every payload, then flush(), timed from the
    first byte to the flush's return.  With ``deadline_ms`` at
    RING_DIAG_DEADLINE_MS the ring forms: its sync count is read once the
    ring's plans have egressed, before the flush's partial, and the last
    dispatched ring is rerun with the plain geofence.  ``profile`` runs
    the region under the profiler (its numbers then carry its cost)."""
    import torch

    from sitewhere_tpu_torch.pipeline.packed import build_packed_chain

    diag = deadline_ms == RING_DIAG_DEADLINE_MS
    disp = make_wire_dispatcher(device, world, FULL_B, ring_depth,
                                deadline_ms, os.path.join(root, "j"))
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
        committed = disp.journal_reader.committed
        records = disp.journal.end_offset
        latency = _latency(disp, "max")
        span_ms = spans.total_ms()
    finally:
        disp.stop()
        disp.journal.close()
    delta = {k: snap[k] - snap0[k] for k in (
        "steps", "host_syncs", "ring_chains", "ring_flushed_plans",
        "processed", "accepted", "unregistered", "derived_alerts")}
    lines = sum(p.count(b"\n") + 1 for p, _ in payloads)
    registered = sum(r for _, r in payloads)
    ring_steps = mid["steps"] - snap0["steps"]
    ring_syncs = mid["host_syncs"] - snap0["host_syncs"]
    rec = {"phase": "dispatcher_wire", "run": run,
           "ring_depth": ring_depth, "deadline_ms": deadline_ms,
           "payloads": len(payloads), "lines": lines, "elapsed_s": elapsed,
           "events_per_s": lines / elapsed,
           "rows_per_s_with_derived": delta["processed"] / elapsed,
           **latency, "stage_ms": stage_ms,
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


def phase_dispatcher_wire(device, geo_cuda):
    """The wire path through the port's dispatcher; returns the kernel's
    launches in each throughput run, by run name."""
    t0 = time.perf_counter()
    world = make_wire_world(device)
    rng = np.random.default_rng(SEED + 6)
    payloads = wire_payloads(rng, WIRE_PAYLOADS, FULL_B, WIRE_TS0_MS)
    paced = wire_payloads(rng, PACED_PAYLOADS + PACED_BURST, PACED_LINES,
                          WIRE_TS0_MS + 10_000_000)
    emit({"phase": "dispatcher_wire", "run": "setup", "capacity": CAPACITY,
          "active": N_ACTIVE, "rules": N_RULES, "zones": FULL_Z,
          "verts": FULL_V, "width": FULL_B,
          "setup_s": time.perf_counter() - t0})
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
        wire_paced(device, world, paced, os.path.join(root, "paced"))
        # the card's busy time, measured apart from the timed regions
        wire_throughput(device, geo_cuda, world,
                        payloads[:PROFILED_PAYLOADS], 0, WIRE_DEADLINE_MS,
                        os.path.join(root, "prof"), "profiled_ring0",
                        profile=True)
        wire_paced(device, world, paced[:PACED_BURST + PROFILED_PACED],
                   os.path.join(root, "prof_paced"), "profiled_paced_ring0",
                   profile=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "dispatcher_wire", "run": "done",
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

    t0 = time.perf_counter()
    geo_cuda.library()
    ptxas = [ln.strip() for ln in geo_cuda.build_log.get("pip_kernel", "")
             .splitlines() if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": ptxas})

    rec = phase_kernel(device, geo_cuda)
    main_launches = phase_main_path(device, geo_cuda)
    wire_launches = phase_dispatcher_wire(device, geo_cuda)
    # the port's default configuration: ring off, the deployment's deadline
    rec["launches"] = wire_launches["throughput_ring0"]
    rec["launches_by_path"] = {"main_path": main_launches,
                               **{f"dispatcher_wire.{k}": v
                                  for k, v in wire_launches.items()}}
    phase_small_reference(device)

    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    emit({"kernels": [rec]})
    print(nvidia_smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
