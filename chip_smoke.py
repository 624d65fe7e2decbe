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
6. a small input run on the card and on the CPU: identical int outputs.

The line before the last is the card's ``nvidia-smi`` name and power
limit; before it, the kernels' JSON record.  The last line is
``{"ok": true, "device": {...}}``.  Without a CUDA card the script exits
non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
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
    rec["launches"] = phase_main_path(device, geo_cuda)
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
