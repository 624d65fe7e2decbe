#!/usr/bin/env python
"""Rule-program bench of the PyTorch port: the bucketing guarantee and
the hot-swap contract, measured.

Counterpart of ``tools/rulebench.py`` over ``sitewhere_tpu_torch.rules``.
Loads a skewed synthetic population of tenant rule programs (default
100k across ~25k tenants) through the bring-your-own-rules compiler and
reports:

1. **Bucketing**: distinct structure keys and distinct compiled pass
   shapes after loading the whole population (``MAX_STRUCTURE_KEYS``
   bounds them by construction), plus the load and publish wall time.
2. **Eval throughput**: events/s through the group passes (the prepare
   fold and every structure group) against the built-in dense
   ``eval_threshold_rules`` over the same event stream.
3. **Swap under traffic**: per-batch eval latency while a random
   program's constants republish every few batches; p50/p99 of the swap
   batches against the quiet ones, and the compiled-pass count, which
   must stay flat across every swap (operand swaps never recompile).

The passes run on ``--device``: the card by default, the CPU when named.

Usage::

    python tools/torch_rulebench.py [--programs 100000] [--tenants 25000]
                                    [--devices 4096] [--events 100000]
                                    [--batch 4096] [--smoke] [--json]
                                    [--device cpu]

Exit status is always 0 (a reporting tool).
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

_POLY = [[0.0, 0.0], [10.0, 0.0], [10.0, 10.0], [0.0, 10.0]]


def _program_doc(rng, idx: int) -> dict:
    """One synthetic program, drawn from a skewed structure mix.

    The mix is deliberately lopsided — most tenants write simple
    threshold specs — and most of the *spelling* diversity (thresholds,
    ops, windows, polygons) is operand diversity, which must collapse
    into the same handful of structure keys."""
    token = f"p{idx}"
    thr = float(rng.uniform(10.0, 90.0))
    op = str(rng.choice(["gt", "lt", "gte", "lte"]))
    level = str(rng.choice(["info", "warning", "error", "critical"]))
    alert = {"type": f"byo.kind{int(rng.integers(0, 16))}",
             "level": level}
    shape = rng.random()
    if shape < 0.55:
        # simple threshold (the common tenant)
        when = {"pred": "value", "op": op, "value": thr}
    elif shape < 0.70:
        # trailing trend: ewma + rate in one clause
        when = {"all": [
            {"pred": "ewma", "op": op, "value": thr,
             "window_s": float(rng.choice([60, 600, 3600]))},
            {"pred": "rate", "op": "gt",
             "value": float(rng.uniform(0.1, 5.0))}]}
    elif shape < 0.82:
        # multi-clause disjunction
        when = {"any": [
            {"pred": "value", "op": "gt", "value": thr},
            {"pred": "value", "op": "lt", "value": thr - 30.0},
            {"all": [{"pred": "rate", "op": "gt", "value": 1.0},
                     {"pred": "value", "op": "gt", "value": thr - 10.0}]}]}
    elif shape < 0.90:
        # geofence containment
        jx, jy = rng.uniform(-2, 2, 2)
        poly = [[x + jx, y + jy] for x, y in _POLY]
        when = {"pred": "geo", "polygon": poly,
                "inside": bool(rng.random() < 0.5)}
    elif shape < 0.95:
        # wide conjunction with metadata joins (c4p8 bucket)
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
        # geo + float lanes combined
        when = {"any": [
            {"all": [{"pred": "geo", "polygon": _POLY, "inside": True},
                     {"pred": "value", "op": "gt", "value": thr}]},
            {"all": [{"pred": "rate", "op": "gt", "value": 2.0}]},
            {"all": [{"pred": "value", "op": "lt", "value": 2.0}]}]}
    return {"token": token, "name": f"bench-{idx}", "alert": alert,
            "when": when}


def _stream(rng, n_events, n_devices, n_tenants, batch):
    """Synthetic telemetry batches (measurements + some locations)."""
    from sitewhere_tpu_torch.schema import EventType

    out = []
    t0 = 1_753_800_000
    for lo in range(0, n_events, batch):
        n = min(batch, n_events - lo)
        et = np.where(rng.random(n) < 0.9,
                      int(EventType.MEASUREMENT),
                      int(EventType.LOCATION)).astype(np.int32)
        out.append({
            "device_id": rng.integers(0, n_devices, n).astype(np.int32),
            "tenant_id": rng.integers(0, n_tenants, n).astype(np.int32),
            "event_type": et,
            "mtype_id": rng.integers(0, 4, n).astype(np.int32),
            "value": rng.uniform(0.0, 100.0, n).astype(np.float32),
            "lon": rng.uniform(-5.0, 15.0, n).astype(np.float32),
            "lat": rng.uniform(-5.0, 15.0, n).astype(np.float32),
            "ts_s": (t0 + lo + np.arange(n)).astype(np.int32),
            "ts_ns": np.zeros(n, np.int32),
            "asset_id": np.full(n, -1, np.int32),
        })
    return out


def run(n_programs: int = 100_000, n_tenants: int = 25_000,
        n_devices: int = 4096, n_events: int = 100_000,
        batch: int = 4096, swap_every: int = 8, seed: int = 11,
        device="cuda"):
    """The bench's result dict (the reference's keys); the passes run on
    ``device``, the card unless ``"cpu"`` is named."""
    from sitewhere_tpu_torch.device import resolve_device
    from sitewhere_tpu_torch.rules import compile as rcompile
    from sitewhere_tpu_torch.rules.dsl import MAX_STRUCTURE_KEYS
    from sitewhere_tpu_torch.rules.engine import RuleEngineRunner

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    result = {"device": str(dev), "programs": n_programs, "tenants": n_tenants,
              "devices": n_devices, "events": n_events, "batch": batch,
              "max_structure_keys": MAX_STRUCTURE_KEYS}

    rcompile.reset_trace_cache()
    eng = RuleEngineRunner(
        capacity=n_devices, n_mtype_slots=4,
        # the population is uniform over tenants, so per-tenant-per-
        # structure collisions follow a birthday bound; 8 slots holds
        # 100k over 25k tenants comfortably
        programs_per_tenant=8, max_programs=max(n_programs, 1024),
        queue_depth=4, device=dev)
    alerts = [0]
    eng.inject = lambda cols: alerts.__setitem__(
        0, alerts[0] + len(cols["device_id"]))

    # ---- 1. load + publish + warm (compile) time
    t0 = time.perf_counter()
    loaded = 0
    for i in range(n_programs):
        doc = _program_doc(rng, i)
        tenant = int(rng.integers(0, n_tenants))
        try:
            eng.registry.put_program(tenant, doc)
            loaded += 1
        except Exception:
            # per-tenant structure-slot collision in the random draw —
            # counted, not fatal (real tenants hit a 400 at POST)
            pass
    t_put = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng.refresh()  # single publish: builds every group + warms kernels
    t_publish = time.perf_counter() - t0
    result["programs_loaded"] = loaded
    result["programs_rejected"] = n_programs - loaded
    result["structure_keys"] = eng.registry.structure_keys()
    result["compiled_shapes"] = rcompile.structure_keys_compiled()
    result["load_s"] = round(t_put, 3)
    result["publish_and_warm_s"] = round(t_publish, 3)
    result["shapes_within_bound"] = (
        result["compiled_shapes"] <= MAX_STRUCTURE_KEYS)

    # ---- 2. eval throughput: compiled groups vs built-in dense table
    batches = _stream(rng, n_events, n_devices, n_tenants, batch)
    eng._eval_batch(dict(batches[0]))  # warm the batch width
    t0 = time.perf_counter()
    for b in batches:
        eng._eval_batch(dict(b))
    dt = time.perf_counter() - t0
    result["eval_events_per_s"] = round(n_events / dt, 1)
    result["alerts_fired"] = alerts[0]
    result["builtin_events_per_s"] = _builtin_throughput(
        batches, n_devices, dev)
    result["relative_cost"] = round(
        result["builtin_events_per_s"]
        / max(result["eval_events_per_s"], 1e-9), 2)

    # ---- 3. swap under traffic: operand republish must not recompile
    quiet: list = []
    swap_lat: list = []
    executables_before = rcompile.compile_count()
    swaps_before = eng.registry.swaps
    for i, b in enumerate(batches):
        if i and i % swap_every == 0:
            # operand-only mutation: same token, same structure, new
            # constants — the hot-swap the zero-stall contract covers
            idx = int(rng.integers(0, n_programs))
            doc = _program_doc(np.random.default_rng(seed + idx), idx)
            tenant = int(rng.integers(0, n_tenants))
            try:
                eng.put_program(tenant, doc)
            except Exception:
                pass
        t0 = time.perf_counter()
        eng._eval_batch(dict(b))
        (swap_lat if i % swap_every == 0 and i else quiet).append(
            time.perf_counter() - t0)
    result["swaps_applied"] = eng.registry.swaps - swaps_before
    result["recompiles_during_swaps"] = (
        rcompile.compile_count() - executables_before)
    if quiet:
        result["quiet_p50_ms"] = round(
            float(np.percentile(quiet, 50)) * 1e3, 3)
        result["quiet_p99_ms"] = round(
            float(np.percentile(quiet, 99)) * 1e3, 3)
    if swap_lat:
        result["swap_p50_ms"] = round(
            float(np.percentile(swap_lat, 50)) * 1e3, 3)
        result["swap_p99_ms"] = round(
            float(np.percentile(swap_lat, 99)) * 1e3, 3)
    return result


def _builtin_throughput(batches, n_devices: int, device) -> float:
    """The fixed-function comparison: the dense [B, R] built-in
    threshold rules over the same stream (1024 rules)."""
    import torch

    from sitewhere_tpu_torch.ids import NULL_ID
    from sitewhere_tpu_torch.pipeline.step import eval_threshold_rules
    from sitewhere_tpu_torch.schema import (
        DeviceState,
        EventBatch,
        RuleKind,
        RuleTable,
    )

    R = 1024
    rng = np.random.default_rng(3)
    rules = RuleTable.empty(R, device=device)
    rules = RuleTable(
        active=torch.ones(R, dtype=torch.bool, device=device),
        tenant_id=torch.full((R,), NULL_ID, dtype=torch.int32,
                             device=device),
        mtype_id=torch.full((R,), NULL_ID, dtype=torch.int32,
                            device=device),
        op=torch.from_numpy(rng.integers(0, 4, R).astype(np.int32)).to(
            device),
        threshold=torch.from_numpy(
            rng.uniform(10, 90, R).astype(np.float32)).to(device),
        alert_code=torch.arange(R, dtype=torch.int32, device=device),
        alert_level=torch.ones(R, dtype=torch.int32, device=device),
        kind=torch.full((R,), int(RuleKind.INSTANT), dtype=torch.int32,
                        device=device),
        window_idx=torch.zeros(R, dtype=torch.int32, device=device),
        ewma_tau_s=rules.ewma_tau_s,
    )
    state = DeviceState.empty(n_devices, num_mtype_slots=4, device=device)

    def to_batch(cols):
        n = len(cols["device_id"])
        eb = EventBatch.empty(n, device=device)
        return eb.replace(
            valid=torch.ones(n, dtype=torch.bool, device=device),
            **{k: torch.from_numpy(np.ascontiguousarray(cols[k])).to(device)
               for k in ("device_id", "tenant_id", "event_type",
                         "mtype_id", "value", "ts_s", "ts_ns")})

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    eb = to_batch(batches[0])
    acc = torch.ones(len(batches[0]["device_id"]), dtype=torch.bool,
                     device=device)
    eval_threshold_rules(rules, state, eb, acc)  # warm
    sync()
    n_events = sum(len(b["device_id"]) for b in batches)
    t0 = time.perf_counter()
    for b in batches:
        eb = to_batch(b)
        acc = torch.ones(len(b["device_id"]), dtype=torch.bool,
                         device=device)
        eval_threshold_rules(rules, state, eb, acc)
    sync()
    return round(n_events / (time.perf_counter() - t0), 1)


def _render(r) -> str:
    lines = [
        f"rule-program bench — {r['programs_loaded']} programs, "
        f"{r['tenants']} tenants, {r['events']} events, "
        f"batch {r['batch']}",
        f"  structure keys   : {len(r['structure_keys'])} "
        f"({', '.join(r['structure_keys'])})",
        f"  compiled shapes  : {r['compiled_shapes']} "
        f"(bound {r['max_structure_keys']}; "
        f"{'OK' if r['shapes_within_bound'] else 'EXCEEDED'})",
        f"  load / publish   : {r['load_s']:.2f} s / "
        f"{r['publish_and_warm_s']:.2f} s",
        f"  compiled eval    : {r['eval_events_per_s']:>12,.0f} ev/s "
        f"({r['alerts_fired']} alerts)",
        f"  built-in table   : {r['builtin_events_per_s']:>12,.0f} ev/s "
        f"({r['relative_cost']}x)",
        f"  swap under load  : {r['swaps_applied']} swaps, "
        f"{r['recompiles_during_swaps']} recompiles",
    ]
    if "swap_p99_ms" in r:
        lines.append(
            f"  eval latency     : quiet p50/p99 "
            f"{r.get('quiet_p50_ms', 0)}/{r.get('quiet_p99_ms', 0)} ms, "
            f"swap-batch p50/p99 "
            f"{r['swap_p50_ms']}/{r['swap_p99_ms']} ms")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--programs", type=int, default=100_000)
    ap.add_argument("--tenants", type=int, default=25_000)
    ap.add_argument("--devices", type=int, default=4096)
    ap.add_argument("--events", type=int, default=100_000)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--swap-every", type=int, default=8)
    ap.add_argument("--smoke", action="store_true",
                    help="small population (tier-1 CI sizing)")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    if args.smoke:
        result = run(n_programs=512, n_tenants=64, n_devices=256,
                     n_events=8192, batch=1024, swap_every=4,
                     device=args.device)
    else:
        result = run(args.programs, args.tenants, args.devices,
                     args.events, args.batch, args.swap_every,
                     device=args.device)
    if args.json:
        print(json.dumps(result, indent=2))
    else:
        print(_render(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
