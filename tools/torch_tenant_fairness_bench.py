#!/usr/bin/env python
"""Tenant fairness bench of the PyTorch port: the noisy-neighbour proof.

Counterpart of ``tools/tenant_fairness_bench.py`` over the port
``Instance``.  One adversarial tenant is pinned at about 10x its fair
share of offered load while a fleet of quiet tenants (device counts
Zipf-distributed, O(100k) devices at the full tier) keeps its steady
trickle.  The run drives the whole ladder (DEGRADED admission,
SHEDDING, recovery) on a fake clock, so every token-bucket decision is
deterministic, and checks four isolation invariants:

1. **Fairness floor**: every quiet tenant's contended goodput stays
   within ``--goodput-floor`` (default 90%) of its isolated baseline.
2. **Budget clip**: the noisy tenant is held to its configured
   ``tenants.<token>.overload.*`` budget overlay, its sheds
   dead-lettered under the replayable ``tenant-budget`` kind.
3. **Zero loss**: every offered row is accounted: accepted rows seal,
   refused rows dead-letter with per-class counts, and a post-recovery
   requeue returns budget-shed rows to the pipeline.
4. **Partition isolation**: a registration churn storm in the noisy
   tenant never bumps an untouched tenant's partition
   ``compile_count``.

The ``Instance`` steps on ``--device``: the card by default, where each
step launches the geofence kernel, or the CPU when named.

Usage::

    python tools/torch_tenant_fairness_bench.py [--devices 100000] [--json]
        [--out TENANTFAIR.json] [--device cpu]
    python tools/torch_tenant_fairness_bench.py --smoke --json

Exit status 0 = every check passed.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

# deterministic admission plane: uniform DEGRADED telemetry budget and
# the adversarial tenant's configured overlay (rows/s)
UNIFORM_RATE = 1_000.0
UNIFORM_BURST = 2_000.0
NOISY_RATE = 150.0
NOISY_BURST = 150.0
QUIET_DEMAND = 200.0       # rows/s per quiet tenant (under fair share)
NOISY_DEMAND = 2_000.0     # rows/s — ~10× the noisy tenant's fair cut
DT = 0.05                  # simulated seconds per offered step


class FakeClock:
    def __init__(self, t=1_000.0):
        self.t = t

    def __call__(self):
        return self.t


def _make_instance(data_dir, capacity, device):
    from sitewhere_tpu_torch.instance import Instance
    from sitewhere_tpu_torch.runtime.config import Config

    cfg = Config({
        "instance": {"id": "tenantfair-bench", "data_dir": data_dir},
        "pipeline": {"width": 256, "registry_capacity": capacity,
                     "mtype_slots": 4, "deadline_ms": 2.0, "n_shards": 1},
        "presence": {"scan_interval_s": 3600.0, "missing_after_s": 1800},
        "overload": {
            "enabled": True,
            # the bench FORCES ladder states; a signal-driven transition
            # mid-phase would clear buckets and corrupt the accounting,
            # so the watermarks are parked out of reach and cooldown is
            # effectively infinite under the fake clock
            "cooldown_s": 1e9,
            "sample_interval_s": 1e9,
            "degraded_telemetry_rate_per_s": UNIFORM_RATE,
            "degraded_telemetry_burst": UNIFORM_BURST,
            "budget_refresh_s": 5.0,
            "watermarks": {
                "seal_lag_s": [1e9, 2e9, 3e9],
                "decode_backlog": [1e9, 2e9, 3e9],
                "egress_inflight": [1e9, 2e9, 3e9],
                "batcher_backlog": [1e9, 2e9, 3e9],
                "fsync_latency_s": [1e9, 2e9, 3e9],
            },
        },
        "tenants": {
            "t-noisy": {"overload": {
                "degraded_telemetry_rate_per_s": NOISY_RATE,
                "degraded_telemetry_burst": NOISY_BURST,
            }},
        },
        "metering": {"window_s": 60.0},
        "tracing": {"sample_rate": 0.0},
    }, apply_env=False)
    return Instance(cfg, device=device)


def _zipf_counts(total, n_tenants, s=1.1):
    """Zipf-ish device counts over ``n_tenants`` ranks summing ~total."""
    weights = 1.0 / np.arange(1, n_tenants + 1) ** s
    counts = np.maximum(1, (total * weights / weights.sum()).astype(int))
    counts[0] += total - int(counts.sum())   # remainder to the head
    return counts.tolist()


def _populate(inst, quiet_tokens, noisy_token, total_devices, probes=16):
    """Create tenants + Zipf-distributed devices through their engines.

    Only ``probes`` devices per tenant get assignments (the ingest
    sample); the rest are bare registrations — they exist to give the
    partition ladder its 100k-device tenant column, and assignment-less
    rows never receive traffic.
    """
    tokens = [noisy_token] + quiet_tokens
    counts = _zipf_counts(total_devices, len(tokens))
    fleet = {}
    for tok, count in zip(tokens, counts):
        inst.tenants.create_tenant(token=tok, name=tok,
                                   auth_token=f"{tok}-auth-token-000")
        tdm = inst.engines.get_engine(tok).device_management
        tdm.create_device_type(token=f"{tok}-type", name=f"{tok} sensor")
        for i in range(count):
            tdm.create_device(token=f"{tok}-d{i}",
                              device_type=f"{tok}-type")
        n_probe = min(probes, count)
        for i in range(n_probe):
            tdm.create_device_assignment(device=f"{tok}-d{i}")
        fleet[tok] = {"devices": count, "probes": n_probe}
    return fleet


def _requests(tok, n_probe, rows):
    """A reusable decoded batch of ``rows`` measurement requests cycling
    the tenant's probe devices, tenancy stamped in metadata (the same
    shape a tenant-authenticated source attaches).  The payload is the
    REAL wire NDJSON so a ``tenant-budget`` dead letter of this batch is
    replayable through the recovery decoder."""
    from sitewhere_tpu_torch.ingest.decoders import JsonLinesDecoder

    payload = "\n".join(json.dumps({
        "deviceToken": f"{tok}-d{r % n_probe}", "type": "Measurement",
        "request": {"name": "temp", "value": float(r),
                    "eventDate": 1_753_800_000 + r},
    }) for r in range(rows)).encode()
    reqs = JsonLinesDecoder()(payload)
    for r in reqs:
        r.metadata = dict(r.metadata or {}, tenant=tok)
    return reqs, payload


def _shed_of(inst, tok):
    return inst.metrics.counter(f"tenant.shed.{tok}").value


def _offer_phase(inst, clock, demands, duration_s):
    """Paced fake-clock offering: each simulated ``DT`` tick offers
    ``demand × DT`` rows per tenant through the tenant-attributed scalar
    intake.  Returns per-tenant offered/accepted/shed."""
    from sitewhere_tpu_torch.runtime.overload import OverloadShed

    disp = inst.dispatcher
    batches = {tok: _requests(tok, probes, max(1, int(rate * DT)))
               for tok, (rate, probes) in demands.items()}
    offered = dict.fromkeys(demands, 0)
    shed0 = {tok: _shed_of(inst, tok) for tok in demands}
    steps = int(round(duration_s / DT))
    for _ in range(steps):
        for tok, (reqs, payload) in batches.items():
            offered[tok] += len(reqs)
            try:
                disp.ingest_many(list(reqs), payload, f"src-{tok}")
            except OverloadShed:
                pass
        clock.t += DT
    disp.flush()
    out = {}
    for tok in demands:
        shed = _shed_of(inst, tok) - shed0[tok]
        out[tok] = {"offered": offered[tok], "shed": int(shed),
                    "accepted": offered[tok] - int(shed)}
    return out


def _dead_letter_rows(inst, kinds):
    rows = 0
    by_kind = {}
    for doc in inst.list_dead_letters(limit=100_000):
        kind = doc.get("kind")
        if kind in kinds:
            n = sum(doc.get("classes", {}).values())
            rows += n
            by_kind[kind] = by_kind.get(kind, 0) + n
    return rows, by_kind


def run(total_devices=100_000, n_quiet=8, duration_s=10.0,
        churn_waves=8, goodput_floor=0.9, data_dir=None, tier="full",
        device="cuda"):
    from sitewhere_tpu_torch.device import resolve_device
    from sitewhere_tpu_torch.runtime.overload import OverloadState

    dev = resolve_device(device)

    root = data_dir or tempfile.mkdtemp(prefix="tenantfair-")
    owns_root = data_dir is None
    churn_per_wave = max(64, total_devices // 20)
    capacity = 1 << int(
        total_devices + churn_waves * churn_per_wave + 4096).bit_length()
    inst = _make_instance(os.path.join(root, "data"), capacity, dev)
    t_wall = time.perf_counter()
    inst.start()
    checks = []

    def check(name, ok, detail):
        checks.append({"name": name, "pass": bool(ok), "detail": detail})

    try:
        quiet = [f"t-quiet{i}" for i in range(n_quiet)]
        fleet = _populate(inst, quiet, "t-noisy", total_devices)
        setup_s = time.perf_counter() - t_wall

        # deterministic admission: swap the controller onto a fake
        # clock BEFORE any bucket exists, pin DEGRADED
        clock = FakeClock()
        inst.overload._clock = clock
        inst.overload._buckets.clear()
        inst.overload.force(OverloadState.DEGRADED, "bench")
        quiet_demand = {tok: (QUIET_DEMAND, fleet[tok]["probes"])
                        for tok in quiet}

        # ---- phase 1: isolated baseline — the quiet fleet alone
        baseline = _offer_phase(inst, clock, quiet_demand, duration_s)

        # ---- phase 2: contended — the adversarial tenant joins at
        # ~10× its fair cut; same quiet demand, same duration
        demands = dict(quiet_demand)
        demands["t-noisy"] = (NOISY_DEMAND, fleet["t-noisy"]["probes"])
        contended = _offer_phase(inst, clock, demands, duration_s)

        worst_frac = min(
            (contended[t]["accepted"] / max(1, baseline[t]["accepted"]))
            for t in quiet)
        check("quiet_goodput_floor", worst_frac >= goodput_floor,
              f"worst quiet contended/baseline goodput "
              f"{worst_frac:.3f} (floor {goodput_floor})")
        check("quiet_never_shed",
              all(contended[t]["shed"] == 0 for t in quiet),
              f"quiet sheds: { {t: contended[t]['shed'] for t in quiet} }")

        noisy = contended["t-noisy"]
        budget_ceiling = NOISY_RATE * duration_s + NOISY_BURST
        check("noisy_clipped_to_budget",
              0 < noisy["accepted"] <= budget_ceiling + 1,
              f"noisy accepted {noisy['accepted']} of "
              f"{noisy['offered']} offered "
              f"(budget ceiling {budget_ceiling:.0f})")
        budget_letters = [d for d in inst.list_dead_letters(limit=100_000)
                          if d.get("kind") == "tenant-budget"]
        check("budget_sheds_dead_lettered",
              sum(sum(d["classes"].values()) for d in budget_letters)
              == noisy["shed"]
              and all(d["tenant"] == "t-noisy" and "budget" in d
                      for d in budget_letters),
              f"{len(budget_letters)} tenant-budget letters carry "
              f"{noisy['shed']} shed rows with the clipping budget")

        # ---- phase 3: SHEDDING — telemetry refused wholesale, but the
        # critical class still flows (the ladder's priority floor)
        from sitewhere_tpu_torch.ingest.decoders import DecodedRequest, RequestKind
        from sitewhere_tpu_torch.runtime.overload import OverloadShed

        inst.overload.force(OverloadState.SHEDDING, "bench")
        shedding = _offer_phase(
            inst, clock, {quiet[0]: (QUIET_DEMAND, 1)}, duration_s / 5)
        alert = DecodedRequest(
            kind=RequestKind.ALERT, device_token=f"{quiet[0]}-d0",
            ts_s=1_753_800_000, mtype="overheat", value=1.0,
            metadata={"tenant": quiet[0], "level": "warning",
                      "message": "hot"})
        alert_refused = False
        try:
            inst.dispatcher.ingest_many([alert], b"bench:alert",
                                        "src-alert")
        except OverloadShed:
            alert_refused = True
        check("shedding_refuses_telemetry_not_critical",
              shedding[quiet[0]]["accepted"] == 0 and not alert_refused,
              f"SHEDDING: {shedding[quiet[0]]['shed']} telemetry rows "
              f"refused, critical alert admitted={not alert_refused}")

        # ---- phase 4: recovery + budget-shed replay
        inst.overload.force(OverloadState.NORMAL, "bench")
        recovered = _offer_phase(
            inst, clock, {"t-noisy": (NOISY_DEMAND, 4)}, duration_s / 5)
        requeue = inst.requeue_dead_letter(budget_letters[0]["offset"])
        inst.dispatcher.flush()
        check("recovery_restores_noisy_and_replays_budget_sheds",
              recovered["t-noisy"]["shed"] == 0
              and requeue.get("requeued") is True,
              f"NORMAL: noisy {recovered['t-noisy']['accepted']} rows "
              f"admitted unclipped; tenant-budget requeue returned "
              f"{requeue.get('rows', 0)} rows")

        # ---- phase 5: zero-loss accounting over every phase
        inst.dispatcher.flush()
        inst.event_store.flush()
        offered_total = (
            sum(p[t]["offered"] for p, sel in
                ((baseline, quiet), (contended, list(demands)),
                 (shedding, [quiet[0]]), (recovered, ["t-noisy"]))
                for t in sel) + 1)                      # + the alert
        letter_rows, by_kind = _dead_letter_rows(
            inst, ("tenant-budget", "intake-shed"))
        accepted_total = int(inst.dispatcher.totals["accepted"])
        requeued_rows = int(requeue.get("rows", 0))
        lost = offered_total + requeued_rows - accepted_total - letter_rows
        check("zero_rows_lost", lost == 0,
              f"offered {offered_total} + requeued {requeued_rows} = "
              f"accepted {accepted_total} + dead-lettered {letter_rows} "
              f"(delta {lost})")
        sealed = int(inst.event_store.total_events)
        check("accepted_rows_sealed", sealed == accepted_total,
              f"{sealed} sealed of {accepted_total} accepted")

        # ---- phase 6: churn storm — noisy registers devices in waves;
        # untouched tenants' partition compile_count must stay flat
        parts = inst.device_state.partitions
        parts.refresh()
        tid = {tok: int(inst.identity.tenant.lookup(tok))
               for tok in quiet + ["t-noisy"]}
        before = {tok: parts.compile_count(tid[tok])
                  for tok in quiet + ["t-noisy"]}
        tdm = inst.engines.get_engine("t-noisy").device_management
        base = fleet["t-noisy"]["devices"]
        for wave in range(churn_waves):
            for i in range(churn_per_wave):
                tdm.create_device(
                    token=f"t-noisy-churn{wave}-{i}",
                    device_type="t-noisy-type")
            parts.refresh()
        after = {tok: parts.compile_count(tid[tok])
                 for tok in quiet + ["t-noisy"]}
        check("churn_storm_partition_isolation",
              all(after[t] == before[t] for t in quiet)
              and after["t-noisy"] > before["t-noisy"],
              f"quiet compile_counts flat at "
              f"{ {t: after[t] for t in quiet} }; noisy "
              f"{before['t-noisy']} -> {after['t-noisy']} over "
              f"{churn_waves} waves x {churn_per_wave} devices")
        summary = inst.device_state.tenant_state_summary(tid["t-noisy"])
        check("partition_view_consistent",
              summary["devices"] == base + churn_waves * churn_per_wave
              and summary["capacity"] >= summary["devices"],
              f"noisy partition {summary['devices']} devices on a "
              f"{summary['capacity']}-row rung "
              f"(compile_count {summary['compile_count']})")

        return {
            "tier": tier,
            "device": str(dev),
            "devices": total_devices,
            "registry_capacity": capacity,
            "tenants": {tok: f["devices"] for tok, f in fleet.items()},
            "setup_s": round(setup_s, 2),
            "wall_s": round(time.perf_counter() - t_wall, 2),
            "config": {
                "uniform_rate_per_s": UNIFORM_RATE,
                "uniform_burst": UNIFORM_BURST,
                "noisy_budget_rate_per_s": NOISY_RATE,
                "noisy_budget_burst": NOISY_BURST,
                "quiet_demand_rows_per_s": QUIET_DEMAND,
                "noisy_demand_rows_per_s": NOISY_DEMAND,
                "duration_s": duration_s,
            },
            "phases": {
                "baseline": baseline,
                "contended": contended,
                "shedding": shedding,
                "recovery": recovered,
                "dead_letters": by_kind,
            },
            "checks": checks,
            "ok": all(c["pass"] for c in checks),
        }
    finally:
        inst.stop()
        inst.terminate()
        if owns_root:
            shutil.rmtree(root, ignore_errors=True)


def _render(result) -> str:
    out = [f"tenant_fairness_bench [{result['tier']}]: "
           f"{result['devices']} devices, "
           f"{len(result['tenants'])} tenants, "
           f"wall {result['wall_s']:.1f}s"]
    contended = result["phases"]["contended"]
    for tok in sorted(contended):
        r = contended[tok]
        frac = r["accepted"] / max(1, r["offered"])
        bar = "#" * max(1, int(30 * frac))
        out.append(f"  {tok:>10} {r['accepted']:>7}/{r['offered']:<7} "
                   f"{bar}")
    for c in result["checks"]:
        out.append(f"  [{'PASS' if c['pass'] else 'FAIL'}] "
                   f"{c['name']}: {c['detail']}")
    return "\n".join(out)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="noisy-neighbor isolation proof "
                    "(budgets, quotas, partitions)")
    parser.add_argument("--devices", type=int, default=100_000)
    parser.add_argument("--quiet-tenants", type=int, default=8)
    parser.add_argument("--duration", type=float, default=10.0,
                        help="simulated seconds per offered phase")
    parser.add_argument("--churn-waves", type=int, default=8)
    parser.add_argument("--goodput-floor", type=float, default=0.9)
    parser.add_argument("--smoke", action="store_true",
                        help="small fleet, short phases (tier-1 gate)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("--json", action="store_true")
    parser.add_argument("--out", help="write the JSON result here")
    args = parser.parse_args(argv)
    kw = dict(total_devices=args.devices, n_quiet=args.quiet_tenants,
              duration_s=args.duration, churn_waves=args.churn_waves,
              goodput_floor=args.goodput_floor, tier="full",
              device=args.device)
    if args.smoke:
        kw.update(total_devices=min(args.devices, 2_000), n_quiet=4,
                  duration_s=2.0, churn_waves=4, tier="smoke")
    result = run(**kw)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)
            f.write("\n")
    if args.json:
        print(json.dumps(result, indent=2))
    else:
        print(_render(result))
    if not result["ok"]:
        for c in result["checks"]:
            if not c["pass"]:
                print(f"FAIL: {c['name']}: {c['detail']}",
                      file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
