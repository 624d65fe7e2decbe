#!/usr/bin/env python
"""Chaos smoke of the PyTorch port: boot an instance under random seeded
faults, check a clean recovery.

Counterpart of ``tools/chaos_smoke.py`` over the port ``Instance``.
Arms a random (but seed-reproducible) subset of the pipeline's fault
injection points (``sitewhere_tpu_torch/runtime/faults.py``), drives wire
traffic through a real instance, then clears the faults, replays the
journal past the committed offset as a crash would, and checks the
at-least-once contract: every journaled row is in the event store
afterwards, and the resilience counters surfaced.  Then: the overload
ladder sheds telemetry and never alerts; device faults mid-storm are
contained with no row lost; a reboot and a kill-restart come back clean;
and the two-host phase: a SHEDDING peer parks the forward spool (paced
probes, no dead letter), the edge refuses with the owner's hint, and
recovery drains the spool to zero.

Every ``Instance`` steps on ``--device``: the card by default, where each
step launches the geofence kernel, or the CPU when named.

Usage::

    python tools/torch_chaos_smoke.py [seed] [--device cpu] [--json OUT]

Exit status 0 = clean recovery; any loss or a boot abort is fatal.
Re-running with the printed seed reproduces the exact fault schedule.
"""

import argparse
import json
import os
import random
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sitewhere_tpu_torch.runtime import faults  # noqa: E402

# Points on the wire → journal → step → store path.  Probabilistic and
# permanent-until-cleared: the run is a storm, recovery happens after.
FAULT_CATALOG = [
    ("dispatcher.step", 0.3),
    ("dispatcher.egress", 0.3),
    # the segment store's background seal workers (store/sealer.py);
    # event_store.flush is the legacy single-writer point, kept for
    # stores still on the base EventStore
    ("event_store.seal", 0.5),
    ("event_store.flush", 0.5),
]

N_PAYLOADS = 40
ROWS_PER_PAYLOAD = 8


def _line(token, value, ts):
    return json.dumps({
        "deviceToken": token, "type": "Measurement",
        "request": {"name": "temp", "value": value, "eventDate": ts},
    })


def _make_instance(data_dir, device):
    from sitewhere_tpu_torch.instance import Instance
    from sitewhere_tpu_torch.runtime.config import Config

    cfg = Config({
        "instance": {"id": "chaos-smoke", "data_dir": data_dir},
        "pipeline": {"width": 64, "registry_capacity": 256,
                     "mtype_slots": 4, "deadline_ms": 5.0, "n_shards": 1},
        "presence": {"scan_interval_s": 3600.0, "missing_after_s": 1800},
    }, apply_env=False)
    return Instance(cfg, device=device)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="seeded faults, a restart, the at-least-once check")
    parser.add_argument("seed", nargs="?", type=int, default=None)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("--json", dest="json_out",
                        help="also write the report here")
    args = parser.parse_args(argv)

    from sitewhere_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    seed = (args.seed if args.seed is not None
            else random.SystemRandom().randrange(1 << 30))
    rng = random.Random(seed)
    armed = [(point, p) for point, p in FAULT_CATALOG if rng.random() < 0.8]
    print(f"chaos_smoke: seed={seed} armed={[p for p, _ in armed]}")

    root = tempfile.mkdtemp(prefix="chaos-smoke-")
    data_dir = os.path.join(root, "data")
    failures = []
    try:
        inst = _make_instance(data_dir, device)
        inst.start()
        dm = inst.device_management
        dm.create_device_type(token="sensor", name="Sensor")
        for i in range(8):
            dm.create_device(token=f"d-{i}", device_type="sensor")
            dm.create_device_assignment(device=f"d-{i}")

        # -- the storm ----------------------------------------------------
        for point, prob in armed:
            faults.inject(point, exc=OSError(f"chaos {point}"),
                          times=None, probability=prob,
                          seed=rng.randrange(1 << 30))
        ingested = 0
        for k in range(N_PAYLOADS):
            lines = [
                _line(f"d-{(k + r) % 8}", float(k),
                      1_753_800_000 + k * ROWS_PER_PAYLOAD + r)
                for r in range(ROWS_PER_PAYLOAD)
            ]
            payload = "\n".join(lines).encode()
            try:
                inst.dispatcher.ingest_wire_lines(payload)
                ingested += ROWS_PER_PAYLOAD
            except Exception:
                # the payload is journaled before the plan runs: a
                # mid-step fault loses nothing durable
                ingested += ROWS_PER_PAYLOAD
        time.sleep(0.1)  # let the deadline loop chew (and crash) freely
        fault_hits = {p: faults.fired(p) for p, _ in armed}

        # -- recovery -----------------------------------------------------
        faults.clear()
        # crash analog: in-memory outstanding-plan state dies with the
        # process; the journal (committed offset) is the durable truth
        with inst.dispatcher._lock:
            inst.dispatcher._plans_outstanding = 0
            inst.dispatcher._inflight.clear()
        inst.dispatcher.replay_journal()
        inst.dispatcher.flush()
        inst.event_store.flush()

        stored = inst.event_store.total_events
        dead = inst.dead_letters.end_offset
        resilience = inst.topology().get("resilience", {})
        # the overload controller may legitimately shed telemetry DURING
        # the fault storm (seal lag spikes are exactly its signal); shed
        # rows are dead-lettered at intake, not journaled — they are
        # audited, not lost
        storm_sheds = (inst.overload.shed_total
                       if inst.overload is not None else 0)
        if stored + storm_sheds < ingested:
            # at-least-once: replay may duplicate, must never lose
            failures.append(
                f"event loss: ingested {ingested}, stored {stored}, "
                f"shed (audited) {storm_sheds}")
        if fault_hits.get("event_store.flush") and not resilience.get(
                "resilience.retries.event_store.seal"):
            # seal failures route through the shared retry primitive —
            # its counter must reach the topology surface
            failures.append("seal faults fired but the retry counter "
                            "never reached the topology surface")
        # -- overload: the ladder sheds telemetry, never alerts -----------
        from sitewhere_tpu_torch.runtime.overload import (
            OverloadShed,
            OverloadState,
        )

        overload_report = {}
        if inst.overload is not None:
            inst.overload.force(OverloadState.SHEDDING, reason="chaos")
            telemetry = _line("d-0", 1.0, 1_753_900_000).encode()
            alert = json.dumps({
                "deviceToken": "d-0", "type": "Alert",
                "request": {"type": "overheat", "level": "warning",
                            "eventDate": 1_753_900_001}}).encode()
            shed_signalled = False
            try:
                inst.dispatcher.ingest_wire_lines(telemetry, "chaos-smoke")
            except OverloadShed:
                shed_signalled = True
            if not shed_signalled:
                failures.append("SHEDDING did not shed telemetry intake")
            alert_rows = inst.dispatcher.ingest_wire_lines(
                alert, "chaos-smoke")
            if alert_rows != 1:
                failures.append("alert-class intake was shed (never "
                                "allowed, in any overload state)")
            shed_letters = [
                d for d in inst.list_dead_letters(limit=50)
                if d.get("kind") == "intake-shed"
            ]
            if not shed_letters:
                failures.append("shed intake was not dead-lettered")
            inst.overload.force(OverloadState.NORMAL, reason="chaos-done")
            inst.dispatcher.flush()
            inst.event_store.flush()
            stored = inst.event_store.total_events  # alert row sealed too
            ingested += 1
            overload_report = inst.overload.snapshot()

        # -- device-fault phase: mid-storm device faults are
        # CONTAINED — faulted dispatches retry/bisect with zero row
        # loss, and a NaN row is masked + counted on the device's
        # packed telemetry instead of corrupting state
        faults.device_inject("device.dispatch", exc=OSError("dead chip"),
                             times=2, seed=rng.randrange(1 << 30))
        dev_rows = 0
        for k in range(6):
            lines = [
                _line(f"d-{(k + r) % 8}",
                      float("nan") if k == 3 and r == 0 else float(k),
                      1_754_000_000 + k * ROWS_PER_PAYLOAD + r)
                for r in range(ROWS_PER_PAYLOAD)
            ]
            inst.dispatcher.ingest_wire_lines("\n".join(lines).encode())
            dev_rows += ROWS_PER_PAYLOAD
        inst.dispatcher.flush()
        faults.device_clear()
        inst.event_store.flush()
        dev_after = inst.event_store.total_events
        counters = inst.metrics.snapshot()["counters"]
        dev_faults = (int(counters.get("device.fault.step_faults", 0))
                      + int(counters.get("device.fault.chain_faults", 0)))
        if dev_faults < 1:
            failures.append("device faults armed but the containment "
                            "path never counted one")
        if dev_after - stored < dev_rows:
            failures.append(
                f"device-fault containment lost rows: {dev_rows} "
                f"ingested, {dev_after - stored} stored")
        if int(counters.get("pipeline.quarantine.rows_nonfinite", 0)) < 1:
            failures.append("a NaN row never reached the device-counted "
                            "nonfinite telemetry")
        stored = dev_after
        ingested += dev_rows
        device_report = {
            "rows": dev_rows,
            "step_faults": dev_faults,
            "rows_nonfinite": int(counters.get(
                "pipeline.quarantine.rows_nonfinite", 0)),
            "breaker": inst.dispatcher.breaker.snapshot(),
        }

        inst.stop()
        inst.terminate()

        # -- reboot: the store + journal must come back clean -------------
        inst2 = _make_instance(data_dir, device)
        inst2.start()
        restored = inst2.event_store.total_events
        if restored < stored - inst2.event_store.sealed_dead_lettered:
            failures.append(
                f"restart lost events: {stored} before, {restored} after")

        # -- kill-restart phase: journal records that never
        # reach the pipeline (the crash window between Journal.append
        # and egress), kill without stop, and prove the next boot
        # restores the checkpoint + replays them with measured RTO
        crash_rows = 3
        for r in range(crash_rows):
            inst2.ingest_journal.append(
                _line(f"d-{r}", 77.0, 1_753_950_000 + r).encode())
        inst2.ingest_journal.close()
        inst2.dead_letters.close()
        del inst2  # simulated SIGKILL — no stop, no final checkpoint

        inst3 = _make_instance(data_dir, device)
        if not inst3.restored:
            failures.append("kill-restart: checkpoint did not restore")
        inst3.start()  # restore ran in __init__; start replays
        inst3.dispatcher.flush()
        inst3.event_store.flush()
        gauges = inst3.metrics.snapshot()["gauges"]
        replayed = int(gauges.get("recovery.replay_events", 0))
        if replayed < crash_rows:
            failures.append(
                f"kill-restart: expected >= {crash_rows} replayed "
                f"events, recovery.replay_events={replayed}")
        if not gauges.get("recovery.restore_s", 0.0) > 0:
            failures.append(
                "kill-restart: recovery.restore_s gauge missing/zero")
        after_kill = inst3.event_store.total_events
        if after_kill < restored + crash_rows:
            failures.append(
                f"kill-restart lost events: {restored}+{crash_rows} "
                f"journaled, {after_kill} stored")
        recovery_report = {
            "replayed": replayed,
            "restore_s": round(float(gauges.get("recovery.restore_s",
                                                0.0)), 4),
            "replay_s": round(float(gauges.get("recovery.replay_s",
                                               0.0)), 4),
        }
        inst3.stop()
        inst3.terminate()

        # -- fleet phase: a SHEDDING peer must park the
        # forward spool (paced probes, zero dead letters), the edge
        # must refuse with the OWNER's hint, and recovery must drain
        # the spool to zero
        from sitewhere_tpu_torch.rpc import (
            HostForwarder,
            RpcDemux,
            RpcServer,
            bind_instance,
        )
        from sitewhere_tpu_torch.rpc.forward import owning_process

        peer = _make_instance(os.path.join(root, "peer"), device)
        peer.start()
        peer.device_management.create_device_type(token="sensor", name="S")
        tok = next(f"p-{i}" for i in range(100)
                   if owning_process(f"p-{i}", 2) == 1)
        peer.device_management.create_device(token=tok,
                                             device_type="sensor")
        peer.device_management.create_device_assignment(device=tok)
        srv = RpcServer(port=0, tokens=peer.tokens)
        bind_instance(srv, peer)
        srv.overload_provider = lambda: (int(peer.overload.state),
                                         peer.overload.retry_after())
        srv.start()
        jwt = peer.tokens.mint("system", ["ROLE_ADMIN"])
        demux = RpcDemux([srv.endpoint], token_provider=lambda: jwt)
        fwd = HostForwarder(None, 0, {0: None, 1: demux},
                            data_dir=os.path.join(root, "fwd-spool"),
                            max_retries=1, heartbeat_interval_s=0)
        fwd.start()
        fleet_report = {}
        try:
            line = _line(tok, 5.0, 1_753_960_000).encode()
            peer.overload.force(OverloadState.SHEDDING, reason="chaos-fleet")
            # rows sent into a shedding owner park in the spool (the
            # first delivery learns the state off the refusal's
            # piggyback headers) — never a dead letter
            fwd.ingest_payload(line)
            fwd.flush(wait=True)
            if fwd.dead_lettered:
                failures.append("fleet: rows for a SHEDDING owner were "
                                "dead-lettered instead of retained")
            if fwd.pending_rows() != 1:
                failures.append("fleet: shed rows not retained in spool")
            # a paced-probe window must stay bounded: hammer flushes
            attempts0 = int(fwd._m_attempts.value)
            for _ in range(25):
                fwd.flush(wait=True)
            storm = int(fwd._m_attempts.value) - attempts0
            fleet_report["parked_window_attempts"] = storm
            if storm > 3:
                failures.append(
                    f"fleet: {storm} send attempts while parked — "
                    "retry storm, probes not paced")
            # the device-facing edge refuses with the owner's hint
            try:
                fwd.ingest_payload(_line(tok, 6.0, 1_753_960_001).encode())
                failures.append("fleet: edge accepted a payload for a "
                                "SHEDDING owner without backpressure")
            except OverloadShed as e:
                fleet_report["edge_retry_after_s"] = e.retry_after_s
            # recovery: probes redeliver, the spool drains to zero
            peer.overload.force(OverloadState.NORMAL, reason="chaos-done")
            deadline = time.monotonic() + 20
            while time.monotonic() < deadline and fwd.pending_rows():
                fwd.flush(wait=True)
                time.sleep(0.2)
            fleet_report["pending_after_recovery"] = fwd.pending_rows()
            if fwd.pending_rows():
                failures.append("fleet: spool did not drain on recovery")
            if fwd.dead_lettered:
                failures.append("fleet: recovery dead-lettered rows")
            fleet_report["peer_health"] = fwd.health.snapshot().get("1")
        finally:
            fwd.stop()
            demux.close()
            srv.stop()
            peer.stop()
            peer.terminate()

        report = {
            "seed": seed,
            "device": str(device),
            "ingested": ingested,
            "stored": stored,
            "restored": restored,
            "dead_letters": dead,
            "fault_hits": fault_hits,
            "resilience": resilience,
            "overload": overload_report,
            "device_fault": device_report,
            "recovery": recovery_report,
            "fleet": fleet_report,
            "failures": failures,
            "ok": not failures,
        }
        print(json.dumps(report, indent=2))
        if args.json_out:
            with open(args.json_out, "w") as f:
                json.dump(report, f, indent=2)
    finally:
        faults.clear()
        faults.device_clear()
        shutil.rmtree(root, ignore_errors=True)

    if failures:
        for f in failures:
            print(f"FAIL: {f}", file=sys.stderr)
        return 1
    print("chaos_smoke: clean recovery")
    return 0


if __name__ == "__main__":
    sys.exit(main())
