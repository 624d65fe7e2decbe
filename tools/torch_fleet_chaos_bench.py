#!/usr/bin/env python3
"""Fleet chaos bench of the PyTorch port: goodput degrades smoothly, it
does not collapse.

Counterpart of ``tools/fleet_chaos_bench.py``.  A 3-host in-process fleet
(port :class:`~sitewhere_tpu_torch.instance.Instance` objects wired over
localhost RPC) takes keyed traffic at host 0's frontend while host 2 is
driven through the failure script:

1. **baseline**: all three hosts healthy; per-host goodput.
2. **shed**: host 2 forced into SHEDDING (``overload.force``): its
   admission refuses telemetry, host 0's health table learns it
   (heartbeat + response piggyback), parks the spool and paces single
   probe batches; the device-facing edge refuses pure host-2 payloads
   with host 2's Retry-After hint.
3. **partition**: host 2's endpoint additionally drops every packet
   (``faults.net_inject``): the failure detector walks SUSPECT -> DOWN;
   probes stay paced.
4. **recover**: partition healed, overload cleared: the health table
   returns to ALIVE/NORMAL and the spool drains to zero.

Asserted contract (the bench FAILS otherwise), as the reference's:

- healthy-host goodput never collapses (min phase >= ``collapse_frac``
  of baseline);
- send attempts to the unhealthy peer stay BOUNDED (one paced probe per
  interval of the phase's wall time, plus discovery slack);
- ZERO forward-plane dead letters, and the spool drains to zero on
  recovery;
- the health table does not flap (bounded transitions for host 2);
- at-least-once toward host 2: it accepts every row sent its way.

The phases wait on the bench's own barriers and counters, not on
wall-clock margins: each phase sends a fixed number of paced driver
rounds after the health table shows the state its setup must produce,
and ends when the healthy hosts have accepted every row sent to them.

Usage, from the repository root::

    python3 tools/torch_fleet_chaos_bench.py [--smoke] [--device cpu]
        [--json FLEETCHAOS.json]

The default device is the card; ``--device cpu`` runs every host on the
CPU.  ``--smoke`` shrinks the phases.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import socket
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sitewhere_tpu_torch.runtime import faults  # noqa: E402

N_HOSTS = 3
N_DEVICES = 48
T0 = 1_754_000_000
SICK = 2                        # the host under test
HEARTBEAT_S = 0.1
PROBE_INTERVAL_S = 2 * HEARTBEAT_S  # the health table's default pacing
COLLAPSE_FRAC = 0.25
BARRIER_S = 60.0                # longest wait on any barrier
MAX_TRANSITIONS = 8
# pacing of the driver's rounds: sustained traffic well inside the
# healthy hosts' capacity, so only the scripted host leaves NORMAL
ROUND_S = 0.02
UNREACHABLE = [1e9, 2e9, 3e9]


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _config(data_dir, ports, pid, heartbeat_s):
    from sitewhere_tpu_torch.runtime.config import Config

    return Config({
        "instance": {"id": f"fleet-{pid}", "data_dir": data_dir},
        "pipeline": {"width": 64, "registry_capacity": 256,
                     "mtype_slots": 4, "deadline_ms": 5.0, "n_shards": 1},
        "presence": {"scan_interval_s": 3600.0, "missing_after_s": 86400},
        "checkpoint": {"interval_s": 0},
        "analytics": {"enabled": False},
        "slo": {"enabled": False},
        # forced overload states must hold for the scripted phase: a
        # short cooldown would let the controller self-recover mid-test.
        # The script is the only overload: every signal's watermarks sit
        # out of reach, so a slow fsync on a loaded box cannot push a
        # healthy host into SHEDDING for the cooldown's 600 s
        "overload": {"enabled": True, "cooldown_s": 600.0,
                     "watermarks": {name: UNREACHABLE for name in (
                         "seal_lag_s", "decode_backlog", "egress_inflight",
                         "batcher_backlog", "fsync_latency_s")}},
        "rpc": {
            "server": {"enabled": True, "host": "127.0.0.1",
                       "port": ports[pid]},
            "process_id": pid,
            "peers": [f"127.0.0.1:{p}" for p in ports],
            "forward_deadline_ms": 10.0,
            "heartbeat_interval_s": heartbeat_s,
            "call_timeout_s": 3.0,
        },
        "security": {"jwt_secret": "fleet-chaos-secret"},
    }, apply_env=False)


def _boot_fleet(root, device):
    from sitewhere_tpu_torch.instance import Instance
    from sitewhere_tpu_torch.rpc.forward import owning_process

    ports = [_free_port() for _ in range(N_HOSTS)]
    insts = []
    for pid in range(N_HOSTS):
        inst = Instance(_config(os.path.join(root, f"host{pid}"), ports,
                                pid, HEARTBEAT_S), device=device)
        inst.start()
        insts.append(inst)
    # every host registers the devices IT owns (dense handles are
    # host-local; forwarded rows must find a registered device)
    tokens_by_owner = {p: [] for p in range(N_HOSTS)}
    for i in range(N_DEVICES):
        tok = f"d-{i}"
        tokens_by_owner[owning_process(tok, N_HOSTS)].append(tok)
    for pid, inst in enumerate(insts):
        dm = inst.device_management
        dm.create_device_type(token="sensor", name="Sensor")
        for tok in tokens_by_owner[pid]:
            dm.create_device(token=tok, device_type="sensor")
            dm.create_device_assignment(device=tok)
    return insts, ports, tokens_by_owner


def _payload(tokens, seq):
    lines = []
    for k, tok in enumerate(tokens):
        lines.append(json.dumps({
            "deviceToken": tok, "type": "Measurement",
            "request": {"name": "temp", "value": float(seq % 50),
                        "eventDate": T0 + seq * 64 + k},
        }))
    return "\n".join(lines).encode()


class Driver:
    """Keyed traffic into host 0's frontend: every round one payload
    carrying rows for ALL owners (the gateway-bulk shape: the edge gate
    never refuses it, the spool absorbs unhealthy owners)."""

    def __init__(self, fwd, tokens_by_owner):
        self.fwd = fwd
        self.tokens_by_owner = tokens_by_owner
        self.sent_rows = {p: 0 for p in tokens_by_owner}
        self.seq = 1

    def round(self):
        batch = {p: toks[self.seq % len(toks):][:4]
                 for p, toks in self.tokens_by_owner.items()}
        payload = b"\n".join(
            _payload(toks, self.seq) for toks in batch.values() if toks)
        self.seq += 1
        self.fwd.ingest_payload(payload, source_id="fleet-bench")
        for p, toks in batch.items():
            self.sent_rows[p] += len(toks)

    def snapshot(self):
        return dict(self.sent_rows)


def accepted(insts):
    return [int(i.dispatcher.metrics_snapshot()["accepted"]) for i in insts]


def count_ingest_calls(demux):
    """Wrap one peer demux's call() to count events.ingest attempts (the
    bounded-probe assertion reads this)."""
    counts = {"events.ingest": 0}
    orig = demux.call

    def counted(method, *a, **kw):
        if method in counts:
            counts[method] += 1
        return orig(method, *a, **kw)

    demux.call = counted
    return counts


def wait_for(cond, what, timeout_s=BARRIER_S, poll=None):
    """Block until ``cond()`` holds; False if it never did."""
    deadline = time.monotonic() + timeout_s
    while not cond():
        if time.monotonic() > deadline:
            return False
        if poll is not None:
            poll()
        time.sleep(0.02)
    return True


def attempt_budget(wall_s):
    """One paced probe per interval of the phase's wall time, plus
    discovery slack (the reference's budget over its fixed phase)."""
    return math.ceil(wall_s / PROBE_INTERVAL_S) + 8


def check_contract(report, failures):
    """The asserted contract over a finished report (appends to
    ``failures``): bounded attempts, smooth goodput, zero dead letters,
    drained spool, no flapping, at-least-once toward the sick host."""
    phases = report["phases"]
    for name in ("shed", "partition"):
        p = phases[name]
        p["attempt_budget"] = attempt_budget(p["wall_s"])
        if p["sick_ingest_attempts"] > p["attempt_budget"]:
            failures.append(
                f"{name}: {p['sick_ingest_attempts']} send attempts to the "
                f"unhealthy peer (budget {p['attempt_budget']}): retry "
                "storm")
    floor = COLLAPSE_FRAC * phases["baseline"]["healthy_goodput_rows_s"]
    for name in ("shed", "partition", "recover"):
        gp = phases[name]["healthy_goodput_rows_s"]
        if gp < floor:
            failures.append(f"{name}: healthy goodput collapsed "
                            f"({gp:.0f} < {floor:.0f} rows/s)")
    if report["forward_dead_lettered"]:
        failures.append(f"{report['forward_dead_lettered']} rows "
                        "dead-lettered by the forwarder")
    if report["pending_after_recovery"]:
        failures.append("spool did not drain on recovery "
                        f"({report['pending_after_recovery']} rows)")
    if report["sick_transitions"] > MAX_TRANSITIONS:
        failures.append(
            f"health table flapped: {report['sick_transitions']} "
            "transitions")
    if report["sick_accepted_rows"] < report["sick_sent_rows"]:
        failures.append(
            f"rows lost toward the sick host: sent "
            f"{report['sick_sent_rows']}, accepted "
            f"{report['sick_accepted_rows']}")


def run(device, smoke=True):
    """The script over a fresh fleet; ``(report, failures)``."""
    from sitewhere_tpu_torch.runtime.overload import (
        OverloadShed,
        OverloadState,
    )

    rounds = 50 if smoke else 200
    root = tempfile.mkdtemp(prefix="fleet-chaos-")
    failures = []
    report = {"phases": {}, "smoke": bool(smoke), "device": str(device)}
    insts = []
    try:
        t_boot = time.perf_counter()
        insts, ports, tokens_by_owner = _boot_fleet(root, device)
        report["boot_s"] = round(time.perf_counter() - t_boot, 2)
        fwd = insts[0].forwarder
        sick_ep = f"127.0.0.1:{ports[SICK]}"
        healthy = [p for p in range(N_HOSTS) if p != SICK]

        # warm-up OUTSIDE the timed phases: the first batch on every
        # host pays the first launches
        for p, toks in tokens_by_owner.items():
            fwd.ingest_payload(_payload(toks[:4], 0), source_id="warmup")
        fwd.flush(wait=True)
        if not wait_for(lambda: all(a >= 4 for a in accepted(insts)),
                        "warm-up", poll=fwd.flush):
            failures.append("warm-up rows never landed on every host")
        report["warmup_accepted"] = accepted(insts)
        base = accepted(insts)

        ingest_calls = count_ingest_calls(insts[0]._peer_demuxes[SICK])
        driver = Driver(fwd, tokens_by_owner)

        def run_phase(name, setup=None, ready=None):
            if setup:
                setup()
            if ready is not None and not wait_for(ready, name):
                failures.append(f"{name}: the fleet never reached the "
                                "phase's state")
            a0 = accepted(insts)
            s0 = driver.snapshot()
            c0 = ingest_calls["events.ingest"]
            t0 = time.perf_counter()
            for _ in range(rounds):
                driver.round()
                time.sleep(ROUND_S)
            s1 = driver.snapshot()
            # the phase ends when the healthy hosts hold their rows
            if not wait_for(lambda: all(
                    accepted(insts)[p] - base[p] >= s1[p] for p in healthy),
                    f"{name} intake", poll=fwd.flush):
                failures.append(f"{name}: healthy hosts never accepted "
                                "their rows")
            dt = time.perf_counter() - t0
            a1 = accepted(insts)
            phase = {
                "wall_s": round(dt, 3),
                "sent_rows": {str(p): s1[p] - s0[p] for p in s1},
                "accepted_delta": [a1[i] - a0[i] for i in range(N_HOSTS)],
                "healthy_goodput_rows_s": round(
                    sum(a1[p] - a0[p] for p in healthy) / dt, 1),
                "sick_ingest_attempts": ingest_calls["events.ingest"] - c0,
                "pending_to_sick": fwd.pending_for(SICK),
                "health": fwd.health.snapshot().get(str(SICK)),
            }
            report["phases"][name] = phase
            return phase

        # -- phase 1: baseline -------------------------------------------
        baseline = run_phase("baseline")
        if baseline["healthy_goodput_rows_s"] <= 0:
            failures.append("baseline produced no goodput: bench broken")

        # -- phase 2: host 2 forced into SHEDDING ------------------------
        shedding = int(OverloadState.SHEDDING)
        run_phase(
            "shed",
            setup=lambda: insts[SICK].overload.force(
                OverloadState.SHEDDING, reason="fleet-chaos"),
            ready=lambda: fwd.health.overload_state(SICK) == shedding)
        if fwd.health.overload_state(SICK) != shedding:
            failures.append(
                "health table never learned the SHEDDING state "
                f"(saw {fwd.health.overload_state(SICK)})")
        # the device-facing edge reflects the OWNER's state: a purely
        # host-2-owned telemetry payload is refused with its hint
        edge = {"refused": False, "retry_after_s": None}
        try:
            fwd.ingest_payload(
                _payload(tokens_by_owner[SICK][:4], 999_999),
                source_id="edge-check")
        except OverloadShed as e:
            edge = {"refused": True, "retry_after_s": e.retry_after_s,
                    "state": e.state.name}
        report["edge_refusal"] = edge
        if not edge["refused"]:
            failures.append("edge did not refuse a pure sick-owner payload "
                            "while the owner sheds")

        # -- phase 3: partition the sick host ----------------------------
        run_phase(
            "partition",
            setup=lambda: faults.net_inject(sick_ep, drop=1.0),
            ready=lambda: fwd.health.state(SICK).name != "ALIVE")
        state_after = fwd.health.state(SICK).name
        report["state_after_partition"] = state_after
        if state_after == "ALIVE":
            failures.append("partitioned peer still ALIVE in the table")

        # -- phase 4: recover --------------------------------------------
        def heal():
            faults.net_clear(sick_ep)
            insts[SICK].overload.force(OverloadState.NORMAL,
                                       reason="fleet-chaos-recover")

        run_phase("recover", setup=heal,
                  ready=lambda: fwd.health.state(SICK).name == "ALIVE")

        # the spool must drain to ZERO once the peer is healthy again
        wait_for(lambda: fwd.pending_rows() == 0, "drain", poll=fwd.flush)
        report["pending_after_recovery"] = fwd.pending_rows()
        report["forward_dead_lettered"] = int(fwd.dead_lettered)
        report["sick_transitions"] = fwd.health.transitions(SICK)
        sick_sent = driver.snapshot()[SICK]
        wait_for(lambda: accepted(insts)[SICK] - base[SICK] >= sick_sent,
                 "sick intake", poll=insts[SICK].dispatcher.flush)
        report["sick_sent_rows"] = sick_sent
        report["sick_accepted_rows"] = accepted(insts)[SICK] - base[SICK]
        report["forward_metrics"] = {
            k: v for k, v in fwd.metrics().items() if k != "peers"}
        check_contract(report, failures)
        report["ok"] = not failures
    finally:
        faults.net_clear()
        for inst in insts:
            try:
                inst.stop()
                inst.terminate()
            except Exception:   # noqa: BLE001 - teardown best-effort
                pass
        shutil.rmtree(root, ignore_errors=True)
    return report, failures


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--smoke", action="store_true")
    parser.add_argument("--device", default=None,
                        help="cpu, or the card (the default)")
    parser.add_argument("--json", dest="json_out")
    args = parser.parse_args(argv)

    from sitewhere_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    report, failures = run(device, smoke=args.smoke)
    print(json.dumps(report, indent=2))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(report, f, indent=2)
    if failures:
        for f in failures:
            print(f"FAIL: {f}", file=sys.stderr)
        return 1
    print("fleet_chaos: goodput degraded smoothly, spool drained, "
          "zero dead letters")
    return 0


if __name__ == "__main__":
    sys.exit(main())
