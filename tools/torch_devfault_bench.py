#!/usr/bin/env python3
"""Device-tier fault containment bench for the PyTorch port.

The port's twin of ``tools/devfault_bench.py --smoke``: it drives a real
port ``Instance`` (``sitewhere_tpu_torch``) through the dispatcher's
device-fault points (``sitewhere_tpu_torch/runtime/faults.py``) at that
bench's sizes (width 64, 8 devices) and holds the containment contract:

- ``chain_fault``: a fault inside a chained ring dispatch re-parks every
  ring plan and re-dispatches them single-step from the pre-chain epoch
  the same live state manager still holds (``lease_generation`` advances
  without a restart), with zero row loss; a fault at slot 1 of the
  2-step chain, after slot 0 ran, leaves the held epoch bitwise the
  pre-chain one, and the state after the re-dispatch equals a fault-free
  run's, bitwise;
- ``breaker``: repeated faults across distinct batches demote dispatch
  chained -> single-step -> FALLBACK and ride the overload ladder
  (DEGRADED while demoted).  On the CPU the FALLBACK level steps there
  (counted in ``device.fault.cpu_fallback_steps``) and a cooldown probe
  restores chained dispatch and releases the ladder.  On a card the
  FALLBACK level fails closed: the demotion runs in a child process,
  which must exit with the dispatcher's STICKY_EXIT_CODE at its first
  dispatch past FALLBACK, and a restart on its directory must store
  every row it journaled;
- ``poison``: rows that fault the device bisect down to the exact poison
  singles, which dead-letter replayably (``device-poison``); every clean
  row commits, and the clean devices' state equals a fault-free run's;
- ``quarantine``: requeuing the poison letters re-ingests the rows; the
  step masks and counts them, and the offending device is quarantined
  with one STATE_CHANGE through the normal egress;
- ``watchdog``: a stalled dispatch trips the soft then the hard budget
  (flight-recorder anomalies; the tier reads unhealthy) and self-clears
  when the dispatch drains;
- ``shard_containment``: the fused mesh ring (4 shards on the one
  device, K=2) under a poison storm in shard 2's segment: only shard 2's
  breaker demotes, the healthy shards keep chaining, the poison rows
  dead-letter as ``device-poison``, no clean row is lost, and the
  episode dumps the flight recorder.  Then shard 2 is driven to
  FALLBACK: its rows side-step through the mesh while the others chain,
  and the process does not exit (on a card ``cpu_fallback_steps`` stays
  0; on the CPU each side step counts as one, as the reference's do).

Usage, from the repository root::

    python3 tools/torch_devfault_bench.py [--device cpu|cuda]

The default device is the card.  Each phase prints one JSON line (with
the geofence kernel's launches when it ran on the card); exit status 0
means every phase held its contract.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sitewhere_tpu_torch.runtime import faults  # noqa: E402

WIDTH = 64
N_DEVICES = 8
POISON_DEVICE = f"d-{N_DEVICES - 1}"
TS0 = 1_754_500_000


def make_instance(data_dir, device, **overrides):
    from sitewhere_tpu_torch.instance import Instance
    from sitewhere_tpu_torch.runtime.config import Config

    pipeline = {"width": WIDTH, "registry_capacity": 256,
                "mtype_slots": 4, "deadline_ms": 5.0, "n_shards": 1,
                "ring_depth": 0, "quarantine_after": 3}
    pipeline.update(overrides)
    cfg = Config({
        "instance": {"id": "devfault-bench", "data_dir": data_dir},
        "pipeline": pipeline,
        # only the bench releases the forced DEGRADED (through the
        # breaker's restore): the ladder's own cooldown must not race it
        "overload": {"cooldown_s": 3600.0},
    }, apply_env=False)
    return Instance(cfg, device=device)


def register(inst):
    dm = inst.device_management
    dm.create_device_type(token="sensor", name="Sensor")
    for i in range(N_DEVICES):
        dm.create_device(token=f"d-{i}", device_type="sensor")
        dm.create_device_assignment(device=f"d-{i}")


class Traffic:
    """Deterministic full-width payload builder (one fill plan each)."""

    def __init__(self, ts0=TS0, clean_devices=N_DEVICES):
        self.ts = ts0
        self.clean = clean_devices

    def _row(self, token, value, ts):
        return json.dumps({
            "deviceToken": token, "type": "Measurement",
            "request": {"name": "temp", "value": value, "eventDate": ts},
        })

    def payload(self, rows=WIDTH, poison_rows=0):
        """``rows`` wire lines; the LAST ``poison_rows`` of them carry a
        NaN value on the dedicated poison device."""
        lines = []
        for r in range(rows):
            self.ts += 1
            if r >= rows - poison_rows:
                lines.append(self._row(POISON_DEVICE, float("nan"),
                                       self.ts))
            else:
                tok = f"d-{r % self.clean}"
                lines.append(self._row(tok, float(self.ts % 997), self.ts))
        return "\n".join(lines).encode()


def counters(inst):
    return inst.metrics.snapshot()["counters"]


def gauges(inst):
    return inst.metrics.snapshot()["gauges"]


def settle(inst):
    inst.dispatcher.flush()
    inst.event_store.flush()
    return inst.event_store.total_events


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def chain_failing_at(k, slot):
    """A K-step chain whose step at ``slot`` raises after the earlier
    slots have run: a fault in the middle of the chain, on the card."""
    from sitewhere_tpu_torch.pipeline.packed import (
        chain_over_slots,
        packed_pipeline_step,
    )

    calls = [0]

    def step(tables, ps, bi, bf):
        calls[0] += 1
        if calls[0] == slot + 1:
            raise faults.FaultInjected(
                f"injected fault at chain slot {slot} of {k}")
        return packed_pipeline_step(tables, ps, bi, bf)

    def chain(tables, ps, *slots):
        return chain_over_slots(step, k, tables, ps, slots)

    return chain


def phase_chain_fault(root, check, device):
    """A transient chained-dispatch fault: re-park, re-lease, zero loss;
    then a fault at slot 1 of the 2-step chain, after slot 0 ran: the
    held epoch stays bitwise the pre-chain one, and the state after the
    single-step re-dispatch equals a fault-free control run's, bitwise."""
    inst = make_instance(os.path.join(root, "chain"), device,
                         ring_depth=2, deadline_ms=200.0)
    control = make_instance(os.path.join(root, "chain-control"), device,
                            ring_depth=2, deadline_ms=200.0)
    inst.start()
    control.start()
    register(inst)
    register(control)
    traffic = Traffic()
    t_ctl = Traffic()
    d = inst.dispatcher
    sm = inst.device_state

    def both():
        d.ingest_wire_lines(traffic.payload())
        control.dispatcher.ingest_wire_lines(t_ctl.payload())

    # warm: one clean chained ring (2 fill plans = ring_depth)
    both()
    both()
    ingested = 2 * WIDTH
    stored0 = settle(inst)
    check(stored0 >= ingested, "warm ring lost rows "
          f"({stored0} stored of {ingested})")
    gen0 = sm.lease_generation
    check(gen0 > 0, "the ring never leased the packed carry")

    # the fault: the first chained dispatch dies once, then the card is
    # fine
    faults.device_inject("device.dispatch", times=1)
    both()
    both()   # ring full -> chain -> fault
    ingested += 2 * WIDTH
    stored = settle(inst)
    faults.device_clear()

    c = counters(inst)
    check(c.get("device.fault.chain_faults", 0) == 1,
          f"expected 1 chain fault, saw {c.get('device.fault.chain_faults')}")
    check(c.get("device.fault.releases", 0) == 1,
          "the faulted chain's lease was not re-leased")
    check(stored >= ingested,
          f"chain fault lost rows: {ingested} ingested, {stored} stored")
    check(d.breaker.snapshot()["level"] == 0,
          "a single transient fault must not trip the breaker")

    # recovery without restart: the SAME live manager leases the carry
    # again for the next chained ring
    both()
    both()
    ingested += 2 * WIDTH
    stored = settle(inst)
    check(sm.lease_generation > gen0,
          "lease_generation did not advance across the fault")
    check(sm is d.state_manager, "state manager identity changed")
    check(stored >= ingested,
          f"post-recovery ring lost rows: {ingested} in, {stored} stored")
    report = {
        "ingested": ingested,
        "stored": int(stored),
        "chain_faults": int(c.get("device.fault.chain_faults", 0)),
        "releases": int(c.get("device.fault.releases", 0)),
        "lease_generation": int(sm.lease_generation),
        "breaker": d.breaker.snapshot(),
    }

    # a fault in the middle of the chain: slot 0 stepped, slot 1 raised
    epoch0 = sm.snapshot_host()
    kept = {}

    def observe(plans, exc, _orig=d._recover_ring):
        kept.update(sm.snapshot_host())
        return _orig(plans, exc)

    d._ring_chains[2] = chain_failing_at(2, 1)
    d._recover_ring = observe
    try:
        both()
        both()
        ingested += 2 * WIDTH
        stored = settle(inst)
    finally:
        del d._recover_ring
        del d._ring_chains[2]
    settle(control)
    check(bool(kept) and all(kept[k].tobytes() == epoch0[k].tobytes()
                             for k in epoch0),
          "the failed chain changed the held epoch")
    check(stored >= ingested,
          f"mid-chain fault lost rows: {ingested} in, {stored} stored")
    got, want = sm.snapshot_host(), control.device_state.snapshot_host()
    unequal = [k for k in want if got[k].tobytes() != want[k].tobytes()]
    check(not unequal, f"state after the re-dispatch differs from the "
          f"fault-free run in {unequal}")
    c = counters(inst)
    report.update({
        "mid_chain_faults": int(c.get("device.fault.chain_faults", 0))
        - report["chain_faults"],
        "epoch_kept_bitwise": bool(kept) and all(
            kept[k].tobytes() == epoch0[k].tobytes() for k in epoch0),
        "state_equals_fault_free": not unequal,
        "stored_after_mid_chain": int(stored),
        "cpu_fallback_steps": int(c.get("device.fault.cpu_fallback_steps",
                                        0)),
    })
    control.stop()
    control.terminate()
    inst.stop()
    inst.terminate()
    return report


def _demote(data_dir, device, check, on_ingest=None):
    """Six faults of distinct batches on a fresh instance (ring K=2): the
    first three demote chained -> single-step, the next three
    single-step -> FALLBACK.  ``on_ingest(ingested, inst)`` runs before
    each ingest call, with the rows journaled once it returns.  Returns
    ``(inst, traffic, ingested, transitions)``."""
    from sitewhere_tpu_torch.runtime.overload import OverloadState

    inst = make_instance(data_dir, device, ring_depth=2, deadline_ms=200.0)
    inst.start()
    register(inst)
    traffic = Traffic()
    d = inst.dispatcher
    d.breaker.cooldown_s = 3600.0     # no accidental half-open mid-phase
    ingested = 0
    transitions = []
    inst.overload.on_transition(
        lambda old, new, signals: transitions.append(
            [old.name, new.name, inst.overload.last_driver]))

    def ingest():
        nonlocal ingested
        ingested += WIDTH
        if on_ingest is not None:
            on_ingest(ingested, inst)
        d.ingest_wire_lines(traffic.payload())

    def fault_cycle():
        faults.device_inject("device.dispatch", times=1)
        ingest()
        ingest()
        settle(inst)
        faults.device_clear()

    # three distinct-batch faults: chained -> single-step
    for _ in range(d.breaker.threshold):
        fault_cycle()
    snap = d.breaker.snapshot()
    check(snap["level"] == 1 and snap["trips"] == 1,
          f"breaker did not demote to single-step: {snap}")
    check(inst.overload.state == OverloadState.DEGRADED,
          "breaker trip did not ride the overload ladder to DEGRADED")
    check(inst.overload.last_driver == "device-breaker",
          "forced DEGRADED lost its driver attribution")

    # three more: single-step -> FALLBACK
    for _ in range(d.breaker.threshold):
        fault_cycle()
    return inst, traffic, ingested, transitions


def phase_breaker(root, check, device):
    """Repeated faults demote chained -> single-step -> FALLBACK.  On the
    CPU the FALLBACK level steps there, counted, and a cooldown probe
    restores chained dispatch and releases the ladder.  On a card the
    FALLBACK level fails closed (:func:`phase_breaker_card`)."""
    if device.type != "cpu":
        return phase_breaker_card(root, check, device)
    from sitewhere_tpu_torch.runtime.overload import OverloadState

    inst, traffic, ingested, transitions = _demote(
        os.path.join(root, "breaker"), device, check)
    d = inst.dispatcher
    snap = d.breaker.snapshot()
    check(snap["level"] == 2 and snap["trips"] == 2,
          f"breaker did not demote to cpu-fallback: {snap}")

    # at FALLBACK a clean dispatch steps on the CPU
    d.ingest_wire_lines(traffic.payload())
    ingested += WIDTH
    settle(inst)
    c = counters(inst)
    check(c.get("device.fault.cpu_fallback_steps", 0) >= 1,
          "FALLBACK level never routed a step to the CPU")

    # recovery: cooldown elapses -> half-open probe -> chained success
    d.breaker.cooldown_s = 0.0
    d.ingest_wire_lines(traffic.payload())
    d.ingest_wire_lines(traffic.payload())
    ingested += 2 * WIDTH
    stored = settle(inst)
    snap = d.breaker.snapshot()
    check(snap["level"] == 0 and snap["restores"] == 1,
          f"probe did not restore chained dispatch: {snap}")
    check(inst.overload.state == OverloadState.NORMAL,
          "breaker restore did not release the forced DEGRADED")
    check(stored >= ingested,
          f"breaker ladder lost rows: {ingested} ingested, {stored} stored")

    c = counters(inst)
    report = {
        "ingested": ingested,
        "stored": int(stored),
        "trips": snap["trips"],
        "restores": snap["restores"],
        "breaker_trips_metric": int(c.get("device.fault.breaker_trips", 0)),
        "cpu_fallback_steps": int(c.get("device.fault.cpu_fallback_steps",
                                        0)),
        "overload": inst.overload.state.name,
        "transitions": transitions,
    }
    inst.stop()
    inst.terminate()
    return report


def breaker_child(data_dir, device) -> int:
    """``--breaker-child``: the demotion on ``device``, with a checkpoint
    once the devices are registered; progress goes to ``<data_dir>.json``
    before each ingest and at each breaker trip.  The dispatcher must
    fail closed (the process exits) at its first dispatch past FALLBACK:
    returning here is a failure."""
    from sitewhere_tpu_torch.device import resolve_device

    progress = {"ingested": 0, "trip_levels": [], "overload_at_trips": []}

    def write():
        with open(data_dir + ".json", "w") as f:
            json.dump(progress, f)

    def on_ingest(ingested, inst):
        if ingested == WIDTH:
            # the devices are registered: checkpoint them for the
            # restart, and record each breaker trip as it happens
            inst.checkpointer.save()
            breaker = inst.dispatcher.breaker
            on_trip = breaker.on_trip

            def tripped(level):
                on_trip(level)
                progress["trip_levels"].append(level)
                progress["overload_at_trips"].append(
                    inst.overload.state.name)
                write()

            breaker.on_trip = tripped
        progress["ingested"] = ingested
        write()

    failures = []
    _demote(data_dir, resolve_device(device),
            lambda ok, msg: ok or failures.append(msg), on_ingest)
    print(f"survived past FALLBACK; failures: {failures}", file=sys.stderr)
    return 1


def phase_breaker_card(root, check, device):
    """The breaker's ladder on a card: the demotion runs in a child
    process (``--breaker-child``), which must fail closed with the
    dispatcher's STICKY_EXIT_CODE at its first dispatch past FALLBACK,
    writing the flight recorder and dead-lettering nothing; a restart on
    its directory must store every row it journaled, with no step on the
    CPU in either process."""
    from sitewhere_tpu_torch.runtime.dispatcher import STICKY_EXIT_CODE

    data_dir = os.path.join(root, "breaker")
    env = dict(os.environ, PYTHONPATH=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--device", str(device),
         "--breaker-child", data_dir],
        env=env, capture_output=True, text=True, timeout=300)
    check(proc.returncode == STICKY_EXIT_CODE,
          f"breaker child exit {proc.returncode}: {proc.stderr[-1500:]}")
    check("failing closed" in proc.stderr,
          f"breaker child left no fail-closed log: {proc.stderr[-800:]}")
    with open(data_dir + ".json") as f:
        progress = json.load(f)
    check(progress["trip_levels"] == [1, 2],
          f"breaker trips in the child: {progress['trip_levels']}")
    check(progress["overload_at_trips"] == ["DEGRADED", "DEGRADED"],
          f"the trips did not ride the overload ladder: {progress}")
    inst = make_instance(data_dir, device, ring_depth=2, deadline_ms=200.0)
    try:
        check(inst.restored, "the breaker restart restored no checkpoint")
        inst.start()
        stored = settle(inst)
        letters = [doc for doc in inst.list_dead_letters(limit=1000)
                   if doc.get("kind") == "device-poison"]
        snaps = [s.get("reason") for s in inst.flightrec.snapshots()]
        c = counters(inst)
        report = {
            "ingested": progress["ingested"],
            "stored": int(stored),
            "trips": len(progress["trip_levels"]),
            "restores": 0,
            "trip_levels": progress["trip_levels"],
            "exit_code": proc.returncode,
            "poison_letters": len(letters),
            "device_lost_dump": "device-lost" in snaps,
            "cpu_fallback_steps": int(c.get(
                "device.fault.cpu_fallback_steps", 0)),
            "overload_at_trips": progress["overload_at_trips"],
        }
        inst.stop()
    finally:
        inst.terminate()
    check(report["stored"] == report["ingested"],
          f"breaker restart stored {report['stored']} of "
          f"{report['ingested']} journaled rows")
    check(not letters, "failing closed dead-lettered rows")
    check(report["device_lost_dump"], "no device-lost flight-recorder dump")
    return report


def clean_state(inst):
    """State rows of every clean device, keyed by token."""
    return {f"d-{i}": inst.device_state.get_device_state(f"d-{i}")
            for i in range(N_DEVICES - 1)}


def _same(a, b):
    """Equality of nested state dicts, NaN equal to NaN."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (math.isnan(a) and math.isnan(b))
    return a == b


def phase_poison(root, check, device):
    """Poison rows bisect to dead letters; clean rows commit equal to a
    fault-free control run.  Returns ``(report, inst, letters)``: the
    quarantine phase continues on the same instance."""
    inst = make_instance(os.path.join(root, "poison"), device)
    control = make_instance(os.path.join(root, "control"), device)
    inst.start()
    control.start()
    register(inst)
    register(control)
    d = inst.dispatcher
    d.breaker.threshold = 99   # this phase proves bisect, not the ladder
    n_poison = 3
    n_clean_payloads = 2    # the reference bench's --smoke volume
    ingested_clean = 0

    t_fault = Traffic(clean_devices=N_DEVICES - 1)
    t_ctl = Traffic(clean_devices=N_DEVICES - 1)
    for _ in range(n_clean_payloads):
        d.ingest_wire_lines(t_fault.payload())
        control.dispatcher.ingest_wire_lines(t_ctl.payload())
        ingested_clean += WIDTH

    # the poison payload: the same clean rows to both; the faulted run
    # also carries NaN rows that make the device fault
    faults.device_inject("device.dispatch", times=None,
                         when_nonfinite=True)
    d.ingest_wire_lines(t_fault.payload(poison_rows=n_poison))
    control.dispatcher.ingest_wire_lines(
        t_ctl.payload(rows=WIDTH - n_poison))
    t_ctl.ts += n_poison          # keep the clocks aligned
    ingested_clean += WIDTH - n_poison
    stored = settle(inst)
    stored_ctl = settle(control)
    faults.device_clear()

    c = counters(inst)
    check(c.get("device.fault.poison_rows", 0) == n_poison,
          f"bisect isolated {c.get('device.fault.poison_rows')} rows, "
          f"expected exactly {n_poison}")
    check(c.get("device.fault.bisect_rounds", 0) > 0, "bisect never ran")
    letters = [doc for doc in inst.list_dead_letters(limit=50)
               if doc.get("kind") == "device-poison"]
    check(len(letters) >= 1, "no device-poison dead letters")
    dl_rows = sum(int(doc.get("count", 0)) for doc in letters)
    check(dl_rows == n_poison,
          f"dead letters carry {dl_rows} rows, expected {n_poison}")
    for doc in letters:
        vals = doc.get("columns", {}).get("value", [])
        check(all(not math.isfinite(v) for v in vals),
              "a dead-lettered poison row has a finite value")
    check(stored >= ingested_clean,
          f"poison containment lost clean rows: {ingested_clean} clean "
          f"ingested, {stored} stored")

    st, st_ctl = clean_state(inst), clean_state(control)
    mismatched = [tok for tok in st if not _same(st[tok], st_ctl[tok])]
    check(not mismatched,
          f"unpoisoned device state diverged from the fault-free run: "
          f"{mismatched}")

    # goodput recovers: the next clean payload lands in full
    d.ingest_wire_lines(t_fault.payload())
    ingested_clean += WIDTH
    stored_after = settle(inst)
    check(stored_after >= stored + WIDTH,
          "goodput did not recover after containment")
    c = counters(inst)
    report = {
        "clean_rows": ingested_clean,
        "stored": int(stored_after),
        "control_stored": int(stored_ctl),
        "poison_rows": n_poison,
        "dead_letters": len(letters),
        "bisect_rounds": int(c.get("device.fault.bisect_rounds", 0)),
        "state_bit_identical": not mismatched,
        "cpu_fallback_steps": int(c.get("device.fault.cpu_fallback_steps",
                                        0)),
    }
    control.stop()
    control.terminate()
    return report, inst, letters


def phase_quarantine(inst, letters, check):
    """Requeue the poison letters: the rows re-enter, the step masks and
    counts them, and the offending device is quarantined once."""
    d = inst.dispatcher
    g0 = gauges(inst)
    check(g0.get("pipeline.quarantine.devices", 0) == 0,
          "device quarantined before any nonfinite row egressed")
    requeued_rows = 0
    for doc in letters:
        res = inst.requeue_dead_letter(int(doc["offset"]))
        check(res.get("requeued") is True,
              f"device-poison requeue refused: {res}")
        requeued_rows += int(res.get("rows", 0))
    n_poison = sum(int(doc.get("count", 0)) for doc in letters)
    check(requeued_rows == n_poison,
          f"requeue replayed {requeued_rows} rows, expected {n_poison}")
    again = inst.requeue_dead_letter(int(letters[0]["offset"]))
    check(again.get("already") is True, "a second requeue re-delivered")
    settle(inst)
    c = counters(inst)
    g = gauges(inst)
    check(c.get("pipeline.quarantine.rows_nonfinite", 0) >= n_poison,
          "device-counted nonfinite telemetry never surfaced")
    check(g.get("pipeline.quarantine.devices", 0) == 1,
          f"expected 1 quarantined device, gauge says "
          f"{g.get('pipeline.quarantine.devices')}")
    check(c.get("pipeline.quarantine.state_changes", 0) == 1,
          "quarantine did not emit exactly one STATE_CHANGE")
    check(d.metrics_snapshot()["device_fault"]["quarantined_devices"] == 1,
          "dispatcher snapshot disagrees on quarantined devices")
    report = {
        "requeued_rows": requeued_rows,
        "quarantined_devices": int(g.get("pipeline.quarantine.devices", 0)),
        "state_changes": int(c.get("pipeline.quarantine.state_changes", 0)),
        "cpu_fallback_steps": int(c.get("device.fault.cpu_fallback_steps",
                                        0)),
    }
    inst.stop()
    inst.terminate()
    return report


def phase_watchdog(root, check, device):
    """A stalled dispatch trips the soft then the hard budget, reads
    unhealthy, and self-clears when the dispatch drains."""
    inst = make_instance(os.path.join(root, "watchdog"), device)
    inst.start()
    register(inst)
    d = inst.dispatcher
    d.watchdog.soft_s = 0.05
    d.watchdog.hard_s = 0.2
    traffic = Traffic()

    unhealthy_seen = []
    stop = threading.Event()

    def sampler():
        while not stop.is_set():
            if d.device_unhealthy:
                unhealthy_seen.append(True)
            time.sleep(0.01)

    t = threading.Thread(target=sampler, daemon=True)
    t.start()
    anomalies0 = int(counters(inst).get("flightrec.anomalies", 0))
    faults.device_inject("device.dispatch", exc=None, stall_s=0.6)
    d.ingest_wire_lines(traffic.payload())   # stalls 0.6 s on this thread
    faults.device_clear()
    stored = settle(inst)
    stop.set()
    t.join(timeout=2)

    wd = d.watchdog.snapshot()
    c = counters(inst)
    check(wd["softTrips"] >= 1, "soft budget never tripped")
    check(wd["hardTrips"] >= 1, "hard budget never tripped")
    check(bool(unhealthy_seen),
          "device_unhealthy was never observable while wedged")
    check(not wd["unhealthy"],
          "unhealthy flag did not self-clear after the dispatch drained")
    check(c.get("device.fault.watchdog_soft_trips", 0) >= 1
          and c.get("device.fault.watchdog_hard_trips", 0) >= 1,
          "watchdog trip counters missing")
    anomalies = int(c.get("flightrec.anomalies", 0))
    check(anomalies > anomalies0,
          "no flight-recorder anomaly for the hung step")
    check(stored >= WIDTH, "stalled dispatch lost rows")

    report = {
        "soft_trips": wd["softTrips"],
        "hard_trips": wd["hardTrips"],
        "unhealthy_observed": bool(unhealthy_seen),
        "self_cleared": not wd["unhealthy"],
        "anomalies": anomalies - anomalies0,
        "stored": int(stored),
        "cpu_fallback_steps": int(c.get("device.fault.cpu_fallback_steps",
                                        0)),
    }
    inst.stop()
    inst.terminate()
    return report


def phase_shard_containment(root, check, device, n_shards=4, k=2,
                            capacity=32, width=WIDTH):
    """Fused mesh ring under a one-shard poison storm, then that shard at
    FALLBACK (see the module docstring)."""
    from sitewhere_tpu_torch.runtime.devguard import FALLBACK

    seg = width // n_shards
    rps = capacity // n_shards
    inst = make_instance(os.path.join(root, "shards"), device,
                         n_shards=n_shards, ring_depth=k,
                         deadline_ms=200.0, registry_capacity=capacity,
                         width=width)
    inst.start()
    dm = inst.device_management
    dm.create_device_type(token="sensor", name="Sensor")
    for i in range(capacity):
        dm.create_device(token=f"d-{i}", device_type="sensor")
        dm.create_device_assignment(device=f"d-{i}")
    handles = np.asarray(inst.identity.device.lookup_many(
        [f"d-{i}" for i in range(capacity)]), np.int32)
    by_shard = [handles[(handles // rps) == s] for s in range(n_shards)]
    rng = np.random.default_rng(5)
    poison_rounds, clean_rounds, ppr = 2 * k, 2 * k, 2

    def rounds(n, r0, poison):
        for r in range(r0, r0 + n):
            # balanced shard-block-ordered full rounds: every emission is
            # ring-eligible on every shard
            dev = np.concatenate([rng.choice(by_shard[s], seg)
                                  for s in range(n_shards)]).astype(np.int32)
            value = rng.uniform(0, 100, width).astype(np.float32)
            if poison:
                value[2 * seg:2 * seg + ppr] = np.nan   # shard 2 only
            inst.dispatcher.ingest_arrays(
                device_id=dev, event_type=np.zeros(width, np.int32),
                ts_s=np.full(width, TS0 + r, np.int32),
                mtype_id=np.zeros(width, np.int32), value=value)

    faults.device_inject("device.dispatch", times=None, when_nonfinite=True)
    try:
        rounds(poison_rounds, 0, True)
        rounds(clean_rounds, poison_rounds, False)
    finally:
        faults.device_clear()
    stored = settle(inst)
    disp = inst.dispatcher
    snap = disp.metrics_snapshot()
    br = snap["device_fault"]["breaker"]
    check(br["shards"][2]["level"] >= 1,
          f"poisoned shard 2 never demoted: {br}")
    healthy = [s for s in range(n_shards) if s != 2]
    for s in healthy:
        check(br["shards"][s]["level"] == 0,
              f"healthy shard {s} was demoted with the sick one: {br}")
    npoison = poison_rounds * ppr
    letters = [d for d in inst.list_dead_letters(limit=100)
               if d.get("kind") == "device-poison"]
    dl_rows = sum(int(d.get("count", 0)) for d in letters)
    check(dl_rows == npoison,
          f"dead letters carry {dl_rows} rows, expected {npoison}")
    total = (poison_rounds + clean_rounds) * width
    check(stored == total - npoison,
          f"clean-row loss: {total - npoison} expected, {stored} stored")
    check(snap["ring_chains"] >= 1,
          "healthy shards never chained while shard 2 was demoted")
    dump = (inst.flightrec.snapshot("shard-containment")
            if inst.flightrec is not None else None)
    check(dump is not None, "no flight-recorder dump for the episode")

    # shard 2 at FALLBACK: its rows side-step through the mesh
    bank = disp.breaker
    seq = 10_000
    while bank.level_of(2) < FALLBACK:
        bank.record_fault(seq, shard=2)
        seq += 1
    chains0, side0 = snap["ring_chains"], disp.sidecar_steps
    fb0 = int(counters(inst).get("device.fault.cpu_fallback_steps", 0))
    fb_rounds = 2 * k
    rounds(fb_rounds, poison_rounds + clean_rounds, False)
    stored_fb = settle(inst)
    snap = disp.metrics_snapshot()
    side = disp.sidecar_steps - side0
    fb = int(counters(inst).get("device.fault.cpu_fallback_steps", 0)) - fb0
    check(stored_fb == stored + fb_rounds * width,
          f"FALLBACK shard lost rows: {stored_fb - stored} of "
          f"{fb_rounds * width} stored")
    check(side == fb_rounds, f"{side} side steps for {fb_rounds} plans")
    check(snap["ring_chains"] - chains0 == fb_rounds // k,
          "the healthy shards stopped chaining beside the FALLBACK shard")
    check(all(bank.level_of(s) == 0 for s in healthy),
          "a healthy shard left level 0")
    check(fb == (side if inst.device.type == "cpu" else 0),
          f"cpu_fallback_steps moved by {fb} on {inst.device.type}")
    report = {
        "n_shards": n_shards,
        "ring_depth": k,
        "poison_rows": npoison,
        "stored": int(stored),
        "expected_stored": total - npoison,
        "shard_levels": [int(sh["level"]) for sh in br["shards"]],
        "ring_chains": int(chains0),
        "dead_letter_rows": dl_rows,
        "flightrec_dump": dump,
        "fallback_ring_chains": int(snap["ring_chains"] - chains0),
        "fallback_side_steps": side,
        "fallback_stored": int(stored_fb - stored),
        "cpu_fallback_steps": fb,
    }
    inst.stop()
    inst.terminate()
    return report


def run(device, check, root, on_phase=None):
    """Every phase in order; ``on_phase(name, report)`` sees each report
    as it lands.  Returns ``{phase: report}``."""
    from sitewhere_tpu_torch.ops import geo_cuda

    phases = {}

    def record(name, fn, *args):
        launches0 = geo_cuda.launch_counts["pip_parity"]
        t0 = time.perf_counter()
        out = fn(*args)
        report = out[0] if isinstance(out, tuple) else out
        report["seconds"] = time.perf_counter() - t0
        report["kernel_launches"] = (geo_cuda.launch_counts["pip_parity"]
                                     - launches0)
        phases[name] = report
        if on_phase is not None:
            on_phase(name, report)
        return out

    try:
        record("chain_fault", phase_chain_fault, root, check, device)
        record("breaker", phase_breaker, root, check, device)
        _, inst, letters = record("poison", phase_poison, root, check,
                                  device)
        record("quarantine", phase_quarantine, inst, letters, check)
        record("watchdog", phase_watchdog, root, check, device)
        record("shard_containment", phase_shard_containment, root, check,
               device)
    finally:
        faults.device_clear()
        faults.clear()
    return phases


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--breaker-child", metavar="DATA_DIR",
                    help="run the breaker phase's child on a card")
    args = ap.parse_args()
    from sitewhere_tpu_torch.device import resolve_device

    if args.breaker_child:
        return breaker_child(args.breaker_child, args.device)

    device = resolve_device(args.device)
    failures = []

    def check(ok, msg):
        if not ok and msg:
            failures.append(msg)

    root = tempfile.mkdtemp(prefix="torch-devfault-bench-")
    t0 = time.monotonic()
    try:
        run(device, check, root, on_phase=lambda name, rep: print(
            json.dumps({"phase": name, **rep}), flush=True))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps({"device": str(device), "width": WIDTH,
                      "wall_s": time.monotonic() - t0,
                      "ok": not failures}))
    for f in failures:
        print(f"FAIL: {f}", file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
