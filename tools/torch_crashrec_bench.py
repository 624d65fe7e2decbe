#!/usr/bin/env python3
"""Kill-point chaos harness of the PyTorch port: prove the port
``Instance`` survives ``kill -9`` anywhere, with measured recovery.

Counterpart of ``tools/crashrec_bench.py``: the same workload, kill
points, sweep catalog and contract over ``sitewhere_tpu_torch``; the
children die at the port's own crosspoints
(``sitewhere_tpu_torch/runtime/faults.py``).

The crash contract under test (runtime/checkpoint.py): restart = restore
the newest complete snapshot + replay the journal from each component's
as-of offset, converging to what an uninterrupted run produces.  The
harness makes that an experiment instead of an argument:

1. a GOLDEN child runs the fixed workload uninterrupted — its durable
   event set and analytics match set are the reference;
2. for each kill point, a fresh child runs the same workload with
   ``SW_CRASHPOINT=<point>:<n>`` armed (runtime/faults.py crosspoint),
   so the Nth crossing of a named pipeline point — mid-ring chain, after
   the journal append, mid-egress, mid-seal, mid-checkpoint-save, just
   before the manifest swap — SIGKILLs the process cold;
3. the parent restarts an instance on the survivor's data dir (restore +
   replay run inside ``Instance.start``) and asserts:
   - **zero committed-event loss**: every journaled event is in the
     event store, and events below the crash-time committed offset
     appear EXACTLY once (the store-dedup floor's no-duplicate half);
   - **analytics equivalence**: union(child's delivered matches,
     post-restore matches) == the golden match set — open windows,
     sessions and CEP stages crossed the kill;
   - **measured RTO**: ``recovery.restore_s`` / ``recovery.replay_s`` /
     ``recovery.replay_events`` gauges are exported by the restarted
     instance (reported per kill).

Usage, from the repository root::

    python3 tools/torch_crashrec_bench.py --smoke [--device cpu]
    python3 tools/torch_crashrec_bench.py --sweep 50 --seed 1234
    python3 tools/torch_crashrec_bench.py --json out.json --sweep 50

The default device is the card; ``--device cpu`` runs every child on the
CPU.  ``--smoke`` runs the six fixed kill points.  Exit status 0 = every
kill recovered clean.
"""

import argparse
import json
import os
import random
import shutil
import signal
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

WIDTH = 32
N_DEVICES = 8
N_PAYLOADS = 14
SAVE_EVERY = 4          # explicit checkpoint every K payloads
T0 = 1_754_000_000

# (crosspoint, hit count): where the child dies.  Counts are chosen so
# the point has certainly been reached mid-workload.
SMOKE_KILLS = [
    ("crash.mid_ring", 2),
    ("crash.mid_egress", 5),
    # kill a background SEAL WORKER mid-segment-write (the segment
    # store's parallel seal pool): boot must quarantine/ignore the torn
    # file and journal replay re-derives the job's rows — zero
    # committed-event loss, consistent catalog
    ("crash.mid_seal", 2),
    # kill between the merged compaction segment landing and the input
    # unlink: boot's tombstone resolution must drop the inputs (rows
    # appear exactly once), not double them
    ("crash.mid_compact", 1),
    ("crash.pre_manifest", 2),
    # kill a forward-spool sender between the spool poll and the peer
    # ack (a 2-host fleet in one process): the uncommitted spool tail
    # must replay to the owner on restart — at-least-once across the
    # DCN hop, no lost rows (runs through run_forward_kill_case)
    ("crash.mid_forward", 1),
]
SWEEP_CATALOG = {
    "crash.mid_ring": (1, 5),
    "crash.post_journal": (1, N_PAYLOADS - 1),
    "crash.mid_egress": (1, 10),
    "crash.mid_seal": (1, 4),
    "crash.mid_compact": (1, 2),
    "crash.mid_checkpoint": (1, 3),
    "crash.pre_manifest": (1, 3),
    "crash.mid_forward": (1, 3),
}

QUERY_DOCS = [
    {"kind": "window", "name": "hot-mean", "mtype": "temp", "agg": "mean",
     "op": "gt", "threshold": 20.0, "windowS": 60},
    {"kind": "session", "name": "chatty", "gapS": 30, "agg": "count",
     "op": "gt", "threshold": 10.0},
    {"kind": "pattern", "name": "spike", "windowS": 60,
     "steps": [{"eventType": "measurement", "mtype": "temp",
                "op": "gt", "threshold": 90.0}]},
]


def _config(data_dir):
    from sitewhere_tpu_torch.runtime.config import Config

    return Config({
        "instance": {"id": "crashrec", "data_dir": data_dir},
        "pipeline": {"width": WIDTH, "registry_capacity": 256,
                     "mtype_slots": 4, "deadline_ms": 5.0, "n_shards": 1,
                     "ring_depth": 2},
        "presence": {"scan_interval_s": 3600.0, "missing_after_s": 86400},
        "checkpoint": {"interval_s": 0},   # explicit saves: deterministic
        "registration": {"default_device_type": "sensor",
                         "allow_new_devices": True},
        # shedding would turn "zero loss" into "zero loss minus audited
        # sheds" — keep the contract sharp for the harness
        "overload": {"enabled": False},
        "slo": {"enabled": False},
    }, apply_env=False)


# the device every instance of this process runs on (``--device``)
DEVICE = None


def _make_instance(data_dir):
    from sitewhere_tpu_torch.instance import Instance

    return Instance(_config(data_dir), device=DEVICE)


def _payload(k):
    """Payload k: WIDTH NDJSON measurement lines, globally unique ts."""
    lines = []
    for r in range(WIDTH):
        i = k * WIDTH + r
        value = 100.0 if i % 7 == 0 else float(i % 50)
        lines.append(json.dumps({
            "deviceToken": f"d-{i % N_DEVICES}", "type": "Measurement",
            "request": {"name": "temp", "value": value,
                        "eventDate": T0 + i},
        }))
    return "\n".join(lines).encode()


def expected_events(data_dir):
    """(ts, value) for every durably journaled measurement row — the
    zero-loss reference set (opening the journal truncates any torn
    tail, which is exactly the not-yet-durable boundary)."""
    from sitewhere_tpu_torch.ingest.journal import Journal

    journal = Journal(data_dir, name="ingest")
    out = {}
    try:
        for _off, payload in journal.scan(0):
            for line in payload.split(b"\n"):
                try:
                    doc = json.loads(line)
                except ValueError:
                    continue
                req = doc.get("request") or {}
                if doc.get("type", "").lower() != "measurement":
                    continue
                out[int(req["eventDate"])] = float(req["value"])
    finally:
        journal.close()
    return out


def committed_offset(data_dir):
    try:
        with open(os.path.join(data_dir, "ingest", "pipeline.offset")) as f:
            return int(f.read().strip() or 0)
    except (OSError, ValueError):
        return 0


def attach_match_sink(inst, path):
    """File sink for analytics matches (STATE_CHANGE fan-out rows):
    line-flushed so rows survive a SIGKILL once written."""
    import numpy as np

    from sitewhere_tpu_torch.ids import NULL_ID
    from sitewhere_tpu_torch.outbound.connectors import CallbackConnector
    from sitewhere_tpu_torch.schema import EventType

    f = open(path, "a")

    def on_batch(cols, mask):
        et = np.asarray(cols["event_type"])
        rows = np.asarray(mask) & (et == int(EventType.STATE_CHANGE)) \
            & (np.asarray(cols["alert_code"]) == NULL_ID)
        for i in np.nonzero(rows)[0]:
            token = inst.identity.device.token_of(
                int(cols["device_id"][i])) or "?"
            f.write(json.dumps({
                "d": token, "ts": int(cols["ts_s"][i]),
                "v": round(float(cols["value"][i]), 4)}) + "\n")
        f.flush()

    inst.outbound.add_connector(
        CallbackConnector(connector_id="crashrec-matches", fn=on_batch))
    return f


def read_matches(path):
    out = set()
    try:
        with open(path) as f:
            for line in f:
                try:
                    doc = json.loads(line)
                except ValueError:
                    continue  # torn final line: its match replays
                out.add((doc["d"], doc["ts"], doc["v"]))
    except OSError:
        pass
    return out


def _ensure_model(inst):
    """Device model + queries, idempotent: present after a successful
    restore, recreated from scratch when the kill predates the anchor
    checkpoint's manifest commit (fresh-boot recovery path)."""
    if any(q["query"]["name"] == "hot-mean"
           for q in inst.analytics.list_queries()):
        return False
    dm = inst.device_management
    dm.create_device_type(token="sensor", name="Sensor")
    for i in range(N_DEVICES):
        dm.create_device(token=f"d-{i}", device_type="sensor")
        dm.create_device_assignment(device=f"d-{i}")
    for doc in QUERY_DOCS:
        inst.analytics.register(doc)
    return True


def run_child(data_dir, matches_path):
    """One instance life: register model + queries, drive the workload
    with periodic quiesced checkpoints.  Run under SW_CRASHPOINT this
    dies mid-flight; unarmed it stops cleanly (the golden run)."""
    inst = _make_instance(data_dir)
    sink = attach_match_sink(inst, matches_path)
    inst.start()
    _ensure_model(inst)
    # deterministic anchor: model + queries are snapshotted before any
    # traffic, so every kill point lands past a restorable generation
    inst.dispatcher.flush()
    inst.checkpointer.save()
    for k in range(N_PAYLOADS):
        inst.dispatcher.ingest_wire_lines(_payload(k), "crashrec")
        if (k + 1) % SAVE_EVERY == 0:
            # quiesce before the save so the snapshot's as-of offsets
            # only ever cover matches already durably in the sink file
            inst.dispatcher.flush()
            inst.analytics.drain()
            inst.outbound.drain()
            inst.checkpointer.save()
            # drive one background-compaction round mid-workload (the
            # interval loop is too slow for this harness), so the
            # crash.mid_compact crosspoint is certainly crossed
            compactor = getattr(inst.event_store, "compactor", None)
            if compactor is not None:
                compactor.run_once()
    inst.dispatcher.flush()
    inst.analytics.drain()
    inst.analytics.flush_live()
    inst.outbound.drain()
    inst.stop()
    inst.terminate()
    sink.close()


def verify(data_dir, matches_path, expected, committed_at_kill):
    """Restart on the survivor's data dir, COMPLETE the interrupted
    workload, and check the recovery contract; return (failures,
    report).  Completing the workload is what makes the golden
    comparison meaningful: restored + replayed + resumed must equal one
    uninterrupted run — events the child never journaled are not
    "lost", they simply haven't happened yet."""
    import numpy as np

    from sitewhere_tpu_torch.schema import EventType

    failures = []
    t0 = time.perf_counter()
    inst = _make_instance(data_dir)
    sink = attach_match_sink(inst, matches_path)
    restored = inst.restored
    inst.start()   # restore already ran in __init__; start replays
    try:
        if _ensure_model(inst):
            # killed before the anchor checkpoint committed: model +
            # queries recreated; re-run the whole journal through
            # analytics (offset 0; the store-dedup floor keeps
            # persistence exactly-once)
            inst.dispatcher.replay_journal(from_offset=0)
        # resume: each payload is ONE journal record, so a payload is
        # either fully journaled (replay re-derived it) or absent —
        # ingest the absent ones to finish the golden workload
        journaled = {(ts - T0) // WIDTH for ts in expected}
        for k in range(N_PAYLOADS):
            if k not in journaled:
                inst.dispatcher.ingest_wire_lines(_payload(k), "crashrec")
        inst.dispatcher.flush()
        inst.analytics.drain()
        inst.analytics.flush_live()
        inst.outbound.drain()
        inst.event_store.flush()

        # segment-catalog consistency: the restarted store's manifest
        # must be internally consistent (no dangling files, no
        # unresolved compaction tombstones, sorted scan order)
        verify_catalog = getattr(inst.event_store, "verify_catalog", None)
        if verify_catalog is not None:
            problems = verify_catalog()
            if problems:
                failures.append(
                    f"segment catalog inconsistent after restart: "
                    f"{problems[:3]}")

        stored = {}
        for cols in inst.event_store.iter_chunks():
            m = cols["event_type"] == int(EventType.MEASUREMENT)
            for ts, val in zip(np.asarray(cols["ts_s"])[m],
                               np.asarray(cols["value"])[m]):
                stored.setdefault(int(ts), []).append(float(val))

        lost = [ts for ts in expected if ts not in stored]
        if lost:
            failures.append(
                f"committed-event loss: {len(lost)} journaled events "
                f"missing from the store (e.g. ts={sorted(lost)[:5]})")
        missing = [ts for k in range(N_PAYLOADS) if k not in journaled
                   for ts in range(T0 + k * WIDTH, T0 + (k + 1) * WIDTH)
                   if ts not in stored]
        if missing:
            failures.append(
                f"resumed-workload loss: {len(missing)} re-ingested "
                f"events missing from the store")
        # the store-dedup half: rows committed BEFORE the kill sealed
        # before the offset did, and the recovery replay must not
        # re-append them.  (Rows ABOVE the committed offset may store
        # twice — that is exactly at-least-once.)
        dup = [ts for ts, vals in stored.items()
               if ts in expected and len(vals) > 1
               and (ts - T0) // WIDTH < committed_at_kill]
        if dup:
            failures.append(
                f"{len(dup)} events below the committed offset stored "
                f"more than once (store-dedup floor failed)")

        snap = inst.metrics.snapshot() if hasattr(inst.metrics,
                                                  "snapshot") else {}
        gauges = snap.get("gauges", {})
        report = {
            "restored": bool(restored),
            "committed_at_kill": committed_at_kill,
            "journaled_events": len(expected),
            "stored_events": sum(len(v) for v in stored.values()),
            "replayed": int(gauges.get("recovery.replay_events", 0)),
            "restore_s": round(float(
                gauges.get("recovery.restore_s", 0.0)), 4),
            "replay_s": round(float(
                gauges.get("recovery.replay_s", 0.0)), 4),
            "verify_wall_s": round(time.perf_counter() - t0, 3),
        }
        if "recovery.restore_s" not in gauges \
                and "recovery.replay_s" not in gauges:
            failures.append("recovery.* gauges missing from the "
                            "restarted instance's registry")
    finally:
        inst.stop()
        inst.terminate()
        sink.close()
    return failures, report


# ---------------------------------------------------------------------------
# crash.mid_forward: the forward-spool sender's kill window (2-host fleet)
# ---------------------------------------------------------------------------

FWD_PAYLOADS = 10
FWD_ROWS = 8


def _fwd_free_port():
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _forward_config(data_dir, ports, pid):
    from sitewhere_tpu_torch.runtime.config import Config

    return Config({
        "instance": {"id": f"crashfwd-{pid}", "data_dir": data_dir},
        "pipeline": {"width": 16, "registry_capacity": 128,
                     "mtype_slots": 4, "deadline_ms": 5.0, "n_shards": 1},
        "presence": {"scan_interval_s": 3600.0, "missing_after_s": 86400},
        "checkpoint": {"interval_s": 0},
        "analytics": {"enabled": False},
        "slo": {"enabled": False},
        "overload": {"enabled": False},
        # forwarded rows auto-register on the OWNER (no model setup)
        "registration": {"default_device_type": "sensor",
                         "allow_new_devices": True},
        "rpc": {
            "server": {"enabled": True, "host": "127.0.0.1",
                       "port": ports[pid]},
            "process_id": pid,
            "peers": [f"127.0.0.1:{p}" for p in ports],
            "forward_deadline_ms": 10.0,
            "heartbeat_interval_s": 0.2,
        },
        "security": {"jwt_secret": "crashfwd-secret"},
    }, apply_env=False)


def _forward_payload(k):
    lines = []
    for r in range(FWD_ROWS):
        i = k * FWD_ROWS + r
        lines.append(json.dumps({
            "deviceToken": f"f-{i % 6}", "type": "Measurement",
            "request": {"name": "temp", "value": float(i % 40),
                        "eventDate": T0 + i},
        }))
    return "\n".join(lines).encode()


def _forward_boot(root, ports):
    from sitewhere_tpu_torch.instance import Instance
    from sitewhere_tpu_torch.rpc.forward import owning_process
    from sitewhere_tpu_torch.services.common import DuplicateToken

    # owner (host 1) first so the sender's spool can drain into it
    insts = []
    for pid in (1, 0):
        inst = Instance(_forward_config(
            os.path.join(root, f"host{pid}"), ports, pid), device=DEVICE)
        # model BEFORE start(): the boot-time journal replay needs the
        # device type (and each host its own devices) already present
        dm = inst.device_management
        try:
            dm.create_device_type(token="sensor", name="Sensor")
        except DuplicateToken:
            pass
        for i in range(6):
            tok = f"f-{i}"
            if owning_process(tok, 2) != pid:
                continue
            try:
                dm.create_device(token=tok, device_type="sensor")
                dm.create_device_assignment(device=tok)
            except DuplicateToken:
                pass
        inst.start()
        insts.append(inst)
    insts.reverse()     # [host0, host1]
    return insts


def run_forward_child(root, ports):
    """One 2-host fleet life: every payload enters host 0's forwarder,
    remote rows spool and ship to host 1.  Under SW_CRASHPOINT=
    crash.mid_forward the whole process SIGKILLs in the sender's
    poll→send window; unarmed it drains and stops clean."""
    insts = _forward_boot(root, ports)
    for k in range(FWD_PAYLOADS):
        insts[0].forwarder.ingest_payload(_forward_payload(k),
                                          source_id="crashfwd")
        insts[0].forwarder.flush()
        time.sleep(0.02)
    insts[0].forwarder.flush(wait=True)
    for inst in insts:
        inst.dispatcher.flush()
        inst.stop()
        inst.terminate()


def _journal_rows(data_dir, name):
    """(ts → value) for every measurement row in one journal (forward
    spools store multi-line payloads; same NDJSON decode)."""
    from sitewhere_tpu_torch.ingest.journal import Journal

    out = {}
    path = os.path.join(data_dir, name)
    if not os.path.isdir(path):
        return out
    journal = Journal(data_dir, name=name)
    try:
        for _off, payload in journal.scan(0):
            for line in payload.split(b"\n"):
                try:
                    doc = json.loads(line)
                except ValueError:
                    continue
                if doc.get("type", "").lower() != "measurement":
                    continue
                req = doc.get("request") or {}
                out[int(req["eventDate"])] = float(req["value"])
    finally:
        journal.close()
    return out


def verify_forward(root, ports):
    """Reboot the 2-host fleet on the survivors' dirs and check the
    FORWARD contract: host 0's forwarder replays the uncommitted spool
    tail on start(), and every row that was durably SPOOLED toward
    host 1 lands in host 1's durable intake journal — at-least-once
    across the DCN hop (duplicates above the sender's committed cursor
    are legal, loss is not).  Store materialization past the journal is
    the other kill points' contract, not this one's."""
    failures = []
    # the spool's surviving content, read BEFORE the restart drains it
    expected = _journal_rows(os.path.join(root, "host0"), "forward-1")
    if not expected:
        failures.append("forward spool empty at the kill — the "
                        "crosspoint fired too early to test anything")
    t0 = time.perf_counter()
    insts = _forward_boot(root, ports)
    try:
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline \
                and insts[0].forwarder.pending_rows() > 0:
            insts[0].forwarder.flush()
            time.sleep(0.05)
        pending = insts[0].forwarder.pending_rows()
        if pending:
            failures.append(
                f"forward spool never drained after restart ({pending})")
        dead = int(insts[0].forwarder.dead_lettered)
        if dead:
            failures.append(
                f"{dead} rows dead-lettered during forward replay")
        for inst in insts:
            inst.dispatcher.flush()
    finally:
        for inst in insts:
            inst.stop()
            inst.terminate()
    # journals are closed now: read the owner's durable intake
    delivered = _journal_rows(os.path.join(root, "host1"), "ingest")
    lost = sorted(ts for ts in expected if ts not in delivered)
    if lost:
        failures.append(
            f"forward-replay loss: {len(lost)} spooled rows never "
            f"reached the owner's journal (e.g. ts={lost[:5]})")
    report = {
        "spooled_rows": len(expected),
        "owner_journal_rows": len(delivered),
        "spool_pending_after": pending,
        "verify_wall_s": round(time.perf_counter() - t0, 3),
    }
    return failures, report


def run_forward_kill_case(root, case, hits, child_cmd):
    data_dir = os.path.join(root, f"{case:03d}-crash-mid-forward-{hits}")
    os.makedirs(data_dir, exist_ok=True)
    ports = [_fwd_free_port(), _fwd_free_port()]
    env = dict(os.environ, SW_CRASHPOINT=f"crash.mid_forward:{hits}")
    proc = subprocess.run(
        child_cmd + ["--forward-child", data_dir,
                     "--ports", f"{ports[0]},{ports[1]}"],
        env=env, capture_output=True, timeout=300)
    killed = proc.returncode == -signal.SIGKILL
    failures = []
    if not killed:
        failures.append(
            f"forward child was not killed (rc={proc.returncode}): "
            f"{proc.stderr.decode(errors='replace')[-800:]}")
        return failures, {"killed": False}
    vfail, report = verify_forward(data_dir, ports)
    failures.extend(vfail)
    report["killed"] = killed
    return failures, report


def run_kill_case(root, case, point, hits, golden_matches, child_cmd):
    data_dir = os.path.join(
        root, f"{case:03d}-{point.replace('.', '-')}-{hits}")
    matches_child = os.path.join(data_dir, "matches-child.jsonl")
    matches_verify = os.path.join(data_dir, "matches-verify.jsonl")
    os.makedirs(data_dir, exist_ok=True)
    env = dict(os.environ, SW_CRASHPOINT=f"{point}:{hits}")
    proc = subprocess.run(
        child_cmd + ["--child", data_dir, "--matches", matches_child],
        env=env, capture_output=True, timeout=300)
    killed = proc.returncode == -signal.SIGKILL
    failures = []
    if not killed and proc.returncode != 0:
        failures.append(
            f"child failed without being killed (rc={proc.returncode}): "
            f"{proc.stderr.decode(errors='replace')[-800:]}")
        return failures, {"killed": False}
    committed = committed_offset(data_dir)
    expected = expected_events(data_dir)
    vfail, report = verify(data_dir, matches_verify, expected, committed)
    failures.extend(vfail)
    matches = read_matches(matches_child) | read_matches(matches_verify)
    missing = golden_matches - matches
    extra = matches - golden_matches
    if missing:
        failures.append(
            f"analytics divergence: {len(missing)} golden matches never "
            f"produced (e.g. {sorted(missing)[:3]})")
    if extra:
        failures.append(
            f"analytics divergence: {len(extra)} matches the golden run "
            f"never produced (e.g. {sorted(extra)[:3]})")
    report.update({
        "killed": killed,
        "matches": len(matches),
        "golden_matches": len(golden_matches),
    })
    return failures, report


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--child", metavar="DATA_DIR")
    parser.add_argument("--forward-child", metavar="DATA_DIR")
    parser.add_argument("--ports", default="")
    parser.add_argument("--matches", default="matches.jsonl")
    parser.add_argument("--smoke", action="store_true")
    parser.add_argument("--sweep", type=int, default=0)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--json", dest="json_out")
    parser.add_argument("--device", default=None,
                        help="cpu, or the card (the default)")
    args = parser.parse_args(argv)

    from sitewhere_tpu_torch.device import resolve_device

    global DEVICE
    DEVICE = resolve_device(args.device)
    if args.child:
        run_child(args.child, args.matches)
        return 0
    if args.forward_child:
        run_forward_child(args.forward_child,
                          [int(p) for p in args.ports.split(",")])
        return 0

    seed = args.seed if args.seed is not None \
        else random.SystemRandom().randrange(1 << 30)
    rng = random.Random(seed)
    if args.sweep:
        points = list(SWEEP_CATALOG)
        kills = [(p, rng.randint(*SWEEP_CATALOG[p]))
                 for p in (rng.choice(points) for _ in range(args.sweep))]
    else:
        kills = list(SMOKE_KILLS)

    child_cmd = [sys.executable, os.path.abspath(__file__),
                 "--device", str(DEVICE)]
    root = tempfile.mkdtemp(prefix="crashrec-")
    results = {"seed": seed, "kills": [], "ok": True}
    all_failures = []
    try:
        # golden reference: the uninterrupted run
        golden_dir = os.path.join(root, "golden")
        golden_matches_path = os.path.join(root, "matches-golden.jsonl")
        env = dict(os.environ)
        env.pop("SW_CRASHPOINT", None)
        proc = subprocess.run(
            child_cmd + ["--child", golden_dir,
                         "--matches", golden_matches_path],
            env=env, capture_output=True, timeout=300)
        if proc.returncode != 0:
            print(proc.stderr.decode(errors="replace")[-2000:],
                  file=sys.stderr)
            print("FAIL: golden run did not complete", file=sys.stderr)
            return 1
        golden_matches = read_matches(golden_matches_path)
        golden_events = expected_events(golden_dir)
        print(f"crashrec: seed={seed} golden: "
              f"{len(golden_events)} events, "
              f"{len(golden_matches)} matches")

        for case, (point, hits) in enumerate(kills):
            if point == "crash.mid_forward":
                # fleet-shaped case: its own 2-host child + verifier
                failures, report = run_forward_kill_case(
                    root, case, hits, child_cmd)
            else:
                failures, report = run_kill_case(
                    root, case, point, hits, golden_matches, child_cmd)
            report.update({"point": point, "hit": hits,
                           "failures": failures})
            results["kills"].append(report)
            all_failures.extend(f"{point}:{hits}: {f}" for f in failures)
            status = "ok" if not failures else "FAIL"
            print(f"  {point}:{hits}  killed={report.get('killed')} "
                  f"restored={report.get('restored')} "
                  f"replayed={report.get('replayed')} "
                  f"restore_s={report.get('restore_s')} "
                  f"replay_s={report.get('replay_s')}  {status}")
        killed_n = sum(1 for r in results["kills"] if r.get("killed"))
        restores = [r["restore_s"] for r in results["kills"]
                    if r.get("restore_s") is not None]
        results["summary"] = {
            "points": len(kills),
            "killed": killed_n,
            "golden_events": len(golden_events),
            "golden_matches": len(golden_matches),
            "restore_s_max": max(restores) if restores else None,
        }
        results["ok"] = not all_failures
        if args.json_out:
            with open(args.json_out, "w") as f:
                json.dump(results, f, indent=2)
        print(json.dumps(results["summary"], indent=2))
    finally:
        shutil.rmtree(root, ignore_errors=True)

    if all_failures:
        for f in all_failures:
            print(f"FAIL: {f}", file=sys.stderr)
        return 1
    print("crashrec: every kill recovered clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
