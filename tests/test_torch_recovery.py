"""Restart of the port's ``Instance`` after a crash, on the CPU.

The contract (``runtime/checkpoint.py``): restart = restore the newest
complete checkpoint, then replay the journal from each section's as-of
offset.  Checked here against an uninterrupted control run of the same
payloads:

- in process: the thread that crosses the crash point stops there (the
  crosspoint raises instead of killing), the instance is abandoned
  without its final checkpoint, then a fresh ``Instance`` opens the same
  data directory;
- a replay from a checkpoint's floor below the committed offset: every
  row re-runs its state effects, none is stored twice
  (``store_dedup_floor``), and the floor retires afterwards;
- real kills: a child process per crash point runs the workload with
  ``SW_CRASHPOINT=<point>:<n>`` armed and dies by SIGKILL; this process
  restarts on the survivor's directory and completes the workload.

Every case: no journaled row is lost, rows below the committed offset at
the crash are stored exactly once, the device state is bitwise equal to
the control run's, and the ``recovery.*`` gauges are exported.
"""

import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from sitewhere_tpu_torch.instance import Instance  # noqa: E402
from sitewhere_tpu_torch.runtime import faults  # noqa: E402
from sitewhere_tpu_torch.runtime.config import Config  # noqa: E402

CAP, WIDTH, M, DEVICES = 128, 64, 4, 100
N_PAYLOADS, SAVE_EVERY = 8, 2
T0_MS = 1_754_000_000_000
MEASUREMENT = 0


def config(root, ring_depth=0):
    return Config({
        "instance": {"id": "recovery", "data_dir": str(root)},
        "pipeline": {"width": WIDTH, "registry_capacity": CAP,
                     "mtype_slots": M, "deadline_ms": 60_000.0,
                     "adaptive_deadline": False, "ring_depth": ring_depth},
        "checkpoint": {"interval_s": 0},
        "events": {"compact_interval_s": 0, "shards": 4},
    }, apply_env=False)


def seed(inst):
    """Devices and a rule that never fires on this traffic (no derived
    alerts, so plans are the payloads whatever the timing)."""
    from sitewhere_tpu_torch.schema import AssignmentStatus, ComparisonOp

    inst.identity.tenant.mint("default")
    inst.identity.mtype.mint("temp")
    for i in range(DEVICES):
        d = inst.identity.device.mint(f"d-{i}")
        inst.mirror.set_device_row(
            d, active=True, tenant_id=0, device_type_id=i % 3,
            assignment_id=i, assignment_status=int(AssignmentStatus.ACTIVE))
    inst.rules.create_rule("temp", ComparisonOp.GT, 80.0, "hot",
                           token="r-hot")


def payload(k):
    """Payload k: WIDTH measurement lines, each with its own eventDate
    (the row's key); every 16th token unregistered."""
    lines = []
    for r in range(WIDTH):
        i = k * WIDTH + r
        tok = f"x-{i}" if i % 16 == 5 else f"d-{(i * 7) % DEVICES}"
        lines.append(json.dumps({
            "deviceToken": tok, "type": "DeviceMeasurements",
            "request": {"name": "temp", "value": 20.0 + (i % 200) / 10,
                        "eventDate": T0_MS + 1000 * i}}))
    return "\n".join(lines).encode()


def row_key(i):
    return (T0_MS + 1000 * i) // 1000


REGISTERED = {row_key(k * WIDTH + r) for k in range(N_PAYLOADS)
              for r in range(WIDTH) if (k * WIDTH + r) % 16 != 5}


def run_workload(inst, payloads=range(N_PAYLOADS)):
    """The child's life: anchor checkpoint, payloads with a quiesced
    checkpoint every SAVE_EVERY, then a clean stop."""
    inst.dispatcher.flush()
    inst.checkpointer.save()
    for k in payloads:
        inst.dispatcher.ingest_wire_lines(payload(k))
        if (k + 1) % SAVE_EVERY == 0:
            inst.dispatcher.flush()
            inst.checkpointer.save()
    inst.dispatcher.flush()


def stored_counts(inst):
    """ts_s -> times stored, over the measurement rows."""
    out = {}
    for cols in inst.event_store.iter_chunks():
        m = np.asarray(cols["event_type"]) == MEASUREMENT
        for ts in np.asarray(cols["ts_s"])[m].tolist():
            out[ts] = out.get(ts, 0) + 1
    return out


def journaled_payloads(root):
    """The payload indices whose record survived in the journal."""
    from sitewhere_tpu_torch.ingest.journal import Journal

    journal = Journal(str(root), name="ingest")
    try:
        out = set()
        for _, p in journal.scan(0):
            first = json.loads(p.split(b"\n", 1)[0])
            out.add((first["request"]["eventDate"] - T0_MS) // 1000 // WIDTH)
        return out
    finally:
        journal.close()


def committed_offset(root):
    try:
        with open(os.path.join(root, "ingest", "pipeline.offset")) as f:
            return int(f.read().strip() or 0)
    except OSError:
        return 0


def halt(inst):
    """Abandon an instance as a crash would: no flush, no final save.  Its
    threads are joined, so none writes into the directory the restart
    opens."""
    disp, store = inst.dispatcher, inst.event_store
    disp._stop.set()
    disp._thread.join(10)
    store._stop.set()
    store._flush_wake.set()
    store._flusher.join(10)
    store.sealer.stop()
    inst.ingest_journal.close()
    inst.dead_letters.close()


def restart_and_complete(root, ring_depth, committed_at_crash):
    """Restart on the survivor's directory, ingest the payloads that never
    reached the journal, and check the recovery contract.  Returns the
    restarted instance's host state and gauges."""
    journaled = journaled_payloads(root)
    inst = Instance(config(root, ring_depth), device="cpu")
    assert inst.restored
    inst.start()
    try:
        for k in range(N_PAYLOADS):
            if k not in journaled:
                inst.dispatcher.ingest_wire_lines(payload(k))
        inst.dispatcher.flush()
        counts = stored_counts(inst)
        lost = REGISTERED - set(counts)
        assert not lost, f"{len(lost)} journaled rows lost"
        assert set(counts) == REGISTERED
        below = {row_key(k * WIDTH + r) for k in range(committed_at_crash)
                 for r in range(WIDTH)} & REGISTERED
        twice = [ts for ts in below if counts[ts] != 1]
        assert not twice, f"{len(twice)} committed rows stored twice"
        assert inst.event_store.verify_catalog() == []
        assert inst.dispatcher.store_dedup_floor == 0
        gauges = inst.metrics.snapshot()["gauges"]
        for g in ("recovery.restore_s", "recovery.replay_s",
                  "recovery.replay_events"):
            assert g in gauges, g
        return inst.device_state.snapshot_host(), gauges
    finally:
        inst.stop()
        inst.terminate()


def assert_state_bitwise(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].tobytes() == b[k].tobytes(), k


@pytest.fixture(scope="module")
def control(tmp_path_factory):
    """The uninterrupted run's device state (ring off; the ring gives the
    same state, tests/test_torch_dispatcher.py)."""
    root = tmp_path_factory.mktemp("control")
    inst = Instance(config(root), device="cpu")
    seed(inst)
    inst.start()
    run_workload(inst)
    counts = stored_counts(inst)
    assert set(counts) == REGISTERED and set(counts.values()) == {1}
    state = inst.device_state.snapshot_host()
    inst.stop()
    inst.terminate()
    return state


# -- in process ---------------------------------------------------------------


class Died(Exception):
    """The armed crash point was crossed (in-process stand-in for the
    SIGKILL: the thread that crossed it goes no further)."""


@pytest.mark.parametrize("point,ring_depth", [("crash.mid_ring", 2),
                                              ("crash.mid_egress", 0),
                                              ("crash.post_journal", 0)])
def test_restart_after_a_crash_window_restores_and_replays(
        tmp_path, control, monkeypatch, point, ring_depth):
    root = tmp_path / "data"
    a = Instance(config(root, ring_depth), device="cpu")
    seed(a)
    a.start()
    run_workload(a, range(4))                  # committed: payloads 0-3
    committed = a.dispatcher.journal_reader.committed
    assert committed == 4
    crossed = []

    def crosspoint(p):
        if p == point:
            crossed.append(p)
            raise Died(p)

    monkeypatch.setattr(faults, "crosspoint", crosspoint)
    d = a.dispatcher
    for step in (lambda: d.ingest_wire_lines(payload(4)),
                 lambda: d.ingest_wire_lines(payload(5)),
                 lambda: d._run_plans(d._take(a.batcher.flush)),
                 d._flush_ring, d._drain_inflight):
        try:
            step()
        except Died:
            pass
    assert crossed, f"{point} is not on the path"
    assert d.journal_reader.committed == committed
    assert a.ingest_journal.end_offset == 6
    halt(a)
    monkeypatch.undo()
    state, gauges = restart_and_complete(root, ring_depth, committed)
    assert gauges["recovery.replay_events"] == 2 * WIDTH
    assert_state_bitwise(state, control)


def test_replay_from_a_floor_below_the_committed_offset(tmp_path, control):
    """The newest checkpoint is older than the committed offset: replay
    starts at its floor, re-runs the state effects of committed records
    without storing them again, and retires the dedup floor."""
    root = tmp_path / "data"
    a = Instance(config(root), device="cpu")
    seed(a)
    a.start()
    run_workload(a, range(2))                  # checkpoint as of offset 2
    for k in (2, 3, 4):
        a.dispatcher.ingest_wire_lines(payload(k))
    a.dispatcher.flush()                       # committed 5, no checkpoint
    assert a.dispatcher.journal_reader.committed == 5
    halt(a)
    b = Instance(config(root), device="cpu")
    assert b.checkpointer.replay_floor == 2
    b.start()
    try:
        assert b.metrics.snapshot()["gauges"][
            "recovery.replay_events"] == 3 * WIDTH
        assert b.dispatcher.store_dedup_floor == 0
        counts = stored_counts(b)
        assert set(counts.values()) == {1}
        for k in range(5, N_PAYLOADS):
            b.dispatcher.ingest_wire_lines(payload(k))
        b.dispatcher.flush()
        assert set(stored_counts(b)) == REGISTERED
        assert_state_bitwise(b.device_state.snapshot_host(), control)
    finally:
        b.stop()
        b.terminate()


# -- real kills ---------------------------------------------------------------------

KILLS = [("crash.post_journal", 5, 0), ("crash.mid_egress", 4, 0),
         ("crash.mid_ring", 2, 2), ("crash.mid_seal", 3, 0),
         ("crash.pre_manifest", 3, 0)]


def child_main(root, ring_depth):
    inst = Instance(config(root, ring_depth), device="cpu")
    seed(inst)
    inst.start()
    run_workload(inst)
    inst.stop()
    inst.terminate()


@pytest.fixture(scope="module")
def killed(tmp_path_factory):
    """One child per kill point, all started together; each result is
    (data dir, ring depth, return code, stderr tail)."""
    root = tmp_path_factory.mktemp("kills")
    procs = {}
    for point, hits, ring in KILLS:
        d = root / f"{point}-{hits}"
        env = dict(os.environ, SW_CRASHPOINT=f"{point}:{hits}",
                   PYTHONPATH=REPO)
        procs[point] = (d, ring, subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--child", str(d),
             str(ring)], env=env, stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE))
    out = {}
    for point, (d, ring, proc) in procs.items():
        _, err = proc.communicate(timeout=240)
        out[point] = (d, ring, proc.returncode, err.decode()[-2000:])
    return out


@pytest.mark.parametrize("point", [k[0] for k in KILLS])
def test_kill_at_a_crash_point_loses_no_committed_event(killed, control,
                                                        point):
    d, ring, rc, err = killed[point]
    assert rc == -signal.SIGKILL, f"child exited {rc}: {err}"
    state, gauges = restart_and_complete(d, ring, committed_offset(d))
    assert_state_bitwise(state, control)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        child_main(sys.argv[2], int(sys.argv[3]))


def test_replay_dead_letters_an_out_of_int32_event_date(tmp_path):
    """A journal record whose eventDate is finite but outside int32 (one
    written before the live decode refused such dates): the restart's
    replay dead-letters that record, as the scalar decoder refuses it,
    replays the records around it, and the boot completes.  (The
    reference's replay aborts here; it is not run.)"""
    from sitewhere_tpu_torch.ingest.journal import Journal

    bad = json.dumps({
        "deviceToken": "d-1", "type": "DeviceMeasurements",
        "request": {"name": "temp", "value": 21.5,
                    "eventDate": 10 ** 13}}).encode()   # 1e10 s
    journal = Journal(str(tmp_path), name="ingest")
    for record in (payload(0), bad, payload(1)):
        journal.append(record)
    journal.close()
    inst = Instance(config(tmp_path), device="cpu")
    seed(inst)
    inst.start()
    try:
        assert inst.dispatcher.journal_reader.committed == 3
        gauges = inst.metrics.snapshot()["gauges"]
        assert gauges["recovery.replay_events"] == 2 * WIDTH
        counts = stored_counts(inst)
        assert set(counts) == {row_key(k * WIDTH + r) for k in (0, 1)
                               for r in range(WIDTH)} & REGISTERED
        assert set(counts.values()) == {1}
    finally:
        inst.stop()
        inst.terminate()
    letters = Journal(str(tmp_path), name="dead-letters")
    try:
        docs = [json.loads(p) for _, p in letters.scan(0)]
    finally:
        letters.close()
    decode = [d for d in docs if d["kind"] == "failed-decode"]
    assert len(decode) == 1
    assert decode[0]["source"] == "journal-replay"
    assert bytes.fromhex(decode[0]["payload"]) == bad
    assert "eventDate" in decode[0]["error"]
