"""Streaming analytics on the port's wire path, against the JAX package's,
on the CPU.

The reference's golden world (``tests/test_streaming_analytics.py``
``TestGoldenEquivalence``): 3 devices, width 64, the same three queries
(a tumbling mean, a window-cross-then-alert pattern, a count session),
here over the golden lines plus a seeded stream whose values lie on a 1/8
grid.  The same NDJSON goes through the JAX ``Instance`` and the port's:

- the port's live matches equal the JAX instance's, and equal the port's
  ``run_retrospective`` over its sealed store;
- the ``analytics`` checkpoint section written by either package is
  restored by the other, operator state bitwise; the port restores a
  reference section in a process where ``jax`` and ``sitewhere_tpu``
  cannot be imported;
- a restart of the port instance restores the section and replays the
  journal from the floor: the rows already in the restored state are
  skipped row-exactly (``analytics.replay_rows_skipped``), and the
  matches equal an uninterrupted run's;
- the runner's worker evaluates on its own stream and fans out off it
  (CUDA streams mocked), and a default config composes the runner.
"""

import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from sitewhere_tpu_torch.analytics import query as port_query
from sitewhere_tpu_torch.analytics import runner as port_runner
from sitewhere_tpu_torch.analytics.runner import QueryRunner as PortRunner
from sitewhere_tpu_torch.instance import Instance as PortInstance
from sitewhere_tpu_torch.runtime.config import Config as PortConfig
from torch_parity import FakeStreams

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTH, CAP, DEVICES = 64, 256, 3
T0_MS = 1_753_800_000_000
QUERIES = (
    {"kind": "window", "name": "hot-mean", "mtype": "temp", "agg": "mean",
     "op": "gt", "threshold": 25.0, "windowS": 300},
    {"kind": "pattern", "name": "cross-then-alert", "windowS": 300,
     "crossOp": "gt", "crossThreshold": 25.0, "crossMtype": "temp",
     "steps": [{"windowCross": True},
               {"eventType": "alert", "withinS": 60}]},
    {"kind": "session", "name": "bursts", "gapS": 60, "agg": "count",
     "op": "gte", "threshold": 3.0},
)
NAMES = tuple(q["name"] for q in QUERIES)


def config(pkg, data_dir, **extra):
    tree = {
        "instance": {"id": "analytics-wire", "data_dir": str(data_dir)},
        "pipeline": {"width": WIDTH, "registry_capacity": CAP,
                     "mtype_slots": 4, "deadline_ms": 60_000.0,
                     "adaptive_deadline": False, "ring_depth": 0},
        "checkpoint": {"interval_s": 0},
        "events": {"compact_interval_s": 0},
        "tracing": {"sample_rate": 1.0},
        **extra,
    }
    if pkg == "jax":
        from sitewhere_tpu.runtime.config import Config

        tree["presence"] = {"scan_interval_s": 3600.0,
                            "missing_after_s": 1800}
        return Config(tree, apply_env=False)
    return PortConfig(tree, apply_env=False)


def make_instance(pkg, data_dir, **extra):
    if pkg == "jax":
        from sitewhere_tpu.instance import Instance
        from sitewhere_tpu.schema import AssignmentStatus

        inst = Instance(config(pkg, data_dir, **extra))
    else:
        from sitewhere_tpu_torch.schema import AssignmentStatus

        inst = PortInstance(config(pkg, data_dir, **extra), device="cpu")
    ident = inst.identity
    ident.tenant.mint("default")
    ident.mtype.mint("temp")
    ident.alert_type.mint("overheat")
    for d in range(DEVICES):
        dev = ident.device.mint(f"dev-{d}")
        inst.mirror.set_device_row(
            dev, active=True, tenant_id=0, device_type_id=0,
            assignment_id=d, assignment_status=int(AssignmentStatus.ACTIVE))
    return inst


def _line(kind, dev, t_s, value=None):
    if kind == "m":
        doc = {"deviceToken": f"dev-{dev}", "type": "DeviceMeasurements",
               "request": {"name": "temp", "value": value,
                           "eventDate": T0_MS + 1000 * t_s}}
    else:
        doc = {"deviceToken": f"dev-{dev}", "type": "DeviceAlert",
               "request": {"type": "overheat", "level": "warning",
                           "eventDate": T0_MS + 1000 * t_s}}
    return json.dumps(doc)


def payloads():
    """The golden lines, then 160 seeded lines over 1,500 s (values on a
    1/8 grid around 25, 10% alerts), in time order, 8 lines a payload."""
    golden = [("m", 0, 0, 20.0), ("m", 0, 10, 24.0), ("m", 0, 20, 40.0),
              ("a", 0, 50, None), ("m", 1, 0, 10.0), ("a", 1, 40, None),
              ("m", 0, 300, 10.0), ("m", 1, 310, 12.0)]
    rng = np.random.default_rng(20261016)
    ts = np.sort(rng.integers(400, 1900, 160))
    rows = [("a" if rng.random() < 0.1 else "m", int(rng.integers(0, 3)),
             int(t), float(rng.integers(-96, 97)) / 8 + 25.0) for t in ts]
    golden.sort(key=lambda r: r[2])
    lines = [_line(*r) for r in golden + rows]
    return ["\n".join(lines[i:i + 8]).encode()
            for i in range(0, len(lines), 8)]


def matches_of(runner):
    return {n: runner.recent_matches(n, limit=10_000) for n in NAMES}


def state_of(runner):
    return {n: runner._queries[n].compiled.export_state() for n in NAMES}


def run_package(pkg, root):
    inst = make_instance(pkg, root / pkg)
    inst.start()
    try:
        for q in QUERIES:
            inst.analytics.register(q)
        for p in payloads():
            inst.dispatcher.ingest_wire_lines(p)
            inst.dispatcher.flush()
        inst.analytics.drain(timeout_s=120.0)
        snapshot = inst.analytics.snapshot_state()
        state = state_of(inst.analytics)
        inst.analytics.flush_live()
        live = matches_of(inst.analytics)
        retro = {n: inst.analytics.run_retrospective(n)["matches"]
                 for n in NAMES}
        counters = inst.metrics.snapshot()["counters"]
        names = {s["name"] for s in inst.tracer.recent(2000)}
    finally:
        inst.stop()
        inst.terminate()
    return {"live": live, "retro": retro, "snapshot": snapshot,
            "state": state, "counters": counters, "spans": names}


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    root = tmp_path_factory.mktemp("analytics-wire")
    return {pkg: run_package(pkg, root) for pkg in ("jax", "torch")}


def test_live_matches_equal_the_reference(both):
    ref, got = both["jax"]["live"], both["torch"]["live"]
    assert got == ref
    for n in NAMES:
        assert got[n], n
    # the golden findings of the reference's test
    assert [m["device_id"] for m in got["cross-then-alert"]][:1] == [0]
    assert (0, 4) in [(m["device_id"], m["count"]) for m in got["bursts"]]


def _key(m):
    return m["ts_s"], m["device_id"], m["start_ts_s"]


def test_live_matches_equal_retrospective(both):
    """The same matches; each list is in its own batches' order (a later
    batch may finalize an earlier window), so they compare sorted."""
    got = both["torch"]
    for n in NAMES:
        assert sorted(got["live"][n], key=_key) == \
            sorted(got["retro"][n], key=_key), n
    counters = got["counters"]
    assert counters["analytics.live_batches"] > 0
    assert counters["analytics.live_dropped"] == 0
    for n in NAMES:
        assert counters[f"analytics.matches.{n}"] == 2 * len(got["live"][n])
    assert {"egress.analytics", "analytics.scan"} <= got["spans"]


def _assert_states_equal(a, b):
    assert sorted(a) == sorted(b)
    for n in a:
        assert sorted(a[n]) == sorted(b[n]), n
        for k in a[n]:
            x, y = np.asarray(a[n][k]), np.asarray(b[n][k])
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), (n, k)


def test_checkpoint_section_restores_across_packages(both):
    from sitewhere_tpu.analytics.runner import QueryRunner as RefRunner

    ref, got = both["jax"], both["torch"]
    _assert_states_equal(ref["state"], got["state"])
    resolve = {"temp": 0}.__getitem__
    # the reference's section, restored by the port
    payload, header = ref["snapshot"]
    port = PortRunner(CAP, resolve_mtype=resolve, device="cpu")
    assert port.restore_state(header, payload) == len(QUERIES)
    _assert_states_equal(ref["state"], state_of(port))
    assert port.replay_floor == header["as_of"] > 0
    # the port's section, restored by the reference
    payload, header = got["snapshot"]
    back = RefRunner(CAP, resolve_mtype=resolve)
    assert back.restore_state(header, payload) == len(QUERIES)
    _assert_states_equal(got["state"], state_of(back))
    assert type(back._queries["hot-mean"].spec).__module__ == \
        "sitewhere_tpu.analytics.query"


_PROBE = """
import json, sys
sys.modules["jax"] = None
sys.modules["sitewhere_tpu"] = None
from sitewhere_tpu_torch.analytics.runner import QueryRunner
payload = open(sys.argv[1], "rb").read()
header = json.loads(sys.argv[2])
r = QueryRunner(%d, resolve_mtype={"temp": 0}.__getitem__, device="cpu")
n = r.restore_state(header, payload)
state = {q: {k: v.tobytes().hex() for k, v in
             r._queries[q].compiled.export_state().items()}
         for q in sorted(r._queries)}
bad = sorted(m for m, v in sys.modules.items() if v is not None
             and (m.startswith("jax") or m == "sitewhere_tpu"
                  or m.startswith("sitewhere_tpu.")))
print(json.dumps([n, state, bad]))
""" % CAP


def test_port_restores_a_reference_section_without_the_reference(
        both, tmp_path):
    payload, header = both["jax"]["snapshot"]
    path = tmp_path / "analytics.section"
    path.write_bytes(payload)
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE, str(path), json.dumps(header)],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    n, state, bad = json.loads(proc.stdout.strip())
    assert n == len(QUERIES) and bad == []
    want = {q: {k: np.asarray(v).tobytes().hex() for k, v in arrs.items()}
            for q, arrs in both["jax"]["state"].items()}
    assert state == want


def test_section_refuses_other_reference_globals():
    from sitewhere_tpu_torch.analytics import checkpoint as ckpt

    plain = ckpt.loads(pickle.dumps({"x": np.arange(3)}, protocol=4))
    assert plain["x"].tolist() == [0, 1, 2]
    forged = (b"\x80\x04\x95\x00\x00\x00\x00\x00\x00\x00\x00\x8c\x16"
              b"sitewhere_tpu.instance\x94\x8c\x08Instance\x94\x93\x94.")
    with pytest.raises(pickle.UnpicklingError):
        ckpt.loads(forged)
    spec = port_query.parse_query(QUERIES[1])
    again = ckpt.loads(ckpt.dumps(spec))
    assert again == spec and type(again) is port_query.PatternQuery


def halt(inst):
    """Abandon an instance as a crash would: no flush of what is pending,
    no final save."""
    disp, store = inst.dispatcher, inst.event_store
    disp._stop.set()
    disp._thread.join(10)
    inst.analytics._stop.set()
    inst.analytics._thread.join(10)
    store._stop.set()
    store._flush_wake.set()
    store._flusher.join(10)
    store.sealer.stop()
    inst.ingest_journal.close()
    inst.dead_letters.close()


def test_restart_replays_from_the_floor_row_exactly(both, tmp_path):
    """Checkpoint after 4 of the payloads, ingest the rest, crash; the
    restart restores the section (its floor is the offset committed when
    the 4th payload was offered, with that record's rows applied), skips
    exactly the replayed rows already in the restored state, and finishes
    with the uninterrupted run's matches."""
    pays = payloads()
    inst = make_instance("torch", tmp_path)
    inst.start()
    for q in QUERIES:
        inst.analytics.register(q)
    for p in pays[:4]:
        inst.dispatcher.ingest_wire_lines(p)
        inst.dispatcher.flush()
    inst.analytics.drain(timeout_s=120.0)
    inst.checkpointer.save()
    before = matches_of(inst.analytics)
    applied = dict(inst.analytics._applied_partial)
    for p in pays[4:]:
        inst.dispatcher.ingest_wire_lines(p)
        inst.dispatcher.flush()
    inst.analytics.drain(timeout_s=120.0)
    halt(inst)

    again = make_instance("torch", tmp_path)
    try:
        assert again.restored
        runner = again.analytics
        assert runner.replay_floor == 3 and applied == {3: 8}
        assert again.checkpointer.replay_floor == 3
        again.start()
        runner.drain(timeout_s=120.0)
        skipped = again.metrics.counter("analytics.replay_rows_skipped").value
        assert skipped == 8
        runner.flush_live()
        after = matches_of(runner)
    finally:
        again.stop()
        again.terminate()
    control = both["torch"]["live"]
    for n in NAMES:
        assert sorted(before[n] + after[n], key=_key) == \
            sorted(control[n], key=_key), n



def test_worker_evaluates_on_its_stream_and_fans_out_off_it(
        tmp_path, monkeypatch):
    fakes = FakeStreams("dispatcher-stream")
    monkeypatch.setattr(port_runner, "_new_stream", lambda device: "runner")
    monkeypatch.setattr(torch.cuda, "stream", fakes.stream)
    monkeypatch.setattr(torch.cuda, "current_stream", fakes.current)
    seen = {"eval": [], "fanout": [], "step": []}
    real_eval = port_query.window_eval

    def eval_spy(*args, **kw):
        seen["eval"].append(torch.cuda.current_stream())
        return real_eval(*args, **kw)

    monkeypatch.setattr(port_query, "window_eval", eval_spy)

    class Outbound:
        def submit(self, cols, mask):
            seen["fanout"].append(torch.cuda.current_stream())

    inst = make_instance("torch", tmp_path)
    inst.analytics.outbound = Outbound()
    disp = inst.dispatcher
    real_step = disp._packed_step

    def step_spy(*args):
        seen["step"].append(torch.cuda.current_stream())
        return real_step(*args)

    inst.start()
    disp._packed_step = step_spy
    try:
        inst.analytics.register(QUERIES[0])
        for p in payloads()[:6]:
            disp.ingest_wire_lines(p)
        disp.flush()
        inst.analytics.drain(timeout_s=120.0)
        inst.analytics.flush_live()
    finally:
        inst.stop()
        inst.terminate()
    assert seen["eval"] and set(seen["eval"]) == {"runner"}
    assert seen["fanout"] and set(seen["fanout"]) == {"dispatcher-stream"}
    assert set(seen["step"]) == {"dispatcher-stream"}


def test_analytics_config_is_honoured(tmp_path):
    default = make_instance("torch", tmp_path / "a")
    try:
        assert default.analytics is not None
        assert default.dispatcher.analytics is default.analytics
        assert "analytics" in default.checkpointer._providers
    finally:
        default.terminate()
    off = make_instance("torch", tmp_path / "b",
                        analytics={"enabled": False, "queue_depth": 8})
    try:
        assert off.analytics is None and off.dispatcher.analytics is None
    finally:
        off.terminate()
    sized = make_instance("torch", tmp_path / "c",
                          analytics={"max_queries": 2, "max_matches": 7,
                                     "queue_depth": 3,
                                     "fanout_matches": False})
    try:
        a = sized.analytics
        assert (a.max_queries, a.max_matches, a._q.maxsize,
                a.fanout_matches) == (2, 7, 3, False)
    finally:
        sized.terminate()
