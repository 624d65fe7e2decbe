"""Outbound connectors, search and the egress outbound leg in the port,
against the reference.

- The reference's own ``tests/test_outbound.py``, ``test_analytics.py``'s
  ``TestEventTap`` and ``test_streaming_analytics.py``'s match fan-out
  case run on the port (``tests/torch_parity.py port_test_module``).
- Cross-package parity on the same seeded columns: the filter masks,
  ``marshal_row``'s JSON (string for string), the ``CircuitBreaker``'s
  states under one outcome sequence and clock, and the
  ``IndexPushConnector``'s bulk bodies.
- The egress leg: persist, then outbound, then analytics and rules; the
  view handed to outbound no longer holds the step output, with the
  store and without it.  A stopped worker drops what is still queued, in
  both packages.
- One seeded NDJSON traffic through the JAX ``Instance`` and the port
  ``Instance`` on the CPU, each with a callback, a file, an HTTP and an
  index-push connector (to a loopback server) and an MQTT connector (to a
  fake client): equal deliveries per connector, ``outbound_rows``, the
  STATE_CHANGE rows one forced presence sweep stores, search results,
  and stream contents and dead letters.
"""

from __future__ import annotations

import http.server
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from sitewhere_tpu.outbound import connectors as jconn
from sitewhere_tpu.outbound import filters as jfilt
from sitewhere_tpu.outbound import manager as jman
from sitewhere_tpu.runtime import resilience as jres
from sitewhere_tpu_torch.outbound import connectors as tconn
from sitewhere_tpu_torch.outbound import filters as tfilt
from sitewhere_tpu_torch.outbound import manager as tman
from sitewhere_tpu_torch.runtime import resilience as tres
from torch_parity import (
    port_cases,
    port_test_module,
    reference_cases,
    run_port_case,
)

torch.set_num_threads(1)
TESTS = os.path.dirname(os.path.abspath(__file__))

# -- the reference's own cases ------------------------------------------------

OUTBOUND_REF = os.path.join(TESTS, "test_outbound.py")
OUTBOUND_CASES = reference_cases(OUTBOUND_REF)


@pytest.fixture(scope="module")
def outbound_ns():
    return port_test_module(OUTBOUND_REF)


def test_the_port_runs_every_reference_outbound_case():
    assert len(OUTBOUND_CASES) == 8


@pytest.mark.parametrize("case", OUTBOUND_CASES)
def test_reference_outbound_case_on_the_port(outbound_ns, case, tmp_path):
    run_port_case(outbound_ns, case, tmp_path)


def test_reference_event_tap_on_the_port(tmp_path):
    ns = port_test_module(os.path.join(TESTS, "test_analytics.py"))
    cases = port_cases(ns)
    assert "TestEventTap.test_tap_accumulates_outbound_batches" in cases
    run_port_case(ns, "TestEventTap.test_tap_accumulates_outbound_batches",
                  tmp_path)


def test_reference_match_fanout_on_the_port(tmp_path):
    ns = port_test_module(os.path.join(TESTS, "test_streaming_analytics.py"))
    inst = ns["_make_instance"](tmp_path)
    try:
        run_port_case(ns, "TestGoldenEquivalence."
                      "test_match_fanout_through_outbound", tmp_path,
                      fixtures={"inst": inst})
    finally:
        inst.stop()
        inst.terminate()


# -- the same columns through both packages ------------------------------------

def _cols(seed: int, n: int = 256):
    rng = np.random.default_rng(seed)
    i32 = lambda lo, hi: rng.integers(lo, hi, n).astype(np.int32)  # noqa: E731
    f32 = lambda s: (rng.standard_normal(n) * s).astype(np.float32)  # noqa: E731
    return {
        "device_id": i32(0, 64), "tenant_id": i32(-1, 4),
        "event_type": i32(0, 7), "ts_s": i32(1_700_000_000, 1_700_100_000),
        "ts_ns": i32(0, 10**9), "mtype_id": i32(-1, 8), "value": f32(1e3),
        "lat": f32(90), "lon": f32(180), "elevation": f32(1e4),
        "alert_code": i32(-1, 50), "alert_level": i32(0, 4),
        "command_id": i32(-1, 10), "area_id": i32(-1, 6),
        "customer_id": i32(-1, 6), "asset_id": i32(-1, 6),
        "assignment_id": i32(-1, 64), "device_type_id": i32(-1, 5),
    }


def _filters(mod):
    return [mod.AreaFilter([1, 3]), mod.AreaFilter([1, 3], include=True),
            mod.DeviceTypeFilter([0], include=True),
            mod.DeviceTypeFilter([2, 4]),
            mod.DeviceFilter(list(range(0, 64, 3)), include=True),
            mod.DeviceFilter([5, 9, 11]),
            mod.EventTypeFilter([2], include=True),
            mod.EventTypeFilter([0, 1]),
            mod.CallbackFilter(lambda c: c["value"] > 0)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_filter_masks_equal_across_packages(seed):
    cols = _cols(seed)
    base = np.random.default_rng(seed + 100).random(256) < 0.8
    for jf, tf in zip(_filters(jfilt), _filters(tfilt)):
        np.testing.assert_array_equal(jf(cols), tf(cols))
    for k in range(1, 5):
        np.testing.assert_array_equal(
            jfilt.apply_filters(_filters(jfilt)[:k], cols, base),
            tfilt.apply_filters(_filters(tfilt)[:k], cols, base))


def test_event_type_names_equal_across_packages():
    assert tconn._EVENT_TYPE_NAMES == jconn._EVENT_TYPE_NAMES


@pytest.mark.parametrize("seed", [0, 3])
def test_marshal_row_json_equal_across_packages(seed):
    from sitewhere_tpu.ids import IdentityMap as JaxIds
    from sitewhere_tpu_torch.ids import IdentityMap as PortIds

    cols = _cols(seed)
    ids = {}
    for pkg, cls in (("jax", JaxIds), ("torch", PortIds)):
        ids[pkg] = cls(capacity=64)
        for d in range(0, 64, 2):          # every other device has a token
            ids[pkg].device.mint(f"dev-{d}")
    partial = {k: v for k, v in cols.items() if k != "asset_id"}
    for c in (cols, partial):
        for identity in (None, "ids"):
            want = [json.dumps(jconn.marshal_row(
                c, r, ids["jax"] if identity else None)) for r in range(256)]
            got = [json.dumps(tconn.marshal_row(
                c, r, ids["torch"] if identity else None)) for r in range(256)]
            assert got == want


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _breaker_trace(mod, outcomes):
    clock = _Clock()
    metrics = mod.global_registry().__class__()
    b = mod.CircuitBreaker("parity", window=8, failure_threshold=0.5,
                           min_calls=4, open_for_s=2.0, half_open_probes=2,
                           clock=clock, metrics=metrics)
    seen = []
    for step, outcome in enumerate(outcomes):
        clock.t += 0.25
        allowed = b.allow()
        if allowed:
            (b.record_failure if outcome else b.record_success)()
        seen.append((step, allowed, b.state, b.shed, b.transitions))
    for op in ("call-ok", "call-fail"):
        clock.t += 3.0
        try:
            b.call(lambda: (_ for _ in ()).throw(ValueError("x"))
                   if op == "call-fail" else 1)
            seen.append((op, b.state))
        except mod.BreakerOpen:
            seen.append((op, "shed"))
        except ValueError:
            seen.append((op, "raised", b.state))
    return seen


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_circuit_breaker_states_equal_across_packages(seed):
    outcomes = (np.random.default_rng(seed).random(80)
                < [0.2, 0.5, 0.8, 0.65][seed]).tolist()
    want = _breaker_trace(jres, outcomes)
    assert _breaker_trace(tres, outcomes) == want
    assert any(s[2] == "open" for s in want if len(s) == 5)


def _index_bodies(conns, filters, statuses):
    """The bulk bodies one IndexPushConnector POSTs, over seeded batches
    and a scripted sequence of answers."""
    bodies, answers = [], list(statuses)
    conn = conns.IndexPushConnector(
        "idx", "http://127.0.0.1:9/bulk", bulk_rows=40,
        bulk_interval_s=3600, backoff_s=0.0, max_buffer_rows=150,
        filters=[filters.EventTypeFilter([6], include=False)])

    def fake_post(body, headers):
        bodies.append(body)
        return answers.pop(0) if answers else 200

    conn._post = fake_post
    for seed in range(6):
        cols = _cols(seed, 64)
        conn.process_batch(cols, np.ones(64, bool))
    conn._flush(force=True)
    return bodies, conn.indexed, conn.dropped, conn.errors


def test_index_push_bulk_bodies_equal_across_packages():
    statuses = [200, 503, 500, 200, 200, 500, 200]
    want = _index_bodies(jconn, jfilt, statuses)
    assert _index_bodies(tconn, tfilt, statuses) == want
    assert want[2] > 0 and want[3] == 3    # overflow drops, failed bulks


def _shutdown_drops_queue(man, conns):
    gate, started = threading.Event(), threading.Event()
    delivered = []

    def slow(cols, mask):
        started.set()
        gate.wait(5)
        delivered.append(int(mask.sum()))

    mgr = man.OutboundConnectorsManager(
        [conns.CallbackConnector("slow", slow)], queue_depth=8)
    mgr.start()
    cols = _cols(0, 16)
    for _ in range(5):
        mgr.submit(cols, np.ones(16, bool))
    assert started.wait(5)
    worker = mgr._workers["slow"]
    stopper = threading.Thread(target=mgr.stop)
    stopper.start()
    deadline = time.monotonic() + 5
    while not worker._stop.is_set() and time.monotonic() < deadline:
        time.sleep(0.005)
    gate.set()
    stopper.join(10)
    assert not stopper.is_alive()
    return delivered, mgr.stats()["slow"]["processed"]


def test_stopped_worker_drops_what_is_queued_in_both_packages():
    """``_Worker._loop`` exits on its stop flag and does not drain its
    queue (the reference's behaviour; an Instance's caller drains first)."""
    want = _shutdown_drops_queue(jman, jconn)
    assert _shutdown_drops_queue(tman, tconn) == want == ([16], 16)


# -- the egress leg -------------------------------------------------------------

def _port_instance(tmp_path, **extra):
    from sitewhere_tpu_torch.runtime.config import Config
    from torch_parity import CpuInstance

    tree = {
        "instance": {"id": "outbound-parity", "data_dir": str(tmp_path)},
        "pipeline": {"width": 64, "registry_capacity": 256,
                     "mtype_slots": 4, "deadline_ms": 5.0, "ring_depth": 0},
        "presence": {"scan_interval_s": 3600.0, "missing_after_s": 1800},
        "checkpoint": {"interval_s": 0},
        "events": {"compact_interval_s": 0},
        "slo": {"enabled": False},
        "overload": {"enabled": False},
    }
    tree.update(extra)
    return CpuInstance(Config(tree, apply_env=False))


def _devices(inst, n):
    """``n`` assigned devices of one type, made in order (so both
    packages mint the same dense ids)."""
    dm = inst.device_management
    dm.create_device_type(token="sensor", name="Sensor")
    tokens = [f"dev-{i}" for i in range(n)]
    for t in tokens:
        dm.create_device(token=t, device_type="sensor")
        dm.create_device_assignment(device=t)
    return tokens


def _lines(rng, tokens, n, t0):
    out = []
    for i in range(n):
        tok = tokens[int(rng.integers(len(tokens)))]
        ts = t0 + i
        kind = rng.random()
        if kind < 0.6:
            out.append({"deviceToken": tok, "type": "Measurement",
                        "request": {"name": ["temp", "hum"][i % 2],
                                    "value": float(rng.integers(0, 400)) / 8,
                                    "eventDate": ts}})
        elif kind < 0.9:
            out.append({"deviceToken": tok, "type": "Location",
                        "request": {"latitude": float(rng.integers(-80, 80)),
                                    "longitude": float(rng.integers(-170,
                                                                    170)),
                                    "elevation": 5.0, "eventDate": ts}})
        else:
            out.append({"deviceToken": tok, "type": "Alert",
                        "request": {"type": "overheat", "level": "warning",
                                    "message": "hot", "eventDate": ts}})
    return "\n".join(json.dumps(d) for d in out).encode()


@pytest.mark.parametrize("store", [True, False])
def test_egress_releases_the_view_and_keeps_the_reference_order(tmp_path,
                                                                store):
    inst = _port_instance(tmp_path)
    disp = inst.dispatcher
    order, views = [], []
    if not store:
        disp.event_store = None
    else:
        real_append = inst.event_store.append_columns

        def append_spy(cols, mask=None):
            order.append("persist")
            return real_append(cols, mask=mask)

        inst.event_store.append_columns = append_spy
    real_submit = inst.outbound.submit

    def submit_spy(cols, mask, **kw):
        if threading.current_thread().name.startswith("analytics"):
            return real_submit(cols, mask, **kw)
        order.append("outbound")
        # the step output is released before the view is handed on
        views.append(getattr(cols, "_out", "not-a-view") is None)
        return real_submit(cols, mask, **kw)

    inst.outbound.submit = submit_spy
    real_live = inst.analytics.submit_live
    inst.analytics.submit_live = lambda *a, **kw: (
        order.append("analytics"), real_live(*a, **kw))[1]
    real_rules = inst.rule_engine.submit_live
    inst.rule_engine.submit_live = lambda *a, **kw: (
        order.append("rules"), real_rules(*a, **kw))[1]
    inst.start()
    try:
        tokens = _devices(inst, 20)
        disp.ingest_wire_lines(_lines(np.random.default_rng(5), tokens, 150,
                                      1_700_000_000))
        disp.flush()
    finally:
        inst.stop()
        inst.terminate()
    legs = (["persist"] if store else []) + ["outbound", "analytics",
                                             "rules"]
    n_plans = len(views)
    assert n_plans >= 3 and all(views)
    assert order == legs * n_plans


# -- one traffic through both Instances -------------------------------------------

class _Capture(http.server.BaseHTTPRequestHandler):
    bodies: dict = {}
    lock = threading.Lock()

    def do_POST(self):  # noqa: N802
        body = self.rfile.read(int(self.headers["Content-Length"]))
        with self.lock:
            self.bodies.setdefault(self.path, []).append(body)
        self.send_response(200)
        self.send_header("Content-Length", "0")
        self.end_headers()

    def log_message(self, *args):
        pass


class _FakeMqtt:
    def __init__(self):
        self.published = []
        self.lock = threading.Lock()

    def publish(self, topic, payload, qos=0):
        with self.lock:
            self.published.append((topic, payload))


def _reference_instance(tmp_path):
    from sitewhere_tpu.instance import Instance
    from sitewhere_tpu.runtime.config import Config

    tree = {
        "instance": {"id": "outbound-parity", "data_dir": str(tmp_path)},
        "pipeline": {"width": 64, "registry_capacity": 256,
                     "mtype_slots": 4, "deadline_ms": 5.0, "n_shards": 1,
                     "ring_depth": 0},
        "presence": {"scan_interval_s": 3600.0, "missing_after_s": 1800},
        "checkpoint": {"interval_s": 0},
        "events": {"compact_interval_s": 0},
        "slo": {"enabled": False},
        "overload": {"enabled": False},
    }
    return Instance(Config(tree, apply_env=False))


def _stream_lines():
    import base64

    docs = [{"deviceToken": "dev-0", "type": "DeviceStream",
             "request": {"streamId": "clip", "contentType": "video/mp4"}}]
    docs += [{"deviceToken": "dev-0", "type": "StreamData",
              "request": {"streamId": "clip", "sequenceNumber": s,
                          "data": base64.b64encode(bytes([s]) * 3).decode()}}
             for s in (2, 0, 1)]
    docs += [{"deviceToken": "dev-1", "type": "StreamData",
              "request": {"streamId": "nope", "sequenceNumber": 0,
                          "data": "AA=="}},
             {"deviceToken": "dev-0", "type": "SendStreamData",
              "request": {"streamId": "clip", "sequenceNumber": 1}}]
    return "\n".join(json.dumps(d) for d in docs).encode()


def _run_instance(pkg, root, port, seed=11):
    if pkg == "jax":
        from sitewhere_tpu.services.common import SearchCriteria
        from sitewhere_tpu.schema import EventType

        inst, conn, filt = _reference_instance(root), jconn, jfilt
    else:
        from sitewhere_tpu_torch.services.common import SearchCriteria
        from sitewhere_tpu_torch.schema import EventType

        inst, conn, filt = _port_instance(root), tconn, tfilt
    rows, mqtt = [], _FakeMqtt()
    lock = threading.Lock()

    def on_batch(cols, mask):
        with lock:
            rows.extend(zip(*(np.asarray(cols[k])[mask].tolist() for k in
                              ("device_id", "event_type", "ts_s", "value",
                               "alert_code", "area_id", "tenant_id"))))

    url = f"http://127.0.0.1:{port}/{pkg}"
    connectors = [
        conn.CallbackConnector("tap", on_batch),
        conn.FileConnector("file", str(root / "out" / "events.jsonl"),
                           identity=inst.identity,
                           filters=[filt.EventTypeFilter([2],
                                                         include=True)]),
        conn.HttpConnector("hook", url + "/hook", identity=inst.identity,
                           filters=[filt.DeviceFilter(range(0, 40, 2),
                                                      include=True)]),
        conn.IndexPushConnector("index", url + "/index", bulk_rows=50,
                                bulk_interval_s=0.1),
        conn.MqttOutboundConnector(
            "mqtt", mqtt, identity=inst.identity,
            multicaster=lambda doc: (["alerts", "all"]
                                     if doc["eventType"] == "alert"
                                     else ["all"]),
            route_builder=lambda route, doc: f"sw/{route}/{doc['deviceId']}",
            filters=[filt.DeviceFilter(range(0, 40, 5), include=True)]),
    ]
    # attached before start(): the instance's lifecycle starts and stops
    # each connector (the index's interval flusher and final flush)
    for c in connectors:
        inst.outbound.add_connector(c)
    inst.start()
    try:
        dm = inst.device_management
        tokens = _devices(inst, 40)
        rng = np.random.default_rng(seed)
        t0 = 1_700_000_000
        for p in range(4):
            inst.dispatcher.ingest_wire_lines(
                _lines(rng, tokens[:36], 120, t0 + 1000 * p))
        inst.dispatcher.flush()
        inst.outbound.drain(10)
        # one forced sweep: the 36 devices with events go missing
        batch = inst.device_state.apply_presence_sweep(
            now_s=t0 + 10_000 + 1801, missing_after_s=1800)
        inst._on_presence_changes(batch)
        inst.dispatcher.flush()
        inst.dispatcher.ingest_wire_lines(_stream_lines())
        inst.dispatcher.flush()
        inst.outbound.drain(10)
        inst.event_store.flush()
        changes = inst.event_store.query(
            SearchCriteria(page=1, page_size=0),
            event_type=int(EventType.STATE_CHANGE))
        local = inst.search_providers.get_provider("local")
        search = [[(r.device_id, r.event_type, r.ts_s, r.value)
                   for r in local.search(SearchCriteria(page=pg,
                                                        page_size=7),
                                         device_id=d).results]
                  for d in (0, 3, 17) for pg in (1, 2)]
        stream = inst.streams.get_assignment_stream(
            dm.get_active_assignment("dev-0").token, "clip")
        content = inst.streams.stream_content(stream.token)
        letters = [(d["kind"], d.get("request_kind"), d.get("device_token"),
                    d.get("stream_id"))
                   for d in inst.list_dead_letters()]
        billed = inst.usage_ledger.usage_of(0)["usage"]["outbound_rows"]
        stats = {cid: (s["processed"], s["errors"], s["dropped"])
                 for cid, s in inst.outbound.stats().items()}
    finally:
        inst.stop()          # the index connector's final flush
        inst.terminate()
    file_lines = sorted(open(root / "out" / "events.jsonl").read()
                        .splitlines())
    docs = {}
    for kind in ("hook", "index"):
        docs[kind] = sorted(
            json.dumps(d, sort_keys=True)
            for body in _Capture.bodies.get(f"/{pkg}/{kind}", [])
            for d in json.loads(body))
    return {
        "tap": sorted(rows), "file": file_lines, "hook": docs["hook"],
        "index": docs["index"], "mqtt": sorted(mqtt.published),
        "changes": sorted((r.device_id, r.ts_s, r.alert_code)
                          for r in changes.results),
        "search": search, "stream": content, "letters": letters,
        "billed": billed, "stats": stats,
    }


def test_one_traffic_through_both_instances(tmp_path):
    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Capture)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        ref = _run_instance("jax", tmp_path / "jax", server.server_port)
        got = _run_instance("torch", tmp_path / "torch", server.server_port)
    finally:
        server.shutdown()
        server.server_close()
    for key in ref:
        assert got[key] == ref[key], key
    n_rows = 4 * 120 + 36      # the payloads and the presence rows
    assert len(ref["tap"]) == n_rows
    assert len(ref["index"]) == n_rows
    assert len(ref["changes"]) == 36
    assert ref["billed"] == 5 * n_rows
    assert ref["file"] and ref["hook"] and ref["mqtt"]
    assert ref["stream"] == b"\x00" * 3 + b"\x01" * 3 + b"\x02" * 3
    assert ("failed-stream-request", "STREAM_DATA", "dev-1",
            "nope") in ref["letters"]
