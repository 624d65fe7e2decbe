"""The port's ingest modules against the JAX reference, on the CPU.

The journal writes the same bytes and each package reads the other's; the
scalar decoders return the same requests; the columnar pure-Python lane
returns the same resolved columns as the reference's decode (whichever of
its lanes takes the payload) and raises where it raises; the batcher
emits the same plans from the same intake; an unpacked plan's EventBatch
lands on the named device as a copy of its host columns.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from sitewhere_tpu.ids import IdentityMap as JIdentityMap
from sitewhere_tpu.ingest import batcher as jbatcher
from sitewhere_tpu.ingest import columnar as jcolumnar
from sitewhere_tpu.ingest import decoders as jdecoders
from sitewhere_tpu.ingest import journal as jjournal
from sitewhere_tpu_torch.ids import IdentityMap
from sitewhere_tpu_torch.ingest import batcher as tbatcher
from sitewhere_tpu_torch.ingest import columnar as tcolumnar
from sitewhere_tpu_torch.ingest import decoders as tdecoders
from sitewhere_tpu_torch.ingest import journal as tjournal
from torch_parity import FakeClock, WIRE_TS0_MS, wire_payload

torch.set_num_threads(1)


def _line(token, kind, req):
    return json.dumps({"deviceToken": token, "type": kind, "request": req})


def _payload(lines):
    return "\n".join(lines).encode()


PAYLOADS = {
    "measurements": _payload([
        _line(f"d-{i}", "Measurement",
              {"name": ("temp", "hum")[i % 2], "value": i * 1.5,
               "eventDate": 1_753_800_000 + i}) for i in range(6)]),
    "locations": _payload([
        _line(f"d-{i}", "DeviceLocation",
              {"latitude": i - 2.5, "longitude": 1.25 * i,
               "elevation": 3.0, "eventDate": 1_753_800_000_500})
        for i in range(4)]),
    "mixed": _payload([
        _line("d-0", "Measurement", {"name": "temp", "value": 21.5,
                                     "eventDate": 1_753_800_000}),
        _line("d-1", "Location", {"latitude": 1.5, "longitude": -2.5,
                                  "eventDate": 1_753_800_001}),
        _line("d-2", "Alert", {"type": "overheat", "level": "critical",
                               "eventDate": 1_753_800_002,
                               "latitude": 3.0, "longitude": 4.0}),
        _line("d-3", "Alert", {"level": 2}),
        _line("d-4", "StateChange", {"eventDate": 1_753_800_003}),
    ]),
    "commands": _payload([
        _line("d-0", "CommandInvocation", {"invocationToken": "inv-1",
                                           "eventDate": 1_753_800_000}),
        _line("d-0", "Acknowledge", {"originatingEventId": "inv-1"}),
        _line("d-1", "Acknowledge", {"originatingEventId": "inv-404"}),
    ]),
    "json_array": ("[" + ",".join([
        _line("d-0", "Measurement", {"name": "t", "value": 1.0}),
        _line("d-1", "Measurement", {"name": "t", "value": 2.0})]) + "]"
    ).encode(),
    "hardware_id": _payload([
        json.dumps({"hardwareId": "d-7", "type": "measurement",
                    "request": {"name": "temp", "value": 3.0}})]),
    "iso_timestamps": _payload([
        _line("d-0", "Measurement",
              {"name": "temp", "value": 1.0,
               "eventDate": "2026-01-02T03:04:05.250Z"})]),
    "registration": _payload([
        _line("d-9", "RegisterDevice", {"deviceTypeToken": "sensor"}),
        _line("d-0", "Measurement", {"name": "t", "value": 1.0}),
    ]),
    "nan_and_ties": _payload([
        '{"deviceToken":"d-0","type":"Measurement","request":'
        '{"name":"temp","value":NaN,"eventDate":1753800000}}',
        _line("d-0", "Measurement", {"name": "temp", "value": 2.0,
                                     "eventDate": 1_753_800_000}),
        _line("d-0", "Measurement", {"name": "temp", "value": 3.0,
                                     "eventDate": 1_753_800_000,
                                     "updateState": False}),
    ]),
    "wire_mix": wire_payload(np.random.default_rng(3), 40, WIRE_TS0_MS),
}

BAD_PAYLOADS = {
    "missing_type": _payload([
        _line("d-0", "Measurement", {"name": "t", "value": 1.0}),
        '{"deviceToken": "d-1"}']),
    "bad_value": _payload([_line("d-0", "Measurement",
                                 {"name": "t", "value": "hot"})]),
    "bad_level": _payload([_line("d-0", "Alert", {"level": "loud"})]),
    "out_of_range_ts": _payload([_line("d-0", "Measurement",
                                       {"name": "t", "value": 1.0,
                                        "eventDate": 1e15})]),
    "infinite_ts": _payload([
        '{"deviceToken":"d-0","type":"Measurement","request":'
        '{"name":"t","value":1,"eventDate":1e999}}']),
    "not_json": b"{nope",
    "unknown_type": _payload([_line("d-0", "Teleport", {})]),
}


def _identity(mod):
    ids = mod()
    for i in range(8):
        ids.device.mint(f"d-{i}")
    for name in ("temp", "hum", "t", "pres", "volt"):
        ids.mtype.mint(name)
    for name in ("overheat", "alert", "door", "tamper"):
        ids.alert_type.mint(name)
    return ids


def _resolved(columnar, ids, payload):
    cols, host = columnar.decode_json_lines(payload)
    out = columnar.resolve_columns(
        cols, ids.device.lookup, ids.mtype.mint, ids.alert_type.mint,
        invocations=ids.invocation) if columnar.n_rows(cols) else {}
    return out, [dataclasses.asdict(r) for r in host]


@pytest.mark.parametrize("name", sorted(PAYLOADS))
def test_columnar_decode_matches_reference(name):
    payload = PAYLOADS[name]
    ref, ref_host = _resolved(jcolumnar, _identity(JIdentityMap), payload)
    got, got_host = _resolved(tcolumnar, _identity(IdentityMap), payload)
    assert sorted(ref) == sorted(got)
    for key in ref:
        np.testing.assert_array_equal(np.asarray(ref[key]),
                                      np.asarray(got[key]), err_msg=key)
        assert np.asarray(ref[key]).dtype == np.asarray(got[key]).dtype, key
    assert ref_host == got_host


@pytest.mark.parametrize("name", sorted(BAD_PAYLOADS))
def test_columnar_decode_raises_where_reference_raises(name):
    payload = BAD_PAYLOADS[name]
    with pytest.raises(jdecoders.DecodeError):
        jcolumnar.decode_json_lines(payload)
    with pytest.raises(tdecoders.DecodeError):
        tcolumnar.decode_json_lines(payload)


@pytest.mark.parametrize("name", sorted(PAYLOADS))
def test_scalar_decoder_matches_reference(name):
    payload = PAYLOADS[name]
    ref = [dataclasses.asdict(r) for r in jdecoders.JsonLinesDecoder()(payload)]
    got = [dataclasses.asdict(r) for r in tdecoders.JsonLinesDecoder()(payload)]
    assert [{k: (int(v) if k == "kind" else v) for k, v in r.items()}
            for r in ref] == \
        [{k: (int(v) if k == "kind" else v) for k, v in r.items()}
         for r in got]


def test_space_of_only_takes_a_bound_lookup():
    ids = IdentityMap()
    assert tcolumnar.space_of(ids.device.lookup) is ids.device
    assert tcolumnar.space_of(ids.device.mint) is None
    assert tcolumnar.space_of(lambda t: 0) is None
    ids.device.mint("a")
    assert ids.device.lookup_many(["a", "b"]) == [0, -1]


# -- journal ------------------------------------------------------------------


def _files(journal):
    import os

    journal.flush()
    return {n: open(os.path.join(journal.dir, n), "rb").read()
            for n in sorted(os.listdir(journal.dir))}


@pytest.mark.parametrize("segment_bytes", [64 << 20, 300],
                         ids=["one_segment", "rotating"])
def test_journal_bytes_identical_and_cross_readable(tmp_path, segment_bytes):
    records = [PAYLOADS[n] for n in sorted(PAYLOADS)] * 3
    journals = {}
    for name, mod in (("jax", jjournal), ("torch", tjournal)):
        j = mod.Journal(str(tmp_path / name), "events",
                        segment_bytes=segment_bytes, fsync_every=7,
                        index_every=4)
        offsets = [j.append(r) for r in records]
        assert offsets == list(range(len(records)))
        j.append_json({"kind": "probe", "n": 1})
        reader = mod.JournalReader(j, "pipeline")
        reader.poll(5)
        reader.commit()
        journals[name] = j
    assert _files(journals["jax"]) == _files(journals["torch"])
    if segment_bytes < 1000:
        assert len(journals["torch"]._segments) > 3
    # each package reopens and reads the other's journal
    for name, mod, other in (("jax", jjournal, "torch"),
                             ("torch", tjournal, "jax")):
        j = mod.Journal(journals[other].dir.rsplit("/events", 1)[0],
                        "events", segment_bytes=segment_bytes,
                        index_every=4)
        reader = mod.JournalReader(j, "pipeline")
        assert reader.committed == 5
        assert j.end_offset == len(records) + 1
        got = [p for _, p in j.scan(0, len(records))]
        assert got == records
        assert j.read_one(len(records) - 2) == records[-2]
        j.close()


# -- batcher ------------------------------------------------------------------


def _batchers(emit_packed):
    out = []
    for mod, ident in ((jbatcher, JIdentityMap), (tbatcher, IdentityMap)):
        ids = _identity(ident)
        clock = FakeClock()
        out.append((mod.Batcher(
            width=16, n_shards=1, registry_capacity=32,
            resolve_device=ids.device.lookup, resolve_mtype=ids.mtype.mint,
            resolve_alert=ids.alert_type.mint, invocations=ids.invocation,
            deadline_ms=5.0, clock=clock, emit_packed=emit_packed,
            controller=mod.AdaptiveBatchController(deadline_ms=5.0)),
            clock))
    return out


def _feed(batcher, clock, decoders):
    """Scalar, request-list and columnar intake, deadline and flush
    emissions, out-of-range ids; returns every emitted plan."""
    rng = np.random.default_rng(11)
    plans = []
    reqs = decoders.JsonLinesDecoder()(PAYLOADS["mixed"])
    for r in reqs:
        plans.append(batcher.add(r, tenant_id=0, payload_ref=4))
    plans += batcher.add_requests(reqs * 3, [1] * 15, list(range(15)))
    n = 37
    plans += batcher.add_arrays(
        device_id=rng.integers(-3, 40, n).astype(np.int32),
        tenant_id=np.zeros(n, np.int32),
        event_type=rng.integers(0, 3, n).astype(np.int32),
        value=rng.uniform(0, 9, n).astype(np.float32),
        ts_s=np.arange(n, dtype=np.int32))
    clock.t += 0.004
    plans.append(batcher.poll())
    clock.t += 0.02
    plans.append(batcher.poll())
    plans += batcher.add_arrays(device_id=np.arange(5, dtype=np.int32))
    plans.append(batcher.flush())
    plans.append(batcher.flush())
    return [p for p in plans if p is not None]


@pytest.mark.parametrize("emit_packed", [True, False],
                         ids=["packed", "unpacked"])
def test_batcher_emits_the_reference_plans(emit_packed):
    (jb, jclock), (tb, tclock) = _batchers(emit_packed)
    ref = _feed(jb, jclock, jdecoders)
    got = _feed(tb, tclock, tdecoders)
    assert len(ref) == len(got) >= 5
    for r, g in zip(ref, got):
        assert (r.n_events, r.width, r.seq, r.reason, r.max_wait_s,
                r.created_at) == \
            (g.n_events, g.width, g.seq, g.reason, g.max_wait_s, g.created_at)
        assert sorted(r.host_cols) == sorted(g.host_cols)
        for k in r.host_cols:
            np.testing.assert_array_equal(r.host_cols[k], g.host_cols[k],
                                          err_msg=k)
            assert r.host_cols[k].dtype == g.host_cols[k].dtype, k
        if emit_packed:
            np.testing.assert_array_equal(r.packed_i, g.packed_i)
            np.testing.assert_array_equal(r.packed_f, g.packed_f)
        else:
            assert g.packed_i is None
    assert (jb.copied_bytes, jb.emitted_events, jb.pending) == \
        (tb.copied_bytes, tb.emitted_events, tb.pending)
    assert jb.controller.window_s == tb.controller.window_s
    assert (jb.controller.grows, jb.controller.shrinks) == \
        (tb.controller.grows, tb.controller.shrinks)



@pytest.mark.parametrize("case", ["in_order", "out_of_order", "unstamped",
                                  "carried_over"])
@pytest.mark.parametrize("emit_packed", [True, False],
                         ids=["packed", "unpacked"])
def test_plan_received_at_is_its_oldest_rows(emit_packed, case):
    """``received_at`` is when the payload of the plan's oldest row
    arrived (before its decode); the deadline still counts from the rows'
    arrival in the batcher."""
    _, (b, clock) = _batchers(emit_packed)
    clock.t = 100.0

    def ids(n):
        return np.arange(n, dtype=np.int32)

    if case == "in_order":
        assert b.add_arrays(device_id=ids(6), received_at=99.0) == []
        clock.t += 0.001
        plans = b.add_arrays(device_id=ids(10), received_at=99.5)
        want = [99.0]
    elif case == "out_of_order":     # the later payload decoded first
        b.add_arrays(device_id=ids(6), received_at=99.5)
        plans = b.add_arrays(device_id=ids(10), received_at=99.2)
        want = [99.2]
    elif case == "unstamped":
        b.add_arrays(device_id=ids(6))
        clock.t += 0.002
        plans = b.add_arrays(device_id=ids(10))
        want = [100.0]
    else:                            # one payload over a fill and a poll
        plans = b.add_arrays(device_id=ids(20), received_at=98.0)
        assert b.poll() is None      # 2 s since receipt, 0 in the batcher
        clock.t += 0.01
        plans.append(b.poll())
        want = [98.0, 98.0]
    assert [p.received_at for p in plans] == want
    for p in plans:
        assert p.received_at <= p.created_at - p.max_wait_s + 1e-9


def test_materialized_batch_is_a_copy_on_the_named_device():
    (_, _), (tb, clock) = _batchers(emit_packed=False)
    plans = tb.add_arrays(device_id=np.arange(20, dtype=np.int32) % 9,
                          value=np.linspace(0, 1, 20, dtype=np.float32))
    plan = plans[0]
    assert plan.batch is None
    batch = plan.materialize_batch("cpu")
    assert plan.batch is batch and plan.materialize_batch("cpu") is batch
    for k, v in plan.host_cols.items():
        t = getattr(batch, k)
        assert t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), v)
    plan.host_cols["value"][0] = 99.0
    assert float(batch.value[0]) == 0.0
    packed = _batchers(emit_packed=True)[1][0].add_arrays(
        device_id=np.arange(16, dtype=np.int32))[0]
    assert packed.materialize_batch("cpu") is None


def test_batcher_runs_one_shard_only():
    """Once a refusal of two shards; since the mesh, a 2-shard batcher
    routes every row to the segment of the shard that owns its device
    (``shard_for_device``), the reference's plan row for row."""
    kw = dict(width=16, n_shards=2, registry_capacity=32,
              resolve_device=lambda t: 0, resolve_mtype=lambda n: 0,
              resolve_alert=lambda n: 0, emit_packed=True)
    ids = np.array([3, 20, 31, 0, 17, -1, 40], np.int32)
    plans = []
    for b in (tbatcher.Batcher(**kw), jbatcher.Batcher(**kw)):
        b.add_arrays(device_id=ids, value=np.arange(7, dtype=np.float32))
        plans.append(b.flush())
    got, ref = plans
    assert got.packed_i.tobytes() == ref.packed_i.tobytes()
    assert got.packed_f.tobytes() == ref.packed_f.tobytes()
    dev, valid = got.packed_i[1], got.packed_i[0] != 0
    for row in np.nonzero(valid & (dev >= 0))[0]:
        assert row // 8 == tbatcher.shard_for_device(int(dev[row]), 32, 2)
    assert tbatcher.shard_for_device(70, 128, 2) == 1
    with pytest.raises(ValueError):
        tbatcher.shard_for_device(0, 3, 2)


def _meas(token="d-1", **req):
    body = {"name": "m", "value": 1.5, "eventDate": WIRE_TS0_MS}
    body.update(req)
    return {"deviceToken": token, "type": "DeviceMeasurements",
            "request": body}


# Records for registration's re-decode, each with the lines it varies;
# "certified" marks those the C scanner proves decodable line by line.
_REDECODE = {
    "mixed": (True, [
        _meas("d-1"),
        {"deviceToken": "d-2", "type": "DeviceLocation",
         "request": {"latitude": 1.5, "longitude": -2, "elevation": 3,
                     "eventDate": WIRE_TS0_MS}},
        {"type": "Alert", "hardwareId": "d-3",
         "request": {"level": 2, "type": "", "eventDate": 1.7e9,
                     "metadata": {"k": [1, "\\u00e9"]}}},
        _meas("d-4", value=7, updateState=False, extra={"a": None}),
        {"deviceToken": "d-5", "type": "measurement",
         "request": {"name": "", "measurementId": "m2", "value": 1e300,
                     "timestamp": WIRE_TS0_MS}}]),
    "blank lines": (True, [_meas("d-1"), " \r", _meas("d-2"), ""]),
    "duplicate key": (True, [
        '{"deviceToken":"d-1","type":"DeviceMeasurements","request":'
        '{"name":"m","value":1,"value":2,"eventDate":1700000000}}']),
    "eventDate 0, timestamp out of range": (False, [
        _meas("d-1"), _meas("d-2", eventDate=0, timestamp=1e17)]),
    "eventDate out of range": (False, [_meas("d-1"),
                                       _meas("d-2", eventDate=2 ** 31)]),
    "eventDate not finite": (False, [_meas("d-1"),
                                     '{"deviceToken":"d-2","type":"'
                                     'Measurement","request":{"name":"m",'
                                     '"value":1,"eventDate":1e999}}']),
    "value too large for a float": (False, [
        '{"deviceToken":"d-1","type":"Measurement","request":{"name":"m",'
        '"value":1' + "0" * 400 + ',"eventDate":1700000000}}']),
    "value a boolean": (False, [_meas("d-1", value=True)]),
    "value a string": (False, [_meas("d-1", value="x")]),
    "name null": (False, [_meas("d-1", name=None, measurementId="m")]),
    "no name": (False, [_meas("d-1", name="")]),
    "level cased": (False, [{"deviceToken": "d-1", "type": "Alert",
                             "request": {"level": "Warning"}}]),
    "level out of range": (False, [{"deviceToken": "d-1", "type": "Alert",
                                    "request": {"level": 2 ** 40}}]),
    "updateState not a literal boolean": (False, [_meas("d-1",
                                                        updateState=0)]),
    "escaped token": (False, ['{"deviceToken":"d-\\u0031","type":'
                              '"Measurement","request":{"name":"m",'
                              '"value":1}}']),
    "registration line": (False, [_meas("d-1"), {
        "deviceToken": "d-9", "type": "RegisterDevice",
        "request": {"deviceTypeToken": "sensor"}}]),
    "command line": (False, [_meas("d-1"), {
        "deviceToken": "d-2", "type": "CommandInvocation",
        "request": {"commandToken": "ping"}}]),
    "no request": (False, [{"deviceToken": "d-1", "type": "Measurement"}]),
    "vertical tab line": (False, [_meas("d-1"), "\x0b", _meas("d-2")]),
    "array": (False, None),
}


@pytest.mark.parametrize("name", sorted(_REDECODE))
def test_record_events_equal_the_scalar_decode(name):
    """Registration's re-decode (``RecordEvents``) returns, for any subset
    of a record's lines, what the reference's scalar decoder returns for
    them, and raises where it raises; only records the C scanner certifies
    are decoded line by line."""
    certified, lines = _REDECODE[name]
    if lines is None:
        payload = json.dumps([_meas("d-1"), _meas("d-2")]).encode()
    else:
        payload = "\n".join(
            ln if isinstance(ln, str) else json.dumps(ln)
            for ln in lines).encode()
    assert (tcolumnar.certified_event_lines(payload) is not None) \
        == certified
    try:
        ref = [r for r in jdecoders.JsonLinesDecoder()(payload)
               if r.event_type is not None]
    except jdecoders.DecodeError:
        with pytest.raises(tdecoders.DecodeError):
            tcolumnar.RecordEvents.of(payload)
        return
    for pick in (lambda i: True, lambda i: i % 2 == 1, lambda i: False):
        events = tcolumnar.RecordEvents.of(payload)
        assert events.tokens == [r.device_token for r in ref]
        got = [dataclasses.asdict(events.request(i))
               for i in range(len(events)) if pick(i)]
        want = [dataclasses.asdict(r) for i, r in enumerate(ref) if pick(i)]
        for doc in got + want:
            doc["kind"] = int(doc["kind"])
        assert got == want
