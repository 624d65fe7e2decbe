"""The port's native wire tier against the JAX reference, on the CPU.

``sitewhere_tpu_torch/native/swwire.c`` builds here with ``cc`` (into
``sitewhere_tpu_torch/_build/``), so every C lane of the port runs in
these tests.  The same bytes go through each lane of both packages:

- fill-direct (``decode_fill_direct`` into a batcher reservation),
- resolved (``_native_decode_resolved``),
- the measurement scanner and the two event-family scanners (the
  fill form ``_native_decode_events_into`` and the two-phase form),
  isolated through ``_native_decode``,
- pure Python (``_decode_lines_inner``), and the whole chain
  (``decode_json_lines``, with and without a device space),

and each lane's outcome must be the same in both: the same bail (None),
the same error type, or the same columns with ints and bools exact and
float32 compared bitwise.  The payloads are the decode-semantics cases of
the reference's ``tests/test_native_{fill,resolved,wire}.py`` and
``tests/test_columnar.py`` plus seeded random ones.  Then the
``TokenTable`` mirror under mint, free and restore, the reservation's
commit/abort/adoption contract, and the boot build that raises.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import sitewhere_tpu.native as jnative
from sitewhere_tpu.ids import HandleSpace as JHandleSpace
from sitewhere_tpu.ingest import batcher as jbatcher
from sitewhere_tpu.ingest import columnar as jcolumnar
from sitewhere_tpu.ingest import decoders as jdecoders
from sitewhere_tpu.pipeline.packed import BATCH_I as J_BATCH_I
from sitewhere_tpu_torch import native as tnative
from sitewhere_tpu_torch.ids import NULL_ID, HandleSpace
from sitewhere_tpu_torch.ingest import batcher as tbatcher
from sitewhere_tpu_torch.ingest import columnar as tcolumnar
from sitewhere_tpu_torch.ingest import decoders as tdecoders
from sitewhere_tpu_torch.pipeline.packed import BATCH_I

torch.set_num_threads(1)

WIDTH, CAPACITY, N_DEVICES = 64, 256, 40
NAMES = ("temp", "rh", "m0", "m1")
SEED = 20261016


# -- payloads -----------------------------------------------------------------


def _env(token, kind, req, **extra):
    return json.dumps({"deviceToken": token, "type": kind, "request": req,
                       **extra}, separators=(",", ":"))


def _m(token, value, ts=1_753_800_000, name="temp", **req):
    return _env(token, "Measurement",
                {"name": name, "value": value, "eventDate": ts, **req})


def _lines(*lines):
    return "\n".join(lines).encode()


def _random_measurements(rng, n, ghosts=0.1):
    out = []
    for i in range(n):
        token = (f"ghost-{i}" if rng.random() < ghosts
                 else f"dev-{int(rng.integers(0, N_DEVICES))}")
        ts = (1_753_800_000_000 + int(rng.integers(0, 5_000))
              if rng.random() < 0.5 else 1_753_800_000 + int(
                  rng.integers(0, 100)) + float(rng.choice([0, 0.25, 0.5])))
        extra = {"updateState": False} if rng.random() < 0.1 else {}
        out.append(_m(token, round(float(rng.uniform(-50, 150)), 3), ts=ts,
                      name=NAMES[int(rng.integers(0, len(NAMES)))], **extra))
    return out


def _random_family(rng, n):
    out = []
    for i in range(n):
        token = f"dev-{int(rng.integers(0, N_DEVICES))}"
        ts = 1_753_800_000 + i
        kind = int(rng.integers(0, 3))
        if kind == 0:
            out.append(_m(token, float(rng.uniform(0, 100)), ts=ts))
        elif kind == 1:
            out.append(_env(token, "Location", {
                "latitude": float(rng.uniform(-80, 80)),
                "longitude": float(rng.uniform(-170, 170)),
                "elevation": float(i), "eventDate": ts}))
        else:
            req = {"type": "overheat", "level": ("critical", 2)[i % 2],
                   "message": "hot!", "eventDate": ts}
            if i % 6 == 2:
                req.update(latitude=1.5, longitude=2.5)
            out.append(_env(token, "Alert", req))
    return out


_NUMBERS = ["0", "-0.0", "0.5", "-12345", "20.1", "1e3", "-2.5e-3",
            "9007199254740993", "3.141592653589793238", "0.1",
            "1234567890123456.75", "1e22"]

_BAD_LINES = {
    "location_line": _env("dev-1", "Location",
                          {"latitude": 1, "longitude": 2}),
    "malformed_json": '{"deviceToken":"dev-1","type":"Measurement",'
                      '"request":{"name":"t","value":}}',
    "missing_value": _env("dev-1", "Measurement", {"name": "t"}),
    "empty_token": _m("", 1),
    "metadata_key": _env("dev-1", "Measurement",
                         {"name": "t", "value": 1, "metadata": {}}),
    "garbage": "garbage not json",
}


def _payloads():
    rng = np.random.default_rng(SEED)
    good = [_m(f"dev-{i}", 1.0 + i) for i in range(5)]
    out = {
        "measurements": _lines(*_random_measurements(rng, 50)),
        "full_width": _lines(*_random_measurements(rng, WIDTH, ghosts=0.0)),
        "trailing_blanks": _lines(*_random_measurements(rng, 9)) + b"\n\n",
        "key_orders": _lines(
            _m("dev-1", 1.5),
            json.dumps({"type": "Measurement", "deviceToken": "dev-2",
                        "request": {"value": 2.5, "name": "temp",
                                    "eventDate": 1_753_800_001}}),
            json.dumps({"request": {"eventDate": 1_753_800_002,
                                    "name": "temp", "value": 3.5},
                        "deviceToken": "dev-3", "type": "Measurements"}),
            _env("dev-4", "Measurement", {"name": "temp", "value": 4.5,
                                          "timestamp": 1_753_800_003}),
            json.dumps({"hardwareId": "dev-5", "type": "Measurement",
                        "request": {"name": "temp", "value": 5.5,
                                    "eventDate": 1_753_800_004}})),
        "alias_precedence": _lines(
            '{"type":"Measurement","hardwareId":"hw","deviceToken":"dev-6",'
            '"request":{"measurementId":"alt","name":"temp","value":1,'
            '"timestamp":111,"eventDate":222}}'),
        "number_forms": _lines(*(
            '{"deviceToken":"dev-1","type":"Measurement","request":'
            '{"name":"rh","value":%s,"eventDate":%s}}' % (v, t)
            for v in _NUMBERS
            for t in ("1753800000", "1753800000.5", "1753800000123.25"))),
        "many_names": _lines(*(_m("dev-1", 1.0, name=f"name-{i}")
                               for i in range(300))),
        "long_name": _lines(_m("dev-2", 2.0, name="n" * 4096)),
        "family_mix": _lines(*_random_family(rng, 60)),
        "alert_precedence": _lines(
            _env("dev-1", "Alert", {"type": "", "alertType": "x",
                                    "eventDate": 1000}),
            _env("dev-2", "Alert", {"alertType": "fallback",
                                    "eventDate": 1000}),
            _env("dev-3", "Alert", {"eventDate": 1000})),
        "extras_skipped": _lines(
            '{"deviceToken":"dev-1","meta":{"a":[1,2,{"b":"c\\n"}]},'
            '"type":"Measurement","request":{"name":"t","value":3.5,'
            '"weird":null,"arr":[true]}}'),
        "registration": _lines(
            _m("dev-0", 42.0),
            _env("new-dev", "RegisterDevice", {"deviceTypeToken": "sensor"}),
            _env("dev-2", "Location", {"latitude": 1.0, "longitude": 2.0})),
        "registration_only": _lines(
            _env("new-dev", "RegisterDevice", {"deviceTypeToken": "s"})),
        "bad_registration": _lines(
            _m("dev-1", 1.0),
            '{"deviceToken":"g","type":"RegisterDevice","request":{'),
        "metadata": _lines(*(
            _env(f"dev-{i}", "Measurement",
                 {"name": "temp", "value": float(i)},
                 metadata={"tenant": "acme"}) for i in range(4))),
        "json_array": b"[" + b",".join(
            _m(f"dev-{i}", float(i)).encode() for i in range(3)) + b"]",
        "empty": b"",
        "blank": b"\n \n\t\n",
        "out_of_range_ts": _lines(_m("dev-1", 1.0, ts=4e18)),
        "out_of_range_ts_mixed": _lines(
            _m("dev-1", 1.0, ts=4e18),
            _env("dev-2", "Location", {"latitude": 1, "longitude": 2})),
        "wider_than_batch": _lines(*(_m(f"dev-{i % N_DEVICES}", float(i))
                                     for i in range(WIDTH + 8))),
        "invalid_utf8": _m("dev-1", 1.0).encode() + b"\n"
        + _m("dev-1", 1.0).encode().replace(b"dev-1", b"dev-\xff"),
        "escaped_token": b'{"deviceToken":"d\\u0041","type":"Measurement",'
                         b'"request":{"name":"t","value":3.5}}',
        "non_json_numbers": _lines(*(
            '{"deviceToken":"dev-1","type":"Measurement",'
            '"request":{"name":"t","value":%s}}' % bad
            for bad in (".5", "+1", "0x10", "1.", "01"))),
        "nan_value": _lines(
            '{"deviceToken":"dev-1","type":"Measurement","request":'
            '{"name":"t","value":NaN,"eventDate":1753800000}}'),
        "bad_level_casing": _lines(_env("dev-1", "Alert",
                                        {"level": "Warning"})),
        "location_missing_longitude": _lines(
            _env("dev-1", "Location", {"latitude": 1.0})),
        "state_change": _lines(_env("dev-1", "StateChange", {})),
    }
    for name, bad in _BAD_LINES.items():
        out[f"mid_bad_{name}"] = _lines(*good, bad, *good)
    base = _lines(*(_m(f"dev-{i}", 1.5 * i, ts=1_753_800_000 + i,
                       name=("temp", "rh")[i % 2]) for i in range(8)))
    for cut in (0, 37, 101, 250, len(base) - 3):
        out[f"truncated_{cut}"] = base[:cut]
    return out


PAYLOADS = _payloads()


# -- the two packages ---------------------------------------------------------


class _Pkg:
    """One package's spaces, batcher and lanes."""

    def __init__(self, which):
        jax = which == "jax"
        self.columnar = jcolumnar if jax else tcolumnar
        self.decoders = jdecoders if jax else tdecoders
        self.batcher_mod = jbatcher if jax else tbatcher
        self.native = jnative if jax else tnative
        self.mod = self.native.load_swwire()
        space = JHandleSpace if jax else HandleSpace
        self.dev = space("device", 2 * CAPACITY)
        self.mt = space("mtype", 1024)
        self.al = space("alert_type", 64)
        for i in range(N_DEVICES):
            self.dev.mint(f"dev-{i}")
        for name in NAMES + ("t",):
            self.mt.mint(name)
        self.batcher = self.batcher_mod.Batcher(
            width=WIDTH, n_shards=1, registry_capacity=CAPACITY,
            resolve_device=self.dev.lookup, resolve_mtype=self.mt.mint,
            resolve_alert=self.al.mint, deadline_ms=1e9, emit_packed=True)


class _ScannerView:
    """The scanner module with some scanners bailing, to isolate one
    lane of ``_native_decode`` (both packages reach every scanner through
    attribute lookups on the module)."""

    def __init__(self, mod, keep):
        self._mod = mod
        self._keep = keep

    def __getattr__(self, name):
        if name in self._keep:
            return getattr(self._mod, name)
        return lambda *args: None


_MEAS_ONLY = ("decode_measurement_lines",)
_TWO_PHASE_ONLY = ("decode_event_lines",)


def _fill_direct(pkg, payload):
    res = pkg.batcher.reserve(payload.count(b"\n") + 1)
    if res is None:
        return "refused"
    n = pkg.columnar.decode_fill_direct(payload, pkg.dev, res, pkg.mt.mint)
    assert pkg.batcher.pending == 0 and pkg.batcher.emitted_batches == 0
    if n is None:
        return None
    rows = {f: getattr(res, f)[:n]
            for f in ("device_id", "mtype_id", "ts_s", "ts_ns",
                      "update_state", "value")}
    return n, rows


def _native_with(pkg, payload, keep, monkeypatch):
    view = _ScannerView(pkg.mod, keep)
    with monkeypatch.context() as m:
        m.setattr(pkg.native, "load_swwire", lambda: view)
        return pkg.columnar._native_decode(payload)


LANES = {
    "fill_direct": lambda pkg, p, mp: _fill_direct(pkg, p),
    "resolved": lambda pkg, p, mp: pkg.columnar._native_decode_resolved(
        p, pkg.dev),
    "measurement": lambda pkg, p, mp: _native_with(pkg, p, _MEAS_ONLY, mp),
    "event_family_fill":
        lambda pkg, p, mp: pkg.columnar._native_decode_events_into(
            pkg.mod, p),
    "event_family": lambda pkg, p, mp: _native_with(pkg, p, _TWO_PHASE_ONLY,
                                                    mp),
    "pure_python": lambda pkg, p, mp: pkg.columnar._decode_lines_inner(
        pkg.decoders.parse_envelopes(p)),
    "chain": lambda pkg, p, mp: pkg.columnar.decode_json_lines(p),
    "chain_resolved": lambda pkg, p, mp: pkg.columnar.decode_json_lines(
        p, device_space=pkg.dev),
}


def _norm(value):
    """A lane's result in a form ``==`` compares exactly: arrays as dtype
    and raw bytes (float32 bitwise), requests as dicts."""
    if isinstance(value, np.ndarray):
        return ("array", value.dtype.str, value.shape, value.tobytes())
    if isinstance(value, dict):
        return {k: _norm(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_norm(v) for v in value]
    if dataclasses.is_dataclass(value):
        return {k: (int(v) if k == "kind" else v)
                for k, v in dataclasses.asdict(value).items()}
    return value


def _outcome(pkg, lane, payload, monkeypatch):
    try:
        return "ok", _norm(LANES[lane](pkg, payload, monkeypatch))
    except pkg.decoders.DecodeError as e:
        return "DecodeError", type(e.__cause__).__name__
    except (ValueError, TypeError, KeyError, OverflowError) as e:
        return "error", type(e).__name__


@pytest.mark.parametrize("payload", sorted(PAYLOADS))
@pytest.mark.parametrize("lane", sorted(LANES))
def test_lane_matches_the_reference(lane, payload, monkeypatch):
    """Each lane of the port gives the reference lane's outcome on the
    same bytes: the same bail, the same error, or the same columns
    (float32 bitwise)."""
    ref = _outcome(_Pkg("jax"), lane, PAYLOADS[payload], monkeypatch)
    got = _outcome(_Pkg("torch"), lane, PAYLOADS[payload], monkeypatch)
    assert got == ref


def test_corpus_reaches_every_c_lane():
    """Each C lane of the port takes some payloads of the corpus and
    bails on others."""
    pkg = _Pkg("torch")
    took = {}
    for lane in ("fill_direct", "resolved", "event_family_fill"):
        took[lane] = sorted(
            name for name, p in PAYLOADS.items()
            if _safe(lambda: LANES[lane](pkg, p, None)) not in (
                None, "refused", "raised"))
    assert "measurements" in took["fill_direct"]
    assert "family_mix" not in took["fill_direct"]
    assert "full_width" in took["resolved"]
    assert "family_mix" in took["event_family_fill"]
    assert "json_array" not in took["event_family_fill"]
    assert all(len(v) < len(PAYLOADS) for v in took.values())


def _safe(fn):
    try:
        return fn()
    except Exception:
        return "raised"


def test_resolved_columns_equal_the_unresolved_lane():
    """The resolved form (ids from the TokenTable, names deduped) gives
    the same batch columns as the token form resolved in Python."""
    pkg = _Pkg("torch")
    payload = PAYLOADS["measurements"]
    cols, host = tcolumnar.decode_json_lines(payload, device_space=pkg.dev)
    assert "device_id" in cols and host == []
    raw, _ = tcolumnar._decode_lines_inner(
        tdecoders.parse_envelopes(payload))
    a = tcolumnar.resolve_columns(cols, pkg.dev.lookup, pkg.mt.mint,
                                  pkg.al.mint)
    b = tcolumnar.resolve_columns(raw, pkg.dev.lookup, pkg.mt.mint,
                                  pkg.al.mint)
    assert _norm(a) == _norm(b)
    assert (a["device_id"] == NULL_ID).any()


# -- the TokenTable and its mirror --------------------------------------------


def test_token_table_basics_and_churn():
    t = tnative.load_swwire().TokenTable()
    assert type(t).__module__ == "_swwire_torch" \
        and type(t).__qualname__ == "TokenTable"
    assert len(t) == 0 and t.get("a") == NULL_ID
    t.set("a", 7)
    t.set(b"b", 9)
    assert (t.get("a"), t.get(b"a"), t.get("b"), len(t)) == (7, 7, 9, 2)
    t.discard("a")
    assert t.get("a") == NULL_ID and len(t) == 1
    n = 5000
    for i in range(n):
        t.set(f"token-{i}", i)
    for i in range(0, n, 2):
        t.discard(f"token-{i}")
    assert len(t) == n // 2 + 1
    assert t.get("token-1") == 1 and t.get("token-2") == NULL_ID
    with pytest.raises(TypeError):
        t.set(123, 1)
    t.clear()
    assert len(t) == 0


def test_token_table_of_the_other_package_is_refused():
    payload = PAYLOADS["measurements"]
    tmod, jmod = tnative.load_swwire(), jnative.load_swwire()
    with pytest.raises(TypeError):
        tmod.decode_measurement_lines_resolved(payload, jmod.TokenTable())
    with pytest.raises(TypeError):
        jmod.decode_measurement_lines_resolved(payload, tmod.TokenTable())
    assert tmod.decode_measurement_lines_resolved(
        payload, tmod.TokenTable()) is not None


def _assert_mirrored(space, tokens):
    table = space.native_table()
    assert len(table) == len(space)
    for t in tokens:
        assert table.get(t) == space.lookup(t), t


@pytest.mark.parametrize("seed", range(4))
def test_mirror_tracks_mint_free_and_restore(seed):
    """Random mint/free/restore sequences in both packages: the port's
    handles equal the reference's and its TokenTable equals ``lookup``
    after every operation; a restore swaps in a new table."""
    rng = np.random.default_rng(seed)
    spaces = (JHandleSpace("device", 512), HandleSpace("device", 512))
    tokens = [f"t-{i}" for i in range(60)]
    for space in spaces:
        space.mint("first")
        space.native_table()
    saved = None
    for step in range(200):
        op = rng.choice(["mint", "mint", "free", "save", "restore"])
        tok = tokens[int(rng.integers(0, len(tokens)))]
        if op == "save":
            saved = list(spaces[1]._id_to_token)
            continue
        before = spaces[1].native_table()
        for space in spaces:
            if op == "mint":
                space.mint(tok)
            elif op == "free":
                space.free(tok)
            elif saved is not None:
                space.load_state(saved)
        if op == "restore" and saved is not None:
            assert spaces[1].native_table() is not before
        assert spaces[0].lookup_many(tokens + ["first"]) \
            == spaces[1].lookup_many(tokens + ["first"]), step
        _assert_mirrored(spaces[1], tokens + ["first"])


def test_mirror_skips_unencodable_tokens():
    dev = HandleSpace("device", 64)
    bad = json.loads('"\\udc80bad"')
    dev.mint(bad)
    table = dev.native_table()
    assert len(table) == 0
    good = dev.mint("good")
    assert table.get("good") == good
    bad2 = json.loads('"\\udc81worse"')
    hid = dev.mint(bad2)
    assert dev.lookup(bad2) == hid
    dev.free(bad2)
    assert dev.lookup(bad2) == NULL_ID


def test_resolved_scan_sees_devices_minted_after_the_table():
    pkg = _Pkg("torch")
    pkg.dev.native_table()
    late = pkg.dev.mint("late-device")
    cols, _ = tcolumnar.decode_json_lines(_lines(_m("late-device", 9.0)),
                                          device_space=pkg.dev)
    assert cols["device_id"][0] == late
    pkg.dev.free("late-device")
    cols, _ = tcolumnar.decode_json_lines(_lines(_m("late-device", 9.0)),
                                          device_space=pkg.dev)
    assert cols["device_id"][0] == NULL_ID


# -- reservations ---------------------------------------------------------------


def _reserve_filled(pkg, payload):
    res = pkg.batcher.reserve(payload.count(b"\n") + 1)
    assert pkg.columnar.decode_fill_direct(payload, pkg.dev, res,
                                           pkg.mt.mint) is not None
    return res


def test_reserve_refuses_out_of_range_caps():
    b = _Pkg("torch").batcher
    assert b.reserve(0) is None and b.reserve(WIDTH + 1) is None
    assert isinstance(b.reserve(WIDTH), tbatcher.Reservation)
    assert isinstance(b.reserve(1), tbatcher.Reservation)


def test_commit_twice_and_commit_after_abort_raise():
    pkg = _Pkg("torch")
    res = _reserve_filled(pkg, _lines(_m("dev-1", 1.0)))
    res.set_const(tenant_id=0, payload_ref=NULL_ID)
    res.commit()
    with pytest.raises(RuntimeError):
        res.commit()
    res2 = _reserve_filled(pkg, _lines(_m("dev-1", 1.0)))
    res2.abort()
    with pytest.raises(RuntimeError):
        res2.commit()
    assert pkg.batcher.pending == 1


@pytest.mark.parametrize("case", ["full_width", "deadline_partial",
                                  "behind_queued_rows", "out_of_capacity"])
def test_reservation_plans_match_the_reference(case):
    """The same fill-direct commits in both packages give the same plans,
    byte for byte: a full-width reservation is adopted (no batch-assembly
    copy, ``packed_i`` is the reservation's buffer) and equals the
    ``add_arrays`` emission of the same rows; a partial one adopts on the
    deadline with clean padding; one behind queued rows is copied; an id
    past the registry capacity is rewritten to NULL_ID in place."""
    plans = {}
    for which in ("jax", "torch"):
        pkg = _Pkg(which)
        b = pkg.batcher
        if case == "out_of_capacity":
            for i in range(N_DEVICES, CAPACITY + 2):
                pkg.dev.mint(f"dev-{i}")
        payload = {
            "full_width": PAYLOADS["full_width"],
            "deadline_partial": _lines(*(_m(f"dev-{i}", 1.0 + i)
                                         for i in range(5))),
            "behind_queued_rows": PAYLOADS["full_width"],
            "out_of_capacity": _lines(_m(f"dev-{CAPACITY + 1}", 5.0),
                                      _m("dev-3", 6.0)),
        }[case]
        if case == "behind_queued_rows":
            b.add_arrays(device_id=np.asarray([0, 1], np.int32),
                         value=np.asarray([9.0, 8.0], np.float32))
        res = _reserve_filled(pkg, payload)
        res.set_const(tenant_id=3, payload_ref=42)
        before = b.copied_bytes
        out = res.commit(**({} if which == "jax" else {"received_at": 1.0}))
        if case in ("deadline_partial", "out_of_capacity"):
            assert out == []
            b.deadline_s = 0.0
            out = [b.poll()]
        assert len(out) == 1
        plan = out[0]
        adopted = plan.packed_i is res.ibuf
        assert adopted == (case == "full_width")
        if adopted:
            assert b.copied_bytes == before
        plans[which] = (plan, b.pending, b.copied_bytes)
    (ref, ref_pending, ref_copied), (got, pending, copied) = \
        plans["jax"], plans["torch"]
    assert J_BATCH_I == BATCH_I
    assert got.packed_i.tobytes() == ref.packed_i.tobytes()
    assert got.packed_f.tobytes() == ref.packed_f.tobytes()
    assert (got.n_events, got.reason, pending, copied) == \
        (ref.n_events, ref.reason, ref_pending, ref_copied)
    assert sorted(got.host_cols) == sorted(ref.host_cols)
    for k in ref.host_cols:
        assert _norm(got.host_cols[k]) == _norm(ref.host_cols[k]), k
    if case == "full_width":
        pkg = _Pkg("torch")
        cols = tcolumnar.resolve_columns(
            tcolumnar._decode_lines_inner(tdecoders.parse_envelopes(
                PAYLOADS["full_width"]))[0],
            pkg.dev.lookup, pkg.mt.mint, pkg.al.mint)
        copy = pkg.batcher.add_arrays(
            tenant_id=np.full(WIDTH, 3, np.int32),
            payload_ref=np.full(WIDTH, 42, np.int32), **cols)[0]
        assert copy.packed_i.tobytes() == got.packed_i.tobytes()
        assert copy.packed_f.tobytes() == got.packed_f.tobytes()
        assert got.received_at == 1.0
    if case == "out_of_capacity":
        assert got.packed_i[BATCH_I.index("device_id")][0] == NULL_ID


# -- the boot build -------------------------------------------------------------


@pytest.mark.parametrize("how", ["broken_source", "no_compiler"])
def test_failed_scanner_build_raises_at_start(tmp_path, monkeypatch, how):
    """``start()`` builds the scanner library; a build that fails raises
    there, with the compiler's output, and nothing decodes in Python in
    its place."""
    from torch_parity import wire_world

    world = wire_world("torch", tmp_path / "j", 0)
    monkeypatch.setattr(tnative, "_swwire", None)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    if how == "broken_source":
        src = tmp_path / "swwire.c"
        src.write_text("#include <Python.h>\nint broken(void) { return }\n")
        monkeypatch.setattr(tnative, "SOURCE", src)
        match = "error"
    else:
        monkeypatch.setenv("CC", str(tmp_path / "no-such-cc"))
        match = "no-such-cc"
    with pytest.raises(tnative.NativeBuildError, match=match):
        world.disp.start()
    assert world.disp._thread is None
    world.disp.stop()
    with pytest.raises(tnative.NativeBuildError):
        world.disp.decode_wire_lines(PAYLOADS["family_mix"])


def test_mirror_stays_exact_under_concurrent_mints_and_scans():
    """Threads mint tokens while others scan payloads of them through the
    resolved lane: the mirror ends equal to ``lookup`` for every token (a
    lost update would leave one unmirrored), and every scanned id is the
    token's handle or NULL_ID (minted after the scan read it)."""
    import sys
    import threading

    space = HandleSpace("device", 1 << 14)
    space.native_table()
    tokens = [f"tok-{i}" for i in range(4000)]
    payload = _lines(*(_m(t, 1.0) for t in tokens[::7]))
    errors = []

    def mint(part):
        for t in tokens[part::6]:
            space.mint(t)

    def scan():
        for _ in range(20):
            cols, _ = tcolumnar.decode_json_lines(payload, device_space=space)
            ids = cols["device_id"]
            want = np.asarray(space.lookup_many(tokens[::7]), np.int32)
            if not ((ids == want) | (ids == NULL_ID)).all():
                errors.append(ids)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=mint, args=(p,)) for p in range(6)]
        threads += [threading.Thread(target=scan) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert len(space) == len(tokens)
    _assert_mirrored(space, tokens)


def test_concurrent_builds_share_one_library(tmp_path):
    """Processes that build the extension at once into one empty build
    directory all load it, and leave one library and no temporary file
    (a minimal source with the module's init keeps the builds short)."""
    import subprocess
    import sys

    src = tmp_path / "mini.c"
    src.write_text(
        "#include <Python.h>\n"
        "static struct PyModuleDef m = {PyModuleDef_HEAD_INIT, "
        "\"_swwire_torch\", NULL, -1, NULL};\n"
        "PyMODINIT_FUNC PyInit__swwire_torch(void) "
        "{ return PyModule_Create(&m); }\n")
    build = tmp_path / "build"
    probe = ("import sys\nfrom pathlib import Path\n"
             "from sitewhere_tpu_torch import native\n"
             "native.SOURCE, native.BUILD_DIR = map(Path, sys.argv[1:])\n"
             "print(native.load_swwire().__name__, native.build_path().name)\n")
    procs = [subprocess.Popen([sys.executable, "-c", probe, str(src),
                               str(build)],
                              cwd=tnative.PKG_DIR.parent,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(4)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, outs
    names = {o.split()[1] for o, _ in outs}
    assert {o.split()[0] for o, _ in outs} == {"_swwire_torch"}
    assert len(names) == 1
    assert [p.name for p in build.iterdir()] == list(names)
