"""The cross-host fabric in the port against the reference.

- The reference's own ``tests/test_rpc.py``, run on the port with its
  imports rewritten (``torch_parity.port_test_module``), every
  ``Instance`` on the CPU, every case of it (the forward metric names
  through the port's own swlint ``metric_names`` lint).
"""

from __future__ import annotations

import json
import os
import socket
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_parity import port_test_module, reference_cases, run_port_case

torch.set_num_threads(1)
TESTS = os.path.dirname(os.path.abspath(__file__))
REF = os.path.join(TESTS, "test_rpc.py")

CASES = reference_cases(REF)


# the Instance import carries a lint marker the CPU swap does not match
REPLACE = (("from sitewhere_tpu.instance import Instance  # noqa: E402",
            "from sitewhere_tpu.instance import Instance"),)


@pytest.fixture(scope="module")
def port_ns():
    return port_test_module(REF, replace=REPLACE)


def test_the_port_runs_every_reference_fabric_case():
    assert "TestPeerHealthTable.test_forward_metric_names_pass_the_lint" \
        in CASES


@pytest.mark.parametrize("case", CASES)
def test_reference_rpc_case_on_the_port(port_ns, case, tmp_path):
    run_port_case(port_ns, case, tmp_path)


# ---------------------------------------------------------------------------
# cluster contracts across packages: frames and owners
# ---------------------------------------------------------------------------

def _frames(wire):
    return [
        wire.request_frame(7, "device.get", {"token": "dev-1"},
                           {"authorization": "abc", "tenant": "t1",
                            "x-trace-id": "00ff"}, b"\x00\x01binary"),
        wire.request_frame(2 ** 40 + 3, "events.ingest",
                           {"sourceId": "wire", "rows": 3},
                           {"x-deadline-ms": "25"},
                           b'{"deviceToken":"d"}\n' * 3),
        wire.request_frame(1, "m", None),
        wire.response_frame(9, {"accepted": 12, "nested": [1, 2.5, None]}),
        wire.response_frame(10, {"error": "not_found", "message": "x"},
                            error=True),
        wire.response_frame(11, {"ok": True}, attachment=b"\xff" * 1000,
                            headers={"x-overload": "2",
                                     "x-retry-after": "0.5"}),
    ]


def _decoded(wire, raw):
    a, b = socket.socketpair()
    try:
        a.sendall(raw)
        return wire.read_frame(b)
    finally:
        a.close()
        b.close()


def test_frames_are_byte_equal_and_read_across_packages():
    from sitewhere_tpu.rpc import wire as ref_wire
    from sitewhere_tpu_torch.rpc import wire as port_wire

    for ref_frame, port_frame in zip(_frames(ref_wire), _frames(port_wire)):
        ref_raw, port_raw = ref_wire.encode(ref_frame), port_wire.encode(
            port_frame)
        assert ref_raw == port_raw
        for reader, raw in ((port_wire, ref_raw), (ref_wire, port_raw)):
            got = _decoded(reader, raw)
            for field in ("request_id", "method", "headers", "body",
                          "attachment", "is_response", "is_error"):
                assert getattr(got, field) == getattr(ref_frame, field), field


def _tokens(n, unicode=False):
    rng = np.random.default_rng(20261017)
    kinds = rng.integers(0, 3, n)
    nums = rng.integers(0, 10 ** 9, n)
    sep = "/ü-" if unicode else "/x-"
    return [(f"dev-{i}", f"sensor-{v:x}", f"t{v}{sep}{i}")[k]
            for i, (k, v) in enumerate(zip(kinds, nums))]


def _payload(tokens):
    return b"\n".join(
        json.dumps({"deviceToken": t, "type": "DeviceMeasurements",
                    "request": {"name": "t", "value": 1.0}}).encode()
        for t in tokens)


@pytest.fixture(scope="module")
def token_payload():
    tokens = _tokens(100_000)
    return tokens, _payload(tokens)


@pytest.mark.parametrize("n_processes", [2, 3, 5])
def test_owners_are_equal_across_packages(n_processes, token_payload):
    from sitewhere_tpu.native import load_swwire as ref_swwire
    from sitewhere_tpu.rpc import forward as ref_fwd
    from sitewhere_tpu_torch.native import load_swwire as port_swwire
    from sitewhere_tpu_torch.rpc import forward as port_fwd

    tokens, payload = token_payload
    ref = [ref_fwd.owning_process(t, n_processes) for t in tokens]
    port = [port_fwd.owning_process(t, n_processes) for t in tokens]
    assert port == ref
    assert set(ref) == set(range(n_processes))
    # the C scanners of both packages take the whole payload (no escape
    # makes them hand it to the Python path) and agree line by line
    native = port_swwire().split_owner_lines(payload, n_processes)
    assert native == ref
    assert ref_swwire().split_owner_lines(payload, n_processes) == ref
    # split_lines over the native scanner, in both packages
    split = port_fwd.split_lines(payload, n_processes)
    assert split == ref_fwd.split_lines(payload, n_processes)
    assert {o: len(v) for o, v in split.items()} == {
        o: ref.count(o) for o in set(ref)}
    # tokens whose JSON carries escapes take the Python path: equal too
    odd = _tokens(2_000, unicode=True)
    odd_payload = _payload(odd)
    assert port_swwire().split_owner_lines(odd_payload, n_processes) is None
    odd_split = port_fwd.split_lines(odd_payload, n_processes)
    assert odd_split == ref_fwd.split_lines(odd_payload, n_processes)
    owner_of = {line: o for o, lines in odd_split.items() for line in lines}
    assert [owner_of[line] for line in odd_payload.split(b"\n")] == [
        ref_fwd.owning_process(t, n_processes) for t in odd]


# ---------------------------------------------------------------------------
# one two-host fleet in each package, the same NDJSON
# ---------------------------------------------------------------------------

FLEET_WIDTH, FLEET_DEVICES, FLEET_PAYLOADS = 64, 100, 6


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _fleet_config(pkg, root, p, peers):
    if pkg == "jax":
        from sitewhere_tpu.runtime.config import Config
    else:
        from sitewhere_tpu_torch.runtime.config import Config
    return Config({
        "instance": {"id": f"fleet-{p}", "data_dir": str(root / f"h{p}")},
        "pipeline": {"width": FLEET_WIDTH, "registry_capacity": 256,
                     "mtype_slots": 4, "deadline_ms": 60_000.0,
                     "adaptive_deadline": False, "n_shards": 1},
        "presence": {"scan_interval_s": 3600.0, "missing_after_s": 1800},
        "checkpoint": {"interval_s": 0},
        "rpc": {"server": {"enabled": True, "host": "127.0.0.1",
                           "port": int(peers[p].rsplit(":", 1)[1])},
                "process_id": p, "peers": peers,
                "forward_deadline_ms": 10.0},
        "security": {"jwt_secret": "fleet-secret"},
    }, apply_env=False)


def _run_fleet(pkg, root):
    from torch_parity import WIRE_ALERTS, WIRE_MTYPES, WIRE_TS0_MS, \
        wire_payload

    if pkg == "jax":
        from sitewhere_tpu.instance import Instance as Inst
        from sitewhere_tpu.rpc import owning_process as owner_of
        kw = {}
    else:
        from sitewhere_tpu_torch.instance import Instance as Inst
        from sitewhere_tpu_torch.rpc import owning_process as owner_of
        kw = {"device": "cpu"}
    from test_torch_rules_wire import stored_rows

    peers = [f"127.0.0.1:{_free_port()}" for _ in range(2)]
    hosts = [Inst(_fleet_config(pkg, root / pkg, p, peers), **kw)
             for p in range(2)]
    try:
        for p, inst in enumerate(hosts):
            # names minted in one order on every host, so dense ids agree
            for name in WIRE_MTYPES:
                inst.identity.mtype.mint(name)
            for name in WIRE_ALERTS:
                inst.identity.alert_type.mint(name)
            inst.start()
            dm = inst.device_management
            dm.create_device_type(token="sensor", name="S")
            for i in range(FLEET_DEVICES):
                tok = f"dev-{i}"
                if owner_of(tok, 2) == p:     # registered on its owner only
                    dm.create_device(token=tok, device_type="sensor")
                    dm.create_device_assignment(device=tok)
        rng = np.random.default_rng(20261019)
        for k in range(FLEET_PAYLOADS):
            payload = wire_payload(rng, FLEET_WIDTH, WIRE_TS0_MS + 1000 * k)
            sender = hosts[k % 2].forwarder
            sender.ingest_payload(payload)
            # the owner's reply comes after its intake, so once the spool
            # is empty every row of the payload sits in its host's
            # batcher, and each plan holds one payload's rows (plans
            # decide which straddled rows registration replays)
            deadline = time.time() + 20
            while sender.metrics()["pending"] and time.time() < deadline:
                sender.flush(wait=True)
                time.sleep(0.005)
            for inst in hosts:
                inst.dispatcher.flush()
        out = []
        for inst in hosts:
            m = inst.forwarder.metrics()
            out.append({
                "rows": stored_rows(inst.event_store),
                "totals": dict(inst.dispatcher.totals),
                "forward": {k: m[k] for k in ("local_rows", "forwarded_rows",
                                              "dead_lettered", "pending")},
            })
        return out
    finally:
        for inst in hosts:
            inst.stop()
            inst.terminate()


@pytest.fixture(scope="module")
def fleets(tmp_path_factory):
    root = tmp_path_factory.mktemp("fleet")
    return {pkg: _run_fleet(pkg, root) for pkg in ("jax", "torch")}


@pytest.mark.parametrize("host", [0, 1])
def test_fleet_hosts_store_and_forward_as_the_reference(fleets, host):
    ref, got = fleets["jax"][host], fleets["torch"][host]
    np.testing.assert_array_equal(got["rows"], ref["rows"])
    assert got["totals"] == ref["totals"]
    assert got["forward"] == ref["forward"]
    assert got["forward"]["forwarded_rows"] > FLEET_WIDTH
    assert got["forward"]["dead_lettered"] == got["forward"]["pending"] == 0
    assert len(got["rows"]) > FLEET_WIDTH


# ---------------------------------------------------------------------------
# a sender SIGKILLed between its spool poll and the owner's ack
# ---------------------------------------------------------------------------

KILL_DEVICES, KILL_LINES = 40, 48


def _kill_config(root, p, peers):
    from sitewhere_tpu_torch.runtime.config import Config

    return Config({
        "instance": {"id": f"kill-{p}", "data_dir": str(root / f"h{p}")},
        "pipeline": {"width": 64, "registry_capacity": 128,
                     "mtype_slots": 4, "deadline_ms": 5.0, "n_shards": 1},
        "presence": {"scan_interval_s": 3600.0, "missing_after_s": 1800},
        "rpc": {"server": {"enabled": True, "host": "127.0.0.1",
                           "port": int(peers[p].rsplit(":", 1)[1])},
                "process_id": p, "peers": peers,
                "forward_deadline_ms": 10.0},
        "security": {"jwt_secret": "kill-secret"},
    }, apply_env=False)


def _kill_payload(k):
    """``KILL_LINES`` measurements; line i of payload k carries the value
    ``1000 * k + i``, so every row is told apart in the stores."""
    return b"\n".join(json.dumps({
        "deviceToken": f"dev-{i % KILL_DEVICES}", "type": "DeviceMeasurements",
        "request": {"name": "temp", "value": float(1000 * k + i),
                    "eventDate": 1_700_000_000_000 + 1000 * k}},
        separators=(",", ":")).encode() for i in range(KILL_LINES))


def _kill_host(root, p, peers):
    from sitewhere_tpu_torch.instance import Instance as Inst
    from sitewhere_tpu_torch.rpc import owning_process as owner_of

    inst = Inst(_kill_config(root, p, peers), device="cpu")
    inst.start()
    dm = inst.device_management
    if not dm.list_device_types().results:
        dm.create_device_type(token="sensor", name="S")
        for i in range(KILL_DEVICES):
            if owner_of(f"dev-{i}", 2) == p:
                dm.create_device(token=f"dev-{i}", device_type="sensor")
                dm.create_device_assignment(device=f"dev-{i}")
        # the registry survives the kill: the restart replays against it
        inst.checkpointer.save()
    return inst


def forward_child(root, peers):
    """Host 0: payload 0 forwards and is acked; payload 1 is spooled and
    polled, and the armed crash point kills the process before the
    send."""
    inst = _kill_host(root, 0, peers)
    fwd = inst.forwarder
    for k in range(2):
        fwd.ingest_payload(_kill_payload(k))
        fwd.flush(wait=True)
        inst.dispatcher.flush()
    raise AssertionError("the crash point did not fire")


def _journal_values(data_dir, name):
    """The measurement values of every line of one journal on disk."""
    from sitewhere_tpu_torch.ingest.journal import Journal

    journal = Journal(str(data_dir), name=name)
    try:
        return sorted(float(json.loads(line)["request"]["value"])
                      for _, payload in journal.scan(0)
                      for line in payload.split(b"\n") if line)
    finally:
        journal.close()


def _stored_values(inst):
    inst.dispatcher.flush()
    inst.event_store.flush()
    vals = []
    for c in inst.event_store.iter_chunks():
        vals += np.asarray(c["value"], np.float64).tolist()
    return sorted(vals)


def test_kill_mid_forward_replays_the_spool_with_no_row_lost(tmp_path):
    import signal
    import subprocess
    import sys

    from sitewhere_tpu_torch.rpc import owning_process as owner_of

    peers = [f"127.0.0.1:{_free_port()}" for _ in range(2)]
    owner = _kill_host(tmp_path, 1, peers)
    try:
        env = dict(os.environ, SW_CRASHPOINT="crash.mid_forward:2",
                   PYTHONPATH=os.path.dirname(TESTS))
        child = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--forward-child",
             str(tmp_path), *peers], env=env, capture_output=True,
            timeout=120)
        assert child.returncode == -signal.SIGKILL, child.stderr[-3000:]
        # payload 0's rows reached the owner once; payload 1's did not
        mine = {0: [], 1: []}
        for k in range(2):
            for i in range(KILL_LINES):
                mine[owner_of(f"dev-{i % KILL_DEVICES}", 2)].append(
                    float(1000 * k + i))
        assert _stored_values(owner) == sorted(
            v for v in mine[1] if v < 1000)
        # what survived the kill on host 0's disk: the spool toward host
        # 1 (payload 1's remote rows, polled but never acked) and the
        # intake journal (the rows the sender took itself)
        spooled = _journal_values(tmp_path / "h0", "forward-1")
        journaled = _journal_values(tmp_path / "h0", "ingest")
        assert set(v for v in mine[1] if v >= 1000) <= set(spooled)
        assert set(v for v in mine[0] if v < 1000) <= set(journaled)
        sender = _kill_host(tmp_path, 0, peers)
        try:
            deadline = time.time() + 20
            while (sender.forwarder.metrics()["pending"]
                   and time.time() < deadline):
                sender.forwarder.flush(wait=True)
                time.sleep(0.01)
            assert sender.forwarder.metrics()["pending"] == 0
            assert sender.forwarder.dead_lettered == 0
            # every row once: the owner's from the replayed spool, the
            # sender's own from its journal
            assert _stored_values(owner) == sorted(mine[1])
            assert _stored_values(sender) == journaled
        finally:
            sender.stop()
            sender.terminate()
    finally:
        owner.stop()
        owner.terminate()


if __name__ == "__main__" and sys.argv[1:2] == ["--forward-child"]:
    forward_child(Path(sys.argv[2]), sys.argv[3:5])


# ---------------------------------------------------------------------------
# the fabric's threads and the per-thread CUDA streams (mocked)
# ---------------------------------------------------------------------------

def test_fabric_threads_call_in_on_the_default_stream(tmp_path, monkeypatch):
    """With CUDA streams mocked: the RPC handler threads that call into
    the instance (``events.ingest`` into the dispatcher,
    ``migration.import`` into the state manager) and the topology polls
    hold no stream of their own, and the imported row is written on the
    stream the epoch was committed from."""
    import threading

    from sitewhere_tpu_torch.rpc import RpcDemux, owning_process
    from sitewhere_tpu_torch.rpc.migration import export_devices
    from torch_parity import FakeStreams

    fakes = FakeStreams()
    monkeypatch.setattr(torch.cuda, "stream", fakes.stream)
    monkeypatch.setattr(torch.cuda, "current_stream", fakes.current)
    peers = [f"127.0.0.1:{_free_port()}" for _ in range(2)]
    hosts = [_kill_host(tmp_path, p, peers) for p in range(2)]
    owner = hosts[1]
    owner.device_state._stream = "epoch-stream"
    calls = []

    def spy(obj, name, tag):
        real = getattr(obj, name)

        def wrapped(*a, **kw):
            calls.append((tag, threading.current_thread().name,
                          torch.cuda.current_stream()))
            return real(*a, **kw)

        monkeypatch.setattr(obj, name, wrapped)

    spy(owner.dispatcher, "ingest_wire_lines", "ingest")
    spy(owner.device_state, "import_row", "import")
    spy(owner, "topology", "topology")
    real_clone = torch.Tensor.clone

    def clone_spy(self, *a, **kw):
        if threading.current_thread().name.startswith("rpc"):
            calls.append(("write", threading.current_thread().name,
                          torch.cuda.current_stream()))
        return real_clone(self, *a, **kw)

    try:
        hosts[0].forwarder.ingest_payload(_kill_payload(0))
        hosts[0].forwarder.flush(wait=True)
        assert hosts[0].forwarder.forwarded_rows > 0
        assert hosts[0].cluster_topology()["peers"]["1"]["devices"] > 0
        # one of host 1's devices, handed back to it with a newer state
        tok = next(f"dev-{i}" for i in range(KILL_DEVICES)
                   if owning_process(f"dev-{i}", 2) == 1)
        doc = export_devices(owner, [tok])[0]
        doc["state"]["last_event_ts_s"] = 2_000_000_000
        jwt = owner.tokens.mint("system", ["ROLE_ADMIN"])
        demux = RpcDemux([peers[1]], token_provider=lambda: jwt)
        monkeypatch.setattr(torch.Tensor, "clone", clone_spy)
        try:
            body, _ = demux.call("migration.import", {"docs": [doc]})
        finally:
            monkeypatch.setattr(torch.Tensor, "clone", real_clone)
            demux.close()
        assert body["states"] == 1
    finally:
        for inst in hosts:
            inst.stop()
            inst.terminate()
    kinds = {kind for kind, _, _ in calls}
    assert kinds == {"ingest", "import", "topology", "write"}, calls
    for kind, thread, stream in calls:
        assert thread != threading.main_thread().name or kind == "topology"
        want = "epoch-stream" if kind == "write" else "default-stream"
        assert stream == want, (kind, thread, stream)
