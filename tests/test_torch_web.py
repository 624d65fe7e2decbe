"""The REST/WS gateway over the port ``Instance``, against the reference.

- The reference's own ``tests/test_web.py`` and ``tests/test_observability.py``
  cases, and the REST cases of ``tests/test_charts.py``, run against the
  port with their imports rewritten (``tests/torch_parity.py
  port_test_module``), each module's ``WebServer`` over a port
  ``Instance`` on the CPU.
- One script of requests through a ``WebServer`` over each package's
  ``Instance``: the JSON bodies equal after ids and timestamps are
  normalised, the same 132 method-and-path pairs in ``openapi.json``, and
  the same parsed exposition families where both packages have them.
- The gateway's own guards: no tensor crosses the REST boundary, and the
  routes that read card tensors run on the stream the epoch was committed
  from (CUDA streams mocked on the CPU).
"""

from __future__ import annotations

import os

import pytest
import torch

from torch_parity import (
    FakeStreams,
    port_cases,
    port_test_module,
    run_port_case,
)

torch.set_num_threads(1)
TESTS = os.path.dirname(os.path.abspath(__file__))

# module -> {case left out: why}; every other case of the module runs
MODULES = {
    "test_web.py": {},
    "test_observability.py": {},
}
# module -> the cases that run (its other cases belong to other slices)
ONLY = {
    "test_charts.py": (
        "test_chart_series_rest_endpoint",
        "test_chart_series_unknown_measurement_returns_empty",
        "test_rule_rest_crud_with_kinds",
        "test_rule_rest_roundtrip_and_bad_enums",
        "test_chart_series_bucketed_rest_param",
    ),
}
_NS = {}


def _ns(module):
    if module not in _NS:
        _NS[module] = port_test_module(os.path.join(TESTS, module))
    return _NS[module]


CASES = ([(m, c) for m, skip in MODULES.items()
          for c in port_cases(_ns(m), skip=skip)]
         + [(m, c) for m, names in ONLY.items() for c in names])


def test_the_port_runs_the_reference_web_cases():
    by_module = {}
    for module, _ in CASES:
        by_module[module] = by_module.get(module, 0) + 1
    assert by_module == {"test_web.py": 25, "test_observability.py": 21,
                         "test_charts.py": 5}
    # every case of test_charts.py that starts a WebServer runs here
    import re

    src = open(os.path.join(TESTS, "test_charts.py")).read()
    rest = {name for name, body in re.findall(
        r"^def (test_\w+)\(.*?\n((?:    .*\n|\n)+)", src, re.M)
        if "WebServer" in body}
    assert rest == set(ONLY["test_charts.py"])


@pytest.fixture(scope="module")
def web_server(tmp_path_factory):
    """``tests/test_web.py``'s module-scoped ``server`` and ``client``,
    shared by its cases as the reference shares them."""
    ns = _ns("test_web.py")
    gen = ns["server"].__wrapped__(tmp_path_factory)
    server = next(gen)
    client = ns["client"].__wrapped__(server)
    yield {"server": server, "client": client}
    next(gen, None)


@pytest.mark.parametrize("module,case", CASES,
                         ids=[f"{m[5:-3]}::{c}" for m, c in CASES])
def test_reference_web_case_on_the_port(module, case, tmp_path, request,
                                        caplog, monkeypatch):
    fixtures = {"caplog": caplog, "monkeypatch": monkeypatch}
    if module == "test_web.py":
        fixtures.update(request.getfixturevalue("web_server"))
    run_port_case(_ns(module), case, tmp_path, fixtures=fixtures)


# ---------------------------------------------------------------------------
# one script of requests through both packages' gateways
# ---------------------------------------------------------------------------

TS = 1_753_800_000
# the script: (method, path, body); ``{tok}`` is the JWT of the first line
SCRIPT = [
    ("POST", "/api/devicetypes", {"token": "sensor", "name": "Sensor"}),
    ("POST", "/api/devices", {"token": "d-1", "device_type": "sensor"}),
    ("POST", "/api/devices", {"token": "d-2", "device_type": "sensor"}),
    ("POST", "/api/assignments", {"token": "a-1", "device": "d-1"}),
    ("POST", "/api/assignments", {"token": "a-2", "device": "d-2"}),
    ("POST", "/api/areatypes", {"token": "site", "name": "Site"}),
    ("POST", "/api/areas", {"token": "hq", "name": "HQ", "area_type": "site"}),
    ("GET", "/api/devices/d-1", None),
    ("GET", "/api/devices?pageSize=10", None),
    ("GET", "/api/devicetypes/sensor", None),
    ("GET", "/api/assignments/a-1", None),
    ("POST", "/api/assignments/a-1/measurements",
     {"name": "temp", "value": 21.5, "ts": TS}),
    ("POST", "/api/assignments/a-1/measurements",
     {"name": "temp", "value": 23.0, "ts": TS + 5}),
    ("POST", "/api/assignments/a-2/measurements",
     {"name": "hum", "value": 40.25, "ts": TS + 1}),
    ("POST", "/api/assignments/a-1/locations",
     {"latitude": 12.5, "longitude": -3.25, "elevation": 7.0, "ts": TS + 2}),
    ("POST", "/api/assignments/a-2/alerts",
     {"type": "door", "level": 2, "message": "open", "ts": TS + 3}),
    ("POST", "/api/assignments/a-9/measurements", {"value": 1.0}),
    ("POST", "/api/assignments/a-1/bogus", {"value": 1.0}),
    ("GET", "/api/assignments/a-1/measurements", None),
    ("GET", "/api/assignments/a-1/locations", None),
    ("GET", "/api/assignments/a-2/alerts", None),
    ("GET", "/api/assignments/a-1/measurements/series?agg=mean", None),
    ("GET", "/api/events?device=d-2", None),
    ("GET", "/api/devicestates/d-1", None),
    ("GET", "/api/devicestates/d-2", None),
    ("GET", "/api/tenants/usage/default", None),
    ("GET", "/api/tenants", None),
    ("GET", "/api/users", None),
    ("GET", "/api/rules", None),
    ("DELETE", "/api/devices/d-1", None),
    ("PUT", "/api/devicetypes/sensor", {"name": "Sensor 2"}),
    ("GET", "/api/search/local?pageSize=3", None),
    ("GET", "/api/instance/cluster/membership", None),
]
# keys whose values are wall-clock times, and the event id, which names
# the row's segment and slot: which segment a row lands in depends on
# when the store's 0.25 s flusher seals, in either package
_VOLATILE = {"created_s", "updated_s", "active_date_s", "last_login_s",
             "received_s", "event_id"}


def _normalise(doc, volatile=_VOLATILE):
    if isinstance(doc, dict):
        return {k: ("<volatile>" if k in volatile else _normalise(v))
                for k, v in sorted(doc.items())}
    if isinstance(doc, list):
        return [_normalise(v) for v in doc]
    return doc


def _gateway(pkg, data_dir):
    cfg_tree = {
        "instance": {"id": "rest-parity", "data_dir": str(data_dir)},
        "pipeline": {"width": 64, "registry_capacity": 1024,
                     "mtype_slots": 4, "deadline_ms": 5.0, "n_shards": 1},
        "presence": {"scan_interval_s": 3600.0, "missing_after_s": 1800},
        "checkpoint": {"interval_s": 0},
        "events": {"compact_interval_s": 0},
    }
    if pkg == "jax":
        from sitewhere_tpu.instance import Instance
        from sitewhere_tpu.runtime.config import Config
        from sitewhere_tpu.runtime.metrics import parse_exposition
        from sitewhere_tpu.web import WebServer

        inst = Instance(Config(cfg_tree, apply_env=False))
    else:
        from sitewhere_tpu_torch.instance import Instance
        from sitewhere_tpu_torch.runtime.config import Config
        from sitewhere_tpu_torch.runtime.metrics import parse_exposition
        from sitewhere_tpu_torch.web import WebServer

        inst = Instance(Config(cfg_tree, apply_env=False), device="cpu")
    inst.start()
    web = WebServer(inst, port=0, topology_interval_s=3600.0)
    web.start()
    return inst, web, parse_exposition


def _request(port, method, path, body=None, token=None):
    import http.client
    import json

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    headers = {"Authorization": f"Bearer {token}"} if token else {}
    conn.request(method, path, headers=headers,
                 body=json.dumps(body).encode() if body is not None else None)
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    ctype = resp.getheader("Content-Type") or ""
    if ctype.startswith("application/json"):
        return resp.status, json.loads(data)
    return resp.status, data.decode()


def _run_script(pkg, data_dir):
    inst, web, parse = _gateway(pkg, data_dir)
    try:
        status, login = _request(web.port, "POST", "/api/jwt",
                                 {"username": "admin",
                                  "password": "password"})
        assert status == 200, login
        tok = login.pop("token")
        out = [("POST /api/jwt", status, login)]
        for method, path, body in SCRIPT:
            status, doc = _request(web.port, method, path, body, tok)
            out.append((f"{method} {path}", status, doc))
        _, spec = _request(web.port, "GET", "/api/openapi.json")
        _, prom = _request(web.port, "GET", "/api/instance/metrics.prom")
        families = parse(prom)
    finally:
        web.stop()
        inst.stop()
        inst.terminate()
    return out, spec, families


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    root = tmp_path_factory.mktemp("rest-parity")
    return {pkg: _run_script(pkg, root / pkg) for pkg in ("jax", "torch")}


def test_same_requests_same_json_bodies(both):
    ref, port = both["jax"][0], both["torch"][0]
    assert [r[:2] for r in port] == [r[:2] for r in ref]
    for (what, _, want), (_, _, got) in zip(ref, port):
        assert _normalise(got) == _normalise(want), what
    # the writes landed: three measurements, a location and an alert
    # stored, and the state of d-1 is its newest measurement and location
    by_path = {what: doc for what, _, doc in port}
    assert by_path["GET /api/assignments/a-1/measurements"][
        "numResults"] == 2
    state = by_path["GET /api/devicestates/d-1"]
    assert state["last_location"]["lat"] == 12.5


def test_same_openapi_paths_132_routes(both):
    ref, port = both["jax"][1], both["torch"][1]
    pairs = {pkg: {(m, p) for p, ops in spec["paths"].items() for m in ops}
             for pkg, spec in (("jax", ref), ("torch", port))}
    assert len(pairs["torch"]) == 132
    assert pairs["torch"] == pairs["jax"]
    assert port["paths"] == ref["paths"]


def test_same_exposition_families(both):
    ref, port = both["jax"][2], both["torch"][2]
    common = set(ref) & set(port)
    assert len(common) >= 100
    for family in sorted(common):
        assert port[family]["type"] == ref[family]["type"], family
        assert set(port[family]["samples"]) == set(
            ref[family]["samples"]), family


# ---------------------------------------------------------------------------
# the gateway's own guards
# ---------------------------------------------------------------------------

def test_no_tensor_crosses_the_rest_boundary():
    import numpy as np

    from sitewhere_tpu_torch.web.http import jsonable

    assert jsonable({"n": np.int32(3), "f": np.float32(0.5)}) == {
        "n": 3, "f": 0.5}
    with pytest.raises(TypeError, match="REST boundary"):
        jsonable({"n": torch.tensor(3)})
    with pytest.raises(TypeError, match="REST boundary"):
        jsonable([torch.zeros(4)])


def test_cluster_view_is_single_host_and_membership_is_refused(tmp_path):
    """A standalone instance: the cluster view has no peers, and a
    membership change that would make it a fleet is refused with the
    reference's 400 (it must boot with ``rpc.peers``); the fabric's own
    membership cases run in ``tests/test_torch_migration.py``."""
    import http.client
    import json

    from sitewhere_tpu_torch.web import WebServer
    from torch_parity import CpuInstance, make_config

    inst = CpuInstance(make_config(tmp_path))
    inst.start()
    web = WebServer(inst, port=0, topology_interval_s=3600.0)
    web.start()
    try:
        _, login = _request(web.port, "POST", "/api/jwt",
                            {"username": "admin", "password": "password"})
        tok = login["token"]
        status, view = _request(web.port, "GET", "/api/instance/cluster",
                                token=tok)
        assert status == 200 and view["peers"] == {}
        assert view["local"]["instance"] == "test-instance"
        status, body = _request(web.port, "POST",
                                "/api/instance/cluster/membership",
                                {"peers": ["127.0.0.1:1", "127.0.0.1:2"]},
                                tok)
        assert status == 400 and "booted standalone" in body["error"]
        # an operator's bad body is still a 400, as in the reference
        conn = http.client.HTTPConnection("127.0.0.1", web.port, timeout=10)
        conn.request("POST", "/api/instance/cluster/membership",
                     body=json.dumps({"peers": []}).encode(),
                     headers={"Authorization": f"Bearer {tok}"})
        assert conn.getresponse().status == 400
        conn.close()
    finally:
        web.stop()
        inst.stop()
        inst.terminate()



def test_state_routes_read_on_the_epoch_stream(tmp_path, monkeypatch):
    """With CUDA streams mocked: the REST handler threads that read the
    device-state epoch (``/api/devicestates/{token}``, the tenant state
    summary) copy it off the card on the stream it was committed from,
    never on their own thread's stream."""
    import threading

    from sitewhere_tpu_torch.analytics import runner as port_runner
    from sitewhere_tpu_torch.rules import engine as port_engine
    from sitewhere_tpu_torch.web import WebServer
    from torch_parity import CpuInstance, make_config

    fakes = FakeStreams()
    monkeypatch.setattr(port_engine, "_new_stream", lambda device: "engine")
    monkeypatch.setattr(port_runner, "_new_stream",
                        lambda device: "analytics")
    monkeypatch.setattr(torch.cuda, "stream", fakes.stream)
    monkeypatch.setattr(torch.cuda, "current_stream", fakes.current)
    inst = CpuInstance(make_config(tmp_path))
    inst.device_state._stream = "epoch-stream"
    reads = []
    real_cpu = torch.Tensor.cpu

    def cpu_spy(self, *a, **kw):
        if threading.current_thread().name.startswith("Thread-"):
            reads.append(("cpu", torch.cuda.current_stream()))
        return real_cpu(self, *a, **kw)

    inst.start()
    web = WebServer(inst, port=0, topology_interval_s=3600.0)
    web.start()
    parts = inst.device_state.partitions
    real_view = parts.view
    monkeypatch.setattr(parts, "view", lambda *a: (
        reads.append(("view", torch.cuda.current_stream())),
        real_view(*a))[1])
    monkeypatch.setattr(torch.Tensor, "cpu", cpu_spy)
    try:
        _, login = _request(web.port, "POST", "/api/jwt",
                            {"username": "admin", "password": "password"})
        tok = login["token"]
        for method, path, body in SCRIPT[:5] + SCRIPT[11:14]:
            status, doc = _request(web.port, method, path, body, tok)
            assert status == 200, (path, doc)
        status, state = _request(web.port, "GET", "/api/devicestates/d-1",
                                 token=tok)
        assert status == 200 and state["last_values"][0] == 23.0
        status, summary = _request(web.port, "GET",
                                   "/api/tenants/default/state", token=tok)
        assert status == 200 and summary["devices_with_state"] == 2
    finally:
        monkeypatch.setattr(torch.Tensor, "cpu", real_cpu)
        web.stop()
        inst.stop()
        inst.terminate()
    assert {kind for kind, _ in reads} == {"cpu", "view"}
    assert all(stream == "epoch-stream" for _, stream in reads), reads
