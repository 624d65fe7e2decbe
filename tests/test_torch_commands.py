"""The port's command delivery against the JAX package's, on the CPU.

- Encoders: the JSON and binary encodings of the same executions (every
  parameter type) are byte-identical between the packages, and the
  binary one decodes back to its parameters in both.
- The processor: the same invocations (good ones; missing, unknown and
  uncoercible parameters; unknown commands and assignments; an int32 out
  of range) through both packages' ``CommandProcessor`` deliver the same
  bytes and dead-letter with the same reasons; both routers pick the same
  destinations; retries of a transient failure run the same schedule.
- The transports: the HTTP provider against a loopback ``http.server``,
  the CoAP provider against a loopback UDP device speaking the port's
  codec, both packages' requests equal; the CoAP codec byte-identical;
  the MQTT provider over an injected client, and the MQTT client's
  packet helpers equal.
- The reference's own ``tests/test_commands.py`` cases run against the
  port, its two ``Instance`` cases among them (each on a CPU
  ``Instance``).
"""

import http.server
import socket
import threading

import pytest
import torch

import sitewhere_tpu.commands as ref_cmd
import sitewhere_tpu.ids as ref_ids
import sitewhere_tpu.ingest.coap as ref_coap
import sitewhere_tpu.ingest.mqtt as ref_mqtt
import sitewhere_tpu.runtime.resilience as ref_res
import sitewhere_tpu.services.device_management as ref_dm
import sitewhere_tpu_torch.commands as port_cmd
import sitewhere_tpu_torch.ids as port_ids
import sitewhere_tpu_torch.ingest.coap as port_coap
import sitewhere_tpu_torch.ingest.mqtt as port_mqtt
import sitewhere_tpu_torch.runtime.resilience as port_res
import sitewhere_tpu_torch.services.device_management as port_dm
from sitewhere_tpu.commands import destinations as ref_dest
from sitewhere_tpu_torch.commands import destinations as port_dest
from sitewhere_tpu_torch.commands.model import CommandExecution
from test_torch_device_management import port_test_module, reference_cases

torch.set_num_threads(1)

PKGS = {
    "jax": (ref_cmd, ref_dest, ref_ids, ref_dm, ref_res),
    "torch": (port_cmd, port_dest, port_ids, port_dm, port_res),
}

PARAMS = [("target", "double", True), ("mode", "string", False),
          ("retries", "int32", False), ("big", "int64", False),
          ("urgent", "bool", False), ("blob", "bytes", False)]


def make_dm(pkg):
    _, _, ids, dm, _ = PKGS[pkg]
    mirror = (dm.RegistryMirror(256) if pkg == "jax"
              else dm.RegistryMirror(256, device="cpu"))
    svc = dm.DeviceManagement("default", ids.IdentityMap(capacity=256),
                              mirror)
    svc.create_device_type(token="thermo", name="Thermostat")
    svc.create_device_type(token="meter", name="Meter")
    svc.create_device_type(token="cam", name="Cam")
    svc.create_device_command("thermo", token="set-point", name="setPoint",
                              namespace="http://acme/thermo",
                              parameters=PARAMS)
    svc.create_device_command("meter", token="reset", name="reset")
    svc.create_device_command("cam", token="snap", name="snap")
    for dev, dtype, meta in (("d-1", "thermo", {"phone_number": "+1555"}),
                             ("m-1", "meter", {}), ("c-1", "cam", {})):
        svc.create_device(token=dev, device_type=dtype, metadata=meta)
        svc.create_device_assignment(token=f"a-{dev}", device=dev)
    return svc


INVOCATIONS = [
    ("set-point", "a-d-1", {"target": 21.5, "mode": "eco", "urgent": True,
                            "retries": -2, "big": -(1 << 40),
                            "blob": b"\x00\xff"}),
    ("set-point", "a-d-1", {"target": "19.0", "urgent": "yes",
                            "retries": "7", "blob": "text"}),
    ("set-point", "a-d-1", {"target": 0.0, "urgent": 0, "mode": 12}),
    ("set-point", "a-d-1", {}),
    ("set-point", "a-d-1", {"target": 1.0, "nope": 2}),
    ("set-point", "a-d-1", {"target": "not-a-number"}),
    ("set-point", "a-d-1", {"target": 1.0, "retries": 1 << 31}),
    ("set-point", "a-d-1", {"target": 1.0, "big": 1 << 63}),
    ("missing-cmd", "a-d-1", {}),
    ("set-point", "a-404", {"target": 1.0}),
    ("reset", "a-m-1", {}),
    ("snap", "a-c-1", {}),
]


def run_processor(pkg, encoder_name, router):
    cmd, dest, _, _, _ = PKGS[pkg]
    dm = make_dm(pkg)
    seen = {"thermo-dest": [], "meter-dest": []}
    dead = []

    def dest_of(name):
        return cmd.CommandDestination(
            name, getattr(cmd, encoder_name)(), cmd.TopicParameterExtractor(),
            cmd.CallbackDeliveryProvider(
                lambda ex, payload, params: seen[name].append(
                    (payload, params))))

    routers = {
        "mapping": cmd.DeviceTypeMappingRouter(
            {"thermo": "thermo-dest", "meter": "meter-dest"}),
        "mapping-default": cmd.DeviceTypeMappingRouter(
            {"meter": "meter-dest"}, default="thermo-dest"),
        "single": cmd.SingleDestinationRouter("meter-dest"),
    }
    proc = cmd.CommandProcessor(
        dm, destinations=[dest_of("thermo-dest"), dest_of("meter-dest")],
        router=routers[router],
        on_undelivered=lambda inv, why: dead.append((inv.token, why)))
    ok = []
    for i, (command, assignment, values) in enumerate(INVOCATIONS):
        ok.append(proc.invoke(cmd.CommandInvocation(
            command_token=command, target_assignment=assignment,
            parameter_values=dict(values), token=f"inv-{i}")))
    return ok, seen, dead, (proc.delivered, proc.undelivered)


@pytest.mark.parametrize("encoder", ["BinaryCommandEncoder",
                                     "JsonCommandEncoder"])
@pytest.mark.parametrize("router", ["mapping", "mapping-default", "single"])
def test_processor_delivers_and_dead_letters_as_the_reference(encoder,
                                                              router):
    a = run_processor("jax", encoder, router)
    b = run_processor("torch", encoder, router)
    assert a == b
    ok, seen, dead, counts = b
    assert any(ok) and not all(ok)
    assert sum(len(v) for v in seen.values()) == counts[0] == sum(ok)
    assert len(dead) == counts[1] == len(ok) - sum(ok)


def _execution(pkg, params, token="inv-x"):
    cmd = PKGS[pkg][0]
    return cmd.CommandExecution(
        invocation=cmd.CommandInvocation(
            command_token="c", target_assignment="a", token=token,
            device_token="dev-7", device_type_token="thermo",
            tenant="default"),
        command_name="setPoint", namespace="http://acme/thermo",
        parameters=params, device_metadata={"phone_number": "+15550123"})


EXECUTIONS = [
    [],
    [("target", "double", 21.5), ("mode", "string", "eco ünï")],
    [("retries", "int32", -2), ("big", "int64", (1 << 63) - 1),
     ("small", "int64", -(1 << 63)), ("urgent", "bool", True),
     ("off", "bool", False)],
    [("blob", "bytes", b"\x00\x01" * 200), ("nan", "double", float("inf"))],
]


@pytest.mark.parametrize("i", range(len(EXECUTIONS)))
@pytest.mark.parametrize("encoder", ["BinaryCommandEncoder",
                                     "JsonCommandEncoder"])
def test_encoders_are_byte_identical(i, encoder):
    a = getattr(ref_cmd, encoder)()(_execution("jax", EXECUTIONS[i]))
    b = getattr(port_cmd, encoder)()(_execution("torch", EXECUTIONS[i]))
    assert a == b
    if encoder == "BinaryCommandEncoder":
        doc = port_cmd.decode_binary_execution(b)
        assert doc == ref_cmd.decode_binary_execution(a)
        assert doc["invocation"] == "inv-x"
        assert doc["parameters"] == {n: v for n, _, v in EXECUTIONS[i]}


@pytest.mark.parametrize("payload", [
    b"", b"\x00\x01junk", b"\xc7\x09", b"\xc7\x01\x05ab",
    b"\xc7\x01\x01a\x01b\x01c\x01\x01p\x09",
    b"\xc7\x01\x01a\x01b\x01c\x01\x01p\x01\x00\x00",
    b"\xc7\x01\x01a\x01b\x01c\x01\x01p\x05\x09ab",
])
def test_binary_decoder_errors_match(payload):
    def outcome(mod):
        try:
            return ("ok", mod.decode_binary_execution(payload))
        except Exception as e:  # noqa: BLE001
            return (type(e).__name__, str(e))

    assert outcome(port_cmd) == outcome(ref_cmd)
    assert outcome(port_cmd)[0] == "ValidationError"


@pytest.mark.parametrize("params", [[("x", "float16", 1.0)],
                                    [("x", "int64", 1 << 64)]])
def test_encoder_validation_errors_match(params):
    def outcome(pkg):
        try:
            return PKGS[pkg][0].BinaryCommandEncoder()(
                _execution(pkg, params))
        except Exception as e:  # noqa: BLE001
            return (type(e).__name__, str(e))

    assert outcome("torch") == outcome("jax")
    assert outcome("torch")[0] == "ValidationError"


class _Flaky:
    def __init__(self, failures):
        self.failures = failures
        self.calls = 0

    def deliver(self, execution, payload, params):
        self.calls += 1
        if self.calls <= self.failures:
            raise OSError(f"transient {self.calls}")


@pytest.mark.parametrize("failures", [0, 2, 5])
def test_destination_retry_matches_the_reference(failures):
    def outcome(pkg):
        cmd, dest, _, _, res = PKGS[pkg]
        flaky = _Flaky(failures)
        d = cmd.CommandDestination(
            "d", cmd.JsonCommandEncoder(), cmd.TopicParameterExtractor(),
            cmd.CallbackDeliveryProvider(flaky.deliver),
            retry=res.RetryPolicy(initial_s=0.0, max_s=0.0, max_attempts=3))
        try:
            d.deliver(_execution(pkg, []))
            return ("ok", flaky.calls)
        except dest.DeliveryError as e:
            return ("DeliveryError", str(e), flaky.calls)

    assert outcome("torch") == outcome("jax")


def test_call_with_retry_refuses_an_unbounded_policy():
    for res in (ref_res, port_res):
        with pytest.raises(ValueError):
            res.call_with_retry(lambda: 1, res.RetryPolicy())


def test_backoff_schedule_matches_the_reference():
    def schedule(res):
        b = res.Backoff(res.RetryPolicy(initial_s=0.5, factor=3.0, max_s=20.0,
                                        jitter=0.2), seed=7, name="t")
        out = [b.next_delay() for _ in range(6)]
        b.reset()
        return out + [b.attempt]

    assert schedule(port_res) == schedule(ref_res)


# -- transports ----------------------------------------------------------------

def _http_server(status=200):
    class Handler(http.server.BaseHTTPRequestHandler):
        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            self.server.requests.append(
                (self.path, self.headers.get("Content-Type"),
                 self.rfile.read(n)))
            self.send_response(self.server.status)
            self.end_headers()

        def log_message(self, *args):
            pass

    srv = http.server.HTTPServer(("127.0.0.1", 0), Handler)
    srv.requests = []
    srv.status = status
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


@pytest.mark.parametrize("status", [200, 204, 302, 401, 503])
def test_http_provider_posts_as_the_reference(status):
    srv = _http_server(status)
    try:
        outcomes = []
        for pkg in ("jax", "torch"):
            _, dest, _, _, _ = PKGS[pkg]
            provider = dest.HttpDeliveryProvider(
                f"http://127.0.0.1:{srv.server_address[1]}/gw/Messages?a=1",
                field_map={"To": "{phone}", "From": "+15550100",
                           "Body": "{payload}", "Dev": "{device}"},
                headers={"X-Test": "1"})
            ex = _execution(pkg, [])
            params = dest.SmsParameterExtractor()(ex)
            try:
                provider.deliver(ex, b"reboot now & then", params)
                outcomes.append("ok")
            except dest.DeliveryError as e:
                outcomes.append(str(e))
        assert outcomes[0] == outcomes[1]
        assert (outcomes[1] == "ok") == (200 <= status < 300)
        assert len(srv.requests) == 2
        assert srv.requests[0] == srv.requests[1]
        path, ctype, body = srv.requests[1]
        assert path == "/gw/Messages?a=1"
        assert ctype == "application/x-www-form-urlencoded"
        assert b"Body=reboot+now+%26+then" in body
    finally:
        srv.shutdown()
        srv.server_close()


def test_http_provider_refuses_a_missing_parameter():
    for pkg in ("jax", "torch"):
        _, dest, _, _, _ = PKGS[pkg]
        provider = dest.HttpDeliveryProvider("http://127.0.0.1:9/x")
        with pytest.raises(dest.DeliveryError, match="phone"):
            provider.deliver(None, b"x", {"phone": ""})
        with pytest.raises(ValueError):
            dest.HttpDeliveryProvider("ftp://127.0.0.1/x")


def _coap_device(replies):
    """A loopback CoAP device: answers each CON with ACK ``code``, in
    turn from ``replies``; returns (port, received payloads, thread)."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.bind(("127.0.0.1", 0))
    sock.settimeout(5.0)
    got = []

    def serve():
        try:
            for code in replies:
                data, addr = sock.recvfrom(65536)
                req = port_coap.parse_message(data)
                got.append((req.code, req.option(port_coap.OPT_URI_PATH),
                            req.payload))
                sock.sendto(port_coap.encode_message(port_coap.CoapMessage(
                    mtype=port_coap.ACK, code=code,
                    message_id=req.message_id, token=req.token)), addr)
        finally:
            sock.close()

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    return sock.getsockname()[1], got, t


def test_coap_provider_delivers_as_the_reference():
    replies = [port_coap.CHANGED_204, port_coap.CHANGED_204,
               (4 << 5) | 4, (4 << 5) | 4]
    port, got, t = _coap_device(replies)
    outcomes = []
    for code in replies[::2]:
        for pkg in ("jax", "torch"):
            _, dest, _, _, _ = PKGS[pkg]
            ex = _execution(pkg, [("delay", "int32", 5)])
            params = dest.CoapParameterExtractor(
                default_port=port, path="commands/{tenant}/{device}")(ex)
            try:
                dest.CoapDeliveryProvider(ack_timeout_s=1.0).deliver(
                    ex, b'{"command":"reboot"}', params)
                outcomes.append((pkg, "ok"))
            except dest.DeliveryError as e:
                outcomes.append((pkg, str(e)))
    t.join(5.0)
    assert [o for _, o in outcomes] == ["ok", "ok", "coap error 4.04",
                                        "coap error 4.04"]
    assert len(got) == 4 and got[0] == got[1]
    assert got[0] == (port_coap.POST, b"commands",
                      b'{"command":"reboot"}')


@pytest.mark.parametrize("msg", [
    dict(mtype=0, code=2, message_id=0x1234, token=b"\x01\x02",
         options=[(11, b"commands"), (11, b"dev-7"), (12, b"\x32")],
         payload=b'{"a":1}'),
    dict(mtype=2, code=(2 << 5) | 4, message_id=7, token=b"", options=[],
         payload=b""),
    dict(mtype=1, code=3, message_id=65535, token=b"12345678",
         options=[(11, b"x" * 20), (300, b"y" * 300), (2000, b"")],
         payload=b"\x00" * 40),
])
def test_coap_codec_is_byte_identical(msg):
    a = ref_coap.encode_message(ref_coap.CoapMessage(**msg))
    b = port_coap.encode_message(port_coap.CoapMessage(**msg))
    assert a == b
    pa, pb = ref_coap.parse_message(a), port_coap.parse_message(b)
    assert (pa.mtype, pa.code, pa.message_id, pa.token, pa.options,
            pa.payload) == (pb.mtype, pb.code, pb.message_id, pb.token,
                            pb.options, pb.payload)
    assert ref_coap.encode_post("a/b/c", b"p", message_id=9, token=b"t") == \
        port_coap.encode_post("a/b/c", b"p", message_id=9, token=b"t")


@pytest.mark.parametrize("data", [b"", b"\x40", b"\x80\x01\x00\x01",
                                  b"\x4f\x01\x00\x01", b"\x40\x01\x00\x01\xff"])
def test_coap_parse_errors_match(data):
    def outcome(mod):
        try:
            return ("ok", mod.parse_message(data).code)
        except mod.CoapError as e:
            return ("CoapError", str(e))

    assert outcome(port_coap) == outcome(ref_coap)


class _Client:
    def __init__(self):
        self.published = []
        self.disconnected = False

    def publish(self, topic, payload, qos=0):
        self.published.append((topic, payload, qos))

    def disconnect(self):
        self.disconnected = True


def test_mqtt_provider_publishes_as_the_reference():
    published = []
    for pkg in ("jax", "torch"):
        cmd, dest, _, _, _ = PKGS[pkg]
        client = _Client()
        provider = dest.MqttDeliveryProvider("broker", qos=1, client=client)
        d = cmd.CommandDestination(
            "mqtt", cmd.BinaryCommandEncoder(),
            cmd.TopicParameterExtractor(
                command_topic="sw/{tenant}/{type}/{device}"), provider)
        provider.start()
        d.deliver(_execution(pkg, [("delay", "int32", 5)]))
        provider.stop()
        assert client.disconnected
        with pytest.raises(dest.DeliveryError, match="not started"):
            provider.deliver(None, b"", {"topic": "t"})
        published.append(client.published)
    assert published[0] == published[1]
    assert published[1][0][0] == "sw/default/thermo/dev-7"


@pytest.mark.parametrize("n", [0, 1, 127, 128, 16383, 16384, 2097152,
                               268435455])
def test_mqtt_packet_helpers_match(n):
    assert port_mqtt._encode_remaining(n) == ref_mqtt._encode_remaining(n)
    assert port_mqtt._utf8("sw/ü/" * (n % 7)) == ref_mqtt._utf8(
        "sw/ü/" * (n % 7))


def test_mqtt_client_round_trip_over_loopback():
    """The port's client publishes to a loopback broker stand-in that
    reads CONNECT and PUBLISH with the reference's framing."""
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    got = []

    def broker():
        conn, _ = srv.accept()
        conn.settimeout(5.0)
        with conn:
            for _ in range(2):
                head = conn.recv(1)
                length, mult = 0, 1
                while True:
                    b = conn.recv(1)[0]
                    length += (b & 0x7F) * mult
                    mult *= 128
                    if not b & 0x80:
                        break
                body = b""
                while len(body) < length:
                    body += conn.recv(length - len(body))
                got.append((head[0] >> 4, body))
                if head[0] >> 4 == ref_mqtt.CONNECT:
                    conn.sendall(bytes([ref_mqtt.CONNACK << 4, 2, 0, 0]))

    t = threading.Thread(target=broker, daemon=True)
    t.start()
    client = port_mqtt.MqttClient("127.0.0.1", srv.getsockname()[1],
                                  client_id="c-1")
    client.connect()
    client.publish("sw/command/d-1", b"\xc7\x01payload", qos=0)
    t.join(5.0)
    client.disconnect()
    srv.close()
    assert [k for k, _ in got] == [ref_mqtt.CONNECT, ref_mqtt.PUBLISH]
    assert got[1][1] == port_mqtt._utf8("sw/command/d-1") + b"\xc7\x01payload"


# -- the reference's own command tests, run against the port -----------------

CASES = reference_cases("test_commands")


@pytest.mark.parametrize("case", CASES)
def test_reference_commands_case_on_the_port(case, tmp_path):
    from test_torch_device_management import run_port_case

    run_port_case("test_commands", case, tmp_path)


def test_reference_command_cases_were_found_and_run_the_port():
    assert len(CASES) == 12
    ns = port_test_module("test_commands")
    assert ns["CommandProcessor"] is port_cmd.CommandProcessor
    assert CommandExecution is port_cmd.CommandExecution
