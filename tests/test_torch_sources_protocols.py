"""The protocol receivers in the port, against the reference.

The reference's own cases for the CoAP server and the WebSocket client
(``tests/test_coap_ws_receivers.py``), the hosted MQTT broker
(``test_mqtt_broker.py``), AMQP 0-9-1 (``test_amqp.py``), AMQP 1.0
(``test_amqp10.py``) and STOMP (the frame codec and receiver cases of
``test_stomp_http.py``, with its SMS-gateway command cases), run against
the port with their imports rewritten (``tests/torch_parity.py
port_test_module``): each drives the port's receiver against an
in-process broker or client over loopback sockets, and the
``Instance`` cases feed the port ``Instance`` on the CPU, and the
outbound ``HttpConnector`` and index-push cases of ``test_stomp_http.py``
post to a loopback HTTP server.
"""

from __future__ import annotations

import os

import pytest
import torch

from torch_parity import port_cases, port_test_module, run_port_case

torch.set_num_threads(1)
TESTS = os.path.dirname(os.path.abspath(__file__))

# module -> (cases left out, source edits)
MODULES = {
    "test_coap_ws_receivers.py": ((), ()),
    "test_mqtt_broker.py": ((), ()),
    "test_amqp.py": ((), ()),
    "test_amqp10.py": ((), ()),
    "test_stomp_http.py": ((), ()),
}
_NS = {}


def _ns(module):
    if module not in _NS:
        _NS[module] = port_test_module(os.path.join(TESTS, module),
                                       replace=MODULES[module][1])
    return _NS[module]


CASES = [(module, case) for module, (skip, _) in MODULES.items()
         for case in port_cases(_ns(module), skip=skip)]


def test_the_port_runs_the_reference_protocol_cases():
    by_module = {}
    for module, _ in CASES:
        by_module[module] = by_module.get(module, 0) + 1
    assert by_module["test_coap_ws_receivers.py"] >= 18
    assert by_module["test_mqtt_broker.py"] >= 14
    assert by_module["test_amqp.py"] >= 10
    assert by_module["test_amqp10.py"] >= 9
    assert by_module["test_stomp_http.py"] >= 14


@pytest.mark.parametrize("module,case", CASES,
                         ids=[f"{m[5:-3]}::{c}" for m, c in CASES])
def test_reference_protocol_case_on_the_port(module, case, tmp_path,
                                             monkeypatch):
    run_port_case(_ns(module), case, tmp_path,
                  fixtures={"monkeypatch": monkeypatch})
