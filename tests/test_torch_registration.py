"""The port's auto-registration against the JAX package's, on the CPU.

- The four cases of the reference's ``tests/test_registration.py`` run
  against the port (the same source, its imports pointing at the port).
- The same registration requests and unregistered events through both
  packages' ``RegistrationManager``, with and without a default device
  type, with a default area and customer, and with new devices refused:
  the same answers, ``registered`` / ``rejected`` counts, devices,
  assignments, mirror rows and identity handles, and the same log
  records.  A sender that holds a mirror row but no ``Device`` (written
  straight into the mirror) fails ``create_device`` with
  ``DuplicateToken``, logged with its traceback, as in the reference.
"""

import logging

import numpy as np
import pytest
import torch

import sitewhere_tpu.ids as ref_ids
import sitewhere_tpu.ingest.decoders as ref_dec
import sitewhere_tpu.services.device_management as ref_dm
import sitewhere_tpu.services.registration as ref_reg
import sitewhere_tpu_torch.ids as port_ids
import sitewhere_tpu_torch.ingest.decoders as port_dec
import sitewhere_tpu_torch.services.device_management as port_dm
import sitewhere_tpu_torch.services.registration as port_reg
from sitewhere_tpu_torch.runtime import checkpoint as port_ckpt
from test_torch_device_management import (
    normalize,
    port_test_module,
    reference_cases,
    run_port_case,
)

torch.set_num_threads(1)

PKGS = {"jax": (ref_ids, ref_dec, ref_dm, ref_reg),
        "torch": (port_ids, port_dec, port_dm, port_reg)}
CAP = 256

CASES = reference_cases("test_registration")


@pytest.mark.parametrize("case", CASES)
def test_reference_registration_case_on_the_port(case, tmp_path):
    run_port_case("test_registration", case, tmp_path)


def test_reference_registration_cases_were_found_and_run_the_port():
    assert len(CASES) == 4
    ns = port_test_module("test_registration")
    assert ns["RegistrationManager"] is port_reg.RegistrationManager


def world(pkg):
    ids, _, dm, _ = PKGS[pkg]
    mirror = (dm.RegistryMirror(CAP) if pkg == "jax"
              else dm.RegistryMirror(CAP, device="cpu"))
    identity = ids.IdentityMap(capacity=CAP)
    svc = dm.DeviceManagement("default", identity, mirror)
    svc.create_device_type(token="thermo", name="Thermostat")
    svc.create_device_type(token="meter", name="Meter")
    svc.create_area_type(token="site", name="Site")
    svc.create_area(token="hq", area_type="site", name="HQ")
    svc.create_customer_type(token="org", name="Org")
    svc.create_customer(token="acme", customer_type="org", name="Acme")
    svc.create_device(token="known", device_type="thermo")
    # a fleet device written straight into the mirror, with no Device
    mirror.set_device_row(identity.device.mint("mirror-only"), active=True,
                          tenant_id=0, device_type_id=0)
    return svc


def requests(pkg):
    dec = PKGS[pkg][1]
    R, M = dec.RequestKind.REGISTRATION, dec.RequestKind.MEASUREMENT
    return [
        dec.DecodedRequest(kind=R, device_token="new-1", ts_s=1),
        dec.DecodedRequest(kind=R, device_token="new-2", ts_s=2,
                           device_type_token="meter", area_token="hq",
                           customer_token="acme",
                           metadata={"coap_port": "5684"}),
        dec.DecodedRequest(kind=R, device_token="new-3", ts_s=3,
                           device_type_token="nope"),
        dec.DecodedRequest(kind=R, device_token="known", ts_s=4),
        dec.DecodedRequest(kind=R, device_token="mirror-only", ts_s=5),
        dec.DecodedRequest(kind=R, device_token="new-1", ts_s=6),
        dec.DecodedRequest(kind=R, device_token="new-4", ts_s=7,
                           area_token="nowhere", customer_token="nobody"),
    ], [
        dec.DecodedRequest(kind=M, device_token="ev-1", ts_s=8, mtype="t",
                           value=1.0),
        dec.DecodedRequest(kind=M, device_token="known", ts_s=9, mtype="t",
                           value=2.0),
        dec.DecodedRequest(kind=M, device_token="mirror-only", ts_s=10,
                           mtype="t", value=3.0),
        dec.DecodedRequest(kind=M, device_token="ev-1", ts_s=11, mtype="t",
                           value=4.0),
        dec.DecodedRequest(kind=M, device_token="ev-2", ts_s=12, mtype="t",
                           value=5.0, metadata={"tenant": "default"}),
    ]


SETTINGS = {
    "default-type": dict(default_device_type="thermo"),
    "defaults": dict(default_device_type="thermo", default_area="hq",
                     default_customer="acme"),
    "no-default": dict(),
    "closed": dict(default_device_type="thermo", allow_new_devices=False),
    "no-assign": dict(default_device_type="thermo", auto_assign=False),
}


def run(pkg, setting, caplog):
    svc = world(pkg)
    mgr = PKGS[pkg][3].RegistrationManager(svc, **SETTINGS[setting])
    regs, events = requests(pkg)
    caplog.clear()
    with caplog.at_level(logging.DEBUG):
        answers = [mgr.handle_registration(r) for r in regs]
        replay = mgr.process_unregistered(events)
    logs = [(r.levelname, r.getMessage(), r.exc_info is not None
             and type(r.exc_info[1]).__name__) for r in caplog.records
            if r.name.endswith(".registration")]
    return svc, mgr, {
        "answers": answers,
        "replay": [(r.device_token, r.ts_s) for r in replay],
        "replay_is_original": all(r in events for r in replay),
        "counts": (mgr.registered, mgr.rejected),
        "devices": normalize(svc.devices),
        "assignments": normalize(list(svc.assignments.values())),
        "logs": logs,
    }


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_registration_matches_the_reference(setting, caplog):
    ref_svc, _, a = run("jax", setting, caplog)
    svc, mgr, b = run("torch", setting, caplog)
    # assignment tokens are minted per process: compare all but the token
    for doc in (a, b):
        for asg in doc["assignments"]:
            asg.pop("token")
    assert b == a
    assert b["replay_is_original"]
    for name in port_ckpt._MIRROR_ARRAYS:
        x = np.asarray(getattr(ref_svc.mirror, name))
        y = np.asarray(getattr(svc.mirror, name))
        assert x.tobytes() == y.tobytes(), name
    assert ref_svc.identity.device.tokens() == svc.identity.device.tokens()
    if setting == "default-type":
        # the mirror-only sender fails create_device, with its traceback
        assert ("ERROR", "auto-registration of mirror-only failed",
                "DuplicateToken") in b["logs"]
        assert b["counts"] == (5, 3)
    if setting == "no-default":
        assert not any(b["answers"][:1]) and b["replay"] == [
            ("known", 9)]
