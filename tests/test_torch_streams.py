"""Device streams in the port against the reference.

The reference's own ``tests/test_streams.py`` runs against the port with
its imports rewritten (``tests/torch_parity.py port_test_module``): the
journal-backed chunk store (create, list, ordered chunks, last write
wins per sequence number, paging, durability across a restart, a torn
tail dropped, mid-file corruption refused), the request-level manager
against the active assignment (create acks, isolation between devices,
send-back) and stream requests over a TCP source into the port
``Instance`` on the CPU.  The same request sequence then goes through
both packages' managers, with equal acks, contents and errors.
"""

from __future__ import annotations

import functools
import os

import pytest
import torch

from sitewhere_tpu_torch.services import device_management as port_dm
from torch_parity import port_cases, port_test_module, run_port_case

torch.set_num_threads(1)
TESTS = os.path.dirname(os.path.abspath(__file__))
REF = os.path.join(TESTS, "test_streams.py")


def _port_module():
    ns = port_test_module(REF)
    # the fixture's registry mirror on the CPU
    ns["RegistryMirror"] = functools.partial(port_dm.RegistryMirror,
                                             device="cpu")
    return ns


@pytest.fixture(scope="module")
def port_ns():
    return _port_module()


CASES = port_cases(_port_module())


def test_the_port_runs_every_reference_stream_case():
    assert len(CASES) == 15
    assert "test_device_streams_over_wire_source" in CASES


@pytest.mark.parametrize("case", CASES)
def test_reference_stream_case_on_the_port(port_ns, case, tmp_path):
    run_port_case(port_ns, case, tmp_path)


def _script(pkg, root):
    """One request sequence through a package's stream manager: its acks,
    assembled contents, send-backs and error classes."""
    if pkg == "jax":
        from sitewhere_tpu.ids import IdentityMap
        from sitewhere_tpu.services import common, streams
        from sitewhere_tpu.services.device_management import (
            DeviceManagement,
            RegistryMirror,
        )
        mirror = RegistryMirror(capacity=64, max_zones=4, max_verts=4)
    else:
        from sitewhere_tpu_torch.ids import IdentityMap
        from sitewhere_tpu_torch.services import common, streams
        from sitewhere_tpu_torch.services.device_management import (
            DeviceManagement,
            RegistryMirror,
        )
        mirror = RegistryMirror(capacity=64, max_zones=4, max_verts=4,
                                device="cpu")
    dm = DeviceManagement("default", IdentityMap(capacity=64), mirror)
    dm.create_device_type(token="cam", name="Cam")
    for i in range(3):
        dm.create_device(token=f"cam-{i}", device_type="cam")
        if i != 1:
            dm.create_device_assignment(device=f"cam-{i}")
    store = streams.DeviceStreamManagement(str(root))
    acks = []
    mgr = streams.DeviceStreamManager(
        dm, store, deliver_command=lambda tok, cmd: acks.append((tok, cmd)))
    out = []

    def call(fn, *args):
        try:
            r = fn(*args)
            out.append(r.value if hasattr(r, "value") else
                       (r.sequence_number, r.data) if hasattr(r, "data")
                       else r)
        except common.ServiceError as e:
            out.append(type(e).__name__)

    for dev, sid in (("cam-0", "a"), ("cam-0", "a"), ("cam-0", ""),
                     ("cam-1", "a"), ("cam-2", "a"), ("cam-9", "a")):
        call(mgr.handle_device_stream_request, dev, sid, "video/mp4")
    for seq, data in ((2, b"cc"), (0, b"aa"), (1, b"bb"), (0, b"AA")):
        call(mgr.handle_device_stream_data_request, "cam-0", "a", seq, data)
    call(mgr.handle_device_stream_data_request, "cam-0", "zz", 0, b"x")
    call(mgr.handle_device_stream_data_request, "cam-2", "a", 5, b"other")
    for dev, seq in (("cam-0", 1), ("cam-0", 7), ("cam-2", 5),
                     ("cam-1", 0)):
        call(mgr.handle_send_device_stream_data_request, dev, "a", seq)
    tokens = {}
    for dev in ("cam-0", "cam-2"):
        a = dm.get_active_assignment(dev)
        s = store.get_assignment_stream(a.token, "a")
        tokens[dev] = store.stream_content(s.token)
    store.stop()
    store.terminate()
    return out, [(t, {k: v for k, v in c.items()}) for t, c in acks], tokens


def test_one_request_sequence_through_both_managers(tmp_path):
    ref = _script("jax", tmp_path / "jax")
    got = _script("torch", tmp_path / "torch")
    assert got == ref
    assert ref[2] == {"cam-0": b"AAbbcc", "cam-2": b"other"}
