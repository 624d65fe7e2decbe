"""The port's tools and the native tier's switches.

- ``tools/torch_fleet_chaos_bench.py --smoke --device cpu``: three port
  ``Instance``s over localhost RPC through baseline, shed, partition and
  recover, held to the reference test's asserts
  (``tests/test_chaos.py TestFleetChaosBench``).
- ``tools/torch_crashrec_bench.py --smoke --device cpu``: the six fixed
  kill points, held to the reference test's asserts
  (``tests/test_chaos.py TestCrashRecBench``).
- The switches: ``SW_NATIVE=0`` takes the pure-Python lanes with the same
  packed columns as the C lanes, ``SW_NATIVE_FILL=0`` gives the same
  packed columns as fill-direct, and a missing ``SW_NATIVE_LIB`` raises
  (the reference falls back to the Python lane there; the port does not).
- ``tools/torch_native_sanitize.sh`` (slow, as the reference's gate).
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from sitewhere_tpu_torch.pipeline.packed import BATCH_I
from torch_parity import CpuInstance, make_config

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tool(name, *args, timeout):
    env = dict(os.environ)
    env.pop("SW_CRASHPOINT", None)
    return subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", name), *args],
        capture_output=True, text=True, timeout=timeout, env=env, cwd=REPO)


def test_fleet_chaos_smoke_shed_partition_recover(tmp_path):
    out = tmp_path / "fleet.json"
    res = _tool("torch_fleet_chaos_bench.py", "--smoke", "--device", "cpu",
                "--json", str(out), timeout=240)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    doc = json.loads(out.read_text())
    assert doc["ok"] and doc["device"] == "cpu"
    # the scripted failure walked the detector where it should
    assert doc["state_after_partition"] in ("SUSPECT", "DOWN")
    assert doc["edge_refusal"]["refused"]
    # bounded probes while unhealthy, zero forward dead letters, spool
    # drained, at-least-once toward the sick host
    for phase in ("shed", "partition"):
        p = doc["phases"][phase]
        assert p["sick_ingest_attempts"] <= p["attempt_budget"]
    assert doc["forward_dead_lettered"] == 0
    assert doc["pending_after_recovery"] == 0
    assert doc["sick_accepted_rows"] >= doc["sick_sent_rows"] > 0
    assert doc["phases"]["shed"]["health"]["overload"] == "SHEDDING"


def test_crashrec_smoke_six_kill_points(tmp_path):
    out = tmp_path / "crashrec.json"
    res = _tool("torch_crashrec_bench.py", "--smoke", "--device", "cpu",
                "--json", str(out), timeout=560)
    assert res.returncode == 0, res.stdout + res.stderr
    doc = json.loads(out.read_text())
    assert doc["ok"] and doc["summary"]["killed"] == 6
    points = {k["point"] for k in doc["kills"]}
    assert {"crash.mid_seal", "crash.mid_compact",
            "crash.mid_forward"} <= points
    for kill in doc["kills"]:
        assert kill["killed"] and not kill["failures"]
        if kill["point"] == "crash.mid_forward":
            # fleet-shaped case: the spool tail replayed to the owner's
            # journal and drained to zero
            assert kill["spool_pending_after"] == 0
            assert kill["owner_journal_rows"] >= kill["spooled_rows"]
        else:
            assert kill["restore_s"] is not None


def test_crashrec_catalogs_are_the_references():
    import importlib.util

    def load(name):
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(REPO, "tools", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    port = load("torch_crashrec_bench")
    ref_src = open(os.path.join(REPO, "tools", "crashrec_bench.py")).read()
    for point, hit in port.SMOKE_KILLS:
        assert f'("{point}", {hit})' in ref_src
    assert len(port.SMOKE_KILLS) == 6
    assert set(port.SWEEP_CATALOG) == {
        "crash.mid_ring", "crash.post_journal", "crash.mid_egress",
        "crash.mid_seal", "crash.mid_compact", "crash.mid_checkpoint",
        "crash.pre_manifest", "crash.mid_forward"}


# ---------------------------------------------------------------------------
# the native tier's switches
# ---------------------------------------------------------------------------

N_DEV = 24
WIDTH = 64


def _payload(k, names=("temp",)):
    lines = []
    for r in range(WIDTH):
        i = k * WIDTH + r
        lines.append(json.dumps({
            "deviceToken": f"d-{i % N_DEV}", "type": "DeviceMeasurements",
            "request": {"name": names[i % len(names)],
                        "value": float(i % 37) + 0.25,
                        "eventDate": 1_754_000_000_000 + 1000 * i}},
            separators=(",", ":")))
    return "\n".join(lines).encode()


def _packed_run(tmp_path, name, payloads):
    """The packed (bi, bf) of every plan the payloads make, the device
    state after them and the instance's decode-copy counter."""
    inst = CpuInstance(make_config(tmp_path / name, ring_depth=0))
    dm = inst.device_management
    dm.create_device_type(token="sensor", name="Sensor")
    for i in range(N_DEV):
        dm.create_device(token=f"d-{i}", device_type="sensor")
        dm.create_device_assignment(device=f"d-{i}")
    inst.start()
    disp = inst.dispatcher
    staged = []
    real = disp._stage_packed

    def capture(bi, bf):
        staged.append((np.array(bi, copy=True), np.array(bf, copy=True)))
        return real(bi, bf)

    disp._stage_packed = capture
    try:
        for p in payloads:
            disp.ingest_wire_lines(p, "switch")
        disp.flush()
        state = inst.device_state.snapshot_host()
        copied = int(inst.metrics.counter(
            "pipeline.bytes_copied.decode").value)
        names = inst.identity.mtype.tokens()
        ids = [inst.identity.mtype.mint(n) for n in names]
    finally:
        inst.stop()
        inst.terminate()
    return _by_name(staged, state, dict(zip(names, ids))), copied


def _by_name(staged, state, minted):
    """``(staged, state)`` with the minted measurement-type ids renumbered
    in name order.  Ids are handles minted in the decode's order: the C
    lanes mint in first-appearance order, the Python lane (like the
    reference's) over ``set(names)``, whose order follows the process's
    string hash seed, so the same payloads can mint other ids."""
    order = sorted(minted)
    new_of = {minted[n]: k for k, n in enumerate(order)}
    row = BATCH_I.index("mtype_id")
    out = []
    for bi, bf in staged:
        bi = bi.copy()
        bi[row] = [new_of.get(int(v), int(v)) for v in bi[row]]
        out.append((bi, bf))
    slots = state["last_values"].shape[1]
    perm = list(range(slots))
    for old, new in new_of.items():
        perm[new % slots] = old % slots
    state = {k: (v[:, perm] if v.ndim > 1 and v.shape[1] == slots else v)
             for k, v in state.items()}
    return out, state


def _assert_same(a, b):
    ((sa, st_a), _), ((sb, st_b), _) = a, b
    assert len(sa) == len(sb) > 0
    for (ai, af), (bi, bf) in zip(sa, sb):
        assert ai.tobytes() == bi.tobytes()
        assert af.tobytes() == bf.tobytes()
    for k in st_a:
        assert st_a[k].tobytes() == st_b[k].tobytes(), k


def test_fill_off_gives_the_fill_direct_columns(tmp_path, monkeypatch):
    payloads = [_payload(k) for k in range(3)]
    on = _packed_run(tmp_path, "on", payloads)
    monkeypatch.setenv("SW_NATIVE_FILL", "0")
    off = _packed_run(tmp_path, "off", payloads)
    _assert_same(on, off)
    # fill-direct copies nothing at decode; with it off the C measurement
    # scanner's intermediate bytes are counted
    assert on[1] == 0 and off[1] > 0


def test_native_off_takes_the_python_lanes(tmp_path, monkeypatch):
    from sitewhere_tpu_torch import native
    from sitewhere_tpu_torch.ingest import columnar

    payloads = [_payload(k, names=("temp", "hum")) for k in range(3)]
    on = _packed_run(tmp_path, "native", payloads)
    monkeypatch.setenv("SW_NATIVE", "0")
    assert native.load_swwire() is None and not native.enabled()
    assert not columnar.fill_direct_ready(payloads[0])
    assert columnar._native_decode(payloads[0]) is None
    off = _packed_run(tmp_path, "python", payloads)
    _assert_same(on, off)


def test_missing_native_lib_raises(tmp_path, monkeypatch):
    """A named prebuilt library that is not there raises at load (and so
    at the dispatcher's start), never a quiet pure-Python run."""
    from sitewhere_tpu_torch import native

    monkeypatch.setattr(native, "_swwire", None)
    monkeypatch.setenv("SW_NATIVE_LIB", str(tmp_path / "gone.so"))
    with pytest.raises(native.NativeBuildError, match="SW_NATIVE_LIB"):
        native.load_swwire()
    from torch_parity import wire_world

    world = wire_world("torch", tmp_path / "j", 0)
    with pytest.raises(native.NativeBuildError, match="SW_NATIVE_LIB"):
        world.disp.start()
    assert world.disp._thread is None
    world.disp.stop()


def test_native_lib_loads_a_prebuilt_library(tmp_path, monkeypatch):
    from sitewhere_tpu_torch import native

    built = native.build_path()
    native.load_swwire()
    lib = tmp_path / "prebuilt.so"
    shutil.copy(built, lib)
    monkeypatch.setattr(native, "_swwire", None)
    monkeypatch.setattr(native, "library_path", None)
    monkeypatch.setenv("SW_NATIVE_LIB", str(lib))
    mod = native.load_swwire()
    assert native.library_path == lib
    assert mod.decode_measurement_lines(_payload(0)) is not None


def _asan_available() -> bool:
    cc = os.environ.get("CC", "cc")
    if shutil.which(cc) is None:
        return False
    try:
        out = subprocess.run([cc, "-print-file-name=libasan.so"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return False
    path = out.stdout.strip()
    return bool(path) and os.path.exists(path)


@pytest.mark.slow
def test_native_lanes_clean_under_asan_ubsan():
    if not _asan_available():
        pytest.skip("no C compiler / ASan runtime in this environment")
    proc = subprocess.run(
        ["bash", os.path.join(REPO, "tools", "torch_native_sanitize.sh")],
        capture_output=True, text=True, timeout=540, cwd=REPO)
    assert proc.returncode == 0, (
        f"sanitized native run failed (rc={proc.returncode}):\n"
        f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    assert "OK (ASan/UBSan clean)" in proc.stdout


@pytest.mark.slow
def test_sanitize_build_produces_instrumented_lib():
    if not _asan_available():
        pytest.skip("no C compiler / ASan runtime in this environment")
    proc = subprocess.run(
        ["bash", os.path.join(REPO, "tools", "torch_native_sanitize.sh"),
         "--build"], capture_output=True, text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    path = proc.stdout.strip().splitlines()[-1]
    assert os.path.exists(path)
    syms = subprocess.run(["nm", "-D", "-u", path], capture_output=True,
                          text=True, timeout=60)
    assert "__asan" in syms.stdout, "no ASan symbols in sanitized build"
