"""The ingest sources and the decode pool in the port, against the reference.

- The reference's own ``tests/test_sources.py``, ``test_decoders.py`` and
  ``test_source_factory.py`` cases, its ``DecodePool`` cases and the
  pooled fill-direct case of ``test_host_pipeline.py``,
  ``test_checkpoint.py::test_dedup_window_survives_restart`` and the
  batch-payload source case of ``test_instance.py``, run against the port
  with their imports rewritten (``tests/torch_parity.py
  port_test_module``), the multi-host raw lane's owner split included.
  Left out: the script decoder (the port has no script manager).
- ``stable_hash64`` gives the same value in both packages.
- The ``Instance``: ``decode_backlog`` is the pool's depth over its bound;
  a stream request a source decodes routes to the device streams (a
  refused one dead-letters as ``failed-stream-request``, another
  host-plane kind as ``unsupported-host-request``); a pooled delivery
  steps its plan on the
  thread's current stream, never on a stream of its own (CUDA streams
  mocked); the ``runtime`` section reads across packages both ways, the
  port's side with ``jax`` and ``sitewhere_tpu`` unimportable.
"""

from __future__ import annotations

import json
import os
import pickle
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from torch_parity import port_cases, port_test_module, run_port_case

torch.set_num_threads(1)
TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)


def _ref(name):
    return os.path.join(TESTS, name)


# module -> (cases left out, source edits)
MODULES = {
    "test_sources.py": ((), ()),
    "test_decoders.py": ((), ()),
    # a script decoder needs the script manager, which is not wired to
    # the factory here
    "test_source_factory.py": (
        ("test_factory_rejects_non_decoder_script",), ()),
    # the decode pool, the pooled fill-direct lane and the host-path
    # bench (the port's, on the CPU); the rest of the module is the
    # dispatcher's, held by tests/test_torch_dispatcher.py
    "test_host_pipeline.py": (
        ("TestEgressOffload", "TestDeviceResidentRing", "TestStartHostCopy",
         "TestRingEndToEnd", "TestStageOverlap",
         "test_fill_path_runs_wire_to_egress_with_zero_copies"),
        (('"tools", "hostpath_bench.py")',
          '"tools", "torch_hostpath_bench.py")'),
         ("r = mod.run(width=128, iters=2, capacity=1024, ring_k=2,",
          "r = mod.run(device='cpu', width=128, iters=2, capacity=1024, "
          "ring_k=2,"))),
}
ONLY = {
    "test_checkpoint.py": {"test_dedup_window_survives_restart"},
    "test_instance.py": {
        "TestBatchIngest.test_source_batch_payload_journals_once_and_"
        "processes_all"},
}
REPLACE = {
    "test_instance.py": (
        ("from sitewhere_tpu.instance import Instance, InstanceTemplate",
         "from sitewhere_tpu.instance import Instance"),),
}
_NS = {}


def _ns(module):
    if module not in _NS:
        replace = MODULES.get(module, ((), ()))[1] or REPLACE.get(module, ())
        _NS[module] = port_test_module(_ref(module), replace=replace)
    return _NS[module]


def _cases():
    out = []
    for module, (skip, _) in MODULES.items():
        out += [(module, c) for c in port_cases(_ns(module), skip=skip)]
    for module, names in ONLY.items():
        out += [(module, c) for c in sorted(names)]
    return out


CASES = _cases()


def test_the_port_runs_the_reference_source_cases():
    by_module = {}
    for module, _ in CASES:
        by_module[module] = by_module.get(module, 0) + 1
    assert by_module["test_sources.py"] >= 8
    assert by_module["test_decoders.py"] >= 20
    assert by_module["test_source_factory.py"] >= 8
    assert ("test_host_pipeline.py", "TestFillDirectEndToEnd.test_fill_"
            "path_through_decode_pool_source") in CASES
    assert sum(1 for m, c in CASES if c.startswith("TestDecodePool.")) >= 6
    assert ("test_host_pipeline.py", "TestHostpathBenchSmoke.test_tool_"
            "reports_every_stage") in CASES


@pytest.mark.parametrize("module,case", CASES,
                         ids=[f"{m[5:-3]}::{c}" for m, c in CASES])
def test_reference_source_case_on_the_port(module, case, tmp_path,
                                           monkeypatch):
    if case.startswith("TestBatchIngest."):
        from torch_parity import CpuInstance, make_config

        inst = CpuInstance(make_config(tmp_path))
        inst.start()
        try:
            run_port_case(_ns(module), case, tmp_path,
                          fixtures={"instance": inst})
        finally:
            inst.stop()
            inst.terminate()
        return
    run_port_case(_ns(module), case, tmp_path,
                  fixtures={"monkeypatch": monkeypatch})


# ---------------------------------------------------------------------------
# the dedup key
# ---------------------------------------------------------------------------

def _tokens(n=4000, seed=20261017):
    """``n`` tokens of 1-24 code points from ASCII, Latin-1, Greek, CJK,
    the astral plane (emoji) and the NUL the dedup key joins with."""
    rng = np.random.default_rng(seed)
    ranges = [(0x20, 0x7F), (0xA0, 0x100), (0x391, 0x3CA),
              (0x4E00, 0x9FA6), (0x1F300, 0x1F650), (0x0, 0x1)]
    out = []
    for _ in range(n):
        k = int(rng.integers(1, 25))
        lo, hi = ranges[int(rng.integers(0, len(ranges)))]
        mix = rng.integers(lo, hi, k)
        ascii_ = rng.integers(0x30, 0x7B, k)
        pick = rng.random(k) < 0.5
        out.append("".join(map(chr, np.where(pick, mix, ascii_))))
    return out


def test_stable_hash64_equals_the_reference():
    from sitewhere_tpu.ids import stable_hash64 as ref_hash
    from sitewhere_tpu_torch.ids import stable_hash64

    tokens = _tokens()
    assert sum(any(ord(c) > 0x7F for c in t) for t in tokens) > 1000
    got = [stable_hash64(t) for t in tokens]
    assert got == [ref_hash(t) for t in tokens]
    assert all(-(1 << 63) <= h < (1 << 63) for h in got)
    assert len(set(got)) == len(set(tokens))


def test_dedup_windows_equal_the_reference():
    from sitewhere_tpu.ingest import decoders as ref_dec
    from sitewhere_tpu.ingest.dedup import AlternateIdDeduplicator as RefDedup
    from sitewhere_tpu_torch.ingest import decoders as port_dec
    from sitewhere_tpu_torch.ingest.dedup import AlternateIdDeduplicator

    tokens = _tokens(600, seed=7)
    rng = np.random.default_rng(8)
    picks = rng.integers(0, len(tokens), 3000)
    seen = {}
    for pkg, dec, dedup in (("jax", ref_dec, RefDedup(window=256)),
                            ("torch", port_dec, AlternateIdDeduplicator(
                                window=256))):
        flags = [dedup.is_duplicate(dec.DecodedRequest(
            kind=dec.RequestKind.MEASUREMENT, device_token=f"d-{i % 7}",
            ts_s=1, alternate_id=tokens[i])) for i in picks]
        seen[pkg] = (flags, dedup.export_keys(), dedup.duplicates)
    assert seen["torch"] == seen["jax"]
    assert 0 < seen["torch"][2] < len(picks)


# ---------------------------------------------------------------------------
# the Instance's ingest composition
# ---------------------------------------------------------------------------

def _tree(data_dir, **extra):
    return {
        "instance": {"id": "sources", "data_dir": str(data_dir)},
        "pipeline": {"width": 64, "registry_capacity": 256,
                     "mtype_slots": 4, "deadline_ms": 60_000.0,
                     "adaptive_deadline": False, "ring_depth": 0},
        "checkpoint": {"interval_s": 0},
        "events": {"compact_interval_s": 0},
        **extra,
    }


def _instance(pkg, data_dir, **extra):
    tree = _tree(data_dir, **extra)
    tree["presence"] = {"scan_interval_s": 3600.0, "missing_after_s": 1800}
    if pkg == "jax":
        from sitewhere_tpu.instance import Instance
        from sitewhere_tpu.runtime.config import Config

        return Instance(Config(tree, apply_env=False))
    from sitewhere_tpu_torch.runtime.config import Config
    from torch_parity import CpuInstance

    return CpuInstance(Config(tree, apply_env=False))


def test_decode_backlog_reads_the_pool_as_the_reference(tmp_path):
    """``decode_backlog`` is the pool's pending payloads over its bound,
    in both packages; 0 without a pool."""
    seen = {}
    for pkg in ("jax", "torch"):
        inst = _instance(pkg, tmp_path / pkg,
                         ingest={"decode_workers": 1,
                                 "decode_max_pending": 8})
        try:
            pool = inst.decode_pool
            assert pool.max_pending == 8
            gate = threading.Event()
            pool.submit("k", gate.wait, lambda r, e: None)
            for _ in range(4):
                pool.submit("k", lambda: None, lambda r, e: None)
            held = inst._overload_signals().decode_backlog
            gate.set()
            assert pool.flush(5.0)
            seen[pkg] = (held, inst._overload_signals().decode_backlog,
                         inst.metrics.counter("ingest.decode_pool_jobs").value)
        finally:
            gate.set()
            inst.terminate()
    assert seen["torch"] == seen["jax"] == (5 / 8, 0.0, 5)
    inst = _instance("torch", tmp_path / "sync",
                     ingest={"decode_workers": 0})
    try:
        assert inst.decode_pool is None
        assert inst._overload_signals().decode_backlog == 0.0
    finally:
        inst.terminate()


def _stream_lines():
    return [
        {"deviceToken": "d-1", "type": "DeviceStream",
         "request": {"streamId": "s-1", "contentType": "video/mp4"}},
        {"deviceToken": "d-1", "type": "DeviceStreamData",
         "request": {"streamId": "s-1", "sequenceNumber": 0,
                     "data": "AAEC"}},
        {"deviceToken": "d-1", "type": "DeviceStreamData",
         "request": {"streamId": "s-7", "sequenceNumber": 0,
                     "data": "AAEC"}},
        {"deviceToken": "d-2", "type": "SendStreamData",
         "request": {"streamId": "s-9", "sequenceNumber": 3}},
    ]


def test_host_plane_requests_dead_letter_as_unsupported(tmp_path):
    """Stream requests a source decodes, on the scalar and the raw lane,
    route to the ``DeviceStreamManager`` as in the reference: the stream
    is created under the device's assignment and its chunk stored; a
    chunk for an unknown stream and a request of an unknown device
    dead-letter as ``failed-stream-request`` with the raw request.  Only
    a host-plane kind the manager does not serve dead-letters as
    ``unsupported-host-request``.  Nothing is journaled as an event and
    the receiver path keeps running."""
    from sitewhere_tpu_torch.ingest.decoders import (
        DecodedRequest,
        JsonLinesDecoder,
        RequestKind,
    )
    from sitewhere_tpu_torch.ingest.sources import InboundEventSource

    inst = _instance("torch", tmp_path, ingest={"decode_workers": 2})
    dm = inst.device_management
    dm.create_device_type(token="cam", name="Cam")
    dm.create_device(token="d-1", device_type="cam")
    assignment = dm.create_device_assignment(device="d-1")
    scalar = inst.add_source(InboundEventSource(
        "scalar", [], JsonLinesDecoder()))
    raw = inst.add_source(InboundEventSource(
        "raw", [], JsonLinesDecoder(), raw_wire=True))
    assert scalar.on_host_request == inst._on_host_request
    inst.start()
    try:
        payload = "\n".join(json.dumps(d) for d in _stream_lines()).encode()
        # one source at a time: the pool delivers each source's payloads
        # in order, the two sources' side by side
        for src in (scalar, raw):
            src.on_encoded_payload(payload)
            assert inst.decode_pool.flush(5.0)
        inst.dispatcher.flush()
        inst._on_host_request(DecodedRequest(
            kind=RequestKind.MAPPING, device_token="d-1", ts_s=0))
        letters = [{k: v for k, v in d.items() if k != "offset"}
                   for d in inst.list_dead_letters()]
        assert scalar.failed_count == raw.failed_count == 0
        assert scalar.decoded_count == 4
        stream = inst.streams.get_assignment_stream(assignment.token, "s-1")
        assert stream is not None and stream.content_type == "video/mp4"
        assert inst.streams.stream_content(stream.token) == b"\x00\x01\x02"
        assert inst.streams.get_assignment_stream(
            assignment.token, "s-7") is None
    finally:
        inst.stop()
        inst.terminate()
    failed = [(d["kind"], d["request_kind"], d["device_token"],
               d["stream_id"]) for d in letters[:-1]]
    assert failed == [
        ("failed-stream-request", "STREAM_DATA", "d-1", "s-7"),
        ("failed-stream-request", "STREAM_SEND", "d-2", "s-9")] * 2
    assert all(bytes.fromhex(d["payload"]) for d in letters[:-1])
    assert letters[-1] == {"kind": "unsupported-host-request",
                           "request_kind": "MAPPING", "device_token": "d-1"}
    # the raw lane journals its payload once (as the reference's does);
    # the scalar lane forwards no event, so journals nothing
    assert inst.ingest_journal.end_offset == 1


class _FakeStreams:
    """Thread-local "current stream" stand-in for ``torch.cuda``."""

    def __init__(self):
        self.local = threading.local()

    def current(self, *args, **kw):
        return getattr(self.local, "stream", "default-stream")

    def stream(self, s):
        import contextlib

        @contextlib.contextmanager
        def ctx():
            prev = self.current()
            self.local.stream = s
            try:
                yield
            finally:
                self.local.stream = prev

        return ctx()


def test_pooled_delivery_steps_on_the_threads_own_stream(tmp_path,
                                                         monkeypatch):
    """With the pool, a plan can be dispatched and stepped on a decode
    worker.  The workers own no CUDA stream: with streams mocked, every
    step (the rule engine's and the analytics runner's streams are live
    beside it) launches on the calling thread's current stream, the
    default one."""
    from sitewhere_tpu_torch.analytics import runner as port_runner
    from sitewhere_tpu_torch.ingest.decoders import JsonLinesDecoder
    from sitewhere_tpu_torch.ingest.sources import InboundEventSource
    from sitewhere_tpu_torch.rules import engine as port_engine
    from torch_parity import wire_payload

    fakes = _FakeStreams()
    monkeypatch.setattr(port_engine, "_new_stream", lambda device: "engine")
    monkeypatch.setattr(port_runner, "_new_stream",
                        lambda device: "analytics")
    monkeypatch.setattr(torch.cuda, "stream", fakes.stream)
    monkeypatch.setattr(torch.cuda, "current_stream", fakes.current)
    inst = _instance("torch", tmp_path, ingest={"decode_workers": 2})
    for i in range(100):
        inst.identity.device.mint(f"dev-{i}")
    src = inst.add_source(InboundEventSource(
        "raw", [], JsonLinesDecoder(), raw_wire=True))
    disp = inst.dispatcher
    real_step = disp._packed_step
    seen = []

    def step_spy(*args):
        seen.append((threading.current_thread().name,
                     torch.cuda.current_stream()))
        return real_step(*args)

    inst.start()
    disp._packed_step = step_spy
    try:
        rng = np.random.default_rng(20261019)
        for r in range(6):
            src.on_encoded_payload(wire_payload(
                rng, 64, 1_753_800_000_000 + 1000 * r,
                kinds=("m",) if r % 2 else ("m", "l", "a"),
                p=(1.0,) if r % 2 else (0.6, 0.3, 0.1)))
        assert inst.decode_pool.flush(5.0)
        disp.flush()
    finally:
        inst.stop()
        inst.terminate()
    on_pool = [s for name, s in seen if name.startswith("ingest-decode")]
    assert on_pool, seen
    assert {s for _, s in seen} == {"default-stream"}
    assert inst.metrics.counter("ingest.decode_pool_jobs").value == 6


# ---------------------------------------------------------------------------
# the runtime section across packages
# ---------------------------------------------------------------------------

DEDUP_SOURCES = [{"id": "dd", "decoder": "jsonlines",
                  "dedup": {"window": 4096},
                  "receivers": [{"type": "tcp", "port": 0}]}]


def _alt_payload(start, n=48):
    return "\n".join(json.dumps({
        "deviceToken": f"d-{i % 5}", "type": "DeviceMeasurements",
        "request": {"name": "temp", "value": float(i),
                    "eventDate": 1_753_800_000 + i,
                    "alternateId": f"alt-{i}-é"}})
        for i in range(start, start + n)).encode()


def _run_dedup(pkg, data_dir):
    """An instance with a dedup source takes two payloads (one repeated
    line each), stops (its final generation holds the section) and
    returns the window and the section file."""
    inst = _instance(pkg, data_dir, sources=DEDUP_SOURCES)
    inst.start()
    src = inst.sources[0]
    try:
        for start in (0, 40):
            src.on_encoded_payload(_alt_payload(start))
        if inst.decode_pool is not None:
            assert inst.decode_pool.flush(5.0)
        assert src.duplicate_count == 8
        keys = src.deduplicator.export_keys()
    finally:
        inst.stop()
        inst.terminate()
    d = inst.checkpointer.dir
    name = sorted(f for f in os.listdir(d) if f.startswith("runtime-"))[-1]
    return keys, os.path.join(d, name)


@pytest.fixture(scope="module")
def runtime_both(tmp_path_factory):
    root = tmp_path_factory.mktemp("runtime")
    return {pkg: _run_dedup(pkg, root / pkg) for pkg in ("jax", "torch")}


def test_runtime_sections_equal_the_reference(runtime_both):
    from sitewhere_tpu.runtime import checkpoint as ref_ckpt

    (ka, pa), (kb, pb) = runtime_both["jax"], runtime_both["torch"]
    assert ka == kb and len(kb) == 88
    ha, a = ref_ckpt.read_framed(pa, component="runtime")
    hb, b = ref_ckpt.read_framed(pb, component="runtime")
    assert ha["version"] == hb["version"] == 1
    assert pickle.loads(a) == pickle.loads(b) == {
        "dedup": {"event-source:dd": kb}, "spools": {}}


def _seed_generation(pkg, data_dir, section):
    """A fresh instance's saved generation, its ``runtime`` file replaced
    by ``section`` (the other package's)."""
    import shutil

    inst = _instance(pkg, data_dir, sources=DEDUP_SOURCES)
    inst.checkpointer.save()
    d = inst.checkpointer.dir
    target = os.path.join(d, sorted(
        f for f in os.listdir(d) if f.startswith("runtime-"))[-1])
    inst.terminate()
    shutil.copyfile(section, target)


def test_port_runtime_section_restores_into_the_reference(runtime_both,
                                                          tmp_path):
    keys, section = runtime_both["torch"]
    _seed_generation("jax", tmp_path, section)
    ref = _instance("jax", tmp_path, sources=DEDUP_SOURCES)
    ref.start()
    try:
        src = ref.sources[0]
        assert src.deduplicator.export_keys() == keys
        src.on_encoded_payload(_alt_payload(0))
        assert ref.decode_pool.flush(5.0)
        assert src.duplicate_count == 48
    finally:
        ref.stop()
        ref.terminate()


_RUNTIME_PROBE = """
import json, sys
sys.modules["jax"] = None
sys.modules["sitewhere_tpu"] = None
from sitewhere_tpu_torch.instance import Instance
from sitewhere_tpu_torch.runtime.config import Config
inst = Instance(Config(json.loads(sys.argv[1]), apply_env=False),
                device="cpu")
assert inst.restored
inst.start()
src = inst.sources[0]
keys = src.deduplicator.export_keys()
src.on_encoded_payload(sys.argv[2].encode())
assert inst.decode_pool.flush(5.0)
dups = src.duplicate_count
inst.stop()
inst.terminate()
bad = sorted(m for m, v in sys.modules.items() if v is not None
             and (m.startswith("jax") or m == "sitewhere_tpu"
                  or m.startswith("sitewhere_tpu.")))
print(json.dumps([keys, dups, bad]))
"""


def test_reference_runtime_section_restores_into_the_port_without_jax(
        runtime_both, tmp_path):
    keys, section = runtime_both["jax"]
    _seed_generation("torch", tmp_path, section)
    tree = _tree(tmp_path, sources=DEDUP_SOURCES)
    proc = subprocess.run(
        [sys.executable, "-c", _RUNTIME_PROBE, json.dumps(tree),
         _alt_payload(0).decode()],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    got, dups, bad = json.loads(proc.stdout.strip().splitlines()[-1])
    assert bad == []
    assert got == keys
    assert dups == 48
