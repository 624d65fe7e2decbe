"""Config-declared sources on the port's wire path, against the JAX
package's, on the CPU.

One reference ``Instance`` and one port ``Instance`` (the world of
``tests/test_torch_rules_wire.py``: width 64, 128 slots, 100 devices, a
threshold rule) each declare two TCP sources with length framing in
their ``sources`` section: ``raw`` (``raw_wire``, the columnar lane and,
with the decode pool, its split halves) and ``lines`` (the ``jsonlines``
decoder into ``ingest_many``).  The same seeded NDJSON goes over loopback
sockets into both, with ``ingest.decode_workers`` 2 (the pool) and 0
(synchronous): the mixed payloads and one measurement-only payload (the
fill-direct lane, scanned on a pool worker) to ``raw``, then mixed
payloads to ``lines``.  Stored rows, dispatcher totals, source counters
and device state are equal between the packages (ints exact, EWMA
within ``tests/torch_parity.py``'s 4-ULP bound), and between the pooled
and the synchronous runs of each package.
"""

from __future__ import annotations

import socket
import struct
import time

import numpy as np
import pytest
import torch

from test_torch_rules_wire import make_instance, seed_world, stored_rows
from torch_parity import WIRE_TS0_MS, assert_state_equal, wire_payload

torch.set_num_threads(1)

SEED = 20261018
WIDTH = 64
SOURCES = [
    {"id": "raw", "decoder": "json", "raw_wire": True,
     "receivers": [{"type": "tcp", "port": 0}]},
    {"id": "lines", "decoder": "jsonlines",
     "receivers": [{"type": "tcp", "port": 0, "framing": "length"}]},
]


def traffic():
    rng = np.random.default_rng(SEED)
    raw = [wire_payload(rng, WIDTH, WIRE_TS0_MS + 1000 * r)
           for r in range(3)]
    raw.append(wire_payload(rng, WIDTH, WIRE_TS0_MS + 4000, kinds=("m",),
                            p=(1.0,), ghosts=0.0))
    lines = [wire_payload(rng, WIDTH, WIRE_TS0_MS + 1000 * (5 + r))
             for r in range(3)]
    return {"raw": raw, "lines": lines}


def _wait(cond, timeout=20.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.005)
    return cond()


def send(src, payloads):
    port = src.receivers[0].port
    with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
        for p in payloads:
            s.sendall(struct.pack(">I", len(p)) + p)


def run(pkg, root, workers):
    inst, status, ops = make_instance(
        pkg, root / f"{pkg}-{workers}", sources=SOURCES,
        ingest={"decode_workers": workers})
    seed_world(inst, status, ops, programs=False)
    inst.start()
    try:
        by_id = {src.source_id: src for src in inst.sources}
        assert sorted(by_id) == ["lines", "raw"]
        if workers:
            assert inst.decode_pool is not None
        else:
            assert inst.decode_pool is None
        jobs = inst.metrics.counter("ingest.decode_pool_jobs")
        journal = inst.ingest_journal
        for sid, payloads in traffic().items():
            before = journal.end_offset
            send(by_id[sid], payloads)
            assert _wait(lambda: journal.end_offset == before + len(payloads)
                         and (inst.decode_pool is None
                              or inst.decode_pool.pending == 0))
            inst.dispatcher.flush()
        out = {
            "rows": stored_rows(inst.event_store),
            "totals": dict(inst.dispatcher.totals),
            "sources": {sid: (s.decoded_count, s.failed_count,
                              s.duplicate_count, s.shed_count)
                        for sid, s in by_id.items()},
            "jobs": jobs.value,
            "state": inst.device_state.current,
            "journal": journal.end_offset,
        }
    finally:
        inst.stop()
        inst.terminate()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("sources-wire")
    return {(pkg, w): run(pkg, root, w)
            for pkg in ("jax", "torch") for w in (2, 0)}


@pytest.mark.parametrize("workers", [2, 0])
def test_stored_rows_equal_the_reference(runs, workers):
    ref, got = runs[("jax", workers)], runs[("torch", workers)]
    assert len(got["rows"]) > 6 * WIDTH * 0.9
    np.testing.assert_array_equal(got["rows"], ref["rows"])
    assert got["totals"] == ref["totals"]
    assert got["journal"] == ref["journal"] == 7


@pytest.mark.parametrize("workers", [2, 0])
def test_source_counters_equal_the_reference(runs, workers):
    ref, got = runs[("jax", workers)], runs[("torch", workers)]
    assert got["sources"] == ref["sources"]
    assert got["sources"]["lines"][0] == 3 * WIDTH


@pytest.mark.parametrize("workers", [2, 0])
def test_device_state_equals_the_reference(runs, workers):
    assert_state_equal(runs[("jax", workers)]["state"],
                       runs[("torch", workers)]["state"])


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_pool_and_synchronous_runs_agree(runs, pkg):
    pooled, sync = runs[(pkg, 2)], runs[(pkg, 0)]
    np.testing.assert_array_equal(pooled["rows"], sync["rows"])
    assert pooled["totals"] == sync["totals"]
    assert pooled["sources"] == sync["sources"]
    assert_state_equal(sync["state"], pooled["state"])
    # every payload of both sources went through the pool's workers
    assert pooled["jobs"] == 7 and sync["jobs"] == 0
