"""Ownership migration in the port against the reference.

- The reference's own ``tests/test_migration.py``, every case, run on the
  port with its imports rewritten (``torch_parity.port_test_module``),
  each ``Instance`` on the CPU.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from torch_parity import port_test_module, reference_cases, run_port_case

torch.set_num_threads(1)
TESTS = os.path.dirname(os.path.abspath(__file__))
REF = os.path.join(TESTS, "test_migration.py")
CASES = reference_cases(REF)


@pytest.fixture(scope="module")
def port_ns():
    return port_test_module(REF)


@pytest.mark.parametrize("case", CASES)
def test_reference_migration_case_on_the_port(port_ns, case, tmp_path):
    run_port_case(port_ns, case, tmp_path)


# ---------------------------------------------------------------------------
# export_row / import_row against the JAX manager
# ---------------------------------------------------------------------------

def _managers(mesh):
    from sitewhere_tpu.ids import IdentityMap as JaxIds
    from sitewhere_tpu.state.manager import DeviceStateManager as JaxMgr
    from sitewhere_tpu_torch import convert
    from sitewhere_tpu_torch.ids import IdentityMap
    from sitewhere_tpu_torch.state.manager import DeviceStateManager
    from torch_parity import CAP, K, M, make_state

    state = make_state(3)
    ref = JaxMgr(CAP, JaxIds(), num_mtype_slots=M, num_ewma_scales=K)
    ref.commit(state)
    port = DeviceStateManager(CAP, IdentityMap(), num_mtype_slots=M,
                              num_ewma_scales=K, device="cpu", mesh=mesh)
    port.commit(convert.device_state_from(state, "cpu"))
    return ref, port


@pytest.mark.parametrize("n_shards", [1, 8])
def test_export_and_import_rows_equal_the_jax_manager(n_shards):
    from sitewhere_tpu_torch.parallel.mesh import Sharded, make_mesh
    from torch_parity import CAP, assert_state_equal

    mesh = make_mesh(devices=["cpu"] * n_shards) if n_shards > 1 else None
    ref, port = _managers(mesh)
    rows = [0, 1, 37, CAP // 2, CAP - 1]
    for d in rows:
        assert port.export_row(d) == ref.export_row(d)
    # newest wins: a newer row applies, an older or equal one does not
    for k, d in enumerate(rows):
        row = ref.export_row(rows[-1 - k])
        row["last_event_ts_s"] = (
            ref.export_row(d)["last_event_ts_s"] + (1 if k % 2 else 0))
        assert port.import_row(d, dict(row)) == ref.import_row(d, dict(row))
    # a row of another shape keeps only its scalar columns
    odd = dict(ref.export_row(2), _mtype_slots=1, last_event_ts_s=10 ** 6)
    assert port.import_row(5, dict(odd)) == ref.import_row(5, dict(odd))
    if mesh is not None:
        packed = port.current_packed
        assert isinstance(packed.si, Sharded) and packed.si.n_shards == 8
    assert_state_equal(ref.current, port.current)
    for d in rows + [5]:
        assert port.export_row(d) == ref.export_row(d)
    with pytest.raises(Exception):
        port.export_row(CAP)


def test_import_during_a_ring_survives_the_ring_commit(tmp_path):
    """An import that comes while a ring's chain holds the leased carry
    waits on the step barrier and lands after the ring's commit; without
    the barrier the commit drops it (the control)."""
    import threading

    from torch_parity import WIRE_TS0_MS, wire_payload, wire_world

    def run(root, barrier):
        world = wire_world("torch", root, ring_depth=2)
        d = world.disp
        rng = np.random.default_rng(5)
        payloads = [wire_payload(rng, 64, WIRE_TS0_MS + 1000 * k,
                                 kinds=("m",), p=(1.0,), ghosts=0.0)
                    for k in range(2)]
        state = world.state
        # a device no row of the ring touches
        target = world.identity.device.mint("migrated-0")
        row = state.export_row(target)
        row["last_event_ts_s"] = 2_000_000_000
        row["last_values"] = [1.5, 2.5, 3.5, 4.5]
        imported = threading.Event()
        in_chain = threading.Event()
        chains = []

        def importer():
            in_chain.wait(10)
            if barrier:
                with d.step_barrier():
                    state.import_row(target, dict(row))
            else:
                state.import_row(target, dict(row))
            imported.set()

        real_chain = d._ring_chain

        def slow_chain(k):
            chain = real_chain(k)

            def run_chain(*args):
                in_chain.set()
                # the importer is waiting on the barrier (or, without
                # it, has already replaced the epoch) before the chain
                # commits
                imported.wait(0.5)
                chains.append(imported.is_set())
                return chain(*args)

            return run_chain

        d._ring_chain = slow_chain
        t = threading.Thread(target=importer)
        t.start()
        for p in payloads:
            d.ingest_wire_lines(p)
        d.flush()
        t.join(10)
        assert chains and imported.is_set()
        got = state.export_row(target)
        return chains[0], got["last_event_ts_s"], got["last_values"]

    applied_first, ts, values = run(tmp_path / "barrier", barrier=True)
    assert applied_first is False          # it waited for the commit
    assert ts == 2_000_000_000 and values == [1.5, 2.5, 3.5, 4.5]
    applied_first, ts, _ = run(tmp_path / "control", barrier=False)
    assert applied_first is True
    assert ts != 2_000_000_000             # the ring's commit dropped it
