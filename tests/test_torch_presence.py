"""Presence detection and the state scans in the port, against the
reference.

- The reference's own ``tests/test_device_state.py`` runs on the port
  (``tests/torch_parity.py port_test_module``): its JAX builders become
  port tensors on the CPU through ``convert``, its one ``jnp`` case
  (``test_presence_sweep_is_jittable_and_pure``) is rewritten in torch,
  and the lease cases call the port's packed step (torch has no buffer
  donation: the chain never writes the leased buffers).
- ``tests/test_instance.py``'s presence re-injection case runs on the
  port ``Instance``.
- One seeded ``DeviceState`` carried across by
  ``convert.device_state_from``: the sweep's STATE_CHANGE batches and
  flags, and the four scans, equal in both packages.
- The CUDA streams of the presence path, mocked: the sweep runs on the
  stream the epoch was committed from, the re-injected plans step on the
  presence thread's own current stream, and the analytics runner fans
  its matches out after leaving its stream.
"""

from __future__ import annotations

import functools
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from sitewhere_tpu.ids import IdentityMap as JaxIdentityMap
from sitewhere_tpu.state.manager import DeviceStateManager as JaxManager
from sitewhere_tpu_torch import convert
from sitewhere_tpu_torch.ids import IdentityMap
from sitewhere_tpu_torch.schema import DeviceState, RuleTable, ZoneTable
from sitewhere_tpu_torch.state.manager import DeviceStateManager
from torch_parity import (
    CAP,
    CPU,
    K,
    M,
    FakeStreams,
    make_state,
    np_of,
    port_test_module,
    reference_cases,
    run_port_case,
)

torch.set_num_threads(1)
TESTS = os.path.dirname(os.path.abspath(__file__))
REF = os.path.join(TESTS, "test_device_state.py")

#: source edits for the reference module's JAX-only lines
_STATE_EDITS = (
    ("from sitewhere_tpu.pipeline import pipeline_step\n",
     "from sitewhere_tpu.pipeline.step import pipeline_step\n"
     "import torch\n"),
    ("from sitewhere_tpu.state import DeviceStateManager, PresenceManager, "
     "presence_sweep\n",
     "from sitewhere_tpu.state.manager import DeviceStateManager\n"
     "from sitewhere_tpu.state.presence import PresenceManager, "
     "presence_sweep\n"),
    ("""    import jax.numpy as jnp

    state = DeviceState.empty(16)
    state = state.replace(
        last_event_type=state.last_event_type.at[2].set(EventType.MEASUREMENT),
        last_event_ts_s=state.last_event_ts_s.at[2].set(100),
    )
    new_state, newly = presence_sweep(state, jnp.int32(10_000), jnp.int32(500))
""", """    state = DeviceState.empty(16)
    ev, ts = state.last_event_type.clone(), state.last_event_ts_s.clone()
    ev[2], ts[2] = int(EventType.MEASUREMENT), 100
    state = state.replace(last_event_type=ev, last_event_ts_s=ts)
    new_state, newly = presence_sweep(state, 10_000, 500)
"""),
    ("""        registry = registry.replace(
            active=registry.active.at[5].set(False)
        )""", """        active = registry.active.clone()
        active[5] = False
        registry = registry.replace(active=active)"""),
    ("        import jax\n\n        from sitewhere_tpu.pipeline.packed",
     "        from sitewhere_tpu.pipeline.packed"),
    ("        from sitewhere_tpu.schema import as_numpy\n", ""),
    ("        host = as_numpy(make_batch(rows))\n",
     "        host = make_batch(rows)\n"),
    ("        return jax.jit(packed_pipeline_step)(tables, manager_ps, bi, bf)",
     "        return packed_pipeline_step(tables, manager_ps,\n"
     "                                    torch.from_numpy(bi),\n"
     "                                    torch.from_numpy(bf))"),
    ("""        ps.si.delete()
        ps.sf.delete()
""", "        del ps  # torch has no donation; the leased buffers stay unwritten\n"),
    ("""    import jax.numpy as jnp

    run_step(manager, [measurement(0, ts=1000)])""",
     "    run_step(manager, [measurement(0, ts=1000)])"),
)


class _OnCpu:
    """A port schema class whose ``empty`` builds on the CPU."""

    def __init__(self, cls):
        self._cls = cls

    def empty(self, *args, **kw):
        return self._cls.empty(*args, device=CPU, **kw)

    def __getattr__(self, name):
        return getattr(self._cls, name)


def _port_state_module():
    import helpers

    ns = port_test_module(REF, replace=_STATE_EDITS)
    ns.update(
        DeviceStateManager=functools.partial(DeviceStateManager, device=CPU),
        DeviceState=_OnCpu(DeviceState), RuleTable=_OnCpu(RuleTable),
        ZoneTable=_OnCpu(ZoneTable),
        make_registry=lambda **kw: convert.registry_from(
            helpers.make_registry(**kw), device=CPU),
        make_batch=lambda rows: convert.event_batch_from(
            helpers.make_batch(rows), device=CPU))
    return ns


STATE_CASES = reference_cases(REF)


@pytest.fixture(scope="module")
def state_ns():
    return _port_state_module()


def test_the_port_runs_every_reference_device_state_case():
    assert len(STATE_CASES) == 17


@pytest.mark.parametrize("case", STATE_CASES)
def test_reference_device_state_case_on_the_port(state_ns, case, tmp_path):
    run_port_case(state_ns, case, tmp_path)


def test_reference_presence_reinjection_on_the_port_instance(tmp_path):
    ns = port_test_module(
        os.path.join(TESTS, "test_instance.py"),
        replace=(("from sitewhere_tpu.instance import Instance, "
                  "InstanceTemplate\n",
                  "from sitewhere_tpu.instance import Instance\n"),))
    run_port_case(ns, "TestDispatchLoop.test_presence_changes_reinjected",
                  tmp_path)


# ---------------------------------------------------------------------------
# one DeviceState through both managers
# ---------------------------------------------------------------------------

def _managers(seed):
    state = make_state(seed)
    tenants = (np.arange(CAP) % 5).astype(np.int32)
    jids, tids = JaxIdentityMap(capacity=CAP), IdentityMap(capacity=CAP)
    for i in range(0, CAP, 3):      # every third slot has a token
        assert jids.device.mint(f"d-{i}") == tids.device.mint(f"d-{i}")
    jm = JaxManager(CAP, jids, num_mtype_slots=M, num_ewma_scales=K,
                    tenant_id_of_device=lambda ids: tenants[ids])
    jm.commit(state)
    tm = DeviceStateManager(CAP, tids, num_mtype_slots=M, num_ewma_scales=K,
                            tenant_id_of_device=lambda ids: tenants[ids],
                            device=CPU)
    tm.commit(convert.device_state_from(state, device=CPU))
    return jm, tm


BATCH_FIELDS = ("valid", "device_id", "tenant_id", "event_type", "ts_s",
                "ts_ns", "alert_code", "update_state")


@pytest.mark.parametrize("seed", [1, 7])
def test_sweeps_and_scans_equal_across_packages(seed):
    jm, tm = _managers(seed)
    scans = lambda m: (m.missing_device_ids(), m.missing_device_tokens(),  # noqa: E731
                       [m.seen_since(t) for t in (0, 300, 900, 2000)],
                       [m.seen_since_tokens(t) for t in (0, 500)],
                       m.summary())
    assert scans(tm) == scans(jm)
    marked = 0
    for now_s, after_s in ((500, 400), (1_010, 200), (1_010, 200),
                           (1_500, 100), (10**6, 1)):
        jb = jm.apply_presence_sweep(now_s, after_s)
        tb = tm.apply_presence_sweep(now_s, after_s)
        assert (jb is None) == (tb is None)
        if jb is not None:
            marked += int(np.asarray(jb.valid).sum())
            for f in BATCH_FIELDS:
                np.testing.assert_array_equal(np_of(getattr(jb, f)),
                                              np_of(getattr(tb, f)), f)
        np.testing.assert_array_equal(np_of(jm.current.presence_missing),
                                      np_of(tm.current.presence_missing))
        assert scans(tm) == scans(jm)
    assert marked > 0


# ---------------------------------------------------------------------------
# CUDA streams on the presence path, mocked
# ---------------------------------------------------------------------------


def test_presence_path_streams(tmp_path, monkeypatch):
    """With CUDA streams mocked, on the port ``Instance``: the presence
    thread's sweep launches on the stream the epoch was committed from,
    the STATE_CHANGE plans it re-injects step on that thread's own
    current stream (it owns none), and the analytics runner fans its
    matches out to outbound only after it has left its own stream."""
    from sitewhere_tpu_torch.analytics import runner as port_runner
    from sitewhere_tpu_torch.rules import engine as port_engine
    from sitewhere_tpu_torch.state import manager as port_manager
    from sitewhere_tpu_torch.runtime.config import Config
    from torch_parity import CpuInstance

    N_DEV = 70
    fakes = FakeStreams()
    monkeypatch.setattr(port_engine, "_new_stream", lambda device: "engine")
    monkeypatch.setattr(port_runner, "_new_stream",
                        lambda device: "analytics")
    monkeypatch.setattr(torch.cuda, "stream", fakes.stream)
    monkeypatch.setattr(torch.cuda, "current_stream", fakes.current)
    clock = [1_000_000.0]
    inst = CpuInstance(Config({
        "instance": {"id": "presence-streams", "data_dir": str(tmp_path)},
        "pipeline": {"width": 64, "registry_capacity": 128,
                     "mtype_slots": 4, "deadline_ms": 5.0, "ring_depth": 0},
        "presence": {"scan_interval_s": 0.02, "missing_after_s": 100},
        "checkpoint": {"interval_s": 0},
    }, apply_env=False))
    inst.presence._clock = lambda: clock[0]
    # the stream a card's manager records at construction and commit
    inst.device_state._stream = "epoch-stream"
    seen = {"sweep": [], "step": [], "fanout": []}
    real_sweep = port_manager.presence_sweep
    monkeypatch.setattr(
        port_manager, "presence_sweep",
        lambda *a: (seen["sweep"].append(
            (threading.current_thread().name, torch.cuda.current_stream())),
            real_sweep(*a))[1])
    disp = inst.dispatcher
    real_step = disp._packed_step

    def step_spy(*args):
        seen["step"].append((threading.current_thread().name,
                             torch.cuda.current_stream()))
        return real_step(*args)

    real_submit = inst.outbound.submit

    def submit_spy(cols, mask, **kw):
        if threading.current_thread().name.startswith("analytics"):
            seen["fanout"].append(torch.cuda.current_stream())
        return real_submit(cols, mask, **kw)

    inst.outbound.submit = submit_spy
    inst.analytics.outbound = inst.outbound
    inst.start()
    disp._packed_step = step_spy
    try:
        dm = inst.device_management
        dm.create_device_type(token="sensor", name="Sensor")
        # more missing devices than a plan's width: the presence thread
        # fills and steps a plan itself
        for i in range(N_DEV):
            dm.create_device(token=f"dev-{i}", device_type="sensor")
            dm.create_device_assignment(device=f"dev-{i}")
        inst.analytics.register({
            "kind": "window", "name": "hot", "mtype": "temp", "agg": "mean",
            "op": "gt", "threshold": 25.0, "windowS": 300})
        t0 = int(clock[0]) - 1_000
        lines = [json.dumps({"deviceToken": f"dev-{i}", "type": "Measurement",
                             "request": {"name": "temp", "value": v,
                                         "eventDate": t0 + dt}})
                 for i in range(N_DEV)
                 for dt, v in ((0, 50.0), (300, 1.0))]
        # while the rows arrive the clock stands at the devices' last
        # event, so the sweeps then flag nothing; once every row is
        # committed the clock moves on, and the one sweep that reads it
        # flags all N_DEV devices together, on the presence thread
        now, clock[0] = clock[0], float(t0 + 300)
        disp.ingest_wire_lines("\n".join(lines).encode())
        disp.flush()
        clock[0] = now
        deadline = time.monotonic() + 5
        while inst.presence.total_marked_missing < N_DEV \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        inst.presence.stop()
        disp.flush()
        inst.analytics.drain()
    finally:
        inst.stop()
        inst.terminate()
    assert inst.presence.total_marked_missing == N_DEV
    assert seen["sweep"] and all(
        s == ("presence-checker", "epoch-stream") for s in seen["sweep"])
    presence_steps = [s for s in seen["step"] if s[0] == "presence-checker"]
    assert presence_steps and all(s[1] == "default-stream"
                                  for s in presence_steps)
    assert seen["fanout"] and all(s == "default-stream"
                                  for s in seen["fanout"])
