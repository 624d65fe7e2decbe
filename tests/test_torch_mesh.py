"""The port's mesh, sharded batcher, sharded Instance and mesh ring.

The reference's own ``tests/test_mesh.py``, ``test_batcher.py``,
``test_sharded_instance.py``, ``test_mesh_ring.py``, the sharded cases of
``test_analytics.py`` and ``test_native_fill.py``'s sharded reserve case
run on the port through ``tests/torch_parity.py port_test_module``, with
every shard on ``cpu``.  Where a case reads a JAX sharding object, the
source edit below names its port counterpart:

- ``x.sharding.shard_shape(s)`` -> ``x.placement.shard_shape(s)``;
- ``len(x.sharding.device_set) == n`` (the state lives on n devices) ->
  the packed epoch's shard count, ``current_packed.si.n_shards == n``
  (the port's shards may share one device);
- ``x.addressable_shards`` -> the blocks of the port's ``Sharded``;
- ``jax.tree_util.tree_leaves(state)`` -> the dataclass fields.

Plus the port's counterparts of ``test_rules.py``'s mesh dry run and
``test_analytics.py``'s window-sharded cases, and the demoted-shard side
route at FALLBACK.
"""

from __future__ import annotations

import os
import types

import numpy as np
import pytest
import torch

from sitewhere_tpu_torch.parallel import MeshSpec, make_mesh, shard_for_device
from sitewhere_tpu_torch.parallel.mesh import (
    MODEL_AXIS,
    SHARD_AXIS,
    Sharded,
    event_sharding,
    registry_sharding,
    replicated,
)
from torch_parity import port_cases, port_test_module, run_port_case

torch.set_num_threads(1)
TESTS = os.path.dirname(os.path.abspath(__file__))
CPU8 = ["cpu"] * 8


@pytest.fixture(scope="module")
def tmesh8():
    return make_mesh(devices=CPU8)


def _pieces(x: Sharded):
    """``jax.Array.addressable_shards`` of the port: each block with its
    index along the sharded axis."""
    out, start = [], 0
    for block in x.shards:
        stop = start + block.shape[x.dim]
        out.append(types.SimpleNamespace(data=block,
                                         index=(slice(start, stop),)))
        start = stop
    return out


_STATE_ON_MESH = (
    "assert len(st.last_event_ts_s.sharding.device_set) == N_SHARDS",
    "assert inst.device_state.current_packed.si.n_shards == N_SHARDS")

# module -> (source edits, cases left out with the reason)
MODULES = {
    "test_mesh.py": ((
        ('assert all(d.platform == "cpu" for d in devices)',
         'assert all(d.type == "cpu" for d in devices)'),
        ("make_mesh(8, model_parallel=2)",
         "make_mesh(8, model_parallel=2, devices=['cpu'] * 8)"),
        ("make_mesh(8, model_parallel=3)",
         "make_mesh(8, model_parallel=3, devices=['cpu'] * 8)"),
        ("import jax.numpy as jnp", "import torch as jnp"),
        ("xs = jax.device_put(x, event_sharding(mesh8))",
         "xs = event_sharding(mesh8).place(x)"),
        ("xs.sharding.shard_shape", "xs.placement.shard_shape"),
        ("r = jax.device_put(jnp.zeros((64,)), replicated(mesh8))",
         "r = replicated(mesh8).place(jnp.zeros((64,)))"),
        ("r.sharding.shard_shape", "r.placement.shard_shape"),
        ("reg_col = jax.device_put(\n"
         "        jnp.arange(capacity, dtype=jnp.int32), "
         "registry_sharding(mesh8)\n    )",
         "reg_col = registry_sharding(mesh8).place(\n"
         "        jnp.arange(capacity, dtype=jnp.int32))"),
        ("enumerate(reg_col.addressable_shards)",
         "enumerate(_pieces(reg_col))"),
    ), {}),
    "test_batcher.py": ((
        ("plan.batch", "plan.materialize_batch('cpu')"),
        ("p1.batch", "p1.materialize_batch('cpu')"),
        ("p2.batch", "p2.materialize_batch('cpu')"),
        ("rest.batch", "rest.materialize_batch('cpu')"),
        ("from sitewhere_tpu.pipeline import pipeline_step",
         "from sitewhere_tpu.pipeline.step import pipeline_step\n"
         "    from sitewhere_tpu_torch import convert"),
        ("jax.jit(pipeline_step)(\n        reg, DeviceState.empty(CAP), "
         "RuleTable.empty(4), ZoneTable.empty(4),",
         "pipeline_step(\n        convert.registry_from(reg, 'cpu'), "
         "DeviceState.empty(CAP, device='cpu'), "
         "RuleTable.empty(4, device='cpu'), "
         "ZoneTable.empty(4, device='cpu'),"),
    ), {}),
    "test_sharded_instance.py": ((_STATE_ON_MESH,), {}),
    "test_mesh_ring.py": ((
        _STATE_ON_MESH,
        ("np.asarray(leaf) for leaf in\n"
         "                jax.tree_util.tree_leaves("
         "inst.device_state.current)",
         "np.asarray(getattr(inst.device_state.current, f)) for f in\n"
         "                inst.device_state.current.__dataclass_fields__"),
    ), {}),
    "test_analytics.py": ((
        ("import jax.numpy as jnp\n\n        rng = np.random.default_rng(5)",
         "import torch as jnp\n\n        rng = np.random.default_rng(5)"),
        ("jnp.ones(N, bool), n_devices=D, n_windows=W)",
         "jnp.ones(N, dtype=jnp.bool), n_devices=D, n_windows=W)"),
        ("np.asarray(sharded.counts)", "sharded.counts.gather().numpy()"),
        ("np.asarray(sharded.means)", "sharded.means.gather().numpy()"),
        ("np.asarray(sharded.variances)",
         "sharded.variances.gather().numpy()"),
        ("len(sharded.counts.sharding.device_set) == 8",
         "sharded.counts.n_shards == 8"),
        ("job = AnalyticsJob(window_s=3600)\n        plain",
         "job = AnalyticsJob(window_s=3600, device='cpu')\n        plain"),
    ), "TestShardedAnalytics"),
    "test_native_fill.py": ((), "TestReserveCommit.test_reserve_refuses_"
                                "oversize_only"),
}
_NS = {}


def _ns(module):
    if module not in _NS:
        edits, _ = MODULES[module]
        ns = port_test_module(os.path.join(TESTS, module), replace=edits)
        ns["_pieces"] = _pieces
        _NS[module] = ns
    return _NS[module]


def _cases(module):
    _, only = MODULES[module]
    cases = port_cases(_ns(module))
    if isinstance(only, str):
        cases = [c for c in cases if c == only or c.startswith(only + ".")]
    return cases


CASES = [(m, c) for m in MODULES for c in _cases(m)]


def test_the_port_runs_the_reference_mesh_modules():
    by_module = {}
    for module, _ in CASES:
        by_module[module] = by_module.get(module, 0) + 1
    assert by_module == {
        "test_mesh.py": 6, "test_batcher.py": 21,
        "test_sharded_instance.py": 4, "test_mesh_ring.py": 4,
        "test_analytics.py": 2, "test_native_fill.py": 1}


@pytest.mark.parametrize("module,case", CASES,
                         ids=[f"{m[5:-3]}::{c}" for m, c in CASES])
def test_reference_mesh_case_on_the_port(module, case, tmp_path, tmesh8):
    run_port_case(_ns(module), case, tmp_path, fixtures={
        "mesh8": tmesh8,
        "devices": [torch.device(d) for d in CPU8]})


# -- the mesh API ---------------------------------------------------------------

def test_mesh_shapes_and_placements(tmesh8):
    assert tmesh8.shape == {SHARD_AXIS: 8, MODEL_AXIS: 1}
    assert MeshSpec(n_shards=8).n_devices == 8
    x = torch.arange(64, dtype=torch.int32)
    xs = event_sharding(tmesh8).place(x)
    assert xs.n_shards == 8 and tuple(xs.shape) == (64,)
    assert [int(b[0]) for b in xs.shards] == list(range(0, 64, 8))
    assert torch.equal(xs.gather(), x)
    r = replicated(tmesh8).place(x)
    assert all(b is x for b in r.shards) and torch.equal(r.gather(), x)
    assert registry_sharding(tmesh8).place(xs) is xs
    with pytest.raises(ValueError):
        event_sharding(tmesh8).place(torch.zeros(12))
    assert shard_for_device(63, 64, 8) == 7


def test_make_mesh_raises_without_enough_devices():
    """A mesh asked of the default devices never collapses onto fewer:
    on a host without cards there are none."""
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="only 0 available"):
            make_mesh(8)
    with pytest.raises(ValueError):
        make_mesh(8, devices=["cpu"] * 4)


def test_instance_device_choices(tmp_path):
    """One device hosts every shard; a sequence names each; None takes
    the cards and raises without enough of them."""
    from sitewhere_tpu_torch.instance import _mesh_for

    mesh = _mesh_for(4, "cpu")
    assert mesh.shard_devices == (torch.device("cpu"),) * 4
    assert _mesh_for(1, "cpu") is None
    assert _mesh_for(2, ["cpu", "cpu"]).n_shards == 2
    if torch.cuda.device_count() < 4:
        with pytest.raises(ValueError):
            _mesh_for(4, None)


# -- the rule engine and the analytics job on a mesh ---------------------------

def test_mesh_rule_engine_matches_interp():
    """``tests/test_rules.py::test_mesh_dryrun_matches_interp`` on the port:
    the sharded prepare over 4 shards gives the interpreter's alerts, and
    the JAX mesh engine's."""
    import jax

    from sitewhere_tpu.parallel import make_mesh as jax_make_mesh
    from sitewhere_tpu.rules.engine import RuleEngineRunner as RefEngine
    from sitewhere_tpu_torch.rules.engine import RuleEngineRunner
    from test_rules import (collect_engine_alerts, doc_geo, doc_multi,
                            doc_value, make_batch)
    from test_torch_rules import port_interp_alerts

    d, t = 64, 8
    engines = (
        RuleEngineRunner(capacity=d, n_mtype_slots=4, asset_capacity=16,
                         queue_depth=4, mesh=make_mesh(devices=["cpu"] * 4),
                         rows_per_shard=d // 4),
        RefEngine(capacity=d, n_mtype_slots=4, asset_capacity=16,
                  queue_depth=4,
                  mesh=jax_make_mesh(4, devices=jax.devices()[:4]),
                  rows_per_shard=d // 4))
    fired = []
    for eng in engines:
        eng.registry.put_program(1, doc_value(thr=40.0))
        eng.registry.put_program(1, doc_multi())
        eng.registry.put_program(2, doc_geo())
        eng.attributes.set("device", 7, "tier", 2)
        eng.refresh()
        fired.append(collect_engine_alerts(eng))
    rng = np.random.default_rng(9)
    batches = [make_batch(rng, 64, d, t, t0=1000 + 600 * i)
               for i in range(3)]
    for b in batches:
        for eng in engines:
            eng._eval_batch(dict(b))
    assert sorted(fired[0]) == port_interp_alerts(engines[0], batches)
    assert sorted(fired[0]) == sorted(fired[1])
    assert len(fired[0]) > 0
    assert engines[0]._trail[0].n_shards == 4


def test_window_sharded_anomalies_match_single_chip(tmesh8):
    """``tests/test_analytics.py::test_window_sharded_anomalies_match_single_chip``
    and ``::test_window_sharded_halo_depth_guard`` on the port."""
    from sitewhere_tpu_torch.analytics import (
        build_window_grid,
        detect_anomalies,
        detect_anomalies_window_sharded,
    )

    d, w, n = 64, 32, 20_000
    rng = np.random.default_rng(3)
    dev = torch.from_numpy(rng.integers(0, d, n).astype(np.int32))
    win = torch.from_numpy(rng.integers(0, w, n).astype(np.int32))
    val = torch.from_numpy(rng.normal(10.0, 1.0, n).astype(np.float32))
    val = torch.where((dev == 7) & (win == 20), val + 25.0, val)
    grid = build_window_grid(dev, win, val, torch.ones(n, dtype=torch.bool),
                             d, w)
    a_ref, z_ref = detect_anomalies(grid, baseline_windows=4)
    a_sh, z_sh = detect_anomalies_window_sharded(tmesh8, grid,
                                                 baseline_windows=4)
    assert bool(a_ref[7].any())
    zr, zs = z_ref.numpy(), z_sh.gather().numpy()
    np.testing.assert_allclose(zr, zs, rtol=2e-3, atol=1e-3)
    off = np.abs(np.abs(zr) - 3.0) > 1e-2
    np.testing.assert_array_equal(a_ref.numpy()[off],
                                  a_sh.gather().numpy()[off])
    small = build_window_grid(
        torch.zeros(4, dtype=torch.int32), torch.zeros(4, dtype=torch.int32),
        torch.ones(4), torch.ones(4, dtype=torch.bool), 8, 16)
    with pytest.raises(ValueError):
        detect_anomalies_window_sharded(tmesh8, small, baseline_windows=4)


# -- the demoted-shard side route at FALLBACK ---------------------------------

def test_fallback_shard_side_steps_through_the_mesh(tmp_path, monkeypatch):
    """One shard at FALLBACK: its rows side-step through the mesh while
    the other shards keep chaining, every row is stored once, and the
    process does not exit.  Only when every shard is at FALLBACK does a
    dispatcher on a card fail closed."""
    from sitewhere_tpu_torch.runtime import dispatcher as tdisp
    from sitewhere_tpu_torch.runtime.devguard import FALLBACK

    ns = _ns("test_mesh_ring.py")
    exits = []

    def _exit(code):
        exits.append(code)
        raise SystemExit(code)

    monkeypatch.setattr(tdisp, "_exit_process", _exit)
    inst, by_shard = ns["_start"](ns["_config"](
        tmp_path, "fallback-shard", n_shards=4, ring_depth=4,
        overload={"cooldown_s": 3600.0}))
    try:
        disp = inst.dispatcher
        bank = disp.breaker
        for seq in range(6):                 # two trips: -> FALLBACK
            bank.record_fault(seq, shard=2)
        assert bank.level_of(2) == FALLBACK
        assert bank.demoted_shards() == (2,)
        ns["_ingest_rounds"](inst, by_shard, 8, seed=5)
        inst.event_store.flush()
        snap = disp.metrics_snapshot()
        assert exits == []
        assert snap["processed"] == 8 * ns["WIDTH"]
        assert inst.event_store.total_events == 8 * ns["WIDTH"]
        assert snap["ring_chains"] == 2
        assert disp.sidecar_steps == 8
        # on the CPU a side step is a CPU step, as the reference counts it
        assert int(inst.metrics.counter(
            "device.fault.cpu_fallback_steps").value) == 8
        for s in (0, 1, 3):
            assert bank.level_of(s) == 0
        assert not disp._tier_fallback()
        for s in (0, 1, 3):
            for seq in range(100, 106):
                bank.record_fault(seq, shard=s)
        assert disp._tier_fallback()
        plan = types.SimpleNamespace(seq=9, n_events=1)
        monkeypatch.setattr(disp, "device", torch.device("cuda", 0))
        with pytest.raises(SystemExit):
            disp._fallback_step(plan)
        assert exits == [tdisp.STICKY_EXIT_CODE]
        monkeypatch.setattr(disp, "device", torch.device("cpu"))
    finally:
        inst.stop()
        inst.terminate()


def test_unpacked_sharded_step_through_the_instance(tmp_path):
    """``pipeline.packed_step: false`` on a 4-shard mesh runs the unpacked
    sharded step (``build_sharded_step``) and stores, accepts and keeps
    the same state as the packed sharded step on the same traffic."""
    from sitewhere_tpu_torch.instance import Instance

    ns = _ns("test_mesh_ring.py")
    results = []
    for packed in (True, False):
        cfg = ns["_config"](tmp_path, f"packed-{packed}", n_shards=4,
                            ring_depth=0)
        cfg = type(cfg)({**cfg.as_dict(), "pipeline": {
            **cfg.as_dict()["pipeline"], "packed_step": packed}},
            apply_env=False)
        inst = Instance(cfg, device="cpu")
        assert inst._packed_step_enabled() is packed
        assert inst.batcher.emit_packed is packed
        inst.start()
        try:
            dm = inst.device_management
            dm.create_device_type(token="sensor", name="Sensor")
            for i in range(ns["CAP"]):
                dm.create_device(token=f"d-{i}", device_type="sensor")
                dm.create_device_assignment(device=f"d-{i}")
            handles = np.asarray(inst.identity.device.lookup_many(
                [f"d-{i}" for i in range(ns["CAP"])]), np.int32)
            by_shard = [handles[(handles // ns["RPS"]) == s]
                        for s in range(4)]
            ns["_ingest_rounds"](inst, by_shard, 3, seed=4)
            snap = inst.dispatcher.metrics_snapshot()
            st = inst.device_state
            results.append((
                {k: snap[k] for k in ("processed", "accepted", "steps")},
                inst.event_store.total_events,
                st.current_packed.si.n_shards,
                [np.asarray(getattr(st.current, f)).tobytes()
                 for f in st.current.__dataclass_fields__]))
        finally:
            inst.stop()
            inst.terminate()
    assert results[0] == results[1]
    assert results[0][0]["accepted"] == 3 * ns["WIDTH"]
