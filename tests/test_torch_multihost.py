"""The multi-process mesh of the port against the reference, on the CPU.

- The reference's four in-process cases of ``tests/test_multihost.py``
  on the port (``torch_parity.port_test_module``), each JAX sharding read
  rewritten to its port counterpart: the shard count of a
  :class:`Sharded` for ``sharding.device_set``, and ``gather()`` for
  ``np.asarray`` of a global array.  The reference's two-process case
  drives its own JAX worker and stays with it; its port counterpart is
  below.
- Two processes over ``gloo`` (this file run as a script, one rank
  each), each holding 2 of 4 shards and only its own registry, state and
  batch rows, through one unpacked sharded step and one cross-rank
  ``ppermute``.  Each rank's rows, metrics and carry must be bitwise equal
  to the one-process 4-shard port mesh's on the same numpy inputs, and to
  the JAX sharded step's on 4 CPU devices (EWMAs within 4 ULPs of the
  value scale, as every JAX-vs-port comparison; the rest exact).
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

N_SHARDS = 4
N_PROCS = 2
HERE = os.path.dirname(os.path.abspath(__file__))
REF = os.path.join(HERE, "test_multihost.py")
PORT_CASES = ("test_initialize_noop_without_env",
              "test_all_shards_local_in_single_process",
              "test_owned_device_range_matches_router",
              "test_make_global_batch_round_trips")
# the JAX sharding reads of the round-trip case, as port reads
REPLACE = (
    ('assert len(out["device_id"].sharding.device_set) == 8',
     'assert out["device_id"].n_shards == 8'),
    ('np.testing.assert_array_equal(np.asarray(out["device_id"]),',
     'np.testing.assert_array_equal(out["device_id"].gather().numpy(),'),
    ('np.testing.assert_allclose(np.asarray(out["value"]), cols["value"])',
     'np.testing.assert_allclose(out["value"].gather().numpy(), '
     'cols["value"])'),
)


def _flat(prefix, tree, out):
    """Dataclass tree -> ``{"prefix.field": array}``."""
    import dataclasses

    for f in dataclasses.fields(tree):
        v = getattr(tree, f.name)
        if dataclasses.is_dataclass(v):
            _flat(f"{prefix}.{f.name}", v, out)
        else:
            out[f"{prefix}.{f.name}"] = v
    return out


def _unflat(cls, prefix, flat):
    """``{"prefix.field": array}`` -> a flat dataclass of tensors."""
    import dataclasses

    return cls(**{f.name: torch.from_numpy(
        np.array(flat[f"{prefix}.{f.name}"]))
        for f in dataclasses.fields(cls)})


# ---------------------------------------------------------------------------
# one rank of the two-process run (this file as a script)
# ---------------------------------------------------------------------------

def _rank_main(in_path: str, out_path: str) -> None:
    from sitewhere_tpu_torch.ops.geo import points_in_polygons
    from sitewhere_tpu_torch.parallel import multihost
    from sitewhere_tpu_torch.parallel.mesh import Placement, P, SHARD_AXIS
    from sitewhere_tpu_torch.parallel.shmap import collective_stats, ppermute
    from sitewhere_tpu_torch.pipeline.sharded import build_sharded_step
    from sitewhere_tpu_torch.schema import (
        DeviceState,
        EventBatch,
        Registry,
        RuleTable,
        ZoneTable,
    )

    torch.set_num_threads(1)
    assert multihost.initialize_from_env(backend="gloo")
    import torch.distributed as dist

    rank = dist.get_rank()
    mesh = multihost.make_process_mesh(N_SHARDS, device="cpu")
    assert multihost.process_local_shards(mesh) == [2 * rank, 2 * rank + 1]
    flat = dict(np.load(in_path))
    cap, width = int(flat.pop("cap")), int(flat.pop("width"))
    registry, state, rules, zones, batch = multihost.make_global_inputs(
        mesh, _unflat(Registry, "registry", flat),
        _unflat(DeviceState, "state", flat),
        _unflat(RuleTable, "rules", flat), _unflat(ZoneTable, "zones", flat),
        _unflat(EventBatch, "batch", flat),
        registry_capacity=cap, batch_width=width)
    step = build_sharded_step(mesh, geofence=points_in_polygons)
    new_state, out = step(registry, state, rules, zones, batch)
    got = {}
    for key, leaf in {**_flat("state", new_state, {}),
                      **_flat("out", out, {})}.items():
        got[key] = multihost.local_rows(leaf)
    # a block crosses ranks point to point: shard k's block to k+1
    ids = Placement(mesh, P(SHARD_AXIS)).place(
        torch.arange(N_SHARDS * 3, dtype=torch.int32))
    shifted = ppermute(ids, [(k, (k + 1) % N_SHARDS)
                             for k in range(N_SHARDS)])
    got["ppermute"] = multihost.local_rows(shifted)
    got["collectives"] = np.int64(collective_stats()["collectives"])
    np.savez(out_path, **got)
    dist.destroy_process_group()
    print(f"[rank {rank}] SPMD OK", flush=True)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(HERE))
    _rank_main(sys.argv[1], sys.argv[2])
    sys.exit(0)


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

from torch_parity import (  # noqa: E402
    CAP,
    WIDTH,
    assert_state_equal,
    jax_batch,
    make_cols,
    make_state,
    make_tables,
    np_of,
    port_test_module,
    run_port_case,
    torch_inputs,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def port_ns():
    return port_test_module(REF, replace=REPLACE)


@pytest.mark.parametrize("case", PORT_CASES)
def test_reference_multihost_case_on_the_port(port_ns, case, tmp_path,
                                              monkeypatch):
    from sitewhere_tpu_torch.parallel.mesh import make_mesh

    # the reference's `mesh8` fixture, as the port's eight CPU shards
    fixtures = {"mesh8": make_mesh(devices=["cpu"] * 8),
                "monkeypatch": monkeypatch}
    run_port_case(port_ns, case, tmp_path, fixtures=fixtures)


def _routed_cols(seed):
    """make_cols rows placed in their owning shard's segment, each
    segment padded with invalid rows (the sharded batcher's layout)."""
    rows, seg = CAP // N_SHARDS, WIDTH // N_SHARDS
    cols = make_cols(seed)
    dev = cols["device_id"]
    owned = (dev >= 0) & (dev < CAP)
    pad = int(np.nonzero(~owned)[0][0])
    idx = []
    for s in range(N_SHARDS):
        mine = list(np.nonzero(owned & (dev // rows == s))[0][:seg])
        idx += mine + [pad] * (seg - len(mine))
    out = {k: v[np.asarray(idx)].copy() for k, v in cols.items()}
    out["valid"] &= owned[np.asarray(idx)]
    # a few foreign rows: registered devices in another shard's segment
    out["device_id"][5] = (out["device_id"][5] + rows) % CAP
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_step_equals_one_process_mesh_and_jax(tmp_path, mesh8):
    import dataclasses

    import jax
    from jax.sharding import Mesh as JaxMesh

    from sitewhere_tpu.pipeline import sharded as js
    from sitewhere_tpu_torch.ops.geo import points_in_polygons
    from sitewhere_tpu_torch.parallel.mesh import gather, make_mesh
    from sitewhere_tpu_torch.parallel.multihost import slice_local
    from sitewhere_tpu_torch.parallel.shmap import tree_map
    from sitewhere_tpu_torch.pipeline import sharded as ts

    reg, rules, zones = make_tables()
    state, cols = make_state(), _routed_cols(11)
    treg, trules, tzones, tstate, tbatch = torch_inputs(reg, rules, zones,
                                                        state, cols)
    # the one-process 4-shard port mesh
    tmesh = make_mesh(devices=["cpu"] * N_SHARDS)
    one_state, one_out = ts.build_sharded_step(
        tmesh, geofence=points_in_polygons)(treg, tstate, trules, tzones,
                                            tbatch)
    one = {**_flat("state", tree_map(gather, one_state), {}),
           **_flat("out", tree_map(gather, one_out), {})}
    # the JAX sharded step on 4 CPU devices
    jmesh = JaxMesh(np.asarray(jax.devices("cpu")[:N_SHARDS]).reshape(
        N_SHARDS, 1), mesh8.axis_names)
    jstate, jout = js.build_sharded_step(jmesh, donate=False)(
        *js.place_inputs(jmesh, reg, state, rules, zones),
        js.place_batch(jmesh, jax_batch(cols)))
    assert_state_equal(jstate, tree_map(gather, one_state))
    for f in dataclasses.fields(jout):
        if f.name in ("derived_alerts", "metrics"):
            for g in dataclasses.fields(getattr(jout, f.name)):
                np.testing.assert_array_equal(
                    np.asarray(getattr(getattr(jout, f.name), g.name)),
                    np_of(one[f"out.{f.name}.{g.name}"]), err_msg=g.name)
        else:
            np.testing.assert_array_equal(
                np.asarray(getattr(jout, f.name)),
                np_of(one[f"out.{f.name}"]), err_msg=f.name)
    assert int(jout.metrics.accepted) > 20

    # each rank's input file holds only its own shards' rows
    port = _free_port()
    procs, outs = [], []
    for rank in range(N_PROCS):
        mine = type("M", (), {"n_shards": N_SHARDS,
                              "local_shards": (2 * rank, 2 * rank + 1)})
        flat = {"cap": np.int64(CAP), "width": np.int64(WIDTH)}
        for prefix, tree, rows in (("registry", treg, CAP),
                                   ("state", tstate, CAP),
                                   ("batch", tbatch, WIDTH)):
            for key, v in _flat(prefix, tree, {}).items():
                flat[key] = slice_local(v.numpy(), mine, rows)
        for prefix, tree in (("rules", trules), ("zones", tzones)):
            flat.update({k: v.numpy()
                         for k, v in _flat(prefix, tree, {}).items()})
        in_path = str(tmp_path / f"in{rank}.npz")
        np.savez(in_path, **flat)
        outs.append(str(tmp_path / f"out{rank}.npz"))
        env = dict(os.environ,
                   SW_COORDINATOR=f"127.0.0.1:{port}",
                   SW_NUM_PROCESSES=str(N_PROCS), SW_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), in_path, outs[-1]],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{log}"
        assert f"[rank {rank}] SPMD OK" in log, log

    for rank in range(N_PROCS):
        got = dict(np.load(outs[rank]))
        mine = type("M", (), {"n_shards": N_SHARDS,
                              "local_shards": (2 * rank, 2 * rank + 1)})
        for key, want in one.items():
            want = np_of(want)
            if key.startswith("out.metrics."):
                # summed over all four shards, in shard order, on each rank
                np.testing.assert_array_equal(got[key], want, err_msg=key)
            else:
                rows = CAP if (key.startswith("state.")
                               or key == "out.present_now") else WIDTH
                np.testing.assert_array_equal(
                    got[key], slice_local(want, mine, rows), err_msg=key)
        # shard k's block [3k, 3k+3) arrived on shard k+1
        expect = np.concatenate([np.arange(3 * ((k - 1) % N_SHARDS),
                                           3 * ((k - 1) % N_SHARDS) + 3)
                                 for k in (2 * rank, 2 * rank + 1)])
        np.testing.assert_array_equal(got["ppermute"], expect)
        assert int(got["collectives"]) >= 2
