"""The step over a device mesh: the Kafka-partitioning analog.

Counterpart of ``sitewhere_tpu/pipeline/sharded.py``.  The same
decomposition, as a :func:`~sitewhere_tpu_torch.parallel.shmap.shard_map`
over the ``shard`` axis:

- registry and state tensors are block-sharded along device capacity;
- the host batcher routes each event into the sub-batch of the shard that
  owns its registry row (:func:`~sitewhere_tpu_torch.parallel.mesh.shard_for_device`),
  so validation and enrichment gathers are shard-local;
- rules and zones are replicated;
- metrics are summed over the shards, so the host sees one global
  counter set.

A mis-routed event (its device row lives on another shard) gets a local
id outside ``[0, rows_local)``.  Every gather and scatter of the step
clamps or masks such ids before indexing (torch index ops raise or write
out of bounds where XLA clamps or drops), and ``validate_and_enrich``'s
range check reports the row unregistered, so the host dead-letter path
re-routes it.

Each shard's step calls :func:`~sitewhere_tpu_torch.pipeline.step.pipeline_step`,
so the geofence kernel launches once per shard per step, at the shard's
width.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from sitewhere_tpu_torch.ops.geo_cuda import points_in_polygons_auto
from sitewhere_tpu_torch.parallel.mesh import (
    SHARD_AXIS,
    Mesh,
    P,
    Placement,
    Sharded,
)
from sitewhere_tpu_torch.parallel.shmap import (
    PSUM,
    axis_index,
    place_tree,
    shard_map,
)
from sitewhere_tpu_torch.pipeline.packed import (
    PackedState,
    PackedTables,
    chain_over_slots,
    pack_outputs,
    pack_state,
    unpack_batch,
    unpack_state,
    unpack_tables,
)
from sitewhere_tpu_torch.pipeline.step import (
    GeofenceFn,
    PipelineOutputs,
    pipeline_step,
)
from sitewhere_tpu_torch.schema import (
    DeviceState,
    EventBatch,
    Registry,
    RuleTable,
    ZoneTable,
)


def _localize(batch: EventBatch, rows_local: int):
    """Global device ids -> this shard's local registry rows: ``(batch
    with local ids, offset)``.  Foreign rows fall outside
    ``[0, rows_local)``."""
    offset = axis_index(SHARD_AXIS) * rows_local
    local_ids = torch.where(batch.device_id >= 0,
                            batch.device_id - offset,
                            torch.full_like(batch.device_id, -1))
    return batch.replace(device_id=local_ids), offset


def build_sharded_step(mesh: Mesh,
                       geofence: GeofenceFn = points_in_polygons_auto):
    """The unpacked step over ``mesh``:
    ``step(registry, state, rules, zones, batch) -> (state, outputs)`` on
    placed inputs (:func:`place_inputs`, :func:`place_batch`; unplaced
    tensors are placed on the way in).  Row-level outputs are
    width-sharded, the state capacity-sharded, the metrics summed.
    Nothing is donated: torch steps never write their inputs."""
    in_specs = (P(SHARD_AXIS), P(SHARD_AXIS), P(), P(), P(SHARD_AXIS))
    out_specs = (P(SHARD_AXIS), _OUTPUT_SPECS)

    def local_step(registry, state, rules, zones, batch):
        local_batch, offset = _localize(batch, registry.capacity)
        new_state, out = pipeline_step(registry, state, rules, zones,
                                       local_batch, geofence)
        # derived alerts carry global device ids again
        derived = out.derived_alerts
        derived = derived.replace(device_id=torch.where(
            derived.device_id >= 0, derived.device_id + offset,
            derived.device_id))
        return new_state, dataclasses.replace(out, derived_alerts=derived)

    return shard_map(local_step, mesh=mesh, in_specs=in_specs,
                     out_specs=out_specs)


# Out specs of PipelineOutputs: every row-level field (the derived-alert
# batch included) sharded along the width, the metrics summed.
_OUTPUT_SPECS = PipelineOutputs(
    **{f.name: P(SHARD_AXIS) for f in dataclasses.fields(PipelineOutputs)
       if f.name != "metrics"},
    metrics=PSUM)


def build_sharded_packed_step(mesh: Mesh,
                              geofence: GeofenceFn = points_in_polygons_auto):
    """The packed interface over the mesh (the deployment form): the
    local step of :func:`build_sharded_step` behind the packed buffers.
    The batch crosses as ``[12, B] + [4, B]`` sharded on axis 1, the state
    as its two planes sharded by capacity, the outputs as one ``[10, B]``
    block sharded by width plus the summed metrics vector and the
    capacity-sharded presence map.  The carry is the state manager's live
    epoch, never written."""
    in_specs = (_packed_tables_specs(), _PACKED_STATE_SPEC,
                P(None, SHARD_AXIS), P(None, SHARD_AXIS))
    out_specs = (_PACKED_STATE_SPEC, P(None, SHARD_AXIS), PSUM,
                 P(SHARD_AXIS))

    def local_step(tables, ps, bi, bf):
        registry, rules, zones = unpack_tables(tables)
        state = unpack_state(ps)
        batch, _ = _localize(unpack_batch(bi, bf), registry.capacity)
        new_state, out = pipeline_step(registry, state, rules, zones,
                                       batch, geofence)
        # telemetry rides the summed metrics vector; derived-alert and
        # enrichment ids in `oi` are table indices (replicated tables,
        # so already global); device ids never leave the host columns
        oi, metrics, present = pack_outputs(out, batch)
        return pack_state(new_state), oi, metrics, present

    return shard_map(local_step, mesh=mesh, in_specs=in_specs,
                     out_specs=out_specs)


def build_sharded_packed_chain(mesh: Mesh, k: int,
                               geofence: GeofenceFn = points_in_polygons_auto):
    """The K-deep packed chain over the mesh: each shard threads its own
    carry through the K staged slots (:func:`chain_over_slots` over the
    id-offsetting local step), and the stacked ``[K, n]`` metrics are
    summed ONCE per chain, the per-step sum the single sharded step does
    K times.  Returns ``(ps', ois [K, 10, B], metrics [K, n],
    present [D])`` with ``ois`` width-sharded, metrics replicated and
    ``present`` capacity-sharded."""
    tables_specs = _packed_tables_specs()
    slot_spec = P(None, SHARD_AXIS)
    in_specs = (tables_specs, _PACKED_STATE_SPEC) + (slot_spec,) * (2 * k)
    out_specs = (_PACKED_STATE_SPEC, P(None, None, SHARD_AXIS), PSUM,
                 P(SHARD_AXIS))

    def local_step(tables, ps, bi, bf):
        registry, rules, zones = unpack_tables(tables)
        state = unpack_state(ps)
        batch, _ = _localize(unpack_batch(bi, bf), registry.capacity)
        new_state, out = pipeline_step(registry, state, rules, zones,
                                       batch, geofence)
        return pack_state(new_state), *pack_outputs(out, batch)

    def local_chain(tables, ps, *slots):
        return chain_over_slots(local_step, k, tables, ps, slots)

    return shard_map(local_chain, mesh=mesh, in_specs=in_specs,
                     out_specs=out_specs)


# The packed-mesh layout lives HERE, once: the shard_map specs and every
# host-side placement read these, so they cannot drift.
_PACKED_STATE_SPEC = P(None, SHARD_AXIS)


def _packed_tables_specs() -> PackedTables:
    return PackedTables(
        reg_i=P(None, SHARD_AXIS),   # registry shards by capacity
        rules_i=P(), rules_f=P(), taus=P(),   # small broadcast tables
        zones_i=P(), zones_v=P(),
    )


def place_packed_batch(mesh: Mesh, bi, bf):
    """One packed wire batch (host numpy or tensors) split along its
    width, a block per shard on its device.  A host block bound for a
    card is copied once into pinned memory and sent without blocking."""
    placement = Placement(mesh, _PACKED_STATE_SPEC)
    return _stage(placement, bi), _stage(placement, bf)


def _stage(placement: Placement, x) -> Sharded:
    if isinstance(x, Sharded):
        return placement.place(x)
    host = x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))
    if host.device.type != "cpu":
        return placement.place(host)
    placement.shard_shape(host.shape)
    devs = placement.mesh.shard_devices
    blocks = []
    for block, dev in zip(torch.chunk(host, len(devs), dim=placement.dim),
                          devs):
        if dev.type == "cuda":
            pinned = torch.empty(block.shape, dtype=block.dtype,
                                 pin_memory=True)
            pinned.copy_(block)
            blocks.append(pinned.to(dev, non_blocking=True))
        else:
            blocks.append(block.clone(memory_format=torch.contiguous_format))
    return Sharded(blocks, placement)


def place_packed_tables(mesh: Mesh, t: PackedTables) -> PackedTables:
    """A PackedTables with its canonical mesh placements."""
    return place_tree(mesh, t, _packed_tables_specs())


def place_packed_state(mesh: Mesh, ps: PackedState) -> PackedState:
    """A PackedState sharded by capacity (a no-op once the epoch already
    carries the placement, i.e. after the first step)."""
    return place_tree(mesh, ps, _PACKED_STATE_SPEC)


def unpack_sharded_state(ps: PackedState) -> DeviceState:
    """A mesh-placed packed epoch as the unpacked step's state: each field
    a :class:`Sharded` of its shards' views (capacity on axis 0)."""
    blocks = [unpack_state(ps.replace(si=si, sf=sf))
              for si, sf in zip(ps.si.shards, ps.sf.shards)]
    placement = Placement(ps.si.mesh, P(SHARD_AXIS))
    return DeviceState(**{
        f.name: Sharded([getattr(b, f.name) for b in blocks], placement)
        for f in dataclasses.fields(DeviceState)})


def place_inputs(mesh: Mesh, registry: Registry, state: DeviceState,
                 rules: RuleTable, zones: ZoneTable
                 ) -> Tuple[Registry, DeviceState, RuleTable, ZoneTable]:
    """The resident tables with their canonical placements: registry and
    state sharded on their leading (capacity) axis, their scalars
    replicated; rules and zones replicated."""
    return (
        place_tree(mesh, registry, P(SHARD_AXIS)),
        place_tree(mesh, state, P(SHARD_AXIS)),
        place_tree(mesh, rules, P()),
        place_tree(mesh, zones, P()),
    )


def place_batch(mesh: Mesh, batch: EventBatch) -> EventBatch:
    """An event batch sharded along its width."""
    return place_tree(mesh, batch, P(SHARD_AXIS))
