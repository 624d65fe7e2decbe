"""Multi-process execution: one sharded pipeline step across processes.

Counterpart of ``sitewhere_tpu/parallel/multihost.py``.  The reference
runs one ``shard_map`` program over a mesh that spans hosts through
``jax.distributed``; the port runs the same per-shard bodies in several
processes joined by ``torch.distributed``:

1. every process calls :func:`initialize_from_env` (coordinator address,
   process count and id from arguments or the environment), which calls
   ``init_process_group`` with an explicit ``tcp://`` address, world size
   and rank;
2. :func:`make_process_mesh` builds a mesh whose ``shard`` axis spans the
   ranks: each shard has an owning rank and a device, and a process holds
   only its own shards (:func:`process_local_shards`,
   :func:`owned_device_range`);
3. each process contributes ONLY its shards' registry and state rows and
   its batch segment (:func:`make_global_tree`, :func:`make_global_inputs`,
   :func:`make_global_batch`): no process ever materializes a whole
   global array;
4. the sharded step runs each process's shards, and its summed metrics
   are all-gathered and summed in global shard order on every rank
   (``parallel/shmap.py``), so every rank's result is bitwise the
   one-process mesh's.

The backend: ``backend=None`` takes ``nccl`` when every rank has a card
of its own (at least as many visible cards as processes) and ``gloo``
otherwise, which stages card tensors through the host; NCCL cannot put
two ranks on one card.  A named backend that cannot run raises; there is
no quiet fallback.

Durability stays per process: each journals its own ingest and commits
its own offsets, as in the reference.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from sitewhere_tpu_torch.parallel.mesh import (
    SHARD_AXIS,
    Mesh,
    P,
    PartitionSpec,
    Placement,
    Sharded,
)
from sitewhere_tpu_torch.parallel.shmap import broadcast_spec, tree_map

logger = logging.getLogger("sitewhere_tpu_torch.multihost")

#: the meta device stands for a shard another process holds
REMOTE = torch.device("meta")


def choose_backend(num_processes: int, backend: Optional[str] = None) -> str:
    """The process group's backend (see the module doc): raises for a
    named backend this host cannot run."""
    import torch.distributed as dist

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if backend is None:
        return "nccl" if cards >= num_processes and cards > 0 else "gloo"
    if backend == "nccl":
        if not dist.is_nccl_available() or cards == 0:
            raise RuntimeError("backend 'nccl' needs a CUDA card and NCCL")
        if cards < num_processes:
            raise RuntimeError(
                f"backend 'nccl' puts one rank on each card: {cards} "
                f"card(s) for {num_processes} processes (use 'gloo')")
        return backend
    if backend == "gloo":
        if not dist.is_gloo_available():
            raise RuntimeError("backend 'gloo' is not available")
        return backend
    raise RuntimeError(f"unknown backend {backend!r}")


def initialize_from_env(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> bool:
    """``torch.distributed.init_process_group`` from arguments or the
    environment: ``SW_COORDINATOR`` (host:port), ``SW_NUM_PROCESSES``
    and ``SW_PROCESS_ID``, as the reference reads them.  Returns True if
    the process group was initialized; False for the single-process
    default (no coordinator given)."""
    import torch.distributed as dist

    coordinator_address = coordinator_address or os.environ.get(
        "SW_COORDINATOR")
    if coordinator_address is None:
        return False
    num_processes = int(num_processes
                        or os.environ.get("SW_NUM_PROCESSES", "1"))
    process_id = int(process_id
                     if process_id is not None
                     else os.environ.get("SW_PROCESS_ID", "0"))
    backend = choose_backend(num_processes, backend)
    dist.init_process_group(
        backend=backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id)
    logger.info("torch.distributed (%s): process %d/%d via %s", backend,
                process_id, num_processes, coordinator_address)
    return True


def make_process_mesh(n_shards: int, device) -> Mesh:
    """A mesh of ``n_shards`` shards over the process group: rank ``r``
    owns the contiguous shards ``[r*n/W, (r+1)*n/W)``, all on its
    ``device`` (several shards share it).  The other ranks' shards show the ``meta`` device here.  Without an
    initialized process group the mesh is this process's alone."""
    import torch.distributed as dist

    dev = torch.device(device)
    if not dist.is_initialized():
        return Mesh([[dev]] * n_shards)
    world = dist.get_world_size()
    rank = dist.get_rank()
    if n_shards % world != 0:
        raise ValueError(
            f"{n_shards} shards do not divide over {world} processes")
    per = n_shards // world
    ranks = [k // per for k in range(n_shards)]
    grid = [[dev if owner == rank else REMOTE] for owner in ranks]
    return Mesh(grid, ranks=ranks, rank=rank)


def process_local_shards(mesh: Mesh) -> List[int]:
    """Indices along the ``shard`` axis this process holds: its sources
    feed only these shards' device populations."""
    return list(mesh.local_shards)


def owned_device_range(shard: int, registry_capacity: int,
                       n_shards: int) -> Tuple[int, int]:
    """[lo, hi) of dense device handles shard ``shard`` owns (block
    sharding; matches ``parallel.mesh.shard_for_device``)."""
    if registry_capacity % n_shards != 0:
        raise ValueError(
            f"capacity={registry_capacity} not divisible by {n_shards}")
    rows = registry_capacity // n_shards
    return shard * rows, (shard + 1) * rows


def _local_leaf(mesh: Mesh, local, spec: PartitionSpec,
                global_rows: int) -> Sharded:
    """One leaf of this process's rows as a :class:`Sharded`: its blocks
    on this process's shards, None elsewhere.  A sharded leaf carries
    this process's shards' rows contiguously along its split axis (the
    global axis is ``global_rows`` long); a replicated one is whole and
    equal on every process."""
    if isinstance(local, np.ndarray):
        local = torch.from_numpy(np.ascontiguousarray(local))
    if local.ndim == 0:
        spec = P()
    placement = Placement(mesh, spec)
    devs = mesh.shard_devices
    mine = mesh.local_shards
    blocks: List[Optional[torch.Tensor]] = [None] * mesh.n_shards
    d = placement.dim
    if d is None:
        for k in mine:
            blocks[k] = local.to(devs[k])
        return Sharded(blocks, placement)
    per = global_rows // mesh.n_shards
    if global_rows % mesh.n_shards or local.shape[d] != per * len(mine):
        raise ValueError(
            f"axis {d} of this process's leaf holds {local.shape[d]} rows; "
            f"{len(mine)} shards of {global_rows}/{mesh.n_shards} expected")
    for k, part in zip(mine, torch.chunk(local, len(mine), dim=d)):
        blocks[k] = part.to(devs[k]).contiguous()
    return Sharded(blocks, placement)


def make_global_tree(mesh: Mesh, local_tree, specs, global_rows: int):
    """A tree of this process's LOCAL rows as mesh-placed
    :class:`Sharded` leaves (the reference's
    ``make_array_from_process_local_data`` per leaf).  ``specs`` is the
    matching spec tree (a spec at a node covers its subtree): sharded
    leaves carry this process's shards' rows of a global axis
    ``global_rows`` long; replicated leaves (``P()``) are equal on every
    process and keep their shape."""
    return tree_map(lambda x, s: _local_leaf(mesh, x, s, global_rows),
                    local_tree, broadcast_spec(specs, local_tree))


def _sharded_specs(tree):
    """Capacity-sharded leaves, scalars replicated."""
    return tree_map(lambda x: P(SHARD_AXIS) if np.ndim(x) else P(), tree)


def make_global_inputs(mesh: Mesh, registry_local, state_local, rules,
                       zones, batch_local, *, registry_capacity: int,
                       batch_width: int):
    """The multi-process analog of ``pipeline.sharded.place_inputs`` and
    ``place_batch``: each process contributes ONLY its shards' registry
    and state rows and its batch segment; rules and zones replicate."""
    return (
        make_global_tree(mesh, registry_local, _sharded_specs(registry_local),
                         registry_capacity),
        make_global_tree(mesh, state_local, _sharded_specs(state_local),
                         registry_capacity),
        make_global_tree(mesh, rules, P(), 0),
        make_global_tree(mesh, zones, P(), 0),
        make_global_tree(mesh, batch_local, _sharded_specs(batch_local),
                         batch_width),
    )


def make_global_packed_inputs(mesh: Mesh, tables_local, ps_local, *,
                              registry_capacity: int):
    """The packed step's resident inputs from this process's rows: the
    packed tables (the registry plane sharded by capacity, rules and
    zones replicated) and the packed state carry sharded by capacity."""
    from sitewhere_tpu_torch.pipeline.sharded import (
        _PACKED_STATE_SPEC,
        _packed_tables_specs,
    )

    return (make_global_tree(mesh, tables_local, _packed_tables_specs(),
                             registry_capacity),
            make_global_tree(mesh, ps_local, _PACKED_STATE_SPEC,
                             registry_capacity))


def make_global_packed_batch(mesh: Mesh, bi_local, bf_local,
                             global_width: int):
    """This process's segment of one packed wire batch (``[12, w]`` and
    ``[4, w]`` for its shards) as the mesh-placed batch."""
    from sitewhere_tpu_torch.pipeline.sharded import _PACKED_STATE_SPEC

    return (_local_leaf(mesh, bi_local, _PACKED_STATE_SPEC, global_width),
            _local_leaf(mesh, bf_local, _PACKED_STATE_SPEC, global_width))


def make_global_batch(mesh: Mesh, local_cols: Dict[str, np.ndarray],
                      global_width: int) -> Dict[str, Sharded]:
    """This process's batch segment as the global sharded batch, without
    materializing the full array anywhere.  ``local_cols`` carries this
    process's rows for ITS shard segments, contiguously."""
    specs = {name: P(SHARD_AXIS) for name in local_cols}
    return {name: _local_leaf(mesh, col, specs[name], global_width)
            for name, col in local_cols.items()}


def local_rows(x: Sharded) -> np.ndarray:
    """This process's blocks of a sharded leaf, joined on the host in
    shard order (a replicated leaf: its first local copy)."""
    blocks = [b.cpu().numpy() for b in x.local_blocks]
    if x.dim is None:
        return blocks[0]
    return np.concatenate(blocks, axis=x.dim)


def slice_local(full, mesh: Mesh, global_rows: int, dim: int = 0):
    """This process's shards' rows of a host array laid out globally
    (for callers that hold the whole input, such as tests)."""
    full = np.asarray(full)
    if full.ndim == 0:
        return full
    per = global_rows // mesh.n_shards
    parts = [np.take(full, np.arange(k * per, (k + 1) * per), axis=dim)
             for k in mesh.local_shards]
    return np.concatenate(parts, axis=dim)


__all__ = ["choose_backend", "initialize_from_env", "local_rows",
           "make_global_batch", "make_global_inputs",
           "make_global_packed_batch", "make_global_packed_inputs",
           "make_global_tree", "make_process_mesh", "owned_device_range",
           "process_local_shards", "slice_local"]
