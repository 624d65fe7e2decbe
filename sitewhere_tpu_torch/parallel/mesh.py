"""Mesh construction and the canonical placements of the event pipeline.

Counterpart of ``sitewhere_tpu/parallel/mesh.py``.  The reference builds a
``jax.sharding.Mesh`` over TPU chips; the port's :class:`Mesh` is a grid
of :class:`torch.device` entries driven by one process (the reference's
mesh is single-controller too).  A device may appear in several grid
cells, so every shard of a mesh can live on one card, as the reference's
tests put every shard on one host's virtual CPU devices.

Axes:

- ``shard``: the data axis.  Event batches (along B) and registry and
  state tensors (along D) are block-sharded over it.
- ``model``: a reserved second axis, size 1 for the event pipeline.

A tensor placed on the mesh is a :class:`Sharded`: one block per shard,
each on its shard's device, the counterpart of a JAX global array and its
addressable shards.  :meth:`Sharded.gather` assembles the whole for the
readers that need it.  A :class:`Placement` (the counterpart of
``NamedSharding``) says how a tensor is laid out: a
:class:`PartitionSpec` names, per tensor axis, the mesh axis it is split
over, or None.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

SHARD_AXIS = "shard"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Static description of the mesh topology."""

    n_shards: int
    model_parallel: int = 1

    @property
    def n_devices(self) -> int:
        return self.n_shards * self.model_parallel


class PartitionSpec(tuple):
    """Per tensor axis, the mesh axis it is split over (or None): the
    counterpart of ``jax.sharding.PartitionSpec``.  ``P()`` replicates."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    @property
    def shard_dim(self) -> Optional[int]:
        """The tensor axis split over ``shard``, or None (replicated)."""
        for i, part in enumerate(self):
            if part == SHARD_AXIS:
                return i
        return None

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


P = PartitionSpec


class Mesh:
    """A ``(shard, model)`` grid of :class:`torch.device` entries."""

    def __init__(self, grid: Sequence[Sequence[torch.device]]):
        self.devices = np.empty((len(grid), len(grid[0])), dtype=object)
        for i, row in enumerate(grid):
            for j, dev in enumerate(row):
                self.devices[i, j] = torch.device(dev)
        self.axis_names = (SHARD_AXIS, MODEL_AXIS)

    @property
    def shape(self) -> dict:
        return {SHARD_AXIS: self.devices.shape[0],
                MODEL_AXIS: self.devices.shape[1]}

    @property
    def size(self) -> int:
        return self.devices.size

    @property
    def n_shards(self) -> int:
        return self.devices.shape[0]

    @property
    def shard_devices(self) -> Tuple[torch.device, ...]:
        """The device of each shard (its ``model`` index 0)."""
        return tuple(self.devices[:, 0])

    def __repr__(self) -> str:
        return (f"Mesh(shard={self.shape[SHARD_AXIS]}, "
                f"model={self.shape[MODEL_AXIS]}, "
                f"devices={sorted({str(d) for d in self.devices.flat})})")


def _visible_devices() -> List[torch.device]:
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(
    n_devices: Optional[int] = None,
    model_parallel: int = 1,
    devices: Optional[Sequence[torch.device]] = None,
) -> Mesh:
    """Build a ``(shard, model)`` mesh over ``devices`` (default: the
    visible cards, ``cuda:0..``).  A list may name one device several
    times: those shards then share it.  Raises where the reference
    raises: fewer devices than asked for, or a count that
    ``model_parallel`` does not divide."""
    if devices is None:
        devices = _visible_devices()
    devices = [torch.device(d) for d in devices]
    if n_devices is None:
        n_devices = len(devices)
    if n_devices > len(devices):
        raise ValueError(
            f"requested n_devices={n_devices} but only {len(devices)} "
            f"available ({[str(d) for d in devices[:4]]}…)")
    if n_devices % model_parallel != 0:
        raise ValueError(
            f"n_devices={n_devices} not divisible by "
            f"model_parallel={model_parallel}")
    flat = devices[:n_devices]
    grid = [flat[i:i + model_parallel]
            for i in range(0, n_devices, model_parallel)]
    return Mesh(grid)


class Placement:
    """How a tensor lies on a mesh: the counterpart of ``NamedSharding``."""

    __slots__ = ("mesh", "spec")

    def __init__(self, mesh: Mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, PartitionSpec) else P(*spec)

    @property
    def dim(self) -> Optional[int]:
        return self.spec.shard_dim

    def shard_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        """The shape of one shard's block of a tensor of ``shape``."""
        shape = tuple(int(s) for s in shape)
        d = self.dim
        if d is None:
            return shape
        n = self.mesh.n_shards
        if shape[d] % n != 0:
            raise ValueError(
                f"axis {d} of shape {shape} is not divisible by the "
                f"mesh's {n} shards")
        return shape[:d] + (shape[d] // n,) + shape[d + 1:]

    def place(self, x) -> "Sharded":
        """``x`` (a tensor, a numpy array or a :class:`Sharded`) laid out
        with this placement: one contiguous block per shard, each on its
        shard's device."""
        if isinstance(x, Sharded):
            if x.placement == self:
                return x
            x = x.gather()
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        devs = self.mesh.shard_devices
        d = self.dim
        if d is None:
            return Sharded([x.to(dev) for dev in devs], self)
        self.shard_shape(x.shape)
        blocks = torch.chunk(x, len(devs), dim=d)
        return Sharded([b.to(dev).contiguous()
                        for b, dev in zip(blocks, devs)], self)

    def __eq__(self, other) -> bool:
        return (isinstance(other, Placement) and other.mesh is self.mesh
                and tuple(other.spec) == tuple(self.spec))

    def __hash__(self) -> int:
        return hash((id(self.mesh), tuple(self.spec)))

    def __repr__(self) -> str:
        return f"Placement({self.spec!r})"


class Sharded:
    """A global tensor held as one block per shard, each on its shard's
    device (a replicated placement holds one full copy per shard; shards
    on one device share it)."""

    __slots__ = ("shards", "placement")

    def __init__(self, shards: Sequence[torch.Tensor], placement: Placement):
        if len(shards) != placement.mesh.n_shards:
            raise ValueError(
                f"{len(shards)} blocks for a mesh of "
                f"{placement.mesh.n_shards} shards")
        self.shards = tuple(shards)
        self.placement = placement

    @property
    def mesh(self) -> Mesh:
        return self.placement.mesh

    @property
    def dim(self) -> Optional[int]:
        return self.placement.dim

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    @property
    def device(self) -> torch.device:
        """Shard 0's device."""
        return self.shards[0].device

    @property
    def shape(self) -> torch.Size:
        first = self.shards[0].shape
        d = self.dim
        if d is None:
            return first
        return torch.Size(first[:d] + (sum(s.shape[d] for s in self.shards),)
                          + first[d + 1:])

    def gather(self, device=None) -> torch.Tensor:
        """The whole tensor on ``device`` (default: shard 0's)."""
        dev = self.device if device is None else torch.device(device)
        if self.dim is None:
            return self.shards[0].to(dev)
        return torch.cat([s.to(dev) for s in self.shards], dim=self.dim)

    def map(self, fn) -> "Sharded":
        """``fn`` applied to every block, same placement."""
        return Sharded([fn(s) for s in self.shards], self.placement)

    def __repr__(self) -> str:
        return (f"Sharded(shape={tuple(self.shape)}, dtype={self.dtype}, "
                f"{self.placement!r}, n_shards={self.n_shards})")


def gather(x, device=None):
    """``x`` whole: a :class:`Sharded` gathered, anything else as is."""
    return x.gather(device) if isinstance(x, Sharded) else x


def event_sharding(mesh: Mesh) -> Placement:
    """Events sharded along the batch dim (the Kafka-partition analog)."""
    return Placement(mesh, P(SHARD_AXIS))


def registry_sharding(mesh: Mesh) -> Placement:
    """Registry and state tensors block-sharded along the capacity dim."""
    return Placement(mesh, P(SHARD_AXIS))


def replicated(mesh: Mesh) -> Placement:
    """Small broadcast tables (rules, zones) replicated on every shard."""
    return Placement(mesh, P())


def shard_for_device(device_id: int, capacity: int, n_shards: int) -> int:
    """Host-side routing: which shard owns this device's registry row.

    Registry arrays are block-sharded, so shard ``k`` owns rows
    ``[k*capacity/n_shards, (k+1)*capacity/n_shards)``.  The ingest
    batcher places each event in the sub-batch of its owning shard.
    """
    if capacity < n_shards or capacity % n_shards != 0:
        raise ValueError(
            f"registry capacity={capacity} must be a positive multiple of "
            f"n_shards={n_shards}"
        )
    return device_id // (capacity // n_shards)
