"""The per-shard map: the one place that runs a local body once per shard.

Counterpart of ``sitewhere_tpu/parallel/shmap.py``, the reference's
version shim around ``jax.shard_map``.  The port's :func:`shard_map`
takes the same ``mesh`` / ``in_specs`` / ``out_specs`` and runs the local
body once per shard, in shard order, on the shard's device:

- each argument leaf is placed with its spec (a :class:`Sharded` already
  placed so passes through) and the body sees shard ``k``'s block;
- inside the body :func:`axis_index` is that shard's index;
- each output leaf is assembled with its out spec: a
  :class:`~sitewhere_tpu_torch.parallel.mesh.PartitionSpec` makes a
  :class:`Sharded` of the per-shard blocks, and :data:`PSUM` sums the
  shards' outputs, in shard order on shard 0's device, and gives the sum
  back to every shard (the reference's ``psum`` followed by a replicated
  out spec; every body of the repo calls ``psum`` as its last step).

A spec may be a prefix of its argument's tree: one spec for a whole
dataclass applies to each of its tensors.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Callable

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

_LOCAL = threading.local()


class _Psum:
    """Out spec: the sum over the shards, replicated (see module doc)."""

    def __repr__(self) -> str:
        return "PSUM"


PSUM = _Psum()


def axis_index(axis_name: str = SHARD_AXIS) -> int:
    """The index of the shard whose body is running."""
    if axis_name != SHARD_AXIS:
        raise ValueError(f"only the {SHARD_AXIS!r} axis is mapped")
    k = getattr(_LOCAL, "index", None)
    if k is None:
        raise RuntimeError("axis_index outside a shard_map body")
    return k


def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, Sharded, np.ndarray))


def _is_spec(x) -> bool:
    return isinstance(x, (PartitionSpec, _Psum))


def tree_map(fn: Callable, tree, *rest, is_leaf=_is_leaf):
    """``fn`` over the leaves of ``tree`` (dataclasses, tuples and lists
    recurse; other values pass through), with the matching nodes of
    ``rest`` as extra arguments."""
    if is_leaf(tree):
        return fn(tree, *rest)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        changes = {}
        for f in dataclasses.fields(tree):
            if not f.init:
                continue
            changes[f.name] = tree_map(
                fn, getattr(tree, f.name),
                *(getattr(r, f.name) for r in rest), is_leaf=is_leaf)
        return dataclasses.replace(tree, **changes)
    if isinstance(tree, (tuple, list)) and not isinstance(tree,
                                                          PartitionSpec):
        return type(tree)(
            tree_map(fn, t, *(r[i] for r in rest), is_leaf=is_leaf)
            for i, t in enumerate(tree))
    return tree


def broadcast_spec(spec, tree):
    """The spec tree of ``tree``: a spec at a node covers its subtree."""
    if _is_spec(spec):
        return tree_map(lambda _: spec, tree)
    if dataclasses.is_dataclass(spec) and not isinstance(spec, type):
        return dataclasses.replace(tree, **{
            f.name: broadcast_spec(getattr(spec, f.name),
                                   getattr(tree, f.name))
            for f in dataclasses.fields(spec) if f.init})
    if isinstance(spec, (tuple, list)):
        return type(tree)(broadcast_spec(s, t) for s, t in zip(spec, tree))
    raise TypeError(f"not a spec: {spec!r}")


def place(mesh: Mesh, x, spec: PartitionSpec):
    """One leaf placed on ``mesh`` with ``spec`` (0-d tensors replicate)."""
    if len(x.shape) == 0:
        spec = P()
    return Placement(mesh, spec).place(x)


def place_tree(mesh: Mesh, tree, spec):
    """Every leaf of ``tree`` placed with its spec from ``spec``."""
    return tree_map(lambda x, s: place(mesh, x, s), tree,
                    broadcast_spec(spec, tree))


def local_block(tree, k: int):
    """Shard ``k``'s view of a placed tree."""
    return tree_map(lambda x: x.shards[k] if isinstance(x, Sharded) else x,
                    tree)


def _device_ctx(dev: torch.device):
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def _assemble(mesh: Mesh, spec, *blocks):
    if isinstance(spec, _Psum):
        devs = mesh.shard_devices
        total = blocks[0].to(devs[0])
        for b in blocks[1:]:
            total = total + b.to(devs[0])
        return Sharded([total.to(d) for d in devs], Placement(mesh, P()))
    return Sharded(list(blocks), Placement(mesh, spec))


def ppermute(x: Sharded, perm) -> Sharded:
    """The collective permute over the ``shard`` axis: block ``j`` of the
    result is ``x``'s block ``i`` (moved to shard ``j``'s device) for
    each ``(i, j)`` in ``perm``, and zeros where no pair sends."""
    devs = x.mesh.shard_devices
    out = [torch.zeros_like(b) for b in x.shards]
    for i, j in perm:
        out[j] = x.shards[i].to(devs[j])
    return Sharded(out, x.placement)


def shard_map(f: Callable, *, mesh: Mesh, in_specs, out_specs):
    """``f`` mapped over the ``shard`` axis of ``mesh`` (see module doc).
    ``in_specs`` has one spec per argument, ``out_specs`` one per output
    (a single spec when ``f`` returns one value)."""
    n = mesh.n_shards
    devs = mesh.shard_devices

    def mapped(*args):
        if len(args) != len(in_specs):
            raise TypeError(
                f"expected {len(in_specs)} arguments, got {len(args)}")
        placed = tuple(place_tree(mesh, a, s)
                       for a, s in zip(args, in_specs))
        outs = []
        for k in range(n):
            local = local_block(placed, k)
            _LOCAL.index = k
            try:
                with _device_ctx(devs[k]):
                    outs.append(f(*local))
            finally:
                _LOCAL.index = None
        single = not isinstance(out_specs, tuple) or _is_spec(out_specs)
        if single:
            outs = [(o,) for o in outs]
            specs = (out_specs,)
        else:
            specs = out_specs
        result = tuple(
            tree_map(lambda s, *blocks: _assemble(mesh, s, *blocks),
                     broadcast_spec(spec, outs[0][i]),
                     *(o[i] for o in outs), is_leaf=_is_spec)
            for i, spec in enumerate(specs))
        return result[0] if single else result

    return mapped


__all__ = ["PSUM", "axis_index", "broadcast_spec", "local_block", "place",
           "place_tree", "ppermute", "shard_map", "tree_map"]
