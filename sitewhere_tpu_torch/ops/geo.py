"""Geofence: batched point-in-polygon, the plain PyTorch version.

Counterpart of ``sitewhere_tpu/ops/geo.py``.  The dense ``[B, Z, V]``
ray-crossing test here is the plain version of the CUDA kernel in
:mod:`.geo_cuda`: the CPU tests run it, and ``chip_smoke.py`` holds the
kernel against it on the card.

Padding contract (as :class:`~sitewhere_tpu_torch.schema.ZoneTable`):
polygons are padded to ``V`` vertices by repeating the last real vertex,
so padded edges have zero length and the wraparound edge ``v[V-1] ->
v[0]`` is the true closing edge.
"""

from __future__ import annotations

import numpy as np
import torch


def pad_polygon(verts, max_verts: int) -> np.ndarray:
    """Host side: pad a polygon ring to ``max_verts`` by repeating its
    last vertex."""
    verts = np.asarray(verts, np.float32)
    if verts.ndim != 2 or verts.shape[1] != 2 or len(verts) < 3:
        raise ValueError(f"polygon needs shape [>=3, 2], got {verts.shape}")
    if len(verts) > max_verts:
        raise ValueError(f"polygon has {len(verts)} verts > max {max_verts}")
    pad = np.repeat(verts[-1:], max_verts - len(verts), axis=0)
    return np.concatenate([verts, pad])


def guarded_slope(x1: torch.Tensor, y1: torch.Tensor, x2: torch.Tensor,
                  y2: torch.Tensor) -> torch.Tensor:
    """``(x2 - x1) / (y2 - y1)``, with the denominator of a horizontal
    edge (which never straddles) set to 1 so the quotient stays finite."""
    denom = torch.where(y2 == y1, torch.ones_like(y1), y2 - y1)
    return (x2 - x1) / denom


def points_in_polygons(points: torch.Tensor, verts: torch.Tensor) -> torch.Tensor:
    """Ray-crossing containment for every (point, polygon) pair.

    Args:
      points: ``float32[B, 2]`` — (x, y) == (lon, lat).
      verts:  ``float32[Z, V, 2]`` — padded polygon rings.

    Returns ``bool[B, Z]``.  The crossing abscissa is rounded after the
    multiply and after the add (two separate ops), the rounding the CUDA
    kernel reproduces with ``__fmul_rn`` / ``__fadd_rn``.
    """
    px = points[:, 0][:, None, None]  # [B, 1, 1]
    py = points[:, 1][:, None, None]
    x1 = verts[None, :, :, 0]  # [1, Z, V]
    y1 = verts[None, :, :, 1]
    x2 = torch.roll(verts[:, :, 0], -1, dims=-1)[None]  # wraparound edge
    y2 = torch.roll(verts[:, :, 1], -1, dims=-1)[None]

    straddles = (y1 > py) != (y2 > py)
    slope = guarded_slope(x1, y1, x2, y2)
    x_cross = slope * (py - y1) + x1
    crossing = straddles & (px < x_cross)
    return (crossing.to(torch.int32).sum(dim=-1) % 2) == 1
