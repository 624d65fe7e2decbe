"""The port's geofence against the JAX reference, on the CPU.

The plain PyTorch ``points_in_polygons`` must be bitwise equal to the JAX
dense path and to the Pallas kernel run in interpret mode.  The CUDA
kernel itself runs only on the card (``chip_smoke.py`` holds it against
the plain version there); here the wrapper's edge-plane layout is
checked by replaying the kernel's per-vertex loop over those planes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sitewhere_tpu.ops.geo import points_in_polygons as jax_pip
from sitewhere_tpu.ops.geo_pallas import points_in_polygons_pallas
from sitewhere_tpu_torch.ops import geo, geo_cuda
from torch_parity import random_zone_verts

torch.set_num_threads(1)


def _case(b, z, v, seed=42):
    rng = np.random.default_rng(seed)
    verts = random_zone_verts(rng, z, v)
    points = rng.uniform(-60, 60, (b, 2)).astype(np.float32)
    return points, verts


def _kernel_replay(points: torch.Tensor, verts: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel's arithmetic, vertex by vertex, over the planes the
    wrapper hands it (padding included), with xor parity."""
    y1, y2, x1, slope = geo_cuda.edge_planes(verts)
    px, py = points[:, :1], points[:, 1:]
    parity = torch.zeros((points.shape[0], verts.shape[0]), dtype=torch.int32)
    for v in range(y1.shape[0]):
        straddles = (y1[v] > py) != (y2[v] > py)
        x_cross = slope[v] * (py - y1[v]) + x1[v]
        parity ^= (straddles & (px < x_cross)).to(torch.int32)
    return parity.to(torch.bool)


@pytest.mark.parametrize("b,z,v", [(16, 4, 8), (300, 130, 16), (512, 256, 8)])
def test_plain_matches_jax_dense_and_pallas(b, z, v):
    points, verts = _case(b, z, v)
    dense = np.asarray(jax_pip(jnp.asarray(points), jnp.asarray(verts)))
    tiled = np.asarray(points_in_polygons_pallas(
        jnp.asarray(points), jnp.asarray(verts), interpret=True))
    got = geo.points_in_polygons(torch.from_numpy(points),
                                 torch.from_numpy(verts)).numpy()
    assert got.dtype == np.bool_ and got.shape == (b, z)
    np.testing.assert_array_equal(got, dense)
    np.testing.assert_array_equal(got, tiled)
    assert got.any()


@pytest.mark.parametrize("b,z,v", [(16, 4, 8), (300, 130, 16), (512, 256, 8),
                                   (33, 1, 3), (70, 9, 5), (40, 3, 32),
                                   (50, 5, 33), (64, 3, 70)])
def test_kernel_planes_replay_plain(b, z, v):
    points, verts = _case(b, z, v, seed=b + z + v)
    p, vt = torch.from_numpy(points), torch.from_numpy(verts)
    planes = geo_cuda.edge_planes(vt)
    assert all(t.shape == (planes[0].shape[0], z) for t in planes)
    vk = planes[0].shape[0]
    assert vk == geo_cuda.kernel_verts(v) >= v
    assert vk in geo_cuda.KERNEL_VERTS or vk % geo_cuda.KERNEL_VERTS[-1] == 0
    np.testing.assert_array_equal(_kernel_replay(p, vt).numpy(),
                                  geo.points_in_polygons(p, vt).numpy())


def test_known_square_and_degenerate_zone():
    square = geo.pad_polygon([[0, 0], [10, 0], [10, 10], [0, 10]], 8)
    verts = np.stack([square, np.zeros((8, 2), np.float32)])
    points = np.array([[5, 5], [15, 5], [-1, -1], [9.99, 9.99], [0, 0]],
                      np.float32)
    got = geo.points_in_polygons(torch.from_numpy(points),
                                 torch.from_numpy(verts)).numpy()
    # [0, 0] is a corner: boundary points land either way, as in the
    # reference, so only the comparison below pins it
    assert got[:4, 0].tolist() == [True, False, False, True]
    assert not got[:, 1].any()
    ref = np.asarray(points_in_polygons_pallas(
        jnp.asarray(points), jnp.asarray(verts), interpret=True))
    np.testing.assert_array_equal(got, ref)


def test_horizontal_edges_and_vertex_points():
    """Axis-aligned rectangles with points on their edges and corners: the
    guarded slope keeps horizontal edges out of the count."""
    rects = np.stack([
        geo.pad_polygon([[0, 0], [4, 0], [4, 2], [0, 2]], 8),
        geo.pad_polygon([[1, 1], [3, 1], [3, 1], [3, 3], [1, 3]], 8),
    ])
    xs, ys = np.meshgrid(np.arange(-1, 5.5, 0.5), np.arange(-1, 4.5, 0.5))
    points = np.stack([xs.ravel(), ys.ravel()], 1).astype(np.float32)
    got = geo.points_in_polygons(torch.from_numpy(points),
                                 torch.from_numpy(rects)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jax_pip(jnp.asarray(points), jnp.asarray(rects))))
    np.testing.assert_array_equal(
        _kernel_replay(torch.from_numpy(points), torch.from_numpy(rects)),
        got)


def test_auto_uses_plain_on_cpu_and_kernel_needs_cuda():
    square = geo.pad_polygon([[0, 0], [1, 0], [1, 1], [0, 1]], 4)
    pts = torch.tensor([[0.5, 0.5]])
    geo_cuda.reset_launch_counts()
    out = geo_cuda.points_in_polygons_auto(pts, torch.from_numpy(square[None]))
    assert bool(out[0, 0])
    assert geo_cuda.launch_counts["pip_parity"] == 0
    with pytest.raises(ValueError):
        geo_cuda.points_in_polygons_cuda(pts, torch.from_numpy(square[None]))


def test_edge_planes_reject_too_many_vertices():
    """No vertex count is too many: past the largest chunk the planes pad
    to a whole number of chunks, which the kernel loops over."""
    assert [geo_cuda.kernel_verts(v) for v in (3, 5, 16, 17, 32, 33, 70)] == [
        4, 8, 16, 32, 32, 64, 96]
    planes = geo_cuda.edge_planes(torch.ones((2, 33, 2)))
    assert all(t.shape == (64, 2) for t in planes)
    assert not planes[0][33:].any() and not planes[1][33:].any()


def test_pad_polygon_contract():
    p = geo.pad_polygon([[0, 0], [1, 0], [0, 1]], 6)
    assert p.shape == (6, 2) and (p[3:] == p[2]).all()
    with pytest.raises(ValueError):
        geo.pad_polygon([[0, 0], [1, 0]], 6)
    with pytest.raises(ValueError):
        geo.pad_polygon([[0, 0]] * 9, 6)
