"""The port's geofence against the JAX reference, on the CPU.

The plain PyTorch ``points_in_polygons`` must be bitwise equal to the JAX
dense path and to the Pallas kernel run in interpret mode.  The CUDA
kernel itself runs only on the card (``chip_smoke.py`` holds it against
the plain version there); here its arithmetic is checked by replaying it
over ``verts`` as the kernel stages them: register chunks of vertex
slots, the slope of each slot edge, one y-compare per slot shared by the
two edges that meet there, and the chunk carry above 32 vertices.
"""

import importlib.util
import os

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


def _chunk(v: int) -> int:
    """The kernel's register chunk for ``v`` vertices (``sw_pip_launch``)."""
    return next((k for k in (4, 8, 16, 32) if k >= v), 32)


_NAN = torch.tensor(0x7FFFFFFF, dtype=torch.int32).view(torch.float32)


def _card(v: torch.Tensor) -> torch.Tensor:
    """A float result as the card gives it: any NaN is the canonical NaN
    0x7fffffff (the CPU's generated NaN carries a sign bit)."""
    return torch.where(torch.isnan(v), _NAN, v)


def _staged(v: torch.Tensor) -> torch.Tensor:
    """As the kernel stages an input: -0 as +0, NaN canonical."""
    return _card(v + 0.0)


def _kernel_replay(points: torch.Tensor, verts: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel's arithmetic, slot by slot: chunk ``c`` holds slots
    ``0..VC`` (slot ``i`` is vertex ``c * VC + i``, or vertex 0 past the
    ring's end) and each slot edge's guarded slope; per slot one
    ``d = py - y`` shared by the edge ending and the edge starting there
    (the last edge of a single chunk reuses slot 0's); per edge ``e = px -
    x_cross``; the sign bit of ``(d_v ^ d_n) & e`` xor'd into the parity,
    across chunks too."""
    v = verts.shape[1]
    vc = _chunk(v)
    one_chunk = v <= vc
    px, py = _staged(points[:, :1]), _staged(points[:, 1:])
    parity = torch.zeros((points.shape[0], verts.shape[0]), dtype=torch.int32)
    for v0 in range(0, v, vc):
        idx = [v0 + i if v0 + i < v else 0 for i in range(vc + 1)]
        x, y = _staged(verts[:, idx, 0]), _staged(verts[:, idx, 1])
        slope = _card(geo.guarded_slope(x[:, :-1], y[:, :-1], x[:, 1:],
                                        y[:, 1:]))
        d = [_card(py - y[:, i]).view(torch.int32) for i in range(vc + 1)]
        if one_chunk:
            d[vc] = d[0]
        for i in range(vc):
            x_cross = _card(_card(slope[:, i] * d[i].view(torch.float32))
                            + x[:, i])
            e = _card(px - x_cross).view(torch.int32)
            parity ^= (d[i] ^ d[i + 1]) & e
    return parity < 0


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
    np.testing.assert_array_equal(_kernel_replay(p, vt).numpy(),
                                  geo.points_in_polygons(p, vt).numpy())


def test_shared_compare_on_vertex_ordinates():
    """Points on the ordinates of the vertices, padding vertices repeated:
    a compare shared by two edges decides both as two compares would, so
    the replay equals the plain version and the JAX dense path."""
    rng = np.random.default_rng(7)
    rings = [[[0, 0], [6, 0], [6, 3], [3, 3], [3, 6], [0, 6]],   # an L
             [[-4, -2], [-1, -5], [2, -2], [2, -2], [-1, 1]],   # repeat inside
             [[1, 1], [5, 2], [4, 5]],
             [[-6, 2], [-2, 2], [-2, 2], [-4, 7]]]
    verts = np.stack([geo.pad_polygon(r, 12) for r in rings]
                     + [geo.pad_polygon(r, 12)[::-1].copy() for r in rings])
    ys = np.unique(verts[:, :, 1])
    xs = np.concatenate([np.unique(verts[:, :, 0]),
                         rng.uniform(-8, 8, 24).astype(np.float32)])
    points = np.stack(np.meshgrid(xs, ys), -1).reshape(-1, 2).astype(
        np.float32)
    p, vt = torch.from_numpy(points), torch.from_numpy(verts)
    want = np.asarray(jax_pip(jnp.asarray(points), jnp.asarray(verts)))
    np.testing.assert_array_equal(geo.points_in_polygons(p, vt).numpy(), want)
    np.testing.assert_array_equal(_kernel_replay(p, vt).numpy(), want)
    assert want.any() and not want.all()


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


def test_replay_on_signed_zeros_and_nonfinite_values():
    """The signs of the rounded differences are the plain compares on -0,
    subnormals, infinities and NaN, in points and in vertices, and where a
    slope overflows to infinity and meets d == 0 (inf * 0).  XLA on the
    CPU flushes subnormals to zero, so the JAX dense path is compared on
    the rows and zones without one."""
    inf, nan = np.inf, np.nan
    xs = [-inf, -3.0, -0.0, 0.0, 0.5, 1.0, 2.0, 3.0, inf, nan]
    ys = [-inf, -1.0, -0.0, 0.0, 1e-45, 0.5, 1.0, 2.0, inf, nan]
    points = np.array([(x, y) for x in xs for y in ys], np.float32)
    rings = [[[-0.0, -0.0], [3, -0.0], [3, 2], [-0.0, 2]],
             [[0, 0], [2, 1e-45], [2, 2], [0, 2]],       # slope -> inf
             [[0, 0], [inf, 1], [0, 2]],
             [[0, 0], [2, nan], [2, 2], [0, 2]],
             [[-1, -inf], [1, 0], [0, 1]],
             [[-0.0, 0.5], [1, -0.0], [2, 0.5], [1, 1]],
             [[0, 0], [2, 1e30], [2, 2], [0, 1e-30]]]    # slope -> inf, 0
    verts = np.stack([geo.pad_polygon(r, 8) for r in rings])
    p, vt = torch.from_numpy(points), torch.from_numpy(verts)
    got = geo.points_in_polygons(p, vt).numpy()
    np.testing.assert_array_equal(_kernel_replay(p, vt).numpy(), got)
    tiny = lambda a: (a != 0) & (np.abs(a) < np.finfo(np.float32).tiny)  # noqa: E731
    rows = ~tiny(points).any(1)
    cols = ~tiny(verts).any((1, 2))
    want = np.asarray(jax_pip(jnp.asarray(points[rows]),
                              jnp.asarray(verts[cols])))
    np.testing.assert_array_equal(got[rows][:, cols], want)
    assert want.any() and got[~rows].any()


@pytest.mark.parametrize("points,verts,error", [
    (torch.zeros((4, 2), dtype=torch.float64), torch.zeros((2, 8, 2)),
     TypeError),
    (torch.zeros((4, 2)), torch.zeros((2, 8, 2), dtype=torch.float64),
     TypeError),
    (torch.zeros((4, 3)), torch.zeros((2, 8, 2)), ValueError),
    (torch.zeros((4, 2)), torch.zeros((2, 8, 3)), ValueError),
    (torch.zeros((4, 2)), torch.zeros((16, 2)), ValueError),
    (torch.zeros((4, 2)), torch.zeros((2, 0, 2)), ValueError),
])
def test_wrapper_rejects_inputs_before_the_card(points, verts, error,
                                                monkeypatch):
    """A float64 or wrongly shaped input raises before the wrapper builds,
    loads or launches anything."""
    def no_card(*args, **kwargs):
        raise AssertionError("the wrapper looked for the card")

    monkeypatch.setattr(geo_cuda, "library", no_card)
    monkeypatch.setattr(torch.cuda, "current_stream", no_card)
    with pytest.raises(error):
        geo_cuda.points_in_polygons_cuda(points, verts)


_SASS = """
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_117pip_parity_kernelILi16ELb1EEEvPK6float2S3_Phiiiii
\t.headerflags\t@"EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;        /* 0x00000a00ff017b82 */
                                                                 /* 0x000fe40000000800 */
        /*0010*/                   LDS.64 R2, [R5] ;
.L_x_0:
        /*0020*/                   FADD R7, -R6, R3 ;
        /*0030*/                   FMUL R8, R7, R9 ;
        /*0040*/                   FADD R8, R8, R10 ;
        /*0050*/                   FADD R8, R2, -R8 ;
        /*0060*/                   LOP3.LUT R11, R7, R12, R8, 0x28, !PT ;
        /*0070*/               @P0 BRA `(.L_x_0) ;
        /*0080*/                   STG.E.U8 desc[UR4][R4.64], R11 ;
        /*0090*/              @!P1 BRA 0x10 ;
        /*00a0*/                   EXIT ;
"""
_PTXAS = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_117pip_parity_kernelILi16ELb1EEEvPK6float2S3_Phiiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_117pip_parity_kernelILi16ELb1EEEvPK6float2S3_Phiiiii
    0 bytes stack frame, 8 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 8648 bytes smem
"""


def test_sass_counter_finds_the_edge_test_loop():
    """``tools/torch_pip_sass.py`` on a listing in both of cuobjdump's
    branch-target forms: the loop with the most FMUL, the smallest such,
    over its multiplies; registers and spills from the ptxas report."""
    spec = importlib.util.spec_from_file_location(
        "torch_pip_sass", os.path.join(os.path.dirname(__file__), "..",
                                       "tools", "torch_pip_sass.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    funcs = tool.functions(_SASS)
    (name, lines), = funcs.items()
    assert "pip_parity_kernelILi16ELb1E" in name
    loop = tool.edge_test_loop(lines)
    # the inner loop, not the outer one around it with the same FMUL
    assert (loop["instructions"], loop["edge_tests"]) == (6, 1)
    assert loop["by_opcode_per_test"] == {
        "FADD": 3.0, "FMUL": 1.0, "LOP3": 1.0, "BRA": 1.0}
    # a loop with more FMUL wins over a smaller one
    more = lines + ["        /*00b0*/  FMUL R1, R1, R1 ;",
                    "        /*00c0*/  BRA 0x10 ;"]
    assert tool.edge_test_loop(more)["edge_tests"] == 2
    assert tool.ptxas_report(_PTXAS) == {name: {
        "registers": 64, "spill_stores": 8, "spill_loads": 16}}


def test_pad_polygon_contract():
    p = geo.pad_polygon([[0, 0], [1, 0], [0, 1]], 6)
    assert p.shape == (6, 2) and (p[3:] == p[2]).all()
    with pytest.raises(ValueError):
        geo.pad_polygon([[0, 0], [1, 0]], 6)
    with pytest.raises(ValueError):
        geo.pad_polygon([[0, 0]] * 9, 6)
