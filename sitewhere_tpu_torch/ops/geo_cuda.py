"""The geofence kernel: point-in-polygon parity in CUDA C++ for Hopper.

Counterpart of ``sitewhere_tpu/ops/geo_pallas.py`` (``_pip_kernel`` :41,
launched by ``points_in_polygons_pallas`` :68).  The kernel source is
``sitewhere_tpu_torch/csrc/pip_kernel.cu``; this module lays out its
inputs, builds it with ``nvcc`` for ``sm_90a`` at first launch into
``sitewhere_tpu_torch/_build/``, binds its plain C entry point with
``ctypes`` and launches it on PyTorch's current stream.

A failed build or launch raises.  There is no work-size switch yet:
:func:`points_in_polygons_auto` launches the kernel for every CUDA input
(the TPU crossover ``PALLAS_WORK_THRESHOLD`` was measured on a v5e and is
not carried over; an H100 sweep will choose one).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Tuple

import torch

from sitewhere_tpu_torch.ops.geo import guarded_slope, points_in_polygons

PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = PKG_DIR / "csrc" / "pip_kernel.cu"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# Edge chunk sizes the kernel is instantiated for: edge planes are padded
# with degenerate edges (y1 == y2 == 0 never straddles) up to the next of
# these, or above the last up to a multiple of it (a loop over chunks).
KERNEL_VERTS = (4, 8, 16, 32)

# Launches of each kernel, counted where the wrapper launches it.
launch_counts: Dict[str, int] = {"pip_parity": 0}
# The compiler's report (``-Xptxas -v``) from the build this process did.
build_log: Dict[str, str] = {}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the geofence kernel cannot be built")
    return found


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """Build (once per source content) and load the kernel library."""
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"pip_kernel-{digest}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}")
        build_log["pip_kernel"] = proc.stdout + proc.stderr
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    fn = lib.sw_pip_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def kernel_verts(v: int) -> int:
    """The padded vertex count ``V'`` the kernel runs for ``v`` vertices."""
    chunk = KERNEL_VERTS[-1]
    return next((k for k in KERNEL_VERTS if k >= v), -(-v // chunk) * chunk)


def edge_planes(verts: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """``float32[Z, V, 2]`` rings -> vertex-major ``[V', Z]`` planes
    ``(y1, y2, x1, slope)``, exactly as ``geo_pallas.py:89-98`` lays them
    out, padded to the kernel's vertex count ``V'`` with degenerate edges."""
    v = verts.shape[1]
    vk = kernel_verts(v)
    x1 = verts[:, :, 0].T.contiguous()  # [V, Z]
    y1 = verts[:, :, 1].T.contiguous()
    x2 = torch.roll(x1, -1, dims=0)
    y2 = torch.roll(y1, -1, dims=0)
    slope = guarded_slope(x1, y1, x2, y2)
    planes = (y1, y2, x1, slope)
    if vk != v:
        pad = verts.new_zeros((vk - v, verts.shape[0]))
        planes = tuple(torch.cat([p, pad]) for p in planes)
    return planes


def points_in_polygons_cuda(points: torch.Tensor,
                            verts: torch.Tensor) -> torch.Tensor:
    """``bool[B, Z]`` containment through the CUDA kernel (CUDA tensors
    only; raises on anything the kernel does not take)."""
    if not (points.is_cuda and verts.is_cuda):
        raise ValueError("points_in_polygons_cuda needs CUDA tensors")
    if points.dtype != torch.float32 or verts.dtype != torch.float32:
        raise TypeError("points and verts must be float32")
    if points.ndim != 2 or points.shape[1] != 2:
        raise ValueError(f"points must be [B, 2], got {tuple(points.shape)}")
    if verts.ndim != 3 or verts.shape[2] != 2:
        raise ValueError(f"verts must be [Z, V, 2], got {tuple(verts.shape)}")
    b, z = points.shape[0], verts.shape[0]
    out = torch.empty((b, z), dtype=torch.bool, device=points.device)
    if b == 0 or z == 0:
        return out
    launch_pip(points[:, 0].contiguous(), points[:, 1].contiguous(),
               edge_planes(verts), out)
    return out


def launch_pip(px: torch.Tensor, py: torch.Tensor,
               planes: Tuple[torch.Tensor, ...], out: torch.Tensor) -> None:
    """Launch the kernel on laid-out inputs: contiguous ``px``, ``py``
    ``float32[B]``, :func:`edge_planes` ``[V', Z]`` and ``out``
    ``bool[B, Z]``, all on one card, on its current stream."""
    lib = library()
    y1, y2, x1, slope = planes
    b, z = out.shape
    stream = torch.cuda.current_stream(out.device).cuda_stream
    rc = lib.sw_pip_launch(px.data_ptr(), py.data_ptr(), y1.data_ptr(),
                           y2.data_ptr(), x1.data_ptr(), slope.data_ptr(),
                           out.data_ptr(), b, z, y1.shape[0], stream)
    if rc != 0:
        raise RuntimeError(f"pip kernel launch failed: CUDA error {rc}")
    launch_counts["pip_parity"] += 1


def points_in_polygons_auto(points: torch.Tensor,
                            verts: torch.Tensor) -> torch.Tensor:
    """The geofence the step calls: the kernel for CUDA tensors, the plain
    version for CPU tensors, and nothing else."""
    if points.is_cuda:
        return points_in_polygons_cuda(points, verts)
    if points.device.type == "cpu":
        return points_in_polygons(points, verts)
    raise ValueError(f"no geofence for device {points.device}")
