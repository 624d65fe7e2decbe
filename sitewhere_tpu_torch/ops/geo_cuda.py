"""The geofence kernel: point-in-polygon parity in CUDA C++ for Hopper.

Counterpart of ``sitewhere_tpu/ops/geo_pallas.py`` (``_pip_kernel`` :41,
launched by ``points_in_polygons_pallas`` :68).  The kernel source is
``sitewhere_tpu_torch/csrc/pip_kernel.cu``; this module builds it with
``nvcc`` for ``sm_90a`` at first launch into ``sitewhere_tpu_torch/_build/``,
binds its plain C entry points with ``ctypes`` and launches it on
PyTorch's current stream, once a call, on the step's own ``points`` and
``verts``: the kernel stages the vertices and computes the edge slopes
itself, so the wrapper lays nothing out.

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
from typing import Dict

import torch

from sitewhere_tpu_torch.ops.geo import points_in_polygons

PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = PKG_DIR / "csrc" / "pip_kernel.cu"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# The fields of ``sw_pip_plan``'s answer, in its order.
PLAN_FIELDS = ("vc", "one_chunk", "blocks_per_sm", "sms", "zone_tiles",
               "warps_per_tile", "grid", "groups", "regs", "local_bytes")

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


def library_path() -> Path:
    """Where the kernel library for this source and these flags lives."""
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"pip_kernel-{digest}.so"


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """Build (once per source content) and load the kernel library."""
    so = library_path()
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
    lib.sw_pip_launch.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                                  + [ctypes.c_void_p])
    lib.sw_pip_launch.restype = ctypes.c_int
    lib.sw_pip_plan.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.sw_pip_plan.restype = ctypes.c_int
    return lib


def _kernel_input(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the kernel reads it: contiguous and 8-byte aligned (float2
    loads); a copy only when ``t`` is neither."""
    if t.is_contiguous() and t.data_ptr() % 8 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def points_in_polygons_cuda(points: torch.Tensor,
                            verts: torch.Tensor) -> torch.Tensor:
    """``bool[B, Z]`` containment through the CUDA kernel, one launch.
    ``points`` ``float32[B, 2]`` and ``verts`` ``float32[Z, V, 2]`` on one
    card; raises on anything the kernel does not take, before it looks
    for the card."""
    if points.dtype != torch.float32 or verts.dtype != torch.float32:
        raise TypeError("points and verts must be float32")
    if points.ndim != 2 or points.shape[1] != 2:
        raise ValueError(f"points must be [B, 2], got {tuple(points.shape)}")
    if verts.ndim != 3 or verts.shape[1] < 1 or verts.shape[2] != 2:
        raise ValueError(
            f"verts must be [Z, V >= 1, 2], got {tuple(verts.shape)}")
    if not (points.is_cuda and verts.is_cuda) or points.device != verts.device:
        raise ValueError("points_in_polygons_cuda needs CUDA tensors on one "
                         "card")
    b, z = points.shape[0], verts.shape[0]
    out = torch.empty((b, z), dtype=torch.bool, device=points.device)
    if b and z:
        launch_pip(_kernel_input(points), _kernel_input(verts), out)
    return out


def launch_pip(points: torch.Tensor, verts: torch.Tensor,
               out: torch.Tensor) -> None:
    """Launch the kernel: ``points`` ``float32[B, 2]`` and ``verts``
    ``float32[Z, V, 2]``, contiguous and 8-byte aligned, and ``out``
    ``bool[B, Z]``, all on one card, on its current stream."""
    lib = library()
    b, z = out.shape
    stream = torch.cuda.current_stream(out.device).cuda_stream
    rc = lib.sw_pip_launch(points.data_ptr(), verts.data_ptr(),
                           out.data_ptr(), b, z, verts.shape[1],
                           out.device.index, stream)
    if rc != 0:
        raise RuntimeError(f"pip kernel launch failed: CUDA error {rc}")
    launch_counts["pip_parity"] += 1


def launch_plan(b: int, z: int, v: int, device: torch.device) -> Dict[str, int]:
    """The launch :func:`launch_pip` makes for ``(B, Z, V)`` on ``device``:
    :data:`PLAN_FIELDS` (chunk, blocks per SM, SMs, grid, groups of 32
    points, registers and spilled bytes a thread)."""
    plan = (ctypes.c_int * len(PLAN_FIELDS))()
    rc = library().sw_pip_plan(b, z, v, torch.device(device).index or 0,
                               ctypes.addressof(plan))
    if rc != 0:
        raise RuntimeError(f"pip kernel plan failed: CUDA error {rc}")
    return dict(zip(PLAN_FIELDS, plan))


def points_in_polygons_auto(points: torch.Tensor,
                            verts: torch.Tensor) -> torch.Tensor:
    """The geofence the step calls: the kernel for CUDA tensors, the plain
    version for CPU tensors, and nothing else."""
    if points.is_cuda:
        return points_in_polygons_cuda(points, verts)
    if points.device.type == "cpu":
        return points_in_polygons(points, verts)
    raise ValueError(f"no geofence for device {points.device}")
