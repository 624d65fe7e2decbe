"""Where a run was placed on the host, for its result line: the CPUs the
process may run on, and the NVIDIA cards under ``/sys/bus/pci/devices``
(read only) with their NUMA node and local CPU list.  The record places
nothing: runs pinned to a fixed set of CPUs spread no less than unpinned
ones on the card's machines, which expose no PCI tree to say which CPUs
are local to a card (``PERF.md`` section 2)."""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, List, Optional

SYSFS_PCI = Path("/sys/bus/pci/devices")
NVIDIA = "0x10de"
GPU_CLASSES = ("0x0300", "0x0302")     # VGA and 3D controllers


def format_cpulist(cpus) -> str:
    """``cpus`` as a kernel cpulist of ranges, such as ``0-3,8,10-11``."""
    runs: List[List[int]] = []
    for c in sorted(cpus):
        if runs and c == runs[-1][1] + 1:
            runs[-1][1] = c
        else:
            runs.append([c, c])
    return ",".join(f"{a}-{b}" if b > a else f"{a}" for a, b in runs)


def _read(path: Path) -> Optional[str]:
    try:
        return path.read_text().strip()
    except OSError:
        return None


def cards(root: Path = SYSFS_PCI) -> List[Dict[str, Optional[str]]]:
    """The NVIDIA cards of this machine in bus order: bus address, NUMA
    node and local CPU list (None where the file is absent)."""
    found = []
    for dev in sorted(root.glob("*")) if root.is_dir() else []:
        if (_read(dev / "vendor") == NVIDIA
                and (_read(dev / "class") or "")[:6] in GPU_CLASSES):
            found.append({"bdf": dev.name,
                          "numa_node": _read(dev / "numa_node"),
                          "local_cpulist": _read(dev / "local_cpulist")})
    return found


def placement(root: Path = SYSFS_PCI) -> Dict:
    """``cpus``, the set this process may run on, and ``cards``."""
    return {"cpus": format_cpulist(os.sched_getaffinity(0)),
            "cards": cards(root)}
