"""The port stands alone: it imports neither JAX nor ``sitewhere_tpu``,
and it runs on the card unless the caller names the CPU."""

import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import sitewhere_tpu_torch
from sitewhere_tpu_torch.device import resolve_device
from sitewhere_tpu_torch.schema import DeviceState, EventBatch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent

_PROBE = """
import importlib, pkgutil, sys
import sitewhere_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "flax",
                                            "sitewhere_tpu.")))
print(len(names), bad)
"""


def test_port_imports_no_jax_and_no_reference():
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    count, bad = proc.stdout.strip().split(" ", 1)
    assert bad == "[]"
    expected = {m.name for m in pkgutil.walk_packages(
        sitewhere_tpu_torch.__path__, "sitewhere_tpu_torch.")}
    assert int(count) == len(expected) >= 15


def test_resolve_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError):
        EventBatch.empty(4)


def test_cpu_only_when_named():
    assert resolve_device("cpu") == torch.device("cpu")
    s = DeviceState.empty(8, 2, 3, device="cpu")
    assert s.ewma_values.shape == (8, 2, 3) and s.capacity == 8
    assert s.last_event_type.dtype == torch.int32
    assert s.presence_missing.dtype == torch.bool
