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
# a module that tried to import either would fail here
sys.modules["jax"] = None
sys.modules["sitewhere_tpu"] = None
import sitewhere_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m, mod in sys.modules.items() if mod is not None
             and (m in ("jax", "sitewhere_tpu")
                  or m.startswith(("jax.", "jaxlib", "flax",
                                   "sitewhere_tpu."))))
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
    assert int(count) == len(expected) >= 30


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


def test_dispatcher_raises_without_a_card(monkeypatch):
    from sitewhere_tpu_torch.ingest.batcher import Batcher
    from sitewhere_tpu_torch.runtime.dispatcher import PipelineDispatcher

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    batcher = Batcher(width=8, n_shards=1, registry_capacity=16,
                      resolve_device=lambda t: -1, resolve_mtype=lambda n: 0,
                      resolve_alert=lambda n: 0, emit_packed=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        PipelineDispatcher(batcher, lambda: None, None, lambda: None,
                           lambda: None, device=None)


def test_port_has_no_cpu_step_fallback():
    """No counterpart of the reference's ``_cpu_packed_step`` and no
    ``except`` that reroutes a device step: a device fault propagates."""
    import ast

    src = REPO / "sitewhere_tpu_torch" / "runtime" / "dispatcher.py"
    tree = ast.parse(src.read_text())
    names = {n.name for n in ast.walk(tree)
             if isinstance(n, (ast.FunctionDef, ast.ClassDef))}
    assert "_cpu_packed_step" not in names and "_cpu_step" not in names
    for node in ast.walk(tree):
        if isinstance(node, ast.ExceptHandler):
            body = ast.dump(ast.Module(body=node.body, type_ignores=[]))
            assert "_packed_step" not in body and "_step" not in body \
                and "'cpu'" not in body, ast.get_source_segment(
                    src.read_text(), node)
