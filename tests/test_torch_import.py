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


_NATIVE_PROBE = """
import json, sys
sys.modules["jax"] = None
sys.modules["sitewhere_tpu"] = None
from sitewhere_tpu_torch import native
mod = native.load_swwire()
bad = sorted(m for m, v in sys.modules.items() if v is not None
             and (m == "sitewhere_tpu" or m.startswith(("sitewhere_tpu.",
                                                        "jax"))))
print(json.dumps([str(native.SOURCE), str(native.library_path),
                  mod.__name__, bad]))
"""


def test_native_tier_builds_under_the_port_and_imports_no_reference():
    """The port's scanner library builds from its own ``swwire.c`` into
    ``sitewhere_tpu_torch/_build/``, never next to the reference's
    extension, and loading it imports nothing of ``sitewhere_tpu``."""
    import json

    proc = subprocess.run([sys.executable, "-c", _NATIVE_PROBE], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    source, library, name, bad = json.loads(proc.stdout.strip())
    assert Path(source) == REPO / "sitewhere_tpu_torch" / "native" / "swwire.c"
    assert Path(library).parent == REPO / "sitewhere_tpu_torch" / "_build"
    assert Path(library).name.startswith("_swwire_torch-")
    assert name == "_swwire_torch" and bad == []


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


# The persist-and-restart slice's modules, each imported on its own with
# JAX and the reference blocked.
SLICE4_MODULES = (
    "store.segment", "store.scan", "store.tiering", "store.sealer",
    "store.compaction", "store.catalog", "store.segmented",
    "services.event_store", "runtime.config", "runtime.checkpoint",
    "instance",
)

_ONE_BY_ONE = """
import importlib, json, sys
sys.modules["jax"] = None
sys.modules["sitewhere_tpu"] = None
out = {}
for name in sys.argv[1:]:
    before = set(sys.modules)
    try:
        importlib.import_module("sitewhere_tpu_torch." + name)
        out[name] = "ok"
    except Exception as e:
        out[name] = f"{type(e).__name__}: {e}"
bad = sorted(m for m, v in sys.modules.items() if v is not None
             and (m.startswith("jax") or m == "sitewhere_tpu"
                  or m.startswith("sitewhere_tpu.")))
print(json.dumps([out, bad]))
"""


@pytest.fixture(scope="module")
def slice4_imports():
    import json

    proc = subprocess.run(
        [sys.executable, "-c", _ONE_BY_ONE, *SLICE4_MODULES], cwd=REPO,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip())


@pytest.mark.parametrize("name", SLICE4_MODULES)
def test_slice4_module_imports_without_jax(slice4_imports, name):
    out, bad = slice4_imports
    assert out[name] == "ok"
    assert bad == []


def test_instance_raises_without_a_card(monkeypatch, tmp_path):
    from sitewhere_tpu_torch.instance import Instance
    from sitewhere_tpu_torch.runtime.config import Config

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config({"instance": {"data_dir": str(tmp_path)},
                  "pipeline": {"width": 8, "registry_capacity": 16}},
                 apply_env=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Instance(cfg)
    assert not (tmp_path / "checkpoint").exists()


# The bring-your-own rules slice: the package and each module imported on
# its own with JAX and the reference blocked.
SLICE5_MODULES = (
    "rules", "rules.dsl", "rules.interp", "rules.compile", "rules.enrich",
    "rules.registry", "rules.engine",
)


@pytest.fixture(scope="module")
def slice5_imports():
    import json

    proc = subprocess.run(
        [sys.executable, "-c", _ONE_BY_ONE, *SLICE5_MODULES], cwd=REPO,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip())


@pytest.mark.parametrize("name", SLICE5_MODULES)
def test_slice5_module_imports_without_jax(slice5_imports, name):
    out, bad = slice5_imports
    assert out[name] == "ok"
    assert bad == []


def test_rule_engine_raises_without_a_card(monkeypatch):
    from sitewhere_tpu_torch.rules.engine import RuleEngineRunner

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        RuleEngineRunner(capacity=16)


# The streaming analytics slice: the package and each module imported on
# its own with JAX and the reference blocked.
SLICE6_MODULES = (
    "analytics", "analytics.windows", "analytics.cep", "analytics.query",
    "analytics.checkpoint", "analytics.runner", "analytics.charts",
)


@pytest.fixture(scope="module")
def slice6_imports():
    import json

    proc = subprocess.run(
        [sys.executable, "-c", _ONE_BY_ONE, *SLICE6_MODULES], cwd=REPO,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip())


@pytest.mark.parametrize("name", SLICE6_MODULES)
def test_slice6_module_imports_without_jax(slice6_imports, name):
    out, bad = slice6_imports
    assert out[name] == "ok"
    assert bad == []


@pytest.mark.parametrize("entry", ["QueryRunner", "AnalyticsJob",
                                   "build_chart_series"])
def test_analytics_entry_points_default_to_the_card(monkeypatch, entry):
    """With no device named, each entry point resolves ``cuda:0``: here,
    without a card, that raises."""
    from sitewhere_tpu_torch import analytics
    from sitewhere_tpu_torch.analytics.charts import build_chart_series

    calls = {"QueryRunner": lambda: analytics.QueryRunner(capacity=16),
             "AnalyticsJob": lambda: analytics.AnalyticsJob(),
             "build_chart_series": lambda: build_chart_series(object())}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()
