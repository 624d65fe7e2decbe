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


#: the ingest sources' modules (named, so a rename cannot drop one from
#: the walk above unnoticed)
SOURCE_MODULES = (
    "sitewhere_tpu_torch.ingest", "sitewhere_tpu_torch.ingest.sources",
    "sitewhere_tpu_torch.ingest.dedup", "sitewhere_tpu_torch.ingest.factory",
    "sitewhere_tpu_torch.ingest.coap", "sitewhere_tpu_torch.ingest.mqtt_broker",
    "sitewhere_tpu_torch.ingest.stomp", "sitewhere_tpu_torch.ingest.amqp",
    "sitewhere_tpu_torch.ingest.amqp10", "sitewhere_tpu_torch.ingest.decoders",
    "sitewhere_tpu_torch.web", "sitewhere_tpu_torch.web.ws",
)

_SOURCES_PROBE = """
import importlib, json, sys
sys.modules["jax"] = None
sys.modules["sitewhere_tpu"] = None
for name in json.loads(sys.argv[1]):
    importlib.import_module(name)
from sitewhere_tpu_torch.ingest import (AmqpReceiver, BinaryDecoder,
    CoapServerReceiver, CompositeDecoder, StompReceiver)
from sitewhere_tpu_torch.ingest.amqp10 import EventHubReceiver
from sitewhere_tpu_torch.ingest.mqtt_broker import MqttBrokerReceiver
from sitewhere_tpu_torch.ingest.sources import DecodePool, WebSocketReceiver
bad = sorted(m for m, v in sys.modules.items() if v is not None
             and (m in ("jax", "sitewhere_tpu")
                  or m.startswith(("jax.", "sitewhere_tpu."))))
print(json.dumps(bad))
"""


def test_ingest_source_modules_import_without_jax_or_reference():
    import json

    proc = subprocess.run(
        [sys.executable, "-c", _SOURCES_PROBE, json.dumps(SOURCE_MODULES)],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip()) == []
    walked = {m.name for m in pkgutil.walk_packages(
        sitewhere_tpu_torch.__path__, "sitewhere_tpu_torch.")}
    assert set(SOURCE_MODULES) <= walked


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
    ``except`` that reroutes a device step: a failed step is contained on
    its own device (re-dispatch, bisection through
    ``_contain_step_failure``) or fails closed, and the breaker's
    FALLBACK level fails closed on a card (``_fallback_step``)."""
    import ast

    src = REPO / "sitewhere_tpu_torch" / "runtime" / "dispatcher.py"
    tree = ast.parse(src.read_text())
    names = {n.name for n in ast.walk(tree)
             if isinstance(n, (ast.FunctionDef, ast.ClassDef))}
    assert "_cpu_packed_step" not in names and "_cpu_step" not in names
    for node in ast.walk(tree):
        if isinstance(node, ast.ExceptHandler):
            body = ast.dump(ast.Module(body=node.body, type_ignores=[]))
            body = body.replace("'_contain_step_failure'", "")
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


# The device services slice: the system of record, auto-registration and
# command delivery, each module imported on its own with JAX and the
# reference blocked.
SLICE7_MODULES = (
    "services.common", "runtime.resilience", "runtime.refpickle",
    "services.device_management", "services.assets",
    "services.registration", "commands", "commands.model",
    "commands.encoders", "commands.routing", "commands.destinations",
    "commands.processing", "ingest.mqtt", "ingest.coap",
    "analytics.checkpoint", "runtime.checkpoint", "runtime.dispatcher",
    "instance",
)


@pytest.fixture(scope="module")
def slice7_imports():
    import json

    proc = subprocess.run(
        [sys.executable, "-c", _ONE_BY_ONE, *SLICE7_MODULES], cwd=REPO,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip())


@pytest.mark.parametrize("name", SLICE7_MODULES)
def test_slice7_module_imports_without_jax(slice7_imports, name):
    out, bad = slice7_imports
    assert out[name] == "ok"
    assert bad == []


# The device-fault containment and control-plane slice, each module
# imported on its own with JAX and the reference blocked.
SLICE8_MODULES = (
    "runtime.devguard", "runtime.faults", "runtime.flightrec",
    "runtime.overload", "runtime.metering", "runtime.metrics",
    "state.manager", "runtime.dispatcher", "instance",
)


@pytest.fixture(scope="module")
def slice8_imports():
    import json

    proc = subprocess.run(
        [sys.executable, "-c", _ONE_BY_ONE, *SLICE8_MODULES], cwd=REPO,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip())


@pytest.mark.parametrize("name", SLICE8_MODULES)
def test_slice8_module_imports_without_jax(slice8_imports, name):
    out, bad = slice8_imports
    assert out[name] == "ok"
    assert bad == []


def test_devfault_tool_imports_without_jax():
    """The port's containment bench imports nothing of JAX or the
    reference."""
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['sitewhere_tpu'] = None; "
            "sys.path.insert(0, 'tools'); import torch_devfault_bench")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_wire_ab_tool_imports_without_jax():
    """The port's parent/change wire comparison imports nothing of JAX or
    the reference."""
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['sitewhere_tpu'] = None; "
            "sys.path.insert(0, 'tools'); import torch_wire_ab")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_registry_mirror_raises_without_a_card(monkeypatch):
    from sitewhere_tpu_torch.services.device_management import RegistryMirror

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        RegistryMirror(16)


def test_instance_composes_the_device_services_by_default(tmp_path):
    """As the reference does: device management, assets, command delivery
    and auto-registration, wired into the dispatcher; ``registration.*``
    is honoured."""
    from sitewhere_tpu_torch.commands.processing import CommandProcessor
    from sitewhere_tpu_torch.instance import Instance, refuse_unsupported
    from sitewhere_tpu_torch.runtime.config import Config
    from sitewhere_tpu_torch.services.assets import AssetManagement
    from sitewhere_tpu_torch.services.device_management import (
        DeviceManagement)
    from sitewhere_tpu_torch.services.registration import (
        RegistrationManager)

    tree = {"instance": {"data_dir": str(tmp_path)},
            "pipeline": {"width": 8, "registry_capacity": 16},
            "checkpoint": {"interval_s": 0},
            "registration": {"default_device_type": "sensor",
                             "allow_new_devices": False}}
    refuse_unsupported(Config(tree, apply_env=False))
    inst = Instance(Config(tree, apply_env=False), device="cpu")
    try:
        assert isinstance(inst.device_management, DeviceManagement)
        assert inst.device_management.mirror is inst.mirror
        assert isinstance(inst.assets, AssetManagement)
        assert isinstance(inst.commands, CommandProcessor)
        assert isinstance(inst.registration, RegistrationManager)
        assert inst.registration.default_device_type == "sensor"
        assert inst.registration.allow_new_devices is False
        disp = inst.dispatcher
        assert disp.registration is inst.registration
        assert disp.on_command_rows == inst._on_command_rows
        assert disp.totals["commands"] == 0
        children = inst.children
        assert children.index(inst.commands) < children.index(disp)
        assert children.index(inst.registration) < children.index(disp)
    finally:
        inst.terminate()


# The outbound, search, presence and device-streams slice: each module
# imported on its own with JAX and the reference blocked.
SLICE10_MODULES = (
    "outbound", "outbound.filters", "outbound.connectors",
    "outbound.manager", "outbound.search", "services.streams",
    "state.presence", "state.manager", "runtime.resilience",
)


@pytest.fixture(scope="module")
def slice10_imports():
    import json

    proc = subprocess.run(
        [sys.executable, "-c", _ONE_BY_ONE, *SLICE10_MODULES], cwd=REPO,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip())


@pytest.mark.parametrize("name", SLICE10_MODULES)
def test_slice10_module_imports_without_jax(slice10_imports, name):
    out, bad = slice10_imports
    assert out[name] == "ok"
    assert bad == []


#: the tenant engines', users', scripts', labels', schedules' and batch
#: operations' modules (named, so a rename cannot drop one from the walk
#: above unnoticed)
TENANT_MODULES = (
    "sitewhere_tpu_torch.security", "sitewhere_tpu_torch.security.users",
    "sitewhere_tpu_torch.security.jwt",
    "sitewhere_tpu_torch.security.context",
    "sitewhere_tpu_torch.runtime.scripting",
    "sitewhere_tpu_torch.services.tenants",
    "sitewhere_tpu_torch.services.schedules",
    "sitewhere_tpu_torch.services.batch_ops",
    "sitewhere_tpu_torch.labels", "sitewhere_tpu_torch.labels.qr",
    "sitewhere_tpu_torch.labels.png", "sitewhere_tpu_torch.labels.manager",
    "sitewhere_tpu_torch.instance", "sitewhere_tpu_torch.runtime.checkpoint",
)

_TENANTS_PROBE = """
import importlib, json, sys
sys.modules["jax"] = None
sys.modules["sitewhere_tpu"] = None
for name in json.loads(sys.argv[1]):
    importlib.import_module(name)
import sitewhere_tpu_torch
from sitewhere_tpu_torch.instance import InstanceTemplate
from sitewhere_tpu_torch.labels import LabelGeneratorManager, decode_matrix
from sitewhere_tpu_torch.security import TokenManagement, UserManagement
from sitewhere_tpu_torch.services.tenants import MultitenantEngineManager
assert callable(sitewhere_tpu_torch.make_instance)
bad = sorted(m for m, v in sys.modules.items() if v is not None
             and (m in ("jax", "sitewhere_tpu")
                  or m.startswith(("jax.", "sitewhere_tpu."))))
print(json.dumps(bad))
"""


def test_tenant_modules_import_without_jax_or_reference():
    import json

    proc = subprocess.run(
        [sys.executable, "-c", _TENANTS_PROBE, json.dumps(TENANT_MODULES)],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip()) == []
    walked = {m.name for m in pkgutil.walk_packages(
        sitewhere_tpu_torch.__path__, "sitewhere_tpu_torch.")}
    assert set(TENANT_MODULES) <= walked


def test_make_instance_builds_the_port_instance(tmp_path):
    """``make_instance(config, template)``, as the reference's; the port's
    on the CPU only when named, and importing the package builds
    nothing."""
    from sitewhere_tpu_torch.instance import Instance, InstanceTemplate
    from sitewhere_tpu_torch.runtime.config import Config

    cfg = Config({"instance": {"data_dir": str(tmp_path)},
                  "pipeline": {"width": 64, "registry_capacity": 128}},
                 apply_env=False)
    template = InstanceTemplate(tenants=[{"token": "acme", "name": "Acme"}])
    inst = sitewhere_tpu_torch.make_instance(cfg, template, device="cpu")
    try:
        assert isinstance(inst, Instance) and inst.template is template
        assert inst.device == torch.device("cpu")
    finally:
        inst.terminate()


def test_standalone_tenant_engine_raises_without_a_card(monkeypatch):
    from sitewhere_tpu_torch.services.tenants import (
        MultitenantEngineManager,
        TenantManagement,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tm = TenantManagement()
    tm.create_tenant("acme", name="Acme")
    mgr = MultitenantEngineManager(tm)
    with pytest.raises(RuntimeError, match="CUDA"):
        mgr.start()
    cpu = MultitenantEngineManager(tm, device="cpu")
    cpu.start()
    assert cpu.get_engine("acme").mirror.device == torch.device("cpu")
    cpu.stop()


# The sharded slice: the mesh, the per-shard map and the sharded step,
# each imported on its own with JAX and the reference blocked.
MESH_MODULES = (
    "parallel", "parallel.mesh", "parallel.shmap", "pipeline.sharded",
)


@pytest.fixture(scope="module")
def mesh_imports():
    import json

    proc = subprocess.run(
        [sys.executable, "-c", _ONE_BY_ONE, *MESH_MODULES], cwd=REPO,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip())


@pytest.mark.parametrize("name", MESH_MODULES)
def test_mesh_module_imports_without_jax(mesh_imports, name):
    out, bad = mesh_imports
    assert out[name] == "ok"
    assert bad == []


def test_sharded_instance_never_collapses_onto_fewer_cards(monkeypatch,
                                                           tmp_path):
    """``pipeline.n_shards: 8`` with no device named takes the cards, and
    raises when fewer are visible; it never folds the shards onto one."""
    from sitewhere_tpu_torch.instance import Instance
    from sitewhere_tpu_torch.runtime.config import Config

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    cfg = Config({"instance": {"data_dir": str(tmp_path)},
                  "pipeline": {"width": 64, "registry_capacity": 128,
                               "n_shards": 8}}, apply_env=False)
    with pytest.raises(ValueError, match="only 1 available"):
        Instance(cfg)
    assert not (tmp_path / "checkpoint").exists()
