"""The port's device system of record against the JAX package's, on the CPU.

- One scripted sequence of ``DeviceManagement`` and ``AssetManagement``
  calls with explicit tokens goes through both packages' services, each
  over its own ``IdentityMap`` and ``RegistryMirror``: every call returns
  equal entities (field by field, the wall-clock stamps aside) or raises
  the same exception class, and afterwards every entity, every mirror
  array and every identity handle is equal.  The sequence covers device
  types, commands and statuses; devices and parents; assignment create,
  missing, release, update back to Active (two Active at once: the first
  in insertion order is the device's) and delete; the area tree and
  customers; zones, with bad bounds; nested groups; alarms; assets; and
  a second tenant over the same identity and mirror.
- The reference's own tests of ``tests/test_device_management.py`` and
  ``tests/test_assets.py`` run against the port: the same source with
  its ``sitewhere_tpu`` imports pointing at the port, each ``Instance``
  and tenant engine on the CPU.
"""

import dataclasses
import functools
import inspect
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import sitewhere_tpu.ids as ref_ids
import sitewhere_tpu.services.assets as ref_assets
import sitewhere_tpu.services.common as ref_common
import sitewhere_tpu.services.device_management as ref_dm
import sitewhere_tpu_torch.ids as port_ids
import sitewhere_tpu_torch.services.assets as port_assets
import sitewhere_tpu_torch.services.common as port_common
import sitewhere_tpu_torch.services.device_management as port_dm
from sitewhere_tpu_torch.runtime import checkpoint as port_ckpt

torch.set_num_threads(1)

TESTS = Path(__file__).resolve().parent
CAP, ZONES, VERTS = 256, 16, 8

# wall-clock stamps: compared as "set or not", never by value
STAMPS = ("created_s", "updated_s")
DATES = ("active_date_s", "released_date_s", "triggered_date_s",
         "acknowledged_date_s", "resolved_date_s")


def normalize(obj):
    """A package-neutral view: dataclasses as their class name and fields
    (stamps dropped, dates reduced to set / unset)."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = {"__class__": type(obj).__name__}
        for f in dataclasses.fields(obj):
            if f.name in STAMPS:
                continue
            v = getattr(obj, f.name)
            out[f.name] = (v is not None) if f.name in DATES else normalize(v)
        return out
    if hasattr(obj, "results") and hasattr(obj, "total"):
        return {"results": normalize(obj.results), "total": obj.total}
    if isinstance(obj, dict):
        return {k: normalize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [normalize(v) for v in obj]
    if isinstance(obj, (np.integer, np.bool_)):
        return obj.item()
    return obj


class Services:
    """One package's services over one identity map and mirror."""

    def __init__(self, pkg):
        self.pkg = pkg
        if pkg == "jax":
            ids, dm, assets, common = ref_ids, ref_dm, ref_assets, ref_common
            mirror = dm.RegistryMirror(CAP, max_zones=ZONES, max_verts=VERTS)
        else:
            ids, dm, assets = port_ids, port_dm, port_assets
            common = port_common
            mirror = dm.RegistryMirror(CAP, max_zones=ZONES, max_verts=VERTS,
                                       device="cpu")
        self.mod = dm
        self.common = common
        self.identity = ids.IdentityMap(capacity=CAP)
        self.mirror = mirror
        self.dm = dm.DeviceManagement("default", self.identity, mirror)
        self.dm2 = dm.DeviceManagement("t2", self.identity, mirror)
        self.am = assets.AssetManagement("default", self.identity)

    def arg(self, value):
        """Build package objects named in a step: ``("criteria", page,
        size)`` and ``("element", device, group, roles)``."""
        if isinstance(value, tuple) and value and value[0] == "criteria":
            return self.common.SearchCriteria(page=value[1],
                                              page_size=value[2])
        if isinstance(value, tuple) and value and value[0] == "element":
            return self.mod.DeviceGroupElement(
                device=value[1], nested_group=value[2],
                roles=list(value[3]))
        if isinstance(value, list):
            return [self.arg(v) for v in value]
        return value

    def call(self, svc, method, *args, **kwargs):
        fn = getattr(getattr(self, svc), method)
        try:
            result = fn(*[self.arg(a) for a in args],
                        **{k: self.arg(v) for k, v in kwargs.items()})
        except Exception as e:  # noqa: BLE001 - the class is the outcome
            return ("raised", type(e).__name__)
        return ("ok", normalize(result))


TRI = [(0.0, 0.0), (0.0, 5.0), (5.0, 5.0)]
SQUARE = [(0.0, 0.0), (0.0, 10.0), (10.0, 10.0), (10.0, 0.0)]

STEPS = [
    # device types, commands, statuses
    ("dm", "create_device_type", ("thermo",), {"name": "Thermostat"}),
    ("dm", "create_device_type", ("gw",),
     {"name": "Gateway", "container_policy": "Composite"}),
    ("dm", "create_device_type", ("thermo",), {"name": "again"}),
    ("dm", "create_device_type", ("noname",), {"name": ""}),
    ("dm", "update_device_type", ("thermo",), {"description": "updated"}),
    ("dm", "update_device_type", ("thermo",), {"bogus": 1}),
    ("dm", "update_device_type", ("nope",), {"description": "x"}),
    ("dm", "create_device_command", ("thermo", "set-point"),
     {"name": "setPoint", "namespace": "http://acme/thermo",
      "parameters": [("target", "double", True), ("mode", "string", False)]}),
    ("dm", "create_device_command", ("thermo", "ping"), {"name": "ping"}),
    ("dm", "create_device_command", ("thermo", "ping"), {"name": "again"}),
    ("dm", "create_device_command", ("nope", "x"), {"name": "x"}),
    ("dm", "create_device_command", ("thermo", "nameless"), {}),
    ("dm", "create_device_status", ("thermo", "ok"),
     {"code": "ok", "name": "OK"}),
    ("dm", "create_device_status", ("thermo", "ok"), {"code": "ok"}),
    ("dm", "list_device_commands", ("thermo",), {}),
    ("dm", "list_device_statuses", ("thermo",), {}),
    ("dm", "get_device_command", ("thermo", "set-point"), {}),
    ("dm", "delete_device_command", ("thermo", "ping"), {}),
    ("dm", "delete_device_command", ("thermo", "ping"), {}),
    ("dm", "list_device_types", (), {}),
    # devices and parents
    ("dm", "create_device", ("gw-1",), {"device_type": "gw"}),
    ("dm", "create_device", ("d-1",),
     {"device_type": "thermo", "parent_device": "gw-1",
      "metadata": {"coap_host": "127.0.0.1"}}),
    ("dm", "create_device", ("d-2",), {"device_type": "thermo"}),
    ("dm", "create_device", ("d-3",), {"device_type": "thermo"}),
    ("dm", "create_device", ("d-bad",), {"device_type": "missing"}),
    ("dm", "create_device", ("d-orphan",),
     {"device_type": "thermo", "parent_device": "nope"}),
    ("dm", "create_device", ("d-1",), {"device_type": "thermo"}),
    ("dm", "update_device", ("d-2",), {"comments": "c", "status": "ok"}),
    ("dm", "update_device", ("d-2",), {"device_type": "missing"}),
    ("dm", "update_device", ("d-2",), {"comments": "x", "not_a_field": 1}),
    ("dm", "get_device", ("nope",), {}),
    # the area tree and customers
    ("dm", "create_area_type", ("site",), {"name": "Site"}),
    ("dm", "create_area_type", ("site",), {"name": "Site"}),
    ("dm", "create_area", ("root",),
     {"area_type": "site", "name": "Root", "bounds": SQUARE}),
    ("dm", "create_area", ("child",),
     {"area_type": "site", "name": "Child", "parent_area": "root"}),
    ("dm", "create_area", ("leaf",),
     {"area_type": "site", "name": "Leaf", "parent_area": "child"}),
    ("dm", "create_area", ("x",), {"area_type": "nope"}),
    ("dm", "create_area", ("y",), {"area_type": "site", "parent_area": "no"}),
    ("dm", "area_tree", (), {}),
    ("dm", "list_areas", (), {"parent": "root"}),
    ("dm", "list_areas", (), {"root_only": True}),
    ("dm", "update_area", ("child",), {"description": "d"}),
    ("dm", "update_area", ("child",), {"bogus": "d"}),
    ("dm", "delete_area", ("root",), {}),
    ("dm", "create_customer_type", ("org",), {"name": "Org"}),
    ("dm", "create_customer", ("parent",),
     {"customer_type": "org", "name": "P"}),
    ("dm", "create_customer", ("kid",),
     {"customer_type": "org", "name": "K", "parent_customer": "parent"}),
    ("dm", "create_customer", ("bad",), {"customer_type": "nope"}),
    ("dm", "create_customer", ("bad",),
     {"customer_type": "org", "parent_customer": "nope"}),
    ("dm", "delete_customer", ("parent",), {}),
    ("dm", "list_customers", (), {"parent": "parent"}),
    ("dm", "list_customer_types", (), {}),
    # assignments: create, missing, release, update back to Active, delete
    ("dm", "create_device_assignment", ("a-1",),
     {"device": "d-1", "customer": "kid", "area": "child",
      "asset": "asset-9"}),
    ("dm", "create_device_assignment", ("a-again",), {"device": "d-1"}),
    ("dm", "create_device_assignment", ("a-x",), {"device": "nope"}),
    ("dm", "create_device_assignment", ("a-y",),
     {"device": "d-2", "customer": "nope"}),
    ("dm", "create_device_assignment", ("a-y",),
     {"device": "d-2", "area": "nope"}),
    ("dm", "create_device_assignment", ("a-z",),
     {"device": "d-2", "status": "Bogus"}),
    ("dm", "create_device_assignment", ("a-1",), {"device": "d-2"}),
    ("dm", "delete_device", ("d-1",), {}),
    ("dm", "mark_missing", ("a-1",), {}),
    ("dm", "get_active_assignment", ("d-1",), {}),
    ("dm", "create_device_assignment", ("a-again",), {"device": "d-1"}),
    ("dm", "release_device_assignment", ("a-1",), {}),
    ("dm", "get_active_assignment", ("d-1",), {}),
    ("dm", "create_device_assignment", ("a-2",),
     {"device": "d-1", "area": "root"}),
    ("dm", "release_device_assignment", ("a-2",), {}),
    ("dm", "create_device_assignment", ("a-3",), {"device": "d-2"}),
    ("dm", "update_device_assignment", ("a-1",), {"status": "Active"}),
    ("dm", "get_active_assignment", ("d-1",), {}),
    ("dm", "update_device_assignment", ("a-2",), {"status": "Active"}),
    ("dm", "get_active_assignment", ("d-1",), {}),
    ("dm", "release_device_assignment", ("a-1",), {}),
    ("dm", "get_active_assignment", ("d-1",), {}),
    ("dm", "update_device_assignment", ("a-2",), {"device": "d-2"}),
    ("dm", "update_device_assignment", ("a-2",), {"customer": "nope"}),
    ("dm", "update_device_assignment", ("a-2",), {"status": "Bogus"}),
    ("dm", "update_device_assignment", ("a-2",), {"customer": "parent"}),
    ("dm", "update_device_assignment", ("a-1",), {"status": "Missing"}),
    ("dm", "get_active_assignment", ("d-1",), {}),
    ("dm", "delete_device_assignment", ("a-1",), {}),
    ("dm", "get_active_assignment", ("d-1",), {}),
    ("dm", "create_device_assignment", ("a-1",), {"device": "d-3"}),
    ("dm", "delete_device_assignment", ("a-1",), {}),
    ("dm", "delete_device_assignment", ("a-1",), {}),
    ("dm", "list_device_assignments", (), {"device": "d-1"}),
    ("dm", "list_device_assignments", (), {"status": "Released"}),
    ("dm", "list_device_assignments", (), {"area": "root"}),
    ("dm", "list_devices", (), {"excluding_assigned": True}),
    ("dm", "list_devices", (("criteria", 2, 2),), {}),
    ("dm", "list_devices", (), {"device_type": "gw"}),
    ("dm", "update_device", ("d-1",), {"device_type": "gw"}),
    ("dm", "delete_device", ("d-3",), {}),
    ("dm", "create_device", ("d-3",), {"device_type": "thermo"}),
    ("dm", "create_device", ("d-4",), {"device_type": "thermo"}),
    # zones, bad bounds among them
    ("dm", "create_zone", ("z-1",),
     {"area": "root", "name": "fence", "bounds": SQUARE,
      "condition": "outside", "alert_type": "fence"}),
    ("dm", "create_zone", ("z-bad",), {"area": "root", "bounds": TRI[:2]}),
    ("dm", "create_zone", ("z-big",),
     {"area": "root", "bounds": [(0.0, float(i)) for i in range(VERTS + 1)]}),
    ("dm", "create_zone", ("z-2",), {"area": "nope", "bounds": TRI}),
    ("dm", "create_zone", ("z-1",), {"area": "root", "bounds": TRI}),
    ("dm", "create_zone", ("z-3",),
     {"area": "child", "bounds": TRI, "alert_level": 3}),
    ("dm", "update_zone", ("z-1",), {"bounds": [(1.0, 1.0), (1.0, 5.0),
                                                (5.0, 5.0)]}),
    ("dm", "update_zone", ("z-1",), {"bounds": TRI[:1]}),
    ("dm", "update_zone", ("z-1",), {"area": "nope"}),
    ("dm", "update_zone", ("z-1",), {"bogus": 1}),
    ("dm", "delete_zone", ("z-3",), {}),
    ("dm", "delete_zone", ("z-3",), {}),
    ("dm", "create_zone", ("z-4",),
     {"area": "leaf", "bounds": SQUARE, "alert_type": "leaf-fence"}),
    ("dm", "list_zones", (), {"area": "root"}),
    ("dm", "delete_area", ("leaf",), {}),
    ("dm", "list_zones", (), {}),
    # nested groups
    ("dm", "create_device_group", ("inner",),
     {"name": "Inner", "roles": ["fleet"]}),
    ("dm", "create_device_group", ("inner",), {"name": "again"}),
    ("dm", "add_device_group_elements",
     ("inner", [("element", "d-1", None, ["a"]),
                ("element", "gw-1", None, [])]), {}),
    ("dm", "create_device_group", ("outer",), {"name": "Outer"}),
    ("dm", "add_device_group_elements",
     ("outer", [("element", None, "inner", ["nested"]),
                ("element", "d-2", None, [])]), {}),
    ("dm", "add_device_group_elements",
     ("outer", [("element", None, "outer", [])]), {}),
    ("dm", "add_device_group_elements",
     ("outer", [("element", None, None, [])]), {}),
    ("dm", "add_device_group_elements",
     ("outer", [("element", "nope", None, [])]), {}),
    ("dm", "add_device_group_elements",
     ("inner", [("element", None, "outer", [])]), {}),
    ("dm", "group_devices", ("outer",), {}),
    ("dm", "list_devices", (), {"group": "outer"}),
    ("dm", "list_device_groups", (), {"role": "fleet"}),
    ("dm", "remove_device_group_elements",
     ("outer", [("element", "d-2", None, [])]), {}),
    ("dm", "create_device_group", ("gone",), {"name": "Gone"}),
    ("dm", "delete_device_group", ("gone",), {}),
    ("dm", "delete_device_group", ("gone",), {}),
    # alarms
    ("dm", "create_device_alarm", ("al-1",),
     {"device": "d-1", "message": "overheating"}),
    ("dm", "create_device_alarm", ("al-2",), {"device": "nope"}),
    ("dm", "create_device_alarm", ("al-3",), {"device": "d-2"}),
    ("dm", "acknowledge_alarm", ("al-1",), {}),
    ("dm", "resolve_alarm", ("al-1",), {}),
    ("dm", "list_device_alarms", (), {"device": "d-1", "state": "Resolved"}),
    ("dm", "delete_device_alarm", ("al-3",), {}),
    ("dm", "get_device_alarm", ("al-3",), {}),
    # assets, bound through an assignment
    ("am", "create_asset_type", ("person",),
     {"name": "Person", "category": "person"}),
    ("am", "create_asset_type", ("person",), {"name": "Again"}),
    ("am", "create_asset_type", ("x",), {"name": "X", "category": "ship"}),
    ("am", "create_asset_type", ("y",), {}),
    ("am", "create_asset_type", ("hw",), {"name": "HW",
                                          "category": "hardware"}),
    ("am", "update_asset_type", ("hw",), {"description": "handheld"}),
    ("am", "update_asset_type", ("person",), {"category": "ship"}),
    ("am", "update_asset_type", ("person",), {"bogus": 1}),
    ("am", "create_asset", ("ada",), {"name": "Ada", "asset_type": "person"}),
    ("am", "create_asset", ("eve",), {"name": "Eve", "asset_type": "nope"}),
    ("am", "create_asset", ("w",), {"name": "W", "asset_type": "hw"}),
    ("am", "update_asset", ("ada",), {"name": "X", "asset_type": "nope"}),
    ("am", "update_asset", ("ada",), {"name": "A. Lovelace"}),
    ("am", "delete_asset_type", ("person",), {}),
    ("am", "asset_dense_id", ("ada",), {}),
    ("dm", "create_device_assignment", ("a-5",),
     {"device": "d-4", "asset": "ada"}),
    ("am", "delete_asset", ("w",), {}),
    ("am", "get_asset", ("w",), {}),
    ("am", "create_asset", ("w",), {"name": "W2", "asset_type": "hw"}),
    ("am", "list_assets", (), {"asset_type": "hw"}),
    ("am", "list_asset_types", (("criteria", 1, 1),), {}),
    # a second tenant over the same identity and mirror
    ("dm2", "create_device_type", ("thermo",), {"name": "B"}),
    ("dm2", "create_device", ("d-1",), {"device_type": "thermo"}),
    ("dm2", "create_device", ("t2-1",), {"device_type": "thermo"}),
    ("dm2", "create_area_type", ("site",), {"name": "Site"}),
    ("dm2", "create_area", ("root",), {"area_type": "site", "name": "R"}),
    ("dm2", "create_zone", ("z-1",), {"area": "root", "bounds": TRI}),
    ("dm2", "create_device_assignment", ("a-1",), {"device": "t2-1"}),
]


@pytest.fixture(scope="module")
def both():
    out = {}
    for pkg in ("jax", "torch"):
        svc = Services(pkg)
        out[pkg] = (svc, [svc.call(*step[:2], *step[2], **step[3])
                          for step in STEPS])
    return out


@pytest.mark.parametrize("i", range(len(STEPS)),
                         ids=[f"{i:03d}-{s[0]}.{s[1]}"
                              for i, s in enumerate(STEPS)])
def test_each_call_matches_the_reference(both, i):
    assert both["torch"][1][i] == both["jax"][1][i]


def test_the_sequence_exercises_errors_and_successes(both):
    outcomes = [o for o, _ in both["jax"][1]]
    raised = {r for o, r in both["jax"][1] if o == "raised"}
    assert outcomes.count("ok") > 100
    assert raised == {"DuplicateToken", "ValidationError", "InvalidReference",
                      "EntityNotFound"}


STORES = ("device_types", "devices", "assignments", "area_types", "areas",
          "customer_types", "customers", "zones", "device_groups", "alarms")


@pytest.mark.parametrize("store", STORES)
def test_entities_equal_the_reference(both, store):
    ref, got = both["jax"][0], both["torch"][0]
    for svc in ("dm", "dm2"):
        a = getattr(getattr(ref, svc), store)
        b = getattr(getattr(got, svc), store)
        assert list(a) == list(b)     # insertion order too
        assert normalize(a) == normalize(b)


def test_assets_equal_the_reference(both):
    ref, got = both["jax"][0].am, both["torch"][0].am
    for attr in ("_types", "_assets"):
        assert list(getattr(ref, attr)) == list(getattr(got, attr))
        assert normalize(getattr(ref, attr)) == normalize(getattr(got, attr))


@pytest.mark.parametrize("array", port_ckpt._MIRROR_ARRAYS + ("z_hi", "epoch"))
def test_mirror_arrays_equal_the_reference(both, array):
    a = np.asarray(getattr(both["jax"][0].mirror, array))
    b = np.asarray(getattr(both["torch"][0].mirror, array))
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def test_identity_handles_equal_the_reference(both, tmp_path):
    docs = []
    for pkg in ("jax", "torch"):
        path = tmp_path / f"{pkg}.json"
        both[pkg][0].identity.save(str(path))
        docs.append(json.loads(path.read_text()))
    assert docs[0] == docs[1]
    spaces = docs[1]
    assert len(spaces["device"]["id_to_token"]) == 6
    assert sorted(spaces["zone"]["id_to_token"]) == ["default:z-1", "t2:z-1"]


def test_active_assignment_index_equals_the_scan(both):
    """The port's per-device index returns what the reference's scan over
    every assignment returns, for every device, and survives a rebuild."""
    got = both["torch"][0].dm
    for dm in (got,):
        want = {}
        for token in dm.devices:
            scan = next((a for a in dm.assignments.values()
                         if a.device == token
                         and a.status in ("Active", "Missing")), None)
            want[token] = scan
            assert dm._active_assignment(token) is scan
        dm.reindex()
        for token, scan in want.items():
            assert dm._active_assignment(token) is scan


# -- the reference's own tests, run against the port -------------------------

def port_test_module(name):
    """``tests/<name>.py`` with every ``sitewhere_tpu`` import pointing at
    the port, and each ``RegistryMirror`` on the CPU."""
    src = (TESTS / f"{name}.py").read_text()
    src = re.sub(r"\bsitewhere_tpu\.", "sitewhere_tpu_torch.", src)
    src = src.replace("from sitewhere_tpu_torch.instance import Instance",
                      "from torch_parity import CpuInstance as Instance")
    src = src.replace("MultitenantEngineManager(tm)",
                      "MultitenantEngineManager(tm, device='cpu')")
    ns = {"__name__": f"port_{name}", "__file__": str(TESTS / f"{name}.py")}
    exec(compile(src, f"<port {name}>", "exec"), ns)
    if "RegistryMirror" in ns:
        ns["RegistryMirror"] = functools.partial(port_dm.RegistryMirror,
                                                 device="cpu")
    return ns


def reference_cases(name, skip=()):
    """``(test id, callable)`` of every test function and test method in
    the reference's module ``tests/<name>.py``, apart from ``skip``."""
    src = (TESTS / f"{name}.py").read_text()
    tests = re.findall(r"^def (test_\w+)\(", src, re.M)
    for cls, body in re.findall(r"^class (Test\w+):\n((?:    .*\n|\n)+)",
                                src, re.M):
        tests += [f"{cls}.{m}" for m in
                  re.findall(r"^    def (test_\w+)\(", body, re.M)]
    return [t for t in tests if t.split(".")[-1] not in skip]


def run_port_case(name, case, tmp_path):
    ns = port_test_module(name)
    if "." in case:
        cls, method = case.split(".")
        fn = getattr(ns[cls](), method)
    else:
        fn = ns[case]
    args = {}
    for param in inspect.signature(fn).parameters:
        if param == "tmp_path":
            args[param] = tmp_path
        else:
            args[param] = ns[param].__wrapped__()
    fn(**args)


DM_CASES = reference_cases("test_device_management")
ASSET_CASES = reference_cases("test_assets")


@pytest.mark.parametrize("case", DM_CASES)
def test_reference_device_management_case_on_the_port(case, tmp_path):
    run_port_case("test_device_management", case, tmp_path)


@pytest.mark.parametrize("case", ASSET_CASES)
def test_reference_assets_case_on_the_port(case, tmp_path):
    run_port_case("test_assets", case, tmp_path)


def test_reference_cases_were_found_and_run_the_port():
    assert len(DM_CASES) == 17 and len(ASSET_CASES) == 11
    ns = port_test_module("test_assets")
    assert ns["DeviceManagement"] is port_dm.DeviceManagement
    assert ns["AssetManagement"] is port_assets.AssetManagement
    assert ns["RegistryMirror"].keywords == {"device": "cpu"}
