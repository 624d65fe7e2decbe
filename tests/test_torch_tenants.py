"""Tenants, users and tokens, scripts, labels, schedules and batch
operations in the port, against the reference.

The reference's own test modules run against the port with their imports
rewritten (``tests/torch_parity.py port_test_module``), each port
``Instance`` on the CPU:

- ``test_security.py``, ``test_tenants.py``, ``test_batch_and_schedules.py``,
  ``test_labels.py``, ``test_multitenant_instance.py`` and
  ``test_instance.py``, whole;
- the script cases of ``test_tracing_scripts.py`` and ``test_charts.py``,
  the script case of ``test_source_factory.py``, the ``users`` and
  ``tenants`` cases of ``test_checkpoint.py`` and
  ``test_schema.py::test_identity_map_roundtrip`` (``IdentityMap.load``).

The script REST cases of ``test_tracing_scripts.py`` run here too; the
REST cases of ``test_charts.py`` run in ``tests/test_torch_web.py``.
"""

from __future__ import annotations

import os

import pytest
import torch

from torch_parity import port_cases, port_test_module, run_port_case

torch.set_num_threads(1)
TESTS = os.path.dirname(os.path.abspath(__file__))

# module -> {case left out: why}; every other case of the module runs
MODULES = {
    "test_security.py": {},
    "test_tenants.py": {},
    "test_batch_and_schedules.py": {},
    "test_labels.py": {},
    "test_multitenant_instance.py": {},
    "test_instance.py": {},
}
# module -> the cases that run (the rest of the module belongs to other
# slices, held by their own port tests)
ONLY = {
    "test_tracing_scripts.py": (
        "test_script_upload_versioning_and_live_swap",
        "test_script_survives_restart",
        "test_bad_script_rejected",
        "test_scripted_decoder_feeds_source_end_to_end",
        "test_script_audit_survives_restart",
        "test_script_rest_endpoints",
        "test_script_upload_requires_admin_authority",
        "test_script_activate_requires_admin_and_audit_is_logged",
    ),
    "test_charts.py": (
        "test_scripted_router_and_encoder",
        "test_encoder_script_bad_return_type_rejected",
    ),
    "test_source_factory.py": ("test_factory_rejects_non_decoder_script",),
    "test_checkpoint.py": (
        "test_kill_and_restart_restores_model_and_replays",
        "test_replay_columnar_fast_path_matches_scalar_semantics",
    ),
    "test_schema.py": ("test_identity_map_roundtrip",),
}
_NS = {}


def _ns(module):
    if module not in _NS:
        _NS[module] = port_test_module(os.path.join(TESTS, module))
    return _NS[module]


def _cases():
    out = []
    for module, skip in MODULES.items():
        out += [(module, c) for c in port_cases(_ns(module), skip=skip)]
    for module, names in ONLY.items():
        out += [(module, c) for c in names]
    return out


CASES = _cases()


def test_the_port_runs_the_reference_cases_of_this_slice():
    by_module = {}
    for module, _ in CASES:
        by_module[module] = by_module.get(module, 0) + 1
    assert by_module == {
        "test_security.py": 21, "test_tenants.py": 14,
        "test_batch_and_schedules.py": 16, "test_labels.py": 42,
        "test_multitenant_instance.py": 7, "test_instance.py": 14,
        "test_tracing_scripts.py": 8, "test_charts.py": 2,
        "test_source_factory.py": 1, "test_checkpoint.py": 2,
        "test_schema.py": 1}
    # every script case of the two modules runs
    import re

    for module, names in ONLY.items():
        if module not in ("test_tracing_scripts.py", "test_charts.py"):
            continue
        src = open(os.path.join(TESTS, module)).read()
        scripted = {name for name, body in re.findall(
            r"^def (test_\w+)\(.*?\n((?:    .*\n|\n)+)", src, re.M)
            if "scripts" in body}
        assert scripted == set(names), module


@pytest.mark.parametrize("module,case", CASES,
                         ids=[f"{m[5:-3]}::{c}" for m, c in CASES])
def test_reference_case_on_the_port(module, case, tmp_path, monkeypatch):
    run_port_case(_ns(module), case, tmp_path,
                  fixtures={"monkeypatch": monkeypatch})
