"""Reference fault, fabric-domain and soak cases on the port.

The reference's own ``tests/test_chaos.py`` (every injection point's
contract: the fault registry, receivers restarting under their
supervisors, breakers shedding, the event store's seal retries, the
dispatcher's fail-closed commit gate and its replays, a corrupt journal
record, command delivery retries, the overload ladder under 4x load,
crash points and a kill mid-ring), ``tests/test_remote_domains.py`` (the
port's ``rpc/domains.py`` ``remote_domains`` and
``attach_remote_domains`` behind a gateway ``Instance``) and the two
cases of ``tests/test_soak.py`` that the tier-1 run takes, run against
the port with their imports rewritten (``tests/torch_parity.py
port_test_module``), each port ``Instance`` on the CPU.  The case that
drives a reference tool drives the port's.  The cases left out are named
with the reason.
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
    "test_chaos.py": {
        "TestCrashRecBench": "its port's bench runs in "
                             "tests/test_torch_tooling.py",
        "TestFleetChaosBench": "its port's bench runs in "
                               "tests/test_torch_tooling.py",
        "TestDevFaultBench": "its port's bench runs in "
                             "tests/test_torch_devguard.py",
    },
    "test_remote_domains.py": {},
    "test_soak.py": {
        "test_everything_at_once_stays_consistent":
            "marked slow in the reference; the tier-1 run deselects it",
        "test_multihost_peer_outage_loses_nothing":
            "marked slow in the reference; the tier-1 run deselects it",
        "test_wire_lane_soak_bounded_rss":
            "marked slow in the reference; the tier-1 run deselects it",
    },
}
# module -> source edits: the tenant fairness case drives the port's bench
# on the CPU; a rule manager built on the default device (the card) is
# built on the CPU; a case reading a JAX sharding object reads the port's
# counterpart (the sharded epoch's shard count: the port's shards may
# share one device)
EDITS = {
    "test_chaos.py": (
        ('os.path.join(root, "tools", "tenant_fairness_bench.py"),\n'
         '             "--smoke", "--json"]',
         'os.path.join(root, "tools", "torch_tenant_fairness_bench.py"),\n'
         '             "--smoke", "--json", "--device", "cpu"]'),),
    "test_soak.py": (
        ("rm = RuleManager(IdentityMap(64))",
         "rm = RuleManager(IdentityMap(64), device='cpu')"),
        ("assert len(inst.device_state.current\n"
         "                   .last_event_ts_s.sharding.device_set) == 8",
         "assert inst.device_state.current_packed.si.n_shards == 8"),),
}
_NS = {}


def _ns(module):
    if module not in _NS:
        _NS[module] = port_test_module(os.path.join(TESTS, module),
                                       replace=EDITS.get(module, ()))
    return _NS[module]


CASES = [(module, c) for module, skip in MODULES.items()
         for c in port_cases(_ns(module), skip=skip)]


def test_the_port_runs_the_reference_cases():
    by_module = {}
    for module, _ in CASES:
        by_module[module] = by_module.get(module, 0) + 1
    assert by_module == {"test_chaos.py": 33, "test_remote_domains.py": 7,
                         "test_soak.py": 2}
    assert ("test_chaos.py", "TestTenantFairnessBench.test_smoke_contract_"
            "holds") in CASES


@pytest.mark.parametrize("module,case", CASES,
                         ids=[f"{m[5:-3]}::{c}" for m, c in CASES])
def test_reference_case_on_the_port(module, case, tmp_path, monkeypatch):
    run_port_case(_ns(module), case, tmp_path,
                  fixtures={"monkeypatch": monkeypatch})
