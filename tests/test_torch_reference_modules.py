"""Reference test modules of earlier slices that had no port run yet.

The reference's own ``test_journal.py``, ``test_resilience.py``,
``test_event_store.py``, ``test_runtime.py``, ``test_mqtt.py``,
``test_segment_store.py`` and the rest of ``test_checkpoint.py`` (its
8-shard mesh case included) run against the port with their imports
rewritten (``tests/torch_parity.py port_test_module``), each port
``Instance`` on the CPU.  The cases left out are named with the reason.
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
    "test_journal.py": {},
    "test_resilience.py": {},
    "test_event_store.py": {},
    "test_runtime.py": {},
    "test_mqtt.py": {},
    "test_checkpoint.py": {
        # run by tests/test_torch_tenants.py (users and tenants) and
        # tests/test_torch_sources.py (the dedup window)
        "test_kill_and_restart_restores_model_and_replays": "elsewhere",
        "test_replay_columnar_fast_path_matches_scalar_semantics":
            "elsewhere",
        "test_dedup_window_survives_restart": "elsewhere",
    },
    "test_segment_store.py": {},
}
# module -> source edits: a case reading a JAX sharding object reads the
# port's counterpart (the sharded epoch's shard count; the port's shards
# may share one device), a case driving a reference tool drives the
# port's, and a query or runner built on the default device (the card)
# is built on the CPU
EDITS = {
    "test_checkpoint.py": (
        ("assert len(st.last_event_ts_s.sharding.device_set) == 8",
         "assert b.device_state.current_packed.si.n_shards == 8"),
        ("r = QueryRunner(capacity=8, metrics=MetricsRegistry(),",
         "r = QueryRunner(capacity=8, metrics=MetricsRegistry(), "
         "device='cpu',"),),
    # the mini broker's close shuts its client connections first: a case
    # that fails before its clients disconnect leaves its handlers
    # reading them, and the close's join of the handlers would wait
    # forever (the clients stay connected, pinging)
    "test_mqtt.py": (
        ("        self.lock = threading.Lock()\n",
         "        self.lock = threading.Lock()\n        self.conns = []\n"),
        ("                sock = self.request\n",
         "                sock = self.request\n"
         "                broker.conns.append(sock)\n"),
        ("        self.server.shutdown()\n        self.server.server_close()",
         "        self.server.shutdown()\n"
         "        for conn in self.conns:\n"
         "            try:\n"
         "                conn.shutdown(socket.SHUT_RDWR)\n"
         "            except OSError:\n"
         "                pass\n"
         "        self.server.server_close()"),),
    # the store bench case drives the port's bench
    "test_segment_store.py": (
        ('"tools", "store_bench.py")', '"tools", "torch_store_bench.py")'),
        ("live_op = compile_query(q, capacity=16)",
         "live_op = compile_query(q, capacity=16, device='cpu')"),
        ("retro_op = compile_query(q, capacity=16)",
         "retro_op = compile_query(q, capacity=16, device='cpu')"),),
}
_NS = {}


def _ns(module):
    if module not in _NS:
        _NS[module] = port_test_module(os.path.join(TESTS, module),
                                       replace=EDITS.get(module, ()))
    return _NS[module]


CASES = [(module, c) for module, skip in MODULES.items()
         for c in port_cases(_ns(module), skip=skip)]


def test_the_port_runs_the_reference_modules():
    by_module = {}
    for module, _ in CASES:
        by_module[module] = by_module.get(module, 0) + 1
    assert by_module == {
        "test_journal.py": 16, "test_resilience.py": 31,
        "test_event_store.py": 31, "test_runtime.py": 6, "test_mqtt.py": 3,
        "test_checkpoint.py": 14, "test_segment_store.py": 31}


@pytest.mark.parametrize("module,case", CASES,
                         ids=[f"{m[5:-3]}::{c}" for m, c in CASES])
def test_reference_module_case_on_the_port(module, case, tmp_path,
                                           monkeypatch, caplog):
    run_port_case(_ns(module), case, tmp_path,
                  fixtures={"monkeypatch": monkeypatch, "caplog": caplog})
