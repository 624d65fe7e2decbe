"""Where a run was placed on the host: the cpulist, the cards found under
a sysfs tree, and the record in the result's line."""

import os

import pytest

from benchmark import host
from benchmark.tests.tiny import make_root, run_cpu


@pytest.mark.parametrize("cpus, text", [
    ({0, 1, 2, 3}, "0-3"),
    ({0, 1, 2, 3, 8, 9, 10, 11}, "0-3,8-11"),
    ({5}, "5"),
    ({0, 2, 4, 5}, "0,2,4-5"),
    ({0, 1, 2, 3, 8, 10, 11}, "0-3,8,10-11"),
    (set(), ""),
])
def test_format_cpulist_gives_ranges(cpus, text):
    assert host.format_cpulist(cpus) == text


def _device(root, name, vendor, cls, cpulist=None, node="0"):
    d = root / name
    d.mkdir(parents=True)
    (d / "vendor").write_text(vendor + "\n")
    (d / "class").write_text(cls + "\n")
    (d / "numa_node").write_text(node + "\n")
    if cpulist is not None:
        (d / "local_cpulist").write_text(cpulist + "\n")


def test_cards_are_nvidia_gpus_in_bus_order(tmp_path):
    _device(tmp_path, "0000:c1:00.0", "0x10de", "0x030200", "4-7", "1")
    _device(tmp_path, "0000:19:00.0", "0x10de", "0x030200", "0-3", "0")
    _device(tmp_path, "0000:18:00.0", "0x10de", "0x068000", "0-3")  # bridge
    _device(tmp_path, "0000:00:02.0", "0x8086", "0x030000", "0-3")
    _device(tmp_path, "0000:1a:00.0", "0x10de", "0x030000")   # no cpulist
    found = host.cards(tmp_path)
    assert [c["bdf"] for c in found] == ["0000:19:00.0", "0000:1a:00.0",
                                         "0000:c1:00.0"]
    assert [c["numa_node"] for c in found] == ["0", "0", "1"]
    assert [c["local_cpulist"] for c in found] == ["0-3", None, "4-7"]


def test_a_missing_sysfs_tree_finds_no_cards(tmp_path):
    rec = host.placement(tmp_path / "absent")
    assert rec["cards"] == []
    assert rec["cpus"] == host.format_cpulist(os.sched_getaffinity(0))


def test_the_result_records_the_cpu_set(tmp_path, monkeypatch, capsys):
    root = make_root(tmp_path, base_config="geo-10k-sync",
                     base_traffic="tracking")
    before = os.sched_getaffinity(0)
    res, _ = run_cpu(monkeypatch, capsys, root, seconds=0.5)
    assert res["correct"] is True
    assert list(res)[-1] == "checks"
    assert res["host"]["cpus"] == host.format_cpulist(before)
    assert isinstance(res["host"]["cards"], list)
    assert os.sched_getaffinity(0) == before
