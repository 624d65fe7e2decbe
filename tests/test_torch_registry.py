"""The port's registry mirror, rule manager and packed helpers against the
JAX reference, on the CPU.

The same row writes publish the same Registry / ZoneTable / RuleTable
epochs (values and dtypes), rebuilt only when dirty and never aliased by
a later write; the publishers take a ``device`` and raise without a card
unless the CPU is named.  The packed additions of this slice (the ring
depth switch, the host copy) are checked here too.
"""

import numpy as np
import pytest
import torch

from sitewhere_tpu import schema as jschema
from sitewhere_tpu.ids import IdentityMap as JIdentityMap
from sitewhere_tpu.pipeline.rules import RuleManager as JRuleManager
from sitewhere_tpu.services.device_management import (
    RegistryMirror as JRegistryMirror,
)
from sitewhere_tpu_torch import schema as tschema
from sitewhere_tpu_torch.ids import IdentityMap
from sitewhere_tpu_torch.pipeline import packed as tpacked
from sitewhere_tpu_torch.pipeline.rules import RuleManager
from sitewhere_tpu_torch.services.common import (
    DuplicateToken,
    EntityNotFound,
    ValidationError,
)
from sitewhere_tpu_torch.services.device_management import RegistryMirror
from torch_parity import (
    CPU,
    np_of,
    wire_world,
)

torch.set_num_threads(1)


def _assert_tables_equal(ref, got):
    for f in ref.__dataclass_fields__:
        a, b = np.asarray(getattr(ref, f)), np_of(getattr(got, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def _write_rows(mirror, enums):
    rng = np.random.default_rng(5)
    for d in range(0, 48, 3):
        mirror.set_device_row(
            d, active=bool(d % 2), tenant_id=d % 4,
            device_type_id=d % 5, assignment_id=d + 100,
            assignment_status=int(enums.AssignmentStatus.ACTIVE),
            area_id=d % 6, customer_id=-1, asset_id=d % 7)
    mirror.clear_device_row(9)
    for z in (0, 1, 4):
        mirror.set_zone_row(
            z, active=True, tenant_id=z % 2, area_id=-1,
            verts_lonlat=rng.uniform(-5, 5, (3 + z, 2)).astype(np.float32),
            condition=z % 2, alert_code=50 + z, alert_level=z % 4)
    mirror.clear_zone_row(1)


@pytest.mark.parametrize("what", ["registry", "zones"])
def test_mirror_publishes_the_reference_epoch(what):
    ref = JRegistryMirror(64, max_zones=16, max_verts=8)
    got = RegistryMirror(64, max_zones=16, max_verts=8, device="cpu")
    for m, enums in ((ref, jschema), (got, tschema)):
        _write_rows(m, enums)
    pub = "publish_registry" if what == "registry" else "publish_zones"
    _assert_tables_equal(getattr(ref, pub)(), getattr(got, pub)())
    if what == "zones":
        assert getattr(got, pub)().capacity == 8   # pow2 over slot 4
    assert got.epoch == ref.epoch


def test_mirror_caches_clean_epochs_and_never_aliases_them():
    m = RegistryMirror(32, max_zones=4, max_verts=4, device="cpu")
    m.set_device_row(3, active=True, tenant_id=1, device_type_id=2)
    reg = m.publish_registry()
    zones = m.publish_zones()
    assert m.publish_registry() is reg and m.publish_zones() is zones
    assert int(reg.epoch) == 1 and not m.dirty
    m.set_device_row(3, active=False, tenant_id=5, device_type_id=2)
    assert m.dirty
    assert bool(reg.active[3]) and int(reg.tenant_id[3]) == 1
    new = m.publish_registry()
    assert new is not reg and int(new.epoch) == 2
    assert int(new.tenant_id[3]) == 5
    assert m.publish_zones() is zones            # zones stayed clean


def test_mirror_rejects_bad_rows_before_writing():
    m = RegistryMirror(8, max_zones=2, max_verts=4, device="cpu")
    with pytest.raises(ValidationError):
        m.set_device_row(8, active=True, tenant_id=0, device_type_id=0)
    with pytest.raises(ValidationError):
        m.set_zone_row(2, active=True, tenant_id=0, area_id=0)
    with pytest.raises(ValidationError):   # too many vertices
        m.set_zone_row(0, active=True, tenant_id=0, area_id=0,
                       verts_lonlat=np.zeros((6, 2), np.float32))
    assert not m.z_active.any() and m.z_hi == 0


def _rules(mgr_cls, ident_cls, enums, **kw):
    ids = ident_cls()
    mgr = mgr_cls(ids, capacity=32, **kw)
    op, kind = enums.ComparisonOp, enums.RuleKind
    mgr.create_rule("temp", op.GT, 30.0, "hot", token="a")
    mgr.create_rule(None, op.LT, -1.5, "cold", tenant="acme", token="b",
                    alert_level=enums.AlertLevel.CRITICAL)
    mgr.create_rule("hum", op.GTE, 70.0, "wet", kind=kind.WINDOW_MEAN,
                    window_s=500.0, token="c")
    mgr.create_rule("temp", op.NEQ, 2.0, "jump", kind=kind.RATE_PER_S,
                    token="d")
    mgr.update_rule("a", threshold=31.0, kind=kind.WINDOW_MEAN, window_s=4000)
    mgr.delete_rule("b")
    mgr.create_rule("pres", op.EQ, 1.0, "flat", token="e")
    return mgr, ids


def test_rule_manager_publishes_the_reference_table():
    ref, rids = _rules(JRuleManager, JIdentityMap, jschema)
    got, gids = _rules(RuleManager, IdentityMap, tschema, device="cpu")
    _assert_tables_equal(ref.publish(), got.publish())
    assert got.publish().ewma_tau_s.dtype == torch.float32
    for space in ("tenant", "mtype", "alert_type"):
        assert getattr(rids, space)._token_to_id == \
            getattr(gids, space)._token_to_id
    table = got.publish()
    assert got.publish() is table and not got.dirty


def test_rule_manager_crud_contract():
    mgr, _ = _rules(RuleManager, IdentityMap, tschema, device="cpu")
    table = mgr.publish()
    assert [r.token for r in mgr.list_rules()] == ["a", "c", "d", "e"]
    with pytest.raises(DuplicateToken):
        mgr.create_rule(None, tschema.ComparisonOp.GT, 0, "x", token="a")
    with pytest.raises(EntityNotFound):
        mgr.get_rule("b")
    with pytest.raises(ValidationError):
        mgr.update_rule("a", threshold="warm")
    with pytest.raises(ValidationError):
        mgr.create_rule(None, tschema.ComparisonOp.GT, 0, "",)
    assert mgr.publish() is table               # failed writes: still clean
    assert mgr.get_rule("a").threshold == 31.0


def test_publishers_need_a_card_unless_cpu_is_named(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        RegistryMirror(8)
    with pytest.raises(RuntimeError, match="CUDA"):
        RuleManager(IdentityMap())
    assert RegistryMirror(8, device="cpu").device == CPU
    assert RuleManager(IdentityMap(), device="cpu").publish().active.device \
        == CPU


# -- packed additions ---------------------------------------------------------


@pytest.mark.parametrize("env,want", [(None, 0), ("8", 8), ("-3", 0),
                                      ("x", 0)])
def test_ring_depth_default(monkeypatch, env, want):
    if env is None:
        monkeypatch.delenv("SW_TPU_RING_DEPTH", raising=False)
    else:
        monkeypatch.setenv("SW_TPU_RING_DEPTH", env)
    assert tpacked.ring_depth_default() == want


def test_host_copy_counts_one_sync_and_reads_once():
    calls = []
    oi = torch.arange(20, dtype=torch.int32).reshape(2, 10)
    met = torch.arange(5, dtype=torch.int32)
    copy = tpacked.start_host_copy(oi, met, on_fetch=lambda: calls.append(1))
    a, b = copy.fetch()
    assert copy.fetch()[0] is a and calls == [1]
    np.testing.assert_array_equal(a, oi.numpy())
    np.testing.assert_array_equal(b, met.numpy())
    ring = tpacked.RingFetch(torch.stack([oi, oi + 1]), torch.stack([met, met]),
                             on_fetch=lambda: calls.append(2))
    views = [tpacked.RingStepView(ring, s) for s in range(2)]
    np.testing.assert_array_equal(views[1].oi, oi.numpy() + 1)
    np.testing.assert_array_equal(views[0].metrics_vector, met.numpy())
    assert calls == [1, 2]


def test_wire_world_tables_match(tmp_path):
    """The deployment the dispatcher tests drive publishes the same
    tables in both packages."""
    ref = wire_world("jax", tmp_path / "j", 0)
    got = wire_world("torch", tmp_path / "t", 0)
    _assert_tables_equal(ref.mirror.publish_registry(),
                         got.mirror.publish_registry())
    _assert_tables_equal(ref.mirror.publish_zones(),
                         got.mirror.publish_zones())
    _assert_tables_equal(ref.rules.publish(), got.rules.publish())
    assert got.rules.publish().capacity == 16
