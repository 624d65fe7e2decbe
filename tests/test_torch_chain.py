"""The K-deep ring through ``runtime/ring.py`` against the JAX chain.

A K=3 ring driven by the port's :class:`RingRunner` over a
:class:`DeviceStateManager` must give the outputs, metrics and carry of
``build_packed_chain(3, donate=False)`` (ints exact, EWMAs within the
stated bound), with one host sync per ring.  Presence flags set by a
sweep between lease and commit must survive as the reference's do.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sitewhere_tpu.ids import IdentityMap as JaxIdentityMap
from sitewhere_tpu.pipeline import packed as jpacked
from sitewhere_tpu.state.manager import DeviceStateManager as JaxManager
from sitewhere_tpu_torch import convert
from sitewhere_tpu_torch.pipeline import packed as tpacked
from sitewhere_tpu_torch.runtime.ring import RingRunner
from sitewhere_tpu_torch.state.manager import DeviceStateManager
from torch_parity import (
    CAP,
    CPU,
    K,
    M,
    assert_packed_state_equal,
    make_cols,
    make_state,
    make_tables,
    np_of,
)

torch.set_num_threads(1)

RING = 3
_jax_chain = jpacked.build_packed_chain(RING, donate=False)


def _ring_batches(ring: int):
    out = []
    for slot in range(RING):
        cols = make_cols(seed=10 * ring + slot,
                         ts_base=1_000 + 6 * (RING * ring + slot))
        out.append(jpacked.pack_batch_host(cols, len(cols["device_id"])))
    return out


@pytest.fixture(scope="module")
def setup():
    registry, rules, zones = make_tables(seed=0)
    state = make_state(seed=1)
    jt = jpacked.pack_tables(registry, rules, zones)
    return jt, state, convert.packed_tables_from(jt, CPU)


def _manager(state) -> DeviceStateManager:
    mgr = DeviceStateManager(CAP, num_mtype_slots=M, num_ewma_scales=K,
                             device="cpu")
    mgr.commit(convert.device_state_from(state, CPU))
    return mgr


def test_ring_matches_jax_chain(setup):
    jt, state, tt = setup
    mgr = _manager(state)
    runner = RingRunner(mgr, tt, RING)
    jps = jpacked.pack_state(state)
    for ring in range(2):
        batches = _ring_batches(ring)
        ref_ps, ref_ois, ref_mets, _ = _jax_chain(
            jt, jps, *(jnp.asarray(b[0]) for b in batches),
            *(jnp.asarray(b[1]) for b in batches))
        views = runner.dispatch(batches)
        assert runner.host_syncs == ring          # nothing read yet
        for slot, view in enumerate(views):
            np.testing.assert_array_equal(view.oi, np_of(ref_ois)[slot])
            np.testing.assert_array_equal(view.metrics_vector,
                                          np_of(ref_mets)[slot])
            assert int(view.metrics.processed) == int(
                batches[slot][0][0].sum())
        assert runner.host_syncs == ring + 1       # one fetch per ring
        assert_packed_state_equal(ref_ps, mgr.current_packed)
        jps = ref_ps
    assert runner.host_syncs_per_batch == pytest.approx(1 / RING)
    assert runner.batches == 2 * RING
    assert mgr.lease_generation == 2
    # the rules fired somewhere in the ring
    assert (views[-1].rule_id >= 0).any() and (views[-1].zone_id >= 0).any()


def test_chain_equals_stepwise(setup):
    """The chain's carry and outputs equal K single packed steps."""
    _, state, tt = setup
    ps = convert.packed_state_from(jpacked.pack_state(state), CPU)
    batches = _ring_batches(0)
    slots = ([torch.from_numpy(b[0]) for b in batches]
             + [torch.from_numpy(b[1]) for b in batches])
    c_ps, c_ois, c_mets, c_present = tpacked.build_packed_chain(RING)(
        tt, ps, *slots)
    present = torch.zeros(CAP, dtype=torch.bool)
    for i in range(RING):
        ps, oi, met, pres = tpacked.packed_pipeline_step(
            tt, ps, slots[i], slots[RING + i])
        assert torch.equal(oi, c_ois[i]) and torch.equal(met, c_mets[i])
        present |= pres
    assert torch.equal(ps.si, c_ps.si) and torch.equal(ps.sf, c_ps.sf)
    assert torch.equal(present, c_present)


def test_presence_sweep_between_lease_and_commit(setup):
    jt, state, tt = setup
    batches = _ring_batches(0)
    now_s, missing_after_s = 1_030, 10

    jm = JaxManager(CAP, JaxIdentityMap(), num_mtype_slots=M,
                    num_ewma_scales=K)
    jm.commit(state)
    jps, jtok = jm.lease_packed()
    jout = _jax_chain(jt, jps, *(jnp.asarray(b[0]) for b in batches),
                      *(jnp.asarray(b[1]) for b in batches))
    jmarked = jm.apply_presence_sweep(now_s, missing_after_s)
    jm.commit_packed(jout[0], present_now=jout[3], lease_token=jtok)

    mgr = _manager(state)
    ps, tok = mgr.lease_packed()
    chain = tpacked.build_packed_chain(RING)
    out = chain(tt, ps, *(torch.from_numpy(b[0]) for b in batches),
                *(torch.from_numpy(b[1]) for b in batches))
    marked = mgr.apply_presence_sweep(now_s, missing_after_s)
    mgr.commit_packed(out[0], present_now=out[3], lease_token=tok)

    np.testing.assert_array_equal(np_of(jmarked.device_id),
                                  np_of(marked.device_id))
    np.testing.assert_array_equal(np_of(jmarked.event_type),
                                  np_of(marked.event_type))
    assert_packed_state_equal(jm.current_packed, mgr.current_packed)
    missing = np_of(mgr.current.presence_missing)
    # the sweep's flags survived for devices the chain did not merge, and
    # were cleared for the ones it did
    swept = np_of(marked.device_id)
    merged = np_of(out[3])
    assert missing[swept[~merged[swept]]].all()
    assert not missing[merged].any()
    assert mgr.summary() == jm.summary()
    assert (mgr.get_device_state_by_id(int(swept[0]))
            == jm.get_device_state_by_id(int(swept[0])))


def test_commit_without_intervention_skips_merge(setup):
    _, state, tt = setup
    mgr = _manager(state)
    ps, tok = mgr.lease_packed()
    out = tpacked.build_packed_chain(RING)(
        tt, ps, *(torch.from_numpy(b[0]) for b in _ring_batches(0)),
        *(torch.from_numpy(b[1]) for b in _ring_batches(0)))
    mgr.commit_packed(out[0], present_now=out[3], lease_token=tok)
    assert mgr.current_packed is out[0]


def test_ring_rejects_wrong_slot_count(setup):
    _, state, tt = setup
    runner = RingRunner(_manager(state), tt, RING)
    with pytest.raises(ValueError):
        runner.dispatch(_ring_batches(0)[:2])


def test_commit_with_batch_rederives_presence(setup):
    """``commit(new_state, batch, accepted)`` after an intervening sweep
    keeps the sweep's flags for devices the step did not merge, as the
    reference's ``commit`` does."""
    from sitewhere_tpu.pipeline import pipeline_step as jax_step
    from sitewhere_tpu_torch.pipeline.step import pipeline_step
    from torch_parity import jax_batch, torch_inputs

    registry, rules, zones = make_tables(seed=0)
    state = make_state(seed=3)
    cols = make_cols(seed=3)
    jm = JaxManager(CAP, JaxIdentityMap(), num_mtype_slots=M,
                    num_ewma_scales=K)
    jm.commit(state)
    new_state, out = jax.jit(jax_step)(registry, state, rules, zones,
                                       jax_batch(cols))
    jm.apply_presence_sweep(1_030, 10)
    jm.commit(new_state, batch=jax_batch(cols), accepted=out.accepted)

    t_reg, t_rules, t_zones, t_state, t_batch = torch_inputs(
        registry, rules, zones, state, cols)
    mgr = _manager(state)
    t_new, t_out = pipeline_step(t_reg, t_state, t_rules, t_zones, t_batch)
    mgr.apply_presence_sweep(1_030, 10)
    mgr.commit(t_new, batch=t_batch, accepted=t_out.accepted)
    np.testing.assert_array_equal(np_of(jm.current.presence_missing),
                                  np_of(mgr.current.presence_missing))
    assert mgr.summary() == jm.summary()


def test_identity_lookup_by_token(setup):
    _, state, _ = setup
    mgr = _manager(state)
    hid = mgr.identity.device.mint("dev-7")
    assert mgr.identity.device.mint("dev-7") == hid
    assert mgr.identity.device.token_of(hid) == "dev-7"
    assert mgr.get_device_state("dev-7") == mgr.get_device_state_by_id(hid)
    with pytest.raises(KeyError):
        mgr.get_device_state("unknown")
