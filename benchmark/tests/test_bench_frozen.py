"""The frozen copies: the geofence's least time, the generators, the
world, each against its source."""

import numpy as np
import pytest
import torch

from benchmark import generator, roofline, world


@pytest.mark.parametrize("b, want_ms", [(131072, 0.128), (16384, 0.0160)])
def test_pip_bound_recomputes_the_kernels_bounds(b, want_ms):
    ops_ms, bytes_ms = roofline.pip_bound_ms(b, 512, 16)
    assert max(ops_ms, bytes_ms) == ops_ms
    assert ops_ms == pytest.approx(want_ms, rel=2e-3)


def test_pip_bound_matches_chip_smoke():
    import chip_smoke

    for b in (4096, 16384, 131072):
        assert roofline.pip_bound_ms(b, 512, 16) == chip_smoke.pip_bound_ms(
            b, 512, 16)


def test_random_polygons_matches_chip_smoke():
    import chip_smoke

    a = world.random_polygons(torch.Generator().manual_seed(5), 64, 16,
                              -80, 80, 0.3, 2.0, "cpu")
    b = chip_smoke.random_polygons(torch.Generator().manual_seed(5), 64, 16,
                                   -80, 80, 0.3, 2.0, "cpu")
    assert torch.equal(a, b)


def _mix():
    return {"event_mix": {"measurement": 0.6, "location": 0.3, "alert": 0.1},
            "unregistered_share": 0.005, "invalid_share": 0.002,
            "nonfinite_share": 0.0005, "value_range": [0.0, 100.0],
            "lon_range": [-12.0, 12.0], "lat_range": [-12.0, 12.0],
            "elevation_range": [0.0, 100.0], "alert_codes": 20,
            "batch_span_s": 1, "ts_ns_max": 1_000_000_000, "pool_batches": 3}


def test_stream_repeats_bitwise_for_a_seed():
    seed = 3_000_000_007
    a = generator.Stream(seed, 2048, _mix(), 3000, 4096, 8)
    b = generator.Stream(seed, 2048, _mix(), 3000, 4096, 8)
    c = generator.Stream(seed + 1, 2048, _mix(), 3000, 4096, 8)
    for n in (0, 1, 5):
        ca, cb, cc = a.columns(n), b.columns(n), c.columns(n)
        for f in ca:
            assert np.array_equal(ca[f], cb[f], equal_nan=True), f
        assert not np.array_equal(ca["device_id"], cc["device_id"])


def test_stream_moves_event_time_and_numbers_rows():
    s = generator.Stream(1, 256, _mix(), 3000, 4096, 8)
    c0, c3 = s.columns(0), s.columns(3)
    assert np.array_equal(c3["ts_s"] - c0["ts_s"], np.full(256, 3))
    assert np.array_equal(c3["payload_ref"], np.arange(256) + 3 * 256)
    assert (c0["alert_code"] < generator.DERIVED_CODE_MIN).all()


def test_batch_shares_follow_the_mix():
    rng = generator.seed_rng(9, 1)
    cols = generator.make_batch_cols(rng, 1 << 18, _mix(), 3000, 4096, 8)
    dev, et = cols["device_id"], cols["event_type"]
    share = lambda m: m.mean()  # noqa: E731
    assert share(et == generator.MEASUREMENT) == pytest.approx(0.6, abs=0.01)
    assert share((dev >= 3000) & (dev < 4096)) == pytest.approx(0.005, abs=0.001)
    assert share((dev < 0) | (dev >= 4096)) == pytest.approx(0.002, abs=0.001)
    assert share(np.isnan(cols["value"])) == pytest.approx(0.0005, abs=0.0002)


def test_world_repeats_for_a_seed_and_keeps_the_wire_worlds_thresholds():
    cfg = {"registry_capacity": 4096, "devices": 3000, "rules": 64,
           "mtype_slots": 8, "ewma_taus_s": [60.0, 600.0, 3600.0],
           "zones": 32, "zone_verts": 16, "zone_box": [-80.0, 80.0],
           "zone_radius": [0.3, 2.0]}
    a = world.to_host(world.make_world(cfg, 3_000_000_001, "cpu"))
    b = world.to_host(world.make_world(cfg, 3_000_000_001, "cpu"))
    for tab in a:
        for f in a[tab]:
            assert np.array_equal(a[tab][f], b[tab][f]), (tab, f)
    r = a["rules"]
    inst = r["kind"] == world.KIND_INSTANT
    assert set(r["threshold"][inst].astype(float).round(3)) == {0.1, 99.9}
    assert (r["threshold"][r["kind"] == world.KIND_WINDOW_MEAN] == 99.0).all()
    assert (r["threshold"][r["kind"] == world.KIND_RATE] == 95.0).all()
    assert (r["alert_code"] >= generator.DERIVED_CODE_MIN).all()
    assert a["registry"]["active"].sum() == 3000
