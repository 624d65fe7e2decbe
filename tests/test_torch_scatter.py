"""The port's newest-wins scatters against the JAX reference, on the CPU.

Every case of ``tests/test_ops.py`` is carried across, plus random parity
with both JAX winner-map forms.  Results must be exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sitewhere_tpu.ops import scatter as jsc
from sitewhere_tpu_torch.ops import scatter as tsc

torch.set_num_threads(1)


def _both(fn_name, *args):
    """Call the JAX and the port function on the same numpy args (tuples
    of arrays stay tuples) and return both results as nested numpy."""
    def conv(a, mod):
        if isinstance(a, tuple):
            return tuple(conv(x, mod) for x in a)
        if isinstance(a, np.ndarray):
            return jnp.asarray(a) if mod is jsc else torch.from_numpy(a.copy())
        return a

    def back(r):
        if isinstance(r, tuple):
            return tuple(back(x) for x in r)
        return r.numpy() if isinstance(r, torch.Tensor) else np.asarray(r)

    ref = getattr(jsc, fn_name)(*(conv(a, jsc) for a in args))
    got = getattr(tsc, fn_name)(*(conv(a, tsc) for a in args))
    return back(ref), back(got)


def _assert_same(ref, got):
    if isinstance(ref, tuple):
        assert len(ref) == len(got)
        for a, b in zip(ref, got):
            _assert_same(a, b)
        return
    assert ref.dtype == got.dtype and ref.shape == got.shape
    np.testing.assert_array_equal(ref, got)


def i32(*v):
    return np.array(v, np.int32)


def f32(*v):
    return np.array(v, np.float32)


def b_(*v):
    return np.array(v, bool)


def test_scatter_last_by_time_basic():
    ref, got = _both(
        "scatter_last_by_time", i32(0, 0, 0, 0), i32(0, 0, 0, 0),
        (f32(0, 0, 0, 0),), i32(1, 1, 2, 0), i32(10, 20, 5, 7),
        i32(0, 0, 0, 0), (f32(1, 2, 3, 4),), b_(True, True, True, False))
    _assert_same(ref, got)
    assert got[0].tolist() == [0, 20, 5, 0]
    assert got[2][0].tolist() == [0.0, 2.0, 3.0, 0.0]


def test_stale_event_ignored():
    ref, got = _both("scatter_last_by_time", i32(100), i32(7), (f32(9),),
                     i32(0), i32(50), i32(999), (f32(1),), b_(True))
    _assert_same(ref, got)
    assert got[0][0] == 100 and got[1][0] == 7 and got[2][0][0] == 9.0


def test_ns_ordering():
    ref, got = _both("scatter_last_by_time", i32(100), i32(500), (f32(9),),
                     i32(0, 0), i32(100, 100), i32(100, 600), (f32(1, 2),),
                     b_(True, True))
    _assert_same(ref, got)
    assert got[1][0] == 600 and got[2][0][0] == 2.0


def test_out_of_range_ids_dropped():
    ref, got = _both("scatter_max_by_key", i32(0, 0), (f32(0, 0),),
                     i32(-1, 7, 0), i32(5, 5, 5), (f32(1, 2, 3),),
                     b_(True, True, True))
    _assert_same(ref, got)
    assert got[0].tolist() == [5, 0] and got[1][0].tolist() == [3.0, 0.0]


def test_exact_tie_one_row_wins_all_columns():
    ref, got = _both("scatter_last_by_time", i32(0, 0), i32(0, 0),
                     (f32(0, 0), f32(0, 0)), i32(1, 1), i32(1000, 1000),
                     i32(0, 0), (f32(10, 20), f32(-10, -20)), b_(True, True))
    _assert_same(ref, got)
    assert (got[2][0][1], got[2][1][1]) == (20.0, -20.0)


@pytest.mark.parametrize("ids,mask,length", [
    (i32(0, 2, 2, 5, 1), b_(True, True, True, True, False), 6),
    (i32(-1, 0), b_(True, True), 3),
])
def test_bincount_fixed(ids, mask, length):
    ref, got = _both("bincount_fixed", ids, mask, length)
    _assert_same(ref, got)


@pytest.mark.parametrize("fn", ["scatter_last_by_time", "scatter_max_by_key"])
def test_arity_mismatch_raises(fn):
    z = torch.zeros(2, dtype=torch.int32)
    f = torch.zeros(2)
    with pytest.raises(ValueError, match="arity"):
        if fn == "scatter_last_by_time":
            tsc.scatter_last_by_time(z, z, (f, f), z, z, z, (f,),
                                     torch.ones(2, dtype=torch.bool))
        else:
            tsc.scatter_max_by_key(z, (f,), z, z, (f, f),
                                   torch.ones(2, dtype=torch.bool))


@pytest.mark.parametrize("nkeys", [1, 2])
def test_winner_rows_matches_both_reference_forms(nkeys):
    """Random ids (some out of range), few distinct keys (many ties): the
    port's scatter form equals the reference's scatter and sort forms."""
    rng = np.random.default_rng(7)
    b, cap = 4096, 257
    ids = rng.integers(-3, cap + 3, b).astype(np.int32)
    keys = (rng.integers(100, 110, b).astype(np.int32),
            rng.integers(0, 4, b).astype(np.int32))[:nkeys]
    mask = rng.random(b) < 0.7
    jargs = (jnp.asarray(ids), tuple(map(jnp.asarray, keys)),
             jnp.asarray(mask), cap)
    got = tsc.winner_rows_by_keys(
        torch.from_numpy(ids), tuple(map(torch.from_numpy, keys)),
        torch.from_numpy(mask), cap).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(jsc._winner_rows_scatter(*jargs)))
    np.testing.assert_array_equal(got, np.asarray(jsc._winner_rows_sort(*jargs)))


def test_apply_winners_multi_column_parity():
    rng = np.random.default_rng(3)
    b, cap, k = 300, 40, 3
    ids = rng.integers(-2, cap + 2, b).astype(np.int32)
    ts_s = rng.integers(5, 8, b).astype(np.int32)
    ts_ns = rng.integers(0, 3, b).astype(np.int32)
    mask = rng.random(b) < 0.8
    cur_s = rng.integers(4, 8, cap).astype(np.int32)
    cur_ns = rng.integers(0, 3, cap).astype(np.int32)
    cur = (rng.random(cap).astype(np.float32),
           rng.random((cap, k)).astype(np.float32),
           rng.integers(0, 9, cap).astype(np.int32))
    pay = (rng.random(b).astype(np.float32),
           rng.random((b, k)).astype(np.float32),
           rng.integers(0, 9, b).astype(np.int32))
    ref, got = _both("scatter_last_by_time", cur_s, cur_ns, cur, ids, ts_s,
                     ts_ns, pay, mask)
    _assert_same(ref, got)
