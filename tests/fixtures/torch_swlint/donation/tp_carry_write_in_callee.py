"""DN001: the carry passed on to a helper that writes into it (and a view
through unpack_state)."""
from sitewhere_tpu_torch.pipeline.packed import chain_over_slots, unpack_state


def _touch(state, rows):
    state.last_values[rows] += 1.0
    return state


def step(tables, ps, bi, bf):
    state = unpack_state(ps)
    _touch(state, bi[0])
    return ps, bi, bf, bf


def chain(tables, ps, *slots):
    return chain_over_slots(step, 2, tables, ps, slots)
