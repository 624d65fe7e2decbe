"""TN: the carry name rebound to the step's output before the write."""
from sitewhere_tpu_torch.pipeline.packed import chain_over_slots


def _advance(ps, bi):
    return ps.replace(si=ps.si + bi[0])


def step(tables, ps, bi, bf):
    ps = _advance(ps, bi)
    ps.si[0] = 0
    return ps, bi, bf, bf


def chain(tables, ps, *slots):
    return chain_over_slots(step, 2, tables, ps, slots)
