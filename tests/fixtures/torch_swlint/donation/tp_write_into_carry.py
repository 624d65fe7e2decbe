"""DN001: a step handed to chain_over_slots writes into its carry."""
from sitewhere_tpu_torch.pipeline.packed import chain_over_slots


def step(tables, ps, bi, bf):
    ps.si[0] = bi[0]
    return ps, bi, bf, bf


def chain(tables, ps, *slots):
    return chain_over_slots(step, 2, tables, ps, slots)
