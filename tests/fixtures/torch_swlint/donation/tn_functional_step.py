"""TN: the step builds its new carry out of place; in-place writes touch
only tensors it allocated."""
import torch

from sitewhere_tpu_torch.pipeline.packed import chain_over_slots


def step(tables, ps, bi, bf):
    si = ps.si.clone()
    si[0] = bi[0]
    acc = torch.zeros_like(bf)
    acc.add_(bf)
    return ps.replace(si=si), bi, acc, bf


def chain(tables, ps, *slots):
    return chain_over_slots(step, 2, tables, ps, slots)
