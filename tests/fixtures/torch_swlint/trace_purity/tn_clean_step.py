"""TN: a step with static shapes and no host reads; int() of a bare
static argument is normalization, not a sync."""
import torch

from sitewhere_tpu_torch.pipeline.packed import chain_over_slots


def step(tables, ps, bi, bf, k=2):
    k = int(k)
    keep = bi[0] >= 0
    vals = torch.where(keep, bf[0], torch.zeros_like(bf[0]))
    return ps, bi, bf + vals * k, keep


def chain(tables, ps, *slots):
    return chain_over_slots(step, 2, tables, ps, slots)
