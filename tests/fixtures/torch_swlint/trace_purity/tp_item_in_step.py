"""TP001: a step handed to chain_over_slots reads a scalar off the card."""
import torch

from sitewhere_tpu_torch.pipeline.packed import chain_over_slots


def step(tables, ps, bi, bf):
    n = bi[0].sum().item()
    return ps, bi * n, bf, torch.zeros(1)


def chain(tables, ps, *slots):
    return chain_over_slots(step, 2, tables, ps, slots)
