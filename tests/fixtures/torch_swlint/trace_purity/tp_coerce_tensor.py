"""TP002: int() of a step parameter's element and float() of a torch
result inside the step set."""
import torch

from sitewhere_tpu_torch.pipeline.packed import chain_over_slots


def step(tables, ps, bi, bf):
    width = int(bi[0, 0])
    scale = float(torch.max(bf))
    return ps, bi[:, :width], bf * scale, bf


def chain(tables, ps, *slots):
    return chain_over_slots(step, 2, tables, ps, slots)
