"""TP001: a sync two calls below a declared step root (the step set
follows the call graph)."""
import torch


def _count(mask):
    return int(mask.sum())


def _fold(values, mask):
    torch.cuda.synchronize()
    return values * _count(mask)


def pipeline_step(registry, state, rules, zones, batch):
    return state, _fold(batch.value, batch.valid)
