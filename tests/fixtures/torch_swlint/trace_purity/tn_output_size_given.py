"""TN: repeat_interleave with output_size and a three-argument
torch.where keep static shapes inside a declared step root."""
import torch


def pipeline_step(registry, state, rules, zones, batch):
    reps = torch.ones_like(batch.device_id)
    ids = torch.repeat_interleave(batch.device_id, reps,
                                  output_size=batch.device_id.shape[0])
    return state, torch.where(batch.valid, ids, -1)
