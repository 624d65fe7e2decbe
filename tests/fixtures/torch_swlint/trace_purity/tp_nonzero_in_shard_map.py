"""TP001: a data-dependent shape (nonzero, a boolean-mask index) inside a
function handed to shard_map."""
import torch

from sitewhere_tpu_torch.parallel.shmap import shard_map


def build(mesh, specs):
    def local(values, valid):
        rows = torch.nonzero(valid).flatten()
        keep = values > 0
        return values[keep], rows

    return shard_map(local, mesh=mesh, in_specs=specs, out_specs=specs)
