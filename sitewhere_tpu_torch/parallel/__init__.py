"""Device mesh, placements and the per-shard map of the port.

Counterpart of ``sitewhere_tpu/parallel``: the reference's ``jax.sharding``
mesh over TPU chips becomes a single-controller mesh of
:class:`torch.device` entries (several shards may share one device).
Events are routed to the shard that owns their device's registry block,
so validation and enrichment gathers stay shard-local; metrics are
summed over the shards (:mod:`~sitewhere_tpu_torch.parallel.shmap`).
"""

from sitewhere_tpu_torch.parallel.mesh import (  # noqa: F401
    MeshSpec,
    make_mesh,
    shard_for_device,
)
