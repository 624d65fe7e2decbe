"""The K-deep ring: K packed batches per chained dispatch, one host sync.

Counterpart of the dispatcher's ring path in
``sitewhere_tpu/runtime/dispatcher.py`` (``_dispatch_chain`` :1160-1199
and the ring fetch at :1706-1737), as a thin runner rather than the
dispatcher: stage K slots -> lease the carry -> run the chain -> commit
the carry -> one :class:`RingFetch` -> K :class:`RingStepView`\\ s.
On a mesh (``mesh=``) the chain is the sharded K-chain of
:mod:`~sitewhere_tpu_torch.pipeline.sharded`: the slots are staged one
block per shard, and the manager's epoch is sharded by capacity.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from sitewhere_tpu_torch.pipeline.packed import (
    PackedTables,
    RingFetch,
    RingStepView,
    build_packed_chain,
    stage_packed_batch,
)
from sitewhere_tpu_torch.state.manager import DeviceStateManager


class RingRunner:
    """Drives K-step chains over a :class:`DeviceStateManager`'s carry.

    ``host_syncs`` counts the blocking device-to-host waits (one per ring,
    at the first slot a caller reads); ``host_syncs_per_batch`` is that
    over the batches dispatched, 1/K in steady state.
    """

    def __init__(self, state_manager: DeviceStateManager,
                 tables: PackedTables, k: int, mesh=None):
        if k < 1:
            raise ValueError(f"ring depth must be >= 1, got {k}")
        self.state_manager = state_manager
        self.k = k
        self.mesh = mesh
        if mesh is not None:
            from sitewhere_tpu_torch.pipeline.sharded import (
                build_sharded_packed_chain,
                place_packed_tables,
            )

            self.tables = place_packed_tables(mesh, tables)
            self._chain = build_sharded_packed_chain(mesh, k)
        else:
            self.tables = tables
            self._chain = build_packed_chain(k)
        self.host_syncs = 0
        self.batches = 0

    def _count_sync(self) -> None:
        self.host_syncs += 1

    @property
    def host_syncs_per_batch(self) -> float:
        return self.host_syncs / self.batches if self.batches else 0.0

    def dispatch(self, batches: Sequence[Tuple[np.ndarray, np.ndarray]]
                 ) -> List[RingStepView]:
        """Run one ring over K host-packed ``(bi, bf)`` batches and return
        one view per slot.  The carry is committed before this returns;
        the views' first read waits for the ring's outputs."""
        if len(batches) != self.k:
            raise ValueError(f"ring takes {self.k} batches, got {len(batches)}")
        if self.mesh is not None:
            from sitewhere_tpu_torch.pipeline.sharded import (
                place_packed_batch,
            )

            staged = [place_packed_batch(self.mesh, bi, bf)
                      for bi, bf in batches]
        else:
            device = self.state_manager.device
            staged = [stage_packed_batch(bi, bf, device)
                      for bi, bf in batches]
        slots = [s[0] for s in staged] + [s[1] for s in staged]
        ps, token = self.state_manager.lease_packed()
        new_ps, ois, mets, present = self._chain(self.tables, ps, *slots)
        self.state_manager.commit_packed(new_ps, present_now=present,
                                         lease_token=token)
        fetch = RingFetch(ois, mets, on_fetch=self._count_sync)
        self.batches += self.k
        return [RingStepView(fetch, slot) for slot in range(self.k)]
