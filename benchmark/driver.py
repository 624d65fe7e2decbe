"""The system under test: ``PipelineDispatcher`` of ``sitewhere_tpu_torch``
on the card, fed by one thread through ``ingest_arrays``.

A configuration says how the dispatcher is hosted: ``started`` (its loop
thread polls the batcher's deadline and, with ``egress_offload``, a
worker egresses), or driven by its caller alone (not started: each
``ingest_arrays`` call batches, steps and egresses on the feeder's
thread, and derived alerts ride in the next plan).

This is the only module of the benchmark that imports the port.  It
builds the dispatcher over the benchmark's world (through the providers
the dispatcher takes) and sink, feeds the stream, and reads the program's
timers and counters.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

import numpy as np

# The program's timers and counters the per-layer metrics read.
TIMERS = ("pipeline.stage_batch_s", "pipeline.stage_h2d_s",
          "pipeline.stage_dispatch_s", "pipeline.stage_ring_dispatch_s",
          "pipeline.stage_egress_s")
COUNTERS = ("pipeline.host_syncs", "pipeline.ring_chains")


def build_dispatcher(world, cfg: Dict, device, sink):
    """The dispatcher over the world and the sink, started where the
    configuration says so (``start()`` builds the native scanners and the
    geofence kernel and runs its warm-up dispatch; otherwise the first
    warm-up batch builds the kernel)."""
    from sitewhere_tpu_torch.ids import IdentityMap
    from sitewhere_tpu_torch.ingest.batcher import Batcher
    from sitewhere_tpu_torch.runtime.dispatcher import PipelineDispatcher
    from sitewhere_tpu_torch.schema import Registry, RuleTable, ZoneTable
    from sitewhere_tpu_torch.state.manager import DeviceStateManager

    registry = Registry(**world["registry"])
    rules = RuleTable(**world["rules"])
    zones = ZoneTable(**world["zones"])
    identity = IdentityMap()
    cap = cfg["registry_capacity"]
    state = DeviceStateManager(
        cap, identity, num_mtype_slots=cfg["mtype_slots"],
        num_ewma_scales=len(cfg["ewma_taus_s"]), device=device)
    batcher = Batcher(
        width=cfg["width"], n_shards=cfg["n_shards"], registry_capacity=cap,
        resolve_device=identity.device.lookup,
        resolve_mtype=identity.mtype.mint,
        resolve_alert=identity.alert_type.mint,
        invocations=identity.invocation, deadline_ms=cfg["deadline_ms"],
        emit_packed=True)
    disp = PipelineDispatcher(
        batcher=batcher, registry_provider=lambda: registry,
        state_manager=state, rules_provider=lambda: rules,
        zones_provider=lambda: zones, event_store=sink,
        ring_depth=cfg["ring_depth"], egress_offload=cfg["egress_offload"],
        device=device)
    if cfg["started"]:
        disp.start()
    return disp


def snapshot(disp) -> Dict:
    """The program's timers (total s, count), counters and step count."""
    m = disp.metrics
    return {
        "timers": {n: (m.timer(n).total, m.timer(n).count) for n in TIMERS},
        "counters": {n: int(m.counter(n).value) for n in COUNTERS},
        "steps": int(disp.steps),
        "copied_bytes": int(disp.batcher.copied_bytes),
    }


class Feeder:
    """One thread calling ``ingest_arrays`` back to back with one full
    width of stream rows each time, from batch ``start``, until
    ``stop_at`` (perf_counter s) or ``n_batches`` batches."""

    def __init__(self, disp, stream, start: int, handover: np.ndarray,
                 spans=None):
        self.disp = disp
        self.spans = spans
        self.stream = stream
        self.next = start
        self.handover = handover
        self.error: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None

    def run(self, stop_at: float = float("inf"),
            n_batches: Optional[int] = None) -> None:
        end = self.next + n_batches if n_batches is not None else None
        try:
            while end is None or self.next < end:
                cols = self.stream.columns(self.next)
                t = time.perf_counter()
                if t >= stop_at:
                    return
                self.handover[self.next] = t
                self.disp.ingest_arrays(**cols)
                if self.spans is not None:
                    self.spans.record("intake", t, time.perf_counter())
                self.next += 1
        except Exception as e:   # re-raised by join()
            self.error = e

    def start(self, stop_at: float) -> None:
        self._thread = threading.Thread(target=self.run, args=(stop_at,),
                                        name="bench-feeder", daemon=True)
        self._thread.start()

    def join(self) -> None:
        if self._thread is not None:
            self._thread.join()
        if self.error is not None:
            raise self.error


def drain(disp, timeout_s: float) -> bool:
    """``flush()``: on its return every row handed in has completed egress
    (rows that never reach the sink fail the comparison); False when the
    batcher still holds rows."""
    disp.flush(timeout_s=timeout_s)
    return disp.batcher.pending == 0


def final_state(disp, sample: np.ndarray) -> Dict[str, np.ndarray]:
    """The program's device state for the sampled devices."""
    host = disp.state_manager.snapshot_host()
    return {name: np.asarray(arr)[sample] for name, arr in host.items()}
