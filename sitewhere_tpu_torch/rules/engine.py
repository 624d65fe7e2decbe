"""The rule-program runner: live evaluation of compiled tenant programs.

Counterpart of ``sitewhere_tpu/rules/engine.py``.  Given a ``mesh``
(the reference's ``mesh=`` / ``rows_per_shard=``), the prepare pass runs
sharded (``rules/compile.py sharded_prepare``) over a trail sharded by
capacity; the ``Instance`` runs the engine unsharded, as the
reference's does.  The dispatcher's egress hands every accepted enriched
batch to :meth:`submit_live` (a non-blocking bounded offer), a single
worker thread runs the prepare and group passes of ``rules/compile.py``,
and fired programs become ALERT rows re-injected through the
dispatcher's derived-alert path.  The ``rules.*`` metric family keeps the
reference's names.

The trail tensors live on the card.  The control-plane hooks, wired by
the ``Instance`` and ``None`` without it: ``overload`` (shed as a
non-priority consumer), ``quotas`` (the metered-quota row gate, pure
host work on the worker) and ``usage_ledger`` (eval seconds billed by
row share).

Streams and threads:

- the worker launches on the card while the dispatcher steps, so the
  engine has its own CUDA stream; every tensor the engine owns (the
  trail, its batch inputs, the warm-up's) is made and used on it;
- one copy of every group's outputs per batch ends the batch with one
  sync (the reference syncs once per group); the tables and attribute
  epochs the batch read stay referenced until then;
- in torch the current stream is per thread, and :meth:`_fanout` ->
  ``inject`` -> the dispatcher's ``_run_plans`` steps the pipeline on the
  engine's thread.  That step must launch on the dispatcher's stream, or
  it races the state carry, so ``inject`` is called outside the engine's
  stream context.

Compile-stall contract: :meth:`refresh` (the mutation-side publish) runs
every group signature not seen yet once, on the MUTATING thread, before
the new epoch is read by traffic; an operand-only swap adds no signature
(``rules/compile.compile_count``).
"""

from __future__ import annotations

import contextlib
import logging
import pickle
import queue
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from sitewhere_tpu_torch.device import DeviceLike, resolve_device
from sitewhere_tpu_torch.ids import NULL_ID
from sitewhere_tpu_torch.rules import compile as rcompile
from sitewhere_tpu_torch.rules.enrich import AttributeStore
from sitewhere_tpu_torch.rules.registry import ProgramRegistry, RulesEpoch
from sitewhere_tpu_torch.runtime.lifecycle import LifecycleComponent
from sitewhere_tpu_torch.runtime.metrics import MetricsRegistry
from sitewhere_tpu_torch.schema import DEFAULT_EWMA_TAUS, EventType

_LOG = logging.getLogger("sitewhere_tpu_torch.rules")

_CHECKPOINT_VERSION = 1

# batch columns staged to the device in one int32 and one float32 block
_INT_COLS = ("device_id", "asset_id", "ts_s", "ts_ns", "mtype_id",
             "event_type", "tenant_id")
_FLOAT_COLS = ("value", "lon", "lat")


def _new_stream(device: torch.device):
    """The engine's own stream on a card; None on the CPU."""
    if device.type == "cuda":
        return torch.cuda.Stream(device=device)
    return None


class RuleEngineRunner(LifecycleComponent):
    """Lifecycle wrapper: trail state + attribute tables + program
    registry + the eval worker."""

    _LIVE_COLS = ("device_id", "tenant_id", "event_type", "mtype_id",
                  "value", "lon", "lat", "ts_s", "ts_ns")

    def __init__(self, capacity: int, n_mtype_slots: int = 8,
                 asset_capacity: int = 1024,
                 resolve_mtype=None, resolve_alert=None,
                 overload=None, metrics=None,
                 programs_per_tenant: int = 4,
                 max_programs: int = 262144,
                 queue_depth: int = 64,
                 mesh=None, rows_per_shard: Optional[int] = None,
                 name: str = "rule-programs",
                 device: DeviceLike = None):
        super().__init__(name)
        if mesh is not None and device is None:
            device = mesh.shard_devices[0]
        self.device = resolve_device(device)
        self.mesh = mesh
        self.rows_per_shard = rows_per_shard
        self._prepare_sharded = None
        self.capacity = int(capacity)
        self.n_mtype_slots = int(n_mtype_slots)
        self.overload = overload
        if metrics is None:
            metrics = MetricsRegistry()
        self.metrics = metrics
        self._stream = _new_stream(self.device)
        self.attributes = AttributeStore(capacity, asset_capacity,
                                         device=self.device)
        self.registry = ProgramRegistry(
            programs_per_tenant=programs_per_tenant,
            max_programs=max_programs,
            resolve_alert=resolve_alert,
            resolve_mtype=resolve_mtype,
            resolve_attr=self.attributes.resolve,
            device=self.device)
        self.taus = torch.tensor(DEFAULT_EWMA_TAUS, dtype=torch.float32,
                                 device=self.device)
        self._trail = self._fresh_trail()
        self._q: "queue.Queue" = queue.Queue(maxsize=queue_depth)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # serializes the passes + trail mutation against checkpoint
        # snapshots and restores
        self._eval_mutex = threading.Lock()
        self._warm_lock = threading.Lock()
        self._warmed: set = set()
        # dispatcher hook (instance-wired): alert re-injection
        self.inject = None
        # metering hooks (instance-wired): None without the ledger
        self.usage_ledger = None
        self.quotas = None
        # rules.* metric family, the reference's names
        self._m_programs = metrics.gauge("rules.programs")
        self._m_groups = metrics.gauge("rules.groups")
        self._m_shapes = metrics.gauge("rules.compiled_shapes")
        self._m_swaps = metrics.counter("rules.swaps")
        self._m_compiles = metrics.counter("rules.compiles")
        self._m_batches = metrics.counter("rules.live_batches")
        self._m_dropped = metrics.counter("rules.live_dropped")
        self._m_shed = metrics.counter("rules.live_shed")
        self._m_alerts = metrics.counter("rules.alerts")
        self._t_eval = metrics.timer("rules.eval_s")
        self._swaps_seen = 0
        self._compiles_seen = 0

    def _on_stream(self):
        """The engine's stream as the current one (nothing on the CPU)."""
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            self._stream.synchronize()

    def _fresh_trail(self):
        D, M = self.capacity, self.n_mtype_slots
        K = len(DEFAULT_EWMA_TAUS)
        dev = self.device
        with self._on_stream():
            trail = (torch.zeros((D, M), dtype=torch.int32, device=dev),
                     torch.zeros((D, M), dtype=torch.int32, device=dev),
                     torch.zeros((D, M), dtype=torch.float32, device=dev),
                     torch.zeros((D, M, K), dtype=torch.float32, device=dev))
        return trail

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        super().start()
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._worker, name=f"{self.name}-eval", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        if self._thread is not None:
            self.drain(timeout_s=5.0)
        self._stop.set()
        if self._thread is not None:
            try:
                self._q.put_nowait(None)
            except queue.Full:
                pass
            self._thread.join(timeout=5)
            self._thread = None
        super().stop()

    # -- mutation side -------------------------------------------------------

    def put_program(self, tenant: int, doc: dict) -> Dict[str, object]:
        out = self.registry.put_program(tenant, doc)
        self.refresh()
        return out

    def delete_program(self, tenant: int, token: str) -> bool:
        found = self.registry.delete_program(tenant, token)
        if found:
            self.refresh()
        return found

    def refresh(self) -> Optional[RulesEpoch]:
        """Publish registry + attribute epochs and run every group
        signature not seen yet once, all on the calling (mutation)
        thread."""
        epoch = self.registry.publish()
        self.attributes.publish()
        if epoch is not None:
            for group in epoch.groups:
                self._warm(group)
        self._publish_metrics()
        return epoch

    def _warm(self, group) -> None:
        sig = group.shape_sig()
        with self._warm_lock:
            if sig in self._warmed:
                return
        B = 8
        K = len(DEFAULT_EWMA_TAUS)
        dev = self.device
        cols = self.attributes.max_columns
        with self._on_stream():
            zi = torch.zeros(B, dtype=torch.int32, device=dev)
            zf = torch.zeros(B, dtype=torch.float32, device=dev)
            feats = rcompile.BatchFeatures(
                ewma=torch.zeros((B, K), dtype=torch.float32, device=dev),
                rate=zf, rate_valid=torch.zeros(B, dtype=torch.bool,
                                                device=dev),
                dev_attr=torch.zeros((B, cols), dtype=torch.int32,
                                     device=dev),
                asset_attr=torch.zeros((B, cols), dtype=torch.int32,
                                       device=dev))
            group.eval_fn(group.tables, feats, zi, zi, zi, zf, zf, zf,
                          torch.zeros(B, dtype=torch.bool, device=dev),
                          has_geo=group.has_geo)
            self._sync()
        with self._warm_lock:
            self._warmed.add(sig)

    def _publish_metrics(self) -> None:
        self._m_programs.set(self.registry.program_count())
        self._m_groups.set(self.registry.group_count())
        self._m_shapes.set(rcompile.structure_keys_compiled())
        swaps = self.registry.swaps
        if swaps > self._swaps_seen:
            self._m_swaps.inc(swaps - self._swaps_seen)
            self._swaps_seen = swaps
        compiles = rcompile.compile_count()
        if compiles > self._compiles_seen:
            self._m_compiles.inc(compiles - self._compiles_seen)
            self._compiles_seen = compiles

    # -- live path -----------------------------------------------------------

    def submit_live(self, cols, mask: np.ndarray) -> None:
        """Offer one accepted enriched batch (non-blocking, called from
        dispatcher egress).  Sheds as a non-priority consumer from
        SHEDDING up; drops (counted) when the queue is full."""
        if self.registry.current_epoch() is None:
            return
        if self.overload is not None \
                and not self.overload.allow_fanout(priority=False):
            self._m_shed.inc()
            return
        mask = np.asarray(mask)
        batch = {k: np.asarray(cols[k])[mask] for k in self._LIVE_COLS}
        batch["asset_id"] = np.asarray(
            cols["asset_id"])[mask] if "asset_id" in cols else np.full(
                len(batch["device_id"]), NULL_ID, np.int32)
        if not len(batch["device_id"]):
            return
        try:
            self._q.put_nowait(batch)
        except queue.Full:
            self._m_dropped.inc()

    def drain(self, timeout_s: float = 10.0) -> None:
        deadline = time.monotonic() + timeout_s
        with self._q.all_tasks_done:
            while self._q.unfinished_tasks:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return
                self._q.all_tasks_done.wait(remaining)

    def _worker(self) -> None:
        while not self._stop.is_set():
            try:
                item = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            try:
                if item is None:
                    continue
                self._m_batches.inc()
                self._eval_batch(item)
            except Exception:
                _LOG.exception("rule program eval failed")
            finally:
                self._q.task_done()

    def _stage(self, batch: Dict[str, np.ndarray]):
        """The batch's columns on the device: ``(ints, floats, accepted)``,
        one copy per block."""
        n = len(batch["device_id"])
        ints = np.stack([np.asarray(batch[k], np.int32) for k in _INT_COLS])
        floats = np.stack([np.asarray(batch[k], np.float32)
                           for k in _FLOAT_COLS])
        acc = np.asarray(batch.get("accepted", np.ones(n, bool)), bool)
        dev = self.device
        return (dict(zip(_INT_COLS, torch.from_numpy(ints).to(dev))),
                dict(zip(_FLOAT_COLS, torch.from_numpy(floats).to(dev))),
                torch.from_numpy(acc).to(dev))

    def _prepare(self, bi, bf, acc, attrs):
        """Run the prepare pass; updates the trail in place and returns
        the per-row features."""
        args = (*self._trail, attrs.device, attrs.asset,
                bi["device_id"], bi["asset_id"], bi["ts_s"], bi["ts_ns"],
                bi["mtype_id"], bf["value"], bi["event_type"], acc,
                self.taus)
        if self.mesh is not None:
            if self._prepare_sharded is None:
                rows = (self.rows_per_shard
                        or self.capacity // self.mesh.size)
                self._prepare_sharded = rcompile.sharded_prepare(
                    self.mesh, rows)
            feats, self._trail = self._prepare_sharded(*args)
        else:
            feats, self._trail = rcompile.prepare_kernel()(*args)
        return feats

    def _eval_batch(self, batch: Dict[str, np.ndarray]) -> None:
        # epoch isolation: grab the published world ONCE; a swap landing
        # mid-batch takes effect next batch, and the outgoing epoch's
        # tables are immutable for as long as we hold them
        epoch = self.registry.current_epoch()
        if epoch is None:
            return
        if self.quotas is not None and "tenant_id" in batch:
            # quota gate: deprioritized/refused tenants lose their rows
            # here (off the hot path); None when no quota is configured
            try:
                skip = self.quotas.skip_mask(np.asarray(batch["tenant_id"]))
            except Exception:
                _LOG.exception("rules quota mask failed")
                skip = None
            if skip is not None and skip.any():
                keep = ~skip
                if not keep.any():
                    return
                n = len(skip)
                batch = {k: (np.asarray(v)[keep]
                             if np.ndim(v) >= 1 and len(v) == n else v)
                         for k, v in batch.items()}
        attrs = self.attributes.publish()
        t0 = time.perf_counter()
        with self._eval_mutex:
            with self._t_eval.time(), self._on_stream():
                bi, bf, acc = self._stage(batch)
                feats = self._prepare(bi, bf, acc, attrs)
                outs, widths = [], []
                for group in epoch.groups:
                    fired, code, level, _pid = group.eval_fn(
                        group.tables, feats, bi["tenant_id"],
                        bi["event_type"], bi["mtype_id"], bf["value"],
                        bf["lon"], bf["lat"], acc, has_geo=group.has_geo)
                    outs.append(torch.stack(
                        [fired.to(torch.int32), code, level]))
                    widths.append(fired.shape[1])
                # one copy of every group's outputs: one sync per batch
                host = torch.cat(outs, dim=2).cpu().numpy()
        fired_out: List[Tuple[np.ndarray, ...]] = []
        lo = 0
        for w in widths:
            part = host[:, :, lo:lo + w]
            fired_out.append((part[0] != 0, part[1], part[2]))
            lo += w
        # outside the engine's stream: inject steps the pipeline here
        self._fanout(batch, fired_out)
        tenants = batch.get("tenant_id")
        if self.usage_ledger is not None and tenants is not None \
                and len(tenants):
            # rule eval is metered compute: bill wall time by row share
            try:
                per_row = (time.perf_counter() - t0) / len(tenants)
                self.usage_ledger.charge_rows_host(
                    np.asarray(tenants), "eval_s",
                    weights=np.full(len(tenants), per_row))
            except Exception:
                _LOG.exception("rules usage charge failed")

    def _fanout(self, batch, fired_out) -> None:
        """Fired (row, program-slot) pairs become ALERT event columns
        re-injected through the dispatcher's derived-alert path."""
        rows_all: List[np.ndarray] = []
        codes_all: List[np.ndarray] = []
        levels_all: List[np.ndarray] = []
        for fired, code, level in fired_out:
            rows, slots = np.nonzero(fired)
            if rows.size:
                rows_all.append(rows)
                codes_all.append(code[rows, slots])
                levels_all.append(level[rows, slots])
        if not rows_all:
            return
        rows = np.concatenate(rows_all)
        n = int(rows.size)
        self._m_alerts.inc(n)
        if self.inject is None:
            return
        cols = {
            "device_id": batch["device_id"][rows].astype(np.int32),
            "tenant_id": batch["tenant_id"][rows].astype(np.int32),
            "event_type": np.full(n, int(EventType.ALERT), np.int32),
            "ts_s": batch["ts_s"][rows].astype(np.int32),
            "ts_ns": batch["ts_ns"][rows].astype(np.int32),
            "value": batch["value"][rows].astype(np.float32),
            "alert_code": np.concatenate(codes_all).astype(np.int32),
            "alert_level": np.concatenate(levels_all).astype(np.int32),
            # derived alerts never re-fold trailing state
            "update_state": np.zeros(n, bool),
        }
        try:
            self.inject(cols)
        except Exception:
            _LOG.exception("rule alert injection failed")

    # -- checkpoint plane ----------------------------------------------------

    def snapshot_state(self) -> Tuple[bytes, Optional[dict]]:
        """Checkpoint section: program docs + attribute tables, the
        reference's payload.  The trailing EWMA/rate state restarts fresh:
        window predicates re-seed from the first sample after a restore
        (the first sample seeds the average, no zero bias)."""
        self.drain(timeout_s=2.0)
        with self._eval_mutex:
            progs, header = self.registry.snapshot_payload()
            cols, arrays = self.attributes.snapshot_payload()
        payload = pickle.dumps(
            {"version": _CHECKPOINT_VERSION, "programs": progs,
             "attr_cols": cols, "attr_arrays": arrays}, protocol=4)
        return payload, header

    def restore_state(self, header, payload) -> int:
        doc = pickle.loads(payload)
        self.attributes.restore_payload(doc.get("attr_cols") or {},
                                        doc.get("attr_arrays") or {})
        self.registry.restore_payload(header or {}, doc["programs"])
        with self._eval_mutex:
            self._trail = self._fresh_trail()
        self.refresh()
        return self.registry.program_count()

    # -- introspection -------------------------------------------------------

    def stats(self) -> Dict[str, object]:
        epoch = self.registry.current_epoch()
        return {
            "programs": self.registry.program_count(),
            "groups": self.registry.group_count(),
            "structures": self.registry.structure_keys(),
            "compiledShapes": rcompile.structure_keys_compiled(),
            "kernelExecutables": rcompile.compile_count(),
            "swaps": self.registry.swaps,
            "builds": self.registry.builds,
            "epoch": epoch.epoch if epoch else 0,
        }


__all__ = ["RuleEngineRunner"]
