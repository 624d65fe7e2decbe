#!/usr/bin/env python3
"""One host of a port fleet: a port ``Instance`` with the RPC fabric, in
a process of its own, driven over its standard input.

Run::

    python3 tools/torch_fleet_host.py '<spec JSON>'

The spec names the host's data directory, its ``process_id`` and the
fleet's ``peers`` (one ``host:port`` RPC endpoint per process, in
process-id order), the shared ``secret`` (``security.jwt_secret``), the
deployment (``capacity``, ``width``, ``deadline_ms``, ``mtype_slots``,
``max_zones``, ``max_zone_verts``), ``device`` (``"cpu"``, or null for
the card: without one the host raises), ``world_ckpt`` (a checkpoint
directory copied into a fresh data directory before boot, so the host
restores its devices, zones and rules from it).  Devices are named
``d-<i>``: ``i`` is the device's global index, which the ownership check
and the fleet-wide row checksums use.  Optional: ``web`` (serve the
REST gateway on 127.0.0.1, port 0) and ``capture_step`` (keep the
inputs and outputs of the first packed step with a valid row, a
restart's recovery replay included, and after each plain rerun, for a
plain-geofence rerun).  The overload ladder moves only by the
``overload`` command.

Each host takes NDJSON frames (``struct.pack(">I", len) + payload``) on
a config-declared raw-wire TCP source on 127.0.0.1 and routes them
through its ``HostForwarder``: rows of devices it owns into its own
pipeline, the rest over the fabric to their owner.  One host process per
fleet member; every member gets the same ``peers`` list and secret.

Protocol: after boot the host prints one JSON line ``{"event": "ready",
...}`` (ports, boot, restore, warm-up and replay seconds), then answers
each JSON command line on its standard input with one JSON line on its
standard output: ``intake`` (wait for N payloads taken by the source,
then until its forward spools are empty), ``flush`` (the dispatcher's
flush: every row egressed, sealed, committed), ``stats``, ``rows``
(stored-row checks, key counts written to a file), ``rerun_plain``,
``checkpoint``, ``journal_keys``, ``state_rows``, ``health``, the chaos
script's ``overload`` (force the ladder), ``net`` (drop packets to a
peer), ``ingest_attempts`` and ``edge_check``, and ``stop``.  Logging goes
to ``host.log`` in the data directory.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import shutil
import sys
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# appended stored-row identity: the same mixing as chip_smoke.row_checksum
_MIX = (np.uint64(0x9E3779B97F4A7C15), np.uint64(0xC2B2AE3D27D4EB4F),
        np.uint64(0x165667B19E3779F9), np.uint64(0x27D4EB2F165667C5))


def row_checksum(cols, globals_of, mask=None, mtypes=None):
    """(rows, order-independent uint64 checksum) of rows by GLOBAL device
    index, so two hosts' stores add up to one fleet's; with ``mtypes``
    (a map of measurement type ids) by global measurement type too."""
    def col(name):
        a = np.asarray(cols[name])
        return a if mask is None else a[mask]

    dense = col("device_id").astype(np.int64)
    dev = np.where(dense >= 0, globals_of(dense), -1).astype(np.uint64)
    mtype = col("mtype_id").astype(np.int64)
    if mtypes is not None:
        mtype = mtypes(mtype)
    with np.errstate(over="ignore"):
        h = (dev * _MIX[0]
             ^ col("event_type").astype(np.uint64) * _MIX[1]
             ^ (col("ts_s").astype(np.uint64) << np.uint64(30))
             ^ col("ts_ns").astype(np.uint64) * _MIX[2]
             ^ mtype.astype(np.uint64) * _MIX[3]
             ^ col("value").view(np.uint32).astype(np.uint64))
        return int(dev.size), int(h.sum(dtype=np.uint64))


def _pct(values, q):
    return float(np.percentile(values, q)) if values else None


class FirstStep:
    """The first packed step with a valid row that a dispatcher runs (the
    boot's warm-up step has none), kept for a rerun from its carry with
    the plain geofence; each rerun arms the capture again."""

    def __init__(self, disp):
        self.captured = None
        step = disp._packed_step

        def capturing(tables, ps, bi, bf):
            # row 0 of the packed batch is ``valid``; the read syncs only
            # while the capture is armed
            if self.captured is not None or not bool(bi[0].any()):
                return step(tables, ps, bi, bf)
            clone = (lambda t: t.clone())
            inputs = (dataclasses.replace(tables, **{
                f.name: clone(getattr(tables, f.name))
                for f in dataclasses.fields(tables)}),
                ps.replace(si=clone(ps.si), sf=clone(ps.sf)),
                clone(bi), clone(bf))
            out = step(tables, ps, bi, bf)
            k_ps, oi, met, present = out
            self.captured = (*inputs, (
                k_ps.replace(si=clone(k_ps.si), sf=clone(k_ps.sf)),
                clone(oi), clone(met), clone(present)))
            return out

        disp._packed_step = capturing

    def rerun(self):
        """The captured step again with the plain geofence: bitwise equal,
        and no kernel launch."""
        import torch

        from sitewhere_tpu_torch.ops import geo_cuda
        from sitewhere_tpu_torch.ops.geo import points_in_polygons
        from sitewhere_tpu_torch.pipeline.packed import packed_pipeline_step

        if self.captured is None:
            return {"captured": False}
        tables, ps, bi, bf, (k_ps, k_oi, k_met, k_present) = self.captured

        def plain(points, verts, rows=8192):
            return torch.cat([points_in_polygons(points[i:i + rows], verts)
                              for i in range(0, points.shape[0], rows)])

        before = geo_cuda.launch_counts["pip_parity"]
        p_ps, p_oi, p_met, p_present = packed_pipeline_step(
            tables, ps, bi, bf, plain)
        same = (torch.equal(p_oi, k_oi) and torch.equal(p_met, k_met)
                and torch.equal(p_present, k_present)
                and torch.equal(p_ps.si, k_ps.si)
                and torch.equal(p_ps.sf, k_ps.sf))
        self.captured = None
        return {"captured": True, "identical": bool(same),
                "kernel_launched": geo_cuda.launch_counts["pip_parity"]
                - before}


class Host:
    def __init__(self, spec):
        self.spec = spec
        self.t_spawn = float(spec.get("spawned_at", time.time()))
        d = spec["data_dir"]
        first_boot = not os.path.isdir(os.path.join(d, "checkpoint"))
        if first_boot and spec.get("world_ckpt"):
            os.makedirs(d, exist_ok=True)
            shutil.copytree(spec["world_ckpt"], os.path.join(d, "checkpoint"))
        self._build()
        self.global_of = np.full(0, -1, np.int64)
        self._refresh_globals()
        self._instrument()
        t0 = time.perf_counter()
        self.inst.start()
        self.start_s = time.perf_counter() - t0
        # steps and launches count from here: the boot's warm-up step and
        # the recovery replay are the ready line's
        from sitewhere_tpu_torch.ops import geo_cuda

        self.steps0 = self.inst.dispatcher.steps
        self.launches0 = geo_cuda.launch_counts["pip_parity"]
        self._wrap_sources()
        self.web = None
        if spec.get("web"):
            from sitewhere_tpu_torch.web import WebServer

            self.web = WebServer(self.inst, host="127.0.0.1", port=0,
                                 topology_interval_s=3600.0)
            self.web.start()

    def _build(self):
        from sitewhere_tpu_torch.instance import Instance
        from sitewhere_tpu_torch.runtime.config import Config

        s = self.spec
        port = int(s["peers"][s["process_id"]].rsplit(":", 1)[1])
        cfg = Config({
            "instance": {"id": f"fleet-{s['process_id']}",
                         "data_dir": s["data_dir"]},
            "pipeline": {"width": s["width"],
                         "registry_capacity": s["capacity"],
                         "mtype_slots": s["mtype_slots"],
                         "deadline_ms": s["deadline_ms"],
                         "adaptive_deadline": False, "ring_depth": 0,
                         "max_zones": s["max_zones"],
                         "max_zone_verts": s["max_zone_verts"]},
            "checkpoint": {"interval_s": 0},
            "rules": {"asset_capacity": s.get("asset_capacity", 1024)},
            # the runs count every line (stored == accepted across a
            # kill), so nothing but a forced state (the chaos script's
            # ``overload`` command) moves the ladder: every watermark out
            # of reach, a cooldown longer than any run; the SLO engine
            # off, as in the reference's zero-loss benches
            "overload": {"enabled": True, "cooldown_s": 3600.0,
                         "watermarks": {name: [1e9, 2e9, 3e9] for name in (
                             "seal_lag_s", "decode_backlog",
                             "egress_inflight", "batcher_backlog",
                             "fsync_latency_s")}},
            "slo": {"enabled": False},
            # no live queries, as the reference's fleet crash bench
            # (tools/crashrec_bench.py _forward_config): a restored
            # runner with no query keeps the as-of offset it was
            # restored with, which would hold every later checkpoint's
            # replay floor at the world's
            "analytics": {"enabled": False},
            "ingest": {"decode_workers": 0},
            "sources": [{"id": "wire", "decoder": "json", "raw_wire": True,
                         "receivers": [{"type": "tcp", "host": "127.0.0.1",
                                        "port": 0}]}],
            "rpc": {"server": {"enabled": True, "host": "127.0.0.1",
                               "port": port},
                    "process_id": s["process_id"], "peers": s["peers"],
                    "forward_deadline_ms": s.get("forward_deadline_ms",
                                                 25.0)},
            "security": {"jwt_secret": s["secret"]},
            # every trace kept: the forward batch times are read from the
            # forwarder's forward.batch spans
            "tracing": {"sample_rate": 1.0},
        }, apply_env=False)
        device = s.get("device")
        self.inst = Instance(cfg, device=device)

    def _refresh_globals(self):
        """Dense device id -> global index ``i`` of its token ``d-<i>``
        (-1 for other tokens)."""
        tokens = self.inst.identity.device.to_dict()["id_to_token"]
        g = np.full(max(len(tokens), 1), -1, np.int64)
        for dense, tok in enumerate(tokens):
            if tok is not None and tok.startswith("d-"):
                g[dense] = int(tok[2:])
        self.global_of = g

    def _globals(self, dense):
        dense = np.asarray(dense, np.int64)
        if dense.size and int(dense.max()) >= self.global_of.size:
            self._refresh_globals()
        return self.global_of[np.clip(dense, 0, None)]

    def _instrument(self):
        """What the fabric has no source for: each replicated ack's
        journal fsync on the owner, the appended rows' checksum and (with
        ``capture_step``) one packed step for the plain rerun; plus a
        sampler of the health table's verdicts."""
        inst = self.inst
        self.fsync_ms = []
        self.appended = {"rows": 0, "sum": 0}
        journal = inst.ingest_journal
        real_flush = journal.flush

        def flush(*a, **kw):
            t0 = time.perf_counter()
            try:
                return real_flush(*a, **kw)
            finally:
                if threading.current_thread().name.startswith("rpc-call"):
                    self.fsync_ms.append((time.perf_counter() - t0) * 1e3)

        journal.flush = flush
        store = inst.event_store
        real_append = store.append_columns
        lock = threading.Lock()

        def append(cols, mask=None):
            out = real_append(cols, mask=mask)
            n, h = row_checksum(cols, self._globals,
                                None if mask is None else np.asarray(mask))
            with lock:
                self.appended["rows"] += n
                self.appended["sum"] = (self.appended["sum"] + h) % (1 << 64)
            return out

        store.append_columns = append
        # armed before start(), so a restarted host's first replayed
        # step is the one captured
        self.first = (FirstStep(inst.dispatcher)
                      if self.spec.get("capture_step") else None)
        # the health table's verdicts on each peer, with their wall-clock
        # times, sampled from its snapshot every 10 ms
        self.transitions = []
        threading.Thread(target=self._watch_health, daemon=True,
                         name="fleet-health-watch").start()

    def _watch_health(self):
        health = self.inst.forwarder.health
        last = {}
        while True:
            for peer, rec in health.snapshot().items():
                if last.get(peer, "ALIVE") != rec["state"]:
                    self.transitions.append(
                        {"peer": int(peer), "from": last.get(peer, "ALIVE"),
                         "to": rec["state"], "at": time.time(),
                         "count": rec["transitions"]})
                last[peer] = rec["state"]
            time.sleep(0.01)

    def _wrap_sources(self):
        """Count the payloads each source has fully routed."""
        self.taken = 0
        self._taken_lock = threading.Lock()
        for src in self.inst.sources:
            real = src.on_wire_payload

            def routed(p, sid, _real=real):
                try:
                    return _real(p, sid)
                finally:
                    with self._taken_lock:
                        self.taken += 1

            src.on_wire_payload = routed

    # -- commands -------------------------------------------------------------

    def ready(self):
        m = self.inst.metrics
        return {"event": "ready", "process_id": self.spec["process_id"],
                "pid": os.getpid(),
                "source_port": self.inst.sources[0].receivers[0].port,
                "web_port": self.web.port if self.web else None,
                "boot_s": time.time() - self.t_spawn,
                "restored": bool(self.inst.restored),
                "restore_s": float(m.gauge("recovery.restore_s").value),
                "replay_s": float(m.gauge("recovery.replay_s").value),
                "replay_events": int(m.gauge("recovery.replay_events").value),
                "start_s": self.start_s,
                "committed": self.inst.dispatcher.journal_reader.committed,
                "journal_records": self.inst.ingest_journal.end_offset}

    def cmd_intake(self, payloads, drain=True, timeout_s=600.0):
        """Wait until the source has routed ``payloads`` payloads, then
        (``drain``) until every forward spool is empty (each owner
        acked)."""
        deadline = time.monotonic() + timeout_s
        t0 = time.perf_counter()
        while self.taken < payloads:
            if time.monotonic() > deadline:
                raise TimeoutError(f"took {self.taken} of {payloads}")
            time.sleep(0.002)
        taken_s = time.perf_counter() - t0
        out = self._drain_spools(deadline) if drain else {
            "taken": self.taken}
        out["taken_wait_s"] = taken_s
        return out

    def _drain_spools(self, deadline):
        fwd = self.inst.forwarder
        t0 = time.perf_counter()
        while fwd.metrics()["pending"]:
            if time.monotonic() > deadline:
                raise TimeoutError(f"spool pending {fwd.metrics()}")
            fwd.flush(wait=True)
            time.sleep(0.002)
        return {"taken": self.taken, "spool_drain_s":
                time.perf_counter() - t0}

    def cmd_drain(self, timeout_s=600.0):
        return self._drain_spools(time.monotonic() + timeout_s)

    def cmd_flush(self):
        t0 = time.perf_counter()
        self.inst.dispatcher.flush()
        return {"flush_s": time.perf_counter() - t0,
                "journal_records": self.inst.ingest_journal.end_offset,
                "pending": self.inst.forwarder.metrics()["pending"]}

    def cmd_stats(self):
        inst = self.inst
        disp, fwd = inst.dispatcher, inst.forwarder
        from sitewhere_tpu_torch.ops import geo_cuda

        m = fwd.metrics()
        # each forwarded batch's span, send to the owner's ack
        batch_ms = [sp["duration_ms"]
                    for sp in inst.tracer.recent(limit=1 << 30)
                    if sp["name"] == "forward.batch"
                    and sp["duration_ms"] is not None]
        return {
            "totals": dict(disp.totals),
            "steps": int(disp.steps - self.steps0),
            "launches": int(geo_cuda.launch_counts["pip_parity"]
                            - self.launches0),
            "forward": {k: m[k] for k in (
                "local_rows", "forwarded_rows", "dead_lettered", "pending",
                "send_attempts", "probe_sends", "edge_refusals")},
            "peers": m["peers"],
            "heartbeats_sent": int(inst.metrics.counter(
                "forward.heartbeats_sent").value),
            "heartbeats_failed": int(inst.metrics.counter(
                "forward.heartbeats_failed").value),
            "forward_batches": len(batch_ms),
            "forward_batch_ms_p50": _pct(batch_ms, 50),
            "forward_batch_ms_p99": _pct(batch_ms, 99),
            "tracing": inst.tracer.stats(),
            "ack_fsyncs": len(self.fsync_ms),
            "ack_fsync_ms_p50": _pct(self.fsync_ms, 50),
            "ack_fsync_ms_p99": _pct(self.fsync_ms, 99),
            "registration_rejected": int(inst.registration.rejected),
            "registration_registered": int(inst.registration.registered),
            "committed": disp.journal_reader.committed,
            "journal_records": inst.ingest_journal.end_offset,
            "appended": dict(self.appended),
            "cpu_fallback_steps": int(inst.metrics.counter(
                "device.fault.cpu_fallback_steps").value),
        }

    def cmd_rows(self, owners_path, keys_out=None, key_lo=None,
                 key_hi=None):
        """The stored rows: their count and checksum by global device,
        whether every row's device is owned by this host, and (with
        ``keys_out``) the measurement rows' ``ts_s`` keys in
        ``[key_lo, key_hi)`` with their counts, as an ``.npz``."""
        owners = np.load(owners_path)
        me = self.spec["process_id"]
        store = self.inst.event_store
        stored = {"rows": 0, "sum": 0}
        inputs = {"rows": 0, "sum": 0}
        derived = self._derived_codes()
        foreign = 0
        keys = []
        for cols in store.iter_chunks():
            n, h = row_checksum(cols, self._globals)
            stored["rows"] += n
            stored["sum"] = (stored["sum"] + h) % (1 << 64)
            sent = ~((np.asarray(cols["event_type"]) == 2)
                     & np.isin(np.asarray(cols["alert_code"]), derived))
            n, h = row_checksum(cols, self._globals, sent,
                                mtypes=self._mtype_globals())
            inputs["rows"] += n
            inputs["sum"] = (inputs["sum"] + h) % (1 << 64)
            glob = self._globals(np.asarray(cols["device_id"], np.int64))
            foreign += int(((glob < 0) | (owners[np.clip(glob, 0, None)]
                                          != me)).sum())
            if keys_out is not None:
                ts = np.asarray(cols["ts_s"], np.int64)
                sel = ((np.asarray(cols["event_type"]) == 0)
                       & (ts >= key_lo) & (ts < key_hi))
                keys.append(ts[sel])
        out = {"stored": stored, "inputs": inputs,
               "appended": dict(self.appended),
               "foreign_rows": foreign,
               "parked": store.sealer.parked_count(),
               "sealed_dead_lettered": store.sealed_dead_lettered}
        if keys_out is not None:
            k = np.concatenate(keys) if keys else np.zeros(0, np.int64)
            uniq, counts = np.unique(k, return_counts=True)
            np.savez(keys_out, keys=uniq, counts=counts)
        return out

    def _derived_codes(self):
        """The alert codes of derived alerts: every alert type but the
        ``device-<k>`` types that alert lines name."""
        toks = self.inst.identity.alert_type.to_dict()["id_to_token"]
        return np.asarray([h for h, tok in enumerate(toks)
                           if tok is not None
                           and not tok.startswith("device-")], np.int64)

    def _mtype_globals(self):
        """Measurement type id -> ``k`` of its token ``m<k>`` (-1 else)."""
        toks = self.inst.identity.mtype.to_dict()["id_to_token"]
        g = np.asarray([int(t[1:]) if t and t[:1] == "m" and t[1:].isdigit()
                        else -1 for t in toks] or [-1], np.int64)
        return lambda ids: np.where(ids >= 0, g[np.clip(ids, 0, None)], -1)

    def cmd_journal_keys(self, lo, hi, out):
        """The ``eventDate`` seconds of every line of a registered
        (``d-``) device in the ingest journal's records ``[lo, hi)``, as
        an ``.npy`` (the keyed payloads' keys)."""
        import re

        pat = re.compile(rb'"deviceToken":"d-\d+"[^\n]*?"eventDate":(\d+)')
        keys = []
        for _, payload in self.inst.ingest_journal.scan(lo, hi):
            keys.extend(int(v) // 1000 for v in pat.findall(payload))
        np.save(out, np.asarray(keys, np.int64))
        return {"keys": len(keys)}

    def cmd_rerun_plain(self):
        """The captured step again from its carry with the plain geofence
        on the card: bitwise equal, and no kernel launch."""
        if self.first is None:
            return {"captured": False}
        return self.first.rerun()

    def cmd_checkpoint(self):
        t0 = time.perf_counter()
        self.inst.checkpointer.save()
        return {"save_s": time.perf_counter() - t0,
                "journal_records": self.inst.ingest_journal.end_offset,
                "committed": self.inst.dispatcher.journal_reader.committed}

    def cmd_state_rows(self, tokens):
        """Each token's registration on this host and a digest of its
        full state row (every field's bytes), from one host copy of the
        epoch; None where the host does not hold the device."""
        import hashlib

        ident = self.inst.identity.device
        dm = self.inst.device_management
        host = self.inst.device_state.snapshot_host()
        out = {}
        for tok in tokens:
            dense = ident.lookup(tok)
            if dense < 0:
                out[tok] = None
                continue
            a = dm.get_active_assignment(tok)
            h = hashlib.sha256()
            for name in sorted(host):
                h.update(np.ascontiguousarray(host[name][dense]).tobytes())
            out[tok] = {"assignment": a.token if a else None,
                        "ts": int(host["last_event_ts_s"][dense]),
                        "state": h.hexdigest()}
        return out

    def cmd_health(self):
        return {"peers": self.inst.forwarder.health.snapshot(),
                "transitions": list(self.transitions)}

    def cmd_overload(self, state, reason="fleet-chaos"):
        """Force the overload ladder to ``state`` (a state name)."""
        from sitewhere_tpu_torch.runtime.overload import OverloadState

        self.inst.overload.force(OverloadState[state], reason=reason)
        return {"state": self.inst.overload.state.name}

    def cmd_net(self, endpoint, drop=0.0):
        """Drop ``drop`` of this host's packets to ``endpoint`` (0 heals
        it): the partition of the chaos script."""
        from sitewhere_tpu_torch.runtime import faults

        if drop:
            faults.net_inject(endpoint, drop=float(drop))
        else:
            faults.net_clear(endpoint)
        return {"endpoint": endpoint, "drop": float(drop)}

    def cmd_ingest_attempts(self, peer):
        """``events.ingest`` calls this host has made to ``peer`` since
        the first ask (the counting wrapper goes on at the first ask)."""
        counts = getattr(self, "_ingest_calls", None)
        if counts is None:
            counts = self._ingest_calls = {}
        if peer not in counts:
            demux = self.inst._peer_demuxes[peer]
            counts[peer] = 0
            real = demux.call

            def counted(method, *a, _peer=peer, **kw):
                if method == "events.ingest":
                    counts[_peer] += 1
                return real(method, *a, **kw)

            demux.call = counted
        return {"peer": peer, "attempts": counts[peer]}

    def cmd_edge_check(self, lines):
        """Route one payload of ``lines`` through the forwarder's edge
        gate: refused (with the owner's Retry-After hint) or taken."""
        from sitewhere_tpu_torch.runtime.overload import OverloadShed

        try:
            self.inst.forwarder.ingest_payload("\n".join(lines).encode(),
                                               source_id="edge-check")
        except OverloadShed as e:
            return {"refused": True, "retry_after_s": e.retry_after_s,
                    "state": e.state.name}
        return {"refused": False}

    def cmd_stop(self):
        if self.web is not None:
            self.web.stop()
        self.inst.stop()
        self.inst.terminate()
        return {"stopped": True}


def main(spec_json: str) -> int:
    sys.path.insert(0, REPO)
    spec = json.loads(spec_json)
    os.makedirs(spec["data_dir"], exist_ok=True)
    logging.basicConfig(
        filename=os.path.join(spec["data_dir"], "host.log"),
        level=logging.WARNING,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    out = sys.stdout
    sys.stdout = sys.stderr        # nothing else writes to the protocol
    host = Host(spec)
    out.write(json.dumps(host.ready()) + "\n")
    out.flush()
    for line in sys.stdin:
        if not line.strip():
            continue
        req = json.loads(line)
        name = req.pop("cmd")
        try:
            reply = {"ok": True,
                     "result": getattr(host, f"cmd_{name}")(**req)}
        except Exception as e:   # the caller fails the run on it
            logging.exception("command %s failed", name)
            reply = {"ok": False, "error": f"{type(e).__name__}: {e}"}
        out.write(json.dumps(reply) + "\n")
        out.flush()
        if name == "stop":
            return 0
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
