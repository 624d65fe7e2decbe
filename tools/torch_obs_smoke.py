#!/usr/bin/env python
"""Observability smoke of the PyTorch port: boot an instance, push
events, scrape the OpenMetrics exposition, and check that the whole
surface holds together.

Counterpart of ``tools/obs_smoke.py`` over the port ``Instance`` and its
``WebServer``.  Checked end to end over HTTP:

- ``GET /api/instance/metrics.prom`` serves parseable OpenMetrics text
  (``parse_exposition`` validates; it does not skip what it cannot
  read);
- at least one latency histogram has non-zero bucket counts;
- the ingest-to-seal watermark gauge is populated after traffic;
- the ``slo.*`` burn-rate and ``device.occupancy.*`` families are on the
  scrape surface;
- a forced flight-recorder anomaly produces a JSONL snapshot that the
  REST surface lists and serves, and that parses back with committed
  batch records in it;
- a forced-error RPC call leaves a retained trace on both sides of the
  boundary (tail sampling at a 0% head rate) with the same trace id;
- a skewed two-tenant load attributes exactly through the metering
  plane: ``GET /api/tenants/usage`` ranks the heavy tenant first with
  exact row counts, the drill-down serves its ledger row, and the
  ``tenant.*`` family round-trips the exposition.

The ``Instance`` steps on ``--device``: the card by default, where each
step launches the geofence kernel, or the CPU when named.

Usage::

    python tools/torch_obs_smoke.py [--device cpu] [--json OUT]

Exit status 0 = every check holds.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import urllib.request

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_EVENTS = 256


def _make_instance(data_dir, device):
    from sitewhere_tpu_torch.instance import Instance
    from sitewhere_tpu_torch.runtime.config import Config

    cfg = Config({
        "instance": {"id": "obs-smoke", "data_dir": data_dir},
        "pipeline": {"width": 64, "registry_capacity": 256,
                     "mtype_slots": 4, "deadline_ms": 5.0, "n_shards": 1},
        "presence": {"scan_interval_s": 3600.0, "missing_after_s": 1800},
        # head sampler off: every retained trace below is the tail
        # sampler's doing
        "tracing": {"sample_rate": 0.0, "tail_latency_ms": 50.0},
        # the ladder stays on, its watermarks out of reach: a busy host's
        # seal lag would otherwise shed the tenant load below, and no
        # check here is about shedding
        "overload": {"watermarks": {
            name: [1e9, 2e9, 3e9] for name in (
                "seal_lag_s", "decode_backlog", "egress_inflight",
                "batcher_backlog", "fsync_latency_s")}},
    }, apply_env=False)
    return Instance(cfg, device=device)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="scrape, SLO, occupancy and flight-recorder checks")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("--json", dest="json_out",
                        help="also write the report here")
    args = parser.parse_args(argv)

    from sitewhere_tpu_torch.device import resolve_device
    from sitewhere_tpu_torch.runtime.metrics import parse_exposition
    from sitewhere_tpu_torch.web import WebServer

    root = tempfile.mkdtemp(prefix="obs-smoke-")
    failures = []
    running = []     # what a failed check leaves to stop, newest last
    try:
        device = resolve_device(args.device)
        inst = _make_instance(os.path.join(root, "data"), device)
        inst.start()
        running.append(lambda: (inst.stop(), inst.terminate()))
        dm = inst.device_management
        dm.create_device_type(token="sensor", name="Sensor")
        for i in range(4):
            dm.create_device(token=f"d-{i}", device_type="sensor")
            dm.create_device_assignment(device=f"d-{i}")
        web = WebServer(inst)
        web.start()
        running.append(web.stop)

        # -- traffic ------------------------------------------------------
        lines = [json.dumps({
            "deviceToken": f"d-{r % 4}", "type": "Measurement",
            "request": {"name": "temp", "value": float(r),
                        "eventDate": 1_753_800_000 + r}})
            for r in range(N_EVENTS)]
        inst.dispatcher.ingest_wire_lines("\n".join(lines).encode())
        inst.dispatcher.flush()
        inst.event_store.flush()

        # -- tenant metering: skewed two-tenant load.  Devices
        #    are tenant-owned, so per-tenant attribution needs tenants +
        #    devices created through their engines; per-row tenancy rides
        #    the decoded-request metadata.
        from sitewhere_tpu_torch.ingest.decoders import DecodedRequest, RequestKind

        tenant_rows = {"acme": 384, "beta": 128}    # 3:1 skew
        for tok, n in tenant_rows.items():
            inst.tenants.create_tenant(token=tok, name=tok.title(),
                                       auth_token=f"{tok}-auth-token-123")
            tdm = inst.engines.get_engine(tok).device_management
            tdm.create_device_type(token=f"{tok}-sensor", name="Sensor")
            tdm.create_device(token=f"{tok}-dev",
                              device_type=f"{tok}-sensor")
            tdm.create_device_assignment(device=f"{tok}-dev")
            reqs = [DecodedRequest(
                kind=RequestKind.MEASUREMENT, device_token=f"{tok}-dev",
                ts_s=1_753_800_000 + r, mtype="temp", value=float(r),
                metadata={"tenant": tok}) for r in range(n)]
            inst.dispatcher.ingest_many(reqs, payload=b"obs-smoke")
        inst.dispatcher.flush()
        inst.event_store.flush()

        # top-K over REST: heavy tenant ranks first, counts are exact
        admin_jwt = inst.tokens.mint("admin", ["ROLE_ADMIN"])
        req = urllib.request.Request(
            f"http://127.0.0.1:{web.port}/api/tenants/usage?top=8",
            headers={"Authorization": f"Bearer {admin_jwt}"})
        with urllib.request.urlopen(req, timeout=10) as resp:
            usage = json.loads(resp.read())
        ranked = [t["tenant"] for t in usage.get("tenants", [])]
        rows_by_tenant = {t["tenant"]: t["usage"]["rows"]
                          for t in usage.get("tenants", [])}
        if ranked[:1] != ["acme"]:
            failures.append(f"heavy tenant not ranked first: {ranked}")
        for tok, n in tenant_rows.items():
            if rows_by_tenant.get(tok) != n:
                failures.append(
                    f"tenant {tok}: expected {n} rows, "
                    f"got {rows_by_tenant.get(tok)}")
        req = urllib.request.Request(
            f"http://127.0.0.1:{web.port}/api/tenants/usage/acme",
            headers={"Authorization": f"Bearer {admin_jwt}"})
        with urllib.request.urlopen(req, timeout=10) as resp:
            drill = json.loads(resp.read())
        if not drill.get("tracked") or \
                drill.get("usage", {}).get("rows") != 384:
            failures.append(f"tenant drill-down wrong: {drill}")

        # -- a forced-error RPC call: the acceptance proof.  The server
        #    runs on the INSTANCE tracer; the handler raises inside the
        #    rpc.server span, so the instance's tail sampler must retain
        #    it — and the caller's side retains its half with the SAME
        #    trace id (both at a 0% head rate).
        from sitewhere_tpu_torch.rpc import RpcChannel, RpcError, RpcServer
        from sitewhere_tpu_torch.runtime.tracing import Tracer

        def boom(ctx, body):
            raise ValueError("forced observability error")

        srv = RpcServer(port=0, tracer=inst.tracer)
        srv.register("boom", boom, auth_required=False)
        srv.start()
        try:
            client_tracer = Tracer(sample_rate=0.0, tail_errors=True)
            chan = RpcChannel(srv.endpoint)
            client_trace = client_tracer.trace("forward.batch")
            try:
                chan.call("boom", {}, trace=client_trace)
                failures.append("forced-error RPC unexpectedly succeeded")
            except RpcError:
                pass
            client_trace.end()
            chan.close()
        finally:
            srv.stop()

        server_spans = [s for s in inst.tracer.recent(200)
                        if s["name"] == "rpc.server.boom"]
        client_spans = [s for s in client_tracer.recent(10)
                        if s["name"] == "rpc.client.boom"]
        if not (server_spans and server_spans[0]["error"]):
            failures.append("server side did not retain the error trace")
        if not client_spans or client_tracer.retained_tail != 1:
            failures.append("client side did not retain the error trace")
        if server_spans and client_spans and \
                client_spans[0]["trace_id"] != server_spans[0]["trace_id"]:
            failures.append("trace id did not cross the RPC boundary")

        # -- scrape -------------------------------------------------------
        url = f"http://127.0.0.1:{web.port}/api/instance/metrics.prom"
        with urllib.request.urlopen(url, timeout=10) as resp:
            ctype = resp.headers.get("Content-Type", "")
            text = resp.read().decode("utf-8")
        if not ctype.startswith("application/openmetrics-text"):
            failures.append(f"unexpected content type: {ctype}")
        families = parse_exposition(text)  # raises on malformed exposition

        histograms = {f: v for f, v in families.items()
                      if v["type"] == "histogram"}
        if not histograms:
            failures.append("no histogram families in the exposition")
        populated = [
            f for f, v in histograms.items()
            if v["samples"].get(f + "_count", 0) > 0
            and any("_bucket{" in k for k in v["samples"])
        ]
        if not populated:
            failures.append("no histogram with non-zero bucket counts")

        seal = families.get("pipeline_ingest_to_seal_latency_s", {})
        seal_v = seal.get("samples", {}).get(
            "pipeline_ingest_to_seal_latency_s", 0.0)
        if seal_v <= 0.0:
            failures.append("ingest->seal watermark gauge not populated")

        # -- SLO + device-occupancy families on the scrape ----------------
        for family in ("slo_burn_rate_p99_ms_fast",
                       "device_occupancy_rows_admitted"):
            if family not in families:
                failures.append(f"{family} missing from the exposition")

        # -- governed tenant.* family round-trips the exposition ----------
        for family in ("tenant_meter_tracked", "tenant_usage_rows_acme",
                       "tenant_usage_rows_beta", "tenant_usage_rows_other"):
            if family not in families:
                failures.append(f"{family} missing from the exposition")
        acme_rows = families.get("tenant_usage_rows_acme", {}).get(
            "samples", {}).get("tenant_usage_rows_acme", 0.0)
        if acme_rows != 384.0:
            failures.append(
                f"tenant_usage_rows_acme scraped {acme_rows}, want 384")

        # -- flight recorder: trigger an anomaly dump, read it back -------
        from sitewhere_tpu_torch.runtime.flightrec import parse_snapshot

        if not inst.flightrec.recent(10):
            failures.append("flight recorder captured no batch records")
        dump = inst.flightrec.anomaly("obs-smoke",
                                      detail="forced by obs_smoke")
        if dump is None:
            failures.append("anomaly did not produce a snapshot")
        else:
            token = inst.tokens.mint("admin", ["ROLE_ADMIN"])
            base = f"http://127.0.0.1:{web.port}/api/instance"
            req = urllib.request.Request(
                f"{base}/flightrecorder",
                headers={"Authorization": f"Bearer {token}"})
            with urllib.request.urlopen(req, timeout=10) as resp:
                listing = json.loads(resp.read())
            names = [s["name"] for s in listing.get("snapshots", [])]
            name = os.path.basename(dump)
            if name not in names:
                failures.append(
                    f"snapshot {name} not listed by the REST surface")
            req = urllib.request.Request(
                f"{base}/flightrecorder/snapshots/{name}",
                headers={"Authorization": f"Bearer {token}"})
            with urllib.request.urlopen(req, timeout=10) as resp:
                snap = parse_snapshot(resp.read())   # raises on malformed
            if snap["header"]["reason"] != "obs-smoke":
                failures.append("snapshot header lost the anomaly reason")
            if not any(r.get("commit") == "ok"
                       for r in snap["records"]):
                failures.append(
                    "snapshot carries no committed batch records")

        stats = inst.tracer.stats()
        if stats["traces_retained_tail"] < 1:
            failures.append(
                f"forced-error trace was not retained: {stats}")

        while running:
            running.pop()()

        report = {
            "device": str(device),
            "families": len(families),
            "histograms_populated": populated,
            "ingest_to_seal_latency_s": seal_v,
            "tenant_usage": rows_by_tenant,
            "tracer": stats,
            "flightrec": inst.flightrec.stats(),
            "failures": failures,
            "ok": not failures,
        }
        print(json.dumps(report, indent=2))
        if args.json_out:
            with open(args.json_out, "w") as f:
                json.dump(report, f, indent=2)
    finally:
        while running:
            try:
                running.pop()()
            except Exception as e:  # the first error is the one to see
                print(f"obs_smoke: cleanup failed: {e!r}", file=sys.stderr)
        shutil.rmtree(root, ignore_errors=True)

    if failures:
        for f in failures:
            print(f"FAIL: {f}", file=sys.stderr)
        return 1
    print("obs_smoke: exposition parses, histograms populated, "
          "error trace retained")
    return 0


if __name__ == "__main__":
    sys.exit(main())
