#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once, on the card(s) of this machine.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up makes the world on the card and a pool of traffic batches from the
seed, builds ``PipelineDispatcher`` with the benchmark's sink as its event
store (started where the configuration says so), and warms up through
the same path.  The window then feeds one
full width of rows at a time, back to back, from one thread, for
``--seconds``, and ends with ``flush()``.  After it the reference works
out again what the sink must have received for a sample of devices and
the comparison decides ``correct``.  The last line of standard output is
one JSON object; the numbers compared, each beside its limit, are the
last lines of standard error.  Exits non-zero without a result when the
machine has fewer CUDA cards than the cell asks for, and when a JAX
module or the JAX package is loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    # run as a script: import the benchmark and the port from the checkout
    sys.path[0] = str(ROOT)

FORBIDDEN = frozenset(("jax", "jaxlib", "flax", "sitewhere_tpu"))
GIB = float(1 << 30)
MAX_BATCHES = 1 << 14        # payload_ref = batch * width + row stays int32
DRAIN_TIMEOUT_S = 120.0
# the traced sub-window: its length, and the gap it leaves before the
# window's end (the profiler stops once the window has closed)
TRACE_SHARE, TRACE_MAX_S, TRACE_TAIL_S = 0.25, 3.0, 0.5


def require_cards(n: int):
    """The first card, or exit 2 when the machine has fewer than ``n``."""
    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n:
        print(f"bench: the cell needs {n} CUDA card(s), this machine has "
              f"{have}", file=sys.stderr)
        raise SystemExit(2)
    return torch.device("cuda", 0)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def latencies(plans, handover, n0: int, width: int):
    """Per plan of the window: hand-over of its oldest row's batch (a
    derived alert's source row counts) to its arrival at the sink, s."""
    import numpy as np

    t, lo, n_stream = plans[:, 0], plans[:, 1], plans[:, 3]
    dlo, n_der = plans[:, 5], plans[:, 6]
    big = np.float64(1 << 62)
    oldest = np.minimum(np.where(n_stream > 0, lo, big),
                        np.where(n_der > 0, dlo, big))
    has = oldest < big
    batch = (oldest[has] // width).astype(np.int64)
    keep = batch >= n0
    return t[has][keep] - handover[batch[keep]]


def make_inputs(cfg, mix, seed: int, device):
    """Everything the cell's inputs are, from the seed: the world on the
    device and its host copy, the sampled devices (sorted handles, and a
    mask indexed by handle with a last entry for the null handle), and
    the traffic stream."""
    import numpy as np

    from benchmark import generator, world as world_mod

    cap, n_dev = cfg["registry_capacity"], cfg["devices"]
    world = world_mod.make_world(cfg, seed, device)
    rng = generator.seed_rng(seed, 2)
    sample = np.sort(np.concatenate([
        rng.choice(n_dev, cfg["sample_devices"], replace=False),
        n_dev + rng.choice(cap - n_dev, cfg["sample_unregistered"],
                           replace=False)])).astype(np.int64)
    sampled = np.zeros(cap + 1, bool)
    sampled[sample] = True
    stream = generator.Stream(seed, cfg["width"], mix, n_dev, cap,
                              cfg["mtype_slots"])
    return world, world_mod.to_host(world), sample, sampled, stream


def main(argv=None, root: Path = ROOT) -> int:
    args = parse(argv)
    from benchmark.spec import Spec

    spec = Spec(root)
    cell = spec.cell(args.workload)
    cfg = spec.config(cell["config"])
    mix = spec.traffic(cell["traffic"])
    cache = Path(root) / ".bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    device = require_cards(int(cell["chips"]))

    import numpy as np
    import torch

    from benchmark import devtrace, driver, host
    from benchmark.reference import compare, plain
    from benchmark.sink import Sink

    t_imported = time.perf_counter()
    on_card = device.type == "cuda"
    width, cap = cfg["width"], cfg["registry_capacity"]
    slots = cfg["mtype_slots"]
    limits = cfg["limits"]

    # -- set-up: world on the card, the sample, the traffic pool ----------
    world, world_host, sample, sampled, stream = make_inputs(
        cfg, mix, args.seed, device)
    spans = devtrace.HostSpans() if args.trace else None
    sink = Sink(sampled, spans)
    t_inputs = time.perf_counter()
    if args.trace and on_card:
        # before the dispatcher's threads exist
        devtrace.warm_profiler(torch)
    t_profiler = time.perf_counter()
    disp = driver.build_dispatcher(world, cfg, device, sink)
    t_started = time.perf_counter()
    handover = np.zeros(MAX_BATCHES, np.float64)
    feeder = driver.Feeder(disp, stream, 0, handover, spans)
    feeder.run(n_batches=cfg["warmup_batches"])
    if feeder.error is not None:
        raise feeder.error
    if not driver.drain(disp, DRAIN_TIMEOUT_S):
        raise RuntimeError("the warm-up did not drain")
    n0 = feeder.next
    snap0 = driver.snapshot(disp)

    # -- the measured window --------------------------------------------
    t0 = time.perf_counter()
    setup_s = t0 - T_START
    stop_at = t0 + args.seconds
    feeder.start(stop_at)
    capture = None
    if args.trace and on_card:
        span_s = min(TRACE_MAX_S, TRACE_SHARE * args.seconds)
        start = stop_at - span_s - min(TRACE_TAIL_S, TRACE_SHARE * args.seconds)
        time.sleep(max(0.0, start - time.perf_counter()))
        capture = devtrace.capture(torch, span_s, lambda: disp.steps, spans)
    feeder.join()
    quiesced = driver.drain(disp, DRAIN_TIMEOUT_S)
    t_end = time.perf_counter()
    n1 = feeder.next
    snap1 = driver.snapshot(disp)
    if n1 >= MAX_BATCHES:
        raise RuntimeError("stream longer than payload_ref can number")

    trace = (devtrace.read_capture(capture, spans) if capture is not None
             else None)
    window_rows = (n1 - n0) * width
    plans = sink.plan_table()
    lat = latencies(plans, handover, n0, width)
    peak = int(torch.cuda.max_memory_allocated(device)) if on_card else 0
    state_obs = driver.final_state(disp, sample)
    disp.stop()
    steps_total = disp.steps
    del disp
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # -- correct: the reference for the sampled devices ------------------
    t_ref = time.perf_counter()
    stream_plans = plans[plans[:, 3] > 0]
    rows = stream.rows_of(n1, sampled)
    exp, ambiguous = plain.outcome(
        world_host, rows, sample, stream_plans[:, 1:3].astype(np.int64),
        slots, "float32", zone_device=device, ambiguity=limits["ewma_gap"])
    obs, obs_dev, obs_enrich = sink.observed(sample, state_obs)
    numbers = compare.outcome_gaps(exp, obs, ambiguous)
    numbers["rows_misplaced"] = compare.rows_misplaced(
        stream_plans[:, 1:5].astype(np.int64), n1 * width, width)
    reg = world_host["registry"]
    registered = np.zeros(cap + 1, bool)
    registered[:cap] = (reg["active"] & (reg["tenant_id"] == 0)
                        & (reg["assignment_status"] == plain.ASSIGNMENT_ACTIVE))
    numbers["stored_total_gap"] = abs(
        sink.stored_stream_rows - stream.accepted_rows(n1, registered))
    numbers["enrich_wrong"] = compare.enrich_wrong(obs_dev, obs_enrich, reg)
    correct, checks, check_lines = compare.verdict(numbers, limits)
    correct = correct and quiesced
    ref_s = time.perf_counter() - t_ref

    # -- metrics ----------------------------------------------------------
    if args.trace:
        ctx = {"config": cfg, "traffic": mix, "width": width,
               "window_s": t_end - t0, "batches": n1 - n0,
               "rows": window_rows, "program": {"start": snap0, "end": snap1},
               "trace": trace, "latency_s": lat}
        metrics = {}
        for m in spec.per_layer(args.workload):
            value = spec.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = {
            "events_per_s": window_rows / (t_end - t0),
            "device_mem_peak_gib": peak / GIB if on_card else None,
            "setup_s": setup_s,
        }
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in spec.end_to_end(args.workload)
                   if e2e.get(m["name"]) is not None}
    covered = int(stream_plans[:, 3].sum())
    result = {
        "correct": bool(correct),
        "attempted": int(window_rows),
        "failed": int(max(0, n1 * width - covered)),
        "metrics": metrics,
        "device": {"platform": "gpu" if on_card else "cpu",
                   "kind": (torch.cuda.get_device_name(device) if on_card
                            else "cpu"),
                   "count": int(cell["chips"]),
                   "memory_peak_bytes": peak},
    }
    if trace is not None:
        result["device"]["busy_s"] = trace["busy_s"]
        result["device"]["window_s"] = trace["window_s"]
        result["breakdown"] = {"device_ops": trace["device_ops"],
                               "idle_gaps": trace["idle_gaps"]}
    result["card"] = card_line() if on_card else "cpu"
    result["host"] = host.placement()
    result["checks"] = checks

    found = forbidden_modules()
    if found:
        print(f"bench: forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    partial = int(np.count_nonzero(plans[:, 4] < width))
    inversions = compare.order_inversions(
        stream_plans[:, 1:3].astype(np.int64), obs.stored_refs,
        rows["device_id"][np.searchsorted(rows["ref"], obs.stored_refs)]
        .astype(np.int64))
    late = int(np.count_nonzero(stream_plans[1:, 1] < stream_plans[:-1, 2]))
    pct = (np.percentile(lat, [50, 90, 99, 100]) * 1e3 if lat.size
           else [float("nan")] * 4)
    # within-run drift: the rate of rows handed over in each fifth
    fifth = (t_end - t0) / 5
    fifths = np.bincount(
        np.minimum(((handover[n0:n1] - t0) // fifth).astype(np.int64), 4),
        minlength=5) * width / fifth
    derived = int(plans[:, 6].sum())
    zone_fired = int(np.isin(exp.alerts[:, 1],
                             world_host["zones"]["alert_code"]).sum())
    chains = (snap1["counters"]["pipeline.ring_chains"]
              - snap0["counters"]["pipeline.ring_chains"])
    syncs = (snap1["counters"]["pipeline.host_syncs"]
             - snap0["counters"]["pipeline.host_syncs"])
    print(f"bench: {args.workload} seed {args.seed}: batches {n1 - n0} in "
          f"{t_end - t0:.3f} s after {n0} warm-up; plans {len(plans)} "
          f"(partial {partial}), steps {steps_total}, in the window "
          f"{snap1['steps'] - snap0['steps']} with {chains} ring chains "
          f"and {syncs} host syncs; derived alerts "
          f"{derived} ({derived / max(1, n1 * width):.5f} of rows), state "
          f"changes {int(plans[:, 7].sum())}; latency samples {lat.size}; "
          f"quiesced {quiesced}; plans stepped before an earlier plan "
          f"{late}, sampled rows stepped before an earlier row of their "
          f"device {inversions}; latency p50/p90/p99/max ms "
          f"{' '.join(f'{x:.1f}' for x in pct)}; M events/s handed over "
          f"by fifth of the window {' '.join(f'{x / 1e6:.3f}' for x in fifths)}"
          + (f"; trace stop {trace['stop_s']:.2f} s, markers "
             f"{trace['markers']}, aligned {trace['aligned']}" if trace
             else "")
          + f"; sampled devices {sample.size}, their rows "
          f"{rows['ref'].size}, their alerts due: zone {zone_fired}, rule "
          f"{len(exp.alerts) - zone_fired}; ambiguous {ambiguous.size}; reference "
          f"{ref_s:.2f} s; set-up s: imports {t_imported - T_START:.2f}, "
          f"inputs {t_inputs - t_imported:.2f}, profiler "
          f"{t_profiler - t_inputs:.2f}, dispatcher start "
          f"{t_started - t_profiler:.2f}, warm-up {t0 - t_started:.2f}",
          file=sys.stderr)
    for line in check_lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
