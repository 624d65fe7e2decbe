"""Device-side telemetry: per-stage device time of the fused step.

Counterpart of ``sitewhere_tpu/pipeline/telemetry.py`` (:func:`measure_rtt`
:59 and :func:`profile_device_stages` :80), rebuilt on CUDA events.

The reference chains each stage ``iters`` times inside one
``lax.fori_loop``, fetches the result and subtracts the measured host
round trip, because a TPU program has no readable clock.  The card has
one: each stage here runs once to warm up, then ``iters`` launches of it
(inputs perturbed by the loop index, and the state stages threading their
carry, as the reference's chains do) run on a stream of the profile's own
between two ``torch.cuda.Event`` records.  A sample is the elapsed time
over ``iters``.  On the CPU the same loop is timed with the host clock.
The result keeps the reference's keys (``<stage>_ms``, ``host_rtt_ms``,
``width``, ``iters``, ``repeats``, ``device_events_per_s``), and every
sample lands in the ``device.stage_ms.<stage>`` histogram.

The stages are the port's own step functions, so the ``zones`` and
``full`` stages launch the geofence kernel (``csrc/pip_kernel.cu``) on a
card at B=width, Z=zone capacity, V=the zone table's vertex count.

:class:`ProfilerCapture` is the on-demand trace behind the Instance's
``start_profiler_capture`` / ``stop_profiler_capture`` (``jax.profiler``
in the reference).

``xla_cost_analysis`` and ``record_cost_metrics`` (the reference's :229
and :253) read the flops and bytes of a compiled XLA program; torch
compiles no program to ask, so the port has no ``device.cost.*`` gauges
and the dispatcher's ``cost_analysis`` switch stays off.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from sitewhere_tpu_torch.device import DeviceLike, resolve_device
from sitewhere_tpu_torch.schema import (
    DeviceState,
    EventBatch,
    Registry,
    RuleTable,
    ZoneTable,
)

# The probed stages, in pipeline order (keys of the result dict and the
# ``device.stage_ms.<stage>`` histogram family suffixes).
DEVICE_STAGES: Tuple[str, ...] = (
    "validate", "rules", "zones", "state", "full")

# Millisecond-scale buckets for the device stage histograms: a step of a
# few milliseconds and its sub-millisecond stages must not collapse into
# one bucket (the default latency buckets are seconds-denominated).
DEVICE_STAGE_MS_BUCKETS: Tuple[float, ...] = (
    0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0,
    50.0, 100.0)


def measure_rtt(samples: int = 7, device: DeviceLike = None) -> float:
    """Median round trip of a trivial launch and its fetch (seconds): the
    per-sync floor a host-timed probe pays."""
    dev = resolve_device(device)
    x = torch.zeros((), dtype=torch.int32, device=dev)
    int(x + 1)  # warm
    rtts = []
    for _ in range(samples):
        t0 = time.perf_counter()
        int(x + 1)
        rtts.append(time.perf_counter() - t0)
    return float(np.median(rtts))


def profile_device_stages(width: int = 16_384, capacity: int = 16_384,
                          active: Optional[int] = None,
                          rules_capacity: int = 64,
                          zones_capacity: int = 64,
                          zone_verts: int = 16,
                          iters: int = 16, repeats: int = 3,
                          metrics=None,
                          device: DeviceLike = None) -> Dict[str, object]:
    """Per-stage device time of the fused step at ``width`` rows over a
    registry of ``capacity`` slots and rule and zone tables of the given
    capacities (empty, as in the reference: the dense ``[B, R]`` and
    ``[B, Z]`` passes cost the same whatever the tables hold).

    Returns ``{"<stage>_ms": median_ms, ..., "host_rtt_ms": ...,
    "width": ..., "iters": ..., "repeats": ...}``; with ``metrics`` (a
    ``MetricsRegistry``) every repeat's sample is observed into the
    ``device.stage_ms.<stage>`` histogram.

    An on-demand diagnostic (REST, boot knob), never part of the live
    dispatch path: it allocates its own tables and batch and launches on
    a stream of its own."""
    from sitewhere_tpu_torch.pipeline.step import (
        eval_threshold_rules,
        eval_zone_rules,
        pipeline_step,
        update_device_state,
        validate_and_enrich,
    )

    dev = resolve_device(device)
    iters, repeats = max(1, int(iters)), max(1, int(repeats))
    active = min(capacity, active if active else max(1, width // 2))
    on_card = dev.type == "cuda"
    stream = torch.cuda.Stream(dev) if on_card else None

    def on_stream():
        return (torch.cuda.stream(stream) if stream is not None
                else contextlib.nullcontext())

    with on_stream():
        registry = Registry.empty(capacity, device=dev).replace(
            active=torch.arange(capacity, device=dev) < active,
            assignment_status=torch.ones(capacity, dtype=torch.int32,
                                         device=dev))
        state0 = DeviceState.empty(capacity, device=dev)
        rules = RuleTable.empty(max(1, rules_capacity), device=dev)
        zones = ZoneTable.empty(max(1, zones_capacity),
                                max_verts=max(3, zone_verts), device=dev)
        rng = np.random.default_rng(0)
        batch = EventBatch.empty(width, device=dev).replace(
            valid=torch.ones(width, dtype=torch.bool, device=dev),
            device_id=torch.from_numpy(
                rng.integers(0, active, width).astype(np.int32)).to(dev),
            ts_s=torch.full((width,), 1_753_800_000, dtype=torch.int32,
                            device=dev),
            value=torch.from_numpy(
                rng.uniform(0, 100, width).astype(np.float32)).to(dev),
            update_state=torch.ones(width, dtype=torch.bool, device=dev),
        )

    def pb(i: int) -> EventBatch:
        # perturb by the loop index, as the reference's chains do, so no
        # two launches of a stage see the same rows
        return batch.replace(
            device_id=(batch.device_id + i) % active,
            ts_s=batch.ts_s + i,
            value=batch.value + float(i) * 1e-6,
        )

    def b_validate(i, carry):
        a, _, _, e = validate_and_enrich(registry, pb(i))
        return carry + a.sum(dtype=torch.int32) + e["area_id"].sum()

    def b_rules(i, carry):
        st, acc = carry
        bt = pb(i)
        a, _, _, _ = validate_and_enrich(registry, bt)
        f, rid, ew = eval_threshold_rules(rules, st, bt, a)
        return (st, acc + f.sum(dtype=torch.int32) + rid.sum()
                + ew.sum().to(torch.int32))

    def b_zones(i, carry):
        bt = pb(i)
        a, _, _, e = validate_and_enrich(registry, bt)
        f, zid = eval_zone_rules(zones, bt, a, e["area_id"])
        return carry + f.sum(dtype=torch.int32) + zid.sum()

    def b_state(i, carry):
        st, acc = carry
        bt = pb(i)
        st2, present = update_device_state(st, bt, bt.valid)
        return (st2, acc + st2.last_event_ts_s.sum()
                + present.sum(dtype=torch.int32))

    def b_full(i, carry):
        st, acc = carry
        st2, out = pipeline_step(registry, st, rules, zones, pb(i))
        return (st2, acc + out.metrics.accepted + out.rule_id.sum()
                + out.zone_id.sum() + out.assignment_id.sum()
                + out.derived_alerts.alert_code.sum()
                + out.present_now.sum(dtype=torch.int32))

    def zero():
        return torch.zeros((), dtype=torch.int32, device=dev)

    probes = {
        "validate": (b_validate, lambda: zero()),
        "rules": (b_rules, lambda: (state0, zero())),
        "zones": (b_zones, lambda: zero()),
        "state": (b_state, lambda: (state0, zero())),
        "full": (b_full, lambda: (state0, zero())),
    }

    def run(body, carry):
        for i in range(iters):
            carry = body(i, carry)
        return carry

    def stage_samples(body, carry0):
        samples = []
        with on_stream():
            run(body, carry0())   # warm-up: allocator, kernel loads
            for _ in range(repeats):
                if on_card:
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record(stream)
                    run(body, carry0())
                    end.record(stream)
                    end.synchronize()
                    samples.append(start.elapsed_time(end) / iters)
                else:
                    t0 = time.perf_counter()
                    run(body, carry0())
                    samples.append((time.perf_counter() - t0) / iters * 1e3)
        return samples

    result: Dict[str, object] = {"width": width, "iters": iters,
                                 "repeats": repeats}
    for stage, (body, carry0) in probes.items():
        samples = stage_samples(body, carry0)
        result[f"{stage}_ms"] = round(float(np.median(samples)), 4)
        if metrics is not None:
            hist = metrics.histogram(f"device.stage_ms.{stage}",
                                     buckets=DEVICE_STAGE_MS_BUCKETS)
            for s in samples:
                hist.observe(s)
    result["host_rtt_ms"] = round(measure_rtt(device=dev) * 1e3, 4)
    if result.get("full_ms"):
        result["device_events_per_s"] = round(
            width / float(result["full_ms"]) * 1e3, 1)
    return result


class ProfilerCapture:
    """One ``torch.profiler`` capture into ``trace_dir``, started and
    stopped on a thread of its own.

    torch's profiler session belongs to the thread that starts it: a stop
    from another thread finds no session, and writing the trace then
    crashes the process.  REST start and stop arrive on two request
    threads, so a capture thread owns the session and the callers hand it
    their requests.  Where the installed torch has ``profile_all_threads``
    the session records every thread's host ops; on a card the kernels
    come from the CUDA activity trace, whichever thread launched them.
    A stop that fails leaves the capture running, so it can be retried."""

    # seconds to wait for the capture thread to start the session, and
    # to stop it and write the trace; past them the caller gets an error
    # naming the wait (the thread, a daemon, is left to finish or hang)
    START_TIMEOUT_S = 120.0
    STOP_TIMEOUT_S = 600.0

    def __init__(self, trace_dir: str, cuda: bool):
        self.trace_dir = trace_dir
        self._cuda = cuda
        self._requests: "queue.Queue[str]" = queue.Queue()
        self._replies: "queue.Queue[Optional[BaseException]]" = queue.Queue()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="profiler-capture")
        self._thread.start()
        err = self._reply("start", self.START_TIMEOUT_S)
        if err is not None:
            self._thread.join(self.START_TIMEOUT_S)
            raise err

    def _reply(self, what: str, timeout_s: float) -> Optional[BaseException]:
        try:
            return self._replies.get(timeout=timeout_s)
        except queue.Empty:
            raise TimeoutError(
                f"profiler capture: the capture thread did not {what} the "
                f"session within {timeout_s:.0f} s") from None

    def _profile(self):
        import torch.profiler as tp

        activities = [tp.ProfilerActivity.CPU]
        if self._cuda:
            activities.append(tp.ProfilerActivity.CUDA)
        kw = {}
        try:
            from torch._C._profiler import _ExperimentalConfig

            kw["experimental_config"] = _ExperimentalConfig(
                profile_all_threads=True)
        except (ImportError, TypeError):
            pass    # an older torch: the capture thread's own host ops
        return tp.profile(
            activities=activities,
            on_trace_ready=tp.tensorboard_trace_handler(self.trace_dir),
            **kw)

    def _stop(self, prof) -> None:
        prof.stop()

    def _run(self) -> None:
        try:
            prof = self._profile()
            prof.start()
        except Exception as e:
            self._replies.put(e)
            return
        self._replies.put(None)
        while True:
            self._requests.get()
            try:
                self._stop(prof)
            except Exception as e:
                self._replies.put(e)
                continue
            self._replies.put(None)
            return

    def stop(self) -> None:
        """Stop the capture and write its trace (raises if that fails;
        the capture then keeps running)."""
        self._requests.put("stop")
        err = self._reply("stop", self.STOP_TIMEOUT_S)
        if err is not None:
            raise err
        self._thread.join(self.STOP_TIMEOUT_S)


__all__ = [
    "DEVICE_STAGES", "DEVICE_STAGE_MS_BUCKETS", "ProfilerCapture",
    "measure_rtt", "profile_device_stages",
]
