#!/usr/bin/env python3
"""Drive the PyTorch port (``sitewhere_tpu_torch``) on one CUDA card.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, each printing one JSON line; any failed check raises and the
script exits non-zero without printing a result:

1. the card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build the geofence kernel (``csrc/pip_kernel.cu``) with ``nvcc`` and,
   at the same time, the native wire tier's C scanners
   (``native/swwire.c``) with ``cc``;
3. hold the kernel against its plain PyTorch version, bitwise, at the main
   path's shape (B=131072 points, Z=512 zones, V=16) and at edge shapes,
   and time both with CUDA events;
4. the main path at full size: a registry of 2^20 slots with 1,000,000
   assigned devices over 8 tenants, 64 rules, 512 zones, batches of
   131072 events, rings of K=8 through ``runtime/ring.py``; events/s,
   ms per ring, host syncs per batch, and the kernel's launch count;
5. one ring rerun from the same carry with the plain geofence: every
   output and the new carry must be identical;
6. the dispatcher's wire path (``dispatcher_wire``) on the same
   deployment, written through ``RegistryMirror`` and ``RuleManager``:
   NDJSON bytes -> journal -> native decode -> batcher -> step -> egress
   -> offset commit.  First the proof that the native tier is on the
   path (run ``native``): the scanner library's path and build seconds,
   ``native.build_fallbacks`` 0, and on one full-size payload of each
   kind the C lane (fill-direct into a reservation for measurements,
   the event-family scanner for the 60/30/10 mix) equal, column for
   column, to the pure-Python decode of the same bytes, with each lane's
   ms per payload.  Then full-width payloads (131072 lines, 60/30/10
   measurements/locations/alerts), 3 rings' worth, at the deployment's
   5 ms batcher deadline with the ring at K=8 and with it off: events/s,
   latency per plan from the payload's receipt (before its decode) to
   egress, p50 and max, host ms per stage, bytes copied per event by
   decode and batch, host syncs per batch, and the summed CUDA-event
   span of the card's steps.  Then a diagnostic run with a 60 s deadline,
   where the ring forms; the same 5 ms ring-off run over measurement-only
   payloads (fill-direct, every plan adopted); a paced region at width
   4096 (deadline 3.5 ms, 50% of the measured capacity, latency from each
   payload's scheduled arrival); and short profiled reruns for the card's
   busy share.  Checks: kernel launches == dispatcher steps, accepted
   rows == registered lines + derived alerts, committed offset == journal
   records; in the diagnostic run, host syncs per batch == 1/8 over the
   ring's steps and the last dispatched ring rerun with the plain
   geofence from its carry, bitwise; in the measurement-only run, adopted
   plans == full-width measurement plans and 0 bytes copied per event by
   decode and batch;
7. persistence and restart through the port ``Instance`` (phase
   ``persist_recover``), its segment store and journal at the Config
   defaults (registration composed, with no default device type, so
   rows of unknown devices are re-decoded and rejected, as in the
   reference), under a temporary directory that is removed afterwards.
   ``persist_throughput``: the same two kinds of full-width payloads (the
   first 8 of each),
   ring off at 5 ms, with the real store: events/s, latency, persist ms
   per plan, ``flush`` ms per commit, segments sealed, bytes on disk and
   the step span; checks: rows stored == rows accepted (registered lines
   + derived alerts), committed offset == journal records, and after
   ``stop()`` the stored rows equal the accepted rows exactly once (an
   order-independent checksum).  ``checkpoint_full``: one save of the
   loaded instance and a restore into a fresh one, seconds and bytes per
   section; check: the restored state bitwise equal to the saved.
   ``kill_recover``: golden children and one child per crash point
   (``crash.mid_egress`` at full size; ``crash.mid_ring``,
   ``crash.post_journal``, ``crash.mid_seal`` and ``crash.pre_manifest``
   at 2^16 slots, 50,000 devices, width 4096) run measurement payloads
   with a checkpoint every 8, the killed ones under
   ``SW_CRASHPOINT=<point>:<n>``; a fresh process restarts on each
   survivor's directory and completes the workload; checks: no journaled
   row lost, rows below the committed offset at the kill stored once,
   the device state equal to the golden run's (ints exact, EWMA within 4
   ULPs of the value scale, other floats bitwise), kernel launches ==
   steps; reports the boot, restore, warm-up and replay seconds;
8. bring-your-own rule programs (phase ``byo_rules``).  ``rules_engine``:
   a ``RuleEngineRunner`` at the deployment's size (2^20 slots, 8
   measurement slots, K=3) with 4 programs of each of the five structure
   keys (c2p4, c2p4g, c4p4, c4p4g, c4p8) for each of the 8 world
   tenants, set to fire on about 1% of rows, the device ``tier`` of
   every active device and the ``grade`` of every asset, and a
   population of 20,000 programs from ``tools/rulebench.py``'s mix over
   5,000 more tenants; 24 full-width 60/30/10 batches straight into
   ``_eval_batch``: ms per batch of the prepare pass and of each group
   pass (CUDA events), each pass's transient peak, engine events/s, and
   6 more under the profiler for the card's busy share; checks at 8192
   rows, the passes on the card against the port's CPU run from the same
   trail (fired/code/level/pid and trail ints exact, EWMA within 4 ULPs
   of the value scale, rate within 4 ULPs), and at 2048 rows the card's
   alerts against the port's numpy ``interp``.  ``rules_wire``: the
   60/30/10 payloads through the port ``Instance`` as in
   ``persist_throughput``, without programs and with them (the default
   tenant's 20, the population, the attributes): events/s, latency, the
   step span and the ``rules.*`` metrics; checks: every program alert
   the engine injected is stored exactly once, stored = accepted
   (registered lines + derived alerts, program alerts among them);
   ``checkpoint_full`` with the ``rule-programs`` section: programs and
   attributes come back as saved;
9. streaming analytics (phase ``streaming_analytics``), four queries: a
   60 s tumbling mean, a 60 s x 4 sliding max, a count >= 3 session with
   a 120 s gap, and a window-mean cross then an alert within 60 s, with
   thresholds where about 1% of windows match; event time advances at
   one report per device per 60 s and values lie on a 1/8 grid.
   ``analytics_engine``: a ``QueryRunner`` at the deployment's size
   (2^20 slots, 1,000,000 devices), 24 full-width batches straight into
   ``_eval_batch``: card ms per batch of each query (CUDA events) beside
   its HBM bound, CEP passes, host copies and transient peak per batch,
   state bytes, events/s, and the busy share under the profiler;
   ``card_vs_cpu``: 8192 rows in two batches through the four queries on
   the card and on the CPU, matches and state bitwise equal;
   ``analytics_wire``: rules_wire.on's run with the four queries
   registered, on payloads of the same shape regenerated with this
   phase's event time: the ``analytics.*`` metrics, and every query's
   live matches equal to ``run_retrospective`` over the sealed store
   (``analytics.live_dropped`` must be 0); ``checkpoint_full.analytics``:
   the operator state restored bitwise;
10. the device system of record, auto-registration and command delivery
   (phase ``device_services``): the wire world restored into an
   ``Instance`` with ``registration.default_device_type: sensor``; device
   types ``sensor`` and ``gateway`` with the commands ``ping`` and
   ``set-rate``, 1,000 assets and 20,000 devices ``c-*`` (every 20th a
   gateway) with their assignments, created through ``DeviceManagement``
   (us per call); then ``device_services_wire``: the first 8 of
   dispatcher_wire's 60/30/10 payloads (0.5% of lines from unknown
   ``x-*`` tokens, every 100th registered line from a ``c-*`` device, 64
   NDJSON command lines of ``c-*`` sensors in every third payload) while
   1,000 ``create_command_invocation`` calls, to the first 1,000 ``c-*``
   devices, arrive at 2,000/s on one thread and are served by 32 handler
   threads;
   sensors' commands go to a callback with the binary encoder, gateways'
   to an HTTP gateway on 127.0.0.1 with the JSON encoder.  Reports
   events/s, latency, the step span, ``egress.registration`` and
   ``egress.commands`` ms per plan, invocation-to-delivery p50 and p99,
   registry republishes and repacks with their ms (the dispatcher's
   ``pipeline.*_s`` timers), the replays beyond the ghost lines and the
   stored rows per sent line of the ``c-*`` devices (the reference's
   straddled-payload duplicates) and
   the log records (the reference logs each failed registration with
   its traceback).  Checks: every distinct ghost registered once with
   one active assignment and an active mirror row of tenant 0, every
   ghost line stored, stored == accepted, every invocation delivered
   exactly once with its encoding, each NDJSON command line dead-lettered
   once as ``undeliverable-invocation``, ``commands`` == stored command
   rows, kernel launches == steps.  ``checkpoint_full.stores``: save,
   restore into a fresh instance; devices, assignments, device types and
   commands, assets equal, the mirror bitwise;
11. device-fault containment and the control plane (phase
   ``control_plane``).  ``devfault``: ``tools/torch_devfault_bench.py``'s
   five phases on the card at width 64 (a chain fault re-parked and
   re-dispatched with the epoch bitwise kept and the state bitwise a
   fault-free run's; the breaker's ladder, whose FALLBACK level fails
   closed on the card: a child process demoted past it must exit with the
   dispatcher's STICKY_EXIT_CODE and a restart must store every row it
   journaled, ``cpu_fallback_steps`` 0 here as everywhere; poison
   rows bisected to ``device-poison`` letters; their requeue into one
   quarantine STATE_CHANGE; the watchdog's soft, hard and recovered
   transitions), then every clean subset of a width-64 bisection stepped
   again by the port on the CPU, bitwise.  ``containment_full``: an
   ``Instance`` at the deployment's size with ring K=8 (the ladder off:
   every row counts) takes a fault at slot 3 of a chain and then one NaN
   row with a NaN-triggered device fault: re-dispatches, bisect rounds,
   launches and ms, the kernel against its plain version on every clean
   subset, one subset stepped again on the CPU, stored == sent - poison.
   ``sticky_child``: a ``--kill-child`` process whose step triggers a real
   device-side assert must exit with the dispatcher's STICKY_EXIT_CODE,
   dead-letter nothing and never step on the CPU; a fresh child recovers
   every sent row.  ``overload``: the paced region (width 4096, 3.5 ms)
   through an ``Instance`` with the ladder, metering, the SLO engine and
   the flight recorder at their defaults, over the deployment's registry
   spread over 8 tenants (the default tenant noisy, 4 of every
   11 payloads, each payload a tenant's, through ``ingest_many``): a
   burst measures the sustained rate, then regions at 50% and 200% of it;
   transitions, sheds by class and tenant, Retry-After, each tenant's
   billed rows against its stored rows (exact), a quota tenant throttled
   in the rule engine and refused at the program-write gate, SLO alerts,
   flight-recorder dumps and bytes, host syncs per batch with metering
   on and off (equal), the ``tenant-metering`` section saved and
   restored;
12. the ingest sources (phase ``ingest_sources``), declared in the
   ``Instance`` config's ``sources`` section and built through
   ``ingest/factory.py build_sources``, over the world checkpoint that
   device_services used (2^20 slots, 1,000,000 devices, width 131072, 5
   ms, ring off).  ``sources_wire``: one TCP source (length framing,
   ``raw_wire``, decoder json); one sender connection sends 4 full-width
   60/30/10 payloads, each as two frames of 65536 lines (a whole one
   passes the receiver's 16 MiB frame cap), and 4 measurement-only ones,
   each payload's devices distinct and disjoint from its neighbours'
   (so the device state cannot depend on where the deadline cuts
   plans), into a fresh ``Instance`` with ``ingest.decode_workers`` 2
   (the decode pool) and again with 0 (synchronous): events/s from the
   first byte sent to ``flush()``, latency per plan, the pool's jobs,
   its depth and the ``decode_backlog`` signal's maximum, host ms per
   stage, adopted plans; checks: the two runs store the same rows and
   end in bitwise equal device state, committed offset == journal
   records == frames, kernel launches == steps, ``native.build_fallbacks``
   0, every frame a pool job and ``decode_backlog`` > 0 in the pooled
   run.  ``sources_protocols``: one ``Instance`` (pool at its default,
   2 workers) with a UDP (64 datagrams of 256 lines), an HTTP (16 POSTs
   of 4096), a hosted MQTT broker (16 QoS-1 publishes of 4096 from the
   port's ``MqttClient``), a CoAP (64 CON POSTs of 64) and a TCP source
   (decoder ``jsonlines``, dedup at its default 2^20 window, 16 payloads
   of 16384 lines with unique alternateIds, then 4 of them again);
   payloads, rows stored, shed and failed counts and ms per payload by
   source; checks: every line stored once, the 65,536 resent lines
   refused as duplicates, ack-gated receivers (HTTP, MQTT broker, CoAP)
   never through the pool, launches == steps.  ``sources_restart``:
   after ``stop()`` a fresh ``Instance`` on the same directory restores
   the ``runtime`` section (its bytes, save and restore ms), re-seeds
   the dedup window through ``add_source`` and refuses the same 4
   resent payloads, all 65,536 lines, storing nothing twice;
13. outbound, search, presence and device streams (phase
   ``outbound_presence``), over the same world checkpoint.
   ``outbound_wire``: 8 mixed and 8 measurement-only payloads of 131072
   lines (each payload's devices a block of a permutation of the fleet,
   as in ``sources_wire``) through ``ingest_wire_lines`` into a fresh
   ``Instance`` with one window query (m0, 1 s mean over 99), ``off``
   with no connectors and ``on`` with six: ``tap`` (a callback keeping
   every row's columns), ``alerts`` (ALERT rows as JSON lines, priority),
   ``webhook`` (HTTP to a loopback ``ThreadingHTTPServer``, 4,096
   devices), ``index`` (bulk pushes of 500 rows or 0.5 s, the same
   devices), ``mqtt`` (the port's ``MqttClient`` into its hosted
   ``MqttBroker``, routed by device type, 1,024 devices, a subscriber
   counting) and ``dead`` (HTTP to a path answering 500, with a circuit
   breaker and the instance's dead letters); the runs drain the
   dispatcher, the runner and the connectors before anything stops.
   Reports events/s of both, ``egress.outbound`` ms per plan, the ack
   latency's p50 and p99 bucket bounds, each connector's ingest-to-ack
   gauge, processed, errors, dropped and shed, and the rows/s of each
   row-by-row connector.  Checks: the tap's rows equal the stored rows
   (``row_checksum``) with no batch dropped, its STATE_CHANGE rows equal
   the query's live matches; the alerts file equals ``marshal_row`` over
   the stored ALERT rows, the webhook's and the MQTT subscriber's
   deliveries the stored rows of their devices, each once (the index's
   after the final flush at ``stop()``); ``dead`` alone counts errors,
   its breaker sheds rows into ``connector-shed`` letters;
   ``outbound_rows`` equals the rows offered times the connectors;
   ``off`` and ``on`` end in bitwise equal device state; launches ==
   steps.  ``outbound_shed``: a fresh instance with the ladder forced to
   SHEDDING takes a 4096-line ALERT payload: only the priority
   connector receives rows, each other's ``outbound.overload_shed.<id>``
   grows by the plans offered.  ``presence``, on the ``on`` instance:
   the missing and seen scans against the store (ms each); one sweep
   with the clock injected (card ms beside its byte bound, the repack
   it forces, host ms), whose STATE_CHANGE rows mark exactly the devices
   with events, re-enter, are stored once and reach the tap, leaving
   every other state field bitwise unchanged; a second sweep marks none;
   one payload re-arms exactly its devices; then the sweep thread
   (0.25 s, an injected clock whose cut lies inside the payloads' event
   times) beside 4 payloads: every flagged device stale for the sweep
   that flagged it, every STATE_CHANGE row stored once.  ``search``: the
   local provider against the store for 64 sampled devices, paged, and a
   federated provider over two local legs against the numpy merge (ms
   per query).  ``streams``: 16 DM-made devices each create a stream
   over the dispatcher's host plane, send 64 chunks of 64 KiB out of
   order and ask for 4 back; contents exact, send-backs exact, a chunk
   for an unknown stream dead-lettered as ``failed-stream-request`` and
   replayed by ``requeue_dead_letter`` once the stream exists;
14. tenant engines, users and tokens, scripts, labels, schedules and
   batch operations (phase ``tenant_engines``), over a world of the
   deployment's size whose 1,000,000 devices spread over 8 tenants
   (``tenant_token``), ring off at 5 ms.  ``engines``: an ``Instance``
   bootstrapped from an ``InstanceTemplate`` (an admin, an operator, the
   8 tenants, a dataset initializer), two config-declared TCP sources
   (decoder ``te-ndjson``, a script uploaded before ``start()``, and
   ``jsonlines``); each tenant's engine makes 2,500 devices through its
   own ``DeviceManagement`` (us per device); 8 full-width 60/30/10
   payloads of pre-resolved columns, each a block of a permutation of
   all 1,020,000 devices with every row stamped with its device's tenant
   (``ingest_arrays``, the reference's multitenant intake), while tenant
   ``t-3``'s engine restarts on a thread between payloads 3 and 4, then
   2 full-width NDJSON payloads of the default tenant's devices through
   ``ingest_wire_lines`` (the wire lane lands its rows in the default
   tenant); 64 rows stamped ``t-5`` for devices of ``t-3``; a cron
   schedule fired on demand with one ``CommandInvocation`` job and a
   ``BatchCommandInvocation`` over 1,024 devices, delivered to a
   callback; 4,096 PNG labels alone and beside the device streams of
   phase 13; one 4,096-line payload through each TCP source.  Reports
   events/s, latency p50 and max, the restart's ms, batch elements/s,
   labels/s alone and beside the streams.  Checks: launches == steps,
   the first plan rerun from its carry with the plain geofence bitwise;
   per tenant, stored rows == lines sent + derived alerts == the tenant
   block's accepted rows; ``t-3``'s devices all found after its
   restart; the mismatch rows processed, none accepted; the scheduled
   invocation and each batch element delivered once; every label decodes
   (``png.read_png_size``, ``qr.decode_matrix``) to its device's URL;
   the scripted source stores the jsonlines source's rows (their decoded
   and registry columns; the derived alerts and the receive time differ
   between the two copies).
   ``restart``: after ``stop()`` a new ``Instance`` on the directory,
   the ladder on: users, tenants, each engine's devices and assignments,
   schedules, jobs and batch operations equal, ``bootstrapped`` and the
   initializer not run again, ``topology()`` with the engine manager
   started and its 8 engines started, labels refused at SHEDDING;
15. the REST/WS gateway and device-stage telemetry (phase
   ``rest_gateway``), over the one-tenant world checkpoint of phases
   10-13: an ``Instance`` and a ``WebServer`` on 127.0.0.1 port 0; a JWT
   login as the template's admin; a device type, 256 devices and their
   assignments made over REST (us per device), and one small GET timed
   over a kept-alive connection and over fresh ones; 1,024 event POSTs
   (60/30/10 measurements, locations and alerts to
   ``/api/assignments/{token}/{kind}``, each a ``DecodedRequest`` that
   ``dispatcher.ingest`` queues and ``flush()`` steps at full width) from
   8 client threads: POSTs/s, POST latency p50, p99 and max, steps,
   kernel launches, store seals on the POST path.  Checks: every answer
   2xx, steps == launches, stored rows == 2xx answers by kind (no derived
   alert: values in the band where no rule fires, locations north of
   every zone), 16 assignments' measurements read back over REST equal to
   what was sent and their ``/api/devicestates/{token}`` equal to the
   newest stored rows.  ``geofence``: one location inside zone 0 and one
   outside, each step captured and rerun from its carry with the plain
   geofence, bitwise; one derived zone alert for the inside POST, none for
   the outside one, the state holding each location.
   ``device_profile``: ``POST /api/instance/profile/device`` (admin) at
   width 131072 with the world's 64 rules and 512 zones of 16 vertices:
   each stage's ms beside the kernel's own, the watchdog's budgets and
   trips before and after; checks: the kernel launched by the zones and
   full stages only, each stage's ``device.stage_ms`` histogram in
   ``/api/instance/metrics.prom`` (read unauthenticated, parsed with
   ``parse_exposition``) holding the profile's samples.  ``capture``:
   ``POST /api/instance/profile/xla`` start and stop from two threads
   around 8 POSTs: the trace directory holds a non-empty trace naming
   ``pip_parity_kernel``.  ``topology``: ``/ws/topology`` sends its
   greeting snapshot and one broadcast; ``openapi.json`` lists 132
   routes;
16. the sharded pipeline at 8 shards on the one card (phase
   ``sharded_mesh``; 16384 batch rows and 131072 registry rows per
   shard): ``kernel_per_shard``, the kernel at B=16384 against the plain
   version and its bound (added to the kernels record as ``per_shard``);
   ``mesh_chain``, shard-block-ordered 60/30/10 rings over the main
   path's world through the sharded K=8 chain, the sharded single step
   and the unsharded chain from the same empty carry: events/s, ms per
   ring, host syncs per batch, launches; checks: every output row, the
   metrics and the final carry bitwise equal across the three, host
   syncs 1/8 on the chain, launches == steps x 8 on the sharded paths,
   the chain's last ring rerun from its carry with the plain geofence
   bitwise.  ``mesh_instance.wire``: the world checkpoint restored into
   an ``Instance`` with ``n_shards: 8`` (re-placed on the mesh), 8 mixed
   payloads, ring off at 5 ms, through the batcher's counted gather
   lane, then ``checkpoint_full`` (the restored state on 8 shards,
   bitwise the saved one); checks as ``persist_throughput``'s, launches
   == steps x 8.  ``mesh_instance.fill_direct``: 8 segment-ordered
   full-width reservations at K=8 (``bench.py:979-995``): every plan
   adopted, ``pipeline.bytes_copied.batch`` 0, one host sync, launches
   == steps x 8.  ``shard_containment``: the devfault bench's phase at 8
   shards (width 128, 64 devices, K=2): only shard 2 demotes, the poison
   rows dead-letter, every clean row stored once, shard 2 at FALLBACK
   side-steps through the mesh with no CPU step and no exit.
   ``sharded_analytics``: ``build_window_grid_sharded`` over 1,000,000
   devices and 2^22 events against the unsharded grid: counts exact,
   means and variances within the reference test's bounds;
17. a small input run on the card and on the CPU: identical int outputs.

Every ``Instance`` run before ``control_plane`` turns the overload
ladder and the SLO engine off (``instance_config``), as the reference's
zero-loss benches do; the ``guards`` line sums each phase's
``device.fault.*`` counters (``cpu_fallback_steps`` must be 0 in every
one: on the card no step runs on the CPU).

Every log record of the run goes to a file under the build directory
(removed at the end); the ``done`` line counts them by logger and level.
The line before the last is the card's ``nvidia-smi`` name and power
limit; before it, the kernels' JSON record.  The last line is
``{"ok": true, "device": {...}}``.  Without a CUDA card the script exits
non-zero and prints no result.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import functools
import json
import math
import os
import shutil
import signal
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W).  The 67
# TFLOP/s float32 rate counts an FMA as two operations: an instruction
# that is not an FMA (the kernel, built with -fmad=false, issues none) runs
# at half of it.  The INT32/logic units issue at half the FP32 lanes' rate.
PEAK_FP32_INSTR = 67e12 / 2  # float32 instructions/s
PEAK_INT32_INSTR = PEAK_FP32_INSTR / 2
PEAK_HBM_BYTES = 3.35e12     # bytes/s

FULL_B, FULL_Z, FULL_V = 131072, 512, 16
CAPACITY, N_ACTIVE, N_TENANTS = 1 << 20, 1_000_000, 8
M_SLOTS, K_SCALES, N_RULES = 8, 3, 64
RING_K, TIMED_RINGS = 8, 16
SEED = 20261016
# the wire path (phase dispatcher_wire)
# full-width payloads: 2 rings at K=8 (3 until the sharded_mesh phase
# came: the script's time limit)
WIRE_PAYLOADS = 2 * RING_K
# The Instance's 60/30/10 wire runs of persist_recover and byo_rules take
# the first half ring of those payloads, streaming_analytics a ring of its
# own: with registration composed each runs at 27k-47k events/s, and with
# 16 (24 for analytics_wire) the whole script took 1,195.6 s of its 1,200
# on a slow H100 host once tenant_engines joined it; with 8 (until the
# sharded_mesh phase came) 1,161.2 s on another
INSTANCE_WIRE_PAYLOADS = RING_K // 2
AN_WIRE_PAYLOADS = RING_K
WIRE_GHOSTS = 0.005               # share of lines from unregistered tokens
# The deployment's batcher deadline (README.md:99-105).  A ring lingers
# one deadline at most, and even the native decode takes far longer than
# that for K full payloads, so at this deadline every ring drains
# single-step.
WIRE_DEADLINE_MS = 5.0
# Diagnostic only, not the deployment: a deadline long enough for K
# payloads to decode, so the ring forms and its checks run.
RING_DIAG_DEADLINE_MS = 60_000.0
PACED_WIDTH, PACED_LINES, PACED_DEADLINE_MS = 4096, 1024, 3.5
PACED_PAYLOADS, PACED_BURST, PACED_UTIL = 128, 32, 0.5
# payloads of the profiled reruns (the card's kernel and copy time)
PROFILED_PAYLOADS, PROFILED_PACED = RING_K, 32
WIRE_TS0_MS = 1_700_000_000_000
WIRE_STAGES = ("decode", "batch", "dispatch", "ring_dispatch", "egress")
# Measurement values of the measurement-only run: a band where no rule of
# the world fires (instant rules sit below 0.1 and above 99.9, window
# means above 99, rates above 95/s; a 20-wide band over >= 0.25 s gaps
# stays under 80/s), so no derived-alert rows join the batcher between
# the payloads and every full-width payload can be adopted as its plan.
MEAS_VALUE_BAND = (20.0, 40.0)
# bring-your-own rule programs (phase byo_rules): every world tenant holds
# RULE_PER_KEY programs of each structure key RULEBENCH_r01.json lists,
# which fills every group's S = 4 slots for every row; on top, a
# population from tools/rulebench.py's mix, cut from that tool's 100,000
# programs over 25,000 tenants
RULE_KEYS = ("c2p4", "c2p4g", "c4p4", "c4p4g", "c4p8")
RULE_PER_KEY = 4
RULE_POP_PROGRAMS, RULE_POP_TENANTS = 20_000, 5_000
RULE_ASSET_CAPACITY = 8192        # the world's 5000 assets, pow2
RULE_BATCHES, RULE_PROFILED = 24, 6
RULE_CPU_ROWS, RULE_INTERP_ROWS = 8192, 2048
# the share of traffic rows the world programs fire on (the wire world's
# built-in derived-alert rate is 1.1%): a geofence square's side is
# sqrt(RULE_SQUARE_SHARE) of the traffic's box
RULE_SQUARE_SHARE = 0.0011
RATE_MAX_ULP = 4.0
# streaming analytics (phase streaming_analytics): event time advances at
# the fleet's reporting rate, each device once per AN_REPORT_S on average,
# so a full-width batch spans FULL_B / N_ACTIVE * AN_REPORT_S seconds
AN_REPORT_S = 60.0
AN_BATCHES, AN_PROFILED = 24, 4
AN_CPU_ROWS, AN_CPU_DEVICES = 8192, 4096
# values: a set point and signed deviations on a 1/8 grid (a sensor of
# 0.125 resolution), 50 +- 48: every window sum and sum of squares is exact
# in float32 whatever the order, and the world's instant rules (below 0.1,
# above 99.9) never fire
AN_SET_POINT, AN_SPREAD_EIGHTHS = 50.0, 384
# the cross feature's prefix sums stay exact while every |prefix| is under
# 2^21 (2^24 eighths); each generated batch is checked against it
AN_PREFIX_BOUND = float(1 << 21)
# thresholds where about 1% of windows match: a window's mean (mostly one
# sample) above 97.0 is 1.04% of a uniform 2..98; the trailing 4-hop max
# above 97.75 about 1% at ~4 samples
AN_QUERIES = (
    {"kind": "window", "name": "temp-mean", "mtype": "m0", "agg": "mean",
     "op": "gt", "threshold": 97.0, "windowS": 60},
    {"kind": "window", "name": "temp-max4", "mtype": "m0", "agg": "max",
     "op": "gt", "threshold": 97.75, "windowS": 60, "length": 4},
    {"kind": "session", "name": "burst", "gapS": 120, "agg": "count",
     "op": "gte", "threshold": 3.0},
    {"kind": "pattern", "name": "cross-alert", "windowS": 60,
     "crossOp": "gt", "crossThreshold": 97.0, "crossMtype": "m0",
     "steps": [{"windowCross": True},
               {"eventType": "alert", "withinS": 60}]},
)
# instructions per edge test in the kernel: float32 - 2 compares
# (straddle), sub, mul, add, 1 compare (px < x_cross); logic - the
# straddle xor and the and-xor into the parity
PIP_FLOAT_PER_TEST = 6
PIP_LOGIC_PER_TEST = 2


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


# the device guards' counters of every dispatcher a phase ran, summed by
# phase (``guard_counts``); main holds cpu_fallback_steps at 0 in every
# phase
GUARD_KEYS = ("cpu_fallback_steps", "watchdog_soft_trips",
              "watchdog_hard_trips", "chain_faults", "step_faults",
              "bisect_rounds", "poison_rows")
GUARDS = {}


def fault_counters(metrics):
    """The ``device.fault.*`` counters of one metrics registry."""
    c = metrics.snapshot()["counters"]
    return {k: int(c.get(f"device.fault.{k}", 0)) for k in GUARD_KEYS}


def add_guards(phase, counts):
    acc = GUARDS.setdefault(phase, dict.fromkeys(GUARD_KEYS, 0))
    for k in GUARD_KEYS:
        acc[k] += int(counts.get(k, 0))


def guard_counts(metrics, phase):
    """The ``device.fault.*`` counters of one run's metrics registry,
    added to ``GUARDS[phase]``; returns them for the run's record."""
    out = fault_counters(metrics)
    add_guards(phase, out)
    return out


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# -- inputs -------------------------------------------------------------------


def random_polygons(gen, z, v, lo, hi, rmin, rmax, device):
    """``z`` random convex polygons of 3..v vertices in the box
    ``[lo, hi]^2``, padded to ``v`` by repeating the last vertex."""
    import torch

    n = torch.randint(3, v + 1, (z,), generator=gen, device=device)
    ang = torch.sort(torch.rand((z, v), generator=gen, device=device)
                     * (2 * math.pi), dim=1).values
    keep = torch.minimum(torch.arange(v, device=device)[None, :], n[:, None] - 1)
    ang = torch.gather(ang, 1, keep)
    center = lo + (hi - lo) * torch.rand((z, 1, 2), generator=gen, device=device)
    radius = rmin + (rmax - rmin) * torch.rand((z, 1), generator=gen,
                                               device=device)
    ring = torch.stack([torch.cos(ang), torch.sin(ang)], dim=-1) * radius[..., None]
    return (center + ring).to(torch.float32).contiguous()


def edge_cases(gen, device):
    """(name, points, verts) shapes off the tile grid and edge geometry."""
    import torch

    cases = []
    pts = lambda b, lo, hi: (lo + (hi - lo) * torch.rand(  # noqa: E731
        (b, 2), generator=gen, device=device)).contiguous()
    cases.append(("B1000_Z130_V16", pts(1000, -60, 60),
                  random_polygons(gen, 130, 16, -50, 50, 1, 20, device)))
    cases.append(("B4097_Z1_V8", pts(4097, -30, 30),
                  random_polygons(gen, 1, 8, -5, 5, 10, 20, device)))
    cases.append(("B777_Z33_V32", pts(777, -60, 60),
                  random_polygons(gen, 33, 32, -50, 50, 1, 30, device)))
    cases.append(("B300_Z40_V40", pts(300, -60, 60),
                  random_polygons(gen, 40, 40, -50, 50, 1, 30, device)))
    cases.append(("B513_Z70_V3", pts(513, -60, 60),
                  random_polygons(gen, 70, 3, -50, 50, 5, 30, device)))
    # axis-aligned rectangles (horizontal edges), lattice points on their
    # edges and corners, V=5 (planes padded to 8)
    lo = torch.randint(-8, 8, (37, 2), generator=gen, device=device).float()
    size = torch.randint(1, 6, (37, 2), generator=gen, device=device).float()
    x0, y0 = lo[:, 0], lo[:, 1]
    x1, y1 = x0 + size[:, 0], y0 + size[:, 1]
    rect = torch.stack([torch.stack([x0, y0], -1), torch.stack([x1, y0], -1),
                        torch.stack([x1, y1], -1), torch.stack([x0, y1], -1),
                        torch.stack([x0, y1], -1)], dim=1)
    g = torch.arange(-10, 14.5, 0.5, device=device)
    lattice = torch.cartesian_prod(g, g).to(torch.float32).contiguous()
    cases.append(("rects_lattice_V5", lattice, rect.contiguous()))
    # padded degenerate (all-zero) zones among real ones, points at origin
    verts = random_polygons(gen, 64, 16, -20, 20, 1, 15, device)
    verts[::3] = 0.0
    p = pts(2000, -25, 25)
    p[:100] = 0.0
    cases.append(("degenerate_zones", p, verts))
    return cases


def make_world(device, capacity, n_active, n_rules, n_zones, n_verts, seed):
    """Registry, rules and zones of the main-path deployment, on device."""
    import torch

    from sitewhere_tpu_torch.schema import (
        AssignmentStatus, Registry, RuleTable, ZoneTable)

    gen = torch.Generator(device=device).manual_seed(seed)
    ids = torch.arange(capacity, dtype=torch.int32, device=device)
    on = ids < n_active
    null = torch.full_like(ids, -1)
    registry = Registry(
        active=on,
        tenant_id=torch.where(on, ids % N_TENANTS, null),
        device_type_id=torch.where(on, ids % 16, null),
        assignment_id=torch.where(on, ids, null),
        assignment_status=torch.where(
            on, int(AssignmentStatus.ACTIVE), int(AssignmentStatus.NONE)
        ).to(torch.int32),
        area_id=torch.where(on, ids % 64, null),
        customer_id=torch.where(on, ids % 1000, null),
        asset_id=torch.where(on, ids % 5000, null),
        epoch=torch.zeros((), dtype=torch.int32, device=device),
    )

    r = torch.arange(n_rules, dtype=torch.int32, device=device)
    kind = r % 3                       # INSTANT, WINDOW_MEAN, RATE_PER_S
    u = torch.rand(n_rules, generator=gen, device=device)
    threshold = torch.where(kind == 2, (u - 0.5) * 160.0, u * 100.0)
    rules = RuleTable(
        active=torch.ones(n_rules, dtype=torch.bool, device=device),
        tenant_id=torch.where(r % 2 == 0, -1, (r // 2) % N_TENANTS).to(torch.int32),
        mtype_id=torch.where(r % 4 == 1, -1, r % M_SLOTS).to(torch.int32),
        op=((r // 3) % 6).to(torch.int32),
        threshold=threshold.to(torch.float32),
        alert_code=1000 + r,
        alert_level=r % 4,
        kind=kind,
        window_idx=(r // 3) % K_SCALES,
        ewma_tau_s=torch.tensor([60.0, 600.0, 3600.0], device=device),
    )

    z = torch.arange(n_zones, dtype=torch.int32, device=device)
    zones = ZoneTable(
        active=torch.ones(n_zones, dtype=torch.bool, device=device),
        tenant_id=torch.where(z % 2 == 0, -1, z % N_TENANTS).to(torch.int32),
        area_id=torch.where(z % 4 == 3, z % 64, -1).to(torch.int32),
        verts=random_polygons(gen, n_zones, n_verts, -10, 10, 0.2, 3, device),
        nvert=torch.full((n_zones,), n_verts, dtype=torch.int32, device=device),
        condition=(z % 4 == 1).to(torch.int32),  # 1/4 ALERT_IF_OUTSIDE
        alert_code=2000 + z,
        alert_level=z % 4,
    )
    return registry, rules, zones


def make_batch_cols(rng, width, n_active, capacity, ts_s):
    """One batch of decoded host columns: ~60% measurements, 30% locations,
    10% alerts; a few invalid, unregistered, tenant-mismatched and NaN
    rows."""
    dev = rng.integers(0, n_active, width).astype(np.int32)
    unreg = rng.random(width) < 0.005
    dev[unreg] = rng.integers(n_active, capacity + 100, int(unreg.sum()))
    tenant = (dev % N_TENANTS).astype(np.int32)
    mism = rng.random(width) < 0.002
    tenant[mism] = (tenant[mism] + 1) % N_TENANTS
    etype = rng.choice(3, width, p=[0.6, 0.3, 0.1]).astype(np.int32)
    value = rng.uniform(0, 100, width).astype(np.float32)
    value[rng.random(width) < 0.0005] = np.nan
    return dict(
        valid=rng.random(width) < 0.998,
        device_id=dev,
        tenant_id=tenant,
        event_type=etype,
        ts_s=np.full(width, ts_s, np.int32),
        ts_ns=rng.integers(0, 1_000_000_000, width).astype(np.int32),
        mtype_id=rng.integers(0, M_SLOTS, width).astype(np.int32),
        value=value,
        lat=rng.uniform(-12, 12, width).astype(np.float32),
        lon=rng.uniform(-12, 12, width).astype(np.float32),
        elevation=rng.uniform(0, 100, width).astype(np.float32),
        alert_code=np.where(etype == 2, rng.integers(0, 20, width),
                            -1).astype(np.int32),
        alert_level=rng.integers(0, 4, width).astype(np.int32),
        command_id=np.full(width, -1, np.int32),
        payload_ref=np.arange(width, dtype=np.int32),
        update_state=np.ones(width, bool),
    )


def make_rings(n_rings, width, n_active, capacity, seed, ts0=1_700_000_000):
    from sitewhere_tpu_torch.pipeline.packed import pack_batch_host

    rng = np.random.default_rng(seed)
    rings = []
    for ring in range(n_rings):
        rings.append([pack_batch_host(
            make_batch_cols(rng, width, n_active, capacity,
                            ts0 + ring * RING_K + slot), width)
            for slot in range(RING_K)])
    return rings


# -- phases -------------------------------------------------------------------


def plain_chunked(points, verts, rows=8192):
    """The plain geofence in row chunks ([B, Z, V] is 4 GiB at full size)."""
    import torch

    from sitewhere_tpu_torch.ops.geo import points_in_polygons

    return torch.cat([points_in_polygons(points[i:i + rows], verts)
                      for i in range(0, points.shape[0], rows)])


def cuda_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def phase_kernel(device, geo_cuda):
    """Kernel vs plain, bitwise, at the full and the edge shapes."""
    import torch

    gen = torch.Generator(device=device).manual_seed(SEED)
    verts = random_polygons(gen, FULL_Z, FULL_V, -50, 50, 1, 20, device)
    points = (-60 + 120 * torch.rand((FULL_B, 2), generator=gen,
                                     device=device)).contiguous()
    got = geo_cuda.points_in_polygons_cuda(points, verts)
    ref = plain_chunked(points, verts)
    torch.cuda.synchronize()
    mismatches = int((got != ref).sum())
    check(mismatches == 0, f"kernel != plain at full shape: {mismatches}")
    check(bool(ref.any()) and not bool(ref.all()), "degenerate full case")
    edge = {}
    for name, p, v in edge_cases(gen, device):
        k, r = geo_cuda.points_in_polygons_cuda(p, v), plain_chunked(p, v)
        edge[name] = int((k != r).sum())
        check(edge[name] == 0, f"kernel != plain at {name}: {edge[name]}")

    # ``ms``: the kernel alone, on inputs laid out in advance;
    # ``wrapper_ms``: the wrapper's whole call (edge planes, point columns)
    px, py = points[:, 0].contiguous(), points[:, 1].contiguous()
    planes = geo_cuda.edge_planes(verts)
    out = torch.empty((FULL_B, FULL_Z), dtype=torch.bool, device=device)
    ms = cuda_ms(lambda: geo_cuda.launch_pip(px, py, planes, out), 50)
    check(torch.equal(out, ref), "timed launch != plain")
    wrapper_ms = cuda_ms(
        lambda: geo_cuda.points_in_polygons_cuda(points, verts), 50)
    plain_ms = cuda_ms(lambda: plain_chunked(points, verts), 3)
    tests = FULL_B * FULL_Z * FULL_V
    bytes_moved = FULL_B * 2 * 4 + 4 * FULL_V * FULL_Z * 4 + FULL_B * FULL_Z
    ops_ms = max(PIP_FLOAT_PER_TEST * tests / PEAK_FP32_INSTR,
                 PIP_LOGIC_PER_TEST * tests / PEAK_INT32_INSTR) * 1e3
    bytes_ms = bytes_moved / PEAK_HBM_BYTES * 1e3
    rec = {
        "name": "pip_parity", "route": "cuda",
        "source": "sitewhere_tpu_torch/csrc/pip_kernel.cu",
        "replaces": "sitewhere_tpu/ops/geo_pallas.py:41",
        "max_abs_err": float(mismatches), "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": None,
    }
    emit({"phase": "kernel_vs_plain", "shape": [FULL_B, FULL_Z, FULL_V],
          "mismatches": mismatches, "inside_share": float(ref.float().mean()),
          "edge_shapes": edge, "ms": ms, "wrapper_ms": wrapper_ms,
          "plain_ms": plain_ms,
          "bound_ms": rec["bound_ms"], "ops_bound_ms": ops_ms,
          "bytes_bound_ms": bytes_ms, "edge_tests": tests})
    return rec


def phase_main_path(device, geo_cuda):
    """The full-size ring loop, then one ring rerun with the plain
    geofence from the same carry."""
    import torch

    from sitewhere_tpu_torch.pipeline.packed import (
        BATCH_I, build_packed_chain, pack_tables, stage_packed_batch)
    from sitewhere_tpu_torch.runtime.ring import RingRunner
    from sitewhere_tpu_torch.state.manager import DeviceStateManager

    t0 = time.perf_counter()
    registry, rules, zones = make_world(device, CAPACITY, N_ACTIVE, N_RULES,
                                        FULL_Z, FULL_V, SEED + 1)
    tables = pack_tables(registry, rules, zones)
    mgr = DeviceStateManager(CAPACITY, num_mtype_slots=M_SLOTS,
                             num_ewma_scales=K_SCALES, device=device)
    runner = RingRunner(mgr, tables, RING_K)
    rings = make_rings(1 + TIMED_RINGS, FULL_B, N_ACTIVE, CAPACITY, SEED + 2)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    for view in runner.dispatch(rings[0]):      # warm-up ring
        view.metrics
    torch.cuda.synchronize()

    carry_before_last = None
    per_step = []
    geo_cuda.reset_launch_counts()
    t0 = time.perf_counter()
    for ring in rings[1:]:
        carry_before_last = mgr.current_packed
        views = runner.dispatch(ring)
        for view in views:
            m = view.metrics
            per_step.append((int(m.processed), int(m.accepted),
                             int(m.threshold_alerts), int(m.zone_alerts)))
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = geo_cuda.launch_counts["pip_parity"]

    n_steps = TIMED_RINGS * RING_K
    check(len(per_step) == n_steps, "missing step outputs")
    check(runner.host_syncs_per_batch == 1 / RING_K,
          f"host_syncs_per_batch {runner.host_syncs_per_batch}")
    check(launches == n_steps, f"kernel launched {launches}x in {n_steps} steps")
    processed = sum(s[0] for s in per_step)
    for (p, a, _, _), (bi, _) in zip(per_step, [b for r in rings[1:] for b in r]):
        check(p == int(bi[BATCH_I.index("valid")].sum()), "processed count")
        check(0 < a <= p, "accepted count")
    check(sum(s[2] for s in per_step) > 0, "no threshold alert fired")
    check(sum(s[3] for s in per_step) > 0, "no zone alert fired")
    # the carry is finite where it should be
    st = mgr.current
    check(bool(torch.isfinite(st.ewma_values).all()), "non-finite EWMA state")
    summary = mgr.summary()
    check(0 < summary["devices_with_state"] <= N_ACTIVE, "state summary")

    emit({"phase": "main_path", "capacity": CAPACITY, "active": N_ACTIVE,
          "rules": N_RULES, "zones": FULL_Z, "verts": FULL_V,
          "width": FULL_B, "ring_k": RING_K, "rings": TIMED_RINGS,
          "setup_s": setup_s, "elapsed_s": elapsed,
          "events_per_s": processed / elapsed,
          "ms_per_ring": elapsed / TIMED_RINGS * 1e3,
          "ms_per_step": elapsed / n_steps * 1e3,
          "host_syncs_per_batch": runner.host_syncs_per_batch,
          "pip_launches": launches,
          "processed": [s[0] for s in per_step],
          "accepted": [s[1] for s in per_step],
          "threshold_alerts": [s[2] for s in per_step],
          "zone_alerts": [s[3] for s in per_step],
          "summary": summary,
          "max_memory_gib": torch.cuda.max_memory_allocated() / 2**30})

    # -- the last ring again, from the same carry, with the plain geofence
    staged = [stage_packed_batch(bi, bf, device) for bi, bf in rings[-1]]
    plain_chain = build_packed_chain(RING_K, geofence=plain_chunked)
    ps, ois, mets, _ = plain_chain(tables, carry_before_last,
                                   *[s[0] for s in staged],
                                   *[s[1] for s in staged])
    kern = mgr.current_packed
    same_out = all(np.array_equal(v.oi, ois[i].cpu().numpy())
                   and np.array_equal(v.metrics_vector, mets[i].cpu().numpy())
                   for i, v in enumerate(views))
    same_state = (torch.equal(ps.si, kern.si) and torch.equal(ps.sf, kern.sf))
    check(same_out, "plain-geofence rerun: outputs differ")
    check(same_state, "plain-geofence rerun: carry differs")
    check(geo_cuda.launch_counts["pip_parity"] == launches,
          "plain rerun launched the kernel")
    emit({"phase": "plain_rerun", "identical_outputs": same_out,
          "identical_carry": same_state})
    return launches


# -- the wire path -------------------------------------------------------------


class CountingStore:
    """Event-store stand-in: counts accepted rows and reads the five
    enrichment columns, as the segment store's append does."""

    def __init__(self):
        self.rows = 0

    def append_columns(self, cols, mask=None):
        for name in ("device_type_id", "assignment_id", "area_id",
                     "customer_id", "asset_id"):
            cols[name]
        self.rows += int(mask.sum())

    def flush(self):
        pass


def make_wire_world(device):
    """The main-path deployment written through the port's services: 2^20
    registry slots with 1,000,000 assigned devices (one tenant: wire rows
    land in the default tenant), 64 rules and 512 zones of 16 vertices.
    Rule thresholds and zones sit where real alerts are rare."""
    from sitewhere_tpu_torch.ids import IdentityMap
    from sitewhere_tpu_torch.pipeline.rules import RuleManager
    from sitewhere_tpu_torch.services.device_management import (
        RegistryMirror)

    identity = IdentityMap()
    mirror = RegistryMirror(CAPACITY, max_zones=FULL_Z, max_verts=FULL_V,
                            device=device)
    rules = RuleManager(identity, capacity=N_RULES, device=device)
    populate_world(identity, mirror, rules, N_ACTIVE)
    return identity, mirror, rules


def tenant_token(k):
    """Tenant ``k`` of a multi-tenant world: 0 is the default tenant."""
    return "default" if k == 0 else f"t-{k}"


def populate_world(identity, mirror, rules, n_active, n_tenants=1):
    """Write the deployment's devices (``n_active`` of them), zones and
    rules into the given identity map, registry mirror and rule manager.
    Device ``d-i`` belongs to tenant ``i % n_tenants`` (``tenant_token``);
    with one tenant every device is the default tenant's."""
    import torch

    from sitewhere_tpu_torch.schema import (
        AssignmentStatus, ComparisonOp, RuleKind, ZoneCondition)

    for k in range(n_tenants):
        check(identity.tenant.mint(tenant_token(k)) == k,
              f"tenant {k} minted out of order")
    for m in range(M_SLOTS):
        identity.mtype.mint(f"m{m}")
    active = int(AssignmentStatus.ACTIVE)
    for i in range(n_active):
        d = identity.device.mint(f"d-{i}")
        mirror.set_device_row(
            d, active=True, tenant_id=i % n_tenants, device_type_id=i % 16,
            assignment_id=i, assignment_status=active, area_id=i % 64,
            customer_id=i % 1000, asset_id=i % 5000)
    gen = torch.Generator(device="cpu").manual_seed(SEED + 5)
    polys = random_polygons(gen, FULL_Z, FULL_V, -80, 80, 0.3, 2.0,
                            "cpu").numpy()
    for z in range(FULL_Z):
        mirror.set_zone_row(
            z, active=True, tenant_id=-1 if z % 2 else 0,
            area_id=z % 64 if z % 4 == 3 else -1, verts_lonlat=polys[z],
            condition=int(ZoneCondition.ALERT_IF_INSIDE),
            alert_code=identity.alert_type.mint(f"zone-{z % 8}"),
            alert_level=z % 4)
    for r in range(N_RULES):
        kind = (RuleKind.INSTANT, RuleKind.WINDOW_MEAN,
                RuleKind.RATE_PER_S)[r % 3]
        if kind == RuleKind.INSTANT:
            op, thr = ((ComparisonOp.GT, 99.9) if r % 2
                       else (ComparisonOp.LT, 0.1))
        elif kind == RuleKind.WINDOW_MEAN:
            op, thr = ComparisonOp.GT, 99.0
        else:
            op, thr = ComparisonOp.GT, 95.0
        rules.create_rule(f"m{r % M_SLOTS}", op, thr, f"rule-{r % 4}",
                          alert_level=r % 4,
                          tenant=None if r % 2 == 0 else "default",
                          kind=kind, window_s=(60.0, 600.0, 3600.0)[r % 3])


_M_LINE = ('{"deviceToken":"%s","type":"DeviceMeasurements","request":'
           '{"name":"m%d","value":%.3f,"eventDate":%d}}')
_L_LINE = ('{"deviceToken":"%s","type":"DeviceLocation","request":'
           '{"latitude":%.5f,"longitude":%.5f,"elevation":%.1f,'
           '"eventDate":%d}}')
_A_LINE = ('{"deviceToken":"%s","type":"DeviceAlert","request":'
           '{"type":"device-%d","level":"warning","eventDate":%d}}')


def wire_payloads(rng, n_payloads, lines, ts0_ms, devices=None):
    """NDJSON payloads of ``lines`` lines, 60/30/10 measurements,
    locations and alerts, a share of unregistered tokens; one second of
    event time per payload.  ``devices(p)``, when given, names payload
    ``p``'s devices (else they are drawn with replacement).  Returns
    ``[(bytes, registered_lines)]``."""
    out = []
    for p in range(n_payloads):
        dev = (rng.integers(0, N_ACTIVE, lines) if devices is None
               else devices(p))
        ghost = rng.random(lines) < WIRE_GHOSTS
        kind = rng.choice(3, lines, p=[0.6, 0.3, 0.1])
        value = rng.uniform(0, 100, lines)
        lat = rng.uniform(-85, 85, lines)
        lon = rng.uniform(-175, 175, lines)
        ts = ts0_ms + 1000 * p + 250 * rng.integers(0, 4, lines)
        body = []
        for d, g, k, v, la, lo, t in zip(
                dev.tolist(), ghost.tolist(), kind.tolist(), value.tolist(),
                lat.tolist(), lon.tolist(), ts.tolist()):
            tok = f"x-{d}" if g else f"d-{d}"
            if k == 0:
                body.append(_M_LINE % (tok, d % M_SLOTS, v, t))
            elif k == 1:
                body.append(_L_LINE % (tok, la, lo, v, t))
            else:
                body.append(_A_LINE % (tok, d % 4, t))
        out.append(("\n".join(body).encode(), lines - int(ghost.sum())))
    return out


def measurement_payloads(rng, n_payloads, lines, ts0_ms, devices=None):
    """Measurement-only NDJSON payloads of ``lines`` lines (the fleet's
    dominant shape), values in MEAS_VALUE_BAND, the same share of
    unregistered tokens; one second of event time per payload;
    ``devices`` as in :func:`wire_payloads`.  Returns
    ``[(bytes, registered_lines)]``."""
    out = []
    lo, hi = MEAS_VALUE_BAND
    for p in range(n_payloads):
        dev = (rng.integers(0, N_ACTIVE, lines) if devices is None
               else devices(p))
        ghost = rng.random(lines) < WIRE_GHOSTS
        value = rng.uniform(lo, hi, lines)
        ts = ts0_ms + 1000 * p + 250 * rng.integers(0, 4, lines)
        body = [_M_LINE % (f"x-{d}" if g else f"d-{d}", d % M_SLOTS, v, t)
                for d, g, v, t in zip(dev.tolist(), ghost.tolist(),
                                      value.tolist(), ts.tolist())]
        out.append(("\n".join(body).encode(), lines - int(ghost.sum())))
    return out


def make_wire_dispatcher(device, world, width, ring_depth, deadline_ms,
                         journal_dir):
    """A started dispatcher over the world's epochs, with its own state,
    journal and store (start() runs the warm-up dispatch)."""
    from sitewhere_tpu_torch.ingest.batcher import Batcher
    from sitewhere_tpu_torch.ingest.journal import Journal, JournalReader
    from sitewhere_tpu_torch.runtime.dispatcher import PipelineDispatcher
    from sitewhere_tpu_torch.state.manager import DeviceStateManager

    identity, mirror, rules = world
    state = DeviceStateManager(
        CAPACITY, identity, num_mtype_slots=M_SLOTS,
        tenant_id_of_device=lambda ids: mirror.tenant_id[ids],
        num_ewma_scales=K_SCALES, device=device)
    batcher = Batcher(
        width=width, n_shards=1, registry_capacity=CAPACITY,
        resolve_device=identity.device.lookup,
        resolve_mtype=identity.mtype.mint,
        resolve_alert=identity.alert_type.mint,
        invocations=identity.invocation, deadline_ms=deadline_ms,
        emit_packed=True)
    journal = Journal(journal_dir, "events", fsync_every=1 << 30,
                      segment_bytes=1 << 30)
    disp = PipelineDispatcher(
        batcher=batcher, registry_provider=mirror.publish_registry,
        state_manager=state, rules_provider=rules.publish,
        zones_provider=mirror.publish_zones, event_store=CountingStore(),
        journal=journal, journal_reader=JournalReader(journal, "pipeline"),
        resolve_tenant=identity.tenant.mint, ring_depth=ring_depth,
        egress_offload=True, device=device)
    disp.start()
    return disp


def _stage_totals(disp):
    return {s: (disp.metrics.timer(f"pipeline.stage_{s}_s").total,
                disp.metrics.timer(f"pipeline.stage_{s}_s").count)
            for s in WIRE_STAGES}


def _stage_ms(disp, before):
    out = {}
    for s, (total0, count0) in before.items():
        t = disp.metrics.timer(f"pipeline.stage_{s}_s")
        if t.count > count0:
            out[s] = (t.total - total0) / (t.count - count0) * 1e3
    return out


def _wait_egress_idle(disp, timeout_s=120.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        with disp._step_lock:
            if not disp._inflight and not disp._egress_busy:
                return
        time.sleep(0.001)
    raise RuntimeError("chip_smoke: egress did not drain")


class DeviceSpans:
    """CUDA events around every step and chain a started dispatcher
    launches.  Their summed span bounds the card's busy time from above:
    a span also holds any gap in which the card waits for the host's next
    launch.  None of it on the CPU."""

    def __init__(self, disp):
        import torch

        self._torch = torch
        self.pairs = []
        self.on = disp.device.type == "cuda"
        if self.on:
            disp._packed_step = self.wrap(disp._packed_step)
            for k, chain in list(disp._ring_chains.items()):
                disp._ring_chains[k] = self.wrap(chain)

    def wrap(self, fn):
        torch = self._torch

        def timed(*args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args)
            end.record()
            self.pairs.append((start, end))
            return out

        return timed

    def total_ms(self):
        if not self.on:
            return None
        self._torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.pairs)


def _device_profile(on: bool):
    """``torch.profiler`` over the card's activity only (kernels and
    copies, from every thread), or nothing (and always on the CPU)."""
    if not on:
        return contextlib.nullcontext(None)
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CUDA])


def _device_ms(prof):
    """The card's kernel and copy time in a profile, in ms: one stream, so
    the entries never overlap and their sum is the busy time."""
    if prof is None:
        return None

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0.0)

    return sum(dev_us(e) for e in prof.key_averages()
               if "CUDA" in str(e.device_type)) / 1e3


def _device_launches(prof):
    """Kernels and copies the card ran in a profile (None without one)."""
    if prof is None:
        return None
    return sum(e.count for e in prof.key_averages()
               if "CUDA" in str(e.device_type))


def _busy(rec, span_ms, device_ms, elapsed, steps):
    """The card's share of the wall time: the CUDA-event span's bound and,
    in a profiled run, the measured kernel and copy time."""
    rec["device_span_ms"] = span_ms
    rec["device_busy_share_max"] = (
        None if span_ms is None else span_ms / 1e3 / elapsed)
    rec["device_span_ms_per_step"] = (
        None if span_ms is None else span_ms / max(1, steps))
    if device_ms is not None:
        rec["device_ms"] = device_ms
        rec["device_ms_per_step"] = device_ms / max(1, steps)
        rec["device_busy_share"] = device_ms / 1e3 / elapsed
    return rec


def _latency(disp, tail: str):
    """p50 and the tail of the dispatcher's per-plan latencies, in ms:
    the max (``tail="max"``) or the p99 and the max."""
    lat = np.asarray(list(disp.latencies_s)) * 1e3
    rec = {"plans": int(lat.size),
           "latency_p50_ms": float(np.percentile(lat, 50)),
           "latency_max_ms": float(lat.max())}
    if tail == "p99":
        rec["latency_p99_ms"] = float(np.percentile(lat, 99))
    return rec


def _time_into(fn, acc):
    """``fn`` with its host seconds added to ``acc[0]``."""

    def timed(*args, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kw)
        finally:
            acc[0] += time.perf_counter() - t0

    return timed


def count_adopted(batcher):
    """Record the sequence number of every plan the batcher emits by
    adopting a full-width reservation (zero-copy)."""
    adopted = []
    emit_adopted = batcher._emit_adopted

    def counted(reason):
        plan = emit_adopted(reason)
        adopted.append(plan.seq)
        return plan

    batcher._emit_adopted = counted
    return adopted


def wire_throughput(device, geo_cuda, world, payloads, ring_depth,
                    deadline_ms, root, run, profile=False, meas=False):
    """ingest_wire_lines over every payload, then flush(), timed from the
    first byte to the flush's return.  With ``deadline_ms`` at
    RING_DIAG_DEADLINE_MS the ring forms: its sync count is read once the
    ring's plans have egressed, before the flush's partial, and the last
    dispatched ring is rerun with the plain geofence.  ``meas``: the
    payloads are full-width measurement-only ones, each of which must
    decode fill-direct and be adopted as its plan.  ``profile`` runs the
    region under the profiler (its numbers then carry its cost)."""
    import torch

    import sitewhere_tpu_torch.runtime.dispatcher as dispatcher_mod
    from sitewhere_tpu_torch.pipeline.packed import build_packed_chain

    diag = deadline_ms == RING_DIAG_DEADLINE_MS
    disp = make_wire_dispatcher(device, world, FULL_B, ring_depth,
                                deadline_ms, os.path.join(root, "j"))
    adopted = count_adopted(disp.batcher)
    decode_copied = disp.metrics.counter("pipeline.bytes_copied.decode")
    # two host steps no stage timer covers: the token and name resolution
    # of decoded columns, and the journal append
    resolve_s, journal_s = [0.0], [0.0]
    resolve_columns = dispatcher_mod.resolve_columns
    dispatcher_mod.resolve_columns = _time_into(resolve_columns, resolve_s)
    disp.journal.append = _time_into(disp.journal.append, journal_s)
    recorded = {}
    if diag:
        real_chain = disp._ring_chain(ring_depth)

        def recording_chain(tables, ps, *slots):
            out = real_chain(tables, ps, *slots)
            recorded.update(tables=tables, ps=ps, slots=slots, out=out)
            return out

        disp._ring_chains[ring_depth] = recording_chain
    spans = DeviceSpans(disp)
    try:
        torch.cuda.synchronize()
        snap0 = disp.metrics_snapshot()
        stages0 = _stage_totals(disp)
        copied0 = (decode_copied.value, disp.batcher.copied_bytes)
        adopted.clear()
        resolve_s[0] = journal_s[0] = 0.0
        disp.latencies_s.clear()
        geo_cuda.reset_launch_counts()
        with _device_profile(profile and device.type == "cuda") as prof:
            t0 = time.perf_counter()
            for payload, _ in payloads:
                disp.ingest_wire_lines(payload)
            _wait_egress_idle(disp)
            mid = disp.metrics_snapshot()
            disp.flush()
            elapsed = time.perf_counter() - t0
        launches = geo_cuda.launch_counts["pip_parity"]
        snap = disp.metrics_snapshot()
        stage_ms = _stage_ms(disp, stages0)
        copied = (decode_copied.value - copied0[0],
                  disp.batcher.copied_bytes - copied0[1])
        build_fallbacks = disp.metrics.gauge("native.build_fallbacks").value
        committed = disp.journal_reader.committed
        records = disp.journal.end_offset
        latency = _latency(disp, "max")
        span_ms = spans.total_ms()
    finally:
        dispatcher_mod.resolve_columns = resolve_columns
        disp.stop()
        disp.journal.close()
    stage_ms["resolve_per_payload"] = resolve_s[0] * 1e3 / len(payloads)
    stage_ms["journal_per_payload"] = journal_s[0] * 1e3 / len(payloads)
    delta = {k: snap[k] - snap0[k] for k in (
        "steps", "host_syncs", "ring_chains", "ring_flushed_plans",
        "processed", "accepted", "unregistered", "derived_alerts")}
    lines = sum(p.count(b"\n") + 1 for p, _ in payloads)
    registered = sum(r for _, r in payloads)
    ring_steps = mid["steps"] - snap0["steps"]
    ring_syncs = mid["host_syncs"] - snap0["host_syncs"]
    rec = {"phase": "dispatcher_wire", "run": run,
           "traffic": "measurements" if meas else "60/30/10",
           "ring_depth": ring_depth, "deadline_ms": deadline_ms,
           "payloads": len(payloads), "lines": lines, "elapsed_s": elapsed,
           "events_per_s": lines / elapsed,
           "rows_per_s_with_derived": delta["processed"] / elapsed,
           **latency, "stage_ms": stage_ms,
           "decode_bytes_copied_per_event": copied[0] / lines,
           "batch_bytes_copied_per_event": copied[1] / lines,
           "adopted_plans": len(adopted),
           "native_build_fallbacks": build_fallbacks,
           "host_syncs_per_batch": delta["host_syncs"] / delta["steps"],
           "ring_region_steps": ring_steps,
           "ring_region_host_syncs_per_batch": ring_syncs / ring_steps,
           "pip_launches": launches, "committed": committed,
           "journal_records": records, **delta}
    rec.update(guard_counts(disp.metrics, rec["phase"]))
    emit(_busy(rec, span_ms, _device_ms(prof), elapsed, delta["steps"]))
    check(launches == delta["steps"],
          f"kernel launched {launches}x in {delta['steps']} dispatcher steps")
    check(delta["accepted"] == registered + delta["derived_alerts"],
          f"accepted {delta['accepted']} != registered {registered} + "
          f"derived {delta['derived_alerts']}")
    check(delta["processed"] == lines + delta["derived_alerts"],
          "processed rows")
    check(delta["unregistered"] == lines - registered, "unregistered rows")
    check(committed == records == len(payloads),
          f"committed offset {committed}, journal records {records}")
    check(build_fallbacks == 0, f"native.build_fallbacks {build_fallbacks}")
    if meas:
        # every payload is one full-width measurement plan, decoded
        # fill-direct and adopted: nothing copied by decode or batch
        check(delta["steps"] == len(payloads) and delta["derived_alerts"] == 0,
              f"{delta['steps']} steps, {delta['derived_alerts']} derived")
        check(len(adopted) == len(payloads),
              f"{len(adopted)} adopted plans of {len(payloads)}")
        check(copied == (0, 0), f"bytes copied (decode, batch) {copied}")
    if diag:
        check(delta["ring_chains"] == len(payloads) // ring_depth,
              f"{delta['ring_chains']} ring chains")
        check(ring_syncs * ring_depth == ring_steps,
              f"ring host syncs {ring_syncs} over {ring_steps} steps")
        # the last dispatched ring again, from its carry, plain geofence
        plain = build_packed_chain(ring_depth, geofence=plain_chunked)
        ps, ois, mets, present = plain(recorded["tables"], recorded["ps"],
                                       *recorded["slots"])
        kps, kois, kmets, kpresent = recorded["out"]
        same = (torch.equal(ois, kois) and torch.equal(mets, kmets)
                and torch.equal(ps.si, kps.si) and torch.equal(ps.sf, kps.sf)
                and torch.equal(present, kpresent))
        emit({"phase": "dispatcher_wire", "run": "plain_rerun",
              "identical": same})
        check(same, "dispatcher ring != plain-geofence rerun")
        check(geo_cuda.launch_counts["pip_parity"] == launches,
              "plain rerun launched the kernel")
    return rec


def wire_paced(device, world, payloads, root, run="paced_ring0",
               profile=False):
    """A latency region as the reference's bench runs one: width 4096,
    deadline 3.5 ms, ring off; a burst measures this dispatcher's
    capacity, then payloads are offered at PACED_UTIL of it on a
    drift-free schedule.  Each payload's latency counts from its scheduled
    arrival, so time the host spends behind schedule is inside it.
    ``profile`` runs the offered region under the profiler."""
    import torch

    disp = make_wire_dispatcher(device, world, PACED_WIDTH, 0,
                                PACED_DEADLINE_MS, os.path.join(root, "p"))
    spans = DeviceSpans(disp)
    try:
        rows = PACED_LINES
        tb = time.perf_counter()
        for payload, _ in payloads[:PACED_BURST]:
            disp.ingest_wire_lines(payload)
        disp.flush()
        capacity = rows * PACED_BURST / (time.perf_counter() - tb)
        gap_s = rows / (capacity * PACED_UTIL)
        torch.cuda.synchronize()
        spans.pairs.clear()
        disp.latencies_s.clear()
        snap0 = disp.metrics_snapshot()
        with _device_profile(profile and device.type == "cuda") as prof:
            t0 = time.perf_counter()
            m0 = time.monotonic()
            for i, (payload, _) in enumerate(payloads[PACED_BURST:]):
                due = m0 + i * gap_s
                delay = due - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
                disp.ingest_wire_lines(payload, received_at=due)
            disp.flush()
            elapsed = time.perf_counter() - t0
        snap = disp.metrics_snapshot()
        latency = _latency(disp, "p99")
        span_ms = spans.total_ms()
    finally:
        disp.stop()
        disp.journal.close()
    n = rows * (len(payloads) - PACED_BURST)
    steps = snap["steps"] - snap0["steps"]
    rec = {"phase": "dispatcher_wire", "run": run,
           "ring_depth": 0, "width": PACED_WIDTH,
           "deadline_ms": PACED_DEADLINE_MS,
           "capacity_events_per_s": capacity, "offered_util": PACED_UTIL,
           "events_per_s": n / elapsed, **latency,
           "steps": steps,
           "host_syncs_per_batch":
           (snap["host_syncs"] - snap0["host_syncs"]) / max(1, steps)}
    rec.update(guard_counts(disp.metrics, rec["phase"]))
    emit(_busy(rec, span_ms, _device_ms(prof), elapsed, steps))
    return rec


def _columns_equal(a, b):
    """Column dicts equal key for key: lists exactly, arrays by dtype and
    raw bytes (float32 bitwise)."""
    if sorted(a) != sorted(b):
        return False
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            x, y = np.asarray(x), np.asarray(y)
            if x.dtype != y.dtype or x.tobytes() != y.tobytes():
                return False
        elif list(x) != list(y):
            return False
    return True


def _best_ms(fn, reps):
    best = None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        dt = (time.perf_counter() - t0) * 1e3
        best = dt if best is None else min(best, dt)
    return best, out


def native_proof(world, meas_payload, mixed_payload):
    """The native tier on this machine: where the library was built and
    how long it took, ``native.build_fallbacks``, and one full-size
    payload of each kind through its C lane and through the pure-Python
    lane (column for column equal), with each lane's ms per payload
    (best of 3 for the C lanes, one pure-Python run)."""
    from sitewhere_tpu_torch import native
    from sitewhere_tpu_torch.ingest import columnar
    from sitewhere_tpu_torch.ingest.batcher import Batcher
    from sitewhere_tpu_torch.ingest.decoders import parse_envelopes

    identity = world[0]
    library = native.library_path
    check(library is not None and library.parent == native.BUILD_DIR
          and library.name.startswith("_swwire_torch-"),
          f"scanner library {library}")
    t0 = time.perf_counter()
    identity.device.native_table()
    table_s = time.perf_counter() - t0
    batcher = Batcher(width=FULL_B, n_shards=1, registry_capacity=CAPACITY,
                      resolve_device=identity.device.lookup,
                      resolve_mtype=identity.mtype.mint,
                      resolve_alert=identity.alert_type.mint,
                      emit_packed=True)

    def fill():
        res = batcher.reserve(meas_payload.count(b"\n") + 1)
        n = columnar.decode_fill_direct(meas_payload, identity.device, res,
                                        identity.mtype.mint)
        return n, res

    def python(payload):
        return columnar._decode_lines_inner(parse_envelopes(payload))

    fill_ms, (n, res) = _best_ms(fill, 3)
    check(n == FULL_B, f"fill-direct returned {n} for {FULL_B} lines")
    py_meas_ms, (py_cols, _) = _best_ms(lambda: python(meas_payload), 1)
    ref = columnar.resolve_columns(
        py_cols, identity.device.lookup, identity.mtype.mint,
        identity.alert_type.mint)
    got = {f: getattr(res, f)[:n] for f in ("device_id", "mtype_id", "ts_s",
                                            "ts_ns", "value")}
    got["update_state"] = res.update_state[:n] != 0
    fill_equal = _columns_equal(got, {f: ref[f] for f in got})
    check(fill_equal, "fill-direct decode != pure-Python decode")
    family_ms, family = _best_ms(
        lambda: columnar._native_decode(mixed_payload), 3)
    check(family is not None, "the event-family scanner bailed")
    py_mixed_ms, py_mixed = _best_ms(lambda: python(mixed_payload), 1)
    family_equal = (_columns_equal(family[0], py_mixed[0])
                    and family[1] == py_mixed[1] == [])
    check(family_equal, "event-family decode != pure-Python decode")
    check(native.build_fallbacks == 0,
          f"native.build_fallbacks {native.build_fallbacks}")
    lines = FULL_B
    rec = {"phase": "dispatcher_wire", "run": "native",
           "library": str(library.relative_to(native.PKG_DIR.parent)),
           "build_s": native.build_seconds,
           "build_fallbacks": native.build_fallbacks,
           "token_table_s": table_s, "lines": lines,
           "fill_direct_rows": n, "fill_direct_equal_python": fill_equal,
           "family_rows": columnar.n_rows(family[0]),
           "family_equal_python": family_equal,
           "decode_ms": {"fill_direct": fill_ms,
                         "python_measurements": py_meas_ms,
                         "event_family": family_ms,
                         "python_60_30_10": py_mixed_ms},
           "decode_us_per_line": {
               "fill_direct": fill_ms * 1e3 / lines,
               "python_measurements": py_meas_ms * 1e3 / lines,
               "event_family": family_ms * 1e3 / lines,
               "python_60_30_10": py_mixed_ms * 1e3 / lines}}
    emit(rec)
    return rec


def phase_dispatcher_wire(device, geo_cuda):
    """The wire path through the port's dispatcher; returns the kernel's
    launches in each throughput run, by run name, and the full-width
    payloads (60/30/10, measurement-only) for the persistence phase."""
    t0 = time.perf_counter()
    world = make_wire_world(device)
    rng = np.random.default_rng(SEED + 6)
    payloads = wire_payloads(rng, WIRE_PAYLOADS, FULL_B, WIRE_TS0_MS)
    paced = wire_payloads(rng, PACED_PAYLOADS + PACED_BURST, PACED_LINES,
                          WIRE_TS0_MS + 10_000_000)
    meas = measurement_payloads(rng, WIRE_PAYLOADS, FULL_B,
                                WIRE_TS0_MS + 20_000_000)
    emit({"phase": "dispatcher_wire", "run": "setup", "capacity": CAPACITY,
          "active": N_ACTIVE, "rules": N_RULES, "zones": FULL_Z,
          "verts": FULL_V, "width": FULL_B,
          "setup_s": time.perf_counter() - t0})
    native_proof(world, meas[0][0], payloads[0][0])
    root = tempfile.mkdtemp(prefix="wire-", dir=geo_cuda.BUILD_DIR)
    launches = {}
    try:
        for ring, deadline_ms, run in (
                (RING_K, WIRE_DEADLINE_MS, f"throughput_ring{RING_K}"),
                (0, WIRE_DEADLINE_MS, "throughput_ring0"),
                (RING_K, RING_DIAG_DEADLINE_MS,
                 f"diagnostic_ring{RING_K}_deadline60s")):
            rec = wire_throughput(device, geo_cuda, world, payloads, ring,
                                  deadline_ms, os.path.join(root, run), run)
            launches[run] = rec["pip_launches"]
        run = "measurements_ring0"
        rec = wire_throughput(device, geo_cuda, world, meas, 0,
                              WIRE_DEADLINE_MS, os.path.join(root, run), run,
                              meas=True)
        launches[run] = rec["pip_launches"]
        wire_paced(device, world, paced, os.path.join(root, "paced"))
        # the card's busy time, measured apart from the timed regions
        wire_throughput(device, geo_cuda, world,
                        payloads[:PROFILED_PAYLOADS], 0, WIRE_DEADLINE_MS,
                        os.path.join(root, "prof"), "profiled_ring0",
                        profile=True)
        wire_throughput(device, geo_cuda, world, meas[:PROFILED_PAYLOADS], 0,
                        WIRE_DEADLINE_MS, os.path.join(root, "prof_meas"),
                        "profiled_measurements_ring0", profile=True,
                        meas=True)
        wire_paced(device, world, paced[:PACED_BURST + PROFILED_PACED],
                   os.path.join(root, "prof_paced"), "profiled_paced_ring0",
                   profile=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "dispatcher_wire", "run": "done",
          "seconds": time.perf_counter() - t0})
    return launches, payloads, meas


# -- persistence and restart ---------------------------------------------------

# The kill runs other than crash.mid_egress run at a reduced size so the
# phase stays within a few minutes: 2^16 registry slots, 50,000 devices,
# width 4096, 24 payloads of 4096 lines (same rules and zones).
SMALL_CAPACITY, SMALL_ACTIVE, SMALL_WIDTH = 1 << 16, 50_000, 4096
KILL_PAYLOADS, KILL_SAVE_EVERY = 24, 8
KILL_TS0_MS = WIRE_TS0_MS + 30_000_000
# (point, hit, size, ring depth, deadline ms): where each child dies
KILLS = (
    ("crash.mid_egress", 13, "full", 0, WIRE_DEADLINE_MS),
    ("crash.mid_ring", 2, "small", RING_K, RING_DIAG_DEADLINE_MS),
    ("crash.post_journal", 13, "small", 0, WIRE_DEADLINE_MS),
    ("crash.mid_seal", 12, "small", 0, WIRE_DEADLINE_MS),
    ("crash.pre_manifest", 3, "small", 0, WIRE_DEADLINE_MS),
)
SIZES = {"full": (CAPACITY, N_ACTIVE, FULL_B),
         "small": (SMALL_CAPACITY, SMALL_ACTIVE, SMALL_WIDTH)}
EWMA_MAX_ULP, EWMA_SCALE = 4.0, 128.0


def instance_config(data_dir, capacity, width, ring_depth, deadline_ms,
                    n_shards=1, **extra):
    """The deployment as an ``Instance`` config: the reference's keys; the
    journal and the segment store at the Config defaults; ``extra``
    sections on top (``registration`` in device_services, the control
    plane's own settings in control_plane).

    The overload ladder and the SLO engine are off here: these runs
    count every line they send (stored == accepted, nothing lost across
    a kill), and the ladder at its defaults sheds whenever the commit
    gate's seal lag passes 0.1 s, which a run that pushes payloads as
    fast as it can always does.  The reference's zero-loss benches turn
    both off for the same reason (``tools/crashrec_bench.py:116-119``).
    The flight recorder, metering, the breaker and the watchdog stay at
    their defaults; phase ``control_plane`` runs the ladder and the SLO
    engine at theirs.  ``n_shards`` > 1 runs the sharded pipeline, every
    shard on the instance's one device."""
    from sitewhere_tpu_torch.runtime.config import Config

    return Config({
        "instance": {"id": "chip-smoke", "data_dir": data_dir},
        "pipeline": {"width": width, "registry_capacity": capacity,
                     "mtype_slots": M_SLOTS, "deadline_ms": deadline_ms,
                     "adaptive_deadline": False, "ring_depth": ring_depth,
                     "max_zones": FULL_Z, "max_zone_verts": FULL_V,
                     "n_shards": n_shards},
        "checkpoint": {"interval_s": 0},
        # the rule engine's asset table covers the world's 5000 assets
        "rules": {"asset_capacity": RULE_ASSET_CAPACITY},
        # every live match of a run is kept for the live == retrospective
        # check
        "analytics": {"max_matches": 1 << 21},
        "overload": {"enabled": False},
        "slo": {"enabled": False},
        **extra,
    }, apply_env=False)


def world_checkpoint(device, root, size, n_tenants=1):
    """Write the deployment through an ``Instance``'s own identity, mirror
    and rules, save it as checkpoint generation 0 (empty device state) and
    return its directory: every later instance restores the world from a
    copy of it.  ``n_tenants`` > 1 spreads the devices over that many
    tenants (``populate_world``)."""
    from sitewhere_tpu_torch.instance import Instance

    capacity, n_active, width = SIZES[size]
    data_dir = os.path.join(root, f"world-{size}-{n_tenants}")
    inst = Instance(instance_config(data_dir, capacity, width, 0,
                                    WIRE_DEADLINE_MS), device=device)
    populate_world(inst.identity, inst.mirror, inst.rules, n_active,
                   n_tenants)
    inst.checkpointer.save()
    inst.terminate()
    return os.path.join(data_dir, "checkpoint")


def instance_from_world(device, world_ckpt, data_dir, capacity, width,
                        ring_depth, deadline_ms, n_shards=1, **extra):
    """A fresh instance whose checkpoint directory is a copy of the
    world's: construction restores the deployment."""
    from sitewhere_tpu_torch.instance import Instance

    shutil.copytree(world_ckpt, os.path.join(data_dir, "checkpoint"))
    inst = Instance(instance_config(data_dir, capacity, width, ring_depth,
                                    deadline_ms, n_shards=n_shards, **extra),
                    device=device)
    check(inst.restored, f"world checkpoint not restored in {data_dir}")
    return inst


_MIX = (np.uint64(0x9E3779B97F4A7C15), np.uint64(0xC2B2AE3D27D4EB4F),
        np.uint64(0x165667B19E3779F9), np.uint64(0x27D4EB2F165667C5))


def row_checksum(cols, mask=None):
    """(rows, order-independent uint64 checksum) of the stored identity of
    each row: device, type, time, measurement and value bits."""
    def col(name):
        a = np.asarray(cols[name])
        return a if mask is None else a[mask]

    dev = col("device_id").astype(np.uint64)
    with np.errstate(over="ignore"):
        h = (dev * _MIX[0]
             ^ col("event_type").astype(np.uint64) * _MIX[1]
             ^ (col("ts_s").astype(np.uint64) << np.uint64(30))
             ^ col("ts_ns").astype(np.uint64) * _MIX[2]
             ^ col("mtype_id").astype(np.uint64) * _MIX[3]
             ^ col("value").view(np.uint32).astype(np.uint64))
        return int(dev.size), int(h.sum(dtype=np.uint64))


def persist_throughput(device, geo_cuda, world_ckpt, payloads, root, run,
                       meas=False, rules=None, phase="persist_recover",
                       name=None, analytics=None, n_shards=1):
    """The wire path through the port ``Instance``: its ``SegmentStore``
    and journal at the Config defaults, ring off, the deployment's 5 ms
    deadline.  Timed from the first byte to the return of the
    dispatcher's flush (every row egressed, sealed and committed) and,
    with tenant programs, to the point where every program alert they
    fired has been injected and stored too (:func:`settle`).

    ``rules(inst)`` loads tenant programs before the instance starts and
    returns a record of the load; the run then records every alert the
    engine injects and checks each is stored exactly once.  A 60/30/10
    run ends with checkpoint_full.

    ``analytics``: streaming queries registered before the instance
    starts; the run then waits for the runner to drain, reports the
    ``analytics.*`` metrics, and after ``flush_live()`` and ``stop()``
    checks every query's live matches against ``run_retrospective`` over
    the sealed store (which needs ``analytics.live_dropped`` 0).

    ``n_shards`` > 1 runs the sharded pipeline over that many shards on
    the one card: each dispatcher step then launches the geofence kernel
    once per shard."""
    import torch

    data_dir = os.path.join(root, run)
    inst = instance_from_world(device, world_ckpt, data_dir, CAPACITY,
                               FULL_B, 0, WIRE_DEADLINE_MS, n_shards=n_shards)
    store, disp, eng = inst.event_store, inst.dispatcher, inst.rule_engine
    load = rules(inst) if rules is not None else None
    runner = inst.analytics
    live_matches = collections.defaultdict(list)
    if analytics is not None:
        for doc in analytics:
            runner.register(doc)
        real_record = runner._record

        def record(entry, matches, live):
            if live:
                live_matches[entry.spec.name].extend(
                    m.to_dict() for m in matches)
            return real_record(entry, matches, live=live)

        runner._record = record
        order = OfferOrder(runner, CAPACITY)
    fired = collections.Counter()
    if load is not None:
        real_inject = eng.inject

        def inject(cols):
            fired.update(zip(*(np.asarray(cols[k]).tolist() for k in (
                "device_id", "ts_s", "ts_ns", "alert_code",
                "alert_level"))))
            return real_inject(cols)

        eng.inject = inject
    byo_codes = np.asarray(sorted(load["alert_codes"]) if load else [],
                           np.int64)
    stored_alerts = collections.Counter()
    persist_s, commits = [0.0], []
    appended = {"rows": 0, "sum": 0}
    real_append, real_flush = store.append_columns, store.flush

    def append(cols, mask=None):
        t0 = time.perf_counter()
        out = real_append(cols, mask=mask)
        persist_s[0] += time.perf_counter() - t0
        n, h = row_checksum(cols, None if mask is None else np.asarray(mask))
        appended["rows"] += n
        appended["sum"] = (appended["sum"] + h) % (1 << 64)
        return out

    def flush(sync=True):
        t0 = time.perf_counter()
        try:
            return real_flush(sync=sync)
        finally:
            if sync:
                commits.append(time.perf_counter() - t0)

    store.append_columns, store.flush = append, flush
    inst.start()
    spans = DeviceSpans(disp)
    try:
        torch.cuda.synchronize()
        snap0 = disp.metrics_snapshot()
        sealed0 = store.sealer.sealed_segments
        commits.clear()
        persist_s[0] = 0.0
        disp.latencies_s.clear()
        rules0 = rules_metrics(inst)
        geo_cuda.reset_launch_counts()
        t0 = time.perf_counter()
        for payload, _ in payloads:
            disp.ingest_wire_lines(payload)
        settle(inst)
        elapsed = time.perf_counter() - t0
        if analytics is not None:
            runner.drain(timeout_s=600.0)
        drained = time.perf_counter() - t0
        launches = geo_cuda.launch_counts["pip_parity"]
        snap = disp.metrics_snapshot()
        rules1 = rules_metrics(inst)
        registration = {"registered": inst.registration.registered,
                        "rejected": inst.registration.rejected}
        committed = disp.journal_reader.committed
        records = inst.ingest_journal.end_offset
        latency = _latency(disp, "max")
        span_ms = spans.total_ms()
        commit_ms = [c * 1e3 for c in commits]
        store.append_columns, store.flush = real_append, real_flush
        # checkpoint_full: one save of the loaded instance, then a fresh
        # instance restores it; the state must come back bitwise
        an = analytics_metrics(inst) if analytics is not None else None
        if not meas:
            saved_state = inst.device_state.snapshot_host()
            saved_analytics = {n: e.compiled.export_state()
                               for n, e in runner._queries.items()}
            saved_rules = (eng.registry.snapshot_payload()[0],
                           eng.attributes.snapshot_payload())
            inst.checkpointer.save()
            save_stats = dict(inst.checkpointer.last_save_stats)
        inst.stop()
        retro = {}
        if analytics is not None:
            # after stop(): its final generation holds the open windows
            # checkpoint_full compares; then every open window finalizes
            runner.flush_live()
            t1 = time.perf_counter()
            for doc in analytics:
                retro[doc["name"]] = runner.run_retrospective(
                    doc["name"])["matches"]
            retro_s = time.perf_counter() - t1
        sealed = store.sealer.sealed_segments - sealed0
        stats = store.store_stats()
        disk = sum(os.path.getsize(os.path.join(store.dir, f))
                   for f in os.listdir(store.dir))
        stored = {"rows": 0, "sum": 0}
        for cols in store.iter_chunks():
            n, h = row_checksum(cols)
            stored["rows"] += n
            stored["sum"] = (stored["sum"] + h) % (1 << 64)
            if byo_codes.size:
                mine = ((np.asarray(cols["event_type"]) == 2)
                        & np.isin(np.asarray(cols["alert_code"]), byo_codes))
                stored_alerts.update(zip(*(
                    np.asarray(cols[k])[mine].tolist() for k in (
                        "device_id", "ts_s", "ts_ns", "alert_code",
                        "alert_level"))))
        parked = store.sealer.parked_count()
        dead = store.sealed_dead_lettered
    finally:
        inst.terminate()
    delta = {k: snap[k] - snap0[k] for k in (
        "steps", "processed", "accepted", "unregistered", "derived_alerts")}
    lines = sum(p.count(b"\n") + 1 for p, _ in payloads)
    registered = sum(r for _, r in payloads)
    plans = len(disp.latencies_s)
    rec = {"phase": phase, "run": name or f"persist_throughput.{run}",
           "traffic": "measurements" if meas else "60/30/10",
           "ring_depth": 0, "deadline_ms": WIRE_DEADLINE_MS,
           "payloads": len(payloads), "lines": lines, "elapsed_s": elapsed,
           "events_per_s": lines / elapsed, **latency,
           "persist_ms_per_plan": persist_s[0] * 1e3 / max(1, plans),
           "flush_ms_per_commit": (float(np.mean(commit_ms))
                                   if commit_ms else None),
           "flush_ms_max": max(commit_ms) if commit_ms else None,
           "commits": len(commit_ms), "segments_sealed": sealed,
           "segments_on_disk": stats["segments"], "bytes_on_disk": disk,
           "rows_stored": stored["rows"], "store_shards": store.n_shards,
           "pipeline_shards": n_shards,
           "bytes_copied_batch": int(disp.metrics.counter(
               "pipeline.bytes_copied.batch").value),
           "seal_workers": store.sealer.n_workers,
           "pip_launches": launches, "committed": committed,
           "journal_records": records, **delta,
           "rules": {k: rules1[k] - rules0[k] for k in rules1},
           "registration": registration,
           "rule_program_alerts": (snap.get("rule_program_alerts", 0)
                                   - snap0.get("rule_program_alerts", 0))}
    if analytics is not None:
        rec["analytics_drain_s"] = drained - elapsed
        rec["analytics"] = an
        rec["analytics_matches"] = {n: len(v)
                                    for n, v in live_matches.items()}
        rec["retrospective_s"] = retro_s
        rec["disordered_devices"] = order.counts()
        rec["live_equals_retrospective"] = {}
        rec["matches_outside_the_contract"] = {}
        for doc in analytics:
            n = doc["name"]
            keep = order.ordered_devices(doc)
            got = [m for m in live_matches[n] if keep[m["device_id"]]]
            want = [m for m in retro[n] if keep[m["device_id"]]]
            rec["live_equals_retrospective"][n] = (
                sorted(got, key=_match_key) == sorted(want, key=_match_key))
            rec["matches_outside_the_contract"][n] = {
                "live": len(live_matches[n]) - len(got),
                "retrospective": len(retro[n]) - len(want)}
            if not rec["live_equals_retrospective"][n]:
                a = {tuple(sorted(m.items())) for m in got}
                b = {tuple(sorted(m.items())) for m in want}
                rec.setdefault("differences", {})[n] = {
                    "live_only": [dict(m) for m in sorted(a - b)[:4]],
                    "retrospective_only": [dict(m) for m in sorted(b - a)[:4]]}
    if load is not None:
        rec["rules"]["eval_ms_per_batch"] = (
            rec["rules"]["eval_s"] * 1e3
            / max(1, rec["rules"]["eval_batches"]))
        rec["rules_load"] = {k: v for k, v in load.items()
                             if k != "alert_codes"}
        rec["program_alerts_stored"] = sum(stored_alerts.values())
    rec.update(guard_counts(disp.metrics, rec["phase"]))
    emit(_busy(rec, span_ms, None, elapsed, delta["steps"]))
    check(launches == delta["steps"] * n_shards,
          f"kernel launched {launches}x in {delta['steps']} dispatcher steps"
          f" of {n_shards} shard(s)")
    if load is not None:
        n_fired = sum(fired.values())
        check(n_fired > 0 and rec["rule_program_alerts"] == n_fired
              == rec["rules"]["alerts"],
              f"program alerts: injected {n_fired}, dispatcher "
              f"{rec['rule_program_alerts']}, engine {rec['rules']['alerts']}")
        check(stored_alerts == fired,
              f"{sum(stored_alerts.values())} program alerts stored for "
              f"{n_fired} fired: one lost or stored twice")
    check(delta["accepted"] == registered + delta["derived_alerts"],
          f"accepted {delta['accepted']} != registered {registered} + "
          f"derived {delta['derived_alerts']}")
    check(appended["rows"] == delta["accepted"],
          f"rows appended {appended['rows']} != accepted {delta['accepted']}")
    check(committed == records == len(payloads),
          f"committed offset {committed}, journal records {records}")
    check(parked == 0 and dead == 0,
          f"{parked} seal jobs parked, {dead} rows dead-lettered")
    check(stored == appended,
          f"stored rows {stored} != accepted rows {appended}: a row lost "
          "or stored twice")
    if analytics is not None:
        check(an["live_dropped"] == 0,
              f"analytics dropped {an['live_dropped']} live batches: live "
              "and retrospective matches cannot agree")
        check(rec["disordered_devices"]["m0"]["rows"] == 0,
              "measurement rows reached the runner out of time order")
        check(all(rec["live_equals_retrospective"].values()),
              f"live != retrospective matches: "
              f"{rec['live_equals_retrospective']}")
        check(all(live_matches.get(n) for n in retro),
              f"a query never matched: {rec['analytics_matches']}")
    if not meas:
        restore_full(device, data_dir, saved_state, save_stats, saved_rules,
                     phase=phase,
                     run="checkpoint_full" + (".analytics" if analytics
                                              else ".rules" if load else ""),
                     saved_analytics=saved_analytics, n_shards=n_shards)
    shutil.rmtree(data_dir, ignore_errors=True)
    return rec


def settle(inst):
    """Flush the dispatcher, then until the rule engine is idle: drain it
    (its worker injects the program alerts it fires) and flush again, so
    every program alert is stored."""
    disp, eng = inst.dispatcher, inst.rule_engine
    disp.flush()
    while eng is not None:
        eng.drain(timeout_s=120.0)
        disp.flush()
        with eng._q.all_tasks_done:
            idle = eng._q.unfinished_tasks == 0
        if idle and disp.batcher.pending == 0:
            return


class OfferOrder:
    """Which devices' rows reached the analytics runner out of time order.

    Live and retrospective evaluation agree by construction only for a
    per-device time-ordered stream (the operators' split invariance): the
    store keeps each device's rows in the order they were offered, but
    splits them into other batches.  A derived or program alert
    re-enters the pipeline after its source plan's egress, so it can
    follow a later row of the same device.  Every offered row is checked,
    in offer order, against the newest row offered before it for its
    device: over all rows, and over the measurement rows of ``m0`` alone
    (what the window queries read)."""

    def __init__(self, runner, capacity):
        self.newest = {"all": np.full(capacity, -1, np.int64),
                       "m0": np.full(capacity, -1, np.int64)}
        self.late = {k: np.zeros(capacity, bool) for k in self.newest}
        self.rows = {k: 0 for k in self.newest}
        real = runner.submit_live

        def submit(cols, mask, trace=None, committed=None):
            m = np.asarray(mask)
            dev = np.asarray(cols["device_id"])[m].astype(np.int64)
            ts = np.asarray(cols["ts_s"])[m].astype(np.int64)
            m0 = ((np.asarray(cols["event_type"])[m] == 0)
                  & (np.asarray(cols["mtype_id"])[m] == 0))
            for key, sel in (("all", slice(None)), ("m0", m0)):
                d, t = dev[sel], ts[sel]
                ok = (d >= 0) & (d < capacity)
                self._scan(key, d[ok], t[ok])
            return real(cols, mask, trace=trace, committed=committed)

        runner.submit_live = submit

    def _scan(self, key, d, t):
        """Rows older than the newest earlier row of their device, in this
        batch's order: a running max over each device's rows (sorted by
        device, stably), seeded with the newest of earlier batches."""
        order = np.argsort(d, kind="stable")
        ds, ts = d[order], t[order]
        run = np.maximum.accumulate((ds << 32) | ts)
        prev = np.concatenate([[-1], run[:-1]])
        same = (prev >> 32) == ds
        before = np.maximum(np.where(same, prev & 0xFFFFFFFF, -1),
                            self.newest[key][ds])
        late = ts < before
        self.rows[key] += int(late.sum())
        self.late[key][ds[late]] = True
        np.maximum.at(self.newest[key], ds, ts)

    def counts(self):
        return {k: {"devices": int(self.late[k].sum()),
                    "rows": self.rows[k]} for k in self.late}

    def ordered_devices(self, doc):
        """The devices whose rows the query reads all arrived in time
        order (a boolean mask over device ids)."""
        key = "m0" if doc["kind"] == "window" and doc.get("mtype") == "m0" \
            else "all"
        return ~self.late[key]


def _match_key(m):
    return (m["ts_s"], m["device_id"], m["start_ts_s"], m["value"],
            m["count"])


def analytics_metrics(inst):
    """The ``analytics.*`` family: live batches, drops, replay skips, and
    each query's eval seconds (timer total and count) and matches."""
    m = inst.metrics
    out = {k: m.counter(f"analytics.{k}").value for k in (
        "live_batches", "live_dropped", "live_shed", "replay_rows_skipped")}
    out["queries"] = {}
    for name, entry in inst.analytics._queries.items():
        t = entry.timer
        out["queries"][name] = {
            "eval_s": t.total, "eval_batches": t.count,
            "eval_ms_per_batch": t.total * 1e3 / max(1, t.count),
            "matches": entry.counter.value}
    return out


def rules_metrics(inst):
    """The ``rules.*`` family's totals (zeros without an engine)."""
    m = inst.metrics
    t = m.timer("rules.eval_s")
    return {"eval_s": t.total, "eval_batches": t.count,
            "live_batches": m.counter("rules.live_batches").value,
            "live_dropped": m.counter("rules.live_dropped").value,
            "alerts": m.counter("rules.alerts").value}


def restore_full(device, data_dir, saved_state, save_stats, saved_rules,
                 phase="persist_recover", run="checkpoint_full",
                 saved_analytics=None, n_shards=1):
    """checkpoint_full: a fresh instance restores the saved instance's
    newest generation; the state must equal the saved one bitwise, the
    rule programs and attribute tables must come back as saved, and so
    must every analytics query's operator state.  With ``n_shards`` > 1
    the restored state is re-placed on the mesh first, and read back
    from its shards."""
    from sitewhere_tpu_torch.instance import Instance

    ckpt = os.path.join(data_dir, "checkpoint")
    t0 = time.perf_counter()
    inst = Instance(instance_config(data_dir, CAPACITY, FULL_B, 0,
                                    WIRE_DEADLINE_MS, n_shards=n_shards),
                    device=device)
    construct_s = time.perf_counter() - t0
    placed_shards = 1
    try:
        check(inst.restored, "checkpoint_full: nothing restored")
        if n_shards > 1:
            placed_shards = inst.device_state.current_packed.si.n_shards
            check(placed_shards == n_shards,
                  f"restored state on {placed_shards} shards, not "
                  f"{n_shards}")
        got = inst.device_state.snapshot_host()
        unequal = sorted(k for k in saved_state
                         if got[k].dtype != saved_state[k].dtype
                         or got[k].tobytes() != saved_state[k].tobytes())
        restore = dict(inst.checkpointer.restore_stats)
        restore_s = inst.checkpointer.restore_s
        eng = inst.rule_engine
        got_attrs = eng.attributes.snapshot_payload()
        rules_equal = (
            eng.registry.snapshot_payload()[0] == saved_rules[0]
            and got_attrs[0] == saved_rules[1][0]
            and all(np.array_equal(got_attrs[1][t], saved_rules[1][1][t])
                    for t in ("device", "asset")))
        programs = eng.registry.program_count()
        got_an = {n: e.compiled.export_state()
                  for n, e in inst.analytics._queries.items()}
        an_unequal = sorted(
            f"{n}.{k}" for n, arrays in (saved_analytics or {}).items()
            for k, a in arrays.items()
            if n not in got_an or got_an[n][k].dtype != a.dtype
            or got_an[n][k].tobytes() != a.tobytes())
        an_bytes = int(sum(a.nbytes for arrays in got_an.values()
                           for a in arrays.values()))
    finally:
        inst.terminate()
    gen = max(int(f.split("-")[1].split(".")[0]) for f in os.listdir(ckpt)
              if f.startswith("manifest-"))
    emit({"phase": phase, "run": run,
          "capacity": CAPACITY, "devices": N_ACTIVE,
          "rule_programs": programs, "rule_programs_equal": rules_equal,
          "state_fields": len(saved_state),
          "state_bytes_in_memory": int(sum(a.nbytes
                                           for a in saved_state.values())),
          "save": save_stats, "restore_s": restore_s,
          "restore": restore, "instance_construct_s": construct_s,
          "generation": gen, "unequal_fields": unequal,
          "state_shards": placed_shards,
          "analytics_queries": len(got_an),
          "analytics_state_bytes": an_bytes,
          "analytics_unequal_fields": an_unequal})
    check(not unequal, f"restored state differs from the saved: {unequal}")
    check(not an_unequal and len(got_an) == len(saved_analytics or {}),
          f"restored analytics state differs from the saved: {an_unequal}")
    check(rules_equal, "restored rule programs or attributes differ")


# -- kill -9 and restart --------------------------------------------------------


def keyed_payloads(n_payloads, lines, n_active, ts0_ms, seed):
    """Measurement-only NDJSON payloads in which every line has its own
    eventDate (one second apart: its second is the row's key), values
    where no rule fires (so no derived alerts, and every payload is one
    plan whatever the timing) and the share of unregistered tokens.
    Returns ``(payloads, registered keys per payload)``."""
    rng = np.random.default_rng(seed)
    lo, hi = MEAS_VALUE_BAND
    out, keys = [], []
    for p in range(n_payloads):
        dev = rng.integers(0, n_active, lines)
        ghost = rng.random(lines) < WIRE_GHOSTS
        value = rng.uniform(lo, hi, lines)
        ts = ts0_ms + 1000 * (p * lines + np.arange(lines))
        out.append("\n".join(
            _M_LINE % (f"x-{d}" if g else f"d-{d}", d % M_SLOTS, v, t)
            for d, g, v, t in zip(dev.tolist(), ghost.tolist(),
                                  value.tolist(), ts.tolist())).encode())
        keys.append(ts[~ghost] // 1000)
    return out, keys


def stored_key_counts(store):
    """(unique keys, their counts) of the stored rows, and how many of
    them are not measurements."""
    parts, others = [], 0
    for c in store.iter_chunks():
        meas = np.asarray(c["event_type"]) == 0
        others += int((~meas).sum())
        parts.append(np.asarray(c["ts_s"], np.int64)[meas])
    keys = np.concatenate(parts) if parts else np.zeros(0, np.int64)
    uniq, counts = np.unique(keys, return_counts=True)
    return uniq, counts, others


def kill_child(spec):
    """One instance life in its own process (``--kill-child``).

    ``role`` golden / kill: restore the world, start, save an anchor
    checkpoint, ingest the payloads with a quiesced checkpoint every
    KILL_SAVE_EVERY, flush; the golden one writes its final state and
    stops.  Under ``SW_CRASHPOINT`` a kill child dies on the way.
    ``role`` verify: restart on the survivor's directory (restore in the
    constructor, replay in ``start``), ingest the payloads that never
    reached the journal, and check the recovery contract."""
    import torch

    from sitewhere_tpu_torch.device import resolve_device
    from sitewhere_tpu_torch.ingest.journal import Journal
    from sitewhere_tpu_torch.instance import Instance
    from sitewhere_tpu_torch.ops import geo_cuda

    device = resolve_device(spec["device"])
    torch.set_num_threads(2)
    if device.type == "cuda":
        torch.ones(1, device=device)
        torch.cuda.synchronize()
    boot_s = time.time() - spec["spawned_at"]
    data_dir = spec["data_dir"]
    capacity, n_active, width = spec["capacity"], spec["n_active"], \
        spec["width"]
    ring, deadline = spec["ring_depth"], spec["deadline_ms"]
    payloads, keys = keyed_payloads(KILL_PAYLOADS, width, n_active,
                                    KILL_TS0_MS, SEED + 7)
    out = {"role": spec["role"], "point": spec.get("point"),
           "boot_s": boot_s}
    if spec["role"] in ("golden", "kill"):
        inst = instance_from_world(device, spec["world_ckpt"], data_dir,
                                   capacity, width, ring, deadline)
        inst.start()
        disp = inst.dispatcher
        disp.flush()
        inst.checkpointer.save()
        for k, payload in enumerate(payloads):
            disp.ingest_wire_lines(payload)
            if (k + 1) % KILL_SAVE_EVERY == 0:
                disp.flush()
                inst.checkpointer.save()
        disp.flush()
        np.savez(spec["state_out"], **inst.device_state.snapshot_host())
        out["guards"] = fault_counters(inst.metrics)
        inst.stop()
        inst.terminate()
        with open(spec["result_out"], "w") as f:
            json.dump(out, f)
        return
    # verify: what survived, read before the restart opens it
    journal = Journal(data_dir, name="ingest")
    journaled = set()
    for _, p in journal.scan(0):
        first = p[:p.index(b"\n")] if b"\n" in p else p
        t = json.loads(first)["request"]["eventDate"]
        journaled.add((t - KILL_TS0_MS) // 1000 // width)
    journal.close()
    committed_at_kill = spec["committed_at_kill"]
    t0 = time.perf_counter()
    inst = Instance(instance_config(data_dir, capacity, width, ring,
                                    deadline), device=device)
    construct_s = time.perf_counter() - t0
    check(inst.restored, "restart restored no checkpoint")
    launches0 = geo_cuda.launch_counts["pip_parity"]
    t0 = time.perf_counter()
    inst.start()
    start_s = time.perf_counter() - t0
    disp = inst.dispatcher
    gauges = inst.metrics.snapshot()["gauges"]
    missing = [k for k in range(KILL_PAYLOADS) if k not in journaled]
    for k in missing:
        disp.ingest_wire_lines(payloads[k])
    disp.flush()
    launches = geo_cuda.launch_counts["pip_parity"] - launches0
    warm = ring if ring else 1
    uniq, counts, not_measurements = stored_key_counts(inst.event_store)
    expected = np.unique(np.concatenate(keys))
    below = np.unique(np.concatenate(keys[:committed_at_kill])) \
        if committed_at_kill else np.zeros(0, np.int64)
    lost = np.setdiff1d(expected, uniq)
    extra = np.setdiff1d(uniq, expected)
    twice = np.intersect1d(below, uniq[counts > 1])
    out.update({
        "restored_generation": inst.checkpointer.restored_generation,
        "replay_floor": inst.checkpointer.replay_floor,
        "committed_at_kill": committed_at_kill,
        "journaled_payloads": len(journaled),
        "resumed_payloads": len(missing),
        "instance_construct_s": construct_s,
        "restore_s": float(gauges["recovery.restore_s"]),
        "restore": dict(inst.checkpointer.restore_stats),
        "start_s": start_s,
        "warm_up_s": start_s - float(gauges["recovery.replay_s"]),
        "replay_s": float(gauges["recovery.replay_s"]),
        "replay_events": int(gauges["recovery.replay_events"]),
        "steps": disp.steps, "pip_launches": launches - warm,
        "rows_expected": int(expected.size), "rows_stored": int(counts.sum()),
        "lost": int(lost.size), "extra": int(extra.size),
        "below_committed_twice": int(twice.size),
        "rows_not_measurements": not_measurements,
        "stored_twice_above": int((counts > 1).sum()) - int(twice.size),
        "catalog_problems": inst.event_store.verify_catalog(),
        "dedup_floor_after": disp.store_dedup_floor,
        "guards": fault_counters(inst.metrics),
    })
    np.savez(spec["state_out"], **inst.device_state.snapshot_host())
    inst.stop()
    inst.terminate()
    with open(spec["result_out"], "w") as f:
        json.dump(out, f)


def _spawn(spec, env_extra=None):
    """Start one ``--kill-child`` process; its stderr goes to a file next
    to its result (a pipe nobody reads could fill and stall it)."""
    spec = dict(spec, spawned_at=time.time())
    env = dict(os.environ)
    env.pop("SW_CRASHPOINT", None)
    env.update(env_extra or {})
    with open(spec["result_out"] + ".err", "wb") as err:
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--kill-child",
             json.dumps(spec)], env=env, stdout=subprocess.DEVNULL,
            stderr=err, cwd=os.path.dirname(os.path.abspath(__file__)))
    proc.err_path = spec["result_out"] + ".err"
    return proc


def _wait_all(procs, timeout_s):
    """Wait for every child; on a timeout kill every one still running.
    Returns ``{name: (returncode, stderr tail)}``."""
    deadline = time.monotonic() + timeout_s
    out = {}
    try:
        for name, proc in procs.items():
            proc.wait(timeout=max(1.0, deadline - time.monotonic()))
            with open(proc.err_path, "rb") as f:
                err = f.read()[-3000:].decode(errors="replace")
            out[name] = (proc.returncode, err)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


def _read_result(path):
    with open(path) as f:
        return json.load(f)


def _state_close(golden_npz, got_npz):
    """Device state against the golden run's: ints exact, EWMA within
    EWMA_MAX_ULP of the value scale, other floats bitwise.  Returns the
    unequal fields and the EWMA's largest error in ULPs of the scale."""
    a, b = np.load(golden_npz), np.load(got_npz)
    unequal, worst = [], 0.0
    for k in a.files:
        x, y = a[k], b[k]
        if x.dtype != y.dtype or x.shape != y.shape:
            unequal.append(k)
        elif k == "ewma_values":
            err = np.abs(x.astype(np.float64) - y.astype(np.float64))
            scale = np.maximum(np.abs(x), EWMA_SCALE) * 2.0 ** -23
            fin = np.isfinite(x)
            if not np.array_equal(x[~fin], y[~fin], equal_nan=True):
                unequal.append(k)
            worst = max(worst, float((err[fin] / scale[fin]).max()))
            if worst > EWMA_MAX_ULP:
                unequal.append(k)
        elif x.tobytes() != y.tobytes():
            unequal.append(k)
    return unequal, worst


def committed_offset(data_dir):
    try:
        with open(os.path.join(data_dir, "ingest", "pipeline.offset")) as f:
            return int(f.read().strip() or 0)
    except OSError:
        return 0


def kill_recover(device, worlds, root):
    """Golden children and one killed child per crash point, then one
    restart per kill on the survivor's directory (crashrec's protocol).
    The small children run side by side; the full-size restart runs
    alone, so its recovery times are those users would see."""
    def spec(role, name, size, ring, deadline, **kw):
        d = os.path.join(root, name)
        capacity, n_active, width = SIZES[size]
        return dict(role=role, size=size, capacity=capacity,
                    n_active=n_active, width=width, ring_depth=ring,
                    deadline_ms=deadline, data_dir=d,
                    world_ckpt=worlds[size], device=str(device),
                    state_out=os.path.join(root, f"{name}-state.npz"),
                    result_out=os.path.join(root, f"{name}.json"), **kw)

    os.makedirs(root, exist_ok=True)
    specs, procs = {}, {}
    for size in ("full", "small"):
        name = f"golden-{size}"
        specs[name] = spec("golden", name, size, 0, WIRE_DEADLINE_MS)
        procs[name] = _spawn(specs[name])
    for point, hit, size, ring, deadline in KILLS:
        name = f"kill-{point.split('.')[1]}"
        specs[name] = spec("kill", name, size, ring, deadline, point=point)
        procs[name] = _spawn(specs[name],
                             {"SW_CRASHPOINT": f"{point}:{hit}"})
    t0 = time.perf_counter()
    done = _wait_all(procs, 600)
    children_s = time.perf_counter() - t0
    for name, (rc, err) in done.items():
        if name.startswith("golden"):
            check(rc == 0, f"{name} failed (rc {rc}): {err}")
            add_guards("persist_recover",
                       _read_result(specs[name]["result_out"])["guards"])
        else:
            check(rc == -signal.SIGKILL,
                  f"{name} was not killed at its point (rc {rc}): {err}")
    # restarts: the small ones side by side, then the full-size one alone
    verify = {}
    for point, hit, size, ring, deadline in KILLS:
        kname = f"kill-{point.split('.')[1]}"
        d = specs[kname]["data_dir"]
        verify[kname] = spec("verify", f"verify-{kname}", size, ring,
                             deadline, point=point,
                             committed_at_kill=committed_offset(d))
        verify[kname]["data_dir"] = d
    order = ([k for k in verify if specs[k]["size"] == "small"],
             [k for k in verify if specs[k]["size"] == "full"])
    for group in order:
        procs = {k: _spawn(verify[k]) for k in group}
        for name, (rc, err) in _wait_all(procs, 600).items():
            check(rc == 0, f"restart after {name} failed (rc {rc}): {err}")
    runs = []
    for point, hit, size, ring, deadline in KILLS:
        kname = f"kill-{point.split('.')[1]}"
        res = _read_result(verify[kname]["result_out"])
        add_guards("persist_recover", res["guards"])
        unequal, ulp = _state_close(specs[f"golden-{size}"]["state_out"],
                                    verify[kname]["state_out"])
        capacity, n_active, width = SIZES[size]
        res.update({"kill_hit": hit, "size": size, "capacity": capacity,
                    "devices": n_active, "width": width,
                    "payloads": KILL_PAYLOADS, "ring_depth": ring,
                    "deadline_ms": deadline,
                    "state_unequal_fields": unequal,
                    "ewma_max_ulp_of_scale": ulp})
        emit({"phase": "persist_recover", "run": f"kill_recover.{point}",
              **res})
        runs.append(res)
        check(res["lost"] == 0, f"{point}: {res['lost']} committed rows lost")
        check(res["extra"] == 0 and res["rows_not_measurements"] == 0,
              f"{point}: {res['extra']} unknown rows, "
              f"{res['rows_not_measurements']} not measurements")
        check(res["below_committed_twice"] == 0,
              f"{point}: {res['below_committed_twice']} rows below the "
              "committed offset stored twice")
        check(res["catalog_problems"] == [],
              f"{point}: catalog {res['catalog_problems']}")
        check(res["dedup_floor_after"] == 0, f"{point}: dedup floor kept")
        check(res["pip_launches"] == res["steps"],
              f"{point}: kernel launched {res['pip_launches']}x in "
              f"{res['steps']} steps")
        check(not unequal, f"{point}: state differs from golden: {unequal}")
    emit({"phase": "persist_recover", "run": "kill_recover.done",
          "children_s": children_s, "kills": len(runs)})
    return runs


def phase_persist_recover(device, geo_cuda, mixed, meas):
    """Persistence and restart on the wire path: the throughput runs with
    the real segment store over the payloads of ``dispatcher_wire``
    (``mixed``, ``meas``), one full-size checkpoint save and restore, and
    kill -9 recovery at five crash points.  Returns the kernel's launches
    in each throughput run, by run name."""
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="persist-", dir=geo_cuda.BUILD_DIR)
    launches = {}
    try:
        worlds = {size: world_checkpoint(device, root, size)
                  for size in ("full", "small")}
        emit({"phase": "persist_recover", "run": "setup",
              "world_s": time.perf_counter() - t0})
        rec = persist_throughput(device, geo_cuda, worlds["full"],
                                 mixed, root, "ring0")
        launches["persist_throughput.ring0"] = rec["pip_launches"]
        rec = persist_throughput(device, geo_cuda, worlds["full"],
                                 meas, root,
                                 "measurements_ring0", meas=True)
        launches["persist_throughput.measurements_ring0"] = \
            rec["pip_launches"]
        kill_recover(device, worlds, os.path.join(root, "kills"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "persist_recover", "run": "done",
          "seconds": time.perf_counter() - t0})
    return launches


# -- bring-your-own rule programs ------------------------------------------------

_RULEBENCH_POLY = [[0.0, 0.0], [10.0, 0.0], [10.0, 10.0], [0.0, 10.0]]


def rulebench_program_doc(rng, idx):
    """One program of ``tools/rulebench.py``'s skewed mix (its
    ``_program_doc``, copied: that tool imports JAX)."""
    token = f"p{idx}"
    thr = float(rng.uniform(10.0, 90.0))
    op = str(rng.choice(["gt", "lt", "gte", "lte"]))
    level = str(rng.choice(["info", "warning", "error", "critical"]))
    alert = {"type": f"byo.kind{int(rng.integers(0, 16))}",
             "level": level}
    shape = rng.random()
    if shape < 0.55:
        when = {"pred": "value", "op": op, "value": thr}
    elif shape < 0.70:
        when = {"all": [
            {"pred": "ewma", "op": op, "value": thr,
             "window_s": float(rng.choice([60, 600, 3600]))},
            {"pred": "rate", "op": "gt",
             "value": float(rng.uniform(0.1, 5.0))}]}
    elif shape < 0.82:
        when = {"any": [
            {"pred": "value", "op": "gt", "value": thr},
            {"pred": "value", "op": "lt", "value": thr - 30.0},
            {"all": [{"pred": "rate", "op": "gt", "value": 1.0},
                     {"pred": "value", "op": "gt", "value": thr - 10.0}]}]}
    elif shape < 0.90:
        jx, jy = rng.uniform(-2, 2, 2)
        poly = [[x + jx, y + jy] for x, y in _RULEBENCH_POLY]
        when = {"pred": "geo", "polygon": poly,
                "inside": bool(rng.random() < 0.5)}
    elif shape < 0.95:
        when = {"any": [
            {"all": [
                {"pred": "value", "op": "gt", "value": thr},
                {"pred": "attr", "table": "device", "column": "tier",
                 "value": int(rng.integers(0, 4)), "op": "eq"},
                {"pred": "event_type", "value": "measurement"},
                {"pred": "ewma", "op": "gt", "value": thr - 5.0,
                 "window_s": 600.0},
                {"pred": "rate", "op": "gt", "value": 0.5}]},
            {"all": [{"pred": "value", "op": "lt", "value": 5.0}]},
            {"all": [{"pred": "value", "op": "gt", "value": 95.0}]}]}
    else:
        when = {"any": [
            {"all": [{"pred": "geo", "polygon": _RULEBENCH_POLY,
                      "inside": True},
                     {"pred": "value", "op": "gt", "value": thr}]},
            {"all": [{"pred": "rate", "op": "gt", "value": 2.0}]},
            {"all": [{"pred": "value", "op": "lt", "value": 2.0}]}]}
    return {"token": token, "name": f"bench-{idx}", "alert": alert,
            "when": when}


def world_program_docs(tenant, box):
    """The world tenant's RULE_PER_KEY programs of each structure key,
    set to fire on about 1% of the traffic's rows: measurements above 99
    or below 0.3 (values are uniform on [0, 100]) and locations inside
    eight small squares of the traffic's ``box`` (lon0, lon1, lat0,
    lat1).  Every predicate kind appears; some clauses never fire (a
    rate of 1e6/s), as in tenants' real programs."""
    lon0, lon1, lat0, lat1 = box
    side = math.sqrt(RULE_SQUARE_SHARE * (lon1 - lon0) * (lat1 - lat0))

    def square(k):
        cx = lon0 + (lon1 - lon0) * ((3 * k + tenant) % 8 + 0.5) / 8
        cy = lat0 + (lat1 - lat0) * ((5 * k + tenant) % 8 + 0.5) / 8
        h = side / 2
        return [[cx - h, cy - h], [cx + h, cy - h], [cx + h, cy + h],
                [cx - h, cy + h]]

    levels = ("info", "warning", "error", "critical")
    docs = []
    for j in range(RULE_PER_KEY):
        whens = {
            "c2p4": {"pred": "value", "op": "gt", "value": 99.9 + 0.02 * j},
            "c2p4g": {"pred": "geo", "polygon": square(j), "inside": True},
            "c4p4": {"any": [
                {"pred": "value", "op": "lt", "value": 0.3 - 0.05 * j},
                {"pred": "value", "op": "gt", "value": 99.95},
                {"all": [{"pred": "rate", "op": "gt", "value": 1e6},
                         {"pred": "value", "op": "gt", "value": 99.0}]}]},
            "c4p4g": {"any": [
                {"all": [{"pred": "geo", "polygon": square(4 + j),
                          "inside": True},
                         {"pred": "event_type", "value": "location"}]},
                {"all": [{"pred": "ewma", "op": "lt", "value": -1.0,
                          "window_s": 60.0}]},
                {"all": [{"pred": "value", "op": "gt", "value": 99.97}]}]},
            "c4p8": {"any": [
                {"all": [
                    {"pred": "value", "op": "gt", "value": 99.0},
                    {"pred": "attr", "table": "device", "column": "tier",
                     "op": "eq", "value": j},
                    {"pred": "event_type", "value": "measurement"},
                    {"pred": "ewma", "op": "gt", "value": 95.0,
                     "window_s": 600.0},
                    {"pred": "attr", "table": "asset", "column": "grade",
                     "op": "gte", "value": 0},
                    {"pred": "value", "op": "lt", "value": 1000.0}]},
                {"all": [{"pred": "value", "op": "lt", "value": 0.02}]},
                {"all": [{"pred": "rate", "op": "lt", "value": -1e6}]}]},
        }
        for key in RULE_KEYS:
            docs.append({"token": f"w{tenant}-{key}-{j}",
                         "alert": {"type": f"world.{key}.{j}",
                                   "level": levels[j]},
                         "when": whens[key]})
    return docs


def load_rule_programs(eng, world_tenants, box, n_devices, seed):
    """The world tenants' programs, the rulebench population over tenants
    after them, and the attribute columns (``tier`` for every active
    device, ``grade`` for every asset), through the registry and one
    publish.  Returns a record of the load."""
    from sitewhere_tpu_torch.rules import compile as rcompile

    t0 = time.perf_counter()
    for tenant in world_tenants:
        for doc in world_program_docs(tenant, box):
            eng.registry.put_program(tenant, doc)
    rng = np.random.default_rng(seed)
    rejected = 0
    base = max(world_tenants) + 1
    for i in range(RULE_POP_PROGRAMS):
        doc = rulebench_program_doc(rng, i)
        try:
            eng.registry.put_program(
                base + int(rng.integers(0, RULE_POP_TENANTS)), doc)
        except ValueError:
            # a per-tenant structure-slot collision of the random draw
            rejected += 1
    ids = np.arange(n_devices)
    eng.attributes.set_many("device", ids, "tier", ids % 4)
    assets = np.arange(5000)
    eng.attributes.set_many("asset", assets, "grade", assets % 3)
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    epoch = eng.refresh()
    publish_s = time.perf_counter() - t0
    world = sorted(world_tenants)
    codes = {p.alert_code for g in eng.registry._groups.values()
             for (t, _), p in g.programs.items() if t in world}
    keys = eng.registry.structure_keys()
    check(keys == sorted(RULE_KEYS), f"structure keys {keys}")
    return {"programs": eng.registry.program_count(),
            "world_programs": len(world) * RULE_PER_KEY * len(RULE_KEYS),
            "population_rejected": rejected, "structure_keys": keys,
            "tables": {g.key: {n: list(t.shape) for n, t in
                               zip(g.tables._fields, g.tables)}
                       for g in epoch.groups},
            "signatures": rcompile.compile_count(),
            "load_s": load_s, "publish_s": publish_s,
            "alert_codes": codes}


def rule_batches(n, width, seed, ts0=1_700_000_000):
    """Engine batches: the main path's 60/30/10 columns with the accepted
    mask the step would give (valid, registered, tenant matching) and the
    registry's asset id."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        c = make_batch_cols(rng, width, N_ACTIVE, CAPACITY, ts0 + i)
        dev = c["device_id"]
        reg = dev < N_ACTIVE
        out.append({
            "device_id": dev, "tenant_id": c["tenant_id"],
            "event_type": c["event_type"], "mtype_id": c["mtype_id"],
            "value": c["value"], "lon": c["lon"], "lat": c["lat"],
            "ts_s": c["ts_s"], "ts_ns": c["ts_ns"],
            "asset_id": np.where(reg, dev % 5000, -1).astype(np.int32),
            "accepted": c["valid"] & reg & (c["tenant_id"] == dev % N_TENANTS),
        })
    return out


class PassClock:
    """CUDA events and the allocator's peak around the engine's prepare
    pass and each group pass (by structure key), on the stream they run
    on.  Nothing on the CPU."""

    def __init__(self, eng, device):
        import torch

        from sitewhere_tpu_torch.rules import compile as rcompile

        self.torch, self.rcompile = torch, rcompile
        self.on = device.type == "cuda"
        self.eng = eng
        self.keys = {g.tables.kind.data_ptr(): g.key
                     for g in eng.registry.current_epoch().groups}
        self.pairs = collections.defaultdict(list)
        self.peak = collections.defaultdict(float)
        self.max_allocated = 0
        self._group = rcompile.rules_group_eval
        self._prepare = eng._prepare

    def _timed(self, name, fn, *args, **kw):
        torch = self.torch
        if not self.on:
            return fn(*args, **kw)
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args, **kw)
        end.record()
        self.pairs[name].append((start, end))
        top = torch.cuda.max_memory_allocated()
        self.peak[name] = max(self.peak[name], top - base)
        self.max_allocated = max(self.max_allocated, top)
        return out

    def __enter__(self):
        def group(tables, *args, **kw):
            return self._timed(self.keys[tables.kind.data_ptr()],
                               self._group, tables, *args, **kw)

        self.rcompile.rules_group_eval = group
        self.eng._prepare = lambda *a: self._timed("prepare",
                                                   self._prepare, *a)
        return self

    def __exit__(self, *exc):
        self.rcompile.rules_group_eval = self._group
        self.eng._prepare = self._prepare
        return False

    def ms_per_batch(self, batches):
        if not self.on:
            return None
        self.torch.cuda.synchronize()
        return {k: sum(s.elapsed_time(e) for s, e in v) / batches
                for k, v in self.pairs.items()}


def _run_passes(eng, batch, trail, device, tables_of):
    """The prepare and group passes of ``_eval_batch``, called directly on
    ``device`` with the given trail (updated in place) and the current
    epoch's tables as ``tables_of(group)`` gives them.  Returns the
    features and ``{key: (fired, code, level, pid)}`` on the host."""
    import torch

    from sitewhere_tpu_torch.rules import compile as rcompile

    attrs = eng.attributes.publish()
    t = {k: torch.from_numpy(np.ascontiguousarray(batch[k])).to(device)
         for k in ("device_id", "asset_id", "ts_s", "ts_ns", "mtype_id",
                   "event_type", "tenant_id", "value", "lon", "lat",
                   "accepted")}
    feats, _ = rcompile.rules_prepare_batch(
        *trail, attrs.device.to(device), attrs.asset.to(device),
        t["device_id"], t["asset_id"], t["ts_s"], t["ts_ns"], t["mtype_id"],
        t["value"], t["event_type"], t["accepted"], eng.taus.to(device))
    outs = {}
    for g in eng.registry.current_epoch().groups:
        out = rcompile.rules_group_eval(
            tables_of(g), feats, t["tenant_id"], t["event_type"],
            t["mtype_id"], t["value"], t["lon"], t["lat"], t["accepted"],
            has_geo=g.has_geo)
        outs[g.key] = tuple(x.cpu().numpy() for x in out)
    return {k: v.cpu().numpy() for k, v in feats._asdict().items()}, outs


def _ulp_of(ref, got, floor):
    """Largest ``|ref - got|`` in ULPs of ``max(|ref|, floor)`` (finite
    entries; non-finite ones must match)."""
    fin = np.isfinite(ref)
    check(np.array_equal(ref[~fin], got[~fin], equal_nan=True),
          "non-finite entries differ")
    if not fin.any():
        return 0.0
    err = np.abs(ref[fin].astype(np.float64) - got[fin].astype(np.float64))
    unit = np.spacing(np.maximum(np.abs(ref[fin]), np.float32(floor)))
    return float((err / unit).max())


def rules_card_vs_cpu(eng, device, batches):
    """At RULE_CPU_ROWS rows: the passes on the card and on the CPU, from
    the same trail (a copy of the engine's), over two consecutive
    batches: fired/code/level/pid and the trail's ints exact, features
    within the ULP bounds."""
    import torch

    cpu = torch.device("cpu")
    card_trail = tuple(x.clone() for x in eng._trail)
    cpu_trail = tuple(x.to(cpu, copy=True) for x in card_trail)
    worst = {"ewma": 0.0, "rate": 0.0}
    fired = 0
    for batch in batches:
        fc, oc = _run_passes(eng, batch, card_trail, device,
                             lambda g: g.tables)
        fh, oh = _run_passes(
            eng, batch, cpu_trail, cpu,
            lambda g: type(g.tables)(*(x.cpu() for x in g.tables)))
        for key in oc:
            for name, a, b in zip(("fired", "code", "level", "pid"),
                                  oh[key], oc[key]):
                check(np.array_equal(a, b),
                      f"card != CPU: {key} {name} "
                      f"({int((a != b).sum())} entries)")
            fired += int(oc[key][0].sum())
        for name in ("rate_valid", "dev_attr", "asset_attr"):
            check(np.array_equal(fh[name], fc[name]), f"card != CPU: {name}")
        worst["ewma"] = max(worst["ewma"], _ulp_of(fh["ewma"], fc["ewma"],
                                                   EWMA_SCALE))
        worst["rate"] = max(worst["rate"], _ulp_of(fh["rate"], fc["rate"],
                                                   np.finfo(np.float32).tiny))
    for i, (a, b) in enumerate(zip(cpu_trail, card_trail)):
        if i < 3:
            # bitwise (NaN measurements are stored as they came)
            check(a.numpy().tobytes() == b.cpu().numpy().tobytes(),
                  f"card != CPU: trail {i}")
        else:
            worst["ewma"] = max(worst["ewma"], _ulp_of(
                a.numpy(), b.cpu().numpy(), EWMA_SCALE))
    check(worst["ewma"] <= EWMA_MAX_ULP, f"EWMA off by {worst['ewma']} ULP")
    check(worst["rate"] <= RATE_MAX_ULP, f"rate off by {worst['rate']} ULP")
    check(fired > 0, "nothing fired in the card-vs-CPU batches")
    return {"rows": len(batches[0]["device_id"]), "batches": len(batches),
            "fired": fired, "ewma_max_ulp_of_scale": worst["ewma"],
            "rate_max_ulp": worst["rate"]}


def rules_card_vs_interp(eng, device, batch):
    """At RULE_INTERP_ROWS rows: the card's alerts, (row, code, level) as
    a multiset, against the port's numpy interpreter over the world
    tenants' programs, from the same trail."""
    from sitewhere_tpu_torch.rules.interp import (
        InterpTrail, interp_eval, interp_features)

    card_trail = tuple(x.clone() for x in eng._trail)
    trail = InterpTrail(*card_trail[3].shape)
    trail.ts_s, trail.ts_ns, trail.value, trail.ewma = (
        x.to("cpu", copy=True).numpy() for x in card_trail)
    _, outs = _run_passes(eng, batch, card_trail, device, lambda g: g.tables)
    card = collections.Counter()
    for fired, code, level, _pid in outs.values():
        rows, slots = np.nonzero(fired)
        card.update(zip(rows.tolist(), code[rows, slots].tolist(),
                        level[rows, slots].tolist()))
    _, arrays = eng.attributes.snapshot_payload()
    tenants = set(np.unique(batch["tenant_id"]).tolist())
    progs = [(t, p.canonical, p.alert_code)
             for g in eng.registry._groups.values()
             for (t, _tok), p in sorted(g.programs.items()) if t in tenants]
    t0 = time.perf_counter()
    feats = interp_features(trail, batch, eng.taus.cpu().tolist(),
                            arrays["device"], arrays["asset"])
    golden = collections.Counter(
        (row, code, lvl) for row, _tok, code, lvl in
        interp_eval(progs, batch, feats))
    interp_s = time.perf_counter() - t0
    check(card == golden,
          f"card != interp: {sum((card - golden).values())} extra, "
          f"{sum((golden - card).values())} missing alerts")
    check(sum(card.values()) > 0, "nothing fired in the interp batch")
    return {"rows": len(batch["device_id"]), "programs": len(progs),
            "alerts": sum(card.values()), "interp_s": interp_s}


def rules_engine_run(device):
    """``rules_engine``: RULE_BATCHES full-width 60/30/10 batches straight
    into the engine's ``_eval_batch``: ms per batch of each pass, engine
    events/s, the allocator's peak, the card's busy share under the
    profiler; then the card against the CPU and against ``interp``."""
    import torch

    from sitewhere_tpu_torch.rules.engine import RuleEngineRunner

    t0 = time.perf_counter()
    eng = RuleEngineRunner(capacity=CAPACITY, n_mtype_slots=M_SLOTS,
                           asset_capacity=RULE_ASSET_CAPACITY, device=device)
    alerts = []
    eng.inject = lambda cols: alerts.append(len(cols["device_id"]))
    load = load_rule_programs(eng, range(N_TENANTS), (-12, 12, -12, 12),
                              N_ACTIVE, SEED + 8)
    batches = rule_batches(1 + RULE_BATCHES + RULE_PROFILED, FULL_B,
                           SEED + 9)
    setup_s = time.perf_counter() - t0
    eng._eval_batch(dict(batches[0]))                 # seeds the trail
    sync = torch.cuda.synchronize if device.type == "cuda" else (
        lambda: None)
    sync()
    alerts.clear()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    timed = batches[1:1 + RULE_BATCHES]
    with PassClock(eng, device) as clock:
        t0 = time.perf_counter()
        for b in timed:
            eng._eval_batch(dict(b))
        sync()
        elapsed = time.perf_counter() - t0
    pass_ms = clock.ms_per_batch(len(timed))
    rows = sum(len(b["device_id"]) for b in timed)
    accepted = sum(int(b["accepted"].sum()) for b in timed)
    n_alerts = sum(alerts)
    with _device_profile(device.type == "cuda") as prof:
        t1 = time.perf_counter()
        for b in batches[1 + RULE_BATCHES:]:
            eng._eval_batch(dict(b))
        sync()
        prof_s = time.perf_counter() - t1
    dev_ms = _device_ms(prof)
    rec = {"phase": "byo_rules", "run": "rules_engine",
           "capacity": CAPACITY, "width": FULL_B, "batches": len(timed),
           "world_tenants": N_TENANTS, **{k: v for k, v in load.items()
                                          if k != "alert_codes"},
           "setup_s": setup_s, "elapsed_s": elapsed,
           "engine_events_per_s": rows / elapsed,
           "ms_per_batch": elapsed / len(timed) * 1e3,
           "pass_ms_per_batch": pass_ms,
           "pass_transient_peak_mib": (
               {k: v / 2**20 for k, v in clock.peak.items()}
               if clock.on else None),
           "peak_allocated_gib": (clock.max_allocated / 2**30
                                  if clock.on else None),
           "run_base_allocated_gib": (base / 2**30 if device.type == "cuda"
                                      else None),
           "alerts": n_alerts, "alerts_per_accepted_row": n_alerts / accepted,
           "profiled_batches": RULE_PROFILED, "profiled_s": prof_s,
           "device_ms_per_batch": (None if dev_ms is None
                                   else dev_ms / RULE_PROFILED),
           "device_busy_share": (None if dev_ms is None
                                 else dev_ms / 1e3 / prof_s),
           "device_ops_per_batch": (None if prof is None
                                    else _device_launches(prof)
                                    / RULE_PROFILED)}
    emit(rec)
    check(n_alerts > 0, "no program fired in rules_engine")
    # the checks, on batches the timed run never saw
    tail = rule_batches(3, RULE_CPU_ROWS, SEED + 10,
                        ts0=1_700_000_000 + 2 * len(batches))
    cpu_rec = rules_card_vs_cpu(eng, device, tail[:2])
    interp_batch = {k: v[:RULE_INTERP_ROWS] for k, v in tail[2].items()}
    interp_rec = rules_card_vs_interp(eng, device, interp_batch)
    emit({"phase": "byo_rules", "run": "rules_engine.checks",
          "card_vs_cpu": cpu_rec, "card_vs_interp": interp_rec})
    return rec


def phase_byo_rules(device, geo_cuda, mixed):
    """Bring-your-own rule programs on the port: ``rules_engine`` (the
    engine alone at full width), then ``rules_wire``: the 60/30/10
    payloads of ``dispatcher_wire`` through the port ``Instance`` with
    its segment store, ring off at 5 ms, without programs and with them
    (the world tenant's programs, the population, the attributes), each
    program alert checked stored exactly once, and checkpoint_full with
    the ``rule-programs`` section.  Returns the kernel's launches in each
    wire run, by run name."""
    t0 = time.perf_counter()
    rules_engine_run(device)
    root = tempfile.mkdtemp(prefix="rules-", dir=geo_cuda.BUILD_DIR)
    launches = {}
    try:
        world = world_checkpoint(device, root, "full")

        def programs(inst):
            return load_rule_programs(
                inst.rule_engine, [inst.identity.tenant.mint("default")],
                (-175, 175, -85, 85), N_ACTIVE, SEED + 11)

        for run, rules in (("off", None), ("on", programs)):
            rec = persist_throughput(
                device, geo_cuda, world, mixed, root,
                f"rules_{run}",
                rules=rules, phase="byo_rules", name=f"rules_wire.{run}")
            launches[f"rules_wire.{run}"] = rec["pip_launches"]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "byo_rules", "run": "done",
          "seconds": time.perf_counter() - t0})
    return launches


# -- streaming analytics ---------------------------------------------------------


def an_span_ms(rows=None, devices=None):
    """Event time of one batch of ``rows`` rows over ``devices`` devices
    at one report per device per AN_REPORT_S (full width: ~7.9 s)."""
    rows = FULL_B if rows is None else rows
    devices = N_ACTIVE if devices is None else devices
    return int(round(rows / devices * AN_REPORT_S * 1000))


def an_values(rng, n):
    """Measurement values: AN_SET_POINT +- AN_SPREAD_EIGHTHS / 8, on the
    1/8 grid."""
    k = rng.integers(-AN_SPREAD_EIGHTHS, AN_SPREAD_EIGHTHS + 1, n)
    return (AN_SET_POINT + k / 8).astype(np.float32)


def an_check_prefix(value, cross_rows):
    """The window-cross feature's prefix sums over one batch stay exact in
    float32: the sum of |value| over its rows is under 2^21."""
    bound = float(np.abs(value[cross_rows].astype(np.float64)).sum())
    check(bound < AN_PREFIX_BOUND,
          f"a batch's cross-feature prefix reaches {bound} >= 2^21")


def an_payloads(rng, n_payloads, lines, ts0_ms):
    """rules_wire's payload shape (60/30/10 measurements, locations and
    alerts, WIRE_GHOSTS unregistered tokens) on this phase's event time:
    payload p spans ``an_span_ms()`` from ``ts0_ms + p * span``, its lines
    in time order (a gateway's batch); values on the 1/8 grid print as
    exact decimals.  Returns ``[(bytes, registered_lines)]``."""
    span = an_span_ms()
    out = []
    for p in range(n_payloads):
        dev = rng.integers(0, N_ACTIVE, lines)
        ghost = rng.random(lines) < WIRE_GHOSTS
        kind = rng.choice(3, lines, p=[0.6, 0.3, 0.1])
        value = an_values(rng, lines)
        lat = rng.uniform(-85, 85, lines)
        lon = rng.uniform(-175, 175, lines)
        ts = ts0_ms + span * p + np.sort(rng.integers(0, span, lines))
        an_check_prefix(value, (kind == 0) & (dev % M_SLOTS == 0) & ~ghost)
        body = []
        for d, g, k, v, la, lo, t in zip(
                dev.tolist(), ghost.tolist(), kind.tolist(), value.tolist(),
                lat.tolist(), lon.tolist(), ts.tolist()):
            tok = f"x-{d}" if g else f"d-{d}"
            if k == 0:
                body.append(_M_LINE % (tok, d % M_SLOTS, v, t))
            elif k == 1:
                body.append(_L_LINE % (tok, la, lo, v, t))
            else:
                body.append(_A_LINE % (tok, d % 4, t))
        out.append(("\n".join(body).encode(), lines - int(ghost.sum())))
    return out


def an_batches(rng, n, width, ts0_s, devices=None):
    """Runner batches: the accepted rows of payloads shaped as
    :func:`an_payloads`'s, as the egress offer hands them over (device,
    time, type, measurement, value, journal ref); batch b spans
    ``an_span_ms(width, devices)`` from ``ts0_s + b * span``."""
    devices = N_ACTIVE if devices is None else devices
    span = an_span_ms(width, devices)
    out = []
    for b in range(n):
        dev = rng.integers(0, devices, width).astype(np.int32)
        kind = rng.choice(3, width, p=[0.6, 0.3, 0.1]).astype(np.int32)
        ts_ms = ts0_s * 1000 + span * b + np.sort(rng.integers(0, span,
                                                               width))
        mt = np.where(kind == 0, dev % M_SLOTS, -1).astype(np.int32)
        value = np.where(kind == 0, an_values(rng, width), 0.0)
        an_check_prefix(value, mt == 0)
        out.append({"device_id": dev, "ts_s": (ts_ms // 1000).astype(np.int32),
                    "event_type": kind, "mtype_id": mt,
                    "value": value.astype(np.float32),
                    "payload_ref": np.full(width, -1, np.int32)})
    return out


def an_resolve():
    return {f"m{m}": m for m in range(M_SLOTS)}.__getitem__


class QueryClock:
    """CUDA events and the allocator's peak around each query's share of a
    batch (its operator and its one host copy), on the runner's stream
    where it runs.  Nothing on the CPU."""

    def __init__(self, runner, device):
        import torch

        self.torch = torch
        self.on = device.type == "cuda"
        self.compiled = {n: e.compiled for n, e in runner._queries.items()}
        self.pairs = collections.defaultdict(list)
        self.peak = collections.defaultdict(float)
        self.max_allocated = 0

    def _timed(self, name, fn, staged):
        torch = self.torch
        if not self.on:
            return fn(staged)
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(staged)
        end.record()
        self.pairs[name].append((start, end))
        top = torch.cuda.max_memory_allocated()
        self.peak[name] = max(self.peak[name], top - base)
        self.max_allocated = max(self.max_allocated, top)
        return out

    def __enter__(self):
        for name, c in self.compiled.items():
            c.eval_staged = functools.partial(self._timed, name,
                                              c.eval_staged)
        return self

    def __exit__(self, *exc):
        for c in self.compiled.values():
            del c.eval_staged
        return False

    def ms_per_batch(self, batches):
        if not self.on:
            return None
        self.torch.cuda.synchronize()
        return {k: sum(s.elapsed_time(e) for s, e in v) / batches
                for k, v in self.pairs.items()}


def an_bound_ms(doc, batch):
    """The least card time of one query's batch: the bytes it must move
    over the HBM rate (its columns read once; the state rows of the
    devices it touches read and written once; the matches are a few
    rows).  Its operations (a few compares and adds per row) bound it far
    lower."""
    dev = batch["device_id"]
    n = dev.size
    if doc["kind"] == "window":
        rows = (batch["event_type"] == 0) & (batch["mtype_id"] == 0)
        length = doc.get("length", 1)
        state = 24 + (24 * length if length > 1 else 0)
        cols = 21        # device, time, type, measurement, value, valid
    elif doc["kind"] == "session":
        rows, state, cols = np.ones(n, bool), 12, 9
    else:
        rows, state, cols = np.ones(n, bool), 28, 21
    touched = np.unique(dev[rows]).size
    return (n * cols + 2 * touched * state) / PEAK_HBM_BYTES * 1e3


def analytics_engine_run(device):
    """``analytics_engine``: the ``QueryRunner`` alone at the deployment's
    size, AN_BATCHES full-width batches straight into ``_eval_batch``:
    card ms per batch of each query (CUDA events) beside its HBM bound,
    CEP passes, host copies and the transient peak per batch, the
    operators' state bytes, events/s, and the card's busy share under
    the profiler in AN_PROFILED more batches."""
    import torch

    from sitewhere_tpu_torch.analytics.runner import QueryRunner

    t0 = time.perf_counter()
    runner = QueryRunner(CAPACITY, resolve_mtype=an_resolve(),
                         device=device)
    for doc in AN_QUERIES:
        runner.register(doc)
    batches = an_batches(np.random.default_rng(SEED + 12),
                         1 + AN_BATCHES + AN_PROFILED, FULL_B, 1_700_000_000)
    setup_s = time.perf_counter() - t0
    sync = torch.cuda.synchronize if device.type == "cuda" else (
        lambda: None)
    runner._eval_batch(dict(batches[0]))
    sync()
    entries = runner._queries
    cep = entries["cross-alert"].compiled.evaluator
    copies0 = {n: e.compiled.copies[0] for n, e in entries.items()}
    matches0 = {n: e.counter.value for n, e in entries.items()}
    passes0 = cep.passes
    timed = batches[1:1 + AN_BATCHES]
    with QueryClock(runner, device) as clock:
        t0 = time.perf_counter()
        for b in timed:
            runner._eval_batch(dict(b))
        sync()
        elapsed = time.perf_counter() - t0
    query_ms = clock.ms_per_batch(len(timed))
    nb = len(timed)
    bounds = {d["name"]: sum(an_bound_ms(d, b) for b in timed) / nb
              for d in AN_QUERIES}
    rows = sum(b["device_id"].size for b in timed)
    with _device_profile(device.type == "cuda") as prof:
        t1 = time.perf_counter()
        for b in batches[1 + AN_BATCHES:]:
            runner._eval_batch(dict(b))
        sync()
        prof_s = time.perf_counter() - t1
    dev_ms = _device_ms(prof)
    state_bytes = {n: int(sum(a.nbytes for a in e.compiled.export_state()
                              .values())) for n, e in entries.items()}
    rec = {"phase": "streaming_analytics", "run": "analytics_engine",
           "capacity": CAPACITY, "devices": N_ACTIVE, "width": FULL_B,
           "batches": nb, "batch_span_ms": an_span_ms(),
           "setup_s": setup_s, "elapsed_s": elapsed,
           "engine_events_per_s": rows / elapsed,
           "ms_per_batch": elapsed / nb * 1e3,
           "query_ms_per_batch": query_ms,
           "query_bound_ms": bounds, "bound_by": "bytes",
           "query_bound_share": (None if query_ms is None else {
               n: bounds[n] / ms for n, ms in query_ms.items()}),
           "cep_passes_per_batch": (cep.passes - passes0) / nb,
           "d2h_copies_per_batch": {
               n: (e.compiled.copies[0] - copies0[n]) / nb
               for n, e in entries.items()},
           "transient_peak_mib": ({k: v / 2**20 for k, v in
                                   clock.peak.items()} if clock.on else None),
           "peak_allocated_gib": (clock.max_allocated / 2**30
                                  if clock.on else None),
           "state_bytes": state_bytes,
           "matches": {n: e.counter.value - matches0[n]
                       for n, e in entries.items()},
           "window_occupancy": runner._m_occupancy.value,
           "profiled_batches": AN_PROFILED, "profiled_s": prof_s,
           "device_ms_per_batch": (None if dev_ms is None
                                   else dev_ms / AN_PROFILED),
           "device_busy_share": (None if dev_ms is None
                                 else dev_ms / 1e3 / prof_s),
           "device_ops_per_batch": (None if prof is None
                                    else _device_launches(prof)
                                    / AN_PROFILED)}
    emit(rec)
    # a 120 s-gap session closes only after two minutes of silence, rare
    # in the run's ~3 minutes of event time: its matches come at flush
    check(all(v for n, v in rec["matches"].items() if n != "burst"),
          f"a query never matched in analytics_engine: {rec['matches']}")
    return rec


def analytics_card_vs_cpu(device):
    """AN_CPU_ROWS rows in two batches over AN_CPU_DEVICES devices
    through the four queries on the card and on the port's CPU path: the
    matches (the flush's too) and the exported state bitwise equal."""
    import torch

    from sitewhere_tpu_torch.analytics.query import compile_query, parse_query

    resolve = an_resolve()
    batches = an_batches(np.random.default_rng(SEED + 14), 2, AN_CPU_ROWS,
                         1_700_000_000, devices=AN_CPU_DEVICES)
    out = {}
    for doc in AN_QUERIES:
        runs = []
        for dev in (device, torch.device("cpu")):
            c = compile_query(parse_query(doc, resolve), CAPACITY,
                              resolve_mtype=resolve, device=dev)
            matches = [m.to_dict() for b in batches for m in c.eval_cols(b)]
            state = c.export_state()
            matches += [m.to_dict() for m in c.flush()]
            runs.append((matches, state))
        (gm, gs), (cm, cs) = runs
        unequal = sorted(k for k in gs if gs[k].dtype != cs[k].dtype
                         or gs[k].tobytes() != cs[k].tobytes())
        out[doc["name"]] = {"matches": len(gm), "matches_equal": gm == cm,
                            "unequal_state": unequal}
    emit({"phase": "streaming_analytics", "run": "card_vs_cpu",
          "rows": AN_CPU_ROWS, "batches": 2, "devices": AN_CPU_DEVICES,
          "queries": out})
    for name, r in out.items():
        check(r["matches_equal"] and not r["unequal_state"],
              f"card != CPU for {name}: {r}")
    check(sum(r["matches"] for r in out.values()) > 0,
          "card_vs_cpu: no query matched")


def phase_streaming_analytics(device, geo_cuda):
    """Streaming analytics on the port: ``analytics_engine`` (the runner
    alone at full width), ``card_vs_cpu`` (8192 rows, bitwise), then
    ``analytics_wire``: rules_wire.on's run through the ``Instance`` with
    the four queries registered, on payloads regenerated with this
    phase's event time and 1/8-grid values; every query's live matches
    checked equal to ``run_retrospective`` over the sealed store, and
    checkpoint_full with the ``analytics`` section.  Returns the kernel's
    launches in the wire run, by run name."""
    t0 = time.perf_counter()
    analytics_engine_run(device)
    analytics_card_vs_cpu(device)
    root = tempfile.mkdtemp(prefix="analytics-", dir=geo_cuda.BUILD_DIR)
    launches = {}
    try:
        world = world_checkpoint(device, root, "full")

        def programs(inst):
            return load_rule_programs(
                inst.rule_engine, [inst.identity.tenant.mint("default")],
                (-175, 175, -85, 85), N_ACTIVE, SEED + 11)

        payloads = an_payloads(np.random.default_rng(SEED + 13),
                               AN_WIRE_PAYLOADS, FULL_B, WIRE_TS0_MS)
        rec = persist_throughput(
            device, geo_cuda, world, payloads, root, "analytics",
            rules=programs, phase="streaming_analytics",
            name="analytics_wire", analytics=AN_QUERIES)
        launches["analytics_wire"] = rec["pip_launches"]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "streaming_analytics", "run": "done",
          "seconds": time.perf_counter() - t0})
    return launches


# -- device services -------------------------------------------------------------

# The command devices: c-0 .. c-19999 created through DeviceManagement with
# their assignments, every 20th a gateway.  REST invocations, half ping
# and half set-rate, go to the first DS_INVOCATIONS of them (5% gateways),
# arriving at DS_RATE_PER_S.  create_command_invocation journals the
# invocation and then flushes the dispatcher (the reference's design): one
# full-width step and one offset commit per call, serialized on the step
# lock, so the count is cut from one per device to what fits the phase
DS_DEVICES, DS_GATEWAY_EVERY = 20_000, 20
DS_INVOCATIONS = 1_000
# The phase takes the first 8 of the 24 wire payloads: where its plans
# split payloads, each split record's rows of devices that only the
# mirror knows fail registration with a logged traceback (the
# reference's), 10,000 or more per plan, and at 24 payloads the phase
# alone took 151-233 s of the script's 1,200
DS_PAYLOADS = 8
DS_RATE_PER_S = 2_000.0
# arrivals are paced on one thread and served by a pool, as a REST front
# end's handler threads serve them
DS_HANDLERS = 32
# NDJSON command lines, spread over every third wire payload
DS_CMD_LINES, DS_CMD_EVERY = 64, 3
# every DS_C_EVERY-th registered wire line comes from a c-* device: their
# stored rows per sent line show the straddled-payload replays (devices
# only in the mirror are refused instead)
DS_C_EVERY = 100
DS_ASSETS = 1_000
_C_LINE = ('{"deviceToken":"c-%d","type":"CommandInvocation","request":'
           '{"commandToken":"ping","eventDate":%d}}')


class LogTally:
    """A root log handler for the whole run: every record is formatted,
    its traceback included, and written to a file under the build
    directory (removed at the end), so the records the reference's
    registration logs cost what they cost without flooding the output;
    counts by logger, level and traceback.  Configured as a service
    logging at volume is (the logging HOWTO's "Optimization"): a
    buffered file flushed at close, no caller frame, thread or process
    lookups per record."""

    _FAST = {"logThreads": False, "logProcesses": False,
             "logMultiprocessing": False, "_srcfile": None}

    def __init__(self, path):
        import logging

        self.path = path
        self.counts = collections.Counter()
        self.first = {}
        self.bytes = 0
        self.saved = {k: getattr(logging, k) for k in self._FAST}
        for k, v in self._FAST.items():
            setattr(logging, k, v)
        self.stream = open(path, "w", buffering=1 << 20)

        class Buffered(logging.StreamHandler):
            def flush(self):
                pass

        handler = Buffered(self.stream)
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s %(message)s"))
        tally = self

        class Counting(logging.Filter):
            def filter(self, record):
                key = (record.name, record.levelname,
                       record.exc_info is not None)
                tally.counts[key] += 1
                if key not in tally.first:
                    tally.first[key] = record.getMessage()[:160]
                return True

        handler.addFilter(Counting())
        self.handler = handler
        logging.getLogger().addHandler(handler)

    def snapshot(self):
        return collections.Counter(self.counts)

    def since(self, before):
        out = {}
        for (name, level, tb), n in (self.counts - before).items():
            key = f"{name}:{level}" + (":traceback" if tb else "")
            out[key] = n
        return out

    def close(self):
        import logging

        logging.getLogger().removeHandler(self.handler)
        self.handler.close()
        self.stream.close()
        for k, v in self.saved.items():
            setattr(logging, k, v)
        self.bytes = os.path.getsize(self.path)
        os.remove(self.path)


def ds_payloads(mixed):
    """The 60/30/10 wire payloads with every DS_C_EVERY-th registered
    line sent by a c-* device, and 64 NDJSON command lines of c-* sensors
    in place of registered lines of every third payload (their records
    are not one JSON document).  Returns ``(payloads, command lines as
    (payload index, device token), ghost lines per token, c-* event lines
    per token)``."""
    import re

    out, cmd_lines = [], []
    ghosts, c_lines = collections.Counter(), collections.Counter()
    hosts = range(0, len(mixed), DS_CMD_EVERY)
    per = dict(zip(hosts, (len(a) for a in np.array_split(
        np.arange(DS_CMD_LINES), len(hosts)))))
    k = 0
    for p, (payload, registered) in enumerate(mixed):
        ghosts.update(t.decode() for t in
                      re.findall(rb'"deviceToken":"(x-\d+)"', payload))
        lines = payload.split(b"\n")
        for pos in range(DS_C_EVERY // 2, len(lines), DS_C_EVERY):
            line = lines[pos]
            if b'"x-' in line:
                continue
            dev = (p * len(lines) + pos) // DS_C_EVERY % DS_DEVICES
            cut = line.index(b'","type"')
            lines[pos] = b'{"deviceToken":"c-%d' % dev + line[cut:]
            c_lines[f"c-{dev}"] += 1
        for pos in np.linspace(16, len(lines) - 16,
                               per.get(p, 0)).astype(int):
            while b'"x-' in lines[pos] or b'"c-' in lines[pos]:
                pos += 1
            dev = (k * 37 + 1) % DS_DEVICES
            if dev % DS_GATEWAY_EVERY == 0:
                dev += 1
            lines[pos] = (_C_LINE % (dev, WIRE_TS0_MS + 1000 * p)).encode()
            cmd_lines.append((p, f"c-{dev}"))
            k += 1
        out.append((b"\n".join(lines), registered))
    return out, cmd_lines, ghosts, c_lines


class Gateway:
    """An SMS/webhook gateway stand-in on 127.0.0.1: records each POST's
    arrival time and form body."""

    def __init__(self):
        import http.server
        import threading

        self.got = []

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(handler):
                n = int(handler.headers.get("Content-Length", 0))
                body = handler.rfile.read(n)
                self.got.append((time.perf_counter(), body))
                handler.send_response(204)
                handler.end_headers()

            def log_message(handler, *args):
                pass

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                      Handler)
        self.server.daemon_threads = True
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}/sms"

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(10.0)


def ds_populate(inst):
    """Device types, commands, assets and the command devices with their
    assignments, through the instance's own services; µs per call."""
    dm, am = inst.device_management, inst.assets
    for dtype in ("sensor", "gateway"):
        dm.create_device_type(token=dtype, name=dtype.title())
        dm.create_device_command(dtype, token="ping", name="ping",
                                 namespace="sw")
        dm.create_device_command(
            dtype, token="set-rate", name="setRate", namespace="sw",
            parameters=[("rate", "int32", True), ("unit", "string", False)])
    am.create_asset_type("gw-hw", name="Gateway hardware",
                         category="hardware")
    for a in range(DS_ASSETS):
        am.create_asset(f"gw-asset-{a}", name=f"Gateway {a}",
                        asset_type="gw-hw")
    t0 = time.perf_counter()
    for i in range(DS_DEVICES):
        gw = i % DS_GATEWAY_EVERY == 0
        dm.create_device(
            token=f"c-{i}", device_type="gateway" if gw else "sensor",
            metadata={"phone_number": f"+1555{i:07d}"} if gw else {})
    t1 = time.perf_counter()
    for i in range(DS_DEVICES):
        gw = i % DS_GATEWAY_EVERY == 0
        dm.create_device_assignment(
            token=f"ca-{i}", device=f"c-{i}",
            asset=(f"gw-asset-{(i // DS_GATEWAY_EVERY) % DS_ASSETS}"
                   if gw else None))
    t2 = time.perf_counter()
    return {"create_device_us": (t1 - t0) / DS_DEVICES * 1e6,
            "create_device_assignment_us": (t2 - t1) / DS_DEVICES * 1e6}


def ds_destinations(inst, gateway):
    """sensor -> a callback with the binary encoder, gateway -> the HTTP
    gateway with the JSON encoder.  Returns the callback's record."""
    from sitewhere_tpu_torch.commands import (
        BinaryCommandEncoder, CallbackDeliveryProvider, CommandDestination,
        DeviceTypeMappingRouter, HttpDeliveryProvider, JsonCommandEncoder,
        SmsParameterExtractor, TopicParameterExtractor)

    encoder, delivered = BinaryCommandEncoder(), []

    def callback(execution, payload, params):
        delivered.append((execution.invocation.token, time.perf_counter(),
                          payload, payload == encoder(execution)))

    inst.commands.add_destination(CommandDestination(
        "sensors", encoder, TopicParameterExtractor(),
        CallbackDeliveryProvider(callback)))
    inst.commands.add_destination(CommandDestination(
        "gateways", JsonCommandEncoder(), SmsParameterExtractor(),
        HttpDeliveryProvider(gateway.url, timeout_s=30.0)))
    inst.commands.router = DeviceTypeMappingRouter(
        {"sensor": "sensors", "gateway": "gateways"})
    return delivered


def ds_invocation(i):
    if i % 2 == 0:
        return "ping", {}
    return "set-rate", {"rate": str(i % 1000), "unit": "hz"}


class Invoker:
    """Operators' REST invocations: arrivals paced on one thread at
    DS_RATE_PER_S, each served by one of DS_HANDLERS threads through
    ``Instance.create_command_invocation``."""

    def __init__(self, inst, n):
        import queue
        import threading

        self.inst, self.n = inst, n
        self.calls = [None] * n
        self.errors = []
        self.q = queue.Queue()
        self.threads = [threading.Thread(target=self.pace, daemon=True)] + [
            threading.Thread(target=self.serve, daemon=True)
            for _ in range(DS_HANDLERS)]

    def start(self):
        self.t0 = time.perf_counter()
        for t in self.threads:
            t.start()

    def pace(self):
        for i in range(self.n):
            due = self.t0 + i / DS_RATE_PER_S
            wait = due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            self.q.put((i, due))
        for _ in range(DS_HANDLERS):
            self.q.put(None)

    def serve(self):
        while True:
            item = self.q.get()
            if item is None:
                return
            i, due = item
            command, params = ds_invocation(i)
            t_call = time.perf_counter()
            try:
                out = self.inst.create_command_invocation(
                    f"ca-{i}", command, params, initiator_id=f"op-{i}")
            except Exception as e:  # noqa: BLE001 - counted and raised below
                self.errors.append(f"{i}: {type(e).__name__}: {e}")
                continue
            self.calls[i] = (out["token"], due, t_call, time.perf_counter())

    def join(self, timeout_s):
        deadline = time.monotonic() + timeout_s
        for t in self.threads:
            t.join(max(0.1, deadline - time.monotonic()))
        return all(not t.is_alive() for t in self.threads)


def _expected_execution(i, token):
    from sitewhere_tpu_torch.commands import (
        CommandExecution, CommandInvocation)

    command, params = ds_invocation(i)
    declared = [] if command == "ping" else [
        ("rate", "int32", int(params["rate"])), ("unit", "string", "hz")]
    return CommandExecution(
        invocation=CommandInvocation(command_token=command,
                                     target_assignment=f"ca-{i}",
                                     token=token),
        command_name="ping" if command == "ping" else "setRate",
        namespace="sw", parameters=declared)


def ds_legs(disp):
    """The dispatcher's egress-leg and republish timers: ``{name: (count,
    seconds)}``."""
    return {k: (t.count, t.total) for k, t in (
        (k, disp.metrics.timer(f"pipeline.{k}_s")) for k in (
            "egress_registration", "egress_commands", "registry_publish",
            "tables_repack"))}


def _pct_ms(values, q):
    """The ``q`` percentile of seconds, in ms (None without values)."""
    return float(np.percentile(np.asarray(values), q)) * 1e3 \
        if values else None


def device_services_run(device, geo_cuda, world, mixed, root, logs):
    """The wire world with auto-registration and command delivery (see
    :func:`phase_device_services`); ``logs`` is the run's
    :class:`LogTally`.  Returns the kernel's launches."""
    import torch
    from urllib.parse import parse_qs

    from sitewhere_tpu_torch.commands import (
        BinaryCommandEncoder, JsonCommandEncoder, decode_binary_execution)
    from sitewhere_tpu_torch.instance import Instance
    from sitewhere_tpu_torch.schema import EventType

    t_setup = time.perf_counter()
    payloads, cmd_lines, ghost_lines, c_lines = ds_payloads(mixed)
    data_dir = os.path.join(root, "device_services")
    registration = {"registration": {"default_device_type": "sensor"}}
    inst = instance_from_world(device, world, data_dir, CAPACITY, FULL_B, 0,
                               WIRE_DEADLINE_MS, **registration)
    dm, disp, mirror = inst.device_management, inst.dispatcher, inst.mirror
    per_call = ds_populate(inst)
    slots = len(inst.identity.device) + len(ghost_lines)
    check(slots <= CAPACITY,
          f"{slots} devices and ghosts exceed {CAPACITY} registry slots")
    gateway = Gateway()
    delivered = ds_destinations(inst, gateway)

    dead0 = inst.dead_letters.end_offset
    inst.start()
    spans = DeviceSpans(disp)
    logs0 = logs.snapshot()
    setup_s = time.perf_counter() - t_setup
    invoker = Invoker(inst, DS_INVOCATIONS)
    try:
        if device.type == "cuda":
            torch.cuda.synchronize()
        snap0 = disp.metrics_snapshot()
        legs0 = ds_legs(disp)
        disp.latencies_s.clear()
        reg0 = (inst.registration.registered, inst.registration.rejected)
        geo_cuda.reset_launch_counts()
        t0 = time.perf_counter()
        invoker.start()
        for payload, _ in payloads:
            disp.ingest_wire_lines(payload)
        disp.flush()
        wire_s = time.perf_counter() - t0
        check(invoker.join(900.0), "command invocations did not finish")
        settle(inst)
        elapsed = time.perf_counter() - t0
        launches = geo_cuda.launch_counts["pip_parity"]
        snap = disp.metrics_snapshot()
        legs = {k: (n - legs0[k][0], t - legs0[k][1])
                for k, (n, t) in ds_legs(disp).items()}
        latency = _latency(disp, "max")
        span_ms = spans.total_ms()
        reg = (inst.registration.registered - reg0[0],
               inst.registration.rejected - reg0[1])
        logged = logs.since(logs0)
        # ghosts: one Device, one active assignment, an active mirror row
        # of tenant 0 each
        active = collections.Counter(
            a.device for a in dm.assignments.values()
            if a.status == "Active" and a.device.startswith("x-"))
        bad_ghosts = []
        for tok in ghost_lines:
            h = inst.identity.device.lookup(tok)
            if (tok not in dm.devices or active[tok] != 1 or h < 0
                    or not mirror.active[h] or mirror.tenant_id[h] != 0):
                bad_ghosts.append(tok)
        ghost_handles = {inst.identity.device.lookup(t): t
                         for t in ghost_lines}
        c_handles = np.asarray([inst.identity.device.lookup(t)
                                for t in c_lines])
        cmd_handles = collections.Counter(
            (p, inst.identity.device.lookup(tok)) for p, tok in cmd_lines)
        dead = [json.loads(raw) for _, raw in inst.dead_letters.scan(dead0)]
        journal = inst.ingest_journal
        # checkpoint_full.stores: save the loaded instance
        saved = {attr: {k: dict(getattr(getattr(inst, attr), k))
                        for k in keys} for attr, keys in (
            ("device_management", ("device_types", "devices",
                                   "assignments")),
            ("assets", ("_types", "_assets")))}
        saved_mirror = {k: np.array(getattr(mirror, k))
                        for k in ("active", "tenant_id", "device_type_id",
                                  "assignment_id", "assignment_status",
                                  "area_id", "customer_id", "asset_id")}
        inst.checkpointer.save()
        save_stats = dict(inst.checkpointer.last_save_stats)
        refs = {}
        for d in dead:
            ref = d.get("payload_ref", -1)
            if d["kind"] == "undeliverable-invocation" and ref >= 0 \
                    and ref not in refs:
                refs[ref] = journal.read_one(ref)
        inst.stop()
        stored_ghosts = collections.Counter()
        stored_rows, stored_commands, stored_c = 0, 0, 0
        for cols in inst.event_store.iter_chunks():
            dev = np.asarray(cols["device_id"])
            etype = np.asarray(cols["event_type"])
            stored_rows += int(dev.size)
            stored_commands += int((etype
                                    == EventType.COMMAND_INVOCATION).sum())
            # the c-* devices' own lines: derived alerts aside
            stored_c += int((np.isin(dev, c_handles) & np.isin(
                etype, (EventType.MEASUREMENT, EventType.LOCATION))).sum())
            for h, n in zip(*np.unique(dev, return_counts=True)):
                if int(h) in ghost_handles:
                    stored_ghosts[ghost_handles[int(h)]] += int(n)
    finally:
        invoker.join(60.0)
        gateway.close()
        inst.terminate()

    delta = {k: snap[k] - snap0[k] for k in (
        "steps", "processed", "accepted", "unregistered", "replayed",
        "commands", "derived_alerts")}
    lines = sum(p.count(b"\n") + 1 for p, _ in payloads)
    n_ghost_lines = sum(ghost_lines.values())
    c_sent = sum(sum(1 for ln in p.split(b"\n") if ln.startswith(
        b'{"deviceToken":"c-') and (b'Measurements"' in ln
                                    or b'Location"' in ln))
        for p, _ in payloads)
    # deliveries: the callback's and the gateway's, by invocation token
    calls = {c[0]: (i, c) for i, c in enumerate(invoker.calls)
             if c is not None}
    by_token = collections.defaultdict(list)
    for token, t, payload, same in delivered:
        by_token[token].append(t)
    http_unequal = 0
    for t, body in gateway.got:
        form = parse_qs(body.decode())
        doc = json.loads(form["Body"][0])
        token = doc["invocation"]
        by_token[token].append(t)
        i = calls[token][0] if token in calls else None
        if i is None or form["Body"][0].encode() != JsonCommandEncoder()(
                _expected_execution(i, token)):
            http_unequal += 1
    # the sensors' payloads: each equal to the encoder's output for the
    # execution it was delivered with, and to the binary encoding of the
    # invocation made, which decodes back to its command
    binary_unequal = sum(1 for *_, same in delivered if not same)
    for token, t, payload, _ in delivered:
        i = calls[token][0] if token in calls else None
        if i is None or payload != BinaryCommandEncoder()(
                _expected_execution(i, token)) \
                or decode_binary_execution(payload)["invocation"] != token:
            binary_unequal += 1
    once = all(len(v) == 1 for v in by_token.values())
    lat_call = [by_token[tok][0] - c[2] for tok, (i, c) in calls.items()
                if by_token.get(tok)]
    lat_arrival = [by_token[tok][0] - c[1] for tok, (i, c) in calls.items()
                   if by_token.get(tok)]
    kinds = collections.Counter(d["kind"] for d in dead)
    # the NDJSON command lines: one undeliverable-invocation dead letter
    # each at its own record; replayed duplicates carry no record
    payload_index = {p: i for i, (p, _) in enumerate(payloads)}
    got = collections.Counter()
    dup_undeliverable = 0
    for d in dead:
        if d["kind"] != "undeliverable-invocation":
            continue
        ref = d.get("payload_ref", -1)
        if ref < 0:
            dup_undeliverable += 1
            continue
        got[(payload_index.get(refs.get(ref)), d["device_id"])] += 1
    rec = {"phase": "device_services", "run": "device_services_wire",
           "traffic": "60/30/10 + invocations", "ring_depth": 0,
           "deadline_ms": WIRE_DEADLINE_MS, "payloads": len(payloads),
           "lines": lines, "ghost_lines": n_ghost_lines,
           "distinct_ghosts": len(ghost_lines),
           "ndjson_command_lines": len(cmd_lines),
           "command_devices": DS_DEVICES,
           "gateways": DS_DEVICES // DS_GATEWAY_EVERY,
           "invocations": DS_INVOCATIONS,
           "invocation_rate_per_s": DS_RATE_PER_S,
           "invocation_handlers": DS_HANDLERS,
           "registry_slots_used": slots, "setup_s": setup_s, **per_call,
           "wire_s": wire_s, "elapsed_s": elapsed,
           "events_per_s": lines / wire_s, **latency, **delta,
           "pip_launches": launches,
           "registration": {"registered": reg[0], "rejected": reg[1]},
           "replayed_minus_ghost_lines": delta["replayed"] - n_ghost_lines,
           "c_device_lines": sum(c_lines.values()),
           "c_measurement_location_lines_sent": c_sent,
           "c_measurement_location_rows_stored": stored_c,
           "c_stored_per_sent_line": stored_c / c_sent if c_sent else None,
           "duplicate_cause": (
               "a plan's ghost rows re-decode their whole payload and "
               "replay every request the plan did not process itself, the "
               "rows of the payload another plan holds among them (the "
               "reference's _handle_unregistered)"),
           **{f"{k}_ms_each": (t / n * 1e3 if n else None)
              for k, (n, t) in legs.items()},
           **{f"{k}_count": n for k, (n, _) in legs.items()},
           "invocation_to_delivery_ms": {
               "from_call_p50": _pct_ms(lat_call, 50),
               "from_call_p99": _pct_ms(lat_call, 99),
               "from_arrival_p50": _pct_ms(lat_arrival, 50),
               "from_arrival_p99": _pct_ms(lat_arrival, 99)},
           "deliveries": {"callback": len(delivered),
                          "http": len(gateway.got)},
           "dead_letters": dict(kinds),
           "undeliverable_replayed_duplicates": dup_undeliverable,
           "rows_stored": stored_rows, "command_rows_stored": stored_commands,
           "logs": logged, "invocation_errors": invoker.errors[:5]}
    rec.update(guard_counts(disp.metrics, rec["phase"]))
    emit(_busy(rec, span_ms, None, wire_s, delta["steps"]))
    check(not invoker.errors, f"invocations failed: {invoker.errors[:3]}")
    check(not bad_ghosts, f"{len(bad_ghosts)} ghosts not registered once "
          f"with an active assignment and row: {bad_ghosts[:3]}")
    check(reg[0] == len(ghost_lines),
          f"registered {reg[0]} of {len(ghost_lines)} distinct ghosts")
    missing = [t for t, n in ghost_lines.items() if stored_ghosts[t] < n]
    check(not missing, f"{len(missing)} ghosts' lines not all stored")
    check(stored_c >= c_sent,
          f"{stored_c} rows stored for {c_sent} c-* device lines")
    check(stored_rows == delta["accepted"],
          f"stored rows {stored_rows} != accepted {delta['accepted']}")
    tokens = [c[0] for c in invoker.calls if c is not None]
    check(len(tokens) == DS_INVOCATIONS == len(set(tokens)),
          f"{len(set(tokens))} unique invocation tokens of {DS_INVOCATIONS}")
    check(len(delivered) + len(gateway.got) == DS_INVOCATIONS and once
          and set(by_token) == set(tokens),
          f"deliveries: callback {len(delivered)} + http "
          f"{len(gateway.got)} for {DS_INVOCATIONS} invocations, once {once}")
    check(http_unequal == 0 and binary_unequal == 0,
          f"{http_unequal} HTTP bodies and {binary_unequal} binary payloads "
          "differ from their execution's encoding")
    check(got == cmd_handles,
          f"NDJSON command lines: {sum(got.values())} dead letters at their "
          f"records for {len(cmd_lines)} lines")
    check(delta["commands"] == stored_commands
          == DS_INVOCATIONS + len(cmd_lines) + dup_undeliverable,
          f"commands {delta['commands']}, stored command rows "
          f"{stored_commands}, invocations {DS_INVOCATIONS} + NDJSON lines "
          f"{len(cmd_lines)} + replayed {dup_undeliverable}")
    check(launches == delta["steps"],
          f"kernel launched {launches}x in {delta['steps']} dispatcher steps")
    ds_restore(device, data_dir, saved, saved_mirror, save_stats)
    return launches


def ds_restore(device, data_dir, saved, saved_mirror, save_stats):
    """checkpoint_full.stores: a fresh instance restores the saved one;
    devices, assignments, device types with their commands and assets
    come back equal, and the mirror bitwise."""
    from sitewhere_tpu_torch.instance import Instance

    t0 = time.perf_counter()
    inst = Instance(instance_config(
        data_dir, CAPACITY, FULL_B, 0, WIRE_DEADLINE_MS,
        registration={"default_device_type": "sensor"}), device=device)
    construct_s = time.perf_counter() - t0
    try:
        check(inst.restored, "checkpoint_full.stores: nothing restored")
        unequal = sorted(f"{attr}.{k}" for attr, stores in saved.items()
                         for k, v in stores.items()
                         if dict(getattr(getattr(inst, attr), k)) != v)
        mirror_unequal = sorted(
            k for k, a in saved_mirror.items()
            if getattr(inst.mirror, k).tobytes() != a.tobytes())
        dm = inst.device_management
        commands = sum(len(t.commands) for t in dm.device_types.values())
        restore = dict(inst.checkpointer.restore_stats)
        restore_s = inst.checkpointer.restore_s
        sample = next(t for t in dm.devices if t.startswith("x-"))
        active_ok = dm.get_active_assignment(sample) is not None
    finally:
        inst.terminate()
    emit({"phase": "device_services", "run": "checkpoint_full.stores",
          "devices": len(saved["device_management"]["devices"]),
          "assignments": len(saved["device_management"]["assignments"]),
          "device_types": len(saved["device_management"]["device_types"]),
          "commands": commands,
          "assets": len(saved["assets"]["_assets"]),
          "stores_bytes": save_stats.get("stores_bytes"),
          "stores_pickle_s": save_stats.get("stores_pickle_s"),
          "stores_save_s": save_stats.get("stores_s"),
          "stores_restore_s": restore.get("stores_s"),
          "save": save_stats, "restore": restore, "restore_s": restore_s,
          "instance_construct_s": construct_s,
          "unequal": unequal, "mirror_unequal": mirror_unequal})
    check(not unequal, f"restored stores differ from the saved: {unequal}")
    check(not mirror_unequal,
          f"restored mirror differs from the saved: {mirror_unequal}")
    check(commands == 4 and active_ok,
          "restored device types, commands or assignment index wrong")


def phase_device_services(device, geo_cuda, mixed, logs, world):
    """The device system of record, auto-registration and command delivery
    on the wire path (see the module docstring, phase 10), over the
    deployment's world checkpoint ``world``; ``logs`` is the run's
    :class:`LogTally`.  Returns the kernel's launches in the wire run, by
    run name."""
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="devices-", dir=geo_cuda.BUILD_DIR)
    launches = {}
    try:
        launches["device_services_wire"] = device_services_run(
            device, geo_cuda, world, mixed[:DS_PAYLOADS], root, logs)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "device_services", "run": "done",
          "seconds": time.perf_counter() - t0})
    return launches


# -- the ingest sources (phase ingest_sources) ----------------------------------

IS_TS0_MS = WIRE_TS0_MS + 50_000_000
# 2 mixed and 2 measurement-only payloads (8 and 8 until the
# rest_gateway phase came, 4 and 4 until the sharded_mesh phase: the
# script's time limit)
IS_MIXED, IS_MEAS = 2, 2
# length_prefixed_frames refuses a frame over 16 MiB (the reference's cap,
# kept); a full-width 60/30/10 payload is about 16.8 MB, so it goes as two
# frames of 65536 lines, a measurement-only one (about 15.7 MB) as one
IS_FRAME_CAP = 16 << 20
# sources_wire: each payload's devices are distinct, and disjoint from the
# next six payloads' (blocks of a permutation of the fleet): no plan can
# hold two rows of one device, wherever the 5 ms deadline and the
# re-injected derived alerts cut the plans, so the pooled and the
# synchronous runs must end in the same state, bit for bit
IS_BLOCKS = N_ACTIVE // FULL_B
# sources_protocols: (payloads, lines) per source; every line's device
# distinct across the run (no rule can fire), every line's eventDate
# distinct within its source's own window of event time
IS_PROTOCOLS = (("udp", 64, 256), ("http", 16, 4096),
                ("mqtt", 16, 4096), ("coap", 64, 64), ("tcp", 16, 16384))
IS_RESENT = 4
IS_WINDOW_MS = 10_000_000
IS_SAMPLE_S = 0.002
_MA_LINE = ('{"deviceToken":"d-%d","type":"DeviceMeasurements","request":'
            '{"name":"m%d","value":%.3f,"eventDate":%d,"alternateId":'
            '"alt-%d"}}')


def is_sources(**receivers):
    """The config's ``sources`` section: one source per named receiver
    document, ``raw_wire`` with the json decoder unless the document
    carries its own ``decoder`` / ``dedup``."""
    out = []
    for sid, doc in receivers.items():
        doc = dict(doc)
        src = {"id": sid, "decoder": doc.pop("decoder", "json"),
               "receivers": [doc]}
        if "dedup" in doc:
            src["dedup"] = doc.pop("dedup")
        else:
            src["raw_wire"] = True
        out.append(src)
    return out


def is_frames(payloads):
    """Length-framed frames of ``payloads``: each whole when it fits the
    cap, else halved at a line boundary.  Returns ``(frames, lines,
    registered lines)``."""
    frames, lines, registered = [], 0, 0
    for payload, reg in payloads:
        n = payload.count(b"\n") + 1
        lines += n
        registered += reg
        if len(payload) <= IS_FRAME_CAP:
            frames.append(payload)
            continue
        cut = -1
        for _ in range(n // 2):
            cut = payload.index(b"\n", cut + 1)
        frames += [payload[:cut], payload[cut + 1:]]
    check(all(len(f) <= IS_FRAME_CAP for f in frames),
          "a frame over the receiver's 16 MiB cap")
    return frames, lines, registered


class BacklogSampler:
    """The decode pool's depth gauge and the overload ladder's
    ``decode_backlog`` signal, read every IS_SAMPLE_S while a run is on;
    keeps the maxima."""

    def __init__(self, inst):
        self.inst = inst
        self.depth = 0.0
        self.backlog = 0.0
        self.samples = 0
        self._stop = threading.Event()
        self._gauge = inst.metrics.gauge("ingest.decode_pool_depth")
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="backlog-sampler")
        self._thread.start()

    def _run(self):
        while not self._stop.wait(IS_SAMPLE_S):
            self.depth = max(self.depth, float(self._gauge.value))
            self.backlog = max(
                self.backlog, self.inst._overload_signals().decode_backlog)
            self.samples += 1

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=5.0)


def is_wait(cond, what, timeout_s=600.0):
    deadline = time.monotonic() + timeout_s
    while not cond():
        check(time.monotonic() < deadline, f"timed out waiting: {what}")
        time.sleep(0.001)


def stored_rows_by(store, windows):
    """Rows per event-time window (``{name: (lo_ms, hi_ms)}``), distinct
    event times per window, and the order-independent checksum of every
    stored row."""
    counts = dict.fromkeys(windows, 0)
    times = {k: [] for k in windows}
    total = {"rows": 0, "sum": 0}
    for cols in store.iter_chunks():
        n, h = row_checksum(cols)
        total["rows"] += n
        total["sum"] = (total["sum"] + h) % (1 << 64)
        # eventDate ms -> (s, ns) goes through a float: round, not floor
        ms = (np.asarray(cols["ts_s"], np.int64) * 1000
              + (np.asarray(cols["ts_ns"], np.int64) + 500_000) // 1_000_000)
        for k, (lo, hi) in windows.items():
            m = (ms >= lo) & (ms < hi)
            counts[k] += int(m.sum())
            times[k].append(ms[m])
    distinct = {k: int(np.unique(np.concatenate(v)).size) if v else 0
                for k, v in times.items()}
    return counts, distinct, total


def sources_wire_run(device, geo_cuda, world, frames, expect, root,
                     workers):
    """One config-declared TCP source (length framing, ``raw_wire``,
    decoder json) in a fresh ``Instance`` restored from the world, with
    ``ingest.decode_workers`` at ``workers``; one sender connection sends
    every frame.  Timed from the first byte sent to the return of
    ``flush()``.  Returns the run's record, its state and checksum."""
    import torch

    from sitewhere_tpu_torch import native

    lines, registered = expect
    data_dir = os.path.join(root, f"sources_wire-{workers}")
    sources = is_sources(wire={"type": "tcp", "port": 0,
                               "framing": "length"})
    inst = instance_from_world(device, world, data_dir, CAPACITY, FULL_B, 0,
                               WIRE_DEADLINE_MS, sources=sources,
                               ingest={"decode_workers": workers})
    disp = inst.dispatcher
    adopted = count_adopted(inst.batcher)
    inst.start()
    spans = DeviceSpans(disp)
    src = inst.sources[0]
    pool = inst.decode_pool
    check((pool is not None) == (workers > 0),
          f"decode pool {pool} at decode_workers={workers}")
    check(src._pool_usable() == (workers > 0),
          "the TCP source's use of the decode pool")
    jobs = inst.metrics.counter("ingest.decode_pool_jobs")
    try:
        torch.cuda.synchronize()
        snap0 = disp.metrics_snapshot()
        stages0 = _stage_totals(disp)
        records0 = inst.ingest_journal.end_offset
        jobs0 = jobs.value
        rejected0 = inst.registration.rejected
        disp.latencies_s.clear()
        sampler = BacklogSampler(inst)
        sent = {}

        def send():
            t = time.perf_counter()
            with socket.create_connection(
                    ("127.0.0.1", src.receivers[0].port), timeout=60) as s:
                for f in frames:
                    s.sendall(struct.pack(">I", len(f)) + f)
            sent["s"] = time.perf_counter() - t

        geo_cuda.reset_launch_counts()
        t0 = time.perf_counter()
        sender = threading.Thread(target=send, name="sources-wire-sender")
        sender.start()
        is_wait(lambda: src.decoded_count + src.failed_count
                + src.shed_count >= lines, "the wire source's rows")
        sender.join(timeout=60.0)
        if pool is not None:
            check(pool.flush(600.0), "decode pool did not drain")
        settle(inst)
        elapsed = time.perf_counter() - t0
        sampler.stop()
        launches = geo_cuda.launch_counts["pip_parity"]
        snap = disp.metrics_snapshot()
        stage_ms = _stage_ms(disp, stages0)
        latency = _latency(disp, "max")
        span_ms = spans.total_ms()
        committed = disp.journal_reader.committed
        records = inst.ingest_journal.end_offset - records0
        rejected = inst.registration.rejected - rejected0
        state = inst.device_state.snapshot_host()
        inst.stop()
        _, _, stored = stored_rows_by(inst.event_store, {})
    finally:
        inst.terminate()
    delta = {k: snap[k] - snap0[k] for k in (
        "steps", "processed", "accepted", "unregistered", "derived_alerts")}
    rec = {"phase": "ingest_sources", "run": "sources_wire",
           "decode_workers": workers, "frames": len(frames),
           "lines": lines, "elapsed_s": elapsed,
           "events_per_s": lines / elapsed, "send_s": sent.get("s"),
           **latency, "stage_ms": stage_ms,
           "decode_pool_jobs": jobs.value - jobs0,
           "decode_pool_depth_max": sampler.depth,
           "decode_backlog_max": sampler.backlog,
           "backlog_samples": sampler.samples,
           "adopted_plans": len(adopted),
           # requests of the plans' journal records handed to registration
           # and refused (no default device type): ghosts and straddles
           "registration_rejected": rejected,
           "source": {"received": src.receivers[0].received_count,
                      "rows": src.decoded_count,
                      "failed": src.failed_count, "shed": src.shed_count},
           "pip_launches": launches, "committed": committed,
           "journal_records": records, "rows_stored": stored["rows"],
           "build_fallbacks": native.build_fallbacks, **delta}
    rec.update(guard_counts(disp.metrics, "ingest_sources"))
    emit(_busy(rec, span_ms, None, elapsed, delta["steps"]))
    check(src.failed_count == 0 and src.shed_count == 0,
          f"wire source: {src.failed_count} failed, {src.shed_count} shed")
    check(src.decoded_count == lines,
          f"wire source took {src.decoded_count} rows of {lines} lines")
    check(launches == delta["steps"],
          f"kernel launched {launches}x in {delta['steps']} dispatcher steps")
    check(delta["accepted"] == registered + delta["derived_alerts"],
          f"accepted {delta['accepted']} != registered {registered} + "
          f"derived {delta['derived_alerts']}")
    check(stored["rows"] == delta["accepted"],
          f"stored {stored['rows']} rows of {delta['accepted']} accepted")
    check(committed == records == len(frames),
          f"committed offset {committed}, journal records {records}, "
          f"frames {len(frames)}")
    check(native.build_fallbacks == 0,
          f"{native.build_fallbacks} payloads took the Python decode")
    if workers:
        check(rec["decode_pool_jobs"] == len(frames),
              f"{rec['decode_pool_jobs']} pool jobs for {len(frames)} frames")
        check(sampler.backlog > 0, "decode_backlog never rose above 0")
    shutil.rmtree(data_dir, ignore_errors=True)
    return rec, state, stored


def is_protocol_lines(rng, devices, n, ts0_ms, alt0=None):
    """``n`` measurement lines of the given devices (values where no rule
    fires), eventDate ``ts0_ms + i``; with ``alt0``, alternateIds
    ``alt-<alt0 + i>``."""
    lo, hi = MEAS_VALUE_BAND
    value = rng.uniform(lo, hi, n)
    if alt0 is None:
        return [_M_LINE % (f"d-{d}", d % M_SLOTS, v, ts0_ms + i)
                for i, (d, v) in enumerate(zip(devices.tolist(),
                                               value.tolist()))]
    return [_MA_LINE % (d, d % M_SLOTS, v, ts0_ms + i, alt0 + i)
            for i, (d, v) in enumerate(zip(devices.tolist(),
                                           value.tolist()))]


def is_protocol_traffic(rng):
    """Payloads per source, each source's lines in its own event-time
    window, every device once across the run."""
    perm = rng.permutation(N_ACTIVE)
    at, out, windows = 0, {}, {}
    for k, (sid, n_payloads, n_lines) in enumerate(IS_PROTOCOLS):
        ts0 = IS_TS0_MS + (k + 1) * IS_WINDOW_MS
        windows[sid] = (ts0, ts0 + IS_WINDOW_MS)
        payloads = []
        for p in range(n_payloads):
            devs = perm[at:at + n_lines]
            at += n_lines
            lines = is_protocol_lines(
                rng, devs, n_lines, ts0 + p * n_lines,
                alt0=p * n_lines if sid == "tcp" else None)
            payloads.append("\n".join(lines).encode())
        out[sid] = payloads
    return out, windows


def is_send_udp(rx, payloads):
    """One datagram per payload, each sent once the receiver took the
    previous one (a burst would overrun the socket's buffer)."""
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        for p in payloads:
            n = rx.received_count
            s.sendto(p, ("127.0.0.1", rx.port))
            is_wait(lambda: rx.received_count > n, "a UDP datagram",
                    timeout_s=30.0)


def is_send_http(rx, payloads):
    import urllib.request

    url = f"http://127.0.0.1:{rx.port}{rx.path}"
    for p in payloads:
        with urllib.request.urlopen(urllib.request.Request(
                url, data=p, method="POST"), timeout=60) as resp:
            check(resp.status == 202, f"HTTP answered {resp.status}")


def is_send_mqtt(rx, payloads):
    from sitewhere_tpu_torch.ingest.mqtt import MqttClient

    client = MqttClient("127.0.0.1", rx.port, client_id="chip-smoke-device")
    client.connect()
    try:
        for i, p in enumerate(payloads):
            client.publish(f"sitewhere/input/dev-{i}", p, qos=1)
            check(client.drain_publishes(timeout=60.0),
                  "the hosted broker withheld a PUBACK")
    finally:
        client.disconnect()


def is_send_coap(rx, payloads):
    from sitewhere_tpu_torch.ingest import coap

    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.settimeout(60.0)
        for mid, p in enumerate(payloads, 1):
            s.sendto(coap.encode_post("events", p, mid, token=b"cs"),
                     ("127.0.0.1", rx.port))
            data, _ = s.recvfrom(65536)
            reply = coap.parse_message(data)
            check(reply.mtype == coap.ACK and reply.message_id == mid
                  and reply.code == coap.CHANGED_204,
                  f"CoAP answered {reply}")


def is_send_tcp(rx, payloads):
    with socket.create_connection(("127.0.0.1", rx.port), timeout=60) as s:
        for p in payloads:
            s.sendall(struct.pack(">I", len(p)) + p)


IS_SENDERS = {"udp": is_send_udp, "http": is_send_http,
              "mqtt": is_send_mqtt, "coap": is_send_coap,
              "tcp": is_send_tcp}
IS_RECEIVERS = {
    "udp": {"type": "udp", "port": 0},
    "http": {"type": "http", "port": 0},
    "mqtt": {"type": "mqtt-broker", "port": 0},
    "coap": {"type": "coap", "port": 0},
    # the dedup window at its default size (2^20 alternate ids)
    "tcp": {"type": "tcp", "port": 0, "decoder": "jsonlines", "dedup": {}},
}


def is_drive(inst, sid, payloads, resent=()):
    """Send one source's payloads (then ``resent``) and wait until the
    source took every line; returns the ms per payload and the decode
    pool's jobs for it."""
    src = {s.source_id: s for s in inst.sources}[sid]
    jobs = inst.metrics.counter("ingest.decode_pool_jobs")
    jobs0 = jobs.value
    lines = sum(p.count(b"\n") + 1 for p in payloads)
    dups = sum(p.count(b"\n") + 1 for p in resent)
    took0 = (src.decoded_count, src.duplicate_count)
    t0 = time.perf_counter()
    IS_SENDERS[sid](src.receivers[0], list(payloads) + list(resent))
    is_wait(lambda: (src.decoded_count - took0[0] + src.failed_count
                     + src.shed_count >= lines
                     and src.duplicate_count - took0[1] >= dups),
            f"source {sid}'s lines")
    if inst.decode_pool is not None:
        check(inst.decode_pool.flush(600.0), "decode pool did not drain")
    ms = (time.perf_counter() - t0) * 1e3
    return {"payloads": len(payloads) + len(resent), "lines": lines,
            "duplicates": src.duplicate_count - took0[1],
            "failed": src.failed_count, "shed": src.shed_count,
            "ms_per_payload": ms / max(1, len(payloads) + len(resent)),
            "decode_pool_jobs": jobs.value - jobs0,
            "acks_on_emit": any(getattr(r, "acks_on_emit", False)
                                for r in src.receivers)}


def sources_protocols_run(device, geo_cuda, world, root):
    """Every source that needs no outside process in one ``Instance``
    (see the module docstring, phase 12); then ``sources_restart``: a
    fresh ``Instance`` on the same directory restores the dedup window
    and refuses the same resent payloads.  Returns the kernel's launches
    by run."""
    import torch

    from sitewhere_tpu_torch.instance import Instance

    rng = np.random.default_rng(SEED + 90)
    traffic, windows = is_protocol_traffic(rng)
    n_tcp = IS_PROTOCOLS[-1][2]
    resent = traffic["tcp"][:IS_RESENT]
    data_dir = os.path.join(root, "sources_protocols")
    sources = is_sources(**IS_RECEIVERS)
    inst = instance_from_world(device, world, data_dir, CAPACITY, FULL_B, 0,
                               WIRE_DEADLINE_MS, sources=sources)
    disp = inst.dispatcher
    inst.start()
    by_sid = {s.source_id: s for s in inst.sources}
    out, launches = {}, {}
    try:
        torch.cuda.synchronize()
        snap0 = disp.metrics_snapshot()
        geo_cuda.reset_launch_counts()
        t0 = time.perf_counter()
        for sid, _, _ in IS_PROTOCOLS:
            out[sid] = is_drive(inst, sid, traffic[sid],
                                resent if sid == "tcp" else ())
        settle(inst)
        elapsed = time.perf_counter() - t0
        launches["sources_protocols"] = geo_cuda.launch_counts["pip_parity"]
        snap = disp.metrics_snapshot()
        keys = by_sid["tcp"].deduplicator.export_keys()
        # the runtime section's snapshot, timed inside the final save
        prov = inst.checkpointer._providers["runtime"]
        snap_s = [0.0]
        prov.snapshot_fn = _time_into(prov.snapshot_fn, snap_s)
        inst.stop()
        save = inst.checkpointer.last_save_stats
        counts, distinct, _ = stored_rows_by(inst.event_store, windows)
    finally:
        inst.terminate()
    delta = {k: snap[k] - snap0[k] for k in ("steps", "accepted",
                                             "derived_alerts")}
    lines = sum(r["lines"] for r in out.values())
    for sid, r in out.items():
        r["rows_stored"] = counts[sid]
    rec = {"phase": "ingest_sources", "run": "sources_protocols",
           "sources": out, "lines": lines, "elapsed_s": elapsed,
           "events_per_s": lines / elapsed,
           "pip_launches": launches["sources_protocols"], **delta}
    rec.update(guard_counts(disp.metrics, "ingest_sources"))
    emit(rec)
    check(launches["sources_protocols"] == delta["steps"],
          f"kernel launched {launches['sources_protocols']}x in "
          f"{delta['steps']} dispatcher steps")
    for sid, r in out.items():
        check(r["failed"] == 0 and r["shed"] == 0,
              f"source {sid}: {r['failed']} failed, {r['shed']} shed")
        check(counts[sid] == distinct[sid] == r["lines"],
              f"source {sid}: {counts[sid]} rows stored "
              f"({distinct[sid]} distinct) of {r['lines']} lines")
        if r["acks_on_emit"]:
            check(r["decode_pool_jobs"] == 0,
                  f"ack-gated source {sid} went through the decode pool")
        else:
            check(r["decode_pool_jobs"] == r["payloads"],
                  f"source {sid}: {r['decode_pool_jobs']} pool jobs for "
                  f"{r['payloads']} payloads")
    check(out["mqtt"]["acks_on_emit"] and out["mqtt"]["decode_pool_jobs"] == 0,
          "the hosted MQTT broker's intake left the synchronous path")
    check(out["tcp"]["duplicates"] == IS_RESENT * n_tcp,
          f"{out['tcp']['duplicates']} duplicates refused, want "
          f"{IS_RESENT * n_tcp}")
    check(delta["derived_alerts"] == 0 and delta["accepted"] == lines,
          f"accepted {delta['accepted']} of {lines} lines, derived "
          f"{delta['derived_alerts']}")
    check(len(keys) == len(traffic["tcp"]) * n_tcp,
          f"dedup window holds {len(keys)} keys")

    # sources_restart: the same directory, the same sources; the dedup
    # window comes back through add_source from the runtime section
    restore_s = [0.0]
    real_restore = Instance._restore_runtime_state
    Instance._restore_runtime_state = _time_into(real_restore, restore_s)
    try:
        t0 = time.perf_counter()
        inst = Instance(instance_config(data_dir, CAPACITY, FULL_B, 0,
                                        WIRE_DEADLINE_MS, sources=sources),
                        device=device)
        boot_s = time.perf_counter() - t0
    finally:
        Instance._restore_runtime_state = real_restore
    check(inst.restored, "sources_restart: nothing restored")
    disp = inst.dispatcher
    inst.start()
    try:
        torch.cuda.synchronize()
        tcp = {s.source_id: s for s in inst.sources}["tcp"]
        reseeded = tcp.deduplicator.export_keys()
        snap0 = disp.metrics_snapshot()
        geo_cuda.reset_launch_counts()
        again = is_drive(inst, "tcp", (), resent)
        settle(inst)
        launches["sources_restart"] = geo_cuda.launch_counts["pip_parity"]
        snap = disp.metrics_snapshot()
        inst.stop()
        counts, distinct, _ = stored_rows_by(inst.event_store,
                                             {"tcp": windows["tcp"]})
    finally:
        inst.terminate()
    steps = snap["steps"] - snap0["steps"]
    rec = {"phase": "ingest_sources", "run": "sources_restart",
           "runtime_section_bytes": save.get("runtime_bytes"),
           "runtime_save_ms": (snap_s[0] + save.get("runtime_s", 0.0)) * 1e3,
           "runtime_restore_ms": restore_s[0] * 1e3,
           "restore_s": inst.checkpointer.restore_s, "boot_s": boot_s,
           "dedup_keys": len(reseeded), "resent": again,
           "rows_stored_tcp": counts["tcp"],
           "accepted": snap["accepted"] - snap0["accepted"],
           "steps": steps, "pip_launches": launches["sources_restart"]}
    rec.update(guard_counts(disp.metrics, "ingest_sources"))
    emit(rec)
    check(reseeded == keys, "the restart's dedup window differs from the "
          "saved one")
    check(again["duplicates"] == IS_RESENT * n_tcp,
          f"after the restart {again['duplicates']} duplicates refused, "
          f"want {IS_RESENT * n_tcp}")
    check(rec["accepted"] == 0,
          f"the restart accepted {rec['accepted']} resent rows")
    check(counts["tcp"] == distinct["tcp"] == len(keys),
          f"tcp rows stored {counts['tcp']} ({distinct['tcp']} distinct) "
          f"for {len(keys)} lines")
    check(launches["sources_restart"] == steps,
          f"kernel launched {launches['sources_restart']}x in {steps} steps")
    shutil.rmtree(data_dir, ignore_errors=True)
    return launches


def phase_ingest_sources(device, geo_cuda, world):
    """The ingest sources on the card (see the module docstring, phase
    12), over the deployment's world checkpoint ``world``.  Returns the
    kernel's launches by run."""
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="sources-", dir=geo_cuda.BUILD_DIR)
    launches = {}
    try:
        rng = np.random.default_rng(SEED + 80)
        perm = rng.permutation(N_ACTIVE)

        def block(i):
            b = i % IS_BLOCKS
            return perm[b * FULL_B:(b + 1) * FULL_B]

        mixed = wire_payloads(rng, IS_MIXED, FULL_B, IS_TS0_MS, devices=block)
        meas = measurement_payloads(
            rng, IS_MEAS, FULL_B, IS_TS0_MS + 1000 * IS_MIXED,
            devices=lambda p: block(IS_MIXED + p))
        frames, lines, registered = is_frames(mixed + meas)
        del mixed, meas
        emit({"phase": "ingest_sources", "run": "setup",
              "frames": len(frames), "frame_mb_max":
              max(len(f) for f in frames) / 1e6,
              "seconds": time.perf_counter() - t0})
        runs = {}
        for workers in (2, 0):
            runs[workers] = sources_wire_run(
                device, geo_cuda, world, frames, (lines, registered), root,
                workers)
            launches[f"sources_wire.workers{workers}"] = \
                runs[workers][0]["pip_launches"]
        del frames
        (pooled, s_pool, c_pool), (sync, s_sync, c_sync) = runs[2], runs[0]
        check(c_pool == c_sync,
              f"pooled and synchronous runs stored different rows: "
              f"{c_pool} != {c_sync}")
        check(sorted(s_pool) == sorted(s_sync) and all(
            s_pool[k].tobytes() == s_sync[k].tobytes() for k in s_pool),
            "pooled and synchronous runs left different device state")
        emit({"phase": "ingest_sources", "run": "sources_wire.checks",
              "rows_equal": True, "state_bitwise_equal": True,
              "state_fields": len(s_pool)})
        del runs, s_pool, s_sync
        launches.update(sources_protocols_run(device, geo_cuda, world, root))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "ingest_sources", "run": "done",
          "seconds": time.perf_counter() - t0})
    return launches


# -- outbound, search, presence and device streams -------------------------------

OP_TS0_MS = WIRE_TS0_MS + 60_000_000
OP_MIXED, OP_MEAS = 8, 8
# the webhook's and the index's devices, and the MQTT connector's; only
# devices without an m0 measurement slot (d % 8 != 0), so the window
# query's match rows (all m0) pass none of their filters
OP_HOOK_DEVICES, OP_MQTT_DEVICES = 4096, 1024
OP_MISSING_AFTER_S = 3600
# matches on about 1% of the 1 s windows of m0 (values uniform in 0-100)
OP_QUERY = {"kind": "window", "name": "hot", "mtype": "m0", "agg": "mean",
            "op": "gt", "threshold": 99.0, "windowS": 1}
OP_CONNECTORS = ("tap", "alerts", "webhook", "index", "mqtt", "dead")
OP_SHED_LINES = 4096
OP_CONCURRENT = 4
OP_PRESENCE_INTERVAL_S = 0.25
OP_SEARCH_DEVICES, OP_SEARCH_PAGE = 64, 4
OP_STREAMS, OP_CHUNKS, OP_CHUNK_BYTES, OP_SEND_BACK = 16, 64, 64 << 10, 4
OP_TAP_COLS = ("device_id", "event_type", "ts_s", "ts_ns", "payload_ref",
               "mtype_id", "value")


class OpSinks:
    """What the outbound run's connectors deliver to: a loopback
    ``ThreadingHTTPServer`` (the webhook's and the index's paths record
    each body; ``/dead`` always answers 500), the port's hosted
    ``MqttBroker`` with one subscribing ``MqttClient`` that keeps every
    (topic, payload), and a tap that keeps the columns of every row."""

    def __init__(self):
        import http.server

        from sitewhere_tpu_torch.ingest.mqtt import MqttClient
        from sitewhere_tpu_torch.ingest.mqtt_broker import MqttBroker

        self.bodies = collections.defaultdict(list)
        self.lock = threading.Lock()
        sinks = self

        class Handler(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def do_POST(self):  # noqa: N802
                body = self.rfile.read(int(self.headers["Content-Length"]))
                dead = self.path.endswith("/dead")
                if not dead:
                    with sinks.lock:
                        sinks.bodies[self.path].append(body)
                self.send_response(500 if dead else 200)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def log_message(self, *args):
                pass

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                      Handler)
        self.server.daemon_threads = True
        self._serve = threading.Thread(target=self.server.serve_forever,
                                       daemon=True, name="op-http")
        self._serve.start()
        self.broker = MqttBroker(port=0)
        self.broker.start()
        self.received = collections.defaultdict(list)
        self.subscriber = MqttClient("127.0.0.1", self.broker.port,
                                     client_id="op-subscriber")
        self.subscriber.on_message = self._on_message
        self.subscriber.connect()
        self.subscriber.subscribe("sw/#", qos=1)
        self.clients = []

    def _on_message(self, topic, payload):
        tag = topic.split("/")[1]
        with self.lock:
            self.received[tag].append((topic, bytes(payload)))

    def url(self, tag, leg):
        return f"http://127.0.0.1:{self.server.server_port}/{tag}/{leg}"

    def docs(self, tag, leg):
        with self.lock:
            bodies = list(self.bodies.get(f"/{tag}/{leg}", ()))
        return [d for b in bodies for d in json.loads(b)]

    def connectors(self, inst, tag, hook_devices, mqtt_devices):
        """The six connectors, their deliver seconds and the tap's rows."""
        from sitewhere_tpu_torch.ingest.mqtt import MqttClient
        from sitewhere_tpu_torch.outbound.connectors import (
            CallbackConnector, FileConnector, HttpConnector,
            IndexPushConnector, MqttOutboundConnector)
        from sitewhere_tpu_torch.outbound.filters import (
            DeviceFilter, EventTypeFilter)
        from sitewhere_tpu_torch.runtime.resilience import CircuitBreaker
        from sitewhere_tpu_torch.schema import EventType

        tap, lock = [], threading.Lock()

        def keep(cols, mask):
            rows = {k: np.asarray(cols[k])[mask].copy() for k in OP_TAP_COLS}
            with lock:
                tap.append(rows)

        client = MqttClient("127.0.0.1", self.broker.port,
                            client_id=f"op-publisher-{tag}")
        client.connect()
        self.clients.append(client)
        path = os.path.join(inst.data_dir, "outbound", "alerts.jsonl")
        conns = [
            CallbackConnector("tap", keep),
            FileConnector("alerts", path, identity=inst.identity,
                          filters=[EventTypeFilter([int(EventType.ALERT)],
                                                   include=True)],
                          priority=True),
            HttpConnector("webhook", self.url(tag, "hook"),
                          identity=inst.identity,
                          filters=[DeviceFilter(hook_devices, include=True)]),
            IndexPushConnector("index", self.url(tag, "index"),
                               bulk_rows=500, bulk_interval_s=0.5,
                               filters=[DeviceFilter(hook_devices,
                                                     include=True)]),
            MqttOutboundConnector(
                "mqtt", client, identity=inst.identity, qos=1,
                multicaster=lambda doc: [f"type-{doc['deviceTypeId']}"],
                route_builder=lambda route, doc:
                    f"sw/{tag}/{route}/{doc['deviceId']}",
                filters=[DeviceFilter(mqtt_devices, include=True)]),
            HttpConnector("dead", self.url(tag, "dead"),
                          filters=[DeviceFilter(hook_devices, include=True)],
                          breaker=CircuitBreaker(
                              f"op-dead-{tag}", window=8, min_calls=4,
                              open_for_s=3600.0, metrics=inst.metrics),
                          dead_letters=inst.dead_letters),
        ]
        deliver_s = {}
        for c in conns:
            acc = deliver_s[c.connector_id] = [0.0]
            c.deliver = _time_into(c.deliver, acc)
            inst.outbound.add_connector(c)
        return conns, deliver_s, tap, path

    def close(self):
        for c in self.clients:
            c.disconnect()
        self.subscriber.disconnect()
        self.broker.stop()
        self.server.shutdown()
        self.server.server_close()
        self._serve.join(timeout=5.0)


def op_stored(store, **filters):
    """Every stored row (optionally filtered), as concatenated columns."""
    parts = collections.defaultdict(list)
    for cols in store.iter_chunks(**filters):
        for k, v in cols.items():
            parts[k].append(np.asarray(v))
    return {k: np.concatenate(v) for k, v in parts.items()}


def op_take(cols, mask):
    return {k: v[mask] for k, v in cols.items()}


def op_docs(cols, identity):
    """``marshal_row`` of every row, as JSON strings (key order kept)."""
    from sitewhere_tpu_torch.outbound.connectors import marshal_row

    return [json.dumps(marshal_row(cols, r, identity))
            for r in range(len(cols["ts_s"]))]


def op_lines(devices, ts_s, seed, kind="m"):
    """One NDJSON payload: a line per device, no unregistered tokens;
    measurements in MEAS_VALUE_BAND or alerts, at ``ts_s`` plus 0-750 ms."""
    rng = np.random.default_rng(seed)
    lo, hi = MEAS_VALUE_BAND
    body = []
    for d, v, q in zip(np.asarray(devices).tolist(),
                       rng.uniform(lo, hi, len(devices)).tolist(),
                       rng.integers(0, 4, len(devices)).tolist()):
        t = ts_s * 1000 + 250 * q
        body.append(_M_LINE % (f"d-{d}", d % M_SLOTS, v, t) if kind == "m"
                    else _A_LINE % (f"d-{d}", d % 4, t))
    return "\n".join(body).encode()


def op_hist_le(hist, q):
    """The upper bound of the bucket holding the ``q`` quantile of a
    histogram, in ms (its buckets' resolution), or None without samples."""
    snap = hist.snapshot()
    if not snap["count"]:
        return None
    for bound, cum in snap["buckets"].items():
        if cum >= q * snap["count"]:
            return bound * 1e3
    return float("inf")


def op_counts(inst):
    return {cid: dict(s, shed=inst.metrics.counter(
        f"outbound.overload_shed.{cid}").value)
        for cid, s in inst.outbound.stats().items()}


def op_state_equal(a, b, skip=()):
    return sorted(a) == sorted(b) and all(
        a[k].tobytes() == b[k].tobytes() for k in a if k not in skip)


def outbound_wire_run(device, geo_cuda, world, payloads, root, sinks, run,
                      blocks):
    """One wire run of ``payloads`` through a fresh ``Instance`` from the
    world, the window query registered: ``off`` with no connectors, ``on``
    with the six.  Timed from the first payload to the outbound drain.
    Returns ``(record, instance, context)``; the ``on`` instance stays
    started for the presence, search and stream runs."""
    import torch

    data_dir = os.path.join(root, run)
    inst = instance_from_world(
        device, world, data_dir, CAPACITY, FULL_B, 0, WIRE_DEADLINE_MS,
        presence={"scan_interval_s": 3600.0,
                  "missing_after_s": OP_MISSING_AFTER_S})
    disp, runner = inst.dispatcher, inst.analytics
    runner.register(OP_QUERY)
    matches = []
    real_record = runner._record

    def record(entry, found, live):
        if live:
            matches.extend((m.device_id, m.ts_s, m.value) for m in found)
        return real_record(entry, found, live=live)

    runner._record = record
    ctx = {"matches": matches}
    if run == "on":
        # attached before start(), so the instance's lifecycle starts and
        # stops each connector (the index's interval flusher and its
        # final flush at stop)
        ctx["conns"], ctx["deliver_s"], ctx["tap"], ctx["alerts_path"] = \
            sinks.connectors(inst, run, blocks["hook"], blocks["mqtt"])
    inst.start()
    offers = []
    real_submit = inst.outbound.submit

    def submit(cols, mask, **kw):
        offers.append(int(np.asarray(mask).sum()))
        return real_submit(cols, mask, **kw)

    inst.outbound.submit = submit
    try:
        torch.cuda.synchronize()
        snap0 = disp.metrics_snapshot()
        stages0 = _stage_totals(disp)
        rejected0 = inst.registration.rejected
        legs0 = disp.metrics.timer("pipeline.egress_outbound_s")
        legs0 = (legs0.count, legs0.total)
        disp.latencies_s.clear()
        geo_cuda.reset_launch_counts()
        t0 = time.perf_counter()
        for payload, _ in payloads:
            disp.ingest_wire_lines(payload)
        settle(inst)
        t_flushed = time.perf_counter() - t0
        runner.drain(timeout_s=600.0)
        inst.outbound.drain(60.0)
        elapsed = time.perf_counter() - t0
        launches = geo_cuda.launch_counts["pip_parity"]
        snap = disp.metrics_snapshot()
        timer = disp.metrics.timer("pipeline.egress_outbound_s")
        latency = _latency(disp, "max")
        stage_ms = _stage_ms(disp, stages0)
        rejected = inst.registration.rejected - rejected0
        state = inst.device_state.snapshot_host()
    except BaseException:
        inst.terminate()
        raise
    delta = {k: snap[k] - snap0[k] for k in (
        "steps", "processed", "accepted", "unregistered", "derived_alerts")}
    lines = sum(p.count(b"\n") + 1 for p, _ in payloads)
    plans = timer.count - legs0[0]
    ack = inst.metrics.histogram("outbound.ack_latency_s")
    rec = {"phase": "outbound_presence", "run": f"outbound_wire.{run}",
           "payloads": len(payloads), "lines": lines, "elapsed_s": elapsed,
           "flushed_s": t_flushed, "events_per_s": lines / elapsed,
           **latency, "stage_ms": stage_ms,
           # requests of the plans' journal records handed to registration
           # and refused: the ghost rows and every straddled record's rest
           "registration_rejected": rejected,
           "pip_launches": launches, **delta,
           "outbound_offers": len(offers), "live_matches": len(matches),
           "egress_outbound_ms_per_plan": (
               (timer.total - legs0[1]) * 1e3 / plans if plans else None),
           "ack_latency_p50_le_ms": op_hist_le(ack, 0.50),
           "ack_latency_p99_le_ms": op_hist_le(ack, 0.99),
           "acks": ack.snapshot()["count"]}
    rec.update(guard_counts(disp.metrics, "outbound_presence"))
    check(launches == delta["steps"],
          f"{run}: kernel launched {launches}x in {delta['steps']} steps")
    ctx.update(offers=offers, delta=delta, state=state)
    return rec, inst, ctx


def outbound_checks(inst, sinks, ctx, rec, blocks):
    """The ``on`` run's deliveries against the store: see the module
    docstring, phase 13."""
    from sitewhere_tpu_torch.ids import NULL_ID
    from sitewhere_tpu_torch.schema import EventType

    counts = op_counts(inst)
    rec["connectors"] = counts
    rec["ingest_to_ack_s"] = {
        cid: inst.metrics.gauge(
            f"pipeline.ingest_to_outbound_ack_latency_s.{cid}").value
        for cid in OP_CONNECTORS}
    rec["rows_per_s"] = {
        cid: (counts[cid]["processed"] / ctx["deliver_s"][cid][0]
              if ctx["deliver_s"][cid][0] else None)
        for cid in ("alerts", "webhook", "mqtt", "index")}
    rec["deliver_s"] = {cid: acc[0] for cid, acc in ctx["deliver_s"].items()}
    stored = op_stored(inst.event_store)
    tap = {k: np.concatenate([b[k] for b in ctx["tap"]])
           for k in OP_TAP_COLS}
    sc = tap["event_type"] == int(EventType.STATE_CHANGE)
    check(counts["tap"]["dropped"] == 0,
          f"tap dropped {counts['tap']['dropped']} batches")
    check(row_checksum(op_take(tap, ~sc)) == row_checksum(stored),
          "the tap's rows != the stored rows")
    check(not (tap["payload_ref"][sc] != NULL_ID).any(),
          "a journaled STATE_CHANGE row reached the tap")
    fanned = sorted(zip(tap["device_id"][sc].tolist(),
                        tap["ts_s"][sc].tolist(),
                        tap["value"][sc].tolist()))
    check(fanned == sorted(ctx["matches"]),
          f"{len(fanned)} match rows at the tap, {len(ctx['matches'])} "
          "live matches")
    check(len(fanned) > 0, "the window query matched nothing")
    alerts = op_take(stored, stored["event_type"] == int(EventType.ALERT))
    with open(ctx["alerts_path"]) as f:
        lines = f.read().splitlines()
    check(sorted(lines) == sorted(op_docs(alerts, inst.identity)),
          "the alerts file != marshal_row over the stored ALERT rows")
    hook = op_take(stored, np.isin(stored["device_id"], blocks["hook"]))
    want = sorted(json.dumps(json.loads(d), sort_keys=True)
                  for d in op_docs(hook, inst.identity))
    got = sorted(json.dumps(d, sort_keys=True)
                 for d in sinks.docs("on", "hook"))
    check(got == want, f"webhook: {len(got)} rows, {len(want)} stored")
    mqtt = op_take(stored, np.isin(stored["device_id"], blocks["mqtt"]))
    want = sorted(
        (f"sw/on/type-{d['deviceTypeId']}/{d['deviceId']}", s.encode())
        for s, d in ((s, json.loads(s)) for s in op_docs(mqtt,
                                                         inst.identity)))
    deadline = time.monotonic() + 60.0
    while len(sinks.received["on"]) < len(want) \
            and time.monotonic() < deadline:
        time.sleep(0.01)
    got = sorted(sinks.received["on"])
    check(got == want, f"mqtt: {len(got)} messages, {len(want)} stored")
    letters = [d for d in inst.list_dead_letters(limit=1 << 20)
               if d.get("kind") == "connector-shed"]
    check(counts["dead"]["errors"] > 0 and ctx["conns"][-1].shed > 0
          and letters and all(d["connector"] == "dead" for d in letters),
          f"the dead connector's breaker: errors {counts['dead']['errors']},"
          f" shed {ctx['conns'][-1].shed}, {len(letters)} letters")
    check(all(counts[c]["errors"] == 0 for c in OP_CONNECTORS
              if c != "dead"),
          f"a live connector counted an error: {counts}")
    billed = inst.usage_ledger.usage_of(0).get("usage", {}).get(
        "outbound_rows", 0)
    offered = len(OP_CONNECTORS) * sum(ctx["offers"])
    check(billed == offered and sum(ctx["offers"])
          == ctx["delta"]["accepted"] + len(ctx["matches"]),
          f"outbound_rows {billed}, offered {offered}")
    rec.update(rows_stored=int(stored["ts_s"].size),
               match_rows=len(fanned), alert_rows=len(lines),
               webhook_rows=len(hook["ts_s"]), mqtt_rows=len(want),
               dead_shed_rows=ctx["conns"][-1].shed,
               connector_shed_letters=len(letters),
               outbound_rows_billed=billed)
    return stored


def outbound_shed_run(device, geo_cuda, world, root, sinks, blocks):
    """``outbound_shed``: a fresh instance with the ladder on, forced to
    SHEDDING; one 4096-line ALERT payload (CRITICAL, admitted at
    SHEDDING) reaches only the priority connector."""
    import torch

    from sitewhere_tpu_torch.runtime.overload import OverloadState

    data_dir = os.path.join(root, "shed")
    inst = instance_from_world(
        device, world, data_dir, CAPACITY, FULL_B, 0, WIRE_DEADLINE_MS,
        overload={"enabled": True, "cooldown_s": 3600.0})
    conns, _, tap, path = sinks.connectors(inst, "shed", blocks["hook"],
                                           blocks["mqtt"])
    inst.start()
    try:
        disp = inst.dispatcher
        inst.overload.force(OverloadState.SHEDDING)
        torch.cuda.synchronize()
        snap0 = disp.metrics_snapshot()
        offers = [0]
        real_submit = inst.outbound.submit

        def submit(cols, mask, **kw):
            offers[0] += 1
            return real_submit(cols, mask, **kw)

        inst.outbound.submit = submit
        geo_cuda.reset_launch_counts()
        devices = blocks["hook"][:OP_SHED_LINES]
        disp.ingest_wire_lines(op_lines(devices, OP_TS0_MS // 1000 + 40_000,
                                        SEED + 91, kind="a"))
        settle(inst)
        inst.analytics.drain(timeout_s=60.0)
        inst.outbound.drain(60.0)
        launches = geo_cuda.launch_counts["pip_parity"]
        snap = disp.metrics_snapshot()
        counts = op_counts(inst)
        state = inst.overload.state
        inst.stop()
        with open(path) as f:
            alert_lines = len(f.read().splitlines())
    finally:
        inst.terminate()
    steps = snap["steps"] - snap0["steps"]
    accepted = snap["accepted"] - snap0["accepted"]
    rec = {"phase": "outbound_presence", "run": "outbound_shed",
           "ladder": state.name, "lines": OP_SHED_LINES,
           "accepted": accepted, "plans_offered": offers[0],
           "alerts_rows": counts["alerts"]["processed"],
           "alerts_file_lines": alert_lines, "connectors": counts,
           "pip_launches": launches, "steps": steps}
    emit(rec)
    check(state >= OverloadState.SHEDDING, f"the ladder left SHEDDING: {state}")
    check(accepted >= OP_SHED_LINES and offers[0] > 0,
          f"shed run: accepted {accepted}, offers {offers[0]}")
    check(counts["alerts"]["processed"] == accepted == alert_lines,
          f"priority connector got {counts['alerts']['processed']} of "
          f"{accepted}")
    for cid in OP_CONNECTORS:
        if cid == "alerts":
            continue
        check(counts[cid]["shed"] == offers[0]
              and counts[cid]["processed"] == 0,
              f"{cid} at SHEDDING: {counts[cid]} for {offers[0]} offers")
    check(not tap, "the tap received a row at SHEDDING")
    check(launches == steps, f"shed: {launches} launches in {steps} steps")
    return launches


def presence_run(geo_cuda, inst, stored, blocks, tap):
    """``presence`` on the ``on`` instance after its wire run: the scans,
    one sweep with the clock injected, send-once, re-arming, and the
    sweep thread beside 4 payloads.  Returns the launches by sub-run."""
    import torch

    from sitewhere_tpu_torch.pipeline.packed import pack_state
    from sitewhere_tpu_torch.schema import EventType
    from sitewhere_tpu_torch.state import manager as state_manager
    from sitewhere_tpu_torch.state.presence import (
        STATE_CHANGE_PRESENCE_MISSING, PresenceManager, presence_sweep)

    mgr, disp, pm = inst.device_state, inst.dispatcher, inst.presence
    after = OP_MISSING_AFTER_S
    launches = {}
    rec = {"phase": "outbound_presence", "run": "presence",
           "missing_after_s": after}
    # scans against the store
    t0 = time.perf_counter()
    missing = mgr.missing_device_ids()
    rec["missing_scan_ms"] = (time.perf_counter() - t0) * 1e3
    check(missing == [], f"{len(missing)} devices missing before a sweep")
    ts = stored["ts_s"]
    cut = int(np.percentile(ts, 50))
    t0 = time.perf_counter()
    seen = mgr.seen_since(cut)
    rec["seen_since_scan_ms"] = (time.perf_counter() - t0) * 1e3
    want = np.unique(stored["device_id"][ts >= cut]).tolist()
    check(seen == want, f"seen_since: {len(seen)} devices, {len(want)} in "
          "the store")
    with_events = np.unique(stored["device_id"])
    rec.update(devices_with_events=int(with_events.size),
               seen_since_devices=len(seen))

    # the sweep's card time beside its byte bound: last_event_type and
    # last_event_ts_s (int32) and presence_missing (bool) read, the new
    # presence_missing and the newly-missing mask written
    state = mgr.current
    now1 = int(ts.max()) + after + 1
    rec["sweep_ms"] = cuda_ms(lambda: presence_sweep(state, now1, after), 20)
    d = state.capacity
    sweep_bytes = d * (4 + 4 + 1) + 2 * d
    rec["sweep_bound_ms"] = sweep_bytes / PEAK_HBM_BYTES * 1e3
    rec["sweep_bytes"] = sweep_bytes
    rec["repack_ms"] = cuda_ms(lambda: pack_state(state), 5)
    del state

    emitted = []      # (now, device ids) of every sweep that marked any
    before = mgr.snapshot_host()
    real_cb = pm.on_state_changes
    held = []
    pm.on_state_changes = held.append
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    marked = pm.sweep_once(now_s=now1)
    torch.cuda.synchronize()
    rec["sweep_host_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    mgr.current_packed             # the sweep dropped the packed epoch
    torch.cuda.synchronize()
    rec["next_step_repack_ms"] = (time.perf_counter() - t0) * 1e3
    pm.on_state_changes = real_cb
    batch = held[0]
    ids = batch.device_id.cpu().numpy()
    check(marked == ids.size and np.array_equal(np.sort(ids), with_events),
          f"the sweep marked {marked}, {with_events.size} devices have events")
    check(bool((batch.alert_code == STATE_CHANGE_PRESENCE_MISSING).all())
          and not bool(batch.update_state.any())
          and bool((batch.event_type == int(EventType.STATE_CHANGE)).all()),
          "the sweep's STATE_CHANGE rows")
    emitted.append((now1, ids))
    snap0 = disp.metrics_snapshot()
    geo_cuda.reset_launch_counts()
    tap0 = len(tap)
    real_cb(batch)
    settle(inst)
    inst.analytics.drain(timeout_s=600.0)
    inst.outbound.drain(60.0)
    snap = disp.metrics_snapshot()
    launches["presence_sweep"] = geo_cuda.launch_counts["pip_parity"]
    steps = snap["steps"] - snap0["steps"]
    rec.update(state_change_rows=int(ids.size), state_change_plans=steps,
               state_change_launches=launches["presence_sweep"])
    check(launches["presence_sweep"] == steps,
          f"presence: {launches['presence_sweep']} launches in {steps} steps")
    after_state = mgr.snapshot_host()
    check(op_state_equal(before, after_state, skip=("presence_missing",)),
          "the sweep changed a field other than presence_missing")
    check(np.array_equal(np.nonzero(after_state["presence_missing"])[0],
                         with_events), "presence_missing != devices with "
          "events")
    del before, after_state
    rows = op_stored(inst.event_store, event_type=int(EventType.STATE_CHANGE))
    mine = rows["ts_s"] == now1
    check(np.array_equal(np.sort(rows["device_id"][mine]), with_events),
          "the sweep's rows are not stored exactly once")
    tapped = {k: np.concatenate([b[k] for b in tap[tap0:]])
              for k in OP_TAP_COLS}
    tap_sc = np.sort(tapped["device_id"][
        (tapped["event_type"] == int(EventType.STATE_CHANGE))
        & (tapped["ts_s"] == now1)])
    check(np.array_equal(tap_sc, with_events),
          f"tap got {tap_sc.size} of the sweep's {with_events.size} rows")
    del tapped
    check(pm.sweep_once(now_s=now1) == 0, "a second sweep marked devices")

    # re-arm: one more payload clears exactly its block; a later sweep
    # marks exactly that block again
    block = blocks["rearm"]
    t_re = int(ts.max()) + 10
    geo_cuda.reset_launch_counts()
    snap0 = disp.metrics_snapshot()
    disp.ingest_wire_lines(op_lines(block, t_re, SEED + 92))
    settle(inst)
    snap = disp.metrics_snapshot()
    launches["presence_rearm"] = geo_cuda.launch_counts["pip_parity"]
    check(launches["presence_rearm"] == snap["steps"] - snap0["steps"],
          "re-arm: launches != steps")
    left = np.asarray(mgr.missing_device_ids())
    check(np.array_equal(left, np.setdiff1d(with_events, block)),
          f"the payload cleared {with_events.size - left.size} flags of "
          f"{block.size}")
    now2 = t_re + after + 1
    held.clear()
    pm.on_state_changes = held.append
    marked2 = pm.sweep_once(now_s=now2)
    pm.on_state_changes = real_cb
    ids2 = held[0].device_id.cpu().numpy()
    check(marked2 == block.size and np.array_equal(np.sort(ids2),
                                                   np.sort(block)),
          f"the re-armed sweep marked {marked2} of the block's {block.size}")
    emitted.append((now2, ids2))
    real_cb(held[0])
    settle(inst)
    rec.update(rearm_cleared=int(block.size), rearm_marked=int(marked2))

    # the sweep thread beside 4 payloads: the injected clock's cut lies
    # inside their event times
    t_c = t_re + 100
    cut = t_c + 2
    merges = [0, 0]
    real_merge = state_manager._merge_presence

    def merge(*args):
        merges[0] += 1
        return real_merge(*args)

    gauge = disp._m_occ["presence_merges"]

    class Summed:
        """The per-plan ``presence_merges`` gauge, summed over the run."""

        def set(self, v):
            merges[1] += int(v)
            gauge.set(v)

    sweeps = []

    def on_changes(batch):
        sweeps.append((cut + after, batch.device_id.cpu().numpy()))
        real_cb(batch)

    thread = PresenceManager(mgr, check_interval_s=OP_PRESENCE_INTERVAL_S,
                             missing_after_s=after,
                             on_state_changes=on_changes,
                             clock=lambda: cut + after)
    state_manager._merge_presence = merge
    disp._m_occ["presence_merges"] = Summed()
    geo_cuda.reset_launch_counts()
    snap0 = disp.metrics_snapshot()
    t0 = time.perf_counter()
    thread.start()
    try:
        for p in range(OP_CONCURRENT):
            disp.ingest_wire_lines(op_lines(blocks["concurrent"][p], t_c + p,
                                            SEED + 93 + p))
        settle(inst)
        time.sleep(2 * OP_PRESENCE_INTERVAL_S)
    finally:
        thread.stop()
        state_manager._merge_presence = real_merge
        disp._m_occ["presence_merges"] = gauge
    settle(inst)
    inst.analytics.drain(timeout_s=600.0)
    inst.outbound.drain(60.0)
    elapsed = time.perf_counter() - t0
    snap = disp.metrics_snapshot()
    launches["presence_concurrent"] = geo_cuda.launch_counts["pip_parity"]
    steps = snap["steps"] - snap0["steps"]
    check(launches["presence_concurrent"] == steps,
          f"concurrent: {launches['presence_concurrent']} launches in "
          f"{steps} steps")
    emitted += sweeps
    flagged = np.asarray(mgr.missing_device_ids())
    last = mgr.snapshot_host()["last_event_ts_s"]
    flagged_at = {}
    for now, dev in emitted:
        for x in dev.tolist():
            flagged_at[x] = now
    check(all(flagged_at[int(x)] - int(last[x]) > after for x in flagged),
          "a flagged device was seen within missing_after_s of its sweep")
    check(merges[1] > 0, "no presence merge during the concurrent run")
    rows = op_stored(inst.event_store, event_type=int(EventType.STATE_CHANGE))
    keys = collections.Counter(zip(rows["device_id"].tolist(),
                                   rows["ts_s"].tolist()))
    want = collections.Counter((int(x), now) for now, dev in emitted
                               for x in dev.tolist())
    check(keys == want, f"{sum(keys.values())} STATE_CHANGE rows stored, "
          f"{sum(want.values())} emitted (each once)")
    rec.update(concurrent={
        "payloads": OP_CONCURRENT, "elapsed_s": elapsed, "sweeps":
        thread.sweeps, "sweeps_marking": len(sweeps), "marked":
        thread.total_marked_missing, "presence_merges": merges[1],
        "commit_merges": merges[0], "plans": steps,
        "pip_launches": launches["presence_concurrent"]},
        flagged_at_end=int(flagged.size),
        state_change_rows_stored=int(rows["ts_s"].size))
    emit(rec)
    return launches


def search_run(inst):
    """``search``: the local provider against the store for 64 sampled
    devices, paged; a federated provider over two local legs against the
    numpy merge of the same rows."""
    from sitewhere_tpu_torch.outbound.search import (
        EventSearchProvider, FederatedSearchProvider)
    from sitewhere_tpu_torch.services.common import SearchCriteria

    stored = op_stored(inst.event_store)
    rng = np.random.default_rng(SEED + 94)
    devices = rng.choice(np.unique(stored["device_id"]), OP_SEARCH_DEVICES,
                         replace=False)
    tokens = [inst.identity.device.token_of(int(d)) for d in devices]
    local = inst.search_providers.get_provider("local")
    fed = FederatedSearchProvider("federated", [
        EventSearchProvider("a", inst.event_store),
        EventSearchProvider("b", inst.event_store)])

    def rows_of(results):
        return [(r.device_id, r.event_type, r.ts_s, r.ts_ns, r.mtype_id,
                 np.float32(r.value).tobytes()) for r in results]

    times = {"local": [], "federated": []}
    pages = 0
    for tok in tokens:
        d = inst.identity.device.lookup(tok)
        mine = op_take(stored, stored["device_id"] == d)
        key = mine["ts_s"].astype(np.int64) * 10**9 + mine["ts_ns"]
        want = sorted(zip(mine["device_id"].tolist(),
                          mine["event_type"].tolist(), mine["ts_s"].tolist(),
                          mine["ts_ns"].tolist(), mine["mtype_id"].tolist(),
                          [v.tobytes() for v in mine["value"]]))
        for name, provider, copies in (("local", local, 1),
                                       ("federated", fed, 2)):
            got, keys, page, total = [], [], 1, 1
            while len(got) < total:
                t0 = time.perf_counter()
                res = provider.search(SearchCriteria(
                    page=page, page_size=OP_SEARCH_PAGE), device_id=d)
                times[name].append(time.perf_counter() - t0)
                total = res.total
                if not res.results:
                    break
                got += rows_of(res.results)
                keys += [r.ts_s * 10**9 + r.ts_ns for r in res.results]
                page += 1
                pages += 1
            check(total == copies * key.size and sorted(got) == sorted(
                want * copies), f"{name} search of {tok}: {len(got)} rows, "
                f"{key.size} stored")
            check(keys == sorted(np.repeat(key, copies).tolist(),
                                 reverse=True),
                  f"{name} search of {tok} is not newest first")
    rec = {"phase": "outbound_presence", "run": "search",
           "devices": len(tokens), "page_size": OP_SEARCH_PAGE,
           "pages": pages,
           "local_ms_per_query": float(np.mean(times["local"])) * 1e3,
           "federated_ms_per_query": float(np.mean(times["federated"])) * 1e3,
           "rows_scanned": int(stored["ts_s"].size)}
    emit(rec)


def streams_run(inst, phase="outbound_presence"):
    """``streams``: stream lines through the dispatcher's host plane; 16
    devices each create a stream, send 64 chunks of 64 KiB out of order
    and ask for 4 back; one chunk for an unknown stream dead-letters and
    its requeue replays it once the stream exists.  Returns the record
    it prints (under ``phase``)."""
    import base64

    dm = inst.device_management
    dm.create_device_type(token="op-cam", name="Camera")
    cams = [f"op-cam-{i}" for i in range(OP_STREAMS)]
    for tok in cams:
        dm.create_device(token=tok, device_type="op-cam")
        dm.create_device_assignment(device=tok)
    rng = np.random.default_rng(SEED + 95)
    sent = {}
    sendbacks = []
    real_send = inst.stream_manager.handle_send_device_stream_data_request

    def send_back(tok, sid, seq):
        data = real_send(tok, sid, seq)
        sendbacks.append((tok, sid, seq, data))
        return data

    inst.stream_manager.handle_send_device_stream_data_request = send_back
    disp = inst.dispatcher

    def line(tok, kind, **req):
        return json.dumps({"deviceToken": tok, "type": kind,
                           "request": req})

    t0 = time.perf_counter()
    nbytes = 0
    for tok in cams:
        chunks = [rng.bytes(OP_CHUNK_BYTES) for _ in range(OP_CHUNKS)]
        sent[tok] = chunks
        order = rng.permutation(OP_CHUNKS).tolist()
        body = [line(tok, "DeviceStream", streamId="clip",
                     contentType="video/mp4")]
        body += [line(tok, "StreamData", streamId="clip", sequenceNumber=s,
                      data=base64.b64encode(chunks[s]).decode())
                 for s in order]
        payload = "\n".join(body).encode()
        nbytes += len(payload)
        disp.ingest_wire_lines(payload)
    t_data = time.perf_counter() - t0
    asks = {tok: rng.choice(OP_CHUNKS, OP_SEND_BACK, replace=False).tolist()
            for tok in cams}
    disp.ingest_wire_lines("\n".join(
        line(tok, "SendStreamData", streamId="clip", sequenceNumber=s)
        for tok in cams for s in asks[tok]).encode())
    disp.flush()
    for tok in cams:
        a = dm.get_active_assignment(tok)
        stream = inst.streams.get_assignment_stream(a.token, "clip")
        check(stream is not None and inst.streams.stream_content(
            stream.token) == b"".join(sent[tok]),
            f"{tok}: stream content != the chunks sent")
    check(sorted(sendbacks) == sorted(
        (tok, "clip", s, sent[tok][s]) for tok in cams for s in asks[tok]),
        "send-back answers != the chunks asked for")
    # a chunk for a stream that does not exist yet, then its requeue
    late = base64.b64encode(b"late-chunk").decode()
    disp.ingest_wire_lines(line(cams[0], "StreamData", streamId="late",
                                sequenceNumber=0, data=late).encode())
    disp.flush()
    letters = [d for d in inst.list_dead_letters(limit=1 << 20)
               if d.get("kind") == "failed-stream-request"]
    check(len(letters) == 1 and letters[0]["stream_id"] == "late",
          f"failed-stream-request letters: {letters}")
    disp.ingest_wire_lines(line(cams[0], "DeviceStream",
                                streamId="late").encode())
    disp.flush()
    out = inst.requeue_dead_letter(letters[0]["offset"])
    a = dm.get_active_assignment(cams[0])
    stream = inst.streams.get_assignment_stream(a.token, "late")
    check(out.get("requeued") and inst.streams.stream_content(stream.token)
          == b"late-chunk", f"requeue of the late chunk: {out}")
    check(len([d for d in inst.list_dead_letters(limit=1 << 20)
               if d.get("kind") == "failed-stream-request"]) == 1,
          "the requeue dead-lettered again")
    rec = {"phase": phase, "run": "streams",
           "devices": OP_STREAMS, "chunks": OP_STREAMS * OP_CHUNKS,
           "chunk_bytes": OP_CHUNK_BYTES, "payload_mb": nbytes / 1e6,
           "data_s": t_data, "mb_per_s": nbytes / 1e6 / t_data,
           "ms_per_stream_payload": t_data * 1e3 / OP_STREAMS,
           "send_backs": len(sendbacks), "requeued": bool(out["requeued"])}
    emit(rec)
    return rec


def phase_outbound_presence(device, geo_cuda, world):
    """Outbound, presence, search and device streams on the card (see the
    module docstring, phase 13), over the deployment's world checkpoint.
    Returns the kernel's launches by run."""
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="outbound-", dir=geo_cuda.BUILD_DIR)
    launches = {}
    sinks = OpSinks()
    try:
        rng = np.random.default_rng(SEED + 90)
        perm = rng.permutation(N_ACTIVE)

        def block(i):
            b = i % IS_BLOCKS
            return perm[b * FULL_B:(b + 1) * FULL_B]

        mixed = wire_payloads(rng, OP_MIXED, FULL_B, OP_TS0_MS,
                              devices=block)
        meas = measurement_payloads(
            rng, OP_MEAS, FULL_B, OP_TS0_MS + 1000 * OP_MIXED,
            devices=lambda p: block(OP_MIXED + p))
        payloads = mixed + meas
        del mixed, meas
        free = perm[perm % M_SLOTS != 0]
        blocks = {"hook": np.sort(free[:OP_HOOK_DEVICES]),
                  "mqtt": np.sort(free[:OP_MQTT_DEVICES]),
                  "rearm": np.sort(block(0)),
                  "concurrent": [block(1 + p) for p in range(OP_CONCURRENT)]}
        emit({"phase": "outbound_presence", "run": "setup",
              "lines": sum(p.count(b"\n") + 1 for p, _ in payloads),
              "seconds": time.perf_counter() - t0})
        off, inst, ctx = outbound_wire_run(device, geo_cuda, world, payloads,
                                           root, sinks, "off", blocks)
        try:
            inst.stop()
        finally:
            inst.terminate()
        emit(off)
        launches["outbound_wire.off"] = off["pip_launches"]
        state_off = ctx["state"]
        on, inst, ctx = outbound_wire_run(device, geo_cuda, world, payloads,
                                          root, sinks, "on", blocks)
        launches["outbound_wire.on"] = on["pip_launches"]
        try:
            stored = outbound_checks(inst, sinks, ctx, on, blocks)
            check(op_state_equal(state_off, ctx["state"]),
                  "device state differs between off and on")
            on["state_equal_off"] = True
            on["events_per_s_off_over_on"] = (off["events_per_s"]
                                              / on["events_per_s"])
            emit(on)
            del state_off, ctx["state"], payloads
            launches.update(presence_run(geo_cuda, inst, stored, blocks,
                                         ctx["tap"]))
            del stored
            search_run(inst)
            streams_run(inst)
            inst.stop()
            stored = op_stored(inst.event_store)
            hook = op_take(stored, np.isin(stored["device_id"],
                                           blocks["hook"]))
            want = sorted(json.dumps(json.loads(d), sort_keys=True)
                          for d in op_docs(hook, None))
            got = sorted(json.dumps(d, sort_keys=True)
                         for d in sinks.docs("on", "index"))
            index = ctx["conns"][3]
            check(got == want,
                  f"index: {len(got)} rows pushed, {len(want)} stored "
                  f"(indexed {index.indexed}, dropped {index.dropped}, "
                  f"errors {index.errors})")
            emit({"phase": "outbound_presence", "run": "index_final",
                  "rows": len(got), "bulks": len(sinks.bodies["/on/index"]),
                  "indexed": ctx["conns"][3].indexed,
                  "dropped": ctx["conns"][3].dropped})
        finally:
            inst.terminate()
        launches["outbound_shed"] = outbound_shed_run(
            device, geo_cuda, world, root, sinks, blocks)
    finally:
        sinks.close()
        shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "outbound_presence", "run": "done",
          "seconds": time.perf_counter() - t0})
    return launches


# -- tenant engines, users, scripts, labels, schedules, batch operations -------

TE_TS0_MS = WIRE_TS0_MS + 70_000_000
# devices each tenant's engine makes through its DeviceManagement, on top
# of the world's 1,000,000 (device_services' scale, 20,000 in all)
TE_ENGINE_DEVICES = 2_500
# full-width 60/30/10 payloads of every tenant's devices (pre-resolved
# columns with each row's tenant, the reference's multitenant intake),
# then full-width NDJSON payloads of the default tenant's devices through
# ingest_wire_lines (the wire lane lands rows in the default tenant)
TE_ARRAY_PAYLOADS, TE_WIRE_PAYLOADS = 8, 2
# tenant A's engine restarts between array payloads TE_RESTART_AT - 1 and
# TE_RESTART_AT, while payload TE_RESTART_AT flows
TE_RESTART_AT, TE_RESTART_TENANT, TE_MISMATCH_TENANT = 4, 3, 5
TE_MISMATCH_ROWS = 64
TE_BATCH_DEVICES = 1024
TE_LABELS = 4096
TE_SCRIPT_LINES = 4096
# the stored columns a line's decode and the registry decide: the two
# copies of the script payload differ in payload_ref, in received_s (the
# wall clock at egress) and in what the device state makes of the second
# copy (its derived alerts, its rule and zone hits)
TE_SCRIPT_COLS = ("device_id", "tenant_id", "event_type", "ts_s", "ts_ns",
                  "mtype_id", "value", "lat", "lon", "elevation",
                  "alert_code", "alert_level", "device_type_id",
                  "assignment_id", "area_id", "customer_id", "asset_id")
TE_SCRIPT = (
    "import json\n\n"
    "def decode(payload):\n"
    "    return [json.loads(line) for line in payload.splitlines()\n"
    "            if line.strip()]\n")
TE_SOURCES = [
    {"id": "scripted", "decoder": "te-ndjson",
     "receivers": [{"type": "tcp", "port": 0}]},
    {"id": "plain", "decoder": "jsonlines",
     "receivers": [{"type": "tcp", "port": 0}]},
]


def te_template(initialized):
    """The bootstrap template: an admin and an operator, the 8 world
    tenants (``tenant_token``), and one dataset initializer that counts
    its runs into ``initialized``."""
    from sitewhere_tpu_torch.instance import InstanceTemplate

    return InstanceTemplate(
        template_id="chip-smoke",
        users=[{"username": "admin", "password": "password",
                "first_name": "Admin", "last_name": "User",
                "authorities": ["ROLE_ADMIN"]},
               {"username": "operator", "password": "operator-pw",
                "first_name": "Op", "last_name": "Erator",
                "authorities": ["ROLE_OPERATOR"]}],
        tenants=[{"token": tenant_token(k), "name": f"Tenant {k}",
                  "auth_token": f"{tenant_token(k)}-auth"}
                 for k in range(N_TENANTS)],
        dataset_initializers=[lambda inst: initialized.append(1)])


def te_instance(device, data_dir, template, **extra):
    from sitewhere_tpu_torch.instance import Instance

    return Instance(instance_config(data_dir, CAPACITY, FULL_B, 0,
                                    WIRE_DEADLINE_MS, sources=TE_SOURCES,
                                    **extra), template, device=device)


def te_norm(obj):
    """A comparable view of store records: dataclasses as field dicts."""
    import dataclasses

    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: te_norm(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: te_norm(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [te_norm(v) for v in obj]
    return obj


def te_view(inst):
    """Users, tenants, each engine's devices and assignments, schedules,
    jobs and batch operations."""
    return {
        "users": te_norm(inst.users._users),
        "authorities": te_norm(inst.users._authorities),
        "tenants": te_norm(inst.tenants._tenants),
        "engines": {e.tenant.token: {
            "tenant_id": e.tenant_id,
            "devices": te_norm(e.device_management.devices),
            "assignments": te_norm(e.device_management.assignments)}
            for e in inst.engines.list_engines()},
        "schedules": te_norm(inst.schedules.schedules),
        "jobs": te_norm(inst.schedules.jobs),
        "batch_ops": te_norm(inst.batch_ops.operations),
    }


def te_populate(inst):
    """Each tenant's engine makes TE_ENGINE_DEVICES devices ``e<k>-<i>``,
    of its own device type ``sensor`` (with the command ``ping``), each
    assigned.  Returns the seconds and their handles by tenant."""
    t0 = time.perf_counter()
    handles = {}
    for k in range(N_TENANTS):
        dm = inst.engines.get_engine(tenant_token(k)).device_management
        dm.create_device_type(token="sensor", name="Sensor")
        dm.create_device_command("sensor", token="ping", name="ping",
                                 namespace="sw", parameters=[])
        for i in range(TE_ENGINE_DEVICES):
            dm.create_device(token=f"e{k}-{i}", device_type="sensor")
            dm.create_device_assignment(token=f"e{k}-a{i}",
                                        device=f"e{k}-{i}")
        handles[k] = np.asarray(inst.identity.device.lookup_many(
            [f"e{k}-{i}" for i in range(TE_ENGINE_DEVICES)]), np.int32)
    return time.perf_counter() - t0, handles


def te_columns(rng, inst, devices, owner, ts_s):
    """One full-width payload of pre-resolved 60/30/10 columns: a row per
    device of ``devices`` (handles), stamped with its owner tenant."""
    n = len(devices)
    kind = rng.choice(3, n, p=(0.6, 0.3, 0.1)).astype(np.int32)
    alert = np.asarray([inst.identity.alert_type.mint(f"device-{a}")
                        for a in range(4)], np.int32)
    return dict(
        device_id=devices.astype(np.int32),
        tenant_id=owner[devices].astype(np.int32),
        event_type=kind,
        ts_s=np.full(n, ts_s, np.int32),
        ts_ns=(250_000_000 * rng.integers(0, 4, n)).astype(np.int32),
        mtype_id=(devices % M_SLOTS).astype(np.int32),
        value=np.round(rng.uniform(0, 100, n), 3).astype(np.float32),
        lat=rng.uniform(-85, 85, n).astype(np.float32),
        lon=rng.uniform(-85, 85, n).astype(np.float32),
        elevation=rng.uniform(0, 50, n).astype(np.float32),
        alert_code=np.where(kind == 2, alert[devices % 4], -1).astype(
            np.int32),
        alert_level=np.ones(n, np.int32),
    )


def te_wire_payload(rng, tokens, ts_ms):
    """One NDJSON payload, 60/30/10, a line per token."""
    kind = rng.choice(3, len(tokens), p=(0.6, 0.3, 0.1))
    value = rng.uniform(0, 100, len(tokens))
    lat, lon = rng.uniform(-85, 85, (2, len(tokens)))
    t = ts_ms + 250 * rng.integers(0, 4, len(tokens))
    lines = []
    for j, (tok, k, v, la, lo, tt) in enumerate(zip(
            tokens, kind.tolist(), value.tolist(), lat.tolist(),
            lon.tolist(), t.tolist())):
        if k == 0:
            lines.append(_M_LINE % (tok, j % M_SLOTS, v, tt))
        elif k == 1:
            lines.append(_L_LINE % (tok, la, lo, 10.0, tt))
        else:
            lines.append(_A_LINE % (tok, j % 4, tt))
    return "\n".join(lines).encode()


def te_drive(inst, sid, payload):
    """Send one payload to source ``sid``'s TCP receiver and wait until
    the source decoded it and the decode pool delivered it."""
    src = {s.source_id: s for s in inst.sources}[sid]
    lines = payload.count(b"\n") + 1
    took0 = src.decoded_count
    is_send_tcp(src.receivers[0], [payload])
    is_wait(lambda: src.decoded_count - took0 + src.failed_count >= lines,
            f"source {sid}'s lines")
    check(src.failed_count == 0, f"source {sid} failed a payload")
    if inst.decode_pool is not None:
        check(inst.decode_pool.flush(600.0), "decode pool did not drain")


def te_label_matrix(png_bytes, scale, border):
    """The QR module matrix a label PNG shows (dark modules 1): the PNG's
    size from its header (``png.read_png_size``), its one IDAT inflated,
    each module's first pixel read."""
    import zlib

    from sitewhere_tpu_torch.labels import png

    w, h = png.read_png_size(png_bytes)
    pos, idat = 8, b""
    while pos < len(png_bytes):
        length = struct.unpack(">I", png_bytes[pos:pos + 4])[0]
        tag = png_bytes[pos + 4:pos + 8]
        if tag == b"IDAT":
            idat += png_bytes[pos + 8:pos + 8 + length]
        pos += 12 + length
    img = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        h, w + 1)[:, 1:]
    n = w // scale - 2 * border
    first = border * scale
    cells = img[first:first + n * scale:scale, first:first + n * scale:scale]
    return (cells == 0).astype(np.uint8)


def te_labels(inst, tokens):
    """One batch of PNG labels for ``tokens``; returns (seconds, pngs)."""
    t0 = time.perf_counter()
    pngs = inst.labels.generate_png_batch("default", "device", tokens)
    return time.perf_counter() - t0, pngs


def te_check_labels(inst, tokens, pngs):
    from sitewhere_tpu_torch.labels import qr

    gen = inst.labels.get_generator("default")
    bad = [tok for tok, p in zip(tokens, pngs)
           if qr.decode_matrix(te_label_matrix(p, gen.scale, gen.border))
           != gen.url_for("device", tok).encode()]
    check(len(pngs) == len(tokens) and not bad,
          f"{len(bad)} labels of {len(pngs)} do not decode to their URL")


def te_clone(obj):
    """A step's tensors (a packed dataclass or a tuple of them) cloned."""
    import dataclasses

    import torch

    if isinstance(obj, torch.Tensor):
        return obj.clone()
    if isinstance(obj, tuple):
        return tuple(te_clone(o) for o in obj)
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).clone()
        for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name), torch.Tensor)})


def tenant_engines_run(device, geo_cuda, world, root):
    """The phase's one ``Instance`` life: bootstrap, devices per tenant,
    mixed traffic with an engine restart, mismatch rows, schedules and
    batch operations, labels beside streams, a scripted source.  Returns
    ``(record, launches, view, data_dir, initialized)``."""
    import torch

    from sitewhere_tpu_torch.commands import (
        BinaryCommandEncoder, CallbackDeliveryProvider, CommandDestination,
        DeviceTypeMappingRouter, TopicParameterExtractor)
    from sitewhere_tpu_torch.pipeline.packed import packed_pipeline_step
    from sitewhere_tpu_torch.runtime.lifecycle import LifecycleState
    from sitewhere_tpu_torch.schema import EventType

    data_dir = os.path.join(root, "engines")
    shutil.copytree(world, os.path.join(data_dir, "checkpoint"))
    initialized = []
    t0 = time.perf_counter()
    inst = te_instance(device, data_dir, te_template(initialized))
    check(inst.restored, "the 8-tenant world was not restored")
    # the decoder script, uploaded before start() builds the sources
    inst.scripts.upload("te-ndjson", "decoder", TE_SCRIPT)
    inst.start()
    boot_s = time.perf_counter() - t0
    rec = {"phase": "tenant_engines", "run": "engines", "boot_s": boot_s}
    try:
        disp = inst.dispatcher
        # 1. bootstrap: the template's users and tenants, the engines up
        engines = {e.tenant.token: e for e in inst.engines.list_engines()}
        check(sorted(engines) == sorted(tenant_token(k)
                                        for k in range(N_TENANTS)),
              f"engines {sorted(engines)}")
        for k in range(N_TENANTS):
            e = engines[tenant_token(k)]
            check(e.state == LifecycleState.STARTED and e.tenant_id == k,
                  f"engine {tenant_token(k)}: {e.state}, id {e.tenant_id}")
        check(engines["default"].device_management is inst.device_management,
              "the default engine is not the instance's services")
        check(inst.bootstrapped and initialized == [1],
              f"bootstrap ran the initializers {len(initialized)}x")
        check(inst.users.authenticate("operator", "operator-pw").username
              == "operator", "the template's operator cannot log in")
        # 2. each engine's devices, through its own DeviceManagement
        populate_s, engine_handles = te_populate(inst)
        owner = np.full(CAPACITY, -1, np.int32)
        owner[:N_ACTIVE] = np.arange(N_ACTIVE) % N_TENANTS
        for k, h in engine_handles.items():
            owner[h] = k
        rec.update(engine_devices=N_TENANTS * TE_ENGINE_DEVICES,
                   populate_s=populate_s,
                   us_per_device=populate_s * 1e6 / (
                       N_TENANTS * TE_ENGINE_DEVICES))

        # 3. mixed traffic: every tenant's devices in blocks of a
        # permutation, then the default tenant's on the wire
        rng = np.random.default_rng(SEED + 110)
        fleet = np.flatnonzero(owner >= 0).astype(np.int32)
        perm = rng.permutation(fleet)
        blocks = [perm[(p * FULL_B) % len(perm):][:FULL_B]
                  for p in range(TE_ARRAY_PAYLOADS)]
        arrays = [te_columns(rng, inst, b, owner, TE_TS0_MS // 1000 + 10 * p)
                  for p, b in enumerate(blocks)]
        del blocks, perm
        t0_tokens = ([f"d-{i}" for i in range(0, N_ACTIVE, N_TENANTS)]
                     + [f"e0-{i}" for i in range(TE_ENGINE_DEVICES)])
        wires = [te_wire_payload(
            rng, [t0_tokens[j % len(t0_tokens)]
                  for j in range(p * FULL_B, (p + 1) * FULL_B)],
            TE_TS0_MS + 10_000 * (TE_ARRAY_PAYLOADS + p))
            for p in range(TE_WIRE_PAYLOADS)]
        sent = np.zeros(N_TENANTS, np.int64)
        for cols in arrays:
            sent += np.bincount(cols["tenant_id"], minlength=N_TENANTS)
        sent[0] += TE_WIRE_PAYLOADS * FULL_B
        # the egress: every plan's tenant block, summed
        block = np.zeros((3, 16), np.int64)
        egress = disp._egress

        def metered_egress(plan, out, replay_depth, trace=None):
            block[:] += out.tenant_meter
            return egress(plan, out, replay_depth, trace=trace)

        disp._egress = metered_egress
        # the first plan's step, captured for the plain-geofence rerun
        captured = []
        step = disp._packed_step

        def capturing(tables, ps, bi, bf):
            if captured:
                return step(tables, ps, bi, bf)
            inputs = (tables, te_clone(ps), te_clone(bi), te_clone(bf))
            out = step(tables, ps, bi, bf)
            captured.append((*inputs, te_clone(out)))
            return out

        disp._packed_step = capturing
        torch.cuda.synchronize()
        snap0 = disp.metrics_snapshot()
        disp.latencies_s.clear()
        geo_cuda.reset_launch_counts()
        restart = {}
        a_token = tenant_token(TE_RESTART_TENANT)
        t_run = time.perf_counter()
        for p, cols in enumerate(arrays):
            if p == TE_RESTART_AT:
                def restart_a():
                    t = time.perf_counter()
                    eng = inst.engines.restart_engine(a_token)
                    restart["ms"] = (time.perf_counter() - t) * 1e3
                    restart["state"] = eng.state

                worker = threading.Thread(target=restart_a)
                worker.start()
                disp.ingest_arrays(**cols)
                worker.join()
            else:
                disp.ingest_arrays(**cols)
        for payload in wires:
            disp.ingest_wire_lines(payload)
        settle(inst)
        elapsed = time.perf_counter() - t_run
        disp._packed_step = step
        latency = _latency(disp, "max")
        snap1 = disp.metrics_snapshot()
        lines = TE_ARRAY_PAYLOADS * FULL_B + TE_WIRE_PAYLOADS * FULL_B
        del arrays, wires
        check(restart.get("state") == LifecycleState.STARTED,
              f"tenant {a_token}'s engine restart: {restart}")
        a_dm = inst.engines.get_engine(a_token).device_management
        a_lost = [i for i in range(TE_ENGINE_DEVICES)
                  if f"e{TE_RESTART_TENANT}-{i}" not in a_dm.devices
                  or a_dm.get_active_assignment(
                      f"e{TE_RESTART_TENANT}-{i}") is None]
        check(not a_lost, f"{len(a_lost)} of {a_token}'s devices lost "
              "across its engine's restart")
        # one plan again from its carry, plain geofence, on the card
        launches_run = geo_cuda.launch_counts["pip_parity"]
        tables, ps, bi, bf, (k_ps, k_oi, k_met, k_present) = captured[0]
        p_ps, p_oi, p_met, p_present = packed_pipeline_step(
            tables, ps, bi, bf, plain_chunked)
        same = (torch.equal(p_oi, k_oi) and torch.equal(p_met, k_met)
                and torch.equal(p_present, k_present)
                and torch.equal(p_ps.si, k_ps.si)
                and torch.equal(p_ps.sf, k_ps.sf))
        check(same, "tenant_engines: plan != its plain-geofence rerun")
        check(geo_cuda.launch_counts["pip_parity"] == launches_run,
              "the plain rerun launched the kernel")
        del captured, tables, ps, bi, bf, k_ps, k_oi, k_met, k_present
        del p_ps, p_oi, p_met, p_present

        # 4. rows stamped with tenant B for devices of tenant A
        a_handles = engine_handles[TE_RESTART_TENANT][:TE_MISMATCH_ROWS]
        before = disp.metrics_snapshot()
        disp.ingest_arrays(
            device_id=a_handles,
            tenant_id=np.full(TE_MISMATCH_ROWS, TE_MISMATCH_TENANT, np.int32),
            event_type=np.zeros(TE_MISMATCH_ROWS, np.int32),
            ts_s=np.full(TE_MISMATCH_ROWS, TE_TS0_MS // 1000 + 500, np.int32),
            mtype_id=np.zeros(TE_MISMATCH_ROWS, np.int32),
            value=np.full(TE_MISMATCH_ROWS, 50.0, np.float32))
        disp.flush()
        after = disp.metrics_snapshot()
        mismatch = {k: after[k] - before[k]
                    for k in ("processed", "accepted", "unregistered")}
        check(mismatch["processed"] == TE_MISMATCH_ROWS
              and mismatch["accepted"] == 0,
              f"tenant-mismatch rows: {mismatch}")

        # 5. a scheduled invocation and a batch operation, delivered to a
        # callback (the default tenant's devices)
        delivered = []
        encoder = BinaryCommandEncoder()
        inst.commands.add_destination(CommandDestination(
            "te-callback", encoder, TopicParameterExtractor(),
            CallbackDeliveryProvider(
                lambda ex, payload, params: delivered.append(
                    (ex.invocation.target_assignment,
                     ex.invocation.initiator,
                     ex.invocation.initiator_id)))))
        inst.commands.router = DeviceTypeMappingRouter(
            {"sensor": "te-callback"})
        # a yearly trigger, fired on demand (the REST trigger's path): the
        # schedule's own ticker must not fire it again during the run
        inst.schedules.create_schedule(token="te-cron", name="Yearly",
                                       trigger_type="Cron", cron="0 0 1 1 *")
        inst.schedules.create_job(
            token="te-job", schedule="te-cron", job_type="CommandInvocation",
            config={"commandToken": "ping", "assignmentToken": "e0-a0"})
        check(inst.schedules.fire("te-cron") == 1, "the cron job did not run")
        t0 = time.perf_counter()
        op = inst.batch_ops.create_batch_command_invocation(
            "ping", devices=[f"e0-{i}" for i in range(TE_BATCH_DEVICES)],
            token="te-batch")
        check(inst.batch_ops.wait_idle(120.0), "the batch did not finish")
        batch_s = time.perf_counter() - t0
        check(op.status == "FinishedSuccessfully"
              and all(el.status == "Succeeded" for el in op.elements),
              f"batch {op.status}: {op.counts}")
        sched = [d for d in delivered if d[1] == "SCHEDULER"]
        batch = sorted(d[0] for d in delivered if d[1] == "BatchOperation")
        check(sched == [("e0-a0", "SCHEDULER", "te-job")],
              f"scheduled deliveries {sched}")
        check(batch == sorted(f"e0-a{i}" for i in range(TE_BATCH_DEVICES)),
              f"{len(batch)} batch deliveries for {TE_BATCH_DEVICES}")

        # 6. labels alone, then beside the device streams
        tokens = [f"d-{i}" for i in range(TE_LABELS)]
        alone_s, pngs = te_labels(inst, tokens)
        te_check_labels(inst, tokens, pngs)
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            streams = pool.submit(streams_run, inst, "tenant_engines")
            beside_s, pngs = te_labels(inst, tokens)
            streams_rec = streams.result()
        te_check_labels(inst, tokens, pngs)
        del pngs

        # 7. the scripted source against a jsonlines source, same bytes
        script_payload = te_wire_payload(
            rng, t0_tokens[:TE_SCRIPT_LINES], TE_TS0_MS + 900_000)
        refs = {}
        for sid in ("scripted", "plain"):
            refs[sid] = inst.ingest_journal.end_offset
            te_drive(inst, sid, script_payload)
            disp.flush()
        sent[0] += 2 * TE_SCRIPT_LINES
        settle(inst)
        inst.event_store.flush()
        stored = op_stored(inst.event_store)
        derived_codes = np.asarray(
            [inst.identity.alert_type.lookup(f"rule-{r}") for r in range(4)]
            + [inst.identity.alert_type.lookup(f"zone-{z}")
               for z in range(8)], np.int32)
        is_derived = ((stored["event_type"] == int(EventType.ALERT))
                      & np.isin(stored["alert_code"], derived_codes))
        by_ref = {}
        for sid, ref in refs.items():
            rows = op_take({k: stored[k] for k in TE_SCRIPT_COLS},
                           (stored["payload_ref"] == ref) & ~is_derived)
            order = np.lexsort(tuple(rows[k] for k in TE_SCRIPT_COLS))
            by_ref[sid] = {k: v[order] for k, v in rows.items()}
        check(len(by_ref["scripted"]["device_id"]) == TE_SCRIPT_LINES
              and all(np.array_equal(by_ref["scripted"][k],
                                     by_ref["plain"][k])
                      for k in TE_SCRIPT_COLS),
              "the scripted source's rows != the jsonlines source's")

        # per tenant: stored == sent lines + derived alerts, and so are
        # the tenant block's accepted rows (a derived alert re-enters
        # the step as a row of its source row's tenant)
        snap2 = disp.metrics_snapshot()
        stored_by = np.bincount(stored["tenant_id"][
            stored["tenant_id"] >= 0], minlength=N_TENANTS)[:N_TENANTS]
        derived_by = np.bincount(stored["tenant_id"][is_derived],
                                 minlength=N_TENANTS)[:N_TENANTS]
        derived = snap2["derived_alerts"] - snap0["derived_alerts"]
        check(int(derived_by.sum()) == derived,
              f"derived alerts stored {derived_by.sum()}, counted {derived}")
        check(np.array_equal(stored_by, sent + derived_by),
              f"stored by tenant {stored_by.tolist()} != sent "
              f"{sent.tolist()} + derived {derived_by.tolist()}")
        check(np.array_equal(block[0][:N_TENANTS], sent + derived_by)
              and not block[0][N_TENANTS:].any(),
              f"tenant block {block[0].tolist()} != sent {sent.tolist()}"
              f" + derived {derived_by.tolist()}")
        steps = snap2["steps"] - snap0["steps"]
        launches = geo_cuda.launch_counts["pip_parity"]
        check(launches == steps,
              f"kernel launched {launches}x in {steps} steps")
        rec.update({
            "array_payloads": TE_ARRAY_PAYLOADS,
            "wire_payloads": TE_WIRE_PAYLOADS, "lines": lines,
            "elapsed_s": elapsed, "events_per_s": lines / elapsed, **latency,
            "steps": steps, "pip_launches": launches,
            "derived_alerts": derived,
            "accepted": snap1["accepted"] - snap0["accepted"],
            "stored_by_tenant": stored_by.tolist(),
            "tenant_block_rows": block[0].tolist(),
            "restart_tenant": a_token, "restart_ms": restart["ms"],
            "plain_rerun_identical": same,
            "mismatch": mismatch,
            "batch_elements": TE_BATCH_DEVICES,
            "batch_elements_per_s": TE_BATCH_DEVICES / batch_s,
            "scheduled_deliveries": len(sched),
            "labels": TE_LABELS,
            "labels_per_s_alone": TE_LABELS / alone_s,
            "labels_per_s_beside_streams": TE_LABELS / beside_s,
            "streams_mb_per_s": streams_rec["mb_per_s"],
            "script_rows": len(by_ref["scripted"]["device_id"]),
        })
        rec.update(guard_counts(disp.metrics, "tenant_engines"))
        del stored, by_ref
        view = te_view(inst)
        t0 = time.perf_counter()
        inst.stop()
        rec["stop_s"] = time.perf_counter() - t0
    finally:
        inst.terminate()
    emit(rec)
    return rec, launches, view, data_dir, initialized


def tenant_engines_restart(device, data_dir, view, initialized):
    """A new ``Instance`` on the same directory, the ladder on: every
    record back, the template not run again, ``topology()`` naming the 8
    engines, label generation refused at SHEDDING."""
    from sitewhere_tpu_torch.runtime.overload import OverloadState
    from sitewhere_tpu_torch.services.common import ServiceUnavailable

    t0 = time.perf_counter()
    again = te_instance(device, data_dir, te_template(initialized),
                        overload={"enabled": True, "cooldown_s": 3600.0})
    restore_s = time.perf_counter() - t0
    try:
        check(again.restored, "the restart restored no checkpoint")
        again.start()
        check(again.bootstrapped and initialized == [1],
              f"the template ran again ({len(initialized)} runs)")
        got = te_view(again)
        for key in view:
            check(got[key] == view[key], f"restart: {key} differ")
        # topology(): the manager in the component tree (the reference's
        # manager keeps its engines outside the lifecycle tree, so the
        # engines themselves are named by its list)
        states = {}

        def walk(node):
            states[node["name"]] = node["state"]
            for child in node["children"]:
                walk(child)

        topo = again.topology()
        walk(topo["components"])
        check(topo["bootstrapped"]
              and states.get("tenant-engine-manager") == "started",
              f"topology: bootstrapped {topo['bootstrapped']}, manager "
              f"{states.get('tenant-engine-manager')}")
        engines = sorted(e.name for e in again.engines.list_engines()
                         if e.state.value == "started")
        check(engines == sorted(f"tenant-engine:{tenant_token(k)}"
                                for k in range(N_TENANTS)),
              f"started engines {engines}")
        again.overload.force(OverloadState.SHEDDING)
        try:
            again.labels.generate_png_batch("default", "device", ["d-0"])
            refused = False
        except ServiceUnavailable:
            refused = True
        check(refused and again.labels.refused_under_load == 1,
              "label generation was not refused at SHEDDING")
    finally:
        again.terminate()
    rec = {"phase": "tenant_engines", "run": "restart",
           "restore_s": restore_s,
           "users": len(view["users"]), "tenants": len(view["tenants"]),
           "engine_devices": {t: len(e["devices"])
                              for t, e in view["engines"].items()},
           "schedules": len(view["schedules"]), "jobs": len(view["jobs"]),
           "batch_ops": len(view["batch_ops"]), "engines_started": engines,
           "labels_refused_at_shedding": refused}
    emit(rec)


def phase_tenant_engines(device, geo_cuda):
    """Tenant engines, users and tokens, scripts, labels, schedules and
    batch operations on the card (see the module docstring, phase 14),
    over an 8-tenant world.  Returns the kernel's launches by run."""
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="tenants-", dir=geo_cuda.BUILD_DIR)
    try:
        world = world_checkpoint(device, root, "full", N_TENANTS)
        _, launches, view, data_dir, initialized = tenant_engines_run(
            device, geo_cuda, world, root)
        tenant_engines_restart(device, data_dir, view, initialized)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "tenant_engines", "run": "done",
          "seconds": time.perf_counter() - t0})
    return {"engines": launches}


# -- the REST/WS gateway and device telemetry ---------------------------------

GW_TS0_S = (WIRE_TS0_MS + 80_000_000) // 1000
GW_DEVICES = 256
GW_POSTS = 1024
GW_CLIENTS = 8
GW_KINDS = ("measurements", "locations", "alerts")
GW_MIX = (0.6, 0.3, 0.1)
GW_SAMPLED = 16             # assignments read back over REST
GW_CAPTURE_POSTS = 8        # POSTs inside the profiler capture
GW_RTT_GETS = 32            # GETs timed per connection kind
# bulk locations in a band north of every world zone (the polygons lie
# within 82 degrees of the equator), measurement values in the band where
# no world rule fires: the bulk run derives no alert, so stored rows ==
# 2xx answers
GW_LAT_BAND = (83.0, 89.0)


class GwClient:
    """One HTTP/1.1 connection to the gateway with the admin's bearer
    token; ``call`` returns ``(status, JSON body or text)``."""

    def __init__(self, port, token=None, timeout=120.0):
        import http.client

        self.conn = http.client.HTTPConnection("127.0.0.1", port,
                                               timeout=timeout)
        self.token = token

    def call(self, method, path, body=None):
        headers = ({"Authorization": f"Bearer {self.token}"}
                   if self.token else {})
        if body is not None:
            headers["Content-Type"] = "application/json"
        self.conn.request(method, path, headers=headers,
                          body=json.dumps(body).encode()
                          if body is not None else None)
        resp = self.conn.getresponse()
        data = resp.read()
        ctype = resp.getheader("Content-Type") or ""
        if ctype.startswith("application/json"):
            return resp.status, json.loads(data)
        return resp.status, data.decode("utf-8")

    def close(self):
        self.conn.close()


def gw_event_posts(rng, n, tokens, ts0_s):
    """``n`` event POSTs, 60/30/10 measurements, locations and alerts, over
    ``tokens`` (assignment tokens), each device's event time rising by one
    second a POST: ``[(token, kind, body)]``."""
    kind = rng.choice(3, n, p=list(GW_MIX))
    which = rng.integers(0, len(tokens), n)
    seen = collections.Counter()
    posts = []
    for k, w in zip(kind.tolist(), which.tolist()):
        tok = tokens[w]
        ts = ts0_s + seen[tok]
        seen[tok] += 1
        if k == 0:
            body = {"name": f"m{w % M_SLOTS}", "ts": ts,
                    "value": round(float(rng.uniform(*MEAS_VALUE_BAND)), 3)}
        elif k == 1:
            body = {"latitude": round(float(rng.uniform(*GW_LAT_BAND)), 5),
                    "longitude": round(float(rng.uniform(-179, 179)), 5),
                    "elevation": 5.0, "ts": ts}
        else:
            body = {"type": f"gw-{w % 4}", "level": 1, "message": "door",
                    "ts": ts}
        posts.append((tok, GW_KINDS[k], body))
    return posts


def gw_inside_point(inst):
    """A (lat, lon) inside zone 0 of the world (the default tenant's, no
    area, alert if inside), checked with the plain geofence on the host."""
    import torch

    from sitewhere_tpu_torch.ops.geo import points_in_polygons

    verts = inst.mirror.publish_zones().verts.cpu()
    v0 = verts[0]
    centre = v0.mean(dim=0)
    for f in (0.0, 0.25, 0.5, 0.75):
        for vx, vy in v0.tolist():
            x = float(centre[0]) * (1 - f) + vx * f
            y = float(centre[1]) * (1 - f) + vy * f
            pt = torch.tensor([[x, y]], dtype=torch.float32)
            if bool(points_in_polygons(pt, verts[:1])[0, 0]):
                return y, x
    raise AssertionError("no point inside zone 0")


def rest_gateway_run(device, geo_cuda, world, root, kernel_rec):
    """The phase's one ``Instance`` and ``WebServer``.  Returns the
    kernel's launches by run."""
    import torch

    from sitewhere_tpu_torch.pipeline.packed import packed_pipeline_step
    from sitewhere_tpu_torch.runtime.metrics import parse_exposition
    from sitewhere_tpu_torch.schema import EventType
    from sitewhere_tpu_torch.web import WebServer
    from sitewhere_tpu_torch.web.ws import ClientWebSocket

    data_dir = os.path.join(root, "gateway")
    # no presence sweep inside the run: its STATE_CHANGE rows would join
    # the stored rows the checks count
    inst = instance_from_world(device, world, data_dir, CAPACITY, FULL_B, 0,
                               WIRE_DEADLINE_MS,
                               presence={"scan_interval_s": 3600.0,
                                         "missing_after_s": 8 * 3600})
    disp, store = inst.dispatcher, inst.event_store
    launches = {}
    t_boot = time.perf_counter()
    inst.start()
    web = WebServer(inst, port=0, topology_interval_s=3600.0)
    web.start()
    boot_s = time.perf_counter() - t_boot
    try:
        # 1. log in as the template's admin
        anon = GwClient(web.port)
        status, login = anon.call(
            "POST", "/api/jwt", {"username": "admin", "password": "password"})
        check(status == 200 and "ROLE_ADMIN" in login["authorities"],
              f"rest_gateway: admin login {status} {login}")
        token = login["token"]
        admin = GwClient(web.port, token)

        # 2. CRUD: a device type, devices and their assignments
        t0 = time.perf_counter()
        status, _ = admin.call("POST", "/api/devicetypes",
                               {"token": "gw-sensor", "name": "GW sensor"})
        check(status == 200, f"rest_gateway: device type {status}")
        tokens = []
        for i in range(GW_DEVICES):
            status, doc = admin.call("POST", "/api/devices", {
                "token": f"gw-{i}", "device_type": "gw-sensor"})
            check(status == 200, f"rest_gateway: device gw-{i}: {doc}")
            status, doc = admin.call("POST", "/api/assignments", {
                "token": f"gwa-{i}", "device": f"gw-{i}"})
            check(status == 200, f"rest_gateway: assignment gwa-{i}: {doc}")
            tokens.append(doc["token"])
        crud_s = time.perf_counter() - t0
        status, page = admin.call("GET", "/api/devices?pageSize=1")
        check(status == 200 and page["numResults"] == GW_DEVICES,
              f"rest_gateway: device list {status} {page}")
        # one small GET over this keep-alive connection and over a fresh
        # connection each: the server writes a response's headers and body
        # in two sends, so a kept-alive client waits out its own delayed
        # ACK (Nagle) on every answer
        rtt = {}
        for how, conn_of in (("keepalive", lambda: admin),
                             ("fresh", lambda: GwClient(web.port, token))):
            t0 = time.perf_counter()
            for _ in range(GW_RTT_GETS):
                c = conn_of()
                status, _ = c.call("GET", "/api/devicetypes/gw-sensor")
                check(status == 200, "rest_gateway: device type GET")
                if c is not admin:
                    c.close()
            rtt[how] = (time.perf_counter() - t0) * 1e3 / GW_RTT_GETS

        # 3. event POSTs from GW_CLIENTS threads
        rng = np.random.default_rng(SEED + 80)
        posts = gw_event_posts(rng, GW_POSTS, tokens, GW_TS0_S)
        chunks = [posts[c::GW_CLIENTS] for c in range(GW_CLIENTS)]
        results = [[] for _ in range(GW_CLIENTS)]
        commits = []
        real_flush = store.flush

        def timed_flush(sync=True):
            t = time.perf_counter()
            try:
                return real_flush(sync=sync)
            finally:
                if sync:
                    commits.append(time.perf_counter() - t)

        def client(c):
            conn = GwClient(web.port, token)
            try:
                for tok, kind, body in chunks[c]:
                    t = time.perf_counter()
                    status, doc = conn.call(
                        "POST", f"/api/assignments/{tok}/{kind}", body)
                    results[c].append((tok, kind, body, status,
                                       time.perf_counter() - t, doc))
            finally:
                conn.close()

        store.flush = timed_flush
        torch.cuda.synchronize()
        snap0 = disp.metrics_snapshot()
        soft0 = disp.watchdog.soft_trips
        geo_cuda.reset_launch_counts()
        t0 = time.perf_counter()
        workers = [threading.Thread(target=client, args=(c,))
                   for c in range(GW_CLIENTS)]
        for w in workers:
            w.start()
        for w in workers:
            w.join()
        elapsed = time.perf_counter() - t0
        launches["posts"] = geo_cuda.launch_counts["pip_parity"]
        snap1 = disp.metrics_snapshot()
        store.flush = real_flush
        done = [r for rs in results for r in rs]
        ok = [r for r in done if 200 <= r[3] < 300]
        check(len(done) == GW_POSTS, f"rest_gateway: {len(done)} answers")
        check(len(ok) == GW_POSTS, "rest_gateway: non-2xx answers "
              f"{collections.Counter(r[3] for r in done)}: "
              f"{[r[5] for r in done if r[3] >= 300][:3]}")
        steps = snap1["steps"] - snap0["steps"]
        check(steps == launches["posts"],
              f"rest_gateway: {steps} steps != {launches['posts']} launches")
        derived = (snap1.get("derived_alerts", 0)
                   - snap0.get("derived_alerts", 0))
        lat_ms = np.asarray([r[4] for r in done]) * 1e3
        commit_ms = np.asarray(commits) * 1e3
        # stored rows == 2xx answers, by kind, and read back over REST
        store.flush()
        names = {"measurements": EventType.MEASUREMENT,
                 "locations": EventType.LOCATION, "alerts": EventType.ALERT}
        a_ids = {tok: inst.device_management.handle_for("assignment", tok)
                 for tok in tokens}
        rows = op_stored(store)
        mine = np.isin(rows["assignment_id"], list(a_ids.values()))
        sent = collections.Counter(r[1] for r in ok)
        for kind, etype in names.items():
            n = int((mine & (rows["event_type"] == int(etype))).sum())
            check(n == sent[kind],
                  f"rest_gateway: {n} {kind} stored, {sent[kind]} 2xx")
        check(int(mine.sum()) == len(ok) and derived == 0,
              f"rest_gateway: stored {int(mine.sum())}, 2xx {len(ok)}, "
              f"derived {derived}")
        by_tok = collections.defaultdict(list)
        for tok, kind, body, *_ in ok:
            by_tok[tok].append((kind, body))
        sampled = sorted(by_tok)[:GW_SAMPLED]
        t0 = time.perf_counter()
        for tok in sampled:
            want = [b for k, b in by_tok[tok] if k == "measurements"]
            status, page = admin.call(
                "GET", f"/api/assignments/{tok}/measurements?pageSize=1000")
            check(status == 200 and page["numResults"] == len(want),
                  f"rest_gateway: {tok} measurements {page.get('numResults')}"
                  f" != {len(want)}")
            got = sorted((r["ts_s"], np.float32(r["value"]))
                         for r in page["results"])
            check(got == sorted((b["ts"], np.float32(b["value"]))
                                for b in want),
                  f"rest_gateway: {tok} measurement rows differ")
            status, state = admin.call(
                "GET", f"/api/devicestates/gw-{tok.split('-')[1]}")
            check(status == 200, f"rest_gateway: state of {tok}: {state}")
            newest = max(b["ts"] for _, b in by_tok[tok])
            check(state["last_event_ts_s"] == newest,
                  f"rest_gateway: {tok} state ts {state['last_event_ts_s']} "
                  f"!= newest {newest}")
            locs = [b for k, b in by_tok[tok] if k == "locations"]
            if locs:
                last = max(locs, key=lambda b: b["ts"])
                check((state["last_location"]["lat"],
                       state["last_location"]["lon"]) == (
                    float(np.float32(last["latitude"])),
                    float(np.float32(last["longitude"]))),
                    f"rest_gateway: {tok} state location")
            for k, b in by_tok[tok]:
                if k != "measurements":
                    continue
                newest_m = max((bb for kk, bb in by_tok[tok]
                                if kk == k and bb["name"] == b["name"]),
                               key=lambda bb: bb["ts"])
                slot = inst.identity.mtype.lookup(b["name"])
                check(state["last_values"][slot] == float(
                    np.float32(newest_m["value"])),
                    f"rest_gateway: {tok} state value of {b['name']}")
        readback_ms = (time.perf_counter() - t0) * 1e3 / len(sampled)
        emit({"phase": "rest_gateway", "run": "posts",
              "boot_s": boot_s, "crud_s": crud_s,
              "crud_us_per_device": crud_s / GW_DEVICES * 1e6,
              "get_ms_keepalive": rtt["keepalive"],
              "get_ms_fresh_connection": rtt["fresh"],
              "posts": GW_POSTS, "clients": GW_CLIENTS,
              "posts_per_s": GW_POSTS / elapsed, "seconds": elapsed,
              "latency_p50_ms": float(np.percentile(lat_ms, 50)),
              "latency_p99_ms": float(np.percentile(lat_ms, 99)),
              "latency_max_ms": float(lat_ms.max()),
              "steps": steps, "kernel_launches": launches["posts"],
              "posts_per_step": GW_POSTS / max(1, steps),
              "commits": int(commit_ms.size),
              "commit_ms_p50": float(np.percentile(commit_ms, 50))
              if commit_ms.size else None,
              "commit_ms_max": float(commit_ms.max())
              if commit_ms.size else None,
              "stored": int(mine.sum()), "stored_by_kind": dict(sent),
              "derived_alerts": derived,
              "watchdog_soft_trips": disp.watchdog.soft_trips - soft0,
              "readback_ms_per_assignment": readback_ms})

        # 4. the geofence: one location inside zone 0, one outside; each
        # step captured and rerun from its carry with the plain geofence
        lat_in, lon_in = gw_inside_point(inst)
        captured = []
        step = disp._packed_step

        def capturing(tables, ps, bi, bf):
            inputs = (tables, te_clone(ps), te_clone(bi), te_clone(bf))
            out = step(tables, ps, bi, bf)
            captured.append((*inputs, te_clone(out)))
            return out

        geo_tok, alerts0 = tokens[0], {}
        rows0 = op_stored(store)
        a0 = a_ids[geo_tok]
        disp._packed_step = capturing
        geo_cuda.reset_launch_counts()
        try:
            for where, (la, lo) in (("inside", (lat_in, lon_in)),
                                    ("outside", (89.5, 179.5))):
                before = len(captured)
                status, doc = admin.call(
                    "POST", f"/api/assignments/{geo_tok}/locations",
                    {"latitude": la, "longitude": lo, "ts": GW_TS0_S + 10_000
                     + (where == "outside")})
                check(status == 200, f"rest_gateway: {where} POST {doc}")
                store.flush()
                rows1 = op_stored(store)
                new = ((rows1["assignment_id"] == a0)
                       & (rows1["event_type"] == int(EventType.ALERT)))
                alerts0[where] = (int(new.sum()) - int(
                    ((rows0["assignment_id"] == a0)
                     & (rows0["event_type"] == int(EventType.ALERT))).sum()))
                rows0 = rows1
                alerts0[f"{where}_steps"] = len(captured) - before
                status, state = admin.call("GET", "/api/devicestates/gw-0")
                check((state["last_location"]["lat"],
                       state["last_location"]["lon"]) == (
                    float(np.float32(la)), float(np.float32(lo))),
                    f"rest_gateway: {where} location not in the state")
        finally:
            disp._packed_step = step
        launches["geofence"] = geo_cuda.launch_counts["pip_parity"]
        check(alerts0["inside"] == 1 and alerts0["outside"] == 0,
              f"rest_gateway: derived zone alerts {alerts0}")
        check(launches["geofence"] == len(captured),
              f"rest_gateway: {launches['geofence']} launches, "
              f"{len(captured)} steps")
        launches_run = geo_cuda.launch_counts["pip_parity"]
        same = True
        for tables, ps, bi, bf, (k_ps, k_oi, k_met, k_present) in captured:
            p_ps, p_oi, p_met, p_present = packed_pipeline_step(
                tables, ps, bi, bf, plain_chunked)
            same = same and (torch.equal(p_oi, k_oi)
                             and torch.equal(p_met, k_met)
                             and torch.equal(p_present, k_present)
                             and torch.equal(p_ps.si, k_ps.si)
                             and torch.equal(p_ps.sf, k_ps.sf))
        check(same, "rest_gateway: geofence steps != plain-geofence rerun")
        check(geo_cuda.launch_counts["pip_parity"] == launches_run,
              "the plain rerun launched the kernel")
        emit({"phase": "rest_gateway", "run": "geofence",
              "inside": [lat_in, lon_in], **alerts0,
              "steps": len(captured), "plain_rerun_identical": same})
        del captured

        # 5. the device profile over REST, against the exposition
        wd = disp.watchdog
        before = {"soft_s": wd.soft_s, "hard_s": wd.hard_s,
                  "soft_trips": wd.soft_trips, "hard_trips": wd.hard_trips}
        geo_cuda.reset_launch_counts()
        t0 = time.perf_counter()
        status, prof = admin.call("POST", "/api/instance/profile/device", {})
        profile_s = time.perf_counter() - t0
        launches["device_profile"] = geo_cuda.launch_counts["pip_parity"]
        check(status == 200, f"rest_gateway: device profile {prof}")
        after = {"soft_s": wd.soft_s, "hard_s": wd.hard_s,
                 "soft_trips": wd.soft_trips, "hard_trips": wd.hard_trips}
        check(prof["width"] == FULL_B, f"rest_gateway: profile {prof}")
        # zones and full launch the kernel once an iteration, warm-up
        # included
        per_stage = prof["iters"] * (prof["repeats"] + 1)
        check(launches["device_profile"] == 2 * per_stage,
              f"rest_gateway: profile launched the kernel "
              f"{launches['device_profile']} times, not {2 * per_stage}")
        # unauthenticated, as a scraper reads it
        status, text = anon.call("GET", "/api/instance/metrics.prom")
        check(status == 200, "rest_gateway: metrics.prom")
        fams = parse_exposition(text)
        from sitewhere_tpu_torch.pipeline.telemetry import DEVICE_STAGES

        for stage in DEVICE_STAGES:
            fam = fams.get(f"device_stage_ms_{stage}")
            check(fam is not None and fam["type"] == "histogram",
                  f"rest_gateway: no device.stage_ms.{stage} family")
            s = fam["samples"]
            n = s[f"device_stage_ms_{stage}_count"]
            check(n == prof["repeats"],
                  f"rest_gateway: {stage} histogram count {n}")
            # the first bucket at or above the median holds at least half
            # of the samples
            med = prof[f"{stage}_ms"]
            above = [(float(k.split('"')[1]), k) for k in s
                     if k.startswith(f"device_stage_ms_{stage}_bucket")
                     and float(k.split('"')[1]) >= med]
            check(s[min(above)[1]] >= (n + 1) // 2,
                  f"rest_gateway: {stage} median {med} beyond its buckets")
        emit({"phase": "rest_gateway", "run": "device_profile",
              "width": prof["width"], "iters": prof["iters"],
              "repeats": prof["repeats"],
              "stage_ms": {st: prof[f"{st}_ms"] for st in DEVICE_STAGES},
              "kernel_ms": kernel_rec["ms"],
              "host_rtt_ms": prof["host_rtt_ms"],
              "device_events_per_s": prof.get("device_events_per_s"),
              "seconds": profile_s, "kernel_launches":
              launches["device_profile"],
              "watchdog_before": before, "watchdog_after": after})

        # 6. a profiler capture, started and stopped on two threads
        replies = {}

        def capture(action):
            c = GwClient(web.port, token)
            try:
                replies[action] = c.call("POST", "/api/instance/profile/xla",
                                         {"action": action})
            finally:
                c.close()

        geo_cuda.reset_launch_counts()
        t = threading.Thread(target=capture, args=("start",))
        t.start()
        t.join()
        check(replies["start"][0] == 200,
              f"rest_gateway: capture start {replies['start']}")
        for j in range(GW_CAPTURE_POSTS):
            status, _ = admin.call(
                "POST", f"/api/assignments/{tokens[j]}/measurements",
                {"name": "m0", "value": 30.0, "ts": GW_TS0_S + 20_000 + j})
            check(status == 200, "rest_gateway: POST inside the capture")
        t = threading.Thread(target=capture, args=("stop",))
        t.start()
        t.join()
        launches["capture"] = geo_cuda.launch_counts["pip_parity"]
        status, doc = replies["stop"]
        check(status == 200 and not doc["capturing"],
              f"rest_gateway: capture stop {replies['stop']}")
        traces = [os.path.join(dp, f) for dp, _, fs in os.walk(
            doc["trace_dir"]) for f in fs]
        sizes = {os.path.basename(p): os.path.getsize(p) for p in traces}
        named = [p for p in traces if os.path.getsize(p) > 0
                 and b"pip_parity_kernel" in open(p, "rb").read()]
        check(named, f"rest_gateway: no trace names the kernel: {sizes}")
        emit({"phase": "rest_gateway", "run": "capture",
              "trace_files": sizes, "names_kernel": len(named),
              "kernel_launches": launches["capture"]})

        # 7. the topology feed: its greeting snapshot and one broadcast
        ws = ClientWebSocket("127.0.0.1", web.port, "/ws/topology",
                             timeout=60.0,
                             headers={"Authorization": f"Bearer {token}"})
        try:
            _, greeting = ws.recv()
            # the feed greets a client before it lists it (the
            # reference's order: no broadcast interleaves with the
            # greeting), so broadcast until one reaches it
            deadline = time.monotonic() + 30.0
            sent_to = 0
            while not sent_to and time.monotonic() < deadline:
                t0 = time.perf_counter()
                sent_to = web.topology.broadcast()
                broadcast_ms = (time.perf_counter() - t0) * 1e3
                if not sent_to:
                    time.sleep(0.01)
            check(sent_to >= 1, "rest_gateway: no broadcast reached the "
                  "topology client")
            _, pushed = ws.recv()
        finally:
            ws.close()
        g, p = json.loads(greeting), json.loads(pushed)
        check(g["instance"] == p["instance"] == "chip-smoke",
              f"rest_gateway: topology feed {g['instance']}")
        check(p["devices"] == g["devices"] >= N_ACTIVE + GW_DEVICES,
              f"rest_gateway: topology devices {p['devices']}")
        status, spec = admin.call("GET", "/api/openapi.json")
        n_routes = sum(len(ops) for ops in spec["paths"].values())
        check(n_routes == 132, f"rest_gateway: {n_routes} routes")
        emit({"phase": "rest_gateway", "run": "topology",
              "greeting_bytes": len(greeting), "broadcast_ms": broadcast_ms,
              "clients": sent_to, "routes": n_routes})
        admin.close()
        anon.close()
    finally:
        web.stop()
        inst.stop()
        inst.terminate()
    return launches


def phase_rest_gateway(device, geo_cuda, world, kernel_rec):
    """The REST/WS gateway and device-stage telemetry over the port
    ``Instance`` on the card (see the module docstring, phase 15), over
    the one-tenant world.  Returns the kernel's launches by run."""
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="gateway-", dir=geo_cuda.BUILD_DIR)
    try:
        launches = rest_gateway_run(device, geo_cuda, world, root,
                                    kernel_rec)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "rest_gateway", "run": "done",
          "seconds": time.perf_counter() - t0})
    return launches


# -- device-fault containment and the control plane ----------------------------

CP_TS0_MS = WIRE_TS0_MS + 40_000_000
# the full-width chain fault strikes at this slot of the K=8 chain, after
# the earlier slots ran
CP_FAULT_SLOT = 3
# clean bisection subsets of the full-width run stepped again by the port
# on the CPU (each a full-width CPU step with the plain geofence); at the
# devfault bench's width 64 every clean subset is
CP_CPU_SUBSETS = 1
# overload and metering: the paced region's width and deadline
# (PACED_WIDTH, PACED_DEADLINE_MS) over the deployment's registry (2^20
# slots, 1,000,000 devices) spread over 8 tenants, the world that
# containment_full and the sticky child use too; tenant 0 ("default") is
# the noisy one, 4 of every 11 payloads
CP_TENANTS = 8
CP_TENANT_CYCLE = (0, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7)
CP_BURST, CP_REGION = 32, 88
CP_UTILS = (0.5, 2.0)
CP_SYNC_PAYLOADS = 16
# tenant 1 carries an eval quota its first evaluated batch overruns (a
# deprioritized tenant's rows are skipped, so live eval alone stops
# billing it below the refusal line; the CPU tests walk the whole ladder)
CP_QUOTA_TENANT, CP_QUOTA_EVAL_S = 1, 2e-5
# the sticky child: payloads of PACED_WIDTH lines of the default tenant's
# devices
CP_STICKY_PAYLOADS = 2


def to_device(obj, device):
    """A packed dataclass (tables, carry) with every tensor on ``device``."""
    import dataclasses

    import torch

    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).to(device)
        for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name), torch.Tensor)})


def clean_measurements(rng, n_payloads, lines, ts0_ms, devices):
    """Measurement-only payloads of registered ``devices`` (no unknown
    tokens), values in MEAS_VALUE_BAND: no rule fires, so each full-width
    payload is one adopted plan.  Returns a list of bytes."""
    lo, hi = MEAS_VALUE_BAND
    out = []
    for p in range(n_payloads):
        dev = rng.choice(devices, lines)
        value = rng.uniform(lo, hi, lines)
        ts = ts0_ms + 1000 * p + 250 * rng.integers(0, 4, lines)
        out.append("\n".join(
            _M_LINE % (f"d-{d}", d % M_SLOTS, v, t)
            for d, v, t in zip(dev.tolist(), value.tolist(),
                               ts.tolist())).encode())
    return out


def poisoned(payload):
    """``payload`` with its first line's value NaN (JSON ``NaN``)."""
    first, rest = payload.split(b"\n", 1)
    head, tail = first.split(b'"value":', 1)
    return head + b'"value":NaN' + tail[tail.index(b","):] + b"\n" + rest


def steps_equal_on_cpu(captured, geofence):
    """Step each captured ``(tables, carry, bi, bf, outputs)`` again on the
    CPU with ``geofence`` (the plain version): outputs, metrics, presence
    and the carry's int rows bitwise, its exact float rows bitwise, the
    EWMA within EWMA_MAX_ULP of the value scale.  Returns the worst EWMA
    error in ULPs of the scale; raises on any other difference."""
    import torch

    from sitewhere_tpu_torch.pipeline.packed import packed_pipeline_step

    cpu = torch.device("cpu")
    worst = 0.0
    for tables, ps, bi, bf, out in captured:
        got = packed_pipeline_step(to_device(tables, cpu), to_device(ps, cpu),
                                   bi.cpu(), bf.cpu(), geofence)
        new_ps, oi, met, present = out
        check(torch.equal(oi.cpu(), got[1]), "subset outputs differ on CPU")
        check(torch.equal(met.cpu(), got[2]), "subset metrics differ on CPU")
        check(torch.equal(present.cpu(), got[3]),
              "subset presence differs on CPU")
        check(torch.equal(new_ps.si.cpu(), got[0].si),
              "subset int carry differs on CPU")
        n_exact = 3 + new_ps.num_mtype_slots
        check(torch.equal(new_ps.sf[:n_exact].cpu(), got[0].sf[:n_exact]),
              "subset float carry differs on CPU")
        a = got[0].sf[n_exact:].double()
        b = new_ps.sf[n_exact:].cpu().double()
        fin = torch.isfinite(a)
        check(torch.equal(torch.isfinite(b), fin), "EWMA finiteness differs")
        scale = torch.clamp(a.abs(), min=EWMA_SCALE) * 2.0 ** -23
        if bool(fin.any()):
            worst = max(worst, float(((a - b).abs()[fin]
                                      / scale[fin]).max()))
    check(worst <= EWMA_MAX_ULP, f"EWMA off by {worst} ULP of scale")
    return worst


def cp_devfault(device, geo_cuda, root):
    """The port's twin of tools/devfault_bench.py --smoke on the card,
    every phase's contract held, then every clean subset of a width-64
    bisection stepped again on the CPU."""
    import torch

    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tools"))
    import torch_devfault_bench as bench

    from sitewhere_tpu_torch.ops.geo import points_in_polygons
    from sitewhere_tpu_torch.pipeline.packed import packed_pipeline_step
    from sitewhere_tpu_torch.runtime import faults

    failures = []

    def note(ok, msg):
        if not ok and msg:
            failures.append(msg)

    def on_phase(name, report):
        emit({"phase": "control_plane", "run": f"devfault.{name}",
              **report})
        add_guards("control_plane.devfault." + name, dict(
            report, watchdog_soft_trips=report.get("soft_trips", 0),
            watchdog_hard_trips=report.get("hard_trips", 0)))

    phases = bench.run(device, note, os.path.join(root, "devfault"),
                       on_phase=on_phase)
    check(not failures, f"devfault contract: {failures}")
    for name, rep in phases.items():
        check(rep["cpu_fallback_steps"] == 0,
              f"devfault {name} stepped on the CPU")
    # the breaker's FALLBACK level failed closed in its child, and the
    # restart stored every journaled row
    from sitewhere_tpu_torch.runtime.dispatcher import STICKY_EXIT_CODE

    brk = phases["breaker"]
    check(brk["exit_code"] == STICKY_EXIT_CODE
          and brk["trip_levels"] == [1, 2]
          and brk["stored"] == brk["ingested"],
          f"the breaker did not fail closed at FALLBACK: {brk}")

    # every clean subset of a width-64 bisection against the CPU port
    inst = bench.make_instance(os.path.join(root, "subsets"), device)
    inst.start()
    bench.register(inst)
    d = inst.dispatcher
    d.breaker.threshold = 99
    traffic = bench.Traffic(clean_devices=bench.N_DEVICES - 1)
    d.ingest_wire_lines(traffic.payload())
    d.flush()
    captured = []
    step = d._packed_step

    def recording(tables, ps, bi, bf):
        out = packed_pipeline_step(tables, ps, bi, bf)
        captured.append((tables, ps, bi, bf, out))
        return out

    d._packed_step = recording
    faults.device_inject("device.dispatch", times=None,
                         when_nonfinite=True)
    try:
        d.ingest_wire_lines(traffic.payload(poison_rows=3))
        d.flush()
    finally:
        faults.device_clear()
        d._packed_step = step
    check(len(captured) > 1, "the width-64 bisection stepped no subset")
    worst = steps_equal_on_cpu(captured, points_in_polygons)
    emit({"phase": "control_plane", "run": "devfault.subsets_vs_cpu",
          "width": bench.WIDTH, "clean_subsets": len(captured),
          "bitwise": True, "ewma_max_ulp_of_scale": worst})
    del captured
    inst.stop()
    inst.terminate()
    torch.cuda.synchronize()


def cp_containment(device, geo_cuda, world, root):
    """Containment at the deployment's size (ring K=8): a fault at slot
    CP_FAULT_SLOT of a chain, then one poison row bisected out of a
    full-width plan.  Returns the kernel's launches in the run."""
    import torch

    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tools"))
    import torch_devfault_bench as bench

    from sitewhere_tpu_torch.ops.geo_cuda import points_in_polygons_auto
    from sitewhere_tpu_torch.pipeline.packed import packed_pipeline_step
    from sitewhere_tpu_torch.runtime import faults

    # every row counts: the ladder stays off (instance_config)
    inst = instance_from_world(device, world, os.path.join(root, "contain"),
                               CAPACITY, FULL_B, RING_K,
                               RING_DIAG_DEADLINE_MS)
    inst.start()
    d, sm = inst.dispatcher, inst.device_state
    rng = np.random.default_rng(SEED + 11)
    payloads = clean_measurements(rng, 2 * RING_K + 1, FULL_B, CP_TS0_MS,
                                  # the default tenant's devices: the
                                  # wire lines name no tenant
                                  np.arange(0, N_ACTIVE, CP_TENANTS))
    sent = 0
    try:
        for payload in payloads[:RING_K]:
            d.ingest_wire_lines(payload)
            sent += FULL_B
        d.flush()
        check(d.metrics_snapshot()["ring_chains"] >= 1,
              "the warm ring never chained")
        epoch0 = sm.snapshot_host()
        kept = {}

        def observe(plans, exc, _orig=d._recover_ring):
            kept.update(sm.snapshot_host())
            return _orig(plans, exc)

        d._ring_chains[RING_K] = bench.chain_failing_at(RING_K,
                                                        CP_FAULT_SLOT)
        d._recover_ring = observe
        c0 = fault_counters(inst.metrics)
        l0, s0 = geo_cuda.launch_counts["pip_parity"], d.steps
        t0 = time.perf_counter()
        try:
            for payload in payloads[RING_K:2 * RING_K]:
                d.ingest_wire_lines(payload)
                sent += FULL_B
            d.flush()
        finally:
            del d._recover_ring
            del d._ring_chains[RING_K]
        chain_s = time.perf_counter() - t0
        c1 = fault_counters(inst.metrics)
        l1, s1 = geo_cuda.launch_counts["pip_parity"], d.steps
        epoch_kept = bool(kept) and all(
            kept[k].tobytes() == epoch0[k].tobytes() for k in epoch0)
        del kept, epoch0
        check(epoch_kept, "the failed chain changed the held epoch")
        check(c1["chain_faults"] - c0["chain_faults"] == 1,
              "the chain fault was not contained once")

        # one poison row: bisected out of the full-width plan
        captured, geo_calls = [], []
        step = d._packed_step

        def geo_recording(points, verts):
            out = points_in_polygons_auto(points, verts)
            geo_calls.append((points, verts, out))
            return out

        def recording(tables, ps, bi, bf):
            out = packed_pipeline_step(tables, ps, bi, bf, geo_recording)
            captured.append((tables, ps, bi, bf, out))
            return out

        bisect = {}
        contain = d._contain_step_failure

        def timed(plan, exc, depth, trace):
            t = time.perf_counter()
            try:
                contain(plan, exc, depth, trace)
            finally:
                bisect["ms"] = (time.perf_counter() - t) * 1e3

        d._packed_step = recording
        d._contain_step_failure = timed
        faults.device_inject("device.dispatch", times=None,
                             when_nonfinite=True)
        try:
            d.ingest_wire_lines(poisoned(payloads[-1]))
            sent += FULL_B
            d.flush()
        finally:
            faults.device_clear()
            d._packed_step = step
            del d._contain_step_failure
        c2 = fault_counters(inst.metrics)
        l2 = geo_cuda.launch_counts["pip_parity"]
        settle(inst)
        inst.event_store.flush()
        stored = inst.event_store.total_events
        letters = [doc for doc in inst.list_dead_letters(limit=20)
                   if doc.get("kind") == "device-poison"]
        # the kernel against its plain version on every clean subset
        # (comparison launches, after the counted window)
        subsets_bitwise = all(
            torch.equal(out, plain_chunked(points, verts))
            for points, verts, out in geo_calls)
        check(subsets_bitwise, "kernel != plain on a bisection subset")
        worst = steps_equal_on_cpu(captured[:CP_CPU_SUBSETS],
                                   lambda p, v: plain_chunked(p, v))
        n_subsets = len(captured)
        del captured, geo_calls
        inst.stop()
    finally:
        inst.terminate()
    torch.cuda.synchronize()
    poison = c2["poison_rows"] - c1["poison_rows"]
    rec = {"phase": "control_plane", "run": "containment_full",
           "width": FULL_B, "capacity": CAPACITY, "devices": N_ACTIVE,
           "zones": FULL_Z, "ring_depth": RING_K,
           "chain_fault_slot": CP_FAULT_SLOT,
           "chain_faults": c1["chain_faults"] - c0["chain_faults"],
           "redispatched_plans": s1 - s0,
           "chain_fault_launches": l1 - l0, "chain_fault_s": chain_s,
           "epoch_kept_bitwise": epoch_kept,
           "step_faults": c2["step_faults"] - c1["step_faults"],
           "bisect_rounds": c2["bisect_rounds"] - c1["bisect_rounds"],
           "bisect_ms": bisect.get("ms"), "clean_subsets": n_subsets,
           "bisect_launches": l2 - l1, "poison_rows": poison,
           "poison_letters": sum(int(doc["count"]) for doc in letters),
           "subsets_kernel_bitwise": subsets_bitwise,
           "subsets_vs_cpu": CP_CPU_SUBSETS,
           "subsets_cpu_ewma_max_ulp_of_scale": worst,
           "sent": sent, "stored": stored,
           "nothing_lost": stored == sent - poison,
           **{k: c2[k] for k in ("cpu_fallback_steps",
                                 "watchdog_soft_trips",
                                 "watchdog_hard_trips")}}
    emit(rec)
    add_guards("control_plane.containment_full", c2)
    check(rec["redispatched_plans"] == RING_K,
          f"{rec['redispatched_plans']} plans re-dispatched, not {RING_K}")
    check(poison == 1 and rec["poison_letters"] == 1,
          f"poison rows {poison}, letters {rec['poison_letters']}")
    check(rec["nothing_lost"], f"stored {stored} of {sent} sent")
    check(rec["bisect_launches"] == n_subsets,
          "bisection launches != clean subsets")
    return {"chain_fault": l1 - l0, "bisect": l2 - l1}


def sticky_child(spec):
    """``--kill-child`` roles ``sticky`` and ``sticky-recover``.  sticky:
    an instance of the world ingests and commits its first payload, then a
    patch in this script makes its step trigger a real device-side
    assert; the dispatcher must fail closed (the process exits with the
    dispatcher's STICKY_EXIT_CODE).  sticky-recover: restart on the
    survivor's directory and count what came back."""
    import torch

    from sitewhere_tpu_torch.device import resolve_device
    from sitewhere_tpu_torch.instance import Instance

    device = resolve_device(spec["device"])
    torch.set_num_threads(2)
    data_dir, width = spec["data_dir"], spec["width"]
    extra = {"rules": {"programs_enabled": False},
             "analytics": {"enabled": False}}
    rng = np.random.default_rng(SEED + 13)
    devices = np.arange(0, spec["n_active"], CP_TENANTS)  # the default's
    payloads = clean_measurements(rng, CP_STICKY_PAYLOADS, width,
                                  CP_TS0_MS + 5_000_000, devices)
    out = {"role": spec["role"]}
    if spec["role"] == "sticky":
        inst = instance_from_world(device, spec["world_ckpt"], data_dir,
                                   spec["capacity"], width, 0,
                                   WIRE_DEADLINE_MS, **extra)
        inst.start()
        d = inst.dispatcher
        d.flush()
        inst.checkpointer.save()
        d.ingest_wire_lines(payloads[0])
        d.flush()
        out["before_fault"] = fault_counters(inst.metrics)
        out["stored_before_fault"] = inst.event_store.total_events
        with open(spec["result_out"], "w") as f:
            json.dump(out, f)
        step = d._packed_step

        def asserting(tables, ps, bi, bf):
            res = step(tables, ps, bi, bf)
            # an out-of-range index: a device-side assert, reported
            # asynchronously, after which the context is lost
            bad = torch.full((1,), 1 << 30, dtype=torch.long,
                             device=bi.device)
            bi[0][bad]
            return res

        d._packed_step = asserting
        d.ingest_wire_lines(payloads[1])
        d.flush()
        out["survived"] = True
        with open(spec["result_out"], "w") as f:
            json.dump(out, f)
        return
    inst = Instance(instance_config(data_dir, spec["capacity"], width, 0,
                                    WIRE_DEADLINE_MS, **extra),
                    device=device)
    check(inst.restored, "the sticky restart restored no checkpoint")
    inst.start()
    inst.dispatcher.flush()
    inst.event_store.flush()
    out.update({
        "stored": inst.event_store.total_events,
        "sent": CP_STICKY_PAYLOADS * width,
        "replay_events": int(inst.metrics.snapshot()["gauges"][
            "recovery.replay_events"]),
        "poison_letters": len([
            doc for doc in inst.list_dead_letters(limit=1000)
            if doc.get("kind") == "device-poison"]),
        "dead_letter_kinds": sorted({
            doc.get("kind") for doc in inst.list_dead_letters(limit=1000)}),
        "flightrec_snapshots": [s.get("reason") for s in
                                inst.flightrec.snapshots()],
        "guards": fault_counters(inst.metrics),
    })
    inst.stop()
    inst.terminate()
    with open(spec["result_out"], "w") as f:
        json.dump(out, f)


def cp_sticky(device, world, root):
    """A real device-side assert in a child process: it must exit
    non-zero with nothing dead-lettered and no CPU step, and a fresh
    child must recover every sent row from the checkpoint and journal."""
    from sitewhere_tpu_torch.runtime.dispatcher import STICKY_EXIT_CODE

    base = dict(capacity=CAPACITY, n_active=N_ACTIVE, width=PACED_WIDTH,
                world_ckpt=world, device=str(device),
                data_dir=os.path.join(root, "sticky"))
    t0 = time.perf_counter()
    spec = dict(base, role="sticky",
                result_out=os.path.join(root, "sticky.json"))
    rc, err = _wait_all({"sticky": _spawn(spec)}, 300)["sticky"]
    child_s = time.perf_counter() - t0
    first = _read_result(spec["result_out"])
    check(rc != 0 and not first.get("survived"),
          f"the sticky child did not fail closed (rc {rc}): {err}")
    check("failing closed" in err, f"no fail-closed log: {err[-800:]}")
    spec = dict(base, role="sticky-recover",
                result_out=os.path.join(root, "sticky-recover.json"))
    rc2, err2 = _wait_all({"recover": _spawn(spec)}, 300)["recover"]
    check(rc2 == 0, f"the sticky restart failed (rc {rc2}): {err2}")
    res = _read_result(spec["result_out"])
    rec = {"phase": "control_plane", "run": "sticky_child",
           "width": PACED_WIDTH, "exit_code": rc,
           "exit_code_expected": STICKY_EXIT_CODE,
           "stored_before_fault": first["stored_before_fault"],
           "cpu_fallback_steps_before_fault":
           first["before_fault"]["cpu_fallback_steps"],
           "child_s": child_s, **{k: v for k, v in res.items()
                                  if k != "role"},
           "restart_cpu_fallback_steps": res["guards"]["cpu_fallback_steps"],
           "nothing_lost": res["stored"] == res["sent"]}
    emit(rec)
    add_guards("control_plane.sticky_child", res["guards"])
    check(rc == STICKY_EXIT_CODE, f"sticky child exit {rc}")
    check(res["poison_letters"] == 0, "a sticky error dead-lettered rows")
    check(first["before_fault"]["cpu_fallback_steps"] == 0
          and res["guards"]["cpu_fallback_steps"] == 0,
          "a sticky run stepped on the CPU")
    check("device-lost" in res["flightrec_snapshots"],
          "no device-lost flight-recorder dump")
    check(rec["nothing_lost"], f"sticky restart stored {res['stored']} "
          f"of {res['sent']}")


def tenant_payloads(rng, n, lines, ts0_ms, n_active):
    """The overload run's traffic: payload ``i`` belongs to tenant
    ``CP_TENANT_CYCLE[i % 11]`` and carries measurements of that tenant's
    devices, values uniform on [0, 100] (rules fire on some).  Returns
    ``[(tenant, bytes)]``."""
    out = []
    for p in range(n):
        k = CP_TENANT_CYCLE[p % len(CP_TENANT_CYCLE)]
        dev = k + CP_TENANTS * rng.integers(0, n_active // CP_TENANTS,
                                            lines)
        value = rng.uniform(0, 100, lines)
        ts = ts0_ms + 1000 * p + 250 * rng.integers(0, 4, lines)
        out.append((k, "\n".join(
            _M_LINE % (f"d-{d}", d % M_SLOTS, v, t)
            for d, v, t in zip(dev.tolist(), value.tolist(),
                               ts.tolist())).encode()))
    return out


def cp_overload_extra(metering=True):
    """The overload run's sections: the ladder, the SLO engine and the
    flight recorder at their defaults, and the quota tenant's budget."""
    return {
        "overload": {"enabled": True}, "slo": {"enabled": True},
        "metering": {"enabled": metering},
        "tenants": {tenant_token(CP_QUOTA_TENANT): {
            "quota": {"eval_s_per_window": CP_QUOTA_EVAL_S}}},
    }


def cp_overload_instance(device, world, data_dir, metering=True):
    return instance_from_world(device, world, data_dir, CAPACITY,
                               PACED_WIDTH, 0, PACED_DEADLINE_MS,
                               **cp_overload_extra(metering))


def cp_decoded(payloads):
    from sitewhere_tpu_torch.ingest.decoders import JsonLinesDecoder

    decoder = JsonLinesDecoder()
    out = []
    for k, payload in payloads:
        reqs = decoder(payload)
        for r in reqs:
            r.metadata = {"tenant": tenant_token(k)}
        out.append((k, payload, reqs))
    return out


def cp_overload(device, geo_cuda, world, root):
    """The paced region at 50% and 200% of the rate it sustains, through
    an Instance with the ladder, metering and the SLO engine at their
    defaults, over 8 tenants with one noisy."""
    from sitewhere_tpu_torch.runtime.overload import OverloadShed
    from sitewhere_tpu_torch.services.common import QuotaExceeded

    capacity, n_active = CAPACITY, N_ACTIVE
    rng = np.random.default_rng(SEED + 17)
    t0 = time.perf_counter()
    traffic = cp_decoded(tenant_payloads(
        rng, CP_BURST + len(CP_UTILS) * CP_REGION + CP_SYNC_PAYLOADS,
        PACED_LINES, CP_TS0_MS + 9_000_000, n_active))
    decode_s = time.perf_counter() - t0
    inst = cp_overload_instance(device, world, os.path.join(root, "ov"))
    eng = inst.rule_engine
    for k in range(CP_TENANTS):
        eng.put_program(k, {"token": f"hot-{k}",
                            "alert": {"type": f"hot-{k}", "level": "warning"},
                            "when": {"pred": "value", "op": "gt",
                                     "value": 99.0}})
    ov, led, quotas = inst.overload, inst.usage_ledger, inst.quotas
    transitions = []
    ov.on_transition(lambda old, new, sig: transitions.append(
        {"from": old.name, "to": new.name, "driver": ov.last_driver,
         "t": time.perf_counter() - t_start,
         "seal_lag_s": sig.seal_lag_s}))
    quota_tid = int(inst.identity.tenant.lookup(
        tenant_token(CP_QUOTA_TENANT)))
    quota_states = []
    sent = collections.Counter()
    retry_after = collections.Counter()
    shed_payloads = collections.Counter()
    t_start = time.perf_counter()
    inst.start()
    d = inst.dispatcher
    launches0 = geo_cuda.launch_counts["pip_parity"]
    runs = []
    try:
        # the rate the region sustains: a burst with the ladder held at
        # NORMAL (its sampling paused, its watermarks untouched)
        signals_fn, ov.signals_fn = ov.signals_fn, None
        tb = time.perf_counter()
        for k, payload, reqs in traffic[:CP_BURST]:
            d.ingest_many(reqs, payload, source_id=f"src-{k}")
            sent[k] += len(reqs)
        d.flush()
        sustained = PACED_LINES * CP_BURST / (time.perf_counter() - tb)
        ov.signals_fn = signals_fn
        at = CP_BURST
        for util in CP_UTILS:
            gap_s = PACED_LINES / (sustained * util)
            snap0 = d.metrics_snapshot()
            shed0, adm0 = ov.shed_total, ov.admitted_total
            tr0 = len(transitions)
            d.latencies_s.clear()
            region = traffic[at:at + CP_REGION]
            at += CP_REGION
            # each sender offers every n-th payload on its own drift-free
            # schedule; ingest runs on the sender's thread, so more than
            # the sustained rate takes more than one sender
            n_send = max(1, int(round(util / CP_UTILS[0])))
            lock = threading.Lock()
            shed_here = [0]

            def sender(j, m0):
                for i in range(j, len(region), n_send):
                    k, payload, reqs = region[i]
                    delay = m0 + i * gap_s - time.monotonic()
                    if delay > 0:
                        time.sleep(delay)
                    try:
                        d.ingest_many(reqs, payload, source_id=f"src-{k}")
                        with lock:
                            sent[k] += len(reqs)
                    except OverloadShed as e:
                        with lock:
                            shed_here[0] += 1
                            shed_payloads[k] += 1
                            retry_after[str(e.retry_after_s)] += 1
                    with lock:
                        quota_states.append(quotas.state_of(quota_tid))

            t0 = time.perf_counter()
            m0 = time.monotonic()
            threads = [threading.Thread(target=sender, args=(j, m0))
                       for j in range(n_send)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            shed_here = shed_here[0]
            d.flush()
            elapsed = time.perf_counter() - t0
            snap = d.metrics_snapshot()
            steps = snap["steps"] - snap0["steps"]
            runs.append({
                "util": util, "senders": n_send, "offered_events_per_s":
                PACED_LINES * len(region) / elapsed,
                "payloads": len(region), "shed_payloads": shed_here,
                "shed_rows": ov.shed_total - shed0,
                "admitted_rows": ov.admitted_total - adm0,
                "transitions": transitions[tr0:],
                "steps": steps,
                "host_syncs_per_batch":
                (snap["host_syncs"] - snap0["host_syncs"]) / max(1, steps),
                **_latency(d, "p99")})
        settle(inst)
        inst.event_store.flush()
        launches = geo_cuda.launch_counts["pip_parity"] - launches0
        counters = inst.metrics.snapshot()["counters"]
        usage = {tenant_token(k): led.usage_of(k)["usage"]
                 for k in range(CP_TENANTS)}
        stored = collections.Counter()
        for c in inst.event_store.iter_chunks():
            t, n = np.unique(np.asarray(c["tenant_id"]), return_counts=True)
            for tid, cnt in zip(t.tolist(), n.tolist()):
                stored[tenant_token(tid)] += cnt
        # the operator gate in front of a rule program write
        try:
            quotas.check_eval(quota_tid)
            eng.put_program(quota_tid, {
                "token": "late", "alert": {"type": "late",
                                           "level": "info"},
                "when": {"pred": "value", "op": "gt", "value": 99.5}})
            refused = False
        except QuotaExceeded:
            refused = True
        slo_alerts = inst.slo.alerts_fired
        slo_alerting = sorted(k for k, v in inst.slo.snapshot()[
            "objectives"].items() if v["alerting"])
        snaps = inst.flightrec.snapshots()
        dump_bytes = sum(os.path.getsize(os.path.join(inst.flightrec.dir,
                                                      s["name"]))
                         for s in snaps)
        ledger_before = led.snapshot()["totals"]
        total_steps = d.steps
        total_syncs = d.metrics_snapshot()["host_syncs"]
        guards = fault_counters(inst.metrics)
        inst.stop()
        save = dict(inst.checkpointer.last_save_stats)
    finally:
        inst.terminate()
    add_guards("control_plane.overload", guards)
    # the tenant-metering section restored into a fresh instance
    from sitewhere_tpu_torch.instance import Instance

    t0 = time.perf_counter()
    again = Instance(instance_config(
        os.path.join(root, "ov"), capacity, PACED_WIDTH, 0,
        PACED_DEADLINE_MS, **cp_overload_extra()), device=device)
    restore_s = time.perf_counter() - t0
    try:
        check(again.restored, "the overload instance restored nothing")
        ledger_after = again.usage_ledger.snapshot()["totals"]
    finally:
        again.terminate()
    restored_equal = all(ledger_after[c] == ledger_before[c]
                         for c in ("rows", "state_writes", "shed_rows",
                                   "dead_letter_rows", "sealed_bytes"))
    # host syncs per batch with metering off, on the same payload shape
    off = cp_overload_instance(device, world, os.path.join(root, "ov-off"),
                               metering=False)
    off.start()
    try:
        for k, payload, reqs in traffic[at:at + CP_SYNC_PAYLOADS]:
            off.dispatcher.ingest_many(reqs, payload, source_id=f"src-{k}")
        off.dispatcher.flush()
        snap_off = off.dispatcher.metrics_snapshot()
        guards_off = fault_counters(off.metrics)
        off.stop()
    finally:
        off.terminate()
    add_guards("control_plane.overload", guards_off)
    syncs_on = total_syncs / max(1, total_steps)
    syncs_off = snap_off["host_syncs"] / max(1, snap_off["steps"])
    by_tenant = {tenant_token(k): {
        "admitted_rows_sent": sent[k],
        "shed_payloads": shed_payloads[k],
        "usage_rows": usage[tenant_token(k)]["rows"],
        "stored_rows": stored[tenant_token(k)],
        "usage_shed_rows": usage[tenant_token(k)]["shed_rows"],
        "usage_eval_s": usage[tenant_token(k)]["eval_s"]}
        for k in range(CP_TENANTS)}
    rec = {"phase": "control_plane", "run": "overload",
           "width": PACED_WIDTH, "deadline_ms": PACED_DEADLINE_MS,
           "capacity": capacity, "devices": n_active,
           "tenants": CP_TENANTS, "noisy": tenant_token(0),
           "decode_s": decode_s, "sustained_events_per_s": sustained,
           "regions": runs,
           "transitions": len(transitions),
           "shed_by_class": {k.split(".")[-1]: int(v)
                             for k, v in counters.items()
                             if k.startswith("overload.shed.")},
           "shed_by_tenant": {k[len("tenant.shed."):]: int(v)
                              for k, v in counters.items()
                              if k.startswith("tenant.shed.") and v},
           "retry_after_s": dict(retry_after),
           "tenants_usage": by_tenant,
           "quota": {"tenant": tenant_token(CP_QUOTA_TENANT),
                     "eval_s_per_window": CP_QUOTA_EVAL_S,
                     "states_seen": sorted(set(quota_states)),
                     "refused_at_end": refused,
                     "eval_rows_skipped": int(counters.get(
                         "tenant.quota.eval_rows_skipped", 0))},
           "slo_alerts": slo_alerts, "slo_alerting_at_end": slo_alerting,
           "flightrec_dumps": len(snaps), "flightrec_dump_bytes": dump_bytes,
           "flightrec_reasons": sorted({s.get("reason") for s in snaps}),
           "host_syncs_per_batch_metering_on": syncs_on,
           "host_syncs_per_batch_metering_off": syncs_off,
           "tenant_metering_save": {k: v for k, v in save.items()
                                    if "tenant-metering" in k},
           "tenant_metering_restored_equal": restored_equal,
           "restore_instance_s": restore_s,
           "kernel_launches": launches, "steps": total_steps,
           **guards}
    emit(rec)
    for k, row in by_tenant.items():
        check(row["usage_rows"] == row["stored_rows"],
              f"tenant {k}: billed {row['usage_rows']} rows, "
              f"stored {row['stored_rows']}")
    check(syncs_on == syncs_off,
          f"host syncs per batch {syncs_on} with metering, {syncs_off} "
          "without")
    check(restored_equal, "tenant-metering section restored unequal")
    check(launches == total_steps, f"kernel launched {launches}x in "
          f"{total_steps} steps")
    check(rec["quota"]["eval_rows_skipped"] > 0 and refused,
          f"the quota tenant was not throttled: {rec['quota']}")
    return launches


def phase_control_plane(device, geo_cuda):
    """Device-fault containment and the control plane on the card: the
    devfault bench's five phases, containment at the deployment's size,
    a sticky CUDA error in a child process, and overload and metering on
    the paced region.  Returns the kernel's launches by run."""
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="control-", dir=geo_cuda.BUILD_DIR)
    launches = {}
    try:
        l0 = geo_cuda.launch_counts["pip_parity"]
        cp_devfault(device, geo_cuda, root)
        launches["devfault"] = geo_cuda.launch_counts["pip_parity"] - l0
        # one world, its devices over CP_TENANTS tenants, for every run
        world = world_checkpoint(device, root, "full", CP_TENANTS)
        for k, v in cp_containment(device, geo_cuda, world, root).items():
            launches[f"containment_full.{k}"] = v
        cp_sticky(device, world, root)
        launches["overload"] = cp_overload(device, geo_cuda, world, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "control_plane", "run": "done",
          "seconds": time.perf_counter() - t0})
    return launches


# -- the sharded pipeline -------------------------------------------------------

SM_SHARDS = 8
SM_RINGS = 4                # timed rings of each mesh_chain path
SM_WIRE_PAYLOADS = RING_K
SM_RESERVATIONS = RING_K    # fill-direct reservations: one ring of K
SM_CONTAIN = {"n_shards": SM_SHARDS, "k": 2, "width": 128, "capacity": 64}
SM_AN_EVENTS = 1 << 22
SM_AN_WINDOWS = 16


def sm_routed_cols(rng, width, n_active, capacity, ts_s, n_shards):
    """``make_batch_cols`` in the sharded batcher's layout: segment ``s``
    of the batch holds devices of shard ``s``'s registry block; its
    0.5% unregistered rows are NULL_ID, as the batcher rewrites them."""
    cols = make_batch_cols(rng, width, n_active, capacity, ts_s)
    seg, rps = width // n_shards, capacity // n_shards
    dev = np.concatenate([
        rng.integers(s * rps, min((s + 1) * rps, n_active), seg)
        for s in range(n_shards)]).astype(np.int32)
    dev[cols["device_id"] >= n_active] = -1
    tenant = (dev % N_TENANTS).astype(np.int32)
    mism = rng.random(width) < 0.002
    tenant[mism] = (tenant[mism] + 1) % N_TENANTS
    cols["device_id"], cols["tenant_id"] = dev, tenant
    return cols


def sm_kernel_per_shard(device, geo_cuda, rec):
    """The kernel at the shape each shard's step gives it (B = width /
    shards), against the plain version and its bound; added to the
    kernel record beside the full-width row."""
    import torch

    b = FULL_B // SM_SHARDS
    gen = torch.Generator(device=device).manual_seed(SEED + 42)
    verts = random_polygons(gen, FULL_Z, FULL_V, -50, 50, 1, 20, device)
    points = (-60 + 120 * torch.rand((b, 2), generator=gen,
                                     device=device)).contiguous()
    ref = plain_chunked(points, verts)
    px, py = points[:, 0].contiguous(), points[:, 1].contiguous()
    planes = geo_cuda.edge_planes(verts)
    out = torch.empty((b, FULL_Z), dtype=torch.bool, device=device)
    ms = cuda_ms(lambda: geo_cuda.launch_pip(px, py, planes, out), 50)
    mismatches = int((out != ref).sum())
    check(mismatches == 0, f"kernel != plain at B={b}: {mismatches}")
    plain_ms = cuda_ms(lambda: plain_chunked(points, verts), 3)
    tests = b * FULL_Z * FULL_V
    bytes_moved = b * 2 * 4 + 4 * FULL_V * FULL_Z * 4 + b * FULL_Z
    ops_ms = max(PIP_FLOAT_PER_TEST * tests / PEAK_FP32_INSTR,
                 PIP_LOGIC_PER_TEST * tests / PEAK_INT32_INSTR) * 1e3
    bytes_ms = bytes_moved / PEAK_HBM_BYTES * 1e3
    shard = {"shape": [b, FULL_Z, FULL_V], "ms": ms, "plain_ms": plain_ms,
             "bound_ms": max(ops_ms, bytes_ms),
             "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
             "max_abs_err": float(mismatches)}
    rec["per_shard"] = shard
    emit({"phase": "sharded_mesh", "run": "kernel_per_shard", **shard,
          "ops_bound_ms": ops_ms, "bytes_bound_ms": bytes_ms})


def sm_mesh_chain(device, geo_cuda, mesh):
    """Shard-block-ordered traffic through the sharded K-chain, the
    sharded single step and the unsharded chain of ``main_path``, on the
    same inputs from the same empty carry: every output row, the metrics
    and the final carry bitwise equal; then the chain's last ring rerun
    from its carry with the plain geofence."""
    import torch

    from sitewhere_tpu_torch.pipeline.packed import (
        PackedView, pack_batch_host, pack_tables)
    from sitewhere_tpu_torch.pipeline.sharded import (
        build_sharded_packed_chain, build_sharded_packed_step,
        place_packed_batch, place_packed_tables)
    from sitewhere_tpu_torch.runtime.ring import RingRunner
    from sitewhere_tpu_torch.state.manager import DeviceStateManager

    t0 = time.perf_counter()
    tables = pack_tables(*make_world(device, CAPACITY, N_ACTIVE, N_RULES,
                                     FULL_Z, FULL_V, SEED + 1))
    rng = np.random.default_rng(SEED + 40)
    rings = [[pack_batch_host(sm_routed_cols(
        rng, FULL_B, N_ACTIVE, CAPACITY, 1_700_000_000 + r * RING_K + s,
        SM_SHARDS), FULL_B) for s in range(RING_K)]
        for r in range(1 + SM_RINGS)]

    def manager(m):
        return DeviceStateManager(CAPACITY, num_mtype_slots=M_SLOTS,
                                  num_ewma_scales=K_SCALES, device=device,
                                  mesh=m)

    setup_s = time.perf_counter() - t0
    n_steps = SM_RINGS * RING_K
    runs, outs, carries = {}, {}, {}
    last_ring = None
    for path in ("mesh_chain", "mesh_step", "unsharded_chain"):
        on_mesh = path != "unsharded_chain"
        mgr = manager(mesh if on_mesh else None)
        syncs = [0]
        seen = []
        if path == "mesh_step":
            step = build_sharded_packed_step(mesh)
            mtables = place_packed_tables(mesh, tables)

            def ring_views(ring):
                views = []
                for bi, bf in ring:
                    sbi, sbf = place_packed_batch(mesh, bi, bf)
                    epoch = mgr.current_packed
                    ps, oi, met, pres = step(mtables, epoch, sbi, sbf)
                    mgr.commit_packed(ps, present_now=pres,
                                      read_epoch=epoch)
                    views.append(PackedView(
                        oi, met, pres,
                        on_fetch=lambda: syncs.__setitem__(0, syncs[0] + 1)))
                return views
        else:
            runner = RingRunner(mgr, tables, RING_K,
                                mesh=mesh if on_mesh else None)
            ring_views = runner.dispatch
        for view in ring_views(rings[0]):          # warm-up ring
            seen.append((view.oi.copy(), view.metrics_vector.copy()))
        torch.cuda.synchronize()
        geo_cuda.reset_launch_counts()
        t1 = time.perf_counter()
        for ring in rings[1:]:
            if path == "mesh_chain":
                before_last = mgr.current_packed
            views = ring_views(ring)
            for view in views:
                seen.append((view.oi, view.metrics_vector))
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t1
        launches = geo_cuda.launch_counts["pip_parity"]
        if path == "mesh_chain":
            last_ring = (before_last, views, runner)
        processed = sum(int(m[0]) for _, m in seen[RING_K:])
        per_batch = (runner.host_syncs_per_batch if path != "mesh_step"
                     else syncs[0] / ((1 + SM_RINGS) * RING_K))
        shards = SM_SHARDS if on_mesh else 1
        runs[path] = {
            "elapsed_s": elapsed, "events_per_s": processed / elapsed,
            "ms_per_ring": elapsed / SM_RINGS * 1e3,
            "ms_per_step": elapsed / n_steps * 1e3,
            "host_syncs_per_batch": per_batch, "pip_launches": launches,
            "steps": n_steps, "shards": shards}
        check(launches == n_steps * shards,
              f"{path}: kernel launched {launches}x in {n_steps} steps of "
              f"{shards} shard(s)")
        outs[path] = seen
        cur = mgr.current_packed
        if on_mesh:
            check(cur.si.n_shards == SM_SHARDS,
                  f"{path}: carry on {cur.si.n_shards} shards")
            carries[path] = (cur.si.gather(), cur.sf.gather())
        else:
            carries[path] = (cur.si, cur.sf)
        del mgr
    check(runs["mesh_chain"]["host_syncs_per_batch"] == 1 / RING_K,
          f"mesh chain host syncs per batch "
          f"{runs['mesh_chain']['host_syncs_per_batch']}")
    ref = outs["unsharded_chain"]
    equal = {}
    for path in ("mesh_chain", "mesh_step"):
        same_out = all(np.array_equal(a[0], b[0])
                       and np.array_equal(a[1], b[1])
                       for a, b in zip(outs[path], ref))
        same_carry = (torch.equal(carries[path][0],
                                  carries["unsharded_chain"][0])
                      and torch.equal(carries[path][1],
                                      carries["unsharded_chain"][1]))
        equal[path] = {"outputs": same_out, "carry": same_carry}
        check(same_out and len(outs[path]) == len(ref),
              f"{path} outputs != the unsharded chain's")
        check(same_carry, f"{path} carry != the unsharded chain's")
    accepted = sum(int(m[1]) for _, m in ref[RING_K:])
    alerts = sum(int(m[4]) + int(m[5]) for _, m in ref[RING_K:])
    check(accepted > 0 and alerts > 0, "no row accepted or no alert fired")

    # the chain's last ring again, from its carry, with the plain geofence
    before_last, views, runner = last_ring
    launches = geo_cuda.launch_counts["pip_parity"]
    plain = build_sharded_packed_chain(mesh, RING_K, geofence=plain_chunked)
    staged = [place_packed_batch(mesh, bi, bf) for bi, bf in rings[-1]]
    ps, ois, mets, _ = plain(runner.tables, before_last,
                             *[s[0] for s in staged],
                             *[s[1] for s in staged])
    ois, mets = ois.gather().cpu().numpy(), mets.gather().cpu().numpy()
    same_out = all(np.array_equal(v.oi, ois[i])
                   and np.array_equal(v.metrics_vector, mets[i])
                   for i, v in enumerate(views))
    same_carry = (torch.equal(ps.si.gather(), carries["mesh_chain"][0])
                  and torch.equal(ps.sf.gather(), carries["mesh_chain"][1]))
    check(same_out and same_carry,
          "mesh chain plain-geofence rerun differs")
    check(geo_cuda.launch_counts["pip_parity"] == launches,
          "the plain rerun launched the kernel")
    emit({"phase": "sharded_mesh", "run": "mesh_chain",
          "shards": SM_SHARDS, "width": FULL_B,
          "shard_width": FULL_B // SM_SHARDS, "capacity": CAPACITY,
          "shard_rows": CAPACITY // SM_SHARDS, "ring_k": RING_K,
          "rings": SM_RINGS, "setup_s": setup_s, "paths": runs,
          "accepted": accepted, "alerts": alerts,
          "equal_to_unsharded_chain": equal,
          "plain_rerun": {"identical_outputs": same_out,
                          "identical_carry": same_carry},
          "max_memory_gib": torch.cuda.max_memory_allocated() / 2**30})
    return {"mesh_chain": runs["mesh_chain"]["pip_launches"],
            "mesh_step": runs["mesh_step"]["pip_launches"]}


def sm_fill_direct(device, geo_cuda, world, root):
    """Segment-ordered full-width fill-direct reservations into the
    sharded ``Instance`` at K=8 (as ``bench.py:979-995`` builds them):
    every plan adopted, nothing copied by the batcher, one host sync per
    ring, the kernel launched once per shard per step."""
    import torch

    data_dir = os.path.join(root, "fill")
    inst = instance_from_world(device, world, data_dir, CAPACITY, FULL_B,
                               RING_K, RING_DIAG_DEADLINE_MS,
                               n_shards=SM_SHARDS)
    try:
        inst.start()
        disp, store = inst.dispatcher, inst.event_store
        handles = np.asarray(inst.identity.device.lookup_many(
            [f"d-{i}" for i in range(N_ACTIVE)]), np.int32)
        rps, seg = CAPACITY // SM_SHARDS, FULL_B // SM_SHARDS
        by_shard = [handles[(handles // rps) == s] for s in range(SM_SHARDS)]
        rng = np.random.default_rng(SEED + 43)
        devs = [np.concatenate([rng.choice(by_shard[s], seg)
                                for s in range(SM_SHARDS)]).astype(np.int32)
                for _ in range(SM_RESERVATIONS)]
        vals = [rng.uniform(20, 40, FULL_B).astype(np.float32)
                for _ in range(SM_RESERVATIONS)]
        adopted = count_adopted(disp.batcher)
        copied = disp.metrics.counter("pipeline.bytes_copied.batch")
        torch.cuda.synchronize()
        snap0, copied0 = disp.metrics_snapshot(), int(copied.value)
        geo_cuda.reset_launch_counts()
        t0 = time.perf_counter()
        for r in range(SM_RESERVATIONS):
            res = disp.batcher.reserve(FULL_B)
            res.device_id[:FULL_B] = devs[r]
            res.mtype_id[:FULL_B] = 0
            res.value[:FULL_B] = vals[r]
            res.ts_s[:FULL_B] = 1_760_000_000 + r
            res.ts_ns[:FULL_B] = 0
            res.update_state[:FULL_B] = 1
            res.n = FULL_B
            disp.ingest_wire_decoded(b"", res, [], source_id="fill")
        disp.flush()
        store.flush()
        elapsed = time.perf_counter() - t0
        launches = geo_cuda.launch_counts["pip_parity"]
        snap = disp.metrics_snapshot()
        delta = {k: snap[k] - snap0[k] for k in (
            "steps", "processed", "accepted", "host_syncs", "ring_chains")}
        rec = {"phase": "sharded_mesh", "run": "mesh_instance.fill_direct",
               "reservations": SM_RESERVATIONS, "ring_k": RING_K,
               "elapsed_s": elapsed,
               "events_per_s": SM_RESERVATIONS * FULL_B / elapsed,
               "adopted": len(adopted),
               "bytes_copied_batch": int(copied.value) - copied0,
               "pip_launches": launches, "stored": store.total_events,
               **delta}
        rec.update(guard_counts(disp.metrics, "sharded_mesh"))
        emit(rec)
        check(len(adopted) == delta["steps"] == SM_RESERVATIONS,
              f"{len(adopted)} of {delta['steps']} plans adopted")
        check(rec["bytes_copied_batch"] == 0,
              f"the batcher copied {rec['bytes_copied_batch']} bytes")
        check(delta["host_syncs"] * RING_K == delta["steps"]
              and delta["ring_chains"] == SM_RESERVATIONS // RING_K,
              f"host syncs {delta['host_syncs']} for {delta['steps']} steps")
        check(launches == delta["steps"] * SM_SHARDS,
              f"kernel launched {launches}x in {delta['steps']} steps")
        check(delta["accepted"] == SM_RESERVATIONS * FULL_B
              == store.total_events,
              f"accepted {delta['accepted']}, stored {store.total_events}")
        inst.stop()
    finally:
        inst.terminate()
        shutil.rmtree(data_dir, ignore_errors=True)
    return launches


def sm_shard_containment(device, geo_cuda, root):
    """The port devfault bench's ``shard_containment`` phase at 8 shards
    on the card (a small world, ``SM_CONTAIN``): only shard 2 demotes,
    the healthy shards keep chaining, the poison rows dead-letter, every
    clean row is stored once; shard 2 at FALLBACK side-steps through the
    mesh, the process does not exit and no step runs on the CPU."""
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tools"))
    import torch_devfault_bench as bench

    failures = []

    def bench_check(ok, msg):
        if not ok and msg:
            failures.append(msg)

    geo_cuda.reset_launch_counts()
    t0 = time.perf_counter()
    rep = bench.phase_shard_containment(root, bench_check, device,
                                        **SM_CONTAIN)
    rep.pop("flightrec_dump", None)
    launches = geo_cuda.launch_counts["pip_parity"]
    emit({"phase": "sharded_mesh", "run": "shard_containment",
          **SM_CONTAIN, "seconds": time.perf_counter() - t0,
          "pip_launches": launches, **rep, "failures": failures})
    check(not failures, f"shard_containment: {failures}")
    check(rep["shard_levels"][2] >= 1 and all(
        lv == 0 for s, lv in enumerate(rep["shard_levels"]) if s != 2),
        f"shard levels {rep['shard_levels']}")
    check(rep["cpu_fallback_steps"] == 0, "a side step ran on the CPU")
    check(launches > 0 and launches % SM_SHARDS == 0,
          f"{launches} launches for {SM_SHARDS} shards")
    return launches


def sm_analytics(device, mesh):
    """``build_window_grid_sharded`` over the world's devices against the
    unsharded grid: counts exact, means and variances within the
    reference test's bounds (``tests/test_analytics.py:199-226``)."""
    import torch

    from sitewhere_tpu_torch.analytics.runner import (
        build_window_grid, build_window_grid_sharded)

    rng = np.random.default_rng(SEED + 44)
    dev = rng.integers(0, N_ACTIVE, SM_AN_EVENTS).astype(np.int32)
    win = rng.integers(0, SM_AN_WINDOWS, SM_AN_EVENTS).astype(np.int32)
    val = rng.normal(10.0, 2.0, SM_AN_EVENTS).astype(np.float32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sharded = build_window_grid_sharded(mesh, dev, win, val, N_ACTIVE,
                                        SM_AN_WINDOWS)
    torch.cuda.synchronize()
    sharded_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = build_window_grid(
        torch.from_numpy(dev).to(device), torch.from_numpy(win).to(device),
        torch.from_numpy(val).to(device),
        torch.ones(SM_AN_EVENTS, dtype=torch.bool, device=device),
        N_ACTIVE, SM_AN_WINDOWS)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    counts = torch.equal(sharded.counts.gather(), ref.counts)
    means = float((sharded.means.gather() - ref.means).abs().max())
    var = float((sharded.variances.gather() - ref.variances).abs().max())
    emit({"phase": "sharded_mesh", "run": "sharded_analytics",
          "devices": N_ACTIVE, "windows": SM_AN_WINDOWS,
          "events": SM_AN_EVENTS, "shards": sharded.counts.n_shards,
          "counts_equal": counts, "means_max_abs_diff": means,
          "variances_max_abs_diff": var, "sharded_s": sharded_s,
          "unsharded_s": plain_s})
    check(counts, "sharded grid counts differ")
    check(means <= 1e-4 and var <= 1e-3,
          f"sharded grid means off {means}, variances off {var}")


def phase_sharded_mesh(device, geo_cuda, world, kernel_rec):
    """The sharded pipeline at 8 shards on the one card: the kernel at
    the per-shard shape, mesh_chain, mesh_instance (the wire run with
    checkpoint_full, the fill-direct ring), shard_containment and the
    sharded analytics grid.  Returns the kernel's launches by run."""
    from sitewhere_tpu_torch.parallel import make_mesh

    t0 = time.perf_counter()
    mesh = make_mesh(devices=[device] * SM_SHARDS)
    sm_kernel_per_shard(device, geo_cuda, kernel_rec)
    launches = sm_mesh_chain(device, geo_cuda, mesh)
    root = tempfile.mkdtemp(prefix="mesh-", dir=geo_cuda.BUILD_DIR)
    try:
        rng = np.random.default_rng(SEED + 41)
        payloads = wire_payloads(rng, SM_WIRE_PAYLOADS, FULL_B,
                                 WIRE_TS0_MS + 30_000_000)
        rec = persist_throughput(device, geo_cuda, world, payloads, root,
                                 "mesh_wire", phase="sharded_mesh",
                                 name="mesh_instance.wire",
                                 n_shards=SM_SHARDS)
        launches["mesh_instance.wire"] = rec["pip_launches"]
        launches["mesh_instance.fill_direct"] = sm_fill_direct(
            device, geo_cuda, world, root)
        launches["shard_containment"] = sm_shard_containment(
            device, geo_cuda, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    sm_analytics(device, mesh)
    emit({"phase": "sharded_mesh", "run": "done",
          "seconds": time.perf_counter() - t0, "launches": launches})
    return launches


def phase_small_reference(device):
    """A small deployment stepped on the card (kernel) and on the CPU
    (plain versions): int outputs and metrics identical, EWMAs close."""
    import torch

    from sitewhere_tpu_torch.pipeline.packed import (
        pack_batch_host, pack_state, pack_tables, packed_pipeline_step)
    from sitewhere_tpu_torch.schema import DeviceState

    cap, active, width = 8192, 6000, 4096
    world = make_world(device, cap, active, N_RULES, 40, FULL_V, SEED + 3)
    devices = (device, torch.device("cpu"))   # card first, CPU second
    tables = [pack_tables(*(t.to(d) for t in world)) for d in devices]
    carry = [pack_state(DeviceState.empty(cap, M_SLOTS, K_SCALES, device=d))
             for d in devices]
    rng = np.random.default_rng(SEED + 4)
    n_exact = 3 + M_SLOTS
    worst = 0.0
    for step in range(3):
        bi, bf = pack_batch_host(make_batch_cols(
            rng, width, active, cap, 1_700_000_000 + step), width)
        outs = []
        for i, d in enumerate(devices):
            carry[i], oi, met, _ = packed_pipeline_step(
                tables[i], carry[i], torch.from_numpy(bi).to(d),
                torch.from_numpy(bf).to(d))
            outs.append((oi.cpu(), met.cpu()))
        (g_oi, g_met), (c_oi, c_met) = outs
        check(torch.equal(g_oi, c_oi), f"small step {step}: outputs differ")
        check(torch.equal(g_met, c_met), f"small step {step}: metrics differ")
        g, c = carry
        check(torch.equal(g.si.cpu(), c.si), f"small step {step}: int carry")
        check(torch.equal(g.sf[:n_exact].cpu(), c.sf[:n_exact]),
              f"small step {step}: float carry")
        err = (g.sf[n_exact:].cpu().double() - c.sf[n_exact:].double()).abs()
        scale = torch.maximum(c.sf[n_exact:].abs(), torch.tensor(128.0))
        worst = max(worst, float((err / (scale * 2.0 ** -23)).max()))
    check(worst <= 4.0, f"small-step EWMA off by {worst} ULP of scale")
    emit({"phase": "small_reference", "capacity": cap, "width": width,
          "steps": 3, "ewma_max_ulp_of_scale": worst})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is present", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from sitewhere_tpu_torch.device import resolve_device
    from sitewhere_tpu_torch.ops import geo_cuda

    t_start = time.perf_counter()
    device = resolve_device()
    geo_cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    logs = LogTally(os.path.join(geo_cuda.BUILD_DIR,
                                 f"chip-smoke-{os.getpid()}.log"))
    smi = nvidia_smi_line()
    emit({"phase": "card", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    from sitewhere_tpu_torch import native

    t0 = time.perf_counter()
    # the kernel (nvcc) and the wire scanners (cc), built side by side
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        builds = [pool.submit(geo_cuda.library), pool.submit(
            native.load_swwire)]
        for b in builds:
            b.result()
    ptxas = [ln.strip() for ln in geo_cuda.build_log.get("pip_kernel", "")
             .splitlines() if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": ptxas, "native_library": str(native.library_path),
          "native_build_s": native.build_seconds})

    rec = phase_kernel(device, geo_cuda)
    main_launches = phase_main_path(device, geo_cuda)
    wire_launches, mixed, meas = phase_dispatcher_wire(device, geo_cuda)
    persist_launches = phase_persist_recover(
        device, geo_cuda, mixed[:INSTANCE_WIRE_PAYLOADS],
        meas[:INSTANCE_WIRE_PAYLOADS])
    del meas
    rules_launches = phase_byo_rules(device, geo_cuda,
                                     mixed[:INSTANCE_WIRE_PAYLOADS])
    an_launches = phase_streaming_analytics(device, geo_cuda)
    # one world checkpoint of the deployment (one tenant) serves
    # device_services, ingest_sources and outbound_presence
    world_root = tempfile.mkdtemp(prefix="world-", dir=geo_cuda.BUILD_DIR)
    try:
        t0 = time.perf_counter()
        world = world_checkpoint(device, world_root, "full")
        emit({"phase": "world", "seconds": time.perf_counter() - t0})
        ds_launches = phase_device_services(device, geo_cuda, mixed, logs,
                                            world)
        del mixed
        is_launches = phase_ingest_sources(device, geo_cuda, world)
        op_launches = phase_outbound_presence(device, geo_cuda, world)
        gw_launches = phase_rest_gateway(device, geo_cuda, world, rec)
        sm_launches = phase_sharded_mesh(device, geo_cuda, world, rec)
        te_launches = phase_tenant_engines(device, geo_cuda)
    finally:
        shutil.rmtree(world_root, ignore_errors=True)
    cp_launches = phase_control_plane(device, geo_cuda)
    # this slice's path: the sharded pipeline's runs, each step one
    # launch per shard at the shard's width
    rec["launches"] = sum(sm_launches.values())
    rec["launches_by_path"] = {"main_path": main_launches,
                               **{f"sharded_mesh.{k}": v
                                  for k, v in sm_launches.items()},
                               **{f"rest_gateway.{k}": v
                                  for k, v in gw_launches.items()},
                               **{f"tenant_engines.{k}": v
                                  for k, v in te_launches.items()},
                               **{f"outbound_presence.{k}": v
                                  for k, v in op_launches.items()},
                               **{f"ingest_sources.{k}": v
                                  for k, v in is_launches.items()},
                               **{f"control_plane.{k}": v
                                  for k, v in cp_launches.items()},
                               **{f"dispatcher_wire.{k}": v
                                  for k, v in wire_launches.items()},
                               **{f"persist_recover.{k}": v
                                  for k, v in persist_launches.items()},
                               **{f"byo_rules.{k}": v
                                  for k, v in rules_launches.items()},
                               **{f"streaming_analytics.{k}": v
                                  for k, v in an_launches.items()},
                               **{f"device_services.{k}": v
                                  for k, v in ds_launches.items()}}
    phase_small_reference(device)
    emit({"phase": "guards", "by_phase": GUARDS})
    for phase, g in GUARDS.items():
        check(g["cpu_fallback_steps"] == 0,
              f"{phase}: {g['cpu_fallback_steps']} steps on the CPU")

    logs.close()
    emit({"phase": "done", "seconds": time.perf_counter() - t_start,
          "log_records": {f"{n}:{lv}" + (":traceback" if tb else ""):
                          {"count": c, "first": logs.first[(n, lv, tb)]}
                          for (n, lv, tb), c in sorted(logs.counts.items())},
          "log_bytes": logs.bytes})
    emit({"kernels": [rec]})
    print(nvidia_smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def child_main(spec_json: str) -> int:
    """``--kill-child``: one instance life of the kill_recover runs, or of
    the control_plane's sticky runs."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    spec = json.loads(spec_json)
    if spec["role"].startswith("sticky"):
        sticky_child(spec)
    else:
        kill_child(spec)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--kill-child"]:
        sys.exit(child_main(sys.argv[2]))
    sys.exit(main())
