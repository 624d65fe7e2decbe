"""Checkpoint/resume: durable snapshots of the instance's state.

Counterpart of ``sitewhere_tpu/runtime/checkpoint.py``.  The registry,
rules and identity live in host dicts and numpy rows and the device
state lives on the card, so durability is explicit:

- a :class:`Checkpointer` snapshots the management stores (device
  management, assets, users, tenants, schedules and jobs, batch
  operations and the rule manager, plus each non-default tenant engine's
  device-management and asset façades), the registry-mirror columns, the
  ``DeviceState`` tensors, the identity map and every registered
  per-component :class:`StateProvider` (the segment catalog) into
  ``data_dir/checkpoint/`` on an interval and at shutdown;
- stream position is the ingest ``JournalReader``'s committed offset
  (commit-after-seal, owned by the dispatcher);
- restart = restore the newest complete snapshot, then replay journal
  records past each component's as-of offset (at-least-once).

Every section records the journal offset it is consistent as-of (the
committed offset captured at save start, unless a provider reports its
own); restore replays from the minimum of them (``replay_floor``).

The device state is copied off the card outside the manager's lock:
the epoch reference is taken under the lock, its two packed carry
buffers are copied once into pinned host memory on the stream of the
commit that produced them, waited for with one CUDA event (no
device-wide synchronize), and split into the reference's field names on
the host.  Restore uploads each field with ``torch.from_numpy(arr).to
(device)`` and commits it, which drops the manager's cached packed
carry.

Atomicity and torn-snapshot tolerance as in the reference: every file is
written tmp -> fsync -> ``os.replace``; sections are CRC-framed,
versioned records (:func:`write_framed`); ``MANIFEST.json`` is replaced
last (after the per-generation ``manifest-<gen>.json`` anchor), so a
crash mid-save or a torn section falls back to the previous complete
generation, and a section whose version is not supported is skipped
with a log line.  Section order: stores, mirror, state, identity LAST,
providers, then the manifest swap (``crash.mid_checkpoint`` after the
stores, ``crash.pre_manifest`` before the swap).

The ``stores`` section pickles its records under the reference's names
(:mod:`~sitewhere_tpu_torch.runtime.refpickle`, over
:data:`STORE_CLASSES`), so a section either package wrote restores into
the other, and the port's restore imports nothing of the reference.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import glob
import json
import logging
import os
import struct
import threading
import time
import zlib
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from sitewhere_tpu_torch.pipeline.rules import ThresholdRule
from sitewhere_tpu_torch.runtime import faults, refpickle
from sitewhere_tpu_torch.runtime.lifecycle import LifecycleComponent
from sitewhere_tpu_torch.schema import AlertLevel, ComparisonOp, RuleKind
from sitewhere_tpu_torch.security import users as _users
from sitewhere_tpu_torch.services import assets as _assets
from sitewhere_tpu_torch.services import batch_ops as _batch
from sitewhere_tpu_torch.services import device_management as _dm
from sitewhere_tpu_torch.services import schedules as _schedules
from sitewhere_tpu_torch.services import tenants as _tenants

logger = logging.getLogger("sitewhere_tpu_torch.checkpoint")

# Host-dict state per Instance attribute: (attr name on Instance, attrs to
# snapshot).  Entities are plain dataclasses — pickled by value.  The
# reference's table.
_STORE_ATTRS = {
    "device_management": (
        "device_types", "devices", "assignments", "area_types", "areas",
        "customer_types", "customers", "zones", "device_groups", "alarms",
    ),
    "users": ("_users", "_authorities"),
    "tenants": ("_tenants", "_templates", "_datasets"),
    "assets": ("_types", "_assets"),
    "schedules": ("schedules", "jobs", "_fires"),
    "batch_ops": ("operations",),
    "rules": ("_rules", "_slots", "_free"),
}

#: every port class the stores section pickles, each naming the
#: reference's in ``_PICKLE_AS``
STORE_CLASSES = (
    ThresholdRule, AlertLevel, ComparisonOp, RuleKind,
    _dm.DeviceCommand, _dm.DeviceStatus, _dm.DeviceType, _dm.Device,
    _dm.DeviceAssignment, _dm.AreaType, _dm.Area, _dm.CustomerType,
    _dm.Customer, _dm.Zone, _dm.DeviceGroupElement, _dm.DeviceGroup,
    _dm.DeviceAlarm, _assets.AssetType, _assets.Asset,
    _users.GrantedAuthority, _users.User,
    _tenants.Tenant, _tenants.TenantTemplate, _tenants.DatasetTemplate,
    _schedules.Schedule, _schedules.ScheduledJob,
    _batch.BatchOperation, _batch.BatchElement,
)
_STORE_NAMES = refpickle.reference_names(STORE_CLASSES)

_MIRROR_ARRAYS = (
    "active", "tenant_id", "device_type_id", "assignment_id",
    "assignment_status", "area_id", "customer_id", "asset_id",
    "z_active", "z_tenant", "z_area", "z_verts", "z_nvert",
    "z_condition", "z_alert_code", "z_alert_level",
)

# framed snapshot-section format (see write_framed)
SNAP_MAGIC = b"SWSNAP1\n"
_FRAME = struct.Struct("<II")  # (length, crc32) — the journal's framing
MANIFEST_VERSION = 2
STORES_VERSION = 1
_SUPPORTED_STORES_VERSIONS = {1}
# section names owned by the checkpointer itself — providers may not
# register under them
_RESERVED_SECTIONS = frozenset({"stores", "mirror", "state", "identity"})


class SnapshotCorrupt(Exception):
    """A snapshot section failed its CRC/framing/decode check — the
    generation is torn; restore falls back to the previous one."""


def _remote(obj) -> bool:
    """True for a RemoteDomain facade (``rpc/domains.py``): its domain
    lives on, and is checkpointed by, the owning host."""
    return bool(getattr(obj, "_remote_facade_", False))


def _copy_val(v):
    """Deep-copy store containers under the owning lock: entities are
    mutated IN PLACE (``update_fields``) and carry mutable sub-containers
    (metadata, authority lists), so the later pickle — running after the
    lock is released — must walk a private copy, never live objects."""
    if isinstance(v, (dict, list)):
        return copy.deepcopy(v)
    return v


def merge_store(obj, values: Dict[str, object]) -> None:
    """Restore snapshotted attributes into a live store IN PLACE where
    possible (dict containers are cleared+updated so components holding
    references keep seeing the store)."""
    for k, v in values.items():
        current = getattr(obj, k)
        if isinstance(current, dict) and isinstance(v, dict):
            current.clear()
            current.update(v)
        else:
            setattr(obj, k, v)


def _atomic_write(path: str, write_fn) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        write_fn(f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def write_framed(path: str, header: Dict[str, object],
                 payload: bytes) -> None:
    """Write one CRC-framed, versioned snapshot section: magic, then a
    JSON header record and the payload record, each ``[len][crc32]``
    prefixed (the journal's record framing) — a torn or corrupted write
    is detectable at restore instead of surfacing as an unpickling crash
    mid-boot.  tmp → fsync → replace, like every snapshot file."""
    head = json.dumps(header, separators=(",", ":")).encode()

    def _write(f):
        f.write(SNAP_MAGIC)
        for blob in (head, payload):
            f.write(_FRAME.pack(len(blob), zlib.crc32(blob)))
            f.write(blob)

    _atomic_write(path, _write)


def read_framed(path: str,
                component: Optional[str] = None
                ) -> Tuple[Dict[str, object], bytes]:
    """Read + verify one framed section; raises :class:`SnapshotCorrupt`
    on any framing/CRC/decode violation (never a decoder-specific
    exception — the restore fallback catches ONE type)."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError as e:
        raise SnapshotCorrupt(f"{path}: {e}") from e
    if not data.startswith(SNAP_MAGIC):
        raise SnapshotCorrupt(f"{path}: bad magic")
    pos = len(SNAP_MAGIC)
    blobs: List[bytes] = []
    for _ in range(2):
        if pos + _FRAME.size > len(data):
            raise SnapshotCorrupt(f"{path}: truncated frame header")
        length, crc = _FRAME.unpack_from(data, pos)
        pos += _FRAME.size
        blob = data[pos:pos + length]
        pos += length
        if len(blob) < length:
            raise SnapshotCorrupt(f"{path}: truncated payload")
        if zlib.crc32(blob) != crc:
            raise SnapshotCorrupt(f"{path}: CRC mismatch")
        blobs.append(blob)
    try:
        header = json.loads(blobs[0])
    except ValueError as e:
        raise SnapshotCorrupt(f"{path}: unreadable header") from e
    if component is not None and header.get("component") != component:
        raise SnapshotCorrupt(
            f"{path}: component tag {header.get('component')!r} != "
            f"{component!r}")
    return header, blobs[1]


@dataclasses.dataclass
class StateProvider:
    """One pluggable snapshot section (analytics state, dedup tables…).

    ``snapshot_fn() -> (payload_bytes, extra_header)`` — ``extra_header``
    may carry ``as_of`` (the journal offset the payload is consistent
    as-of; None/absent = the checkpointer's conservative committed
    offset).  ``restore_fn(header, payload)`` re-hydrates the component;
    it runs only after the payload passed CRC and version checks."""

    name: str
    snapshot_fn: Callable[[], Tuple[bytes, Optional[Dict[str, object]]]]
    restore_fn: Callable[[Dict[str, object], bytes], None]
    version: int = 1
    supported_versions: Optional[frozenset] = None

    def accepts(self, version) -> bool:
        if self.supported_versions is not None:
            return version in self.supported_versions
        return version == self.version


class Checkpointer(LifecycleComponent):
    """Periodic + shutdown snapshots of one instance's state.

    ``last_save_stats`` holds the newest save's seconds and bytes per
    section (``state_d2h_s``: the device-state copy off the card alone)."""

    def __init__(self, instance, interval_s: float = 30.0,
                 prune_journal: bool = False):
        super().__init__(name="checkpointer")
        self.instance = instance
        self.interval_s = float(interval_s)
        self.prune_journal = bool(prune_journal)
        self.dir = os.path.join(instance.data_dir, "checkpoint")
        os.makedirs(self.dir, exist_ok=True)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._save_lock = threading.Lock()
        self._providers: Dict[str, StateProvider] = {}
        self.last_saved_at: Optional[float] = None
        self.last_save_stats: Dict[str, float] = {}
        # crash-recovery surface (filled by restore()):
        self.restored_generation: Optional[int] = None
        self.restored_offsets: Dict[str, int] = {}
        #: minimum restored as-of offset — Instance.start replays the
        #: journal from here so every component re-derives what its
        #: snapshot is missing (None = no offsets restored: replay from
        #: the committed offset)
        self.replay_floor: Optional[int] = None
        self.restore_s: float = 0.0
        #: the restore's seconds by step: ``load_s`` (read and validate
        #: every section), then each section's apply (``state_s``: the
        #: upload to the card and the commit)
        self.restore_stats: Dict[str, float] = {}
        candidates = self._manifest_candidates()
        self.generation = candidates[0][0] if candidates else -1

    def register_provider(self, provider: StateProvider) -> None:
        """Register a per-component snapshot section.  Must happen before
        :meth:`restore` (the instance wires providers, then restores)."""
        if provider.name in _RESERVED_SECTIONS:
            raise ValueError(f"section name {provider.name!r} is reserved")
        self._providers[provider.name] = provider

    # -- manifest -----------------------------------------------------------

    @property
    def _manifest_path(self) -> str:
        return os.path.join(self.dir, "MANIFEST.json")

    def _manifest(self) -> dict:
        try:
            with open(self._manifest_path) as f:
                return json.load(f)
        except (FileNotFoundError, ValueError):
            return {}

    def _manifest_candidates(self) -> List[Tuple[int, dict]]:
        """Usable manifests, newest generation first: the MANIFEST swap
        target plus the per-generation anchors retained for torn-snapshot
        fallback.  A manifest that doesn't parse is simply not a
        candidate."""
        seen: Dict[int, dict] = {}
        current = self._manifest()
        if isinstance(current.get("generation"), int):
            seen[current["generation"]] = current
        for path in glob.glob(os.path.join(self.dir, "manifest-*.json")):
            try:
                with open(path) as f:
                    doc = json.load(f)
            except (OSError, ValueError):
                continue
            gen = doc.get("generation")
            if isinstance(gen, int):
                seen.setdefault(gen, doc)
        return sorted(seen.items(), key=lambda kv: -kv[0])

    # -- save ---------------------------------------------------------------

    def save(self) -> Optional[str]:
        """Write one snapshot generation; returns the manifest path."""
        with self._save_lock:
            inst = self.instance
            stats: Dict[str, float] = {}
            t_save = time.perf_counter()
            # As-of capture FIRST: the committed offset is read before any
            # component snapshot, so a claimed offset never leads the data
            # (commits only grow, and every effect below the captured value
            # has landed in the components read after it).
            reader = getattr(getattr(inst, "dispatcher", None),
                             "journal_reader", None)
            committed = int(reader.committed) if reader is not None else 0
            journal = getattr(inst, "ingest_journal", None)
            journal_end = int(journal.end_offset) if journal is not None \
                else 0
            gen = self.generation + 1
            names: Dict[str, str] = {}
            offsets: Dict[str, int] = {}

            def timed_write(section: str, write) -> None:
                t0 = time.perf_counter()
                write(os.path.join(self.dir, names[section]))
                stats[f"{section}_s"] = time.perf_counter() - t0
                stats[f"{section}_bytes"] = os.path.getsize(
                    os.path.join(self.dir, names[section]))

            # 1. management stores — containers are COPIED under each
            # store's lock so the pickle below (lock released) can't race
            # a concurrent mutation
            def snap_store(obj, keys) -> Dict[str, object]:
                lock = getattr(obj, "_lock", None)
                with lock if lock is not None else contextlib.nullcontext():
                    return {k: _copy_val(getattr(obj, k)) for k in keys}

            # A gateway instance serves some domains through RemoteDomain
            # facades (rpc/domains.py): the owner checkpoints those
            # stores; a facade holds nothing to snapshot.
            stores: Dict[str, Dict[str, object]] = {
                attr: snap_store(getattr(inst, attr), keys)
                for attr, keys in _STORE_ATTRS.items()
                if getattr(inst, attr, None) is not None
                and not _remote(getattr(inst, attr))
            }
            # the non-default tenant engines' façades (the default
            # engine's are the instance's own, above)
            engines = getattr(inst, "engines", None)
            if engines is not None:
                stores["__engines__"] = {
                    eng.tenant.token: {
                        "device_management": snap_store(
                            eng.device_management,
                            _STORE_ATTRS["device_management"]),
                        "assets": snap_store(
                            eng.asset_management, _STORE_ATTRS["assets"]),
                    }
                    for eng in engines.list_engines()
                    if eng.tenant.token != "default"
                }
            names["stores"] = f"stores-{gen:08d}.swsnap"
            t0 = time.perf_counter()
            blob = refpickle.dumps(stores, _STORE_NAMES)
            stats["stores_pickle_s"] = time.perf_counter() - t0
            timed_write("stores", lambda path: write_framed(
                path, {"component": "stores", "version": STORES_VERSION,
                       "as_of": committed}, blob))
            offsets["stores"] = committed
            # chaos kill point: a death here leaves gen's stores file on
            # disk with no manifest — the previous generation must restore
            faults.crosspoint("crash.mid_checkpoint")

            # 2. registry mirror columns (+ zone tables + epoch)
            mirror = inst.mirror
            with mirror._lock:
                mirror_arrays = {
                    k: np.array(getattr(mirror, k)) for k in _MIRROR_ARRAYS
                }
                mirror_arrays["epoch"] = np.asarray(mirror.epoch)
                # z_hi drives the published ZoneTable's pow2 trim — a
                # restore without it would trim restored zones away
                mirror_arrays["z_hi"] = np.asarray(mirror.z_hi)
            names["mirror"] = f"mirror-{gen:08d}.npz"
            timed_write("mirror", lambda path: _atomic_write(
                path, lambda f: np.savez(f, **mirror_arrays)))
            offsets["mirror"] = committed

            # 3. device-state tensors: the epoch copied off the card (two
            # packed buffers through pinned memory), split on the host; a
            # remoted device_state belongs to the owner's checkpoints
            if not _remote(inst.device_state):
                t0 = time.perf_counter()
                state_arrays = inst.device_state.snapshot_host()
                stats["state_d2h_s"] = time.perf_counter() - t0
                names["state"] = f"state-{gen:08d}.npz"
                timed_write("state", lambda path: _atomic_write(
                    path, lambda f: np.savez(f, **state_arrays)))
                offsets["state"] = committed

            # 4. identity map LAST (see module docstring: a token minted
            # mid-save must never be dangling in the restored identity)
            names["identity"] = f"identity-{gen:08d}.json"
            timed_write("identity", inst.identity.save)

            # 5. registered component providers — a provider crash skips
            # ITS section, never the snapshot: the component then
            # re-derives from the journal like one that never snapshotted
            for provider in self._providers.values():
                try:
                    payload, extra = provider.snapshot_fn()
                except Exception:
                    logger.exception("state provider %s snapshot failed; "
                                     "section skipped", provider.name)
                    continue
                header = {"component": provider.name,
                          "version": provider.version}
                header.update(extra or {})
                as_of = header.get("as_of")
                header["as_of"] = committed if as_of is None else int(as_of)
                names[provider.name] = f"{provider.name}-{gen:08d}.swsnap"
                timed_write(provider.name, lambda path: write_framed(
                    path, header, payload))
                offsets[provider.name] = int(header["as_of"])

            # 6. manifest: the per-generation anchor first (it is what
            # torn-snapshot fallback finds when a LATER save dies before
            # its swap), then the MANIFEST swap commits the generation
            manifest = {"generation": gen, "files": names,
                        "saved_at": time.time(),
                        "version": MANIFEST_VERSION,
                        "offsets": offsets,
                        "committed": committed,
                        "journal_end": journal_end}
            blob = json.dumps(manifest).encode()
            t0 = time.perf_counter()
            _atomic_write(
                os.path.join(self.dir, f"manifest-{gen:08d}.json"),
                lambda f: f.write(blob))
            # chaos kill point: gen is fully on disk but not committed —
            # restore must come up on the previous manifest
            faults.crosspoint("crash.pre_manifest")
            _atomic_write(self._manifest_path, lambda f: f.write(blob))
            stats["manifest_s"] = time.perf_counter() - t0
            self.generation = gen
            self.last_saved_at = time.time()
            # keep gen-1 too: torn-generation fallback needs ONE previous
            # complete file set on disk (gc'd once gen+1 commits)
            self._gc(keep=gen - 1)
            # 7. journal retention (opt-in): everything below the
            # pipeline's durably committed offset is re-derivable from
            # this snapshot + the event store
            if self.prune_journal and reader is not None:
                pruned = inst.ingest_journal.prune(reader.committed)
                if pruned:
                    logger.info(
                        "pruned %d ingest-journal segment(s) below "
                        "committed offset %d", pruned, reader.committed)
            # 8. dead-letter retention: keep the newest N records; 0
            # disables
            keep = int(inst.config.get("dead_letters.retain_records",
                                       10_000) or 0)
            if keep > 0:
                cut = inst.dead_letters.end_offset - keep
                if cut > 0 and inst.dead_letters.prune(cut):
                    logger.info("pruned dead-letter segments below %d", cut)
            stats["total_s"] = time.perf_counter() - t_save
            self.last_save_stats = stats
            logger.info("checkpoint generation %d saved (committed=%d)",
                        gen, committed)
            return self._manifest_path

    def _gc(self, keep: int) -> None:
        for path in glob.glob(os.path.join(self.dir, "*-*.npz")) + \
                glob.glob(os.path.join(self.dir, "*-*.swsnap")) + \
                glob.glob(os.path.join(self.dir, "*-*.json")):
            base = os.path.basename(path)
            try:
                gen = int(base.rsplit("-", 1)[1].split(".")[0])
            except (IndexError, ValueError):
                continue
            if gen < keep:
                with contextlib.suppress(OSError):
                    os.remove(path)

    # -- restore ------------------------------------------------------------

    def restore(self) -> bool:
        """Restore the newest COMPLETE snapshot into the live components.

        Called from ``Instance.__init__`` after provider registration,
        before start.  Generations are tried newest-first: every section
        is read and validated (CRC frames, schema versions, parseable
        payloads) BEFORE anything is applied, so a torn generation falls
        back to the previous complete one without leaving components
        half-hydrated.  Returns True if a snapshot was restored; False —
        never an exception — when no usable generation exists (fresh
        boot)."""
        t0 = time.perf_counter()
        for gen, manifest in self._manifest_candidates():
            names = manifest.get("files")
            if not names:
                continue
            t_load = time.perf_counter()
            try:
                sections = self._load_generation(manifest)
            except Exception as e:  # noqa: BLE001 — one torn file must
                # not take boot down; fall back to the older generation
                logger.warning(
                    "checkpoint generation %s unusable (%s: %s); trying "
                    "the previous generation", gen,
                    type(e).__name__, e)
                continue
            self.restored_offsets = {
                k: int(v)
                for k, v in (manifest.get("offsets") or {}).items()
                if k in sections
            }
            self.restore_stats = {"load_s": time.perf_counter() - t_load}
            self._apply_generation(manifest, sections)
            self.restored_generation = int(gen)
            if self.restored_offsets:
                self.replay_floor = min(self.restored_offsets.values())
            self.restore_s = time.perf_counter() - t0
            metrics = getattr(self.instance, "metrics", None)
            if metrics is not None:
                metrics.gauge("recovery.restore_s").set(self.restore_s)
            logger.info(
                "restored checkpoint generation %s in %.3fs "
                "(replay floor %s; %d devices)",
                gen, self.restore_s, self.replay_floor,
                len(self.instance.identity.device))
            return True
        return False

    def _load_generation(self, manifest: dict) -> Dict[str, object]:
        """Read + validate every section of one generation into host
        memory WITHOUT touching live components.  Raises on corruption
        (the caller falls back); version-unsupported sections are logged
        and omitted from the result."""
        names = manifest["files"]
        sections: Dict[str, object] = {}

        # identity: parse up front so a torn file fails the generation
        # here, not inside load_into after other sections applied
        with open(os.path.join(self.dir, names["identity"])) as f:
            json.load(f)

        # management stores
        stores_path = os.path.join(self.dir, names["stores"])
        header, payload = read_framed(stores_path, component="stores")
        if header.get("version") not in _SUPPORTED_STORES_VERSIONS:
            logger.warning(
                "stores section version %s unsupported; skipping "
                "store restore", header.get("version"))
        else:
            sections["stores"] = self._unpickle(payload, stores_path)

        # registry mirror / device state: npz (zip CRC verifies members)
        try:
            with np.load(os.path.join(self.dir, names["mirror"])) as z:
                sections["mirror"] = {k: np.array(z[k]) for k in z.files}
            missing = (set(_MIRROR_ARRAYS) | {"epoch", "z_hi"}) \
                - set(sections["mirror"])
            if missing:
                raise SnapshotCorrupt(f"mirror section lacks {sorted(missing)}")
            if "state" in names:
                with np.load(os.path.join(self.dir, names["state"])) as z:
                    sections["state"] = {k: np.array(z[k])
                                         for k in z.files}
        except Exception as e:
            raise SnapshotCorrupt(f"tensor section unreadable: {e}") from e

        # provider sections
        for name, fname in names.items():
            if name in _RESERVED_SECTIONS:
                continue
            provider = self._providers.get(name)
            if provider is None:
                logger.warning("snapshot section %s has no registered "
                               "provider; ignored", name)
                continue
            header, payload = read_framed(
                os.path.join(self.dir, fname), component=name)
            if not provider.accepts(header.get("version")):
                logger.warning(
                    "snapshot section %s version %s unsupported "
                    "(provider speaks %s); section skipped — state "
                    "re-derives from the journal", name,
                    header.get("version"), provider.version)
                continue
            sections[name] = (provider, header, payload)
        return sections

    @staticmethod
    def _unpickle(payload: bytes, path: str):
        try:
            return refpickle.loads(payload, _STORE_NAMES)
        except Exception as e:  # noqa: BLE001 — unpickling raises anything
            raise SnapshotCorrupt(f"{path}: unpicklable ({e})") from e

    def _apply_generation(self, manifest: dict,
                          sections: Dict[str, object]) -> None:
        """Hydrate live components from pre-validated sections."""
        inst = self.instance
        names = manifest["files"]
        stats = self.restore_stats
        t0 = time.perf_counter()

        def lap(section: str) -> None:
            nonlocal t0
            now = time.perf_counter()
            stats[f"{section}_s"] = now - t0
            t0 = now

        # identity — strictly in place: the batcher captured bound
        # lookup/mint methods of the existing HandleSpace objects
        inst.identity.load_into(os.path.join(self.dir, names["identity"]))
        lap("identity")

        # management stores; restored rules rebuild their device table.
        # The tenant engines' façades wait in ``_engine_snapshots`` for
        # the engine factory, which hydrates each engine as it is built.
        stores = sections.get("stores")
        if stores is not None:
            inst._engine_snapshots = stores.pop("__engines__", {})
            for attr, values in stores.items():
                obj = getattr(inst, attr, None)
                if obj is None:
                    logger.info("checkpoint store %s has no component in "
                                "this instance; skipped", attr)
                    continue
                if _remote(obj):
                    continue  # domain remoted since the snapshot
                merge_store(obj, values)
            if hasattr(inst.rules, "_dirty"):
                inst.rules._dirty = True
            dm = getattr(inst, "device_management", None)
            if dm is not None:
                dm.reindex()
        lap("stores")

        # registry mirror: columns, epoch and z_hi; both dirty flags set
        # so the next publish_registry / publish_zones re-uploads
        z = sections["mirror"]
        with inst.mirror._lock:
            for k in _MIRROR_ARRAYS:
                getattr(inst.mirror, k)[:] = z[k]
            inst.mirror.epoch = int(z["epoch"])
            inst.mirror.z_hi = int(z["z_hi"])
            inst.mirror._dirty = True
            inst.mirror._zones_dirty = True
        lap("mirror")

        # device state — tolerant of fields added since the snapshot was
        # taken AND of shape changes (e.g. a different EWMA scale count):
        # mismatched fields keep their empty init rather than crashing
        # every subsequent step
        z = sections.get("state")
        if z is not None and not _remote(inst.device_state):
            manager = inst.device_state
            current = manager.current
            known = {
                fld.name: tuple(getattr(current, fld.name).shape)
                for fld in dataclasses.fields(current)
            }
            updates = {}
            skipped = set()
            for k, arr in z.items():
                if k not in known:
                    continue
                if arr.shape != known[k]:
                    logger.warning(
                        "checkpoint field %s shape %s != current %s; "
                        "keeping empty init", k, arr.shape, known[k])
                    skipped.add(k)
                    continue
                updates[k] = torch.from_numpy(arr).to(manager.device)
            if "ewma_values" in skipped or "ewma_values" not in z:
                # the EWMA fold seeds on last_value_ts_s > 0 — restoring
                # the timestamps without the EWMAs would treat zeroed
                # averages as seeded; drop the measurement stats together
                # so seeding re-occurs
                for k in ("last_value_ts_s", "last_value_ts_ns",
                          "last_values"):
                    updates.pop(k, None)
            # commit() drops the cached packed carry: the next step and
            # the next lease_packed read the restored epoch
            manager.commit(current.replace(**updates))
        lap("state")

        # provider sections — a restore_fn crash degrades to "this
        # component never snapshotted", never a failed boot
        for name, entry in sections.items():
            if name in ("stores", "mirror", "state"):
                continue
            provider, header, payload = entry
            try:
                provider.restore_fn(header, payload)
            except Exception:
                logger.exception(
                    "state provider %s restore failed; its state "
                    "re-derives from the journal", name)
                self.restored_offsets.pop(name, None)
        lap("providers")

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        super().start()
        self._stop.clear()
        if self.interval_s > 0:
            self._thread = threading.Thread(
                target=self._loop, name="checkpointer-loop", daemon=True
            )
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        super().stop()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.save()
            except Exception:
                logger.exception("periodic checkpoint failed")
