"""Runtime-uploadable scripts: versioned operator logic, live-swapped.

Counterpart of ``sitewhere_tpu/runtime/scripting.py``, whole.

Reference: Groovy scripts stored in ZooKeeper and synced to each engine's
local filesystem (``microservice/scripting/ScriptSynchronizer.java``,
``ZookeeperScriptManagement.java``); decoders/rule-processors/routers
reference scripts by id and pick up new versions without a restart.

Here a script is Python source defining one well-known entry point per
kind:

- ``decoder``:   ``decode(payload: bytes) -> list``  — items may be
  envelope dicts (``{"deviceToken", "type", "request"}``) or
  :class:`~sitewhere_tpu_torch.ingest.decoders.DecodedRequest` objects.
- ``processor``: ``process(cols: dict, mask) -> None`` — an outbound
  callback body (enriched-batch consumer, the Groovy-processor analog).
- ``router``:    ``route(execution) -> str`` — a command-destination id
  (reference ``GroovyCommandRouter.java``).
- ``encoder``:   ``encode(execution) -> bytes`` — a command payload
  encoder (reference ``GroovyStringCommandExecutionEncoder.java``).

Versions are immutable and durable (``data_dir/scripts/<name>/v<NNN>.py``
+ a manifest naming the active version), so upload/activate/rollback
survive restarts.  Consumers hold a *handle* (:meth:`ScriptManager.
as_decoder` / :meth:`as_processor`) that resolves the active version per
call — uploading activates atomically, with no pipeline pause.

Trust model: like the reference's Groovy, scripts run with interpreter
privileges — upload requires the REST admin authority; this is operator
tooling, not a sandbox.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from sitewhere_tpu_torch.services.common import (
    EntityNotFound,
    ValidationError,
    require,
)

logger = logging.getLogger("sitewhere_tpu_torch.scripting")

KINDS = ("decoder", "processor", "router", "encoder")
_ENTRY_POINT = {"decoder": "decode", "processor": "process",
                "router": "route", "encoder": "encode"}


@dataclass
class ScriptVersion:
    version: int
    source: str
    created_s: float
    entry: Callable = field(repr=False, default=None)


class ScriptRecord:
    def __init__(self, name: str, kind: str):
        self.name = name
        self.kind = kind
        self.versions: Dict[int, ScriptVersion] = {}
        self.active_version: Optional[int] = None

    @property
    def active(self) -> Optional[ScriptVersion]:
        if self.active_version is None:
            return None
        return self.versions.get(self.active_version)


class ScriptManager:
    """Versioned script store with durable persistence + live handles."""

    def __init__(self, data_dir: str):
        self.dir = os.path.join(data_dir, "scripts")
        os.makedirs(self.dir, exist_ok=True)
        self._lock = threading.RLock()
        self._scripts: Dict[str, ScriptRecord] = {}
        # Script upload/activation is arbitrary code execution — every
        # such act is audit-logged (who/when/what version), in memory for
        # the REST surface and appended durably to audit.jsonl.
        # Reference: ScriptSynchronizer's versioned-script semantics; the
        # audit trail is the part the reference lacked.
        self._audit: List[dict] = []
        self._audit_path = os.path.join(self.dir, "audit.jsonl")
        self._load_audit()
        self._load_existing()

    def _load_audit(self, keep: int = 1000) -> None:
        try:
            with open(self._audit_path) as f:
                lines = f.readlines()
        except OSError:
            return
        tail = lines[-keep:]
        for line in tail:
            try:
                self._audit.append(json.loads(line))
            except ValueError:
                continue
        if len(lines) > keep:
            # compact: the retained-entry cap bounds the FILE too, so
            # startup cost never scales with total historical volume
            tmp = f"{self._audit_path}.tmp.{os.getpid()}"
            try:
                with open(tmp, "w") as f:
                    f.writelines(tail)
                os.replace(tmp, self._audit_path)
            except OSError:
                logger.warning("script audit compaction failed",
                               exc_info=True)

    def _audit_append(self, action: str, name: str, version: int,
                      actor: str) -> None:
        entry = {"ts_s": round(time.time(), 3), "actor": actor,
                 "action": action, "script": name, "version": version}
        self._audit.append(entry)
        del self._audit[:-1000]
        try:
            with open(self._audit_path, "a") as f:
                f.write(json.dumps(entry) + "\n")
        except OSError:
            logger.warning("script audit append failed", exc_info=True)

    def audit_log(self, limit: int = 100) -> List[dict]:
        if limit <= 0:
            return []
        with self._lock:
            return list(self._audit[-limit:])

    # -- persistence ---------------------------------------------------------

    def _script_dir(self, name: str) -> str:
        return os.path.join(self.dir, name)

    def _manifest_path(self, name: str) -> str:
        return os.path.join(self._script_dir(name), "MANIFEST.json")

    def _load_existing(self) -> None:
        for name in sorted(os.listdir(self.dir)):
            mpath = self._manifest_path(name)
            try:
                with open(mpath) as f:
                    manifest = json.load(f)
            except (OSError, ValueError):
                # stray files, unreadable dirs, bad JSON: skip — a broken
                # entry must never abort instance startup
                continue
            if manifest.get("kind") not in KINDS:
                logger.warning("script %s manifest lacks a valid kind; "
                               "skipped", name)
                continue
            record = ScriptRecord(name, manifest["kind"])
            for v in manifest.get("versions", []):
                path = os.path.join(self._script_dir(name), f"v{v:03d}.py")
                try:
                    with open(path) as f:
                        source = f.read()
                except FileNotFoundError:
                    continue
                try:
                    entry = self._compile(name, manifest["kind"], source)
                except ValidationError:
                    logger.warning("script %s v%d no longer compiles; "
                                   "skipped", name, v)
                    continue
                record.versions[v] = ScriptVersion(
                    version=v, source=source,
                    created_s=os.path.getmtime(path), entry=entry)
            active = manifest.get("active")
            if active in record.versions:
                record.active_version = active
            elif record.versions:
                record.active_version = max(record.versions)
            if record.versions:
                self._scripts[name] = record

    def _persist(self, record: ScriptRecord, version: ScriptVersion) -> None:
        d = self._script_dir(record.name)
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"v{version.version:03d}.py")
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(version.source)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        manifest = {
            "kind": record.kind,
            "versions": sorted(record.versions),
            "active": record.active_version,
        }
        tmp = self._manifest_path(record.name) + f".tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._manifest_path(record.name))

    # -- compile -------------------------------------------------------------

    @staticmethod
    def _compile(name: str, kind: str, source: str) -> Callable:
        entry_name = _ENTRY_POINT[kind]
        namespace: Dict[str, object] = {"__name__": f"sw_script_{name}"}
        try:
            exec(compile(source, f"<script:{name}>", "exec"), namespace)
        except Exception as e:
            raise ValidationError(f"script does not compile: {e}") from e
        entry = namespace.get(entry_name)
        require(callable(entry), ValidationError(
            f"{kind} script must define {entry_name}(...)"))
        return entry

    # -- CRUD ----------------------------------------------------------------

    def upload(self, name: str, kind: str, source: str,
               activate: bool = True, actor: str = "system") -> dict:
        """Store a new version (validated by compiling); optionally make
        it active immediately — the ScriptSynchronizer 'replace' semantic."""
        require(kind in KINDS, ValidationError(f"kind must be one of {KINDS}"))
        require(bool(name) and "/" not in name and not name.startswith("."),
                ValidationError("bad script name"))
        entry = self._compile(name, kind, source)
        with self._lock:
            record = self._scripts.get(name)
            if record is None:
                record = ScriptRecord(name, kind)
                self._scripts[name] = record
            require(record.kind == kind, ValidationError(
                f"script {name!r} is a {record.kind}, not a {kind}"))
            version = (max(record.versions) + 1) if record.versions else 1
            sv = ScriptVersion(version=version, source=source,
                               created_s=time.time(), entry=entry)
            record.versions[version] = sv
            self._audit_append("upload", name, version, actor)
            if activate or record.active_version is None:
                record.active_version = version
                self._audit_append("activate", name, version, actor)
            self._persist(record, sv)
            return self.describe(name)

    def activate(self, name: str, version: int,
                 actor: str = "system") -> dict:
        """Switch the active version (rollback/roll-forward)."""
        with self._lock:
            record = self._get(name)
            require(version in record.versions,
                    EntityNotFound(f"{name} has no version {version}"))
            record.active_version = version
            self._audit_append("activate", name, version, actor)
            self._persist(record, record.versions[version])
            return self.describe(name)

    def _get(self, name: str) -> ScriptRecord:
        record = self._scripts.get(name)
        require(record is not None, EntityNotFound(f"no script {name!r}"))
        return record

    def describe(self, name: str) -> dict:
        with self._lock:
            record = self._get(name)
            return {
                "name": record.name,
                "kind": record.kind,
                "active": record.active_version,
                "versions": [
                    {"version": v.version,
                     "created_s": round(v.created_s, 3)}
                    for v in sorted(record.versions.values(),
                                    key=lambda s: s.version)
                ],
            }

    def list_scripts(self) -> List[dict]:
        with self._lock:
            return [self.describe(n) for n in sorted(self._scripts)]

    def get_source(self, name: str, version: Optional[int] = None) -> str:
        with self._lock:
            record = self._get(name)
            v = record.active_version if version is None else version
            require(v in record.versions,
                    EntityNotFound(f"{name} has no version {v}"))
            return record.versions[v].source

    # -- live handles ---------------------------------------------------------

    def _active_entry(self, name: str, kind: str) -> Callable:
        with self._lock:
            record = self._get(name)
            require(record.kind == kind, ValidationError(
                f"script {name!r} is a {record.kind}, not a {kind}"))
            active = record.active
            require(active is not None,
                    EntityNotFound(f"{name} has no active version"))
            return active.entry

    def as_decoder(self, name: str) -> Callable:
        """A source decoder resolving the ACTIVE version on every call —
        uploads swap behavior live, like the reference's script sync."""
        from sitewhere_tpu_torch.ingest.decoders import (
            DecodedRequest,
            DecodeError,
            _decode_one,
            envelope_fields,
        )

        def scripted_decode(payload: bytes):
            entry = self._active_entry(name, "decoder")
            try:
                items = entry(payload)
            except DecodeError:
                raise
            except Exception as e:
                raise DecodeError(f"script {name!r} failed: {e}") from e
            out = []
            for item in items or []:
                if isinstance(item, DecodedRequest):
                    out.append(item)
                elif isinstance(item, dict):
                    out.append(_decode_one(*envelope_fields(item)))
                else:
                    raise DecodeError(
                        f"script {name!r} returned {type(item).__name__}")
            return out

        return scripted_decode

    def as_processor(self, name: str) -> Callable:
        """An outbound-connector callback resolving the active version."""

        def scripted_process(cols, mask):
            self._active_entry(name, "processor")(cols, mask)

        return scripted_process

    def as_router(self, name: str) -> Callable:
        """A command router (execution → destination id) resolving the
        active version (reference ``GroovyCommandRouter.java``)."""

        def scripted_route(execution) -> str:
            return str(self._active_entry(name, "router")(execution))

        return scripted_route

    def as_encoder(self, name: str) -> Callable:
        """A command payload encoder resolving the active version
        (reference ``GroovyStringCommandExecutionEncoder.java``)."""

        def scripted_encode(execution) -> bytes:
            out = self._active_entry(name, "encoder")(execution)
            if isinstance(out, str):
                return out.encode()
            if isinstance(out, (bytes, bytearray)):
                return bytes(out)
            # bytes(int) would deliver NUL padding as a command payload;
            # fail so the invocation dead-letters instead
            raise ValidationError(
                f"encoder script {name!r} returned "
                f"{type(out).__name__}, expected str/bytes")

        return scripted_encode
