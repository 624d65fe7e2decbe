"""Device binary streams: chunked media storage and the stream manager.

Counterpart of ``sitewhere_tpu/services/streams.py``.  Streams are
created per active assignment and filled with sequence-numbered binary
chunks; the request-level manager resolves the device's current
assignment and answers send-back requests with stored chunks or empty
payloads.

Storage: all chunks land in ONE durable
:class:`~sitewhere_tpu_torch.ingest.journal.Journal` under
``<root>/streams``, each record framed as ``(stream_token, seq, data)``;
a host index maps ``(stream, seq)`` to its journal offset, last write
wins per sequence number.  Stream descriptors are saved to
``streams.meta`` and reloaded.  Stream ids are scoped per assignment.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import os
import struct
import threading
from typing import Dict, List, Optional, Tuple

from sitewhere_tpu_torch.ingest.journal import Journal
from sitewhere_tpu_torch.runtime.lifecycle import LifecycleComponent
from sitewhere_tpu_torch.services.common import (
    DuplicateToken,
    EntityNotFound,
    InvalidReference,
    SearchCriteria,
    SearchResults,
    ValidationError,
    mint_token,
    now_s,
    paged,
    require,
)


class DeviceStreamStatus(enum.Enum):
    """Ack status for stream-create requests (reference
    ``spi/device/command/DeviceStreamStatus``)."""

    CREATED = "created"
    EXISTS = "exists"
    FAILED = "failed"


@dataclasses.dataclass
class DeviceStream:
    """Stream descriptor (reference ``IDeviceStream``): ``token`` is the
    system-wide handle (reference UUID), ``stream_id`` the device-chosen
    name unique within its assignment."""

    token: str
    stream_id: str
    assignment_token: str
    content_type: str
    created_s: int = dataclasses.field(default_factory=now_s)
    metadata: Dict[str, str] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class DeviceStreamData:
    """One chunk of a stream (reference ``IDeviceStreamData``)."""

    stream_token: str
    sequence_number: int
    data: bytes
    received_s: int


# Journal record: [u16 token_len][u64 seq][u32 ts][token utf8][data]
_REC = struct.Struct("<HQI")
_MAX_SEQ = (1 << 64) - 1


def _pack_chunk(token: str, seq: int, ts: int, data: bytes) -> bytes:
    tok = token.encode("utf-8")
    return _REC.pack(len(tok), seq, ts) + tok + data


def _unpack_chunk(payload: bytes) -> Tuple[str, int, int, bytes]:
    tok_len, seq, ts = _REC.unpack_from(payload)
    tok_end = _REC.size + tok_len
    return payload[_REC.size:tok_end].decode("utf-8"), seq, ts, payload[tok_end:]


class DeviceStreamManagement(LifecycleComponent):
    """Durable stream + chunk store for one tenant.

    Capability parity: create/get/list streams
    (``IDeviceStreamManagement``), add/get/list chunk data
    (``IDeviceStreamDataManagement``), assembled download.
    """

    def __init__(self, root: str, name: str = "stream-management"):
        super().__init__(name)
        self.dir = os.path.join(root, "streams")
        os.makedirs(self.dir, exist_ok=True)
        self._lock = threading.RLock()
        # dense journal index: chunk point reads (send-back hot path) seek
        # straight to the record instead of rolling forward through
        # neighboring multi-KB media records
        self._journal = Journal(self.dir, name="media", index_every=1)
        self._streams: Dict[str, DeviceStream] = {}          # token -> stream
        self._by_scope: Dict[Tuple[str, str], str] = {}      # (assignment, stream_id) -> token
        # stream token -> {seq: (journal offset, received_s)}
        self._index: Dict[str, Dict[int, Tuple[int, int]]] = {}
        self._load_existing()

    # -- durability ---------------------------------------------------------

    def _meta_path(self) -> str:
        return os.path.join(self.dir, "streams.meta")

    def _save_meta(self) -> None:
        tmp = self._meta_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump(
                {
                    tok: {
                        "stream_id": s.stream_id,
                        "assignment_token": s.assignment_token,
                        "content_type": s.content_type,
                        "created_s": s.created_s,
                        "metadata": s.metadata,
                    }
                    for tok, s in self._streams.items()
                },
                f,
            )
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._meta_path())

    def _load_existing(self) -> None:
        if os.path.exists(self._meta_path()):
            with open(self._meta_path()) as f:
                for tok, fields in json.load(f).items():
                    stream = DeviceStream(token=tok, **fields)
                    self._streams[tok] = stream
                    self._by_scope[(stream.assignment_token, stream.stream_id)] = tok
                    self._index[tok] = {}
        # one streaming pass over the journal rebuilds every chunk index
        for offset, payload in self._journal.scan(0):
            token, seq, ts, _ = _unpack_chunk(payload)
            if token in self._index:  # chunks of unknown streams are skipped
                self._index[token][seq] = (offset, ts)

    def stop(self) -> None:
        self._journal.flush()
        super().stop()

    def terminate(self) -> None:
        self._journal.close()
        super().terminate()

    # -- stream CRUD --------------------------------------------------------

    def create_device_stream(
        self,
        assignment_token: str,
        stream_id: str,
        content_type: str = "application/octet-stream",
        metadata: Optional[Dict[str, str]] = None,
    ) -> DeviceStream:
        require(bool(stream_id), ValidationError("stream_id required"))
        with self._lock:
            scope = (assignment_token, stream_id)
            require(
                scope not in self._by_scope,
                DuplicateToken(
                    f"stream {stream_id!r} exists for assignment {assignment_token!r}"
                ),
            )
            stream = DeviceStream(
                token=mint_token("stream"),
                stream_id=stream_id,
                assignment_token=assignment_token,
                content_type=content_type,
                metadata=metadata or {},
            )
            self._streams[stream.token] = stream
            self._by_scope[scope] = stream.token
            self._index[stream.token] = {}
            self._save_meta()
            return stream

    def get_device_stream(self, stream_token: str) -> DeviceStream:
        """Lookup by system token (reference ``getDeviceStream(UUID)``)."""
        with self._lock:
            stream = self._streams.get(stream_token)
            require(stream is not None, EntityNotFound(f"no stream {stream_token!r}"))
            return stream

    def get_assignment_stream(
        self, assignment_token: str, stream_id: str
    ) -> Optional[DeviceStream]:
        """Lookup by (assignment, device-chosen id) — the manager's scope."""
        with self._lock:
            token = self._by_scope.get((assignment_token, stream_id))
            return self._streams.get(token) if token is not None else None

    def list_device_streams(
        self,
        assignment_token: Optional[str] = None,
        criteria: Optional[SearchCriteria] = None,
    ) -> SearchResults[DeviceStream]:
        with self._lock:
            matches = [
                s
                for s in self._streams.values()
                if assignment_token is None or s.assignment_token == assignment_token
            ]
        matches.sort(key=lambda s: s.created_s)
        return paged(matches, criteria)

    # -- chunk data ---------------------------------------------------------

    def add_device_stream_data(
        self, stream_token: str, sequence_number: int, data: bytes
    ) -> DeviceStreamData:
        require(
            0 <= sequence_number <= _MAX_SEQ,
            ValidationError(f"sequence_number out of range: {sequence_number}"),
        )
        with self._lock:
            self.get_device_stream(stream_token)
            ts = now_s()
            offset = self._journal.append(
                _pack_chunk(stream_token, sequence_number, ts, data)
            )
            self._index[stream_token][sequence_number] = (offset, ts)
            return DeviceStreamData(stream_token, sequence_number, bytes(data), ts)

    def get_device_stream_data(
        self, stream_token: str, sequence_number: int
    ) -> Optional[DeviceStreamData]:
        with self._lock:
            self.get_device_stream(stream_token)
            entry = self._index[stream_token].get(sequence_number)
            if entry is None:
                return None
            offset, ts = entry
        _, seq, _, data = _unpack_chunk(self._journal.read_one(offset))
        return DeviceStreamData(stream_token, seq, data, ts)

    def _chunks_in_order(self, stream_token: str) -> List[Tuple[int, int, int]]:
        """Sorted ``(seq, offset, ts)`` rows for a stream."""
        with self._lock:
            self.get_device_stream(stream_token)
            return sorted(
                (seq, off, ts) for seq, (off, ts) in self._index[stream_token].items()
            )

    def list_device_stream_data(
        self, stream_token: str, criteria: Optional[SearchCriteria] = None
    ) -> SearchResults[DeviceStreamData]:
        """Chunks in sequence order (reference list API sorts by seq)."""
        rows = self._chunks_in_order(stream_token)
        page = paged(rows, criteria)
        return SearchResults(
            results=self._read_rows(page.results), total=page.total
        )

    def stream_content(self, stream_token: str) -> bytes:
        """Assembled stream payload in sequence order (media download)."""
        rows = self._read_rows(self._chunks_in_order(stream_token))
        return b"".join(chunk.data for chunk in rows)

    def _read_rows(self, rows: List[Tuple[int, int, int]]) -> List[DeviceStreamData]:
        """Bulk chunk fetch: one journal range scan instead of a point read
        per chunk (offsets of one stream are usually clustered)."""
        if not rows:
            return []
        wanted = {off: (seq, ts) for seq, off, ts in rows}
        lo, hi = min(wanted), max(wanted) + 1
        out = {}
        for offset, payload in self._journal.scan(lo, hi):
            if offset in wanted:
                token, seq, _, data = _unpack_chunk(payload)
                out[offset] = DeviceStreamData(token, seq, data, wanted[offset][1])
        return [out[off] for _, off, _ in rows]


class DeviceStreamManager(LifecycleComponent):
    """Request-level stream handling against the active assignment.

    Reference: ``media/DeviceStreamManager.java`` — resolve the device's
    current assignment, then create the stream / append data / answer
    send-back requests.  Every operation is scoped to the caller's own
    assignment: a device can only ever touch streams created under it.
    Acks and send-back payloads go to the (optional) ``deliver_command``
    hook, the analog of the reference's ``deliverSystemCommand`` path.
    """

    def __init__(
        self,
        device_management,  # services.device_management.DeviceManagement
        stream_management: DeviceStreamManagement,
        deliver_command=None,  # Callable[[str, dict], None]
    ):
        super().__init__("device-stream-manager")
        self.dm = device_management
        self.streams = stream_management
        self.deliver_command = deliver_command

    def _current_assignment(self, device_token: str):
        device = self.dm.get_device(device_token)
        assignment = self.dm.get_active_assignment(device.token)
        require(
            assignment is not None,
            InvalidReference(f"device {device_token!r} not assigned"),
        )
        return assignment

    def _own_stream(self, device_token: str, stream_id: str) -> DeviceStream:
        assignment = self._current_assignment(device_token)
        stream = self.streams.get_assignment_stream(assignment.token, stream_id)
        require(
            stream is not None,
            EntityNotFound(
                f"no stream {stream_id!r} for assignment {assignment.token!r}"
            ),
        )
        return stream

    def handle_device_stream_request(
        self, device_token: str, stream_id: str,
        content_type: str = "application/octet-stream",
    ) -> DeviceStreamStatus:
        assignment = self._current_assignment(device_token)
        try:
            self.streams.create_device_stream(
                assignment.token, stream_id, content_type
            )
            status = DeviceStreamStatus.CREATED
        except DuplicateToken:
            status = DeviceStreamStatus.EXISTS
        except ValidationError:
            # reference: create failures ack FAILED rather than erroring the
            # device's request (DeviceStreamManager.java:62-66)
            status = DeviceStreamStatus.FAILED
        if self.deliver_command is not None:
            self.deliver_command(
                device_token,
                {"type": "stream_ack", "stream_id": stream_id,
                 "status": status.value},
            )
        return status

    def handle_device_stream_data_request(
        self, device_token: str, stream_id: str, sequence_number: int, data: bytes
    ) -> DeviceStreamData:
        stream = self._own_stream(device_token, stream_id)
        return self.streams.add_device_stream_data(
            stream.token, sequence_number, data
        )

    def handle_send_device_stream_data_request(
        self, device_token: str, stream_id: str, sequence_number: int
    ) -> bytes:
        """Device asks for chunk N back; absent chunks answer empty
        (reference sends ``new byte[0]``)."""
        stream = self._own_stream(device_token, stream_id)
        chunk = self.streams.get_device_stream_data(stream.token, sequence_number)
        data = chunk.data if chunk is not None else b""
        if self.deliver_command is not None:
            self.deliver_command(
                device_token,
                {"type": "stream_data", "stream_id": stream_id,
                 "sequence_number": sequence_number, "data": data},
            )
        return data
