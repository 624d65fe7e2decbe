"""Payload decoders: raw protocol bytes → typed device requests.

Reference: ``IDeviceEventDecoder`` implementations in
``service-event-sources`` — JSON (``decoder/json/JsonDeviceRequestDecoder.java``,
``JsonBatchEventDecoder.java``), protobuf
(``decoder/protobuf/ProtobufDeviceEventDecoder.java``), scripted decoders
(``decoder/GroovyEventDecoder.java``), and a composite decoder that picks a
sub-decoder per device type
(``decoder/composite/BinaryCompositeDeviceEventDecoder.java``).

Here decoders are plain callables ``bytes -> list[DecodedRequest]``:

- :class:`JsonDecoder` — the envelope ``{"deviceToken": ..., "type": ...,
  "request": {...}}`` (the shape the reference's MQTT conformance senders
  emit, ``MqttTests.java:107-168``; ``hardwareId`` accepted as alias).
- :class:`JsonBatchDecoder` — ``{"deviceToken": ..., "events": [...]}``.
- :class:`BinaryDecoder` — a compact length-prefixed binary framing (the
  protobuf-decoder analog, without a schema compiler dependency).
- :class:`CompositeDecoder` — metadata extractor chooses a sub-decoder.
- "Scripting" (the Groovy analog) = any user-supplied callable with the
  same signature.

Counterpart of ``sitewhere_tpu/ingest/decoders.py``, whole.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import enum
import json
import struct
from typing import Callable, Dict, List, Optional, Tuple

from sitewhere_tpu_torch.schema import AlertLevel, EventType


class DecodeError(Exception):
    """Failed decode → dead-letter journal (reference: failed-decode topic,
    ``EventSourcesManager.java:189``)."""


class RequestKind(enum.IntEnum):
    # The 6 event types (EventType values 0..5), plus host-plane requests.
    MEASUREMENT = 0
    LOCATION = 1
    ALERT = 2
    COMMAND_INVOCATION = 3
    COMMAND_RESPONSE = 4
    STATE_CHANGE = 5
    REGISTRATION = 10       # reference: RegisterDevice → registration topic
    STREAM_DATA = 11        # reference: device stream chunks
    MAPPING = 12            # reference: DeviceMappingCreateRequest
    STREAM_CREATE = 13      # reference: DeviceStreamCreateRequest
    STREAM_SEND = 14        # reference: SendDeviceStreamDataRequest


_TYPE_ALIASES = {
    "measurement": RequestKind.MEASUREMENT,
    "measurements": RequestKind.MEASUREMENT,
    "devicemeasurements": RequestKind.MEASUREMENT,
    "location": RequestKind.LOCATION,
    "devicelocation": RequestKind.LOCATION,
    "alert": RequestKind.ALERT,
    "devicealert": RequestKind.ALERT,
    "registerdevice": RequestKind.REGISTRATION,
    "registration": RequestKind.REGISTRATION,
    "acknowledge": RequestKind.COMMAND_RESPONSE,
    "commandresponse": RequestKind.COMMAND_RESPONSE,
    "commandinvocation": RequestKind.COMMAND_INVOCATION,
    "statechange": RequestKind.STATE_CHANGE,
    "streamdata": RequestKind.STREAM_DATA,
    "devicestreamdata": RequestKind.STREAM_DATA,
    "devicestream": RequestKind.STREAM_CREATE,
    "devicestreamcreate": RequestKind.STREAM_CREATE,
    "sendstreamdata": RequestKind.STREAM_SEND,
}

_LEVEL_ALIASES = {
    "info": AlertLevel.INFO,
    "warning": AlertLevel.WARNING,
    "error": AlertLevel.ERROR,
    "critical": AlertLevel.CRITICAL,
}


@dataclasses.dataclass
class DecodedRequest:
    """One typed inbound request (reference: ``IDecodedDeviceRequest``)."""

    kind: RequestKind
    device_token: str
    ts_s: int
    ts_ns: int = 0
    # measurement
    mtype: Optional[str] = None
    value: float = 0.0
    # location
    lat: float = 0.0
    lon: float = 0.0
    elevation: float = 0.0
    # alert
    alert_type: Optional[str] = None
    alert_level: int = AlertLevel.INFO
    alert_message: Optional[str] = None
    # command response (reference: Acknowledge w/ originating event id)
    originating_event: Optional[str] = None
    response: Optional[str] = None
    # registration
    device_type_token: Optional[str] = None
    area_token: Optional[str] = None
    customer_token: Optional[str] = None
    # generic
    metadata: Optional[dict] = None
    # device stream requests (host plane)
    stream_id: Optional[str] = None
    sequence_number: int = 0
    stream_data: Optional[bytes] = None
    content_type: Optional[str] = None
    alternate_id: Optional[str] = None   # dedup key (AlternateIdDeduplicator)
    update_state: bool = True            # reference: event.isUpdateState()

    @property
    def event_type(self) -> Optional[EventType]:
        """The on-device event type, or None for host-plane requests."""
        if self.kind <= RequestKind.STATE_CHANGE:
            return EventType(int(self.kind))
        return None


def _ts_from_seconds(value: float) -> Tuple[int, int]:
    """Epoch-SECONDS float → (ts_s, ts_ns) with the int32 schema check.

    No epoch-millis heuristic: callers whose wire format DEFINES the
    field as seconds (the binary framing) must not reinterpret corrupt
    values in (1e11, ~2.1e12] as milliseconds — they dead-letter."""
    s = int(value)  # OverflowError (inf) / ValueError (nan) → DecodeError
    if not -(1 << 31) <= s < (1 << 31):
        raise DecodeError(f"timestamp out of range: {value!r}")
    return s, int(round((value - s) * 1e9))


def _parse_ts(value) -> Tuple[int, int]:
    """Accept epoch seconds (int/float), epoch millis (int > 1e11), or ISO."""
    if value is None:
        return 0, 0
    if isinstance(value, (int, float)):
        if value > 1e11:  # epoch millis
            value = value / 1000.0
        s = int(value)
        if not -(1 << 31) <= s < (1 << 31):
            # the schema stores epoch seconds as int32; a huge finite
            # literal would otherwise escape as OverflowError at the
            # batcher's column conversion (fuzz-found crash vector)
            raise DecodeError(f"eventDate out of range: {value!r}")
        return s, int(round((value - s) * 1e9))
    if isinstance(value, str):
        try:
            dt = _dt.datetime.fromisoformat(value.replace("Z", "+00:00"))
        except ValueError as e:
            raise DecodeError(f"bad eventDate {value!r}") from e
        ts = dt.timestamp()
        s = int(ts)
        if not -(1 << 31) <= s < (1 << 31):
            raise DecodeError(f"eventDate out of range: {value!r}")
        return s, int(round((ts - s) * 1e9))
    raise DecodeError(f"bad eventDate {value!r}")


def _decode_one(token: str, kind_name: str, req: dict) -> DecodedRequest:
    try:
        return _decode_one_inner(token, kind_name, req)
    except DecodeError:
        raise
    except (ValueError, TypeError, KeyError, OverflowError) as e:
        # Malformed field values (float("abc"), int(None), and the
        # OverflowError from int(inf) — json.loads parses "1e999" and
        # the "Infinity" literal to float inf) must become DecodeError
        # so sources dead-letter them instead of the exception killing
        # the receiver thread.  Fuzz-found: an eventDate of 1e999 on
        # any scalar-path line escaped here as OverflowError.
        raise DecodeError(f"bad field in {kind_name!r} request: {e}") from e


def _decode_one_inner(token: str, kind_name: str, req: dict) -> DecodedRequest:
    kind = _TYPE_ALIASES.get(kind_name.strip().lower())
    if kind is None:
        raise DecodeError(f"unknown request type {kind_name!r}")
    ts_s, ts_ns = _parse_ts(req.get("eventDate", req.get("timestamp")))
    common = dict(
        kind=kind,
        device_token=token,
        ts_s=ts_s,
        ts_ns=ts_ns,
        metadata=req.get("metadata"),
        alternate_id=req.get("alternateId"),
        update_state=bool(req.get("updateState", True)),
    )
    if kind == RequestKind.MEASUREMENT:
        # `or`: an empty name falls through to the alias (same rule on
        # the columnar and native paths — they must never diverge)
        name = req.get("name") or req.get("measurementId")
        if not name or "value" not in req:
            raise DecodeError("measurement needs name+value")
        return DecodedRequest(mtype=str(name), value=float(req["value"]), **common)
    if kind == RequestKind.LOCATION:
        try:
            return DecodedRequest(
                lat=float(req["latitude"]),
                lon=float(req["longitude"]),
                elevation=float(req.get("elevation", 0.0)),
                **common,
            )
        except KeyError as e:
            raise DecodeError(f"location missing {e}") from e
    if kind == RequestKind.ALERT:
        level = req.get("level", "info")
        if isinstance(level, str):
            level = _LEVEL_ALIASES.get(level.lower())
            if level is None:
                raise DecodeError(f"bad alert level {req.get('level')!r}")
        level = int(level)
        if not -(1 << 31) <= level < (1 << 31):
            raise DecodeError(f"alert level out of range: {level!r}")
        return DecodedRequest(
            alert_type=str(req.get("type", req.get("alertType", "alert"))),
            alert_level=level,
            alert_message=req.get("message"),
            **common,
        )
    if kind == RequestKind.COMMAND_RESPONSE:
        return DecodedRequest(
            originating_event=req.get("originatingEventId"),
            response=req.get("response"),
            **common,
        )
    if kind == RequestKind.COMMAND_INVOCATION:
        # journaled invocation payloads (create_command_invocation) must
        # re-decode on crash replay; the invocation token correlates the
        # row with its responses
        return DecodedRequest(
            originating_event=req.get("invocationToken"),
            **common,
        )
    if kind == RequestKind.REGISTRATION:
        return DecodedRequest(
            device_type_token=req.get("deviceTypeToken", req.get("specificationToken")),
            area_token=req.get("areaToken"),
            customer_token=req.get("customerToken"),
            **common,
        )
    if kind in (RequestKind.STREAM_CREATE, RequestKind.STREAM_DATA,
                RequestKind.STREAM_SEND):
        stream_id = req.get("streamId")
        if not stream_id:
            raise DecodeError("stream request needs streamId")
        if kind == RequestKind.STREAM_CREATE:
            return DecodedRequest(
                stream_id=str(stream_id),
                # `or`: an explicit JSON null must fall back, not become
                # the literal string "None"
                content_type=str(req.get("contentType")
                                 or "application/octet-stream"),
                **common)
        seq = req.get("sequenceNumber")
        if seq is None:
            raise DecodeError("stream request needs sequenceNumber")
        if kind == RequestKind.STREAM_SEND:
            return DecodedRequest(stream_id=str(stream_id),
                                  sequence_number=int(seq), **common)
        raw = req.get("data")
        if raw is None:
            raise DecodeError("stream data needs data (base64)")
        import base64 as _base64

        try:
            blob = _base64.b64decode(raw, validate=True)
        except Exception as e:
            raise DecodeError(f"bad stream data base64: {e}") from e
        return DecodedRequest(stream_id=str(stream_id),
                              sequence_number=int(seq),
                              stream_data=blob, **common)
    if kind in (RequestKind.STATE_CHANGE, RequestKind.MAPPING):
        return DecodedRequest(**common)
    raise DecodeError(f"unsupported request type {kind_name!r}")


class JsonDecoder:
    """``{"deviceToken"|"hardwareId": ..., "type": ..., "request": {...}}``"""

    def __call__(self, payload: bytes) -> List[DecodedRequest]:
        try:
            doc = json.loads(payload)
        except (ValueError, UnicodeDecodeError) as e:
            raise DecodeError(f"bad json: {e}") from e
        if not isinstance(doc, dict):
            raise DecodeError("json payload must be an object")
        token = doc.get("deviceToken", doc.get("hardwareId"))
        if not token:
            raise DecodeError("missing deviceToken/hardwareId")
        kind = doc.get("type")
        if not kind:
            raise DecodeError("missing type")
        req = doc.get("request", {})
        if not isinstance(req, dict):
            raise DecodeError("request must be an object")
        return [_decode_one(str(token), str(kind), req)]


class JsonBatchDecoder:
    """``{"deviceToken": ..., "events": [{"type": ..., ...}, ...]}``

    Reference: ``JsonBatchEventDecoder.java`` — many events in one payload.
    """

    def __call__(self, payload: bytes) -> List[DecodedRequest]:
        try:
            doc = json.loads(payload)
        except (ValueError, UnicodeDecodeError) as e:
            raise DecodeError(f"bad json: {e}") from e
        token = doc.get("deviceToken", doc.get("hardwareId"))
        if not token:
            raise DecodeError("missing deviceToken/hardwareId")
        events = doc.get("events")
        if not isinstance(events, list) or not events:
            raise DecodeError("missing events[]")
        out = []
        for ev in events:
            if not isinstance(ev, dict) or "type" not in ev:
                raise DecodeError("each event needs a type")
            out.append(_decode_one(str(token), str(ev["type"]), ev))
        return out


def parse_envelopes(payload: bytes) -> List[dict]:
    """Parse wire bytes — one JSON envelope, a JSON array of envelopes, or
    NDJSON — into a list of envelope dicts.  Shared by the scalar
    :class:`JsonLinesDecoder` and the columnar wire edge
    (:func:`sitewhere_tpu_torch.ingest.columnar.decode_json_lines`)."""
    text = payload.strip()
    if not text:
        raise DecodeError("empty payload")
    try:
        if text.startswith(b"["):
            docs = json.loads(text)
        elif b"\n" in text:
            # one synthesized array parse instead of N json.loads calls;
            # blank interior lines are legal NDJSON and are skipped
            lines = [ln for ln in text.split(b"\n") if ln.strip()]
            try:
                docs = json.loads(b"[" + b",".join(lines) + b"]")
            except ValueError:
                # not NDJSON after all — a pretty-printed single envelope
                # (journaled by the scalar path) also contains newlines
                docs = [json.loads(text)]
        else:
            docs = [json.loads(text)]
    except (ValueError, UnicodeDecodeError) as e:
        raise DecodeError(f"bad json: {e}") from e
    if not isinstance(docs, list):
        raise DecodeError("wire batch must be envelope(s)")
    return docs


_KIND_WIRE_NAMES = {
    RequestKind.MEASUREMENT: "Measurement",
    RequestKind.LOCATION: "Location",
    RequestKind.ALERT: "Alert",
    RequestKind.COMMAND_RESPONSE: "CommandResponse",
    RequestKind.COMMAND_INVOCATION: "CommandInvocation",
    RequestKind.REGISTRATION: "Registration",
    RequestKind.STATE_CHANGE: "StateChange",
    RequestKind.STREAM_DATA: "StreamData",
    RequestKind.STREAM_CREATE: "DeviceStream",
    RequestKind.STREAM_SEND: "SendStreamData",
}


def encode_envelope(req: DecodedRequest) -> bytes:
    """:class:`DecodedRequest` → the JSON wire envelope
    :func:`_decode_one` accepts — the inverse of decode for the fields
    the pipeline carries.  Used when an already-decoded row must cross
    DCN to its owning host (``rpc/forward.py``) and re-enter that host's
    wire intake: re-encoding beats inventing a second serialization for
    the same data (one wire format, as the reference keeps one protobuf
    payload schema end to end)."""
    kind_name = _KIND_WIRE_NAMES.get(req.kind)
    if kind_name is None:
        raise ValueError(f"kind {req.kind!r} has no wire envelope")
    body: Dict[str, object] = {
        "eventDate": (req.ts_s + req.ts_ns / 1e9) if req.ts_ns else req.ts_s,
    }
    if req.metadata:
        body["metadata"] = req.metadata
    if req.alternate_id:
        body["alternateId"] = req.alternate_id
    if not req.update_state:
        body["updateState"] = False
    if req.kind == RequestKind.MEASUREMENT:
        body["name"] = req.mtype
        body["value"] = req.value
    elif req.kind == RequestKind.LOCATION:
        body["latitude"] = req.lat
        body["longitude"] = req.lon
        if req.elevation:
            body["elevation"] = req.elevation
    elif req.kind == RequestKind.ALERT:
        body["type"] = req.alert_type
        body["level"] = int(req.alert_level)
        if req.alert_message is not None:
            body["message"] = req.alert_message
    elif req.kind == RequestKind.COMMAND_RESPONSE:
        if req.originating_event is not None:
            body["originatingEventId"] = req.originating_event
        if req.response is not None:
            body["response"] = req.response
    elif req.kind == RequestKind.COMMAND_INVOCATION:
        if req.originating_event is not None:
            body["invocationToken"] = req.originating_event
    elif req.kind == RequestKind.REGISTRATION:
        if req.device_type_token:
            body["deviceTypeToken"] = req.device_type_token
        if req.area_token:
            body["areaToken"] = req.area_token
        if req.customer_token:
            body["customerToken"] = req.customer_token
    elif req.kind in (RequestKind.STREAM_CREATE, RequestKind.STREAM_DATA,
                      RequestKind.STREAM_SEND):
        import base64 as _base64

        body["streamId"] = req.stream_id
        if req.kind == RequestKind.STREAM_CREATE:
            if req.content_type:
                body["contentType"] = req.content_type
        else:
            body["sequenceNumber"] = req.sequence_number
        if req.kind == RequestKind.STREAM_DATA:
            body["data"] = _base64.b64encode(
                req.stream_data or b"").decode("ascii")
    return json.dumps(
        {"deviceToken": req.device_token, "type": kind_name, "request": body},
        separators=(",", ":")).encode("utf-8")


def envelope_fields(doc) -> Tuple[str, str, dict]:
    """Validate one envelope → ``(device_token, type_name, request)``."""
    if not isinstance(doc, dict):
        raise DecodeError("each line must be a JSON object")
    token = doc.get("deviceToken", doc.get("hardwareId"))
    kind = doc.get("type")
    if not token or not kind:
        raise DecodeError("line missing deviceToken/type")
    req = doc.get("request", {})
    if not isinstance(req, dict):
        raise DecodeError("request must be an object")
    return str(token), str(kind), req


class JsonLinesDecoder:
    """Scalar fallback for NDJSON wire batches (and plain envelopes).

    Used where individual :class:`DecodedRequest` objects are needed for
    payloads that may have arrived through the columnar wire edge
    (journal replay, unregistered-row re-decode); the hot path decodes
    the same bytes columnar-ly via
    :func:`sitewhere_tpu_torch.ingest.columnar.decode_json_lines`.
    """

    def __call__(self, payload: bytes) -> List[DecodedRequest]:
        return [
            _decode_one(*envelope_fields(doc))
            for doc in parse_envelopes(payload)
        ]


# Compact binary framing:  magic "SW" | u8 kind | u8 token_len | token |
# f64 ts | kind-specific payload.  The schema-compiled-protobuf analog.
_BIN_MAGIC = b"SW"
_BIN_HEAD = struct.Struct("<2sBB")
_BIN_TS = struct.Struct("<d")
_BIN_MEAS = struct.Struct("<Bd")       # mtype_len follows; value
_BIN_LOC = struct.Struct("<ddd")       # lat, lon, elevation
_BIN_ALERT = struct.Struct("<BB")      # level, type_len


class BinaryDecoder:
    """Compact binary event framing (see module source for layout)."""

    def __call__(self, payload: bytes) -> List[DecodedRequest]:
        try:
            magic, kind, token_len = _BIN_HEAD.unpack_from(payload, 0)
            if magic != _BIN_MAGIC:
                raise DecodeError("bad magic")
            pos = _BIN_HEAD.size
            token = payload[pos : pos + token_len].decode("utf-8")
            pos += token_len
            (ts,) = _BIN_TS.unpack_from(payload, pos)
            pos += _BIN_TS.size
            # range/finiteness checks: wire bytes can encode inf/nan
            # or out-of-int32 floats, which must dead-letter like the
            # JSON paths, never escape as OverflowError (seconds-only:
            # the binary field is DEFINED as epoch seconds, so no
            # millis heuristic)
            ts_s, ts_ns = _ts_from_seconds(ts)
            kind = RequestKind(kind)
            if kind == RequestKind.MEASUREMENT:
                name_len, value = _BIN_MEAS.unpack_from(payload, pos)
                pos += _BIN_MEAS.size
                name = payload[pos : pos + name_len].decode("utf-8")
                return [
                    DecodedRequest(
                        kind=kind, device_token=token, ts_s=ts_s, ts_ns=ts_ns,
                        mtype=name, value=value,
                    )
                ]
            if kind == RequestKind.LOCATION:
                lat, lon, elev = _BIN_LOC.unpack_from(payload, pos)
                return [
                    DecodedRequest(
                        kind=kind, device_token=token, ts_s=ts_s, ts_ns=ts_ns,
                        lat=lat, lon=lon, elevation=elev,
                    )
                ]
            if kind == RequestKind.ALERT:
                level, type_len = _BIN_ALERT.unpack_from(payload, pos)
                pos += _BIN_ALERT.size
                atype = payload[pos : pos + type_len].decode("utf-8")
                return [
                    DecodedRequest(
                        kind=kind, device_token=token, ts_s=ts_s, ts_ns=ts_ns,
                        alert_type=atype, alert_level=level,
                    )
                ]
            if kind == RequestKind.REGISTRATION:
                (dt_len,) = struct.unpack_from("<B", payload, pos)
                pos += 1
                dt_token = payload[pos : pos + dt_len].decode("utf-8")
                return [
                    DecodedRequest(
                        kind=kind, device_token=token, ts_s=ts_s, ts_ns=ts_ns,
                        device_type_token=dt_token or None,
                    )
                ]
            raise DecodeError(f"unsupported binary kind {int(kind)}")
        except (struct.error, UnicodeDecodeError, ValueError,
                OverflowError) as e:
            raise DecodeError(f"bad binary payload: {e}") from e

    @staticmethod
    def encode(req: DecodedRequest) -> bytes:
        """Inverse framing (used by tests and device simulators)."""
        token = req.device_token.encode("utf-8")
        ts = req.ts_s + req.ts_ns / 1e9
        head = _BIN_HEAD.pack(_BIN_MAGIC, int(req.kind), len(token))
        body = head + token + _BIN_TS.pack(ts)
        if req.kind == RequestKind.MEASUREMENT:
            name = (req.mtype or "").encode("utf-8")
            return body + _BIN_MEAS.pack(len(name), req.value) + name
        if req.kind == RequestKind.LOCATION:
            return body + _BIN_LOC.pack(req.lat, req.lon, req.elevation)
        if req.kind == RequestKind.ALERT:
            atype = (req.alert_type or "").encode("utf-8")
            return body + _BIN_ALERT.pack(req.alert_level, len(atype)) + atype
        if req.kind == RequestKind.REGISTRATION:
            dt = (req.device_type_token or "").encode("utf-8")
            return body + struct.pack("<B", len(dt)) + dt
        raise ValueError(f"cannot encode kind {req.kind}")


class CompositeDecoder:
    """Metadata extractor chooses a sub-decoder per payload.

    Reference: ``BinaryCompositeDeviceEventDecoder`` — a metadata extractor
    reads the payload, yields a key (there: the device type), and a keyed
    sub-decoder decodes the body.
    """

    def __init__(
        self,
        extractor: Callable[[bytes], Tuple[str, bytes]],
        decoders: Dict[str, Callable[[bytes], List[DecodedRequest]]],
    ):
        self.extractor = extractor
        self.decoders = decoders

    def __call__(self, payload: bytes) -> List[DecodedRequest]:
        key, body = self.extractor(payload)
        decoder = self.decoders.get(key)
        if decoder is None:
            raise DecodeError(f"no decoder for key {key!r}")
        return decoder(body)
