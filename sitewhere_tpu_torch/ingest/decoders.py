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
- :class:`JsonLinesDecoder` — NDJSON wire batches, scalar (journal
  replay, unregistered-row re-decode).

Counterpart of the JSON half of ``sitewhere_tpu/ingest/decoders.py``;
the binary framing and the composite decoder come with the slice that
ports the protocol sources.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import enum
import json
from typing import List, Optional, Tuple

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
