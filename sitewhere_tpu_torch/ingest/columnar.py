"""Columnar wire decode: one NDJSON payload -> column arrays, no per-event
dataclasses.

Counterpart of ``sitewhere_tpu/ingest/columnar.py``, with its lanes in
the reference's order of preference:

- fill-direct (:func:`decode_fill_direct`): homogeneous measurement
  payloads, the dominant fleet shape, scanned by C straight into a
  batcher reservation, device tokens resolved through the
  ``TokenTable`` mirror (:meth:`~..ids.HandleSpace.native_table`);
- resolved (:func:`_native_decode_resolved`): the same scan into fresh
  arrays, for journal replay;
- the C measurement scanner, then the C event-family scanners
  (:func:`_native_decode`): measurements, locations and alerts in any
  mix, registration lines split out;
- pure Python: one ``json.loads`` per line (:func:`~.decoders.
  parse_envelopes`) and one comprehension + ``np.fromiter`` sweep per
  column, for every shape the scanners do not take.

The scanners are ``sitewhere_tpu_torch/native/swwire.c`` (built at first
use; a failed build raises).  Their strictness contract is the
reference's: any shape deviation makes a scanner return None and the
next lane takes the payload, with identical results, errors included.

Wire format: newline-delimited JSON, each line the envelope the scalar
:class:`~.decoders.JsonDecoder` accepts (``{"deviceToken", "type",
"request": {...}}``); a JSON array of the same envelopes is accepted too
(pure Python).  Host-plane lines (registration etc.) fall out as scalar
:class:`~.decoders.DecodedRequest` objects for the normal path.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

import numpy as np

from sitewhere_tpu_torch.ids import NULL_ID, HandleSpace
from sitewhere_tpu_torch.ingest.decoders import (
    _LEVEL_ALIASES,
    _TYPE_ALIASES,
    DecodedRequest,
    DecodeError,
    JsonLinesDecoder,
    RequestKind,
    _decode_one,
    _parse_ts,
    envelope_fields,
    parse_envelopes,
)
from sitewhere_tpu_torch.schema import EventType

_MISS = object()  # dict-get sentinel (kind 0 is falsy: `or` won't do)


class CopyTally:
    """Per-call count of the intermediate bytes a decode lane
    materializes (anything that is neither the wire payload nor a final
    batch column: the C scanner's returned bytes objects, ``frombuffer``
    copies, ``astype`` outputs, the ``_split_epoch`` temporaries).  The
    dispatcher adds the total to ``pipeline.bytes_copied.decode``; the
    fill-direct lane adds nothing.  Boolean masks are not counted."""

    __slots__ = ("n",)

    def __init__(self) -> None:
        self.n = 0

    def add(self, nbytes: int) -> None:
        self.n += int(nbytes)


# _split_epoch materializes this many temp/output bytes per row (np.where
# f64 + int64 seconds + f64 diff + f64 scaled + f64 round + int64 nanos +
# two int32 casts = 8+8+8+8+8+8+4+4), counted as a constant.
_SPLIT_EPOCH_BYTES_PER_ROW = 56

# Request kinds that are pipeline events (EventType 0..5).
_EVENT_KINDS = frozenset(int(k) for k in RequestKind
                         if k <= RequestKind.STATE_CHANGE)

# Exact-case lookup first (one dict get per line); common wire casings
# pre-seeded so the .lower() normalization never runs on the fast path.
_KIND_EXACT = dict(_TYPE_ALIASES)
_KIND_EXACT.update({
    "Measurement": RequestKind.MEASUREMENT,
    "Measurements": RequestKind.MEASUREMENT,
    "DeviceMeasurements": RequestKind.MEASUREMENT,
    "Location": RequestKind.LOCATION,
    "DeviceLocation": RequestKind.LOCATION,
    "Alert": RequestKind.ALERT,
    "DeviceAlert": RequestKind.ALERT,
    "RegisterDevice": RequestKind.REGISTRATION,
    "Registration": RequestKind.REGISTRATION,
    "Acknowledge": RequestKind.COMMAND_RESPONSE,
    "CommandResponse": RequestKind.COMMAND_RESPONSE,
    "CommandInvocation": RequestKind.COMMAND_INVOCATION,
    "StateChange": RequestKind.STATE_CHANGE,
    "StreamData": RequestKind.STREAM_DATA,
})


def space_of(resolve_device) -> Optional[HandleSpace]:
    """The HandleSpace behind a bound ``lookup`` resolver, else None.

    Only ``HandleSpace.lookup`` itself qualifies: a caller passing e.g.
    ``mint`` (or any other callable) keeps its semantics and the bulk
    lookup stays off.
    """
    owner = getattr(resolve_device, "__self__", None)
    if isinstance(owner, HandleSpace) \
            and getattr(resolve_device, "__func__", None) \
            is HandleSpace.lookup:
        return owner
    return None


def n_rows(columns: Dict[str, object]) -> int:
    """Event-row count of a decoded column dict, resolved or not."""
    return len(columns["device_id"] if "device_id" in columns
               else columns["device_token"])


def fill_direct_ready(payload) -> bool:
    """The gate of every C lane, cheap enough to run before allocating a
    reservation: NDJSON bytes (a JSON array decodes in Python), with the
    native tier on (``SW_NATIVE=0`` sends every payload to the
    pure-Python lane)."""
    from sitewhere_tpu_torch import native

    return isinstance(payload, bytes) and payload[:1] != b"[" \
        and native.enabled()


def decode_fill_direct(payload: bytes, device_space: HandleSpace,
                       reservation, resolve_mtype) -> Optional[int]:
    """Fill-direct decode: the C scan straight into a batcher reservation.

    The scanner writes validated int32/float32 values directly into
    ``reservation``'s packed column rows (device ids resolved through the
    ``TokenTable`` mirror, timestamps split to ``(ts_s, ts_ns)`` in C);
    the only Python objects made are the distinct measurement names.
    Returns the row count; on any shape deviation the reservation is
    aborted (nothing was shared, so no torn rows) and None is returned,
    and the caller decodes with :func:`decode_json_lines`, which gives the
    same result, errors included.
    """
    from sitewhere_tpu_torch.native import load_swwire

    res = reservation
    if not fill_direct_ready(payload):
        res.abort()
        return None
    out = load_swwire().decode_measurement_lines_resolved_into(
        payload, device_space.native_table(), res.device_id, res.name_idx,
        res.value, res.ts_s, res.ts_ns, res.update_state)
    if out is None:
        res.abort()
        return None
    n, uniq = out
    # resolve the distinct names, then remap the scratch indices into the
    # mtype row in place (np.take into a distinct destination: no
    # temporary is gathered)
    uniq_ids = np.asarray([resolve_mtype(u) for u in uniq], np.int32)
    row = res.mtype_id
    if len(uniq_ids) == 1:
        row[:n] = uniq_ids[0]
    else:
        np.take(uniq_ids, res.name_idx[:n], out=row[:n])
    res.n = n
    return n


def decode_json_lines(
    payload: bytes,
    device_space: Optional[HandleSpace] = None,
    copied: Optional[CopyTally] = None,
) -> Tuple[Dict[str, object], List[DecodedRequest]]:
    """Decode one NDJSON (or JSON-array) wire payload columnar-ly.

    Returns ``(columns, host_requests)`` where ``columns`` holds, for the
    event lines only:

    - ``device_token``: list[str]; resolve with :func:`resolve_columns`
    - ``mtype`` / ``alert_type``: list[Optional[str]]
    - ``event_type``, ``ts_s``, ``ts_ns``, ``value``, ``lat``, ``lon``,
      ``elevation``, ``alert_level``, ``update_state``: numpy arrays
    - ``origin`` (only when some row carries one): invocation tokens

    and ``host_requests`` carries the rare host-plane lines as scalar
    requests.  Raises :class:`DecodeError` if the payload or any line
    cannot be parsed (the whole payload dead-letters).

    With ``device_space`` (the HandleSpace the caller resolves
    ``device_token`` against), homogeneous measurement payloads take the
    C scanner's RESOLVED form: ``columns`` then carries ``device_id``
    (int32, ``NULL_ID`` for unknown tokens) instead of ``device_token``,
    ``mtype_uniq``/``mtype_idx`` instead of ``mtype`` and ``alert_code``
    instead of ``alert_type``; :func:`resolve_columns` takes both shapes.
    ``copied`` counts the lane's intermediate bytes (:class:`CopyTally`).
    """
    if device_space is not None:
        resolved = _native_decode_resolved(payload, device_space, copied)
        if resolved is not None:
            return resolved
    native = _native_decode(payload, copied)
    if native is not None:
        return native
    try:
        return _decode_lines_inner(parse_envelopes(payload))
    except DecodeError:
        raise
    except (ValueError, TypeError, KeyError, OverflowError) as e:
        # Bad field values (non-numeric "value", unhashable "type", ...)
        # dead-letter like any other decode failure.
        raise DecodeError(f"bad wire batch: {e}") from e


def _native_decode_resolved(
    payload: bytes,
    device_space: HandleSpace,
    copied: Optional[CopyTally] = None,
) -> Optional[Tuple[Dict[str, object], List[DecodedRequest]]]:
    """The C measurement scan with device tokens resolved in C (the
    ``TokenTable`` mirror).  Same strictness contract as
    :func:`_native_decode`'s measurement scanner: any shape deviation
    returns None and the caller takes the next lane."""
    from sitewhere_tpu_torch.native import load_swwire

    if not fill_direct_ready(payload):
        return None
    out = load_swwire().decode_measurement_lines_resolved(
        payload, device_space.native_table())
    if out is None:
        return None
    ids_b, uniq_names, idx_b, values_b, ts_b, us_b = out
    # the ids come back as a writable bytearray, so the batcher's in-place
    # NULL_ID rewrite of out-of-range rows needs no defensive copy
    device_id = np.frombuffer(ids_b, np.int32)
    n = len(device_id)
    if copied is not None:
        copied.add(len(ids_b) + len(idx_b) + len(values_b) + len(ts_b)
                   + len(us_b)                   # C scratch -> bytes
                   + 4 * n + n                   # value/update astype
                   + _SPLIT_EPOCH_BYTES_PER_ROW * n)
    ts_s, ts_ns = _split_epoch(np.frombuffer(ts_b, np.float64))
    zeros = np.zeros(n, np.float32)
    return {
        "device_id": device_id,
        "event_type": np.zeros(n, np.int32),  # all MEASUREMENT
        "ts_s": ts_s, "ts_ns": ts_ns,
        "mtype_uniq": uniq_names,
        "mtype_idx": np.frombuffer(idx_b, np.int32),
        "value": np.frombuffer(values_b, np.float64).astype(np.float32),
        "lat": zeros, "lon": zeros, "elevation": zeros,
        "alert_code": np.full(n, NULL_ID, np.int32),
        "alert_level": np.zeros(n, np.int32),
        "update_state": np.frombuffer(us_b, np.uint8).astype(np.bool_),
    }, []


def _host_requests(host_lines) -> List[DecodedRequest]:
    """Registration/host-plane lines -> scalar requests (shared by the
    event-family lanes; a line ``json.loads`` rejects dead-letters the
    whole payload, as on the pure-Python lane)."""
    host: List[DecodedRequest] = []
    for line in host_lines:
        try:
            doc = json.loads(line)
        except ValueError as e:
            raise DecodeError(f"bad wire batch: {e}") from e
        host.append(_decode_one(*envelope_fields(doc)))
    return host


class RecordEvents:
    """The event requests of one NDJSON journal record, in line order,
    as the scalar :class:`~sitewhere_tpu_torch.ingest.decoders.JsonLinesDecoder`
    returns them (host-plane lines left out); ``tokens`` holds each
    event's device token.

    :meth:`of` decodes the record up front, and raises as the scalar
    decoder does, unless :func:`certified_event_lines` proves that every
    line decodes; then :meth:`request` decodes a line the first time it
    is asked for, and a reader that needs a few lines of a large record
    pays for those alone."""

    def __init__(self, tokens: List[str], requests: List[object],
                 lines: Optional[List[bytes]] = None):
        self.tokens = tokens
        self._requests = requests
        self._lines = lines

    @classmethod
    def of(cls, payload: bytes) -> "RecordEvents":
        certified = certified_event_lines(payload)
        if certified is not None:
            lines, tokens = certified
            return cls(tokens, [None] * len(tokens), lines)
        reqs = [r for r in JsonLinesDecoder()(payload)
                if r.event_type is not None]
        return cls([r.device_token for r in reqs], reqs)

    def __len__(self) -> int:
        return len(self.tokens)

    def request(self, i: int) -> DecodedRequest:
        req = self._requests[i]
        if req is None:
            req = self._requests[i] = _decode_one(
                *envelope_fields(json.loads(self._lines[i])))
        return req


def certified_event_lines(
        payload: bytes) -> Optional[Tuple[List[bytes], List[str]]]:
    """``(lines, device tokens)`` of an NDJSON record every line of which
    the scalar decoder accepts as an event, proven without running it;
    None when that is not proven.

    The proof: the C event scanner (``swwire.c decode_event_lines``)
    accepts every line as a measurement, location or alert, none is a
    host-plane line, and every event time lies in the scalar decoder's
    int32 range.  The scanner's grammar is no wider than the scalar
    decoder's: unescaped string keys, tokens, names and types, finite
    JSON numbers, the same type aliases, the same token and name
    precedence, lowercase level aliases or in-range numbers, literal
    booleans, and a present ``request`` object.  Its event time is
    ``eventDate`` unless that is 0, the scalar decoder's whenever they
    differ is 0, so the range check is no wider either."""
    if not fill_direct_ready(payload):
        return None
    from sitewhere_tpu_torch.native import load_swwire

    out = load_swwire().decode_event_lines(payload)
    if out is None:
        return None
    tokens, ts_b, host_lines = out[0], out[5], out[11]
    if not tokens or host_lines:
        return None
    try:
        _split_epoch(np.frombuffer(ts_b, np.float64))
    except DecodeError:
        return None
    lines = [ln for ln in payload.split(b"\n") if ln.strip()]
    if len(lines) != len(tokens):
        return None
    return lines, tokens


def _native_decode_events_into(
    mod, payload: bytes,
) -> Optional[Tuple[Dict[str, object], List[DecodedRequest]]]:
    """Fill-direct event-family decode: the C scanner writes the numeric
    columns straight into freshly allocated final arrays (int32/float32/
    bool), no intermediate bytes objects.  None = take the two-phase
    scanner (which reproduces errors such as out-of-range timestamps)."""
    cap = payload.count(b"\n") + 1
    kinds = np.empty(cap, np.int32)
    ts_s = np.empty(cap, np.int32)
    ts_ns = np.empty(cap, np.int32)
    value = np.empty(cap, np.float32)
    lat = np.empty(cap, np.float32)
    lon = np.empty(cap, np.float32)
    elev = np.empty(cap, np.float32)
    level = np.empty(cap, np.int32)
    us = np.empty(cap, np.bool_)
    out = mod.decode_event_lines_into(
        payload, kinds, ts_s, ts_ns, value, lat, lon, elev, level, us)
    if out is None:
        return None
    n, tokens, names, alert_types, host_lines = out
    if n == 0 and not host_lines:
        return None  # keep the pure-Python lane's empty-payload error
    host = _host_requests(host_lines)
    if n == 0:
        return {"device_token": [], "mtype": [], "alert_type": []}, host
    return {
        "device_token": tokens,
        "event_type": kinds[:n],
        "ts_s": ts_s[:n], "ts_ns": ts_ns[:n],
        "mtype": names,
        "value": value[:n],
        "lat": lat[:n], "lon": lon[:n], "elevation": elev[:n],
        "alert_type": alert_types,
        "alert_level": level[:n],
        "update_state": us[:n],
    }, host


def _native_decode(
    payload: bytes,
    copied: Optional[CopyTally] = None,
) -> Optional[Tuple[Dict[str, object], List[DecodedRequest]]]:
    """The C lanes for NDJSON event payloads: measurements, locations and
    alerts in any mix, registration lines split out for the host-plane
    path.

    Strictness contract (``swwire.c``): any deviation from the supported
    shapes returns None and the pure-Python lane takes over; the C lanes
    only accelerate, they never change behavior.  A registration line the
    scanner accepted but ``json.loads`` rejects dead-letters the whole
    payload, as on the pure-Python lane.
    """
    from sitewhere_tpu_torch.native import load_swwire

    if not fill_direct_ready(payload):
        return None
    mod = load_swwire()
    # Homogeneous measurement payloads go through the specialized scanner
    # (about 2x the generic one); it bails within the first divergent
    # line, so trying it first costs mixed payloads almost nothing.
    meas = mod.decode_measurement_lines(payload)
    if meas is not None:
        tokens, names, values_b, ts_b, us_b = meas
        n = len(tokens)
        if n == 0:
            return None  # keep the pure-Python lane's empty-payload error
        if copied is not None:
            copied.add(len(values_b) + len(ts_b) + len(us_b)
                       + 4 * n + n + _SPLIT_EPOCH_BYTES_PER_ROW * n)
        ts_s, ts_ns = _split_epoch(np.frombuffer(ts_b, np.float64))
        zeros = np.zeros(n, np.float32)
        return {
            "device_token": tokens,
            "event_type": np.zeros(n, np.int32),  # all MEASUREMENT
            "ts_s": ts_s, "ts_ns": ts_ns,
            "mtype": names,
            "value": np.frombuffer(values_b, np.float64).astype(np.float32),
            "lat": zeros, "lon": zeros, "elevation": zeros,
            "alert_type": [None] * n,
            "alert_level": np.zeros(n, np.int32),
            "update_state": np.frombuffer(us_b, np.uint8).astype(np.bool_),
        }, []
    filled = _native_decode_events_into(mod, payload)
    if filled is not None:
        return filled
    out = mod.decode_event_lines(payload)
    if out is None:
        return None
    (tokens, kinds_b, names, alert_types, values_b, ts_b, lat_b, lon_b,
     elev_b, lvl_b, us_b, host_lines) = out
    n = len(tokens)
    if n == 0 and not host_lines:
        return None  # keep the pure-Python lane's empty-payload error
    host = _host_requests(host_lines)
    if n == 0:
        return {"device_token": [], "mtype": [], "alert_type": []}, host
    if copied is not None:
        copied.add(len(kinds_b) + len(values_b) + len(ts_b) + len(lat_b)
                   + len(lon_b) + len(elev_b) + len(lvl_b) + len(us_b)
                   + 4 * n * 6 + n + _SPLIT_EPOCH_BYTES_PER_ROW * n)
    ts_s, ts_ns = _split_epoch(np.frombuffer(ts_b, np.float64))
    columns: Dict[str, object] = {
        "device_token": tokens,
        "event_type": np.frombuffer(kinds_b, np.uint8).astype(np.int32),
        "ts_s": ts_s.astype(np.int32),
        "ts_ns": ts_ns.astype(np.int32),
        "mtype": names,
        "value": np.frombuffer(values_b, np.float64).astype(np.float32),
        "lat": np.frombuffer(lat_b, np.float64).astype(np.float32),
        "lon": np.frombuffer(lon_b, np.float64).astype(np.float32),
        "elevation": np.frombuffer(elev_b, np.float64).astype(np.float32),
        "alert_type": alert_types,
        "alert_level": np.frombuffer(lvl_b, np.int32).copy(),
        "update_state": np.frombuffer(us_b, np.uint8).astype(np.bool_),
    }
    return columns, host


def _decode_lines_inner(
    docs: List[dict],
) -> Tuple[Dict[str, object], List[DecodedRequest]]:
    # Fast extraction: comprehensions with exception fallback to the
    # generic per-line loop (hardwareId alias, host-plane lines,
    # malformed-line diagnostics).
    try:
        tokens = [d["deviceToken"] for d in docs]
        kind_names = [d["type"] for d in docs]
        reqs = [d["request"] for d in docs]
        kinds = [_KIND_EXACT.get(k, _MISS) for k in kind_names]
    except (TypeError, KeyError):
        return _decode_generic(docs)
    if _MISS in kinds:
        kinds = [
            (k if k is not _MISS
             else _TYPE_ALIASES.get(str(raw).strip().lower()))
            for k, raw in zip(kinds, kind_names)
        ]
    if None in kinds or any(int(k) not in _EVENT_KINDS for k in kinds) \
            or not all(type(r) is dict for r in reqs) \
            or not all(type(t) is str and t for t in tokens):
        return _decode_generic(docs)

    n = len(docs)
    ts_s, ts_ns = _ts_columns(reqs)
    event_type = np.fromiter(map(int, kinds), np.int32, n)
    update_state = np.fromiter(
        (r.get("updateState", True) for r in reqs), np.bool_, n)

    first = kinds[0]
    if first == RequestKind.MEASUREMENT and kinds.count(first) == n:
        # homogeneous measurement payload: the dominant fleet shape
        try:
            values = np.fromiter((r["value"] for r in reqs), np.float32, n)
        except KeyError:
            raise DecodeError("measurement needs name+value") from None
        mtypes = [r.get("name") or r.get("measurementId") for r in reqs]
        if None in mtypes:
            raise DecodeError("measurement needs name+value")
        zeros = np.zeros(n, np.float32)
        columns: Dict[str, object] = {
            "device_token": tokens,
            "event_type": event_type,
            "ts_s": ts_s, "ts_ns": ts_ns,
            "mtype": mtypes, "value": values,
            "lat": zeros, "lon": zeros, "elevation": zeros,
            "alert_type": [None] * n,
            "alert_level": np.zeros(n, np.int32),
            "update_state": update_state,
        }
        return columns, []
    if first == RequestKind.LOCATION and kinds.count(first) == n:
        try:
            lats = np.fromiter((r["latitude"] for r in reqs), np.float32, n)
            lons = np.fromiter((r["longitude"] for r in reqs), np.float32, n)
        except KeyError as e:
            raise DecodeError(f"location missing {e}") from None
        elevs = np.fromiter(
            (r.get("elevation", 0.0) for r in reqs), np.float32, n)
        columns = {
            "device_token": tokens,
            "event_type": event_type,
            "ts_s": ts_s, "ts_ns": ts_ns,
            "mtype": [None] * n, "value": np.zeros(n, np.float32),
            "lat": lats, "lon": lons, "elevation": elevs,
            "alert_type": [None] * n,
            "alert_level": np.zeros(n, np.int32),
            "update_state": update_state,
        }
        return columns, []

    # mixed-kind payload: per-row extraction
    return _decode_mixed(tokens, kinds, reqs, ts_s, ts_ns, event_type,
                         update_state)


def _ts_columns(reqs: List[dict]) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized eventDate/timestamp -> (ts_s, ts_ns); per-row fallback
    for ISO strings (same aliases as the scalar ``_decode_one``)."""
    n = len(reqs)
    try:
        raw = np.fromiter(
            (r.get("eventDate") or r.get("timestamp") or 0 for r in reqs),
            np.float64, n)
    except (TypeError, ValueError):
        pairs = [_parse_ts(r.get("eventDate", r.get("timestamp")))
                 for r in reqs]
        return (np.fromiter((p[0] for p in pairs), np.int32, n),
                np.fromiter((p[1] for p in pairs), np.int32, n))
    return _split_epoch(raw)


def _split_epoch(raw: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """float64 epoch -> (ts_s, ts_ns) split (millis heuristic)."""
    if not np.isfinite(raw).all():
        # json.loads parses "1e999" (and the Infinity/NaN literals) to
        # non-finite floats; the scalar path's int(inf) is a decode
        # error, so the columnar path dead-letters too
        raise DecodeError("non-finite eventDate/timestamp")
    raw = np.where(raw > 1e11, raw / 1e3, raw)  # epoch millis
    if ((raw >= float(1 << 31)) | (raw <= -float(1 << 31) - 1.0)).any():
        # int32 epoch-seconds schema: reject instead of truncating; the
        # bound mirrors the scalar path's truncate-toward-zero int(value)
        # + [-2^31, 2^31) check exactly
        raise DecodeError("eventDate out of range")
    ts_s = raw.astype(np.int64)
    ts_ns = np.round((raw - ts_s) * 1e9).astype(np.int64)
    return ts_s.astype(np.int32), ts_ns.astype(np.int32)


def _decode_mixed(tokens, kinds, reqs, ts_s, ts_ns, event_type,
                  update_state) -> Tuple[Dict[str, object],
                                         List[DecodedRequest]]:
    n = len(tokens)
    mtypes: List[Optional[str]] = []
    values = np.zeros(n, np.float32)
    alert_types: List[Optional[str]] = []
    alert_levels = np.zeros(n, np.int32)
    lats = np.zeros(n, np.float32)
    lons = np.zeros(n, np.float32)
    elevs = np.zeros(n, np.float32)
    origins: List[Optional[str]] = []  # invocation-token correlation
    for i, (kind, r) in enumerate(zip(kinds, reqs)):
        # touches only the fields the kind carries
        if kind == RequestKind.MEASUREMENT:
            # `or` (not get-with-default): an empty name falls through to
            # the alias, as on the fast path
            name = r.get("name") or r.get("measurementId")
            if not name or "value" not in r:
                raise DecodeError("measurement needs name+value")
            mtypes.append(str(name))
            values[i] = float(r["value"])
            alert_types.append(None)
            origins.append(None)
        elif kind == RequestKind.LOCATION:
            try:
                lats[i] = float(r["latitude"])
                lons[i] = float(r["longitude"])
            except KeyError as e:
                raise DecodeError(f"location missing {e}") from e
            elevs[i] = float(r.get("elevation", 0.0))
            mtypes.append(None)
            alert_types.append(None)
            origins.append(None)
        elif kind == RequestKind.ALERT:
            # the scalar decoder's semantics: missing type defaults to
            # "alert", an unknown string level is a decode error
            alert_types.append(str(r.get("type",
                                         r.get("alertType", "alert"))))
            level = r.get("level", "info")
            if isinstance(level, str):
                lv = _LEVEL_ALIASES.get(level.lower())
                if lv is None:
                    raise DecodeError(f"bad alert level {level!r}")
                level = lv
            alert_levels[i] = int(level)
            mtypes.append(None)
            origins.append(None)
            if "latitude" in r and "longitude" in r:
                lats[i] = float(r["latitude"])
                lons[i] = float(r["longitude"])
        else:
            # COMMAND_INVOCATION / COMMAND_RESPONSE / STATE_CHANGE rows:
            # only the correlation token beyond type + timestamp
            mtypes.append(None)
            alert_types.append(None)
            if kind == RequestKind.COMMAND_RESPONSE:
                origins.append(r.get("originatingEventId"))
            elif kind == RequestKind.COMMAND_INVOCATION:
                origins.append(r.get("invocationToken"))
            else:
                origins.append(None)

    columns: Dict[str, object] = {
        "device_token": tokens,
        "event_type": event_type,
        "ts_s": ts_s, "ts_ns": ts_ns,
        "mtype": mtypes, "value": values,
        "lat": lats, "lon": lons, "elevation": elevs,
        "alert_type": alert_types,
        "alert_level": alert_levels,
        "update_state": update_state,
    }
    if any(o is not None for o in origins):
        columns["origin"] = origins
    return columns, []


def _decode_generic(docs) -> Tuple[Dict[str, object], List[DecodedRequest]]:
    """Slow path: hardwareId alias, host-plane lines, full diagnostics."""
    events: List[tuple] = []
    host: List[DecodedRequest] = []
    for doc in docs:
        token, kind_name, req = envelope_fields(doc)
        kind = _TYPE_ALIASES.get(kind_name.strip().lower())
        if kind is None:
            raise DecodeError(f"unknown request type {kind_name!r}")
        if int(kind) in _EVENT_KINDS:
            events.append((token, kind, req))
        else:
            host.append(_decode_one(token, kind_name, req))

    if not events:
        return {"device_token": [], "mtype": [], "alert_type": []}, host
    tokens = [t for t, _, _ in events]
    kinds = [k for _, k, _ in events]
    reqs = [r for _, _, r in events]
    n = len(events)
    ts_s, ts_ns = _ts_columns(reqs)
    event_type = np.fromiter(map(int, kinds), np.int32, n)
    update_state = np.fromiter(
        (r.get("updateState", True) for r in reqs), np.bool_, n)
    columns, _ = _decode_mixed(tokens, kinds, reqs, ts_s, ts_ns,
                               event_type, update_state)
    return columns, host


def resolve_columns(
    columns: Dict[str, object],
    resolve_device,
    resolve_mtype,
    resolve_alert,
    invocations=None,
) -> Dict[str, np.ndarray]:
    """Map token/name columns to dense handles -> batcher-ready arrays.

    Device tokens resolve through the HandleSpace's bulk lookup when the
    resolver is one (one comprehension instead of a Python callable per
    token); name columns memoize per payload (a fleet payload carries a
    handful of measurement names).  Columns the C resolved scanner
    already mapped (``device_id``, ``alert_code``, ``mtype_uniq`` /
    ``mtype_idx``) pass through; only the distinct names are minted here.
    """
    n = n_rows(columns)
    out: Dict[str, np.ndarray] = {
        k: columns[k]
        for k in ("event_type", "ts_s", "ts_ns", "value", "lat", "lon",
                  "elevation", "alert_level", "update_state")
    }
    if "device_id" in columns:
        out["device_id"] = np.asarray(columns["device_id"], np.int32)
    else:
        tokens = columns["device_token"]
        owner = space_of(resolve_device)
        if owner is not None:
            out["device_id"] = np.asarray(owner.lookup_many(tokens),
                                          np.int32)
        else:
            out["device_id"] = np.fromiter(
                (resolve_device(t) for t in tokens), np.int32, n)

    def memoized(names, resolve) -> np.ndarray:
        mapping = {
            m: (NULL_ID if m is None else resolve(m)) for m in set(names)
        }
        return np.asarray([mapping[m] for m in names], np.int32)

    if "mtype_uniq" in columns:
        uniq_ids = np.asarray(
            [resolve_mtype(u) for u in columns["mtype_uniq"]], np.int32)
        out["mtype_id"] = (uniq_ids[columns["mtype_idx"]] if len(uniq_ids)
                           else np.full(n, NULL_ID, np.int32))
    else:
        out["mtype_id"] = memoized(columns["mtype"], resolve_mtype)
    if "alert_code" in columns:
        out["alert_code"] = np.asarray(columns["alert_code"], np.int32)
    else:
        out["alert_code"] = memoized(columns["alert_type"], resolve_alert)
    origins = columns.get("origin")
    if origins is not None and invocations is not None:
        et = np.asarray(columns["event_type"])
        cid = np.full(n, NULL_ID, np.int32)
        for i, tok in enumerate(origins):
            if tok:
                # invocations MINT their token; responses only LOOK UP,
                # so an unknown token stays uncorrelated instead of
                # allocating a handle
                cid[i] = (invocations.mint(tok)
                          if et[i] == int(EventType.COMMAND_INVOCATION)
                          else invocations.lookup(tok))
        out["command_id"] = cid
    return out
