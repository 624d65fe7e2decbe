"""Command execution encoders — bytes on the wire to the device.

Counterpart of ``sitewhere_tpu/commands/encoders.py``, whole.

Reference: ``service-command-delivery/.../encoding/`` offers a protobuf
encoder whose message schema is built *at runtime from the device type's
command specs* (``ProtobufExecutionEncoder.java`` using
``sitewhere-communication/.../protobuf/DeviceTypeProtoBuilder.java:27`` —
a ``DescriptorProto`` assembled from data), plus JSON and Java-hybrid
encoders.  Here:

- :class:`JsonCommandEncoder` — self-describing JSON (the JSON encoder
  analog; also the fixture format of the reference's MQTT tests).
- :class:`BinaryCommandEncoder` — compact tag/length/varint wire format
  derived from the command's declared parameter list, implementing the
  runtime-schema-from-device-type semantic without a protoc dependency.
  Layout: header ``magic u8, version u8, command-name str, namespace str,
  invocation-token str, param-count varint`` then per parameter
  ``name str, type u8, value`` (varint/zigzag for ints+bool, f64 LE for
  double, length-prefixed UTF-8 for string/bytes).  Strings are
  ``varint length + bytes``.
"""

from __future__ import annotations

import base64
import json
import struct
from typing import Tuple

from sitewhere_tpu_torch.commands.model import CommandExecution
from sitewhere_tpu_torch.services.common import ValidationError

_MAGIC = 0xC7
_VERSION = 1
_TYPE_CODES = {"string": 0, "double": 1, "int32": 2, "int64": 3, "bool": 4, "bytes": 5}
_TYPE_NAMES = {v: k for k, v in _TYPE_CODES.items()}


class JsonCommandEncoder:
    """Self-describing JSON encoding of an execution."""

    content_type = "application/json"

    def __call__(self, execution: CommandExecution) -> bytes:
        doc = {
            "invocation": execution.invocation.token,
            "command": execution.command_name,
            "namespace": execution.namespace,
            "parameters": {
                # bytes params ride as base64 (JSON has no binary type).
                name: (
                    base64.b64encode(bytes(value)).decode("ascii")
                    if _type == "bytes"
                    else value
                )
                for (name, _type, value) in execution.parameters
            },
        }
        return json.dumps(doc, sort_keys=True).encode("utf-8")


def _varint(n: int) -> bytes:
    if n < 0:
        raise ValidationError("varint requires non-negative")
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _zigzag(n: int) -> int:
    if not -(1 << 63) <= n < (1 << 63):
        raise ValidationError(f"integer {n} outside int64 range")
    return (n << 1) ^ (n >> 63) if n < 0 else n << 1


def _unzigzag(n: int) -> int:
    return (n >> 1) ^ -(n & 1)


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    shift = 0
    result = 0
    while True:
        if pos >= len(buf):
            raise ValidationError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _put_str(s: str) -> bytes:
    raw = s.encode("utf-8")
    return _varint(len(raw)) + raw


def _read_str(buf: bytes, pos: int) -> Tuple[str, int]:
    n, pos = _read_varint(buf, pos)
    if pos + n > len(buf):
        raise ValidationError("truncated string")
    return buf[pos : pos + n].decode("utf-8"), pos + n


class BinaryCommandEncoder:
    """Schema-derived compact binary encoding (see module docstring)."""

    content_type = "application/octet-stream"

    def __call__(self, execution: CommandExecution) -> bytes:
        out = bytearray((_MAGIC, _VERSION))
        out += _put_str(execution.command_name)
        out += _put_str(execution.namespace)
        out += _put_str(execution.invocation.token)
        out += _varint(len(execution.parameters))
        for name, ptype, value in execution.parameters:
            if ptype not in _TYPE_CODES:
                raise ValidationError(f"unknown parameter type {ptype}")
            out += _put_str(name)
            out.append(_TYPE_CODES[ptype])
            if ptype == "string":
                out += _put_str(str(value))
            elif ptype == "bytes":
                raw = bytes(value)
                out += _varint(len(raw)) + raw
            elif ptype == "double":
                out += struct.pack("<d", float(value))
            elif ptype == "bool":
                out += _varint(1 if value else 0)
            else:  # int32 / int64
                out += _varint(_zigzag(int(value)))
        return bytes(out)


def decode_binary_execution(payload: bytes) -> dict:
    """Device-side decode of :class:`BinaryCommandEncoder` output (used by
    tests and the reference-style conformance fixtures)."""
    if len(payload) < 2 or payload[0] != _MAGIC:
        raise ValidationError("bad magic")
    if payload[1] != _VERSION:
        raise ValidationError(f"unsupported version {payload[1]}")
    pos = 2
    command, pos = _read_str(payload, pos)
    namespace, pos = _read_str(payload, pos)
    invocation, pos = _read_str(payload, pos)
    count, pos = _read_varint(payload, pos)
    params = {}
    for _ in range(count):
        name, pos = _read_str(payload, pos)
        if pos >= len(payload):
            raise ValidationError("truncated parameter")
        code = payload[pos]
        pos += 1
        ptype = _TYPE_NAMES.get(code)
        if ptype is None:
            raise ValidationError(f"unknown type code {code}")
        if ptype == "string":
            value, pos = _read_str(payload, pos)
        elif ptype == "bytes":
            n, pos = _read_varint(payload, pos)
            if pos + n > len(payload):
                raise ValidationError("truncated bytes value")
            value = payload[pos : pos + n]
            pos += n
        elif ptype == "double":
            if pos + 8 > len(payload):
                raise ValidationError("truncated double value")
            (value,) = struct.unpack_from("<d", payload, pos)
            pos += 8
        elif ptype == "bool":
            raw, pos = _read_varint(payload, pos)
            value = bool(raw)
        else:
            raw, pos = _read_varint(payload, pos)
            value = _unzigzag(raw)
        params[name] = value
    return {
        "command": command,
        "namespace": namespace,
        "invocation": invocation,
        "parameters": params,
    }
