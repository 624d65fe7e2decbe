"""Config-driven event-source construction (EventSourcesParser analog).

Reference: tenant configuration XML declares each event source — its
receivers, decoder, and deduplicator — and
``spring/EventSourcesParser.java:27-50`` materializes them into the
running engine.  Here the same declaration lives in the instance config
tree::

    "sources": [
        {"id": "wire", "decoder": "json",
         "receivers": [{"type": "tcp", "port": 7011,
                        "framing": "newline"}]},
        {"id": "mq", "decoder": "jsonlines", "dedup": {"window": 65536},
         "receivers": [{"type": "stomp", "host": "broker", "port": 61613,
                        "destination": "/queue/telemetry"}]},
    ]

and :func:`build_sources` materializes :class:`InboundEventSource`
instances the caller attaches via ``Instance.add_source`` (which wires
the dispatcher/forwarder sinks).  Receiver types map to the transports
in :mod:`sitewhere_tpu_torch.ingest.sources` (+ CoAP and STOMP); decoder names
to :mod:`sitewhere_tpu_torch.ingest.decoders`.  Unknown types raise
``ValidationError`` at build time — a config typo must fail boot, not
silently drop a source (the reference's schema-validated XML gives the
same guarantee).

Counterpart of ``sitewhere_tpu/ingest/factory.py``, whole.  The
``Instance`` passes its
:class:`~sitewhere_tpu_torch.runtime.scripting.ScriptManager`, so a
decoder named after an uploaded decoder script resolves to its live
handle (the active version on every call).
"""

from __future__ import annotations

from typing import Dict, List

from sitewhere_tpu_torch.services.common import ValidationError

_FRAMINGS = ("length", "newline")


def _build_receiver(doc: Dict):
    from sitewhere_tpu_torch.ingest import coap, sources, stomp

    if not isinstance(doc, dict):
        raise ValidationError(f"receiver entry must be an object: {doc!r}")
    kind = str(doc.get("type", "")).lower()
    args = {k: v for k, v in doc.items() if k != "type"}
    try:
        if kind == "tcp":
            framing = str(args.pop("framing", "length")).lower()
            if framing not in _FRAMINGS:
                raise ValidationError(
                    f"tcp framing must be one of {_FRAMINGS}: {framing!r}")
            return sources.TcpReceiver(
                host=str(args.pop("host", "127.0.0.1")),
                port=int(args.pop("port", 0)),
                framing=(sources.newline_frames if framing == "newline"
                         else sources.length_prefixed_frames),
                **args)
        if kind == "udp":
            return sources.UdpReceiver(
                host=str(args.pop("host", "127.0.0.1")),
                port=int(args.pop("port", 0)), **args)
        if kind == "http":
            return sources.HttpReceiver(
                host=str(args.pop("host", "127.0.0.1")),
                port=int(args.pop("port", 0)),
                path=str(args.pop("path", "/events")), **args)
        if kind == "mqtt":
            return sources.MqttReceiver(
                host=str(args.pop("host")),
                port=int(args.pop("port", 1883)),
                topic=str(args.pop("topic", "sitewhere/input")), **args)
        if kind in ("mqtt-broker", "hosted-mqtt"):
            # hosts an in-process broker: devices connect directly, no
            # external middleware (ActiveMQBrokerEventReceiver analog)
            from sitewhere_tpu_torch.ingest import mqtt_broker

            return mqtt_broker.MqttBrokerReceiver(
                host=str(args.pop("host", "127.0.0.1")),
                # the conventional MQTT port: devices must be able to
                # find the hosted broker without reading logs (an
                # ephemeral port would move every restart)
                port=int(args.pop("port", 1883)),
                topic_filter=str(args.pop(
                    "topic_filter", "sitewhere/input/#")), **args)
        if kind == "stomp":
            return stomp.StompReceiver(
                host=str(args.pop("host")),
                port=int(args.pop("port", 61613)),
                destination=str(args.pop(
                    "destination", "/queue/sitewhere.input")), **args)
        if kind in ("amqp", "rabbitmq"):
            from sitewhere_tpu_torch.ingest import amqp

            return amqp.AmqpReceiver(
                host=str(args.pop("host")),
                port=int(args.pop("port", 5672)),
                queue=str(args.pop("queue", "sitewhere.input")), **args)
        if kind in ("eventhub", "amqp10"):
            from sitewhere_tpu_torch.ingest import amqp10

            return amqp10.EventHubReceiver(
                host=str(args.pop("host")),
                port=int(args.pop("port", 5672)),
                event_hub=str(args.pop("event_hub", "sitewhere")),
                **args)
        if kind == "coap":
            return coap.CoapServerReceiver(
                host=str(args.pop("host", "127.0.0.1")),
                port=int(args.pop("port", 0)), **args)
        if kind in ("ws", "websocket"):
            return sources.WebSocketReceiver(
                host=str(args.pop("host")),
                port=int(args.pop("port")),
                path=str(args.pop("path", "/")), **args)
        if kind in ("poll", "polling-rest"):
            return sources.PollingRestReceiver(
                url=str(args.pop("url")),
                interval_s=float(args.pop("interval_s", 10.0)), **args)
    except ValidationError:
        raise
    except (KeyError, TypeError, ValueError) as e:
        raise ValidationError(f"bad {kind!r} receiver config: {e}") from e
    raise ValidationError(f"unknown receiver type {doc.get('type')!r}")


def _build_decoder(name: str, scripts=None):
    from sitewhere_tpu_torch.ingest import decoders

    key = str(name).lower()
    table = {
        "json": decoders.JsonDecoder,
        "jsonlines": decoders.JsonLinesDecoder,
        "batch": decoders.JsonBatchDecoder,
        "binary": decoders.BinaryDecoder,
    }
    if key in table:
        return table[key]()
    if scripts is not None:
        try:
            meta = scripts.describe(str(name))
        except Exception:
            raise ValidationError(f"unknown decoder {name!r}")
        if meta.get("kind") != "decoder":
            # must fail BOOT: at runtime the kind mismatch would raise
            # past the sources' DecodeError handling into the transport
            # thread, silently losing every payload
            raise ValidationError(
                f"script {name!r} is a {meta.get('kind')}, not a decoder")
        # runtime-uploaded decoder script (ScriptSynchronizer analog):
        # resolves the ACTIVE version on every call, so uploads swap
        # behavior live
        return scripts.as_decoder(str(name))
    raise ValidationError(f"unknown decoder {name!r}")


def build_sources(docs: List[Dict], scripts=None) -> List:
    """Materialize ``InboundEventSource`` objects from config documents."""
    from sitewhere_tpu_torch.ingest.dedup import AlternateIdDeduplicator
    from sitewhere_tpu_torch.ingest.sources import InboundEventSource

    out = []
    for doc in docs or []:
        if not isinstance(doc, dict):
            raise ValidationError(f"source entry must be an object: {doc!r}")
        source_id = str(doc.get("id") or f"source-{len(out)}")
        receivers = [_build_receiver(r) for r in doc.get("receivers", [])]
        if not receivers:
            raise ValidationError(f"source {source_id!r} has no receivers")
        decoder = _build_decoder(doc.get("decoder", "json"), scripts)
        dedup_doc = doc.get("dedup")
        dedup = None
        if dedup_doc is not None:
            if not isinstance(dedup_doc, dict):
                raise ValidationError(
                    f"dedup must be an object: {dedup_doc!r}")
            unknown = set(dedup_doc) - {"window"}
            if unknown:
                raise ValidationError(
                    f"unknown dedup option(s): {sorted(unknown)}")
            dedup = AlternateIdDeduplicator(
                window=int(dedup_doc.get("window", 1 << 20)))
        raw_wire = bool(doc.get("raw_wire", False))
        if raw_wire and dedup is not None:
            # must fail BOOT: the raw lane never consults the
            # deduplicator, so accepting both would silently disable a
            # configured dedup window
            raise ValidationError(
                f"source {source_id!r}: raw_wire bypasses the decoder "
                "and dedup — remove the dedup block or raw_wire")
        if raw_wire and str(doc.get("decoder", "json")).lower() not in (
                "json", "jsonlines", "batch"):
            # same principle for the decoder: the raw lane feeds payloads
            # to the NDJSON columnar decode (which also accepts single
            # envelopes and JSON arrays — the json/jsonlines/batch wire
            # shapes), so a binary or script decoder here would be
            # silently disabled and every payload would dead-letter
            raise ValidationError(
                f"source {source_id!r}: raw_wire handles JSON wire "
                f"shapes only — decoder {doc.get('decoder')!r} would "
                "never run")
        out.append(InboundEventSource(
            source_id, receivers, decoder, deduplicator=dedup,
            raw_wire=raw_wire))
    return out
