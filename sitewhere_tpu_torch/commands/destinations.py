"""Command destinations: encoder × parameter extractor × delivery provider.

Counterpart of ``sitewhere_tpu/commands/destinations.py``, whole.

Reference: ``ICommandDestination`` composes exactly these three SPIs
(``service-command-delivery/.../destination/mqtt/MqttCommandDestination.java``
+ ``MqttParameterExtractor`` computing a per-device topic +
``MqttCommandDeliveryProvider`` publishing).  CoAP delivery speaks RFC
7252 directly (:class:`CoapDeliveryProvider`); SMS delivery
(``twilio/TwilioCommandDeliveryProvider.java`` — an HTTPS POST of form
fields to a gateway) generalizes to :class:`HttpDeliveryProvider` +
:class:`SmsParameterExtractor`; anything else plugs in through
:class:`CallbackDeliveryProvider`.
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, Dict, Optional

from sitewhere_tpu_torch.commands.model import CommandExecution
from sitewhere_tpu_torch.runtime import faults
from sitewhere_tpu_torch.runtime.lifecycle import LifecycleComponent
from sitewhere_tpu_torch.runtime.resilience import (
    RetriesExhausted,
    RetryPolicy,
    call_with_retry,
)
from sitewhere_tpu_torch.services.common import ServiceError

logger = logging.getLogger("sitewhere_tpu_torch.commands")


class DeliveryError(ServiceError):
    """Transport-level delivery failure → undelivered dead-letter."""


def _placeholder_fields(execution: CommandExecution) -> Dict[str, str]:
    """The shared ``{device}``/``{tenant}``/``{type}`` pattern vocabulary
    (one place — the MQTT and CoAP extractors must not diverge)."""
    inv = execution.invocation
    return {
        "device": inv.device_token or "",
        "tenant": inv.tenant or "",
        "type": inv.device_type_token or "",
    }


class TopicParameterExtractor:
    """Per-device delivery parameters from a topic pattern.

    Reference: ``MqttParameterExtractor`` expands command/system topic
    patterns with the device's hardware id.  Placeholders: ``{device}``,
    ``{tenant}``, ``{type}``.
    """

    def __init__(
        self,
        command_topic: str = "sitewhere/command/{device}",
        system_topic: str = "sitewhere/system/{device}",
    ):
        self.command_topic = command_topic
        self.system_topic = system_topic

    def __call__(self, execution: CommandExecution) -> Dict[str, str]:
        fields = _placeholder_fields(execution)
        return {
            "topic": self.command_topic.format(**fields),
            "system_topic": self.system_topic.format(**fields),
        }


class MqttDeliveryProvider(LifecycleComponent):
    """Publish encoded executions to a broker topic.

    Reference: ``MqttCommandDeliveryProvider`` over the shared
    ``MqttLifecycleComponent``; here over
    :class:`sitewhere_tpu_torch.ingest.mqtt.MqttClient`.
    """

    def __init__(self, host: str, port: int = 1883, qos: int = 0, client=None):
        super().__init__("mqtt-delivery")
        self.host = host
        self.port = port
        self.qos = qos
        self._client = client  # injectable for tests
        self._lock = threading.Lock()

    def start(self) -> None:
        super().start()
        if self._client is None:
            from sitewhere_tpu_torch.ingest.mqtt import MqttClient

            self._client = MqttClient(self.host, self.port)
            self._client.connect()

    def stop(self) -> None:
        if self._client is not None:
            try:
                self._client.disconnect()
            except Exception:
                pass
            self._client = None
        super().stop()

    def deliver(self, execution: CommandExecution, payload: bytes, params: Dict[str, str]) -> None:
        if self._client is None:
            raise DeliveryError("mqtt delivery provider not started")
        try:
            with self._lock:
                self._client.publish(params["topic"], payload, qos=self.qos)
        except Exception as e:
            raise DeliveryError(f"mqtt publish failed: {e}") from e


class CoapParameterExtractor:
    """Per-device CoAP endpoint parameters.

    Reference: ``destination/coap/MetadataCoapParameterExtractor.java`` —
    host/port come from device metadata with configured defaults; the
    URI path is a pattern (``{device}``/``{tenant}``/``{type}``).
    """

    def __init__(self, default_host: str = "127.0.0.1",
                 default_port: int = 5683,
                 path: str = "commands/{device}",
                 metadata_host_key: str = "coap_host",
                 metadata_port_key: str = "coap_port"):
        self.default_host = default_host
        self.default_port = default_port
        self.path = path
        self.metadata_host_key = metadata_host_key
        self.metadata_port_key = metadata_port_key

    def __call__(self, execution: CommandExecution) -> Dict[str, str]:
        meta = dict(execution.device_metadata or {})
        return {
            "host": str(meta.get(self.metadata_host_key, self.default_host)),
            "port": str(meta.get(self.metadata_port_key, self.default_port)),
            "path": self.path.format(**_placeholder_fields(execution)),
        }


class CoapDeliveryProvider(LifecycleComponent):
    """POST encoded executions to the device's CoAP endpoint (RFC 7252
    confirmable exchange with client-side retransmission).

    Reference: ``destination/coap/CoapCommandDeliveryProvider.java``
    (Californium client).  Here the from-scratch codec in
    :mod:`sitewhere_tpu_torch.ingest.coap` does the framing; CON requests
    retransmit on the RFC schedule (ACK_TIMEOUT 2s doubling,
    MAX_RETRANSMIT 4) and an RST or 4.xx/5.xx response is a delivery
    failure → undelivered dead-letter.
    """

    def __init__(self, ack_timeout_s: float = 2.0, max_retransmit: int = 4,
                 max_wait_s: float = 30.0):
        super().__init__("coap-delivery")
        self.ack_timeout_s = ack_timeout_s
        self.max_retransmit = max_retransmit
        # total exchange budget (caps the RFC 2+4+8+16+32s worst case so
        # one dead endpoint can't stall a command batch for a minute;
        # MAX_TRANSMIT_WAIT-style bound)
        self.max_wait_s = max_wait_s
        self._lock = threading.Lock()
        import random as _random

        # RFC 7252 §4.4: start message ids unpredictably
        self._message_id = _random.SystemRandom().getrandbits(16)

    def _next_mid(self) -> int:
        with self._lock:
            self._message_id = (self._message_id + 1) & 0xFFFF
            return self._message_id

    @staticmethod
    def _check_code(reply) -> None:
        code_class = reply.code >> 5
        if code_class in (4, 5):
            raise DeliveryError(
                f"coap error {code_class}.{reply.code & 0x1F:02d}")

    def deliver(self, execution: CommandExecution, payload: bytes,
                params: Dict[str, str]) -> None:
        import os
        import socket
        import time as _time

        from sitewhere_tpu_torch.ingest import coap

        host = params["host"]
        port = int(params["port"])
        mid = self._next_mid()
        token = os.urandom(4)
        datagram = coap.encode_post(params.get("path", ""), payload,
                                    message_id=mid, confirmable=True,
                                    token=token)
        sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            # connect() makes the kernel drop datagrams from other
            # sources — a stray peer can't fail or fake the exchange
            sock.connect((host, port))
            deadline_total = _time.monotonic() + self.max_wait_s
            timeout = self.ack_timeout_s
            for _ in range(self.max_retransmit + 1):
                try:
                    sock.send(datagram)
                except OSError as e:
                    raise DeliveryError(f"coap send failed: {e}") from e
                attempt_deadline = min(
                    _time.monotonic() + timeout, deadline_total)
                separate = False  # empty ACK seen; response comes later
                while True:
                    remaining = attempt_deadline - _time.monotonic()
                    if remaining <= 0:
                        break
                    sock.settimeout(remaining)
                    try:
                        data = sock.recv(65536)
                    except socket.timeout:
                        break
                    except OSError as e:
                        raise DeliveryError(f"coap recv failed: {e}") from e
                    try:
                        reply = coap.parse_message(data)
                    except coap.CoapError:
                        continue  # garbled datagram: keep waiting
                    if reply.mtype == coap.RST and reply.message_id == mid:
                        raise DeliveryError(
                            "coap endpoint reset the exchange")
                    if reply.mtype == coap.ACK and reply.message_id == mid:
                        if reply.code == 0:
                            # §5.2.2 separate response: the real reply
                            # arrives as a CON/NON with our token — wait
                            # out the remaining total budget
                            separate = True
                            attempt_deadline = deadline_total
                            continue
                        self._check_code(reply)
                        return
                    if reply.mtype in (coap.CON, coap.NON) \
                            and reply.token == token:
                        if reply.mtype == coap.CON:
                            # acknowledge the separate response so the
                            # device stops retransmitting it
                            try:
                                sock.send(coap.encode_message(
                                    coap.CoapMessage(
                                        mtype=coap.ACK, code=0,
                                        message_id=reply.message_id)))
                            except OSError:
                                pass
                        self._check_code(reply)
                        return
                    # unrelated datagram: ignore without consuming the
                    # retransmit budget
                if separate:
                    # request WAS acknowledged — retransmitting would be
                    # a protocol violation; the response just never came
                    raise DeliveryError(
                        "coap separate response never arrived")
                if _time.monotonic() >= deadline_total:
                    break
                timeout *= 2  # RFC 7252 §4.2 exponential backoff
            raise DeliveryError(
                f"coap delivery timed out (budget {self.max_wait_s}s, "
                f"{self.max_retransmit + 1} attempts)")
        finally:
            sock.close()


class SmsParameterExtractor:
    """Per-device SMS parameters (destination phone number).

    Reference: ``destination/sms/SmsParameterExtractor.java`` — the
    phone number comes from device metadata.  Executions for devices
    without one fail delivery (→ undelivered dead-letter), matching the
    reference's null-check.
    """

    def __init__(self, metadata_phone_key: str = "phone_number"):
        self.metadata_phone_key = metadata_phone_key

    def __call__(self, execution: CommandExecution) -> Dict[str, str]:
        meta = dict(execution.device_metadata or {})
        phone = str(meta.get(self.metadata_phone_key, "")).strip()
        fields = _placeholder_fields(execution)
        return {"phone": phone, "device": fields["device"]}


class HttpDeliveryProvider(LifecycleComponent):
    """Deliver encoded executions by POSTing to an HTTP gateway.

    Reference: ``twilio/TwilioCommandDeliveryProvider.java`` — Twilio SMS
    delivery is an HTTPS POST of (from, to, body) form fields to an
    account endpoint.  This provider generalizes that shape: form fields
    come from a template over the extractor's params plus the payload, so
    any SMS/webhook gateway (Twilio-compatible or otherwise) plugs in via
    config rather than code.  A missing required param (e.g. no phone
    number in device metadata) or an HTTP error status raises
    :class:`DeliveryError` → undelivered dead-letter.
    """

    def __init__(
        self,
        url: str,
        field_map: Optional[Dict[str, str]] = None,
        headers: Optional[Dict[str, str]] = None,
        require: tuple = ("phone",),
        timeout_s: float = 10.0,
        name: str = "http-delivery",
    ):
        super().__init__(name)
        from urllib.parse import urlsplit

        parts = urlsplit(url)
        if parts.scheme not in ("http", "https"):
            raise ValueError(f"unsupported gateway scheme: {parts.scheme!r}")
        self._scheme = parts.scheme
        self._netloc = parts.netloc
        self._path = (parts.path or "/") + (
            "?" + parts.query if parts.query else "")
        # each value is a str.format template over params ∪ {payload}
        self.field_map = dict(field_map or {"To": "{phone}", "Body": "{payload}"})
        self.headers = dict(headers or {})
        self.require = tuple(require)
        self.timeout_s = timeout_s

    def deliver(self, execution: CommandExecution, payload: bytes,
                params: Dict[str, str]) -> None:
        import http.client
        from urllib.parse import urlencode

        for key in self.require:
            if not params.get(key):
                raise DeliveryError(
                    f"missing delivery parameter {key!r} "
                    f"(device metadata incomplete)")
        fields = dict(params)
        fields["payload"] = payload.decode("utf-8", "replace")
        body = urlencode(
            {k: v.format(**fields) for k, v in self.field_map.items()})
        headers = {
            "Content-Type": "application/x-www-form-urlencoded",
            **self.headers,
        }
        cls = (http.client.HTTPSConnection if self._scheme == "https"
               else http.client.HTTPConnection)
        conn = cls(self._netloc, timeout=self.timeout_s)
        try:
            conn.request("POST", self._path, body=body.encode(), headers=headers)
            resp = conn.getresponse()
            resp.read()
            # only 2xx is delivery: redirects are not followed, so a 3xx
            # means the gateway never got the command
            if not 200 <= resp.status < 300:
                raise DeliveryError(f"gateway returned {resp.status}")
        except DeliveryError:
            raise
        except Exception as e:
            raise DeliveryError(f"gateway POST failed: {e}") from e
        finally:
            conn.close()


class CallbackDeliveryProvider:
    """Deliver through any callable — the plug-in point for transports
    whose client libraries aren't in this image (Twilio SMS)."""

    def __init__(self, fn: Callable[[CommandExecution, bytes, Dict[str, str]], None]):
        self.fn = fn

    def deliver(self, execution: CommandExecution, payload: bytes, params: Dict[str, str]) -> None:
        try:
            self.fn(execution, payload, params)
        except Exception as e:
            raise DeliveryError(str(e)) from e


class CommandDestination:
    """One named delivery path: encode → extract params → deliver.

    ``retry`` (a :class:`~sitewhere_tpu_torch.runtime.resilience.RetryPolicy`)
    re-attempts TRANSIENT :class:`DeliveryError` s before the processor
    dead-letters the invocation — e.g. an MQTT broker mid-reconnect.
    Default is no retry (CoAP already retransmits on the RFC 7252
    schedule; double-retrying a confirmable exchange would violate it).
    """

    def __init__(
        self,
        destination_id: str,
        encoder: Callable[[CommandExecution], bytes],
        extractor: Callable[[CommandExecution], Dict[str, str]],
        provider,
        retry: Optional[RetryPolicy] = None,
    ):
        self.destination_id = destination_id
        self.encoder = encoder
        self.extractor = extractor
        self.provider = provider
        self.retry = retry

    def _deliver_once(self, execution: CommandExecution, payload: bytes,
                      params: Dict[str, str]) -> None:
        faults.fire("commands.deliver")
        self.provider.deliver(execution, payload, params)

    def deliver(self, execution: CommandExecution) -> None:
        payload = self.encoder(execution)
        params = self.extractor(execution)
        if self.retry is None:
            self._deliver_once(execution, payload, params)
            return
        try:
            call_with_retry(
                lambda: self._deliver_once(execution, payload, params),
                self.retry, retry_on=(DeliveryError,),
                name=f"commands.{self.destination_id}")
        except RetriesExhausted as e:
            # surface the underlying transport failure to the processor's
            # undelivered dead-letter path, with the retry context
            raise DeliveryError(
                f"{e} (last: {e.__cause__})") from e.__cause__
