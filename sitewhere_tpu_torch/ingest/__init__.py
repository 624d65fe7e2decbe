"""Host-side ingest: protocol frontends → decode → dedupe → batch → journal.

Replaces the reference's ``service-event-sources`` (receivers + decoders +
deduplicators, ``sources/InboundEventSource.java:35-309``) and the Kafka
durability layer (``MicroserviceKafkaProducer/Consumer``): events enter via
protocol frontends, are decoded to typed requests, deduplicated, appended to
a durable journal with offsets (the Kafka-topic analog), and assembled into
fixed-shape :class:`~sitewhere_tpu_torch.schema.EventBatch` tensors routed by
owning shard for the SPMD pipeline step.

Counterpart of ``sitewhere_tpu/ingest/__init__.py``: the same exports.
"""

from sitewhere_tpu_torch.ingest.journal import Journal, JournalReader  # noqa: F401
from sitewhere_tpu_torch.ingest.decoders import (  # noqa: F401
    DecodedRequest,
    RequestKind,
    JsonDecoder,
    JsonBatchDecoder,
    BinaryDecoder,
    CompositeDecoder,
    DecodeError,
    JsonLinesDecoder,
)
from sitewhere_tpu_torch.ingest.dedup import AlternateIdDeduplicator  # noqa: F401
from sitewhere_tpu_torch.ingest.coap import CoapServerReceiver  # noqa: F401
from sitewhere_tpu_torch.ingest.amqp import AmqpReceiver  # noqa: F401
from sitewhere_tpu_torch.ingest.stomp import StompReceiver  # noqa: F401
from sitewhere_tpu_torch.ingest.columnar import decode_json_lines  # noqa: F401
from sitewhere_tpu_torch.ingest.batcher import Batcher, BatchPlan  # noqa: F401
