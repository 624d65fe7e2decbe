"""Event deduplication at the ingest edge.

Reference: ``IDeviceEventDeduplicator`` implementations —
``deduplicator/AlternateIdDeduplicator.java`` (drop events whose alternate
id already exists in the event store) and ``GroovyEventDeduplicator.java``
(scripted predicate).  Here:

- :class:`AlternateIdDeduplicator` keeps a bounded LRU of recently seen
  alternate-id hashes (the store-lookup becomes an O(1) in-memory check;
  the bound makes memory static, trading exactness beyond the window — the
  journal retains everything for offline exact dedup).
- The Groovy analog is any ``Callable[[DecodedRequest], bool]`` predicate
  (return True = duplicate) plugged into the source.

Counterpart of ``sitewhere_tpu/ingest/dedup.py``, whole.
"""

from __future__ import annotations

from collections import OrderedDict

from sitewhere_tpu_torch.ids import stable_hash64
from sitewhere_tpu_torch.ingest.decoders import DecodedRequest


class AlternateIdDeduplicator:
    """Bounded-LRU alternate-id dedup; thread-compatible (single pump)."""

    def __init__(self, window: int = 1 << 20):
        self.window = window
        self._seen: OrderedDict[int, None] = OrderedDict()
        self.duplicates = 0

    def is_duplicate(self, req: DecodedRequest) -> bool:
        alt = req.alternate_id
        if not alt:
            return False
        key = stable_hash64(f"{req.device_token}\x00{alt}")
        if key in self._seen:
            self._seen.move_to_end(key)
            self.duplicates += 1
            return True
        self._seen[key] = None
        if len(self._seen) > self.window:
            self._seen.popitem(last=False)
        return False

    # -- checkpoint integration (runtime/checkpoint.py) ---------------------

    def export_keys(self) -> list:
        """LRU keys, oldest first — the checkpoint payload.  Hashes only
        (the raw alternate ids were never retained)."""
        return list(self._seen.keys())

    def import_keys(self, keys) -> None:
        """Re-seed the window from exported keys (restore): a restarted
        instance keeps catching duplicates the window had already seen
        instead of re-admitting them until the LRU refills."""
        self._seen.clear()
        for key in keys[-self.window:]:
            self._seen[int(key)] = None
