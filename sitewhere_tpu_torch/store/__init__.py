"""Log-structured sharded segment store.

Counterpart of ``sitewhere_tpu/store/``:

- :mod:`~sitewhere_tpu_torch.store.segment`: the columnar segment format
  (zone maps, Blooms, packed ``[C, n]`` layout, compaction provenance);
- :mod:`~sitewhere_tpu_torch.store.catalog`: the segment manifest and
  its checkpoint section;
- :mod:`~sitewhere_tpu_torch.store.sealer`: supervised, fail-closed
  background seal workers;
- :mod:`~sitewhere_tpu_torch.store.compaction`: background segment
  merge with a crash-safe tombstone swap;
- :mod:`~sitewhere_tpu_torch.store.tiering`: the packed hot tier;
- :mod:`~sitewhere_tpu_torch.store.scan`: the retrospective scan lane;
- :mod:`~sitewhere_tpu_torch.store.segmented`: :class:`SegmentStore`,
  the dispatcher's ``event_store``.

``SegmentStore`` is exposed lazily: ``segmented`` imports
:mod:`sitewhere_tpu_torch.services.event_store`, which imports
``store.segment``; an eager import here would be circular.
"""

from __future__ import annotations


def __getattr__(name):
    if name == "SegmentStore":
        from sitewhere_tpu_torch.store.segmented import SegmentStore
        return SegmentStore
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["SegmentStore"]
