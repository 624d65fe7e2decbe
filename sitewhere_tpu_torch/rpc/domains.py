"""Marshalling rules shared by the REST surface and the RPC fabric.

Counterpart of ``sitewhere_tpu/rpc/domains.py`` as far as the REST
gateway needs it: :func:`scrub` (the reference's :101) with its
``_SCRUB_KEYS``.  The per-domain method table, ``bind_domains`` and the
remote facades come with the multi-host slice.
"""

from __future__ import annotations

# Credential material must never cross a marshalling boundary — neither
# REST nor the fabric (the reference's REST marshalers drop it too).
_SCRUB_KEYS = frozenset({"hashed_password"})


def scrub(doc):
    """Drop credential fields from a marshalled entity (recursive)."""
    if isinstance(doc, dict):
        return {k: scrub(v) for k, v in doc.items() if k not in _SCRUB_KEYS}
    if isinstance(doc, list):
        return [scrub(v) for v in doc]
    return doc


__all__ = ["scrub"]
