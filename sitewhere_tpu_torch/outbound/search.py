"""Event search providers — federated search over indexed events.

Counterpart of ``sitewhere_tpu/outbound/search.py``.  The built-in
provider searches the columnar event store directly (chunk pruning and
vectorized masks); :class:`FederatedSearchProvider` fans a query out to
several providers and merges newest first; the manager keeps the
named-provider registry.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from sitewhere_tpu_torch.services.common import (
    EntityNotFound,
    SearchCriteria,
    SearchResults,
)
from sitewhere_tpu_torch.services.event_store import EventRecord, EventStore


class EventSearchProvider:
    """Search the event store (reference: ``SolrSearchProvider``)."""

    def __init__(self, provider_id: str, store: EventStore, name: str = ""):
        self.provider_id = provider_id
        self.name = name or provider_id
        self.store = store

    def search(self, criteria: Optional[SearchCriteria] = None, **filters) -> SearchResults[EventRecord]:
        return self.store.query(criteria, **filters)


class TokenSearchAdapter:
    """Token-level filters onto the local store's dense-id query.

    Federated queries carry tokens (hosts don't share dense handles);
    the local leg resolves them against this host's identity map — an
    unknown token simply matches nothing here (it may be another
    host's device)."""

    def __init__(self, provider_id: str, store: EventStore, identity,
                 device_management, name: str = ""):
        self.provider_id = provider_id
        self.name = name or provider_id
        self.store = store
        self.identity = identity
        self.device_management = device_management

    def search(self, criteria: Optional[SearchCriteria] = None,
               **filters) -> SearchResults[EventRecord]:
        resolved = {}
        token = filters.pop("device_token", None)
        if token is not None:
            dense = self.identity.device.lookup(token)
            if dense < 0:
                return SearchResults(results=[], total=0)
            resolved["device_id"] = int(dense)
        token = filters.pop("assignment_token", None)
        if token is not None:
            handle = self.device_management.handle_for("assignment", token)
            if handle < 0:
                return SearchResults(results=[], total=0)
            resolved["assignment_id"] = int(handle)
        resolved.update(filters)
        self.store.flush()
        return self.store.query(criteria, **resolved)


class RemoteSearchProvider:
    """Search a PEER instance's event store over the RPC fabric.

    Reference: external search providers query a remote index over the
    network (``SolrSearchProvider``).  In a multi-host topology each
    host's store indexes its own shards' events (keyed forwarding,
    ``rpc/forward.py``), so a peer's store is exactly such a remote
    index — reached through ``events.query`` on the fabric.  Results are
    the wire dicts (already marshaled by the peer)."""

    def __init__(self, provider_id: str, demux, name: str = ""):
        self.provider_id = provider_id
        self.name = name or provider_id
        self.demux = demux

    def search(self, criteria: Optional[SearchCriteria] = None,
               **filters) -> SearchResults[dict]:
        criteria = criteria or SearchCriteria()
        body = {"page": criteria.page, "pageSize": criteria.page_size}
        if criteria.start_s is not None:
            body["start"] = criteria.start_s
        if criteria.end_s is not None:
            body["end"] = criteria.end_s
        for key, wire_key in (("device_token", "deviceToken"),
                              ("assignment_token", "assignmentToken"),
                              ("event_type", "eventType")):
            if filters.get(key) is not None:
                body[wire_key] = filters[key]
        page, _ = self.demux.call("events.query", body)
        return SearchResults(results=list(page.get("results", [])),
                             total=int(page.get("numResults", 0)))


def _record_ts(record) -> tuple:
    """Newest-first merge key for local EventRecords and remote dicts."""
    if isinstance(record, dict):
        return (record.get("ts_s", 0), record.get("ts_ns", 0))
    return (getattr(record, "ts_s", 0), getattr(record, "ts_ns", 0))


class FederatedSearchProvider:
    """Cluster-wide search: fan a query out to several providers (the
    local store + every peer) and merge newest-first.

    This is the multi-host completion of the reference's federation
    idea: one logical search surface over per-host indexes.  Each
    backend is over-fetched to ``page × page_size`` so the merged page
    is exact regardless of how rows distribute across hosts; a peer
    that fails mid-query is skipped (federated search degrades, it
    does not fail whole — the reference's provider surface has the
    same isolation)."""

    def __init__(self, provider_id: str, providers: List, name: str = ""):
        self.provider_id = provider_id
        self.name = name or provider_id
        self.providers = list(providers)

    def search(self, criteria: Optional[SearchCriteria] = None,
               **filters) -> SearchResults:
        criteria = criteria or SearchCriteria()
        # page_size <= 0 is the "unlimited" sentinel every provider
        # honors (SearchCriteria.slice) — propagate it, don't slice to []
        unlimited = criteria.page_size <= 0
        fetch = SearchCriteria(
            page=1,
            page_size=0 if unlimited else criteria.page * criteria.page_size,
            start_s=criteria.start_s, end_s=criteria.end_s)
        merged: List = []
        total = 0
        for provider in self.providers:
            try:
                page = provider.search(fetch, **filters)
            except Exception:   # noqa: BLE001 — degrade, don't fail whole
                import logging

                logging.getLogger("sitewhere_tpu_torch.search").warning(
                    "federated search: provider %s failed; skipping",
                    provider.provider_id, exc_info=True)
                continue
            merged.extend(page.results)
            total += page.total
        merged.sort(key=_record_ts, reverse=True)
        if unlimited:
            return SearchResults(results=merged, total=total)
        lo = (criteria.page - 1) * criteria.page_size
        return SearchResults(results=merged[lo:lo + criteria.page_size],
                             total=total)


class SearchProvidersManager:
    """Named provider registry (reference: ``SearchProviderManager``)."""

    def __init__(self, providers: Optional[List[EventSearchProvider]] = None):
        self._providers: Dict[str, EventSearchProvider] = {
            p.provider_id: p for p in providers or []
        }

    def add_provider(self, provider: EventSearchProvider) -> None:
        self._providers[provider.provider_id] = provider

    def get_provider(self, provider_id: str) -> EventSearchProvider:
        p = self._providers.get(provider_id)
        if p is None:
            raise EntityNotFound(f"search provider {provider_id}")
        return p

    def list_providers(self) -> List[EventSearchProvider]:
        return list(self._providers.values())
