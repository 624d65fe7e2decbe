"""Shared service plumbing: errors, paging, tokens and the entity base.

Counterpart of ``sitewhere_tpu/services/common.py``, whole: the service
errors (reference analog: ``SiteWhereException`` error codes), the paging
criteria and results of the list APIs (``ISearchCriteria`` /
``ISearchResults``), ``require``, ``now_s``, ``mint_token``, the
:class:`Entity` base of every persisted record (``IPersistentEntity``) and
the validate-then-apply :func:`update_fields`.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from typing import Callable, Dict, Generic, Iterable, List, Optional, TypeVar

T = TypeVar("T")


class ServiceError(Exception):
    """Base for service-level failures (maps to HTTP codes at the gateway)."""

    http_status = 500


class EntityNotFound(ServiceError):
    http_status = 404


class DuplicateToken(ServiceError):
    http_status = 409


class InvalidReference(ServiceError):
    """A referenced entity (type, area, customer…) does not exist."""

    http_status = 400


class ValidationError(ServiceError):
    http_status = 400


class AuthError(ServiceError):
    http_status = 401


class ForbiddenError(ServiceError):
    http_status = 403


class ServiceUnavailable(ServiceError):
    """Optional work refused under overload (degradation ladder) —
    clients should back off and retry once the instance recovers."""

    http_status = 503


class QuotaExceeded(ServiceError):
    """A tenant exhausted its metered quota (eval seconds per window).

    Retryable by design: the quota is measured over the usage ledger's
    sliding window, so the refusal clears as the window rotates — 429,
    not 403.  Never raised on the ingest hot path; only the optional
    eval surfaces (rule compile/eval, analytics runs) enforce quotas."""

    http_status = 429


@dataclasses.dataclass(frozen=True)
class SearchCriteria:
    """Page + optional time-range criteria.

    Reference: ``ISearchCriteria`` (1-based page index) and
    ``IDateRangeSearchCriteria`` used across every list API.
    """

    page: int = 1
    page_size: int = 100
    start_s: Optional[int] = None  # inclusive unix-seconds lower bound
    end_s: Optional[int] = None    # inclusive upper bound

    def slice(self, items: List[T]) -> List[T]:
        if self.page_size <= 0:
            return list(items)
        lo = (max(self.page, 1) - 1) * self.page_size
        return items[lo : lo + self.page_size]


@dataclasses.dataclass
class SearchResults(Generic[T]):
    """A page of results + the total match count (reference ``ISearchResults``)."""

    results: List[T]
    total: int

    def __iter__(self):
        return iter(self.results)

    def __len__(self):
        return len(self.results)


def paged(matches: List[T], criteria: Optional[SearchCriteria]) -> SearchResults[T]:
    criteria = criteria or SearchCriteria()
    return SearchResults(results=criteria.slice(matches), total=len(matches))


def now_s() -> int:
    return int(time.time())


_uuid_counter = itertools.count()
_uuid_lock = threading.Lock()


def mint_token(prefix: str) -> str:
    """Generate a unique token for entities created without one.

    Reference: entity tokens default to UUIDs
    (``Persistence.java`` create helpers).  Uses a counter + time so tokens
    are unique and stable within a process without consuming entropy.
    """
    with _uuid_lock:
        n = next(_uuid_counter)
    return f"{prefix}-{int(time.time() * 1000):x}-{n:x}"


@dataclasses.dataclass
class Entity:
    """Base fields shared by every persisted entity.

    Reference: ``IPersistentEntity`` — token, created/updated audit stamps,
    free-form metadata map.
    """

    token: str
    created_s: int = dataclasses.field(default_factory=now_s)
    updated_s: int = dataclasses.field(default_factory=now_s)
    metadata: Dict[str, str] = dataclasses.field(default_factory=dict)

    def touch(self) -> None:
        self.updated_s = now_s()


def require(condition: bool, error: ServiceError) -> None:
    if not condition:
        raise error


def update_fields(
    entity: Entity,
    fields: Dict[str, object],
    allowed: Iterable[str],
    validate: Optional[Callable[[Dict[str, object]], None]] = None,
) -> None:
    """Validate-then-apply entity update (reference: the update half of
    ``Persistence.java`` create/update validation).

    All checks — unknown fields and the optional ``validate`` hook — run
    before any attribute is written, so a rejected update never leaves a
    partial write behind.
    """
    unknown = set(fields) - set(allowed)
    require(not unknown, ValidationError(f"unknown fields {sorted(unknown)}"))
    if validate is not None:
        validate(fields)
    for key, value in fields.items():
        setattr(entity, key, value)
    entity.touch()
