"""Shared service plumbing: errors, paging and tokens.

Counterpart of the part of ``sitewhere_tpu/services/common.py`` that the
registry mirror, the rule manager and the event store use: the service
errors (reference analog: ``SiteWhereException`` error codes), the
paging criteria and results of the list APIs, ``require``, ``now_s`` and
``mint_token``.  The entity base comes with the services.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from typing import Generic, List, Optional, TypeVar

T = TypeVar("T")


class ServiceError(Exception):
    """Base for service-level failures (maps to HTTP codes at the gateway)."""

    http_status = 500


class EntityNotFound(ServiceError):
    http_status = 404


class DuplicateToken(ServiceError):
    http_status = 409


class ValidationError(ServiceError):
    http_status = 400


@dataclasses.dataclass(frozen=True)
class SearchCriteria:
    """Page + optional time-range criteria (1-based page index; the
    reference's ``ISearchCriteria`` and ``IDateRangeSearchCriteria``)."""

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
    """A page of results + the total match count."""

    results: List[T]
    total: int

    def __iter__(self):
        return iter(self.results)

    def __len__(self):
        return len(self.results)


def now_s() -> int:
    return int(time.time())


_uuid_counter = itertools.count()
_uuid_lock = threading.Lock()


def mint_token(prefix: str) -> str:
    """Generate a unique token for entities created without one: a
    counter + time, unique and stable within a process without consuming
    entropy."""
    with _uuid_lock:
        n = next(_uuid_counter)
    return f"{prefix}-{int(time.time() * 1000):x}-{n:x}"


def require(condition: bool, error: ServiceError) -> None:
    if not condition:
        raise error
