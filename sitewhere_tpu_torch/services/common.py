"""Shared service plumbing: errors and tokens.

Counterpart of the part of ``sitewhere_tpu/services/common.py`` that the
registry mirror and the rule manager use: the service errors (reference
analog: ``SiteWhereException`` error codes), ``require``, ``now_s`` and
``mint_token``.  Paging and the entity base come with the services.
"""

from __future__ import annotations

import itertools
import threading
import time


class ServiceError(Exception):
    """Base for service-level failures (maps to HTTP codes at the gateway)."""

    http_status = 500


class EntityNotFound(ServiceError):
    http_status = 404


class DuplicateToken(ServiceError):
    http_status = 409


class ValidationError(ServiceError):
    http_status = 400


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
