"""Per-thread security context + run-as-system.

Counterpart of ``sitewhere_tpu/security/context.py``, whole.

Reference: ``sitewhere-core/.../security/UserContextManager.java`` (thread
-bound authentication) and ``sitewhere-microservice/.../security/
SystemUserRunnable.java`` (internal operations run as a synthetic system
user carrying all authorities).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Iterator, List, Optional

from sitewhere_tpu_torch.services.common import AuthError, ForbiddenError

from sitewhere_tpu_torch.security.users import SUPERUSER_AUTHORITIES


@dataclasses.dataclass(frozen=True)
class SecurityContext:
    username: str
    authorities: List[str]
    tenant: Optional[str] = None

    def has(self, authority: str) -> bool:
        return authority in self.authorities


_local = threading.local()


def current_user() -> Optional[SecurityContext]:
    return getattr(_local, "context", None)


@contextlib.contextmanager
def security_context(ctx: SecurityContext) -> Iterator[SecurityContext]:
    """Bind a context for the duration of a request (gateway auth filter)."""
    prev = getattr(_local, "context", None)
    _local.context = ctx
    try:
        yield ctx
    finally:
        _local.context = prev


@contextlib.contextmanager
def system_user(tenant: Optional[str] = None) -> Iterator[SecurityContext]:
    """Run-as-system for internal pipeline work (SystemUserRunnable analog)."""
    with security_context(
        SecurityContext(username="system", authorities=list(SUPERUSER_AUTHORITIES), tenant=tenant)
    ) as ctx:
        yield ctx


def require_authority(authority: str) -> SecurityContext:
    """Gate an operation on the calling thread's context (reference: Spring
    ``@Secured`` on REST controllers / gRPC JWT interceptor)."""
    ctx = current_user()
    if ctx is None:
        raise AuthError("no authenticated user")
    if not ctx.has(authority):
        raise ForbiddenError(f"missing authority {authority!r}")
    return ctx
