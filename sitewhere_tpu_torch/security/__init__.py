"""Security: users, granted authorities, JWT tokens, request context.

Counterpart of ``sitewhere_tpu/security/__init__.py``, whole.

Reference: ``service-user-management`` (user + authority CRUD, password
hashing in ``persistence/UserManagementPersistence.java``, gRPC surface
``grpc/UserManagementImpl.java``) and the microservice kernel's JWT
machinery (``sitewhere-microservice/.../security/TokenManagement.java``
mint/verify, ``SystemUserRunnable.java`` run-as-system,
``sitewhere-core/.../security/UserContextManager.java``).

TPU-first reshape: none of this touches the device — identity stays a
host concern; the pipeline only ever sees dense tenant ids.  The JWT
implementation is self-contained HS256 over the stdlib (no external
dependency), wire-compatible with standard JWT consumers.
"""

from sitewhere_tpu_torch.security.jwt import TokenManagement, TokenExpired, TokenInvalid
from sitewhere_tpu_torch.security.users import (
    AUTHORITIES,
    GrantedAuthority,
    User,
    UserManagement,
)
from sitewhere_tpu_torch.security.context import (
    SecurityContext,
    current_user,
    require_authority,
    system_user,
)

__all__ = [
    "TokenManagement",
    "TokenExpired",
    "TokenInvalid",
    "AUTHORITIES",
    "GrantedAuthority",
    "User",
    "UserManagement",
    "SecurityContext",
    "current_user",
    "require_authority",
    "system_user",
]
