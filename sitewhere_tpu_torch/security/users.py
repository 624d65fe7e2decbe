"""User management: users + granted authorities.

Counterpart of ``sitewhere_tpu/security/users.py``, whole.

Reference: ``service-user-management`` — user CRUD with hashed passwords
(``persistence/UserManagementPersistence.java``), granted-authority
hierarchy, authenticate-and-update-last-login
(``grpc/UserManagementImpl.java`` authenticate RPC), backing JWT login at
the REST gateway (``service-web-rest/.../auth/controllers/JwtService.java``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import hmac
import os
import threading
from typing import Dict, List, Optional

from sitewhere_tpu_torch.services.common import (
    AuthError,
    DuplicateToken,
    Entity,
    EntityNotFound,
    InvalidReference,
    SearchCriteria,
    SearchResults,
    ValidationError,
    now_s,
    paged,
    require,
    update_fields,
)

# The authority catalog — the reference ships a fixed authority hierarchy
# (``SiteWhereAuthority`` in sitewhere-core-api spi/user): (name, description,
# parent-group).  Superusers hold all of these.
AUTHORITIES: List[tuple] = [
    ("ADMINISTER_USERS", "Administer users", "Users"),
    ("ADMINISTER_USER_SELF", "Administer own user account", "Users"),
    ("ADMINISTER_TENANTS", "Administer tenants", "Tenants"),
    ("ADMINISTER_TENANT_SELF", "Administer own tenant", "Tenants"),
    ("ADMINISTER_DEVICES", "Administer devices", "Devices"),
    ("ADMINISTER_EVENTS", "Administer device events", "Devices"),
    ("ADMINISTER_ASSETS", "Administer assets", "Assets"),
    ("ADMINISTER_SCHEDULES", "Administer schedules", "Schedules"),
    ("ADMINISTER_BATCH", "Administer batch operations", "Batch"),
    ("REST_ACCESS", "Access the REST surface", "API"),
]

SUPERUSER_AUTHORITIES = [name for name, _, _ in AUTHORITIES]

#: the reference module the entities pickle under (``_PICKLE_AS``)
_REF = "sitewhere_tpu.security.users"

_HASH_ITERS = 100_000  # pbkdf2-sha256 work factor


class AccountStatus:
    """Mirror of the reference's ``AccountStatus`` enum (java-model)."""

    ACTIVE = "active"
    EXPIRED = "expired"
    LOCKED = "locked"


@dataclasses.dataclass
class GrantedAuthority(Entity):
    """Reference: ``IGrantedAuthority`` — named permission, optional parent."""

    _PICKLE_AS = (_REF, "GrantedAuthority")

    authority: str = ""
    description: str = ""
    parent: Optional[str] = None
    group: bool = False


@dataclasses.dataclass
class User(Entity):
    """Reference: ``IUser`` — credentials + profile + authorities."""

    _PICKLE_AS = (_REF, "User")

    username: str = ""
    hashed_password: str = ""  # "pbkdf2$<iters>$<salt-hex>$<digest-hex>"
    first_name: str = ""
    last_name: str = ""
    status: str = AccountStatus.ACTIVE
    authorities: List[str] = dataclasses.field(default_factory=list)
    last_login_s: Optional[int] = None


def hash_password(password: str, salt: Optional[bytes] = None) -> str:
    """PBKDF2-SHA256 password hash (reference hashes via Spring's encoder)."""
    if not password:
        raise ValidationError("password required")
    salt = salt if salt is not None else os.urandom(16)
    digest = hashlib.pbkdf2_hmac("sha256", password.encode(), salt, _HASH_ITERS)
    return f"pbkdf2${_HASH_ITERS}${salt.hex()}${digest.hex()}"


def check_password(password: str, hashed: str) -> bool:
    try:
        _, iters, salt_hex, digest_hex = hashed.split("$")
        digest = hashlib.pbkdf2_hmac(
            "sha256", password.encode(), bytes.fromhex(salt_hex), int(iters)
        )
        return hmac.compare_digest(digest.hex(), digest_hex)
    except (ValueError, AttributeError):
        return False


class UserManagement:
    """The ``IUserManagement`` SPI reshaped as an in-process host service.

    Thread-safe; authoritative store is host dicts (the reference's Mongo
    collections).  Nothing here is device-visible.
    """

    def __init__(self):
        self._lock = threading.RLock()
        self._users: Dict[str, User] = {}
        self._authorities: Dict[str, GrantedAuthority] = {}
        for name, desc, group in AUTHORITIES:
            self._authorities[name] = GrantedAuthority(
                token=name, authority=name, description=desc, parent=group
            )

    # -- users ------------------------------------------------------------

    def create_user(
        self,
        username: str,
        password: str,
        first_name: str = "",
        last_name: str = "",
        authorities: Optional[List[str]] = None,
        status: str = AccountStatus.ACTIVE,
        metadata: Optional[Dict[str, str]] = None,
    ) -> User:
        with self._lock:
            require(bool(username), ValidationError("username required"))
            require(
                username not in self._users,
                DuplicateToken(f"user {username!r} exists"),
            )
            auths = list(authorities if authorities is not None else [])
            for a in auths:
                require(
                    a in self._authorities,
                    InvalidReference(f"unknown authority {a!r}"),
                )
            user = User(
                token=username,
                username=username,
                hashed_password=hash_password(password),
                first_name=first_name,
                last_name=last_name,
                status=status,
                authorities=auths,
                metadata=dict(metadata or {}),
            )
            self._users[username] = user
            return user

    def get_user(self, username: str) -> User:
        with self._lock:
            user = self._users.get(username)
            require(user is not None, EntityNotFound(f"no user {username!r}"))
            return user

    def update_user(self, username: str, **fields) -> User:
        """Update profile fields; ``password=`` re-hashes; ``authorities=``
        replaces the grant list (reference: updateUser + updateUserAuthorities)."""
        with self._lock:
            user = self.get_user(username)

            def validate(f):
                if "authorities" in f:
                    f["authorities"] = list(f["authorities"])
                    for a in f["authorities"]:
                        require(
                            a in self._authorities,
                            InvalidReference(f"unknown authority {a!r}"),
                        )
                if "password" in f:
                    # hash_password validates (raises before any write) and
                    # the hash replaces the plaintext in the field dict.
                    f["hashed_password"] = hash_password(f.pop("password"))

            update_fields(
                user,
                fields,
                ("password", "authorities", "first_name", "last_name", "status", "metadata"),
                validate,
            )
            return user

    def delete_user(self, username: str) -> User:
        with self._lock:
            user = self.get_user(username)
            del self._users[username]
            return user

    def list_users(self, criteria: Optional[SearchCriteria] = None) -> SearchResults[User]:
        with self._lock:
            return paged(sorted(self._users.values(), key=lambda u: u.username), criteria)

    # -- authentication ----------------------------------------------------

    def authenticate(self, username: str, password: str, update_last_login: bool = True) -> User:
        """Reference: ``UserManagementImpl.authenticate`` — verify password
        against the stored hash, require an active account, stamp last login."""
        with self._lock:
            user = self._users.get(username)
            require(user is not None, AuthError("bad credentials"))
            # Status is checked before the password so a locked/expired
            # account never acts as a password-validity oracle.
            require(
                user.status == AccountStatus.ACTIVE,
                AuthError(f"account {user.status}"),
            )
            require(
                check_password(password, user.hashed_password),
                AuthError("bad credentials"),
            )
            if update_last_login:
                user.last_login_s = now_s()
            return user

    # -- authorities -------------------------------------------------------

    def create_granted_authority(
        self, authority: str, description: str = "", parent: Optional[str] = None
    ) -> GrantedAuthority:
        with self._lock:
            require(
                authority not in self._authorities,
                DuplicateToken(f"authority {authority!r} exists"),
            )
            ga = GrantedAuthority(
                token=authority, authority=authority, description=description, parent=parent
            )
            self._authorities[authority] = ga
            return ga

    def get_granted_authority(self, authority: str) -> GrantedAuthority:
        with self._lock:
            ga = self._authorities.get(authority)
            require(ga is not None, EntityNotFound(f"no authority {authority!r}"))
            return ga

    def list_granted_authorities(
        self, criteria: Optional[SearchCriteria] = None
    ) -> SearchResults[GrantedAuthority]:
        with self._lock:
            return paged(
                sorted(self._authorities.values(), key=lambda a: a.authority), criteria
            )

    def authorities_for(self, username: str) -> List[str]:
        return list(self.get_user(username).authorities)
