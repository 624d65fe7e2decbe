"""Self-contained HS256 JWT mint/verify.

Counterpart of ``sitewhere_tpu/security/jwt.py``, whole.

Reference: ``sitewhere-microservice/src/main/java/com/sitewhere/microservice/
security/TokenManagement.java`` — jjwt-based JWT with the username as
subject and granted authorities as a claim, default expiration in minutes;
verified by ``JwtServerInterceptor``/``TokenAuthenticationFilter`` on every
gRPC/REST call.  This implementation is wire-compatible (standard JWT
header/payload/signature, HS256) but uses only the stdlib.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import os
import time
from typing import Dict, List, Optional

from sitewhere_tpu_torch.services.common import AuthError

GRANTED_AUTHORITIES_CLAIM = "auth"  # reference: TokenManagement CLAIM_GRANTED_AUTHORITIES
TENANT_CLAIM = "tenant"


class TokenInvalid(AuthError):
    """Signature/structure failure (reference: InvalidTokenException)."""


class TokenExpired(AuthError):
    """Token past its exp claim (reference: JwtExpiredException)."""


def _b64url(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode("ascii")


def _unb64url(data: str) -> bytes:
    pad = "=" * (-len(data) % 4)
    return base64.urlsafe_b64decode(data + pad)


class TokenManagement:
    """Mint and verify JWTs carrying username + authorities (+ tenant).

    The signing secret is process-wide (reference: shared instance secret);
    pass one explicitly or let it be generated fresh (tokens then only
    verify within this process, which is the single-instance default).
    """

    def __init__(self, secret: Optional[bytes] = None, default_expiration_min: int = 60):
        self._secret = secret if secret is not None else os.urandom(32)
        self.default_expiration_min = default_expiration_min

    def mint(
        self,
        username: str,
        authorities: List[str],
        expiration_min: Optional[int] = None,
        tenant: Optional[str] = None,
        now_s: Optional[int] = None,
    ) -> str:
        """Reference: ``TokenManagement.generateToken(user, minutes)``."""
        iat = int(time.time()) if now_s is None else now_s
        exp = iat + 60 * (
            expiration_min if expiration_min is not None else self.default_expiration_min
        )
        header = {"alg": "HS256", "typ": "JWT"}
        payload: Dict[str, object] = {
            "sub": username,
            "iat": iat,
            "exp": exp,
            GRANTED_AUTHORITIES_CLAIM: list(authorities),
        }
        if tenant is not None:
            payload[TENANT_CLAIM] = tenant
        signing_input = (
            _b64url(json.dumps(header, separators=(",", ":")).encode())
            + "."
            + _b64url(json.dumps(payload, separators=(",", ":")).encode())
        )
        sig = hmac.new(self._secret, signing_input.encode("ascii"), hashlib.sha256)
        return signing_input + "." + _b64url(sig.digest())

    def claims(self, token: str, now_s: Optional[int] = None) -> Dict[str, object]:
        """Verify signature + expiry, return the claims dict.

        Reference: ``TokenManagement.getClaimsForToken`` (throws on invalid
        or expired).
        """
        parts = token.split(".")
        if len(parts) != 3:
            raise TokenInvalid("malformed token")
        signing_input = parts[0] + "." + parts[1]
        try:
            expect = hmac.new(
                self._secret, signing_input.encode("ascii"), hashlib.sha256
            ).digest()
            got = _unb64url(parts[2])
        except Exception as exc:  # bad base64 etc.
            raise TokenInvalid(f"undecodable token: {exc}") from exc
        if not hmac.compare_digest(expect, got):
            raise TokenInvalid("bad signature")
        try:
            header = json.loads(_unb64url(parts[0]))
            payload = json.loads(_unb64url(parts[1]))
        except Exception as exc:
            raise TokenInvalid(f"undecodable claims: {exc}") from exc
        if header.get("alg") != "HS256":
            raise TokenInvalid(f"unsupported alg {header.get('alg')!r}")
        now = int(time.time()) if now_s is None else now_s
        if int(payload.get("exp", 0)) < now:
            raise TokenExpired("token expired")
        return payload

    def username(self, token: str) -> str:
        """Reference: ``TokenManagement.getUsernameFromToken``."""
        return str(self.claims(token)["sub"])

    def authorities(self, token: str) -> List[str]:
        """Reference: ``TokenManagement.getGrantedAuthoritiesFromToken``."""
        return list(self.claims(token).get(GRANTED_AUTHORITIES_CLAIM, []))
