"""Security: authenticators + access control.

Reference parity (SURVEY §2.1 Security):
* ``server/security/`` — AuthenticationFilter + PasswordAuthenticator:
  here a file-backed password authenticator (the
  ``plugin/trino-password-authenticators`` file variant: one
  ``user:bcrypt-or-plain`` entry per line; this environment has no bcrypt
  wheel, so hashes are salted SHA-256 ``sha256:<salt>:<hex>``) plus an
  insecure (allow-all) authenticator, selected by config.
* ``security/AccessControlManager`` + SPI ``spi/security/`` — a
  rule-based access control: JSON rules of
  ``{"user": regex, "catalog": regex, "table": regex, "allow": bool}``
  evaluated first-match (the file-based access control plugin analog);
  default is allow-all.

Credentials ride the statement protocol as HTTP basic auth or the
X-Presto1-User header (matching the reference's X-Trino-User).

* internal communication — the nodes of a cluster (announcements, tasks,
  pages) prove themselves to each other with a bearer derived from a
  shared secret (``internal-communication.shared-secret``, Trino's
  ``InternalAuthenticationManager``): ``internal_headers`` adds it to a
  request, ``internal_ok`` checks one.  A node without a secret sends and
  checks nothing.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import re
import secrets
from dataclasses import dataclass, field
from typing import Dict, List, Optional


class AccessDeniedError(Exception):
    pass


def hash_password(password: str, salt: Optional[str] = None) -> str:
    salt = salt or secrets.token_hex(8)
    digest = hashlib.sha256((salt + password).encode()).hexdigest()
    return f"sha256:{salt}:{digest}"


def _check(password: str, stored: str) -> bool:
    if stored.startswith("sha256:"):
        _, salt, digest = stored.split(":", 2)
        return hashlib.sha256(
            (salt + password).encode()).hexdigest() == digest
    return secrets.compare_digest(password, stored)  # plain entry


INTERNAL_HEADER = "X-Presto1-Internal-Bearer"


def internal_headers(secret: Optional[str]) -> Dict[str, str]:
    """The header that proves a request comes from a node holding
    ``secret``: an HMAC of it, so the secret itself never crosses the wire
    (none without a secret)."""
    if secret is None:
        return {}
    token = hmac.new(secret.encode(), b"presto1 internal communication",
                     hashlib.sha256).hexdigest()
    return {INTERNAL_HEADER: token}


def internal_ok(headers, secret: Optional[str]) -> bool:
    """Whether a request's ``headers`` carry ``secret``'s bearer (always
    where there is no secret)."""
    if secret is None:
        return True
    want = internal_headers(secret)[INTERNAL_HEADER]
    return hmac.compare_digest(headers.get(INTERNAL_HEADER) or "", want)


class Authenticator:
    """Allow-all (the reference's insecure authenticator)."""

    def authenticate(self, headers) -> str:
        user = headers.get("X-Presto1-User") or "anonymous"
        return user


class PasswordAuthenticator(Authenticator):
    """File-backed user:password-hash store (PasswordAuthenticator SPI)."""

    def __init__(self, password_file: Optional[str] = None,
                 users: Optional[Dict[str, str]] = None):
        self.users: Dict[str, str] = dict(users or {})
        if password_file:
            with open(password_file) as f:
                for line in f:
                    line = line.strip()
                    if line and not line.startswith("#"):
                        user, stored = line.split(":", 1)
                        self.users[user] = stored

    def authenticate(self, headers) -> str:
        auth = headers.get("Authorization", "")
        if not auth.startswith("Basic "):
            raise AccessDeniedError("missing basic credentials")
        try:
            user, _, password = base64.b64decode(
                auth[6:]).decode().partition(":")
        except Exception:
            raise AccessDeniedError("malformed credentials")
        stored = self.users.get(user)
        if stored is None or not _check(password, stored):
            raise AccessDeniedError(f"invalid credentials for {user}")
        return user


@dataclass
class AccessRule:
    user: str = ".*"
    catalog: str = ".*"
    table: str = ".*"
    allow: bool = True

    def matches(self, user: str, catalog: str, table: str) -> bool:
        return bool(re.fullmatch(self.user, user)
                    and re.fullmatch(self.catalog, catalog)
                    and re.fullmatch(self.table, table))


class AccessControl:
    """First-match rule evaluation (file-based access control analog).

    No rules -> allow everything (the reference's AllowAllAccessControl).
    """

    def __init__(self, rules: Optional[List[AccessRule]] = None):
        self.rules = list(rules or [])

    @classmethod
    def from_file(cls, path: str) -> "AccessControl":
        with open(path) as f:
            spec = json.load(f)
        return cls([AccessRule(**r) for r in spec.get("rules", [])])

    def check_can_select(self, user: str, catalog: str, table: str) -> None:
        if not self.rules:
            return
        for r in self.rules:
            if r.matches(user, catalog, table):
                if r.allow:
                    return
                raise AccessDeniedError(
                    f"user {user} cannot select from {catalog}.{table}")
        raise AccessDeniedError(
            f"user {user} cannot select from {catalog}.{table}")

    def filter_tables(self, user: str, catalog: str, tables) -> list:
        return [t for t in tables
                if self._allowed(user, catalog, t)]

    def _allowed(self, user: str, catalog: str, table: str) -> bool:
        try:
            self.check_can_select(user, catalog, table)
            return True
        except AccessDeniedError:
            return False
