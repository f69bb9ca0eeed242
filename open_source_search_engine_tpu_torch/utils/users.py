"""Per-user admin accounts — the Users.cpp role.

A copy of ``open_source_search_engine_tpu/utils/users.py``; the port imports
nothing of that package.

The reference keeps a user table (``Users.cpp`` / ``users.txt``) with
per-user passwords and permission bits beside the master password.
Ours: ``users.txt`` in the instance base dir, one
``name:pbkdf2-hash:role`` line per user (roles ``admin`` > ``spider``
> ``query``), managed programmatically or by editing the file.
Passwords never store in the clear; verification is constant-time.
"""

from __future__ import annotations

import hashlib
import hmac
import os
import secrets
from pathlib import Path

ROLES = ("query", "spider", "admin")
_ITER = 50_000


def _hash(pwd: str, salt: bytes) -> bytes:
    return hashlib.pbkdf2_hmac("sha256", pwd.encode(), salt, _ITER)


class Users:
    def __init__(self, base_dir: str | Path):
        self.path = Path(base_dir) / "users.txt"
        self._users: dict[str, tuple[bytes, bytes, str]] = {}
        self.load()

    def load(self) -> None:
        self._users.clear()
        if not self.path.exists():
            return
        for line in self.path.read_text().splitlines():
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            try:
                name, salt_hex, hash_hex, role = line.split(":")
                if role not in ROLES:
                    continue
                self._users[name] = (bytes.fromhex(salt_hex),
                                     bytes.fromhex(hash_hex), role)
            except ValueError:
                continue

    def save(self) -> None:
        lines = ["# name:salt:pbkdf2_sha256:role"]
        for name, (salt, h, role) in sorted(self._users.items()):
            lines.append(f"{name}:{salt.hex()}:{h.hex()}:{role}")
        tmp = self.path.with_suffix(".tmp")
        tmp.write_text("\n".join(lines) + "\n")
        os.replace(tmp, self.path)

    def add(self, name: str, pwd: str, role: str = "query") -> None:
        if role not in ROLES:
            raise ValueError(f"role must be one of {ROLES}")
        if ":" in name or not name:
            raise ValueError("bad user name")
        salt = secrets.token_bytes(16)
        self._users[name] = (salt, _hash(pwd, salt), role)
        self.save()

    def remove(self, name: str) -> bool:
        if name in self._users:
            del self._users[name]
            self.save()
            return True
        return False

    def check(self, name: str, pwd: str,
              min_role: str = "admin") -> bool:
        """Constant-time credential check at ≥ the required role."""
        rec = self._users.get(name)
        if rec is None:
            # burn comparable time so user enumeration stays blind
            _hash(pwd, b"\x00" * 16)
            return False
        salt, want, role = rec
        ok = hmac.compare_digest(_hash(pwd, salt), want)
        return ok and ROLES.index(role) >= ROLES.index(min_role)

    def names(self) -> list[tuple[str, str]]:
        return [(n, r) for n, (_, _, r) in sorted(self._users.items())]
