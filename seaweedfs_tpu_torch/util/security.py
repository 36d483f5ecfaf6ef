"""Security: HS256 JWT per-fid tokens + access guard.

Mirrors the reference's model (ref: weed/security/jwt.go:21-40,
guard.go:43-62): the master signs a short-lived token scoped to a file id at
assign time; volume servers verify it on writes when a signing key is
configured. Implemented with stdlib hmac (no external jwt dependency).

Copied from the JAX package's util/security.py, without `real_remote`:
the port's HTTP server has no loopback fallback proxy, so the peer of a
request is its socket's own.
"""

from __future__ import annotations

import base64
import hmac
import json
import time
from dataclasses import dataclass
from hashlib import sha256


def _b64(data: bytes) -> bytes:
    return base64.urlsafe_b64encode(data).rstrip(b"=")


def _unb64(data: str) -> bytes:
    pad = "=" * (-len(data) % 4)
    return base64.urlsafe_b64decode(data + pad)


def gen_jwt(signing_key: str, expires_seconds: int, fid: str) -> str:
    """Signed token bound to one file id (ref jwt.go GenJwt)."""
    if not signing_key:
        return ""
    header = _b64(json.dumps({"alg": "HS256", "typ": "JWT"}).encode())
    claims = {"Fid": fid}
    if expires_seconds:
        claims["exp"] = int(time.time()) + expires_seconds
    payload = _b64(json.dumps(claims).encode())
    msg = header + b"." + payload
    sig = _b64(hmac.new(signing_key.encode(), msg, sha256).digest())
    return (msg + b"." + sig).decode()


class TokenError(Exception):
    pass


def decode_jwt(signing_key: str, token: str) -> dict:
    """Verify signature + expiry; returns claims (ref jwt.go DecodeJwt)."""
    try:
        header, payload, sig = token.split(".")
    except ValueError as e:
        raise TokenError("malformed token") from e
    msg = f"{header}.{payload}".encode()
    expected = _b64(hmac.new(signing_key.encode(), msg, sha256).digest()).decode()
    if not hmac.compare_digest(sig, expected):
        raise TokenError("invalid signature")
    claims = json.loads(_unb64(payload))
    if "exp" in claims and time.time() > claims["exp"]:
        raise TokenError("token expired")
    return claims


def verify_fid_token(signing_key: str, token: str, fid: str) -> None:
    """Raise unless the token authorizes this exact fid (ref
    volume_server_handlers.go:90 requires sc.Fid == vid+","+fid; a
    volume-prefix match would let one upload token write every needle on
    the volume). An extension suffix on the requested fid is ignored."""
    claims = decode_jwt(signing_key, token)
    token_fid = claims.get("Fid", "")
    if token_fid == fid.split(".")[0]:
        return
    # canonicalize both sides so "_delta" chunk fids and the /vid/fid URL
    # form compare equal to the comma form the token was minted for —
    # still an exact (vid, key, cookie) match, never a volume-prefix one
    try:
        from ..storage.file_id import FileId

        if FileId.parse(token_fid) == FileId.parse(fid):
            return
    except ValueError:
        pass
    raise TokenError("token fid mismatch")


@dataclass
class Guard:
    """Whitelist + JWT gate for HTTP handlers (ref guard.go)."""

    white_list: tuple = ()
    signing_key: str = ""
    expires_seconds: int = 10

    @property
    def is_active(self) -> bool:
        return bool(self.white_list or self.signing_key)

    def _parsed_whitelist(self):
        """(exact_ips, networks) parsed once — check_whitelist runs on the
        hot write path."""
        key = tuple(self.white_list)
        cached = getattr(self, "_whitelist_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        import ipaddress

        exact = set()
        networks = []
        for entry in self.white_list:
            if "/" in entry:
                try:
                    networks.append(ipaddress.ip_network(entry, strict=False))
                except ValueError:
                    continue
            else:
                exact.add(entry)
        self._whitelist_cache = (key, (exact, networks))
        return exact, networks

    def check_whitelist(self, peer_ip: str) -> bool:
        """Exact IPs and CIDR networks (ref guard.go checkWhiteList)."""
        if not self.white_list:
            return True
        exact, networks = self._parsed_whitelist()
        if peer_ip in exact:
            return True
        if not networks:
            return False
        import ipaddress

        try:
            ip = ipaddress.ip_address(peer_ip)
        except ValueError:
            return False
        return any(ip in net for net in networks)

    def check_jwt(self, auth_header: str, fid: str) -> bool:
        if not self.signing_key:
            return True
        if not auth_header.startswith("Bearer "):
            return False
        try:
            verify_fid_token(self.signing_key, auth_header[7:], fid)
            return True
        except TokenError:
            return False
