"""Engine-API JWT authentication.

The execution_layer/src/engine_api/auth.rs analog: the CL authenticates
to the EL's authenticated port with an HS256 JWT over a shared 32-byte
hex secret (the jwtsecret file), claims carrying an `iat` within ±60 s
(EL-side drift tolerance per the engine API spec)."""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import time

JWT_DRIFT_TOLERANCE_S = 60


class JwtError(ValueError):
    pass


def _b64url(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _b64url_decode(s: str) -> bytes:
    pad = "=" * (-len(s) % 4)
    return base64.urlsafe_b64decode(s + pad)


def load_jwt_secret(hex_or_path: str) -> bytes:
    """Accepts the 64-hex-char secret itself or a path to a jwtsecret
    file (geth/nethermind format: optionally 0x-prefixed hex)."""
    text = hex_or_path
    try:
        with open(hex_or_path) as f:
            text = f.read()
    except OSError:
        pass
    text = text.strip().removeprefix("0x")
    secret = bytes.fromhex(text)
    if len(secret) != 32:
        raise JwtError(f"jwt secret must be 32 bytes, got {len(secret)}")
    return secret


def generate_jwt(secret: bytes, iat: int | None = None, claims: dict | None = None) -> str:
    header = {"alg": "HS256", "typ": "JWT"}
    payload = {"iat": int(time.time()) if iat is None else int(iat)}
    if claims:
        payload.update(claims)
    signing_input = (
        _b64url(json.dumps(header, separators=(",", ":")).encode())
        + "."
        + _b64url(json.dumps(payload, separators=(",", ":")).encode())
    )
    sig = hmac.new(secret, signing_input.encode(), hashlib.sha256).digest()
    return signing_input + "." + _b64url(sig)


def validate_jwt(token: str, secret: bytes, now: int | None = None) -> dict:
    """EL-side validation: signature + iat drift. Returns the claims.
    EVERY malformation surfaces as JwtError — base64/json decode errors
    must not escape past the 401 handler."""
    try:
        head_b64, claims_b64, sig_b64 = token.split(".")
        signing_input = f"{head_b64}.{claims_b64}".encode()
        expected = hmac.new(secret, signing_input, hashlib.sha256).digest()
        if not hmac.compare_digest(expected, _b64url_decode(sig_b64)):
            raise JwtError("bad signature")
        header = json.loads(_b64url_decode(head_b64))
        if header.get("alg") != "HS256":
            raise JwtError(f"unsupported alg {header.get('alg')}")
        claims = json.loads(_b64url_decode(claims_b64))
        iat = int(claims.get("iat", 0))
    except JwtError:
        raise
    except (ValueError, TypeError, KeyError) as e:
        # binascii.Error and JSONDecodeError are ValueError subclasses
        raise JwtError(f"malformed token: {e}") from e
    now = int(time.time()) if now is None else now
    if abs(now - iat) > JWT_DRIFT_TOLERANCE_S:
        raise JwtError("iat outside drift tolerance")
    return claims
