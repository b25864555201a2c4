"""Request authentication for the prover RPC (reference:
crates/sdk/src/network/prover.rs:32-49 — every proof-network job is signed
with the client's ZKM_PRIVATE_KEY identity before submission).

The reference signs jobs with secp256k1 ECDSA; this environment has no
vetted ECDSA dependency, so the same posture is carried by HMAC-SHA256
over a shared key (machine-room DCN trust domain) with replay protection:

    sig = HMAC(key, method || b"\\0" || timestamp || b"\\0" || nonce
                     || b"\\0" || body)

The timestamp must be within `MAX_SKEW_S` of the server clock and the
nonce must be fresh (an LRU set per server). Key distribution is by env
(`ZIREN_NETWORK_KEY`, hex or raw) or constructor argument; with no key
configured the service stays open, matching the loopback default."""

from __future__ import annotations

import hashlib
import hmac
import os
import secrets
import threading
import time
from collections import OrderedDict

MAX_SKEW_S = 300.0

HDR_SIG = "X-Ziren-Signature"
HDR_TS = "X-Ziren-Timestamp"
HDR_NONCE = "X-Ziren-Nonce"


class AuthError(PermissionError):
    pass


def load_key(explicit=None) -> bytes | None:
    """Resolve the shared key: explicit arg > ZIREN_NETWORK_KEY env > None.
    Hex-looking strings decode; anything else is used as raw bytes."""
    key = explicit if explicit is not None else os.environ.get(
        "ZIREN_NETWORK_KEY"
    )
    if key is None or key == "":
        return None
    if isinstance(key, bytes):
        return key
    s = str(key)
    try:
        if len(s) % 2 == 0 and len(s) >= 32:
            return bytes.fromhex(s)
    except ValueError:
        pass
    return s.encode()


def _digest(key: bytes, method: str, ts: str, nonce: str, body: bytes) -> str:
    msg = b"\0".join(
        [method.encode(), ts.encode(), nonce.encode(), bytes(body)]
    )
    return hmac.new(key, msg, hashlib.sha256).hexdigest()


def sign_headers(key: bytes, method: str, body: bytes) -> dict:
    ts = f"{time.time():.3f}"
    nonce = secrets.token_hex(16)
    return {
        HDR_SIG: _digest(key, method, ts, nonce, body),
        HDR_TS: ts,
        HDR_NONCE: nonce,
    }


class RequestVerifier:
    """Server-side check: signature + clock skew + nonce freshness."""

    def __init__(self, key: bytes, max_nonces: int = 65536):
        self.key = key
        self._nonces: OrderedDict = OrderedDict()
        self.max_nonces = max_nonces
        # the server answers in threads: the freshness test, the insert
        # and the eviction are one step, or two copies of a request pass
        self._lock = threading.Lock()

    def verify(self, method: str, headers, body: bytes) -> None:
        sig = headers.get(HDR_SIG)
        ts = headers.get(HDR_TS)
        nonce = headers.get(HDR_NONCE)
        if not (sig and ts and nonce):
            raise AuthError("unsigned request (missing auth headers)")
        try:
            skew = abs(time.time() - float(ts))
        except ValueError:
            raise AuthError("bad timestamp") from None
        if skew > MAX_SKEW_S:
            raise AuthError(f"timestamp skew {skew:.0f}s exceeds limit")
        want = _digest(self.key, method, ts, nonce, body)
        if not hmac.compare_digest(want, str(sig)):
            raise AuthError("bad request signature")
        with self._lock:
            if nonce in self._nonces:
                raise AuthError("nonce replay")
            self._nonces[nonce] = None
            while len(self._nonces) > self.max_nonces:
                self._nonces.popitem(last=False)
