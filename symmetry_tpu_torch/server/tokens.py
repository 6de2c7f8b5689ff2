"""Signed session tokens.

The reference defines `verifySession`/`sessionValid` keys (src/constants.ts:
17-18) with the verification logic living in the absent server sibling. We
implement sessions as *server-signed offline-verifiable tokens*: the server
signs {session_id, client_key, model, expiry} with its Ed25519 identity, and a
provider verifies the signature against the serverKey it already trusts from
its config — no provider→server round trip on the hot path. Clients can still
ask the server directly via `verifySession` → `sessionValid`.
"""

from __future__ import annotations

import json
import time
from typing import Any

from symmetry_tpu_torch.identity import Identity


def _canonical(payload: dict[str, Any]) -> bytes:
    return json.dumps(payload, sort_keys=True, separators=(",", ":")).encode()


def mint(server_identity: Identity, *, session_id: str, client_key: str,
         model_name: str, ttl_s: float = 3600.0) -> dict[str, Any]:
    payload = {
        "sessionId": session_id,
        "clientKey": client_key,
        "modelName": model_name,
        "expiresAt": time.time() + ttl_s,
    }
    return {"payload": payload, "signature": server_identity.sign(_canonical(payload)).hex()}


def verify(token: Any, server_key: bytes, *, client_key: str | None = None,
           model_name: str | None = None) -> dict[str, Any] | None:
    """Return the payload if the token is authentic and unexpired, else None."""
    if not isinstance(token, dict):
        return None
    payload, sig_hex = token.get("payload"), token.get("signature")
    if not isinstance(payload, dict) or not isinstance(sig_hex, str):
        return None
    try:
        sig = bytes.fromhex(sig_hex)
    except ValueError:
        return None
    if not Identity.verify(_canonical(payload), sig, server_key):
        return None
    if payload.get("expiresAt", 0) < time.time():
        return None
    if client_key is not None and payload.get("clientKey") != client_key:
        return None
    if model_name is not None and payload.get("modelName") != model_name:
        return None
    return payload
