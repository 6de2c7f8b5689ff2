"""JSON helpers (capability parity with reference src/utils.ts:4-14)."""

from __future__ import annotations

import json
from typing import Any


def safe_parse_json(data: str | bytes | None) -> Any | None:
    """Parse JSON, returning None on any failure (reference: src/utils.ts:4-10)."""
    if data is None:
        return None
    try:
        return json.loads(data)
    except (json.JSONDecodeError, TypeError, UnicodeDecodeError, ValueError):
        return None


def dumps(obj: Any) -> bytes:
    """Compact UTF-8 JSON encoding for the wire."""
    return json.dumps(obj, separators=(",", ":"), ensure_ascii=False).encode("utf-8")
