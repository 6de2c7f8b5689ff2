"""Message envelope: `{key, data}` JSON objects.

Same envelope shape as the reference (`ProviderMessage<T>`, src/types.ts:23-26;
`createMessage`, src/utils.ts:12-14), but carried inside length-framed (and,
post-handshake, encrypted) frames instead of raw unframed JSON writes — the
reference relies on each `peer.write` arriving as exactly one `data` event
(src/provider.ts:110-115,174-179), which TCP does not guarantee.

Trace context convention: an `inference` frame's data may carry
`"traceId"` (client-minted, utils/trace.new_trace_id) — providers thread
it through the backend and host pipe so every component's spans correlate
on one timeline — and the provider's stream-start reply carries `"tMono"`
(its CLOCK_MONOTONIC read at send) so the client can estimate the
provider-clock offset for the merged Perfetto export. Both fields are
optional: peers that ignore them interoperate unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from symmetry_tpu_torch.protocol.keys import normalize_key
from symmetry_tpu_torch.utils.json import dumps, safe_parse_json


@dataclass(slots=True)
class Message:
    key: str
    data: Any = None

    def encode(self) -> bytes:
        obj: dict[str, Any] = {"key": self.key}
        if self.data is not None:
            obj["data"] = self.data
        return dumps(obj)


def create_message(key: str, data: Any = None) -> bytes:
    """Encode a `{key, data}` envelope (reference: src/utils.ts:12-14)."""
    return Message(key, data).encode()


def parse_message(raw: bytes | str | None) -> Message | None:
    """Decode an envelope; None on malformed input (never raises on bad peers)."""
    obj = safe_parse_json(raw)
    if not isinstance(obj, dict) or "key" not in obj or not isinstance(obj["key"], str):
        return None
    return Message(key=normalize_key(obj["key"]), data=obj.get("data"))
