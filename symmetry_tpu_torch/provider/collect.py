"""Conversation data collection.

Parity with the reference's declared data collection
(src/provider.ts:277-297): when `dataCollectionEnabled`, each completed
conversation is written to `{path}/{peer_pubkey}-{conversation_index}.json`
containing the request messages plus the assembled completion. The flag is
announced to the server and surfaced to clients in providerDetails — providers
must declare collection openly (reference readme.md, Communication section).
"""

from __future__ import annotations

import asyncio
import json
import os
from typing import Any

from symmetry_tpu_torch.utils.logging import logger


class DataCollector:
    def __init__(self, base_path: str, enabled: bool) -> None:
        self.enabled = enabled
        self._base = os.path.expanduser(base_path)

    async def save(self, *, peer_key: str, conversation_index: int,
                   messages: list[dict[str, Any]], completion: str) -> str | None:
        if not self.enabled:
            return None
        os.makedirs(self._base, exist_ok=True)
        path = os.path.join(self._base, f"{peer_key}-{conversation_index}.json")
        payload = {
            "messages": messages + [{"role": "assistant", "content": completion}],
        }
        # Off the event loop: file IO must not stall the token pump.
        await asyncio.get_running_loop().run_in_executor(
            None, _write_json, path, payload
        )
        logger.debug(f"saved conversation to {path}")
        return path


def _write_json(path: str, payload: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(payload, fh, ensure_ascii=False, indent=2)
    os.replace(tmp, path)
