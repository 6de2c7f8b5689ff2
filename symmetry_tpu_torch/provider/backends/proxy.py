"""HTTP proxy backend: OpenAI-compatible external servers.

Capability parity with the reference's only inference path — POST
`{model, messages, stream:true}` to `{apiProtocol}://{apiHostname}:{apiPort}
{apiPath}` with optional Bearer apiKey (src/provider.ts:299-319), then parse
the streamed response per backend dialect (src/utils.ts:16-52):

  ollama / openwebui → OpenAI chunk `choices[0].delta.content`
  llamacpp           → `content`
  litellm / default  → `choices[0].delta.content` with literal-"undefined" guard

Chunks are forwarded raw (clients see the backend's native format, as in the
reference src/provider.ts:247) with the delta extracted once per chunk.
"""

from __future__ import annotations

from typing import Any, AsyncIterator

from symmetry_tpu_torch.provider.backends.base import (
    BackendError,
    InferenceBackend,
    InferenceRequest,
    StreamChunk,
)
from symmetry_tpu_torch.utils.json import safe_parse_json

_DATA_PREFIX = "data: "


def is_stream_with_data_prefix(line: str) -> bool:
    """SSE `data:` detection (reference: src/utils.ts:16-18)."""
    return line.startswith(_DATA_PREFIX)


def safe_parse_stream_response(line: str) -> Any | None:
    """Strip SSE prefix and parse (reference: src/utils.ts:20-31)."""
    if is_stream_with_data_prefix(line):
        line = line[len(_DATA_PREFIX):]
    if line.strip() in ("", "[DONE]"):
        return None
    return safe_parse_json(line)


def get_chat_data_from_provider(provider: str, chunk: Any) -> str:
    """Per-backend delta extraction (reference: src/utils.ts:33-52)."""
    if not isinstance(chunk, dict):
        return ""
    if provider == "llamacpp":
        content = chunk.get("content")
    else:
        choices = chunk.get("choices") or [{}]
        delta = choices[0].get("delta") if choices else None
        content = (delta or {}).get("content")
        if content is None:
            # Ollama-native shape: {"message": {"content": ...}}
            content = (chunk.get("message") or {}).get("content")
    if content is None or content == "undefined":  # literal guard, src/utils.ts:47
        return ""
    return str(content)


class ProxyBackend(InferenceBackend):
    def __init__(self, config: Any) -> None:
        self.name = config.api_provider
        self._url = (
            f"{config.get('apiProtocol')}://{config.get('apiHostname')}"
            f":{config.get('apiPort')}{config.get('apiPath')}"
        )
        self._model = config.model_name
        self._api_key = config.get("apiKey")
        self._session: aiohttp.ClientSession | None = None

    async def start(self) -> None:
        # aiohttp is imported here, not at the top: the client imports
        # this module's SSE helpers, and neither it nor a tpu_native
        # provider may need aiohttp to start.
        import aiohttp

        self._session = aiohttp.ClientSession()

    async def stop(self) -> None:
        if self._session is not None:
            await self._session.close()
            self._session = None

    async def healthy(self) -> bool:
        return True  # health = reachability; checked implicitly per request

    def _build_request(self, request: InferenceRequest) -> tuple[dict, dict]:
        """Reference: buildStreamRequest, src/provider.ts:299-319."""
        headers = {"Content-Type": "application/json"}
        if self._api_key:
            headers["Authorization"] = f"Bearer {self._api_key}"
        body: dict[str, Any] = {
            "model": self._model,
            "messages": request.messages,
            "stream": True,
        }
        if request.max_tokens is not None:
            body["max_tokens"] = request.max_tokens
        if request.temperature is not None:
            body["temperature"] = request.temperature
        if request.top_p is not None:
            body["top_p"] = request.top_p
        return body, headers

    async def stream(self, request: InferenceRequest) -> AsyncIterator[StreamChunk]:
        import aiohttp

        if self._session is None:
            await self.start()
        body, headers = self._build_request(request)
        try:
            async with self._session.post(self._url, json=body, headers=headers) as resp:
                if resp.status != 200:
                    detail = (await resp.text())[:500]
                    raise BackendError(f"backend HTTP {resp.status}: {detail}")
                # Both SSE ("data: {...}\n\n") and JSON-lines backends split on newline.
                async for raw_line in resp.content:
                    line = raw_line.decode("utf-8", errors="replace").strip()
                    if not line:
                        continue
                    parsed = safe_parse_stream_response(line)
                    if parsed is None:
                        if line.endswith("[DONE]"):
                            yield StreamChunk(raw=line, text="", done=True)
                        continue
                    text = get_chat_data_from_provider(self.name, parsed)
                    done = bool(
                        isinstance(parsed, dict)
                        and (
                            parsed.get("done") is True  # ollama-native
                            or (parsed.get("choices") or [{}])[0].get("finish_reason")
                        )
                    )
                    yield StreamChunk(raw=line, text=text, done=done)
        except aiohttp.ClientError as exc:
            raise BackendError(f"backend connection failed: {exc}") from exc
