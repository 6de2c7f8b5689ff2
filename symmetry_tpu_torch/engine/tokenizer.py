"""Tokenization + chat templating for the engine.

Two implementations behind one interface:
  - HFTokenizer: wraps a local HF tokenizer dir (llama3/mistral production
    path; no network — the checkpoint dir ships tokenizer files).
  - ByteTokenizer: UTF-8 bytes as ids 0-255 plus BOS/EOS — deterministic,
    dependency-free, pairs with the `tiny` model preset so the whole serving
    stack runs in tests (SURVEY §4: engine tests against tiny real models).

Detokenization is incremental: decode() may be called per generated token,
and multi-byte codepoints must not be emitted until complete — the stream
the provider forwards is text chunks, and a split UTF-8 sequence would
corrupt the client's view (reference hot loop forwards backend chunks
verbatim, src/provider.ts:247; here WE are the backend producing them).
"""

from __future__ import annotations

import abc


class Tokenizer(abc.ABC):
    bos_id: int
    eos_ids: frozenset[int]
    vocab_size: int

    @abc.abstractmethod
    def encode(self, text: str, *, bos: bool = True) -> list[int]: ...

    @abc.abstractmethod
    def decode(self, ids: list[int]) -> str: ...

    @abc.abstractmethod
    def apply_chat_template(self, messages: list[dict[str, str]]) -> list[int]:
        """Render a chat and leave the sequence open for the assistant turn."""

    def stream_decoder(self) -> "StreamDecoder":
        return StreamDecoder(self)


class StreamDecoder:
    """Incremental detokenizer: feed ids, get only newly-completed text.

    Decodes only a sliding window of recent ids (never the whole history), so
    per-token cost is O(window), not O(generated-so-far): `_prefix` marks where
    the last emitted text's token context starts, `_read` where unemitted ids
    begin. Both advance together once a push produces clean (no trailing
    replacement char) text, which bounds the window at a few ids in practice.
    """

    def __init__(self, tok: Tokenizer) -> None:
        self._tok = tok
        self._ids: list[int] = []
        self._prefix = 0  # context window start
        self._read = 0    # first id not yet emitted as text

    def push(self, token_id: int) -> str:
        # One id is the degenerate batch: the back-off loop collapses to
        # push's old hold-everything-back behavior, and keeping a single
        # implementation means the hold-back rules cannot drift.
        return self.push_many([token_id])

    def push_many(self, token_ids: list[int]) -> str:
        """Feed a whole run of ids in ONE pass; return the newly-completed
        text. Equivalent to ``"".join(push(t) for t in token_ids)`` but with
        O(1) decode calls per run instead of O(len) — the batch API the
        block-granular emit path uses (one call per slot per decode block).

        A trailing incomplete codepoint is held back exactly as push()
        holds it: back off id-by-id from the end (a codepoint spans at most
        a few ids) to the last clean boundary and emit up to there."""
        if not token_ids:
            return ""
        self._ids.extend(token_ids)
        prefix_text = self._tok.decode(self._ids[self._prefix:self._read])
        end = len(self._ids)
        text = self._tok.decode(self._ids[self._prefix:end])
        while text.endswith("�") and end > self._read:
            # Mid-codepoint tail: shrink the emitted run until clean. Ids
            # past `end` stay buffered for the next push/flush.
            end -= 1
            text = self._tok.decode(self._ids[self._prefix:end])
        if text.endswith("�") or end <= self._read:
            return ""  # the whole unemitted run is mid-codepoint
        delta = text[len(prefix_text):]
        self._prefix = self._read
        self._read = end
        return delta

    def flush(self) -> str:
        text = self._tok.decode(self._ids[self._prefix:])
        prefix_text = self._tok.decode(self._ids[self._prefix:self._read])
        self._prefix = self._read = len(self._ids)
        return text[len(prefix_text):]


def resolve_resume(tokenizer: Tokenizer, resume: dict | None,
                   prompt_ids: list[int], max_new: int
                   ) -> tuple[list[int], int, int]:
    """ONE implementation of resume-request resolution, shared by every
    admission path (host submit, decode-tier adopt, in-process backend —
    divergent copies already disagreed once on negative-count handling):
    returns (prompt_ids + re-encoded emitted continuation, remaining
    token budget, resume offset). The client's claimed token count wins
    (it positions the seeded RNG lane exactly); the re-encoded length
    stands in when the shed couldn't stamp one. Raises ValueError on a
    negative claim — a malformed resume must be rejected, not inflate
    the budget past the client's max_tokens.

    A remaining budget of ZERO is meaningful: the interrupted stream had
    already emitted the whole max_tokens budget (the crash ate only the
    finish frame). Callers must then complete the request immediately
    with finish_reason "length" and no new tokens — flooring to 1 here
    would generate one token past the client's budget and break
    token-identity with the uninterrupted run (which stopped exactly at
    max_tokens)."""
    if not isinstance(resume, dict):
        return prompt_ids, max_new, 0
    text = str(resume.get("text") or "")
    emitted_ids = tokenizer.encode(text, bos=False) if text else []
    claimed = resume.get("tokens")
    offset = int(claimed) if claimed is not None else len(emitted_ids)
    if offset < 0:
        raise ValueError(f"resume tokens {offset} < 0")
    return prompt_ids + emitted_ids, max(0, max_new - offset), offset


class ByteTokenizer(Tokenizer):
    """ids 0-255 = raw bytes; 256 = BOS; 257 = EOS; ids >= 258 decode to
    byte (id % 256). vocab defaults to 258 (fits `tiny`).

    The modulo mapping matters for models whose vocab exceeds 258 served
    WITHOUT tokenizer files (benchmarks, smoke runs): a 128k-vocab model
    samples ids >= 258 essentially always, and silently dropping them
    (the old behavior) turns the entire stream into empty text deltas —
    round 3's e2e bench measured exactly that silence (every client's
    TTFT == wall time) before this fix. Construct with the model's
    vocab_size so sampled ids are meaningful byte text."""

    BOS, EOS = 256, 257

    def __init__(self, vocab_size: int = 258) -> None:
        self.bos_id = self.BOS
        self.eos_ids = frozenset({self.EOS})
        self.vocab_size = max(int(vocab_size), 258)

    def encode(self, text: str, *, bos: bool = True) -> list[int]:
        ids = list(text.encode("utf-8"))
        return ([self.BOS] + ids) if bos else ids

    def decode(self, ids: list[int]) -> str:
        data = bytes(i % 256 for i in ids if i not in (self.BOS, self.EOS))
        return data.decode("utf-8", errors="replace")

    def apply_chat_template(self, messages: list[dict[str, str]]) -> list[int]:
        parts = [f"{m.get('role', 'user')}: {m.get('content', '')}\n"
                 for m in messages]
        parts.append("assistant: ")
        return self.encode("".join(parts), bos=True)


class HFTokenizer(Tokenizer):
    """transformers AutoTokenizer over local files only."""

    def __init__(self, path: str) -> None:
        from transformers import AutoTokenizer

        self._tok = AutoTokenizer.from_pretrained(path, local_files_only=True)
        self.bos_id = self._tok.bos_token_id
        eos = self._tok.eos_token_id
        ids = {eos} if isinstance(eos, int) else set(eos or ())
        # llama3 chat ends turns with <|eot_id|>, distinct from eos.
        for special in ("<|eot_id|>", "<|im_end|>"):
            sid = self._tok.convert_tokens_to_ids(special)
            if isinstance(sid, int) and sid >= 0:
                ids.add(sid)
        self.eos_ids = frozenset(ids)
        self.vocab_size = len(self._tok)

    def encode(self, text: str, *, bos: bool = True) -> list[int]:
        return self._tok.encode(text, add_special_tokens=bos)

    def decode(self, ids: list[int]) -> str:
        return self._tok.decode(ids, skip_special_tokens=True)

    def apply_chat_template(self, messages: list[dict[str, str]]) -> list[int]:
        if self._tok.chat_template is not None:
            return self._tok.apply_chat_template(
                messages, add_generation_prompt=True, tokenize=True
            )
        parts = [f"{m.get('role', 'user')}: {m.get('content', '')}\n"
                 for m in messages]
        parts.append("assistant: ")
        return self.encode("".join(parts), bos=True)


def get_tokenizer(tokenizer_path: str | None,
                  vocab_size: int = 258) -> Tokenizer:
    """tokenizer_path -> HFTokenizer; else a ByteTokenizer sized to the
    MODEL's vocab (so sampled ids stream as text, see ByteTokenizer)."""
    if tokenizer_path:
        return HFTokenizer(tokenizer_path)
    return ByteTokenizer(vocab_size)
