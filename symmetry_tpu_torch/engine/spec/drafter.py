"""Host-side n-gram prompt-lookup drafter (speculative decoding, draft half).

Prompt-lookup decoding (Saxena; PAPERS.md) drafts continuation tokens with
NO draft model: serving workloads that repeat long spans of their own
context — code edits, RAG answers quoting retrieved passages, extractive
summaries, chat turns restating a preamble — let the last few generated
tokens be matched against an index of the slot's prompt + generation so
far, and the tokens that followed the previous occurrence become the
proposal. The engine's verify pass (engine.verify_step / ops/sampling.
verify_tokens) then scores all proposals in ONE batched forward and keeps
the longest target-agreeing prefix, so a wrong proposal costs one wasted
lane position, never a wrong token.

Everything here is plain host Python on small lists — no JAX, no device
work — mirroring how StreamDecoder keeps detokenizer state host-side. The
scheduler owns one drafter and drives begin/extend/propose/release around
its decode loop; the index is per-slot and dies with the slot.

Matching rule (per slot): try the longest context suffix first
(`ngram_max` down to `ngram_min` tokens), look up a prior occurrence,
and propose up to `k_draft` tokens that followed it. The index keeps the
last few occurrence positions per n-gram, newest first, because (a) the
current context suffix is itself always the newest entry — a draft must
continue a STRICTLY EARLIER occurrence — and (b) near-tail occurrences
have their continuation truncated by the tail itself (a period-1 loop's
newest prior match yields a 1-token draft), so the proposer prefers the
newest occurrence old enough to supply all k_draft tokens.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterable


@dataclass(frozen=True)
class SpecConfig:
    """`tpu.speculative` knob, parsed. k_draft is the verify lane width
    (draft tokens per slot per dispatch); the n-gram bounds trade match
    precision (longer = fewer, better matches) against coverage."""

    k_draft: int = 8
    ngram_max: int = 3
    ngram_min: int = 1
    # Prompt positions indexed at slot admission (begin() runs on the
    # scheduler's single serving thread, so its cost stalls every active
    # stream): prompts longer than this index only their LAST
    # max_index_tokens — recent context matches matter most, and
    # generation keeps extending the indexed tail incrementally.
    max_index_tokens: int = 4096

    def __post_init__(self) -> None:
        if self.k_draft < 1:
            raise ValueError("speculative k_draft must be >= 1")
        if not 1 <= self.ngram_min <= self.ngram_max:
            raise ValueError("speculative needs 1 <= ngram_min <= ngram_max")
        if self.max_index_tokens < self.ngram_max + self.k_draft:
            raise ValueError("speculative max_index_tokens too small")

    @classmethod
    def from_knob(cls, knob: Any) -> "SpecConfig | None":
        """Parse the `tpu.speculative` config value: falsy disables;
        True = defaults; an int = k_draft; a mapping = field overrides."""
        if not knob:
            return None
        if knob is True:
            return cls()
        if isinstance(knob, int):
            return cls(k_draft=knob)
        if isinstance(knob, dict):
            unknown = set(knob) - {"k_draft", "ngram_max", "ngram_min",
                                   "max_index_tokens"}
            if unknown:
                raise ValueError(
                    f"unknown tpu.speculative keys: {sorted(unknown)}")
            return cls(**{k: int(v) for k, v in knob.items()})
        raise ValueError(
            f"tpu.speculative must be a bool, int, or mapping, "
            f"got {type(knob).__name__}")


class NGramDrafter:
    """Per-slot prompt-lookup index + proposal generation.

    Not thread-safe; lives on the scheduler's engine thread like every
    other piece of per-slot host state.
    """

    def __init__(self, config: SpecConfig) -> None:
        self.config = config
        # slot -> full token context (prompt + emitted generation)
        self._ctx: dict[int, list[int]] = {}
        # slot -> {ngram tuple: occurrence ends, NEWEST FIRST} — an "end"
        # is the context position right AFTER the n-gram, i.e. where its
        # continuation starts. Bounded per key: k_draft + 1 entries
        # guarantee that even a period-1 token loop (whose newest
        # occurrences all sit inside the tail) retains one occurrence at
        # least k_draft tokens back, so propose() can emit a full draft.
        self._index: dict[int, dict[tuple[int, ...], list[int]]] = {}
        self._hist = config.k_draft + 1

    # ------------------------------------------------------------- lifecycle

    def begin(self, slot: int, prompt_ids: Iterable[int],
              first_token: int) -> None:
        """Install a freshly-activated slot: context = prompt + the first
        sampled token (decode continues from it). Indexing runs on the
        scheduler's serving thread where a stall holds every active
        stream, so only the last max_index_tokens of a long prompt are
        indexed — matches against the dropped head are forfeited, the
        admission cost stays bounded."""
        ctx = list(prompt_ids)[-self.config.max_index_tokens:]
        ctx.append(first_token)
        self._ctx[slot] = []
        self._index[slot] = {}
        self.extend(slot, ctx)

    def extend(self, slot: int, tokens: Iterable[int]) -> None:
        """Append emitted tokens to the slot's context and index every
        n-gram they complete. Called once per processed block — O(block ×
        n-gram range) dict writes, no scans."""
        ctx = self._ctx.get(slot)
        if ctx is None:
            return
        index = self._index[slot]
        cfg = self.config
        for tok in tokens:
            ctx.append(int(tok))
            end = len(ctx)
            for n in range(cfg.ngram_min, cfg.ngram_max + 1):
                if end < n:
                    continue
                key = tuple(ctx[end - n:end])
                ends = index.get(key)
                if ends is None:
                    index[key] = [end]
                else:
                    ends.insert(0, end)
                    del ends[self._hist:]

    def release(self, slot: int) -> None:
        self._ctx.pop(slot, None)
        self._index.pop(slot, None)

    def active_slots(self) -> list[int]:
        return list(self._ctx)

    # ------------------------------------------------------------- proposals

    def propose(self, slot: int) -> list[int]:
        """Up to k_draft continuation tokens for `slot`, or [] when no
        context suffix recurs (the slot then rides a plain decode lane)."""
        ctx = self._ctx.get(slot)
        if not ctx:
            return []
        index = self._index[slot]
        cfg = self.config
        end = len(ctx)
        for n in range(min(cfg.ngram_max, end), cfg.ngram_min - 1, -1):
            ends = index.get(tuple(ctx[end - n:end]))
            if ends is None:
                continue
            # Newest occurrence old enough to supply a FULL draft; else
            # the newest strictly-prior one (short draft beats none). The
            # newest entry is the context's own tail (start == end).
            best: int | None = None
            for start in ends:
                if start >= end:
                    continue
                if best is None:
                    best = start
                if start + cfg.k_draft <= end:
                    best = start
                    break
            if best is None:
                continue
            return ctx[best:best + cfg.k_draft]
        return []
