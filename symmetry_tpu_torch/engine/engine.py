"""The serving engine in PyTorch: prefill / insert / decode over a slot batch.

Port of symmetry_tpu/engine/engine.py, main-path subset. The shape
discipline is the JAX engine's:

  - PREFILL runs a batch of prompts padded to one of a few fixed buckets,
    from an empty cache, through the flash prefill kernel;
  - INSERT copies each prefilled KV row into its decode slot;
  - DECODE advances ALL slots `decode_block` tokens per dispatch at a fixed
    [B, 1] shape; per-slot raggedness lives in length arrays, not shapes.

The decode cache is written in place (index assignment, never a copy).
Dispatches are asynchronous on the card: `decode_steps_dispatch` returns a
HostFuture that the scheduler syncs with np.asarray one iteration later, so
host work overlaps the device as in the JAX engine.

Int8 serving follows the JAX engine: `kv_quant` keeps the KV cache in int8
with float32 scale planes, and `fused_dequant` packs int8 weights
(QuantizedTensor leaves, from models/llama.py quantize_params or
init_params(quantize=True)) into the W8A16 kernel's layout; leaves the
kernel cannot take stay flat on the mixed dot, logged and counted.

Knobs outside this slice (mesh, speculative decoding, the prefix cache,
chunked prefill, disaggregated roles, pipeline microbatches, device
profiling) raise EngineError naming their ROADMAP item.

The engine is synchronous and single-threaded by design: exactly one thread
(the scheduler's engine thread) may call the mutating methods.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, NamedTuple

import numpy as np
import torch

from symmetry_tpu_torch.engine.tokenizer import Tokenizer
from symmetry_tpu_torch.models.llama import (
    KVCache,
    ModelConfig,
    forward_hidden,
    init_cache,
    logits_from_hidden,
    pack_params,
)
from symmetry_tpu_torch.ops import kernels
from symmetry_tpu_torch.ops.quant import PackedQuantizedTensor, QuantizedTensor
from symmetry_tpu_torch.ops.sampling import sample_tokens
from symmetry_tpu_torch.utils.logging import logger
from symmetry_tpu_torch.utils.metrics import METRICS, MetricName

_SEED_MASK = 2**63 - 1


class EngineError(RuntimeError):
    pass


class DecodeState(NamedTuple):
    """Everything the decode step needs, all static-shape device tensors.

    The JAX engine's per-slot PRNG keys become (seed, step): the sampler
    hashes them into noise on the device (ops/sampling.py), and every
    decode step advances `step`."""

    cache: KVCache             # [L, B, T, K, D] x2 + lengths [B]
    last_token: torch.Tensor   # [B] int64 — token to feed next step
    temperature: torch.Tensor  # [B] float32
    top_p: torch.Tensor        # [B] float32
    top_k: torch.Tensor        # [B] int64
    seed: torch.Tensor         # [B] int64 — one noise stream PER SLOT
    step: torch.Tensor         # [B] int64 — draws made on that stream


@dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0
    top_p: float = 1.0
    top_k: int = 0
    seed: int | None = None
    # Stream resumption: how many tokens of this request's completion were
    # already sampled before this admission. A SEEDED request starts its
    # draw counter there, so the resumed continuation samples exactly the
    # tokens the uninterrupted run would have. Ignored without a seed.
    rng_skip: int = 0

    @classmethod
    def from_request(cls, req: Any) -> "SamplingParams":
        return cls(
            temperature=req.temperature if req.temperature is not None else 0.0,
            top_p=req.top_p if req.top_p is not None else 1.0,
            top_k=getattr(req, "top_k", None) or 0,
            seed=req.seed,
        )


class HostFuture:
    """A device tensor handed to the scheduler unsynced. np.asarray (its
    `__array__`) copies it to the host, blocking on this dispatch only —
    the scheduler's dispatch-before-sync pipelining needs no other API."""

    __slots__ = ("tensor",)

    def __init__(self, tensor: torch.Tensor) -> None:
        self.tensor = tensor

    def __array__(self, dtype=None, copy=None) -> np.ndarray:
        arr = self.tensor.cpu().numpy()
        return arr if dtype is None else arr.astype(dtype, copy=False)


# Knobs outside this slice -> the ROADMAP item that brings them.
_NOT_PORTED = {
    "mesh": "tensor / pipeline parallel meshes (ROADMAP Queue 1 item 14)",
    "pipeline_microbatches": "pipeline parallelism (ROADMAP Queue 1 item 14)",
    "speculative": "speculative decoding (ROADMAP Queue 1 item 7)",
    "prefix_cache_bytes": "the radix prefix cache (ROADMAP Queue 1 item 6)",
    "prefill_chunk": "chunked prefill (ROADMAP Queue 1 item 6)",
    "role": "disaggregated prefill/decode roles (ROADMAP Queue 1 item 11)",
    "profile_sample": "device profiling probes (ROADMAP Queue 1 item 12)",
}


class InferenceEngine:
    """Owns params + decode state; exposes prefill/insert/decode primitives.

    The constructor keeps the JAX engine's signature plus `device`;
    prefix_block_tokens and prefix_gossip_* only tune the prefix cache and
    are inert while it is refused.

    Thread-safety: NOT thread-safe; exactly one thread (the scheduler's
    engine thread) may call the mutating methods.
    """

    def __init__(
        self,
        config: ModelConfig,
        params: dict,
        tokenizer: Tokenizer,
        *,
        mesh=None,
        max_slots: int = 8,
        max_seq_len: int = 2048,
        prefill_buckets: tuple[int, ...] = (128, 512, 2048),
        cache_dtype: torch.dtype = torch.bfloat16,
        decode_block: int = 1,
        kv_quant: bool = False,
        pipeline_microbatches: int = 1,
        prefill_chunk: int | None = None,
        prefill_token_budget: int | None = None,
        prefix_cache_bytes: int = 0,
        prefix_block_tokens: int = 16,
        prefix_gossip_blocks: int = 64,
        prefix_gossip_s: float = 2.0,
        speculative=None,
        fused_dequant: bool = False,
        role: str = "unified",
        profile_sample: int = 0,
        device: str | torch.device = "cuda",
    ) -> None:
        refused = {
            "mesh": mesh is not None,
            "pipeline_microbatches": pipeline_microbatches > 1,
            "speculative": speculative is not None,
            "prefix_cache_bytes": prefix_cache_bytes > 0,
            "prefill_chunk": prefill_chunk is not None,
            "role": role != "unified",
            "profile_sample": profile_sample > 0,
        }
        for knob, on in refused.items():
            if on:
                raise EngineError(f"{knob}: {_NOT_PORTED[knob]} is not "
                                  f"ported to the PyTorch engine yet")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise EngineError("no CUDA device is available; pass "
                              "device='cpu' to run the plain versions")
        self.config = config
        self.params = _to_device(params, self.device)
        self.fused_dequant = bool(fused_dequant)
        if self.fused_dequant:
            self._pack_weights()
        self.tokenizer = tokenizer
        self.max_slots = max_slots
        self.max_seq_len = max_seq_len
        self.prefill_buckets = tuple(sorted(b for b in prefill_buckets
                                            if b <= max_seq_len))
        if not self.prefill_buckets:
            raise EngineError("no prefill bucket fits within max_seq_len")
        self.cache_dtype = cache_dtype
        self.kv_quant = bool(kv_quant)
        if decode_block < 1:
            raise EngineError("decode_block must be >= 1")
        self.decode_block = decode_block
        self.prefill_token_budget = (prefill_token_budget
                                     if prefill_token_budget is not None
                                     else self.PREFILL_TOKEN_BUDGET)
        if self.prefill_token_budget < 1:
            raise EngineError("prefill_token_budget must be >= 1")

        dev = self.device
        self.state = DecodeState(
            cache=init_cache(config, max_slots, max_seq_len, cache_dtype,
                             quantized=self.kv_quant, device=dev),
            last_token=torch.zeros(max_slots, dtype=torch.int64, device=dev),
            temperature=torch.zeros(max_slots, dtype=torch.float32,
                                    device=dev),
            top_p=torch.ones(max_slots, dtype=torch.float32, device=dev),
            top_k=torch.zeros(max_slots, dtype=torch.int64, device=dev),
            seed=torch.zeros(max_slots, dtype=torch.int64, device=dev),
            step=torch.zeros(max_slots, dtype=torch.int64, device=dev),
        )
        self._base_seed = int.from_bytes(os.urandom(8), "little") & _SEED_MASK
        self._requests_served = 0

    def _pack_weights(self) -> None:
        """`fused_dequant`: pack the int8 leaves into the W8A16 kernel's
        panel layout once, here; the layout is the routing (qmatmul
        dispatches on the leaf type). Leaves the kernel cannot take stay
        flat on the mixed dot, loudly (log + counter), never silently."""
        if not _has_int8(self.params):
            raise EngineError(
                "fused_dequant found no packable int8 weights: it requires "
                "int8 weights (quantization: int8); the knob would "
                "otherwise be silently inert")
        fallback = METRICS.counter(
            MetricName.QMM_FALLBACK,
            "int8 leaves kept on the mixed dot at load", labels=("reason",))
        degrades: list[tuple[str, str]] = []
        self.params = pack_params(self.params, report=degrades)
        for path, reason in degrades:
            logger.warning(f"fused_dequant: {path} stays on the mixed dot "
                           f"(reason: {reason})")
            fallback.inc(reason=reason)

    # ------------------------------------------------------------------
    # Device primitives

    def _prefill(self, tokens, true_len, temp, top_p, top_k, seed, step):
        """tokens [N, Sb] padded; returns (first tokens [N], prefix KV).

        N > 1 is COALESCED prefill (the scheduler batches concurrent
        arrivals into one dispatch). The prefix buffer is allocated empty:
        the prefill-from-empty trunk writes every one of its Sb positions
        (and, for an int8 cache, their scales) and flash attention never
        reads it back."""
        N, Sb = tokens.shape
        c = self.config
        shape = (c.num_layers, N, Sb, c.num_kv_heads, c.dim_per_head)
        kv_dtype = torch.int8 if self.kv_quant else self.cache_dtype
        scale_shape = (c.num_layers, N, c.num_kv_heads, Sb)

        def scales():
            return (torch.empty(scale_shape, dtype=torch.float32,
                                device=self.device)
                    if self.kv_quant else None)

        cache = KVCache(
            k=torch.empty(shape, dtype=kv_dtype, device=self.device),
            v=torch.empty(shape, dtype=kv_dtype, device=self.device),
            lengths=torch.zeros(N, dtype=torch.int32, device=self.device),
            k_scale=scales(), v_scale=scales())
        h, cache = forward_hidden(self.params, c, tokens, cache,
                                  seq_lens=true_len, prefill_flash=True)
        # Project ONLY the last valid position through the LM head.
        rows = torch.arange(N, device=self.device)
        h_last = h[rows, (true_len - 1).long()][:, None]      # [N, 1, E]
        last = logits_from_hidden(self.params, c, h_last)[:, 0]
        return sample_tokens(last, seed, step, temp, top_p, top_k), cache

    def _insert_all(self, prefix: KVCache, slots, true_len, first_token,
                    temp, top_p, top_k, seed, step) -> None:
        """Install EVERY row of a coalesced prefill in place. Pad rows carry
        the last real request's slot and identical data: re-writing it is
        idempotent."""
        st = self.state
        Sb = prefix.k.shape[2]
        st.cache.k[:, slots, :Sb] = prefix.k
        st.cache.v[:, slots, :Sb] = prefix.v
        if self.kv_quant:
            st.cache.k_scale[:, slots, :, :Sb] = prefix.k_scale
            st.cache.v_scale[:, slots, :, :Sb] = prefix.v_scale
        # The first sampled token's KV is not written yet: the next decode
        # step writes it at position true_len.
        st.cache.lengths[slots] = true_len
        st.last_token[slots] = first_token
        st.temperature[slots] = temp
        st.top_p[slots] = top_p
        st.top_k[slots] = top_k
        st.seed[slots] = seed
        st.step[slots] = step

    def _decode_one(self) -> torch.Tensor:
        """Advance every slot one token."""
        st = self.state
        h, cache = forward_hidden(self.params, self.config,
                                  st.last_token[:, None], st.cache)
        logits = logits_from_hidden(self.params, self.config, h)[:, 0]
        toks = sample_tokens(logits, st.seed, st.step, st.temperature,
                             st.top_p, st.top_k)
        self.state = st._replace(cache=cache, last_token=toks,
                                 step=st.step + 1)
        return toks

    # ------------------------------------------------------------------
    # Host-side API (called by the scheduler's engine thread)

    def bucket_for(self, prompt_len: int) -> int:
        for b in self.prefill_buckets:
            if prompt_len <= b:
                return b
        raise EngineError(
            f"prompt of {prompt_len} tokens exceeds the largest prefill "
            f"bucket ({self.prefill_buckets[-1]})")

    # Coalesced-prefill batch sizes, gated PER BUCKET by a token budget
    # (batch × bucket ≤ budget): wide batches at the small buckets, narrow
    # ones at the big buckets so the transient prefill buffers stay bounded.
    PREFILL_BATCHES = (1, 2, 4, 8, 16)
    PREFILL_TOKEN_BUDGET = 2048

    def prefill_batches_for(self, bucket: int) -> tuple[int, ...]:
        """Allowed coalesced-prefill batch sizes at `bucket` (ascending,
        always contains 1), capped by max_slots."""
        budget = max(self.prefill_token_budget, bucket)
        return tuple(b for b in self.PREFILL_BATCHES
                     if b * bucket <= budget
                     and (b == 1 or b <= self.max_slots))

    def _request_seed(self, sampling: SamplingParams) -> tuple[int, int]:
        """(seed, first step) for one request: seeded requests reproduce
        their whole completion, and `rng_skip` starts a seeded resume at
        the draw its interrupted run had reached; unseeded ones get
        per-request entropy."""
        if sampling.seed is not None:
            return (int(sampling.seed) & _SEED_MASK,
                    max(0, int(sampling.rng_skip or 0)))
        self._requests_served += 1
        return ((self._base_seed
                 + self._requests_served * 0x9E3779B97F4A7C15) & _SEED_MASK,
                0)

    def prefill_and_insert(self, slot: int, prompt_ids: list[int],
                           sampling: SamplingParams) -> int:
        """Prefill a prompt and install it in `slot`; returns first token."""
        return self.prefill_and_insert_many(
            [(slot, prompt_ids, sampling)])[0]

    def prefill_and_insert_many(
        self, assignments: list[tuple[int, list[int], SamplingParams]],
    ) -> list[int]:
        """Prefill several prompts in as few device dispatches as the
        bucket's batch budget allows and install each in its slot; returns
        their first tokens. A group wider than the bucket's largest allowed
        batch is split into consecutive dispatches."""
        if not assignments:
            return []
        if any(len(ids) == 0 for _, ids, _ in assignments):
            raise EngineError("empty prompt")
        n_req = len(assignments)
        bucket = max(self.bucket_for(len(ids)) for _, ids, _ in assignments)
        allowed = self.prefill_batches_for(bucket)
        if n_req > allowed[-1]:
            return [tok
                    for start in range(0, n_req, allowed[-1])
                    for tok in self.prefill_and_insert_many(
                        assignments[start:start + allowed[-1]])]
        batch = next(b for b in allowed if b >= n_req)

        padded = np.zeros((batch, bucket), np.int64)
        lens = np.zeros((batch,), np.int32)
        temps = np.zeros((batch,), np.float32)
        top_ps = np.ones((batch,), np.float32)
        top_ks = np.zeros((batch,), np.int64)
        seeds = np.zeros((batch,), np.int64)
        steps = np.zeros((batch,), np.int64)
        slots = np.zeros((batch,), np.int64)
        for i in range(batch):
            # Pad rows replay the last request BIT-IDENTICALLY — same
            # prompt, slot, seed and step — because every row is inserted:
            # anything short of an identical overwrite would corrupt the
            # last real slot's state.
            slot, ids, sampling = assignments[min(i, n_req - 1)]
            slots[i] = slot
            padded[i, :len(ids)] = ids
            lens[i] = len(ids)
            temps[i] = sampling.temperature
            top_ps[i] = sampling.top_p
            top_ks[i] = sampling.top_k
            if i >= n_req:
                seeds[i], steps[i] = seeds[n_req - 1], steps[n_req - 1]
                continue
            seeds[i], steps[i] = self._request_seed(sampling)

        def dev(a):
            return torch.from_numpy(a).to(self.device)

        lens_t, temps_t, top_ps_t, top_ks_t = (
            dev(lens), dev(temps), dev(top_ps), dev(top_ks))
        seeds_t, steps_t = dev(seeds), dev(steps)
        toks, prefix = self._prefill(dev(padded), lens_t, temps_t, top_ps_t,
                                     top_ks_t, seeds_t, steps_t)
        # The prefill drew with `step`; decode continues at step + 1.
        self._insert_all(prefix, dev(slots), lens_t, toks, temps_t, top_ps_t,
                         top_ks_t, seeds_t, steps_t + 1)
        host_toks = toks.cpu().numpy()
        return [int(host_toks[i]) for i in range(n_req)]

    def release_slot(self, slot: int) -> None:
        """A finished slot's cache lane is garbage until reuse (insert
        resets it); nothing to do device-side — the hook exists so the
        scheduler's slot lifecycle has a single engine-visible seam."""

    def warmup(self) -> None:
        """Run the serving shapes once before traffic: the kernels build (at
        first use, from csrc/), one decode block runs, and every bucket
        prefills and inserts at its widest batch, so an out-of-memory shows
        at startup rather than at the first burst. There is nothing to
        compile beyond the kernels: PyTorch runs eagerly. Call before the
        first insert — warmup advances device state with garbage that is
        only harmless on an empty cache (inserts target slot 0 at length 0).
        """
        if self.device.type == "cuda":
            kernels.build_all()
        self.decode_steps_dispatch()
        for bucket in self.prefill_buckets:
            n = max(b for b in self.prefill_batches_for(bucket)
                    if b <= self.max_slots)

            def full(value, dtype, n=n):
                return torch.full((n,), value, dtype=dtype,
                                  device=self.device)

            toks, prefix = self._prefill(
                torch.zeros((n, bucket), dtype=torch.int64,
                            device=self.device),
                full(1, torch.int32), full(0.0, torch.float32),
                full(1.0, torch.float32), full(0, torch.int64),
                full(0, torch.int64), full(0, torch.int64))
            self._insert_all(prefix, full(0, torch.int64),
                             full(0, torch.int32), toks,
                             full(0.0, torch.float32),
                             full(1.0, torch.float32), full(0, torch.int64),
                             full(0, torch.int64), full(1, torch.int64))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def decode_steps_dispatch(self) -> HostFuture:
        """Dispatch one decode block WITHOUT syncing: returns the [K, B]
        token tensor as a HostFuture. The caller can enqueue block N+1 and
        only then block on block N's tokens, so host-side work (transfer,
        detokenize, emit) overlaps block N+1's device execution."""
        toks = [self._decode_one() for _ in range(self.decode_block)]
        return HostFuture(torch.stack(toks))

    def decode_steps(self) -> np.ndarray:
        """decode_block tokens for every slot; host gets [K, B] int64."""
        return np.asarray(self.decode_steps_dispatch())

    def decode_step(self) -> np.ndarray:
        """One decode step [B] (requires decode_block == 1; tests/bench)."""
        if self.decode_block != 1:
            raise EngineError("decode_step needs decode_block=1")
        return self.decode_steps()[0]

    def slot_length(self, slot: int) -> int:
        return int(self.state.cache.lengths[slot])

    @property
    def slot_capacity(self) -> int:
        return self.max_seq_len

    def weight_stream_bytes(self) -> int:
        """Bytes of parameter data one decode step must stream from device
        memory: every weight (int8 payload + float32 scales, or dense),
        except the input embedding unless it is tied (it is gathered, not
        contracted; tied models re-read it as the LM head). Metadata-only,
        safe from any thread."""
        total = sum(t.numel() * t.element_size()
                    for t in _leaves(self.params))
        if not self.config.tie_embeddings:
            embed = self.params["embed"]
            total -= embed.numel() * embed.element_size()
        return total

    def compile_cache_sizes(self) -> dict[str, int]:
        """Compiled-variant count per primitive. Empty: the engine runs
        eagerly; CUDA graph capture is later work."""
        return {}


def _leaves(tree: Any):
    """Every tensor of a params tree, the payload and scales of int8 leaves
    included."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (QuantizedTensor, PackedQuantizedTensor)):
        yield from tree
    else:
        yield tree


def _has_int8(tree: Any) -> bool:
    if isinstance(tree, dict):
        return any(_has_int8(v) for v in tree.values())
    return isinstance(tree, (QuantizedTensor, PackedQuantizedTensor))


def _to_device(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (QuantizedTensor, PackedQuantizedTensor)):
        return type(tree)(*(t.to(device) for t in tree))
    return tree.to(device)
