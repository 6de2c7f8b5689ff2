"""The serving engine in PyTorch: prefill / insert / decode over a slot batch.

Port of symmetry_tpu/engine/engine.py, single-device subset. The shape
discipline is the JAX engine's:

  - PREFILL runs a batch of prompts padded to one of a few fixed buckets,
    from an empty cache, through the flash prefill kernel;
  - CHUNKED PREFILL (prefill_chunk) builds a long prompt's KV chunk by
    chunk into a batch-1 cache of bucket capacity, one dispatch per
    chunk, between decode blocks; chunks run the continuation path (the
    trunk over a live cache, ops/attention.py), as in the JAX package;
  - INSERT copies each prefilled KV row into its decode slot;
  - DECODE advances ALL slots `decode_block` tokens per dispatch at a fixed
    [B, 1] shape; per-slot raggedness lives in length arrays, not shapes.

The radix prefix cache (prefix_cache_bytes) keeps whole-block prompt
prefixes in a paged KV pool ([L, n_blocks + 1, block_tokens, K, D], block
0 the trash block); engine/prefix_cache.py (a copy) does the bookkeeping.
A hit seeds a working buffer by one block gather and prefills only the
suffix; finished prefills scatter their new tail blocks into the pool.
Gathers and scatters are indexed copies in plain torch (the JAX package
does them in XLA, outside any kernel).

The decode cache, prefill buffers and the pool are written in place
(index assignment, never a copy). Dispatches are asynchronous on the card:
`decode_steps_dispatch` returns a HostFuture that the scheduler syncs with
np.asarray one iteration later, so host work overlaps the device as in the
JAX engine.

Int8 serving follows the JAX engine: `kv_quant` keeps the KV cache in int8
with float32 scale planes, and `fused_dequant` packs int8 weights
(QuantizedTensor leaves, from models/llama.py quantize_params or
init_params(quantize=True)) into the W8A16 kernel's layout; leaves the
kernel cannot take stay flat on the mixed dot, logged and counted.

Speculative decoding (`speculative`, engine/spec/) verifies every slot's
n-gram draft in ONE batched [B, 1 + k_draft] forward (`verify_step`): the
continuation trunk, per-position acceptance (ops/sampling.py
verify_tokens) and a rollback of the cache lengths to the first
rejection. `from_tpu_config` loads an HF checkpoint (engine/weights.py)
through the warm cache when `checkpoint_path` is set.

Disaggregated tiers (`role`, engine/disagg/): a "prefill" engine builds
prompt KV that the host cuts into handoff frames from the slot lane
(`extract_slot_kv`) and never decodes; a "decode" engine adopts those
frames into its block pool (`adopt_prefix`), so the request admits through
the ordinary prefix-hit path. Device-time probes (`profile_sample`,
utils/devprof.py) time 1 in N dispatches of each kind on the card.

Tensor parallelism (`mesh`, parallel/): a mesh whose `model` axis is N
runs N engines, one per rank (process), each holding its block of the
params (models/llama.py shard_params: `params` passed with a mesh are
this rank's blocks) and of the KV cache and prefix pool (its kv heads,
cache_logical_axes). Every rank's host state -- slot lengths, keys, the
radix tree -- is the same: rank 0's scheduler drives all of them through
parallel/multihost.py's command loop. Knobs outside this slice (any other
mesh axis, dcn_data, MoE on a mesh, pipeline microbatches, ring_mesh)
raise EngineError naming their ROADMAP item.

The engine is synchronous and single-threaded by design: exactly one thread
(the scheduler's engine thread) may call the mutating methods.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from symmetry_tpu_torch.engine.disagg.frames import BFloat16Array, wire_dtype
from symmetry_tpu_torch.engine.prefix_cache import (
    BlockPool,
    RadixHit,
    RadixIndex,
)
from symmetry_tpu_torch.engine.spec import SpecConfig
from symmetry_tpu_torch.engine.tokenizer import Tokenizer, get_tokenizer
from symmetry_tpu_torch.engine.weights import (
    CheckpointError,
    load_checkpoint,
    load_warm_cache,
    read_hf_config,
    save_warm_cache,
    warm_cache_current,
)
from symmetry_tpu_torch.models.llama import (
    KVCache,
    ModelConfig,
    forward_hidden,
    init_cache,
    init_params,
    logits_from_hidden,
    pack_params,
    param_logical_axes,
    preset,
    scale_axes,
)
from symmetry_tpu_torch.ops import kernels, prng
from symmetry_tpu_torch.ops.quant import PackedQuantizedTensor, QuantizedTensor
from symmetry_tpu_torch.ops.sampling import sample_tokens, verify_tokens
from symmetry_tpu_torch.parallel.mesh import MeshSpec, build_mesh
from symmetry_tpu_torch.parallel.multihost import (
    build_multihost_mesh,
    init_distributed,
)
from symmetry_tpu_torch.parallel.sharding import Sharding, logical_to_spec
from symmetry_tpu_torch.utils.devprof import DeviceProfiler
from symmetry_tpu_torch.utils.logging import logger
from symmetry_tpu_torch.utils.metrics import METRICS, MetricName

class EngineError(RuntimeError):
    pass


class DecodeState(NamedTuple):
    """Everything the decode step needs, all static-shape device tensors.

    Per-slot PRNG keys are threefry key data, as the JAX engine's
    (ops/prng.py): every decode step splits a slot's key into its next key
    and the key of that step's draw."""

    cache: KVCache             # [L, B, T, K, D] x2 + lengths [B]
    last_token: torch.Tensor   # [B] int64 — token to feed next step
    temperature: torch.Tensor  # [B] float32
    top_p: torch.Tensor        # [B] float32
    top_k: torch.Tensor        # [B] int64
    rng: torch.Tensor          # [B, 2] int64 — one key chain PER SLOT


@dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0
    top_p: float = 1.0
    top_k: int = 0
    seed: int | None = None
    # Stream resumption: how many tokens of this request's completion were
    # already sampled before this admission. A SEEDED request's key chain
    # is walked past that many draws, so the resumed continuation samples
    # exactly the tokens the uninterrupted run would have. Ignored without
    # a seed.
    rng_skip: int = 0

    @classmethod
    def from_request(cls, req: Any) -> "SamplingParams":
        return cls(
            temperature=req.temperature if req.temperature is not None else 0.0,
            top_p=req.top_p if req.top_p is not None else 1.0,
            top_k=getattr(req, "top_k", None) or 0,
            seed=req.seed,
        )


@dataclass
class ChunkedPrefill:
    """An in-progress chunked prefill: one prompt's KV prefix being built
    chunk by chunk, so that admitting a long prompt never stalls the active
    decode streams for more than about one chunk.

    With `start_pos` > 0 the cache was SEEDED from a prefix-cache hit (its
    first start_pos positions already hold that prefix's KV) and `ids`
    carries only the uncached suffix. The prefill key draws the first
    token; the decode key goes into the slot."""

    slot: int
    ids: np.ndarray           # [1, n_chunks * C] padded suffix tokens
    true_len: int             # FULL prompt length (prefix + suffix)
    n_chunks: int
    cache: Any                # batch-1 prefix KVCache (bucket capacity)
    temp: torch.Tensor        # [1]
    top_p: torch.Tensor       # [1]
    top_k: torch.Tensor       # [1]
    prefill_key: torch.Tensor  # [1, 2] draws the first token
    decode_key: torch.Tensor   # [1, 2] the slot's key chain from there
    done_chunks: int = 0
    start_pos: int = 0        # tokens already in the cache at start
    full_ids: tuple[int, ...] = ()  # the whole prompt (prefix-store key)

    @property
    def remaining_chunks(self) -> int:
        return self.n_chunks - self.done_chunks

    @property
    def suffix_len(self) -> int:
        return self.true_len - self.start_pos


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
    "mesh": "a mesh axis other than `model` (data, context, stage, "
            "expert: ROADMAP Queue 1 item 14)",
    "dcn_data": "a data axis across hosts (dcn_data > 1: ROADMAP Queue 1 "
                "item 14)",
    "moe_mesh": "MoE on a mesh (ROADMAP Queue 1 item 14)",
    "pipeline_microbatches": "pipeline parallelism (ROADMAP Queue 1 item 14)",
}

# KV cache dtype -> the dtype name its handoff planes travel under.
_WIRE_DTYPES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                torch.float16: "float16", torch.int8: "int8"}


def to_numpy_plane(t: torch.Tensor) -> np.ndarray:
    """A KV plane as a host numpy array for a handoff frame: bf16 as its
    uint16 words (frames.BFloat16Array), which the frame writes under the
    name "bfloat16"."""
    if t.dtype == torch.bfloat16:
        return t.cpu().view(torch.uint16).numpy().view(BFloat16Array)
    return t.cpu().numpy()


def from_numpy_plane(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """The inverse of to_numpy_plane, onto `device`."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if isinstance(a, BFloat16Array):
        t = t.view(torch.bfloat16)
    return t.to(device)


def _refuse(knob: str) -> EngineError:
    return EngineError(f"{knob}: {_NOT_PORTED[knob]} is not ported to the "
                       f"PyTorch engine yet")


def check_mesh(shape: dict[str, int], config: ModelConfig | None = None
               ) -> None:
    """Refuse a mesh this slice does not serve: any axis but `model` above
    1, MoE on a mesh, or a model axis that does not divide the heads, kv
    heads, MLP width and vocabulary (each rank holds an equal block)."""
    if any(n > 1 for axis, n in shape.items() if axis != "model"):
        raise _refuse("mesh")
    tp = int(shape.get("model", 1))
    if tp == 1 or config is None:
        return
    if getattr(config, "num_experts", 0):
        raise _refuse("moe_mesh")
    for what, n in (("num_heads", config.num_heads),
                    ("num_kv_heads", config.num_kv_heads),
                    ("intermediate_size", config.intermediate_size),
                    ("vocab_size", config.vocab_size)):
        if n % tp:
            raise EngineError(f"mesh model={tp} does not divide {what} "
                              f"{n}: every rank holds an equal block")


class InferenceEngine:
    """Owns params + decode state; exposes prefill/insert/decode primitives.

    The constructor keeps the JAX engine's signature plus `device`, with
    one default changed: prefill_chunk is None (every prompt takes the
    one-dispatch flash prefill) unless the caller sets it, as
    from_tpu_config does from the provider's `tpu:` section (256 there).

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
        speculative: SpecConfig | None = None,
        fused_dequant: bool = False,
        role: str = "unified",
        profile_sample: int = 0,
        device: str | torch.device = "cuda",
    ) -> None:
        if pipeline_microbatches > 1:
            raise _refuse("pipeline_microbatches")
        if mesh is not None:
            check_mesh(mesh.shape, config)
            if role != "unified":
                # Handoff frames are host-side snapshots of the whole
                # cache; a rank holds only its kv heads (the JAX engine's
                # refusal, for its own reason).
                raise EngineError(
                    f"tpu.role {role!r} supports single-device engines "
                    f"only (KV handoff snapshots the cache host-side); "
                    f"drop the role or the mesh")
            if mesh.size == 1:
                mesh = None
            elif torch.device(device) != mesh.device:
                raise EngineError(f"engine device {device} is not this "
                                  f"rank's mesh device {mesh.device}")
        self.mesh = mesh
        # Disaggregated prefill/decode (engine/disagg/): "unified" prefills
        # AND decodes; "prefill" builds prompt KV and hands it off (never
        # decodes; warmup skips the decode side); "decode" adopts handed-off
        # KV through the prefix store and generates. The role gates which
        # paths warmup runs and which scheduler paths serve; it changes no
        # computation.
        if role not in ("unified", "prefill", "decode"):
            raise EngineError(
                f"unknown engine role {role!r}; expected unified, "
                f"prefill, or decode (disagg is a backend-level role — "
                f"the broker assigns prefill/decode to its two hosts)")
        self.role = role
        # symprof (utils/devprof.py, tpu.profile_sample): sampling
        # completion probes around every dispatch kind below. Off (0) = one
        # branch per dispatch: every hook is guarded by `dp.enabled`.
        self.devprof = DeviceProfiler(profile_sample)
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
        if prefill_chunk is not None and prefill_chunk < 1:
            raise EngineError("prefill_chunk must be >= 1 (or None)")
        self.prefill_chunk = prefill_chunk
        self.prefill_token_budget = (prefill_token_budget
                                     if prefill_token_budget is not None
                                     else self.PREFILL_TOKEN_BUDGET)
        if self.prefill_token_budget < 1:
            raise EngineError("prefill_token_budget must be >= 1")
        # Speculative decoding (engine/spec/): None keeps the serving path
        # as it is -- no verify dispatch, the scheduler never drafts,
        # warmup runs the same shapes.
        self.spec = speculative
        if self.spec is not None and 1 + self.spec.k_draft > max_seq_len:
            raise EngineError(
                f"speculative k_draft {self.spec.k_draft} does not fit "
                f"max_seq_len {max_seq_len}")

        dev = self.device
        self.state = DecodeState(
            cache=init_cache(config, max_slots, max_seq_len, cache_dtype,
                             quantized=self.kv_quant, device=dev,
                             mesh=self.mesh),
            last_token=torch.zeros(max_slots, dtype=torch.int64, device=dev),
            temperature=torch.zeros(max_slots, dtype=torch.float32,
                                    device=dev),
            top_p=torch.ones(max_slots, dtype=torch.float32, device=dev),
            top_k=torch.zeros(max_slots, dtype=torch.int64, device=dev),
            rng=prng.split(torch.tensor(prng.key_data(0), device=dev),
                           max_slots),
        )
        self._base_key = prng.key_data(
            int.from_bytes(os.urandom(4), "little"))
        self._requests_served = 0
        # (batch, bucket) -> persistent prefill buffer; see
        # _prefill_scratch_for.
        self._prefill_scratch: dict[tuple[int, int], KVCache] = {}

        # Radix prefix cache over a paged KV block pool. `prefix_align` is
        # the suffix width of the one-dispatch hit path (min(prefill_chunk,
        # smallest bucket)); matching is at `prefix_block` granularity. Off
        # by default (budget 0, or no prefill_chunk): no lookups, no pool.
        self.prefix_align = (min(self.prefill_chunk, self.prefill_buckets[0])
                             if self.prefill_chunk is not None else None)
        self.prefix_block = int(prefix_block_tokens)
        if self.prefix_block < 1:
            raise EngineError("prefix_block_tokens must be >= 1")
        self.block_pool: BlockPool | None = None
        self.prefix_index: RadixIndex | None = None
        self._pool_kv: KVCache | None = None
        # Pool-gossip rider: digests per summary, and the minimum seconds
        # between recomputes (stats probes share one walk).
        self.prefix_gossip_blocks = int(prefix_gossip_blocks)
        self.prefix_gossip_s = float(prefix_gossip_s)
        self._gossip_cache: tuple[float, dict | None] | None = None
        if prefix_cache_bytes > 0 and self.prefix_align:
            for b in self.prefill_buckets:
                if b % self.prefix_block:
                    raise EngineError(
                        f"prefix_block_tokens {self.prefix_block} must "
                        f"divide every prefill bucket (bucket {b} does "
                        f"not): the block gathers and scatters index "
                        f"buckets in whole blocks")
            block_bytes = self.prefix_block * self.kv_bytes_per_token()
            n_blocks = int(prefix_cache_bytes) // block_bytes
            if self.role == "decode":
                # Geometry floor, not a fixed MB knob: adopting a
                # largest-bucket prompt must never be rejected by a budget
                # too small for the model at hand. Two largest prefixes'
                # worth keeps one pinned mid-copy while the next adopts.
                n_blocks = max(n_blocks, 2 * (self.prefill_buckets[-1]
                                              // self.prefix_block))
            # The pool must at least hold one smallest-bucket prefix or
            # every insert is a guaranteed rejection.
            n_blocks = max(n_blocks,
                           self.prefill_buckets[0] // self.prefix_block)
            self.block_pool = BlockPool(n_blocks, self.prefix_block,
                                        block_bytes)
            self.prefix_index = RadixIndex(self.block_pool)
            # The device half, allocated once: [L, n_blocks + 1, block, K,
            # D] (+1: id 0 is the trash block that pad lanes write to).
            self._pool_kv = init_cache(config, n_blocks + 1,
                                       self.prefix_block, cache_dtype,
                                       quantized=self.kv_quant, device=dev,
                                       mesh=self.mesh)
        if self.role == "decode" and self.prefix_index is None:
            # Adoption lands handed-off KV through the radix index; without
            # it every migrated request would re-prefill from scratch.
            raise EngineError(
                "role: decode requires the prefix cache "
                "(tpu.prefix_cache_mb > 0 and a prefill_chunk) — "
                "handoff frames are adopted through it")
        if self.role == "prefill" and not self.prefix_align:
            raise EngineError(
                "role: prefill requires tpu.prefill_chunk — the decode "
                "tier's suffix dispatch needs its shape")

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
        self.params = pack_params(self.params, config=self.config,
                                  mesh=self.mesh, report=degrades)
        for path, reason in degrades:
            logger.warning(f"fused_dequant: {path} stays on the mixed dot "
                           f"(reason: {reason})")
            fallback.inc(reason=reason)

    # ------------------------------------------------------------------
    # Device primitives

    def _prefill(self, tokens, true_len, temp, top_p, top_k, keys,
                 scratch: KVCache):
        """tokens [N, Sb] padded; returns (first tokens [N], prefix KV).

        N > 1 is COALESCED prefill (the scheduler batches concurrent
        arrivals into one dispatch). `scratch` is the persistent prefix
        buffer of this (N, Sb) shape (_prefill_scratch_for), written in
        place: the prefill-from-empty trunk writes every one of its Sb
        positions (and, for an int8 cache, their scales) and flash
        attention never reads it back, so dirty reuse is sound once the
        lengths are reset to the empty-cache contract."""
        cache = scratch._replace(lengths=torch.zeros_like(scratch.lengths))
        h, cache = forward_hidden(self.params, self.config, tokens, cache,
                                  seq_lens=true_len, prefill_flash=True,
                                  mesh=self.mesh)
        return self._sample_at(h, true_len - 1, temp, top_p, top_k,
                               keys), cache

    def _sample_at(self, h, last_idx, temp, top_p, top_k, keys):
        """Project ONLY position last_idx[n] of each row through the LM head
        and sample the first tokens [N]."""
        rows = torch.arange(h.shape[0], device=self.device)
        h_last = h[rows, last_idx.long()][:, None]               # [N, 1, E]
        last = logits_from_hidden(self.params, self.config, h_last,
                                  self.mesh)[:, 0]
        return sample_tokens(last, keys, temp, top_p, top_k)

    def _chunk_step(self, tokens, cache: KVCache, seq_len) -> KVCache:
        """Extend a prefix cache by one prompt chunk through the
        continuation path (absolute-position masking against the KV that
        earlier chunks wrote; the flash path's empty-cache contract does
        not hold past chunk 0)."""
        _, cache = forward_hidden(self.params, self.config, tokens, cache,
                                  seq_lens=seq_len, mesh=self.mesh)
        return cache

    def _chunk_final(self, tokens, cache: KVCache, seq_len, last_idx, temp,
                     top_p, top_k, keys):
        """Last chunk (or a cached hit's suffix): also sample the first
        token at last_idx, as `_prefill` does."""
        h, cache = forward_hidden(self.params, self.config, tokens, cache,
                                  seq_lens=seq_len, mesh=self.mesh)
        return self._sample_at(h, last_idx, temp, top_p, top_k,
                               keys), cache

    def _insert_all(self, prefix: KVCache, slots: np.ndarray, true_len,
                    first_token, temp, top_p, top_k, decode_keys) -> None:
        """Install a coalesced prefill in place, each slot from its LAST
        row. Pad rows replay the last real request into its slot: in a
        dense model they are bit-identical to it, but in an MoE model they
        compete with it for expert capacity and can differ, and a CUDA
        scatter with repeated indices writes them in no fixed order. The
        last row is what a sequential scatter (the CPU's, the JAX
        engine's) leaves."""
        st = self.state
        last = sorted({int(s): i for i, s in enumerate(slots)}.values())
        rows = None
        if len(last) < len(slots):
            rows = self._dev(np.asarray(last, np.int64))
            slots = slots[last]

        def pick(t, dim=0):
            return t if rows is None else t.index_select(dim, rows)

        slots = self._dev(slots)
        Sb = prefix.k.shape[2]
        st.cache.k[:, slots, :Sb] = pick(prefix.k, 1)
        st.cache.v[:, slots, :Sb] = pick(prefix.v, 1)
        if self.kv_quant:
            st.cache.k_scale[:, slots, :, :Sb] = pick(prefix.k_scale, 1)
            st.cache.v_scale[:, slots, :, :Sb] = pick(prefix.v_scale, 1)
        # The first sampled token's KV is not written yet: the next decode
        # step writes it at position true_len.
        st.cache.lengths[slots] = pick(true_len)
        st.last_token[slots] = pick(first_token)
        st.temperature[slots] = pick(temp)
        st.top_p[slots] = pick(top_p)
        st.top_k[slots] = pick(top_k)
        st.rng[slots] = pick(decode_keys)

    # Block pool moves (the radix prefix cache's device side).

    def _insert_from_blocks(self, scratch: KVCache, ids, p: int) -> KVCache:
        """Seed every row of a (batch, bucket) working buffer from pool
        blocks, in place: `ids` [bucket // prefix_block] names the block
        covering each bucket span (pad lanes carry the trash block; their
        garbage lands at positions >= p, which the suffix continuation
        never attends) and every row's length becomes `p`."""
        L, B = scratch.k.shape[:2]

        def gather(pool_arr, dst):
            sel = pool_arr[:, ids]                      # [L, nb, PB, K, D]
            dst.copy_(sel.reshape((L, 1, -1) + sel.shape[3:]).expand_as(dst))

        def gather_scale(pool_arr, dst):
            sel = pool_arr[:, ids].movedim(1, 2)        # [L, K, nb, PB]
            dst.copy_(sel.reshape(L, 1, sel.shape[1], -1).expand_as(dst))

        pool = self._pool_kv
        gather(pool.k, scratch.k)
        gather(pool.v, scratch.v)
        if self.kv_quant:
            gather_scale(pool.k_scale, scratch.k_scale)
            gather_scale(pool.v_scale, scratch.v_scale)
        return scratch._replace(lengths=torch.full_like(scratch.lengths, p))

    def _write_blocks(self, row: KVCache, ids) -> None:
        """Scatter a batch-1 row buffer (capacity one bucket) into pool
        blocks, in place: bucket span j lands in block ids[j]. Spans not to
        be stored (resident prefix blocks, positions past the prefix) point
        at the trash block, where nobody reads."""
        pool, nb = self._pool_kv, ids.shape[0]

        def put(pool_arr, row_arr):
            src = row_arr[:, 0].reshape((row_arr.shape[0], nb, -1)
                                        + row_arr.shape[3:])
            pool_arr[:, ids] = src.to(pool_arr.dtype)

        def put_scale(pool_arr, row_arr):
            src = row_arr[:, 0].reshape(row_arr.shape[0], row_arr.shape[2],
                                        nb, -1).movedim(2, 1)
            pool_arr[:, ids] = src.to(pool_arr.dtype)   # [L, nb, K, PB]

        put(pool.k, row.k)
        put(pool.v, row.v)
        if self.kv_quant:
            put_scale(pool.k_scale, row.k_scale)
            put_scale(pool.v_scale, row.v_scale)

    def _extract_prefix_row(self, prefix: KVCache, row: int, p: int
                            ) -> KVCache:
        """Row `row` of a batch-N prefill buffer as a batch-1 buffer valid
        through `p` tokens. A view, not a copy: the scatter that reads it
        is queued before the buffer's next use (device order is FIFO)."""

        def take(arr):
            return arr[:, row:row + 1] if arr is not None else None

        return KVCache(k=take(prefix.k), v=take(prefix.v),
                       lengths=torch.full((1,), p, dtype=torch.int32,
                                          device=self.device),
                       k_scale=take(prefix.k_scale),
                       v_scale=take(prefix.v_scale))

    def _decode_one(self) -> torch.Tensor:
        """Advance every slot one token."""
        st = self.state
        h, cache = forward_hidden(self.params, self.config,
                                  st.last_token[:, None], st.cache,
                                  mesh=self.mesh)
        logits = logits_from_hidden(self.params, self.config, h,
                                    self.mesh)[:, 0]
        # Each slot's key splits into its next key and this step's draw.
        keys = prng.split(st.rng)
        toks = sample_tokens(logits, keys[:, 1], st.temperature,
                             st.top_p, st.top_k)
        self.state = st._replace(cache=cache, last_token=toks,
                                 rng=keys[:, 0])
        return toks

    def _verify(self, draft: torch.Tensor, n_draft: torch.Tensor):
        """Speculative verify: ONE batched forward over [B, 1 + k_draft]
        positions -- the pending last_token plus every slot's drafted
        continuation -- then per-position acceptance (verify_tokens) and a
        per-slot rollback of the cache lengths to the first rejection.

        The trunk is the continuation path the chunks run (absolute-
        position causal masking against the live cache), so KV for all
        1 + k positions is written in place; positions past each slot's
        seq_len write garbage that the rolled-back lengths exclude and
        later writes overwrite -- the rollback is one lengths update, no
        data movement. A slot with n_draft 0 advances exactly one token,
        like a plain decode step. Returns (tokens [1 + k, B], n_emit [B])."""
        st = self.state
        tokens = torch.cat([st.last_token[:, None], draft], dim=1)
        old_lengths = st.cache.lengths
        h, cache = forward_hidden(self.params, self.config, tokens, st.cache,
                                  seq_lens=1 + n_draft, mesh=self.mesh)
        # The head over all 1 + k positions: every lane is a candidate.
        logits = logits_from_hidden(self.params, self.config, h, self.mesh)
        # One split of each slot's key per verify, as a decode step takes.
        keys = prng.split(st.rng)
        out, n_emit = verify_tokens(logits, draft, n_draft, keys[:, 1],
                                    st.temperature, st.top_p, st.top_k)
        last = torch.gather(out, 1, (n_emit - 1).long()[:, None])[:, 0]
        self.state = st._replace(
            cache=cache._replace(lengths=old_lengths + n_emit),
            last_token=last, rng=keys[:, 0])
        return out.T, n_emit

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

    def _request_keys(self, sampling: SamplingParams) -> tuple:
        """(prefill key, decode key) for one request, as the JAX engine
        derives them: a seeded request splits `key(seed)`, an unseeded one
        `fold_in(base key, requests served)`. `rng_skip` walks a seeded
        request's chain past the draws its interrupted run already made:
        the uninterrupted run samples token 1 with the prefill key and
        token i + 1 with the i-th decode split, so a resume after N tokens
        takes the N-th step key and the N-th carry (the JAX engine's
        `rng_resume`)."""
        skip = max(0, int(sampling.rng_skip or 0))
        if sampling.seed is not None:
            pk, dk = prng.split_key(prng.key_data(sampling.seed))
            for _ in range(skip):
                dk, pk = prng.split_key(dk)
            return pk, dk
        self._requests_served += 1
        return tuple(prng.split_key(
            prng.fold_in_key(self._base_key, self._requests_served)))

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
        rows = self._sampling_rows(assignments, batch)
        slots = np.zeros((batch,), np.int64)
        for i in range(batch):
            # Pad rows replay the last request BIT-IDENTICALLY (same prompt,
            # slot and keys; _sampling_rows): every row is inserted,
            # and anything short of an identical overwrite would corrupt
            # the last real slot's state.
            slot, ids, _ = assignments[min(i, n_req - 1)]
            slots[i] = slot
            padded[i, :len(ids)] = ids
            lens[i] = len(ids)

        lens_t = self._dev(lens)
        dp = self.devprof
        t_dp = dp.begin() if dp.enabled else 0.0
        toks, prefix = self._prefill(self._dev(padded), lens_t, *rows[:4],
                                     self._prefill_scratch_for(batch,
                                                               bucket))
        # The prefill drew with the prefill keys; the slots carry on with
        # the decode keys.
        self._insert_all(prefix, slots, lens_t, toks, *rows[:3], rows[4])
        if dp.enabled:
            # The probe covers the prefill + insert chain (one stream, so
            # the event after the insert follows both).
            dp.probe("prefill", self.state.last_token, t_dp)
        # Populate the prefix cache from this batch before the buffer goes
        # back to the pool (the next same-shape prefill overwrites it).
        if self.prefix_index is not None:
            self.prefix_index.note_miss(n_req)  # admitted uncached
            self._maybe_store_prefix(assignments[:n_req], prefix)
        self._store_prefill_scratch(batch, bucket, prefix)
        host_toks = toks.cpu().numpy()
        return [int(host_toks[i]) for i in range(n_req)]

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _sampling_rows(self, assignments, batch: int) -> tuple:
        """(temperature, top_p, top_k, prefill keys, decode keys) device
        tensors ([batch], keys [batch, 2]) for a dispatch: one key
        derivation per real request (shared by every admission path, so a
        seeded request samples identically however it was admitted), pad
        rows copying the last request."""
        n_req = len(assignments)
        temps = np.zeros((batch,), np.float32)
        top_ps = np.ones((batch,), np.float32)
        top_ks = np.zeros((batch,), np.int64)
        pkeys = np.zeros((batch, 2), np.int64)
        dkeys = np.zeros((batch, 2), np.int64)
        for i in range(batch):
            sampling = assignments[min(i, n_req - 1)][2]
            temps[i] = sampling.temperature
            top_ps[i] = sampling.top_p
            top_ks[i] = sampling.top_k
            if i >= n_req:
                pkeys[i], dkeys[i] = pkeys[n_req - 1], dkeys[n_req - 1]
            else:
                pkeys[i], dkeys[i] = self._request_keys(sampling)
        return tuple(self._dev(a) for a in (temps, top_ps, top_ks, pkeys,
                                            dkeys))

    # ------------------------------------------------------------------
    # Shared-prefix KV cache (engine side; bookkeeping in prefix_cache.py)

    def prefix_lookup(self, prompt_ids: list[int]) -> RadixHit | None:
        """Pinned longest block-aligned prefix hit for this prompt, or None.
        The scheduler groups admissions by the hit's group key and must
        release() hits it does not dispatch; the engine releases hits it
        consumes."""
        if self.prefix_index is None:
            return None
        return self.prefix_index.lookup(prompt_ids)

    def _bucket_ids(self, bucket: int, blocks=(), at: int = 0
                    ) -> torch.Tensor:
        """Block-id lane vector for one bucket's gather or scatter: lane j
        covers bucket positions [j * PB, (j + 1) * PB). Lanes outside
        `blocks` (placed from lane `at`) carry the trash block 0."""
        ids = np.zeros((bucket // self.prefix_block,), np.int64)
        if len(blocks):
            ids[at:at + len(blocks)] = blocks
        return self._dev(ids)

    def seeded_chunk_ok(self, prompt_len: int) -> bool:
        """True when a long-suffix hit can run as a seeded chunked prefill:
        the prompt's bucket holds more than one chunk (the JAX engine
        compiles chunk programs only there; the port keeps its routing)."""
        return (self.prefill_chunk is not None
                and self.bucket_for(prompt_len) > self.prefill_chunk)

    def prefill_and_insert_cached(
        self, assignments: list[tuple[int, list[int], SamplingParams]],
        hit: RadixHit,
    ) -> list[int]:
        """Admit a group of requests that SHARE a cached prefix: one block
        gather seeds every row of the (batch, bucket) working buffer, one
        continuation dispatch prefills only the uncached suffixes (at most
        prefix_align tokens each) and samples first tokens, one insert
        installs every slot. The finished rows then extend the radix tree
        with their new tail blocks. Releases `hit` in all paths."""
        try:
            if not assignments:
                return []
            p, A = hit.length, self.prefix_align
            n_req = len(assignments)
            bucket = max(self.bucket_for(len(ids))
                         for _, ids, _ in assignments)
            allowed = self.prefill_batches_for(bucket)
            if n_req > allowed[-1]:
                raise EngineError(
                    f"cached-prefill group of {n_req} exceeds the bucket's "
                    f"batch cap {allowed[-1]} (scheduler partitions to cap)")
            for _, ids, _ in assignments:
                if not p < len(ids) <= p + A:
                    raise EngineError(
                        f"cached-prefill suffix out of range: prompt "
                        f"{len(ids)} vs prefix {p} (suffix cap {A})")
                if tuple(ids[:p]) != hit.tokens:
                    raise EngineError("prompt diverges from cached prefix")
            batch = next(b for b in allowed if b >= n_req)

            suffix = np.zeros((batch, A), np.int64)
            sfx_lens = np.zeros((batch,), np.int32)
            full_lens = np.zeros((batch,), np.int32)
            slots = np.zeros((batch,), np.int64)
            for i in range(batch):
                # pad rows replay the last request bit-identically
                slot, ids, _ = assignments[min(i, n_req - 1)]
                sfx = ids[p:]
                suffix[i, :len(sfx)] = sfx
                sfx_lens[i] = len(sfx)
                full_lens[i] = len(ids)
                slots[i] = slot
            rows = self._sampling_rows(assignments, batch)

            dp = self.devprof
            t_dp = dp.begin() if dp.enabled else 0.0
            scratch = self._insert_from_blocks(
                self._prefill_scratch_for(batch, bucket),
                self._bucket_ids(bucket, hit.blocks), p)
            if dp.enabled:
                dp.probe("seed_gather", scratch.k, t_dp)
            # The gather out of the pool is queued ahead of any later
            # scatter into a since-freed block: safe to unpin now.
            hit.release()
            sfx_t = self._dev(sfx_lens)
            t_dp = dp.begin() if dp.enabled else 0.0
            toks, prefix = self._chunk_final(self._dev(suffix), scratch,
                                             sfx_t, sfx_t - 1, *rows[:4])
            self._insert_all(prefix, slots, self._dev(full_lens), toks,
                             *rows[:3], rows[4])
            if dp.enabled:
                # The cached-hit suffix dispatch is still a prefill on the
                # device (chunk_final + insert over the seeded rows).
                dp.probe("prefill", self.state.last_token, t_dp)
            # The rows hold prefix + suffix KV: extend the tree with the new
            # tail blocks before the buffer goes back to the scratch pool,
            # so the next turn of a session hits at its full history.
            self._maybe_store_prefix(assignments[:n_req], prefix)
            self._store_prefill_scratch(batch, bucket, prefix)
            self.prefix_index.note_reuse(n_req, p)
            host_toks = toks.cpu().numpy()
            return [int(host_toks[i]) for i in range(n_req)]
        finally:
            hit.release()

    def _maybe_store_prefix(self, assignments, prefix: KVCache) -> None:
        """Store ONE newly built prefix of a prefill batch into the pool (at
        most one scatter per admission dispatch): the first row whose
        whole-block prefix has an unresident tail. Only the NEW blocks are
        written; blocks the tree holds stay shared by reference."""
        PB = self.prefix_block
        for row, (_slot, ids, _sampling) in enumerate(assignments):
            p = PB * (len(ids) // PB)
            if p < PB:
                continue
            dp = self.devprof
            t_dp = 0.0
            plan = self.prefix_index.plan_insert(ids[:p])
            if plan is None:
                continue  # fully resident, or rejected even after LRU
            try:
                # inside the try: a failed dispatch must abort the plan, or
                # its pinned prefix and allocated blocks leak. The probe's
                # begin() sits here too: only a path that dispatches may
                # close a pending dispatch gap.
                if dp.enabled:
                    t_dp = dp.begin()
                row_cache = self._extract_prefix_row(prefix, row, p)
                self._write_blocks(row_cache, self._bucket_ids(
                    row_cache.k.shape[2], plan.new_ids,
                    at=plan.matched_len // PB))
            except Exception:
                plan.abort()
                raise
            plan.commit()
            if dp.enabled:
                dp.probe("scatter", self._pool_kv.k, t_dp)
            return

    def prefix_cache_stats(self) -> dict | None:
        return (self.prefix_index.stats()
                if self.prefix_index is not None else None)

    def prefix_cache_summary(self) -> dict | None:
        """Compact radix-cache summary for pool gossip (RadixIndex.summary),
        recomputed at most every `prefix_gossip_s` seconds. None when the
        cache or the rider is off. Read from the host's serve thread; the
        walk is read-only."""
        if self.prefix_index is None or self.prefix_gossip_blocks <= 0:
            return None
        now = time.monotonic()
        cached = self._gossip_cache
        if cached is not None and now - cached[0] < self.prefix_gossip_s:
            return cached[1]
        summary = self.prefix_index.summary(self.prefix_gossip_blocks)
        self._gossip_cache = (now, summary)
        return summary

    def kv_bytes_per_token(self) -> int:
        """Bytes of KV one token position occupies: k + v payloads, plus
        the scale planes when int8."""
        c = self.config
        per_plane = c.num_layers * c.num_kv_heads
        if self.kv_quant:
            return 2 * per_plane * (c.dim_per_head + 4)
        itemsize = torch.empty((), dtype=self.cache_dtype).element_size()
        return 2 * per_plane * c.dim_per_head * itemsize

    # ------------------------------------------------------------------
    # Disaggregated prefill/decode (engine side; frames in engine/disagg/)

    def extract_slot_kv(self, slot: int, p: int) -> KVCache:
        """Batch-1 snapshot of decode-lane `slot`'s KV, lengths pinned to
        `p` — the device half of a prefill-tier handoff. Every admission
        path ends by inserting the prompt's KV into the slot lane, so
        extracting from the lane is uniform across all of them. A view
        (the prefix-cache row extract), trimmed to the smallest prefill
        bucket holding `p`, so the host copy the caller makes scales with
        the prompt, not max_seq_len. The caller copies it to the host
        before the lane can be reused (the handoff sink runs on the engine
        thread, ahead of any next admission)."""
        if not 0 <= slot < self.max_slots:
            raise EngineError(f"extract_slot_kv: slot {slot} out of range")
        row = self._extract_prefix_row(self.state.cache, slot, p)
        cap = self.bucket_for(max(int(p), 1))
        if cap >= self.max_seq_len:
            return row

        def cut(arr, axis):
            return arr.narrow(axis, 0, cap) if arr is not None else None

        return row._replace(k=cut(row.k, 2), v=cut(row.v, 2),
                            k_scale=cut(row.k_scale, 3),
                            v_scale=cut(row.v_scale, 3))

    def _upload_row(self, planes: dict[str, np.ndarray], p: int) -> KVCache:
        """A batch-1 row buffer from host planes (to_numpy_plane layout),
        on the engine's device, valid through `p` tokens."""
        def up(key):
            a = planes.get(key)
            return from_numpy_plane(a, self.device) if a is not None else None

        return KVCache(k=up("k"), v=up("v"),
                       lengths=torch.full((1,), p, dtype=torch.int32,
                                          device=self.device),
                       k_scale=up("k_scale"), v_scale=up("v_scale"))

    def _host_row(self, capacity: int) -> dict[str, np.ndarray]:
        """Zeroed host planes of one batch-1 row of `capacity` positions,
        in this engine's cache dtype (bf16 as frames.BFloat16Array)."""
        c = self.config
        shape = (c.num_layers, 1, capacity, c.num_kv_heads, c.dim_per_head)
        if self.kv_quant:
            scales = (c.num_layers, 1, c.num_kv_heads, capacity)
            return {"k": np.zeros(shape, np.int8),
                    "v": np.zeros(shape, np.int8),
                    "k_scale": np.zeros(scales, np.float32),
                    "v_scale": np.zeros(scales, np.float32)}
        if self.cache_dtype == torch.bfloat16:
            return {key: np.zeros(shape, np.uint16).view(BFloat16Array)
                    for key in ("k", "v")}
        dtype = np.dtype(_WIRE_DTYPES[self.cache_dtype])
        return {"k": np.zeros(shape, dtype), "v": np.zeros(shape, dtype)}

    def adopt_prefix(self, handoff) -> bool:
        """Decode-tier adoption: a deserialized KV handoff (engine/disagg/
        frames.py KVHandoff, block-manifest format) lands in the radix
        tree, so the migrated request admits through the ordinary cached
        path — one block gather and one suffix dispatch, as a local prefix
        hit does.

        Blocks the sender skipped (already shipped once) OR that this tree
        already holds adopt BY REFERENCE — only new blocks are assembled
        into one bucket-padded row and scattered into the pool in a single
        dispatch. The adopted prefix is the longest leading run of
        resident-or-shipped blocks (a skipped block this tier has since
        evicted shortens the run; the request re-prefills a longer suffix).

        Returns True when a non-empty prefix is (or already was) resident,
        False when nothing could be adopted (routing-only frame, pool
        rejection) — the request then admits through a full prefill.
        Structural mismatches between the frame and this engine's
        model/cache geometry raise: adopting wrong-shaped or wrong-dtype KV
        would stream garbage."""
        if self.prefix_index is None:
            raise EngineError("adopt_prefix requires the prefix cache "
                              "(role: decode builds it by contract)")
        p = int(handoff.p)
        if p <= 0:
            return False  # routing-only handoff: nothing to adopt
        PB = self.prefix_block
        bs = int(handoff.block_size)
        if p % bs:
            raise EngineError(f"handoff prefix length {p} is not a "
                              f"multiple of its block size {bs}")
        if bool(handoff.kv_quant) != bool(self.kv_quant):
            raise EngineError(
                f"handoff KV quantization ({handoff.kv_quant}) disagrees "
                f"with this engine ({self.kv_quant}) — tiers must share "
                f"the cache layout")
        c = self.config
        want = (c.num_layers, 1, bs, c.num_kv_heads, c.dim_per_head)
        want_dtype = _WIRE_DTYPES[torch.int8 if self.kv_quant
                                  else self.cache_dtype]
        for j, planes in handoff.blocks.items():
            k, v = planes["k"], planes["v"]
            if k.shape != want or v.shape != want:
                raise EngineError(
                    f"handoff block {j} KV shape {k.shape} does not "
                    f"match this model ({want})")
            if wire_dtype(k) != want_dtype or wire_dtype(v) != want_dtype:
                raise EngineError(
                    f"handoff block {j} KV dtype {wire_dtype(k)} does not "
                    f"match this engine's cache dtype {want_dtype}")
        tokens = tuple(int(t) for t in handoff.tokens[:p])
        # Leading coverage: resident tree blocks first, then contiguous
        # shipped frame blocks. A hole (skipped-and-evicted) ends it.
        cov = self.prefix_index.match_len(tokens)
        for j in range(p // bs):
            lo, hi = j * bs, (j + 1) * bs
            if hi <= cov:
                continue
            if lo > cov or j not in handoff.blocks:
                break
            cov = hi
        p_eff = PB * (min(cov, p) // PB)
        if p_eff <= 0:
            return False
        dp = self.devprof
        t_dp = 0.0
        plan = self.prefix_index.plan_insert(tokens[:p_eff])
        if plan is None:
            # Fully resident (adoption by reference), or the pool rejected
            # the tail even after eviction.
            return self.prefix_index.match_len(tokens[:p_eff]) >= p_eff
        # Assemble the new tail into one bucket-padded batch-1 row and
        # scatter it in ONE dispatch. The whole assembly runs inside the
        # try: a failure between plan and commit (no bucket fits, a frame
        # missing its scale planes, a device transfer error) must abort the
        # plan, or its pinned matched prefix and allocated blocks leak. The
        # probe's begin() sits inside for the same reasons as in
        # _maybe_store_prefix.
        try:
            if dp.enabled:
                t_dp = dp.begin()
            capacity = self.bucket_for(p_eff)
            m = plan.matched_len
            rows = self._host_row(capacity)
            for j, planes in handoff.blocks.items():
                lo, hi = j * bs, (j + 1) * bs
                if hi <= m or lo >= p_eff:
                    continue  # resident already, or past the adopted run
                # A frame block may straddle p_eff when the sender's block
                # size is not a multiple of this pool's: clip to the
                # adopted run (the row is only capacity wide).
                w = min(hi, p_eff) - lo
                for key, row in rows.items():
                    if key.endswith("_scale"):
                        row[:, :, :, lo:lo + w] = planes[key][:, :, :, :w]
                    else:
                        row[:, :, lo:lo + w] = planes[key][:, :, :w]
            self._write_blocks(self._upload_row(rows, p_eff),
                               self._bucket_ids(capacity, plan.new_ids,
                                                at=m // PB))
        except Exception:
            plan.abort()
            raise
        plan.commit()
        if dp.enabled:
            # Adoption's device work: the host-to-device row copy and the
            # one-dispatch pool scatter.
            dp.probe("adopt", self._pool_kv.k, t_dp)
        return True

    # ------------------------------------------------------------------
    # Chunked prefill (long prompts, interleaved with decode blocks)

    def wants_chunked(self, prompt_len: int) -> bool:
        """True when this prompt should prefill chunk by chunk: more than
        one chunk long (a single-chunk prompt is one dispatch already)."""
        return (self.prefill_chunk is not None
                and prompt_len > self.prefill_chunk)

    def start_chunked_prefill(self, slot: int, prompt_ids: list[int],
                              sampling: SamplingParams,
                              hit: RadixHit | None = None) -> ChunkedPrefill:
        """Begin a chunked prefill for `slot`; advance_chunked_prefill
        drives it (one dispatch per call). With a prefix-cache `hit`, the
        cache is seeded from the pool and the chunks cover only the
        uncached suffix. The hit is released here in all paths."""
        try:
            if not prompt_ids:
                raise EngineError("empty prompt")
            C = self.prefill_chunk
            if C is None:
                raise EngineError("chunked prefill needs prefill_chunk")
            true_len = len(prompt_ids)
            bucket = self.bucket_for(true_len)  # validates; cache capacity
            start = 0
            if hit is not None:
                start = hit.length
                if not 0 < start < true_len:
                    raise EngineError("cached prefix does not fit prompt")
                if tuple(prompt_ids[:start]) != hit.tokens:
                    raise EngineError("prompt diverges from cached prefix")
            sfx_len = true_len - start
            n_chunks = -(-sfx_len // C)
            padded = np.zeros((1, n_chunks * C), np.int64)
            padded[0, :sfx_len] = prompt_ids[start:]
            temp, top_p, top_k, pkey, dkey = self._sampling_rows(
                [(slot, prompt_ids, sampling)], 1)

            cache = self._new_prefix_cache(bucket)
            if hit is not None:
                dp = self.devprof
                t_dp = dp.begin() if dp.enabled else 0.0
                cache = self._insert_from_blocks(
                    cache, self._bucket_ids(bucket, hit.blocks), start)
                if dp.enabled:
                    dp.probe("seed_gather", cache.k, t_dp)
                hit.release()  # gather queued; blocks free to evict
                self.prefix_index.note_reuse(1, start)
            elif self.prefix_index is not None:
                self.prefix_index.note_miss(1)  # admitted uncached
            return ChunkedPrefill(
                slot=slot, ids=padded, true_len=true_len, n_chunks=n_chunks,
                cache=cache, temp=temp, top_p=top_p, top_k=top_k,
                prefill_key=pkey, decode_key=dkey, start_pos=start,
                full_ids=tuple(prompt_ids))
        finally:
            if hit is not None:
                hit.release()

    def advance_chunked_prefill(self, job: ChunkedPrefill) -> int | None:
        """Run ONE chunk; returns the first sampled token when the prompt
        is complete (the slot is then live), else None. Chunk offsets are
        relative to the suffix the job carries: with a seeded start_pos the
        cache lengths already place the writes past the prefix."""
        C = self.prefill_chunk
        c0 = job.done_chunks * C
        chunk = self._dev(job.ids[:, c0:c0 + C])
        valid = torch.tensor([min(C, job.suffix_len - c0)],
                             dtype=torch.int32, device=self.device)
        dp = self.devprof
        t_dp = dp.begin() if dp.enabled else 0.0
        if job.done_chunks < job.n_chunks - 1:
            job.cache = self._chunk_step(chunk, job.cache, valid)
            job.done_chunks += 1
            if dp.enabled:
                dp.probe("chunk", job.cache.k, t_dp)
            return None
        last_idx = torch.tensor([job.suffix_len - 1 - c0], dtype=torch.int64,
                                device=self.device)
        toks, cache = self._chunk_final(chunk, job.cache, valid, last_idx,
                                        job.temp, job.top_p, job.top_k,
                                        job.prefill_key)
        job.done_chunks += 1
        job.cache = None
        self._insert_all(cache, np.asarray([job.slot], np.int64),
                         torch.tensor([job.true_len], dtype=torch.int32,
                                      device=self.device),
                         toks, job.temp, job.top_p, job.top_k,
                         job.decode_key)
        if dp.enabled:
            dp.probe("chunk", self.state.last_token, t_dp)
        # The finished buffer holds the FULL prompt's KV: scatter its
        # unresident whole blocks into the pool before it is dropped
        # (blocks the tree already holds, e.g. a seeded job's prefix, stay
        # shared by reference).
        if self.prefix_index is not None and job.full_ids:
            PB = self.prefix_block
            p = PB * (job.true_len // PB)
            plan = (self.prefix_index.plan_insert(job.full_ids[:p])
                    if p >= PB else None)
            if plan is not None:
                try:
                    self._write_blocks(cache, self._bucket_ids(
                        cache.k.shape[2], plan.new_ids,
                        at=plan.matched_len // PB))
                except Exception:
                    plan.abort()
                    raise
                plan.commit()
        return int(toks.cpu().numpy()[0])

    def _new_prefix_cache(self, capacity: int, batch: int = 1) -> KVCache:
        """A zeroed batch-N prefix cache. Zeros, not garbage: the
        continuation attention multiplies unwritten positions' values by an
        exactly-zero probability, and uninitialized memory may hold NaN."""
        return init_cache(self.config, batch, capacity, self.cache_dtype,
                          quantized=self.kv_quant, device=self.device,
                          mesh=self.mesh)

    def _prefill_scratch_for(self, batch: int, bucket: int) -> KVCache:
        """The persistent prefix buffer for this (batch, bucket) prefill
        shape, written in place by each prefill and stored back, so a shape
        in active use allocates nothing (see `_prefill`)."""
        scratch = self._prefill_scratch.pop((batch, bucket), None)
        if scratch is None:
            scratch = self._new_prefix_cache(bucket, batch)
        return scratch

    def _store_prefill_scratch(self, batch: int, bucket: int,
                               prefix: KVCache) -> None:
        """Return a prefix buffer to the pool, LRU-bounded to twice the
        token budget (or this shape), so rare shapes churn their buffers
        instead of pinning every grid shape's KV for good."""
        key = (batch, bucket)
        self._prefill_scratch.pop(key, None)
        self._prefill_scratch[key] = prefix  # most-recently-used last
        cap = 2 * max(self.prefill_token_budget, batch * bucket)
        total = sum(b * bk for (b, bk) in self._prefill_scratch)
        for old_key in list(self._prefill_scratch):
            if total <= cap or old_key == key:
                continue
            self._prefill_scratch.pop(old_key)  # dropped ref frees memory
            total -= old_key[0] * old_key[1]

    def release_slot(self, slot: int) -> None:
        """A finished slot's cache lane is garbage until reuse (insert
        resets it); nothing to do device-side — the hook exists so the
        scheduler's slot lifecycle has a single engine-visible seam."""

    def warmup(self) -> None:
        """Run the serving shapes once before traffic: the kernels build (at
        first use, from csrc/), one decode block runs, every bucket
        prefills and inserts at its widest batch, each chunk-capable bucket
        runs a chunk step and a final chunk, and with the prefix cache on,
        every (batch, bucket) block gather, suffix continuation and scatter
        runs once, so an out-of-memory shows at startup rather than at the
        first burst. There is nothing to compile beyond the kernels:
        PyTorch runs eagerly. Call before the first insert — warmup advances
        device state with garbage that is only harmless on an empty cache
        (inserts target slot 0 at length 0; pool writes the trash block).

        Role split, as in the JAX engine: a "prefill" engine never decodes,
        so the decode block and the verify are skipped and the handoff
        snapshot (the slot-lane extract, trimmed to each bucket, copied to
        the host) runs instead; a "decode" engine's pool scatters run from
        host rows, as adoption's do.
        """
        decode_side = self.role != "prefill"
        if self.device.type == "cuda":
            kernels.build_all()
        if decode_side:
            self.decode_steps_dispatch()

        def full(n, value, dtype):
            return torch.full((n,), value, dtype=dtype, device=self.device)

        def rows(n):  # temperature, top_p, top_k, keys
            return (full(n, 0.0, torch.float32), full(n, 1.0, torch.float32),
                    full(n, 0, torch.int64),
                    torch.zeros((n, 2), dtype=torch.int64,
                                device=self.device))

        def zeros(n, width):
            return torch.zeros((n, width), dtype=torch.int64,
                               device=self.device)

        for bucket in self.prefill_buckets:
            n = max(b for b in self.prefill_batches_for(bucket)
                    if b <= self.max_slots)
            toks, prefix = self._prefill(
                zeros(n, bucket), full(n, 1, torch.int32), *rows(n),
                self._prefill_scratch_for(n, bucket))
            self._insert_all(prefix, np.zeros(n, np.int64),
                             full(n, 0, torch.int32), toks, *rows(n))
            self._store_prefill_scratch(n, bucket, prefix)
        C = self.prefill_chunk
        for bucket in (self.prefill_buckets if C is not None else ()):
            if bucket <= C:
                continue
            one = full(1, 1, torch.int32)
            cache = self._chunk_step(zeros(1, C), self._new_prefix_cache(
                bucket), one)
            self._chunk_final(zeros(1, C), cache, one,
                              full(1, 0, torch.int64), *rows(1))
        if self.prefix_index is not None:
            A = self.prefix_align
            for bucket in self.prefill_buckets:
                # every lane at the trash block: the garbage lands where
                # nobody reads
                row = (self._upload_row(self._host_row(bucket), 0)
                       if self.role == "decode"
                       else self._new_prefix_cache(bucket))
                self._write_blocks(row, self._bucket_ids(bucket))
                for batch in self.prefill_batches_for(bucket):
                    scratch = self._insert_from_blocks(
                        self._prefill_scratch_for(batch, bucket),
                        self._bucket_ids(bucket), 0)
                    _, prefix = self._chunk_final(
                        zeros(batch, A), scratch, full(batch, 1, torch.int32),
                        full(batch, 0, torch.int64), *rows(batch))
                    self._store_prefill_scratch(batch, bucket, prefix)
        if self.role == "prefill":
            for bucket in self.prefill_buckets:
                row = self.extract_slot_kv(0, min(bucket, self.max_seq_len))
                for plane in (row.k, row.v, row.k_scale, row.v_scale):
                    if plane is not None:
                        to_numpy_plane(plane)
        if self.spec is not None and decode_side:
            # The [B, 1 + k_draft] verify shape: zero drafts advance every
            # lane one garbage token, harmless before the first insert.
            self.verify_step(
                np.zeros((self.max_slots, self.spec.k_draft), np.int64),
                np.zeros((self.max_slots,), np.int32))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def decode_steps_dispatch(self) -> HostFuture:
        """Dispatch one decode block WITHOUT syncing: returns the [K, B]
        token tensor as a HostFuture. The caller can enqueue block N+1 and
        only then block on block N's tokens, so host-side work (transfer,
        detokenize, emit) overlaps block N+1's device execution.

        A firing probe (profile_sample) waits for THIS block's device work
        before returning — draining the stream is what makes the following
        dispatch gap a true device-idle sample; the 1-in-N cadence bounds
        the serialization cost."""
        dp = self.devprof
        t_dp = dp.begin() if dp.enabled else 0.0
        toks = torch.stack([self._decode_one()
                            for _ in range(self.decode_block)])
        if dp.enabled:
            dp.probe("decode_block", toks, t_dp)
        return HostFuture(toks)

    def verify_step_dispatch(self, draft: np.ndarray, n_draft: np.ndarray
                             ) -> tuple[HostFuture, HostFuture]:
        """Dispatch ONE speculative verify WITHOUT syncing: `draft`
        [B, k_draft] holds each slot's proposed continuation tokens,
        `n_draft` [B] how many are real (0 = no proposal; the slot advances
        one plain token). Returns (tokens [1 + k, B], n_emit [B]) as
        HostFutures, which the scheduler syncs an iteration later, as it
        does a decode block's."""
        if self.spec is None:
            raise EngineError("speculative decoding is not enabled")
        k = self.spec.k_draft
        if draft.shape != (self.max_slots, k):
            raise EngineError(
                f"draft shape {draft.shape} != {(self.max_slots, k)}")
        draft_t = self._dev(np.asarray(draft, np.int64))
        n_draft_t = self._dev(np.asarray(n_draft, np.int32))
        dp = self.devprof
        t_dp = dp.begin() if dp.enabled else 0.0
        toks, n_emit = self._verify(draft_t, n_draft_t)
        if dp.enabled:
            dp.probe("verify", toks, t_dp)
        return HostFuture(toks), HostFuture(n_emit)

    def verify_step(self, draft: np.ndarray, n_draft: np.ndarray
                    ) -> tuple[np.ndarray, np.ndarray]:
        """Synchronous verify (tests and non-pipelined callers):
        tokens[:n, b] with n = n_emit[b] are slot b's emitted run."""
        toks, n_emit = self.verify_step_dispatch(draft, n_draft)
        return np.asarray(toks), np.asarray(n_emit)

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
        contracted; tied models re-read it as the LM head). On a mesh, the
        whole model's: each leaf's block times the blocks it is cut into.
        Metadata-only, safe from any thread."""
        return self._stream_bytes(per_device=False)

    def weight_stream_bytes_per_device(self) -> int:
        """This rank's slice of weight_stream_bytes: each leaf counts its
        local block, so sharded leaves divide by the axis size while
        replicated ones count in full on every rank -- the bytes one decode
        step streams from this card (the JAX engine's, from
        sharding.shard_shape). On a single device it equals
        weight_stream_bytes."""
        return self._stream_bytes(per_device=True)

    def _stream_bytes(self, *, per_device: bool) -> int:
        def parts(axes) -> int:
            if per_device or self.mesh is None:
                return 1
            return Sharding(self.mesh, logical_to_spec(axes)).parts()

        def nbytes(leaf, axes) -> int:
            if isinstance(leaf, (QuantizedTensor, PackedQuantizedTensor)):
                return (leaf.q.numel() * leaf.q.element_size() * parts(axes)
                        + leaf.scale.numel() * 4 * parts(scale_axes(axes)))
            return leaf.numel() * leaf.element_size() * parts(axes)

        def visit(node, axes) -> int:
            return sum(visit(v, axes[k]) if isinstance(v, dict)
                       else nbytes(v, axes[k]) for k, v in node.items())

        axes = param_logical_axes(self.config)
        total = visit(self.params, axes)
        if not self.config.tie_embeddings:
            total -= nbytes(self.params["embed"], axes["embed"])
        return total

    def compile_cache_sizes(self) -> dict[str, int]:
        """Compiled-variant count per primitive. Empty: the engine runs
        eagerly; CUDA graph capture is later work."""
        return {}

    # ------------------------------------------------------------------

    @classmethod
    def from_tpu_config(cls, tpu_cfg: Any, *,
                        device: str | torch.device = "cuda"
                        ) -> "InferenceEngine":
        """Build from a provider config's `tpu:` section
        (provider/config.py TpuConfig), on the card unless the caller asks
        for the CPU.

        With `checkpoint_path`, the weights and config come from that HF
        safetensors directory (engine/weights.py): from the warm cache when
        `warm_cache` is on and the cache is current, else by a cold load
        (quantized for `quantization: int8`) that then writes the cache,
        best effort. A checkpoint that is missing or cannot be read raises
        CheckpointError; nothing falls back to random weights. Without it,
        the weights are `init_params(preset(model_preset or "tiny"))`
        drawn from torch.Generator(d).manual_seed(0), d the card when one
        is present and else the CPU: random weights of the preset's shape,
        NOT the JAX package's jax.random.key(0) weights.
        A `tpu.mesh` of N > 1 ranks (the `model` axis) builds this rank's
        engine of an N-rank job: with `tpu.multihost`, this joins the job
        first (parallel/multihost.py init_distributed, from its
        coordinator, num_processes and process_id); without it, the caller
        has joined it (the engine host spawns and joins its ranks itself).
        Every rank loads only its block of the weights. Knobs outside this
        slice raise EngineError naming their ROADMAP item: any other mesh
        axis, dcn_data > 1, MoE on a mesh and pipeline microbatches."""
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise EngineError("no CUDA device is available; pass "
                              "device='cpu' to run the plain versions")
        spec = MeshSpec.from_dict(dict(tpu_cfg.mesh or {}))
        if spec.size > 1:
            # Refuse before joining a job: the model's shapes decide too.
            check_mesh(spec.shape(), read_hf_config(tpu_cfg.checkpoint_path)
                       if tpu_cfg.checkpoint_path
                       else preset(tpu_cfg.model_preset or "tiny"))
        mh = tpu_cfg.multihost
        if mh and int(mh.get("dcn_data", 1)) > 1:
            raise _refuse("dcn_data")
        if tpu_cfg.pipeline_microbatches > 1:
            raise _refuse("pipeline_microbatches")
        mesh = None
        if mh:
            init_distributed(mh["coordinator"], int(mh["num_processes"]),
                             int(mh.get("process_id", 0)), device=device)
            mesh = build_multihost_mesh(spec)
        elif spec.size > 1:
            if not dist.is_initialized():
                raise EngineError(
                    f"tpu.mesh {spec.shape()} runs {spec.size} ranks, one "
                    f"process each: serve it through the engine host "
                    f"(which starts the other ranks) or tpu.multihost, or "
                    f"join the job first (parallel/multihost.py "
                    f"init_distributed)")
            mesh = build_mesh(spec)
        if mesh is not None:
            device = mesh.device
        dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32,
                  "float16": torch.float16}
        if tpu_cfg.dtype not in dtypes:
            raise EngineError(f"unsupported tpu.dtype {tpu_cfg.dtype!r}; "
                              f"expected one of {sorted(dtypes)}")
        dtype = dtypes[tpu_cfg.dtype]
        if tpu_cfg.quantization not in (None, "int8"):
            raise EngineError(
                f"unsupported tpu.quantization {tpu_cfg.quantization!r}")
        if tpu_cfg.kv_quantization not in (None, "int8"):
            raise EngineError(f"unsupported tpu.kv_quantization "
                              f"{tpu_cfg.kv_quantization!r}")
        quant = tpu_cfg.quantization == "int8"
        if tpu_cfg.checkpoint_path:
            params, config = _load_weights(
                tpu_cfg.checkpoint_path, dtype=dtype, quantize=quant,
                warm=bool(getattr(tpu_cfg, "warm_cache", True)),
                device=device, mesh=mesh)
        else:
            config = preset(tpu_cfg.model_preset or "tiny")
            # Drawn on the card whenever one is present (then moved to
            # `device`), so that one config gives the same weights on a
            # machine whatever the engine's device: a host on the card and
            # one with --device cpu serve the same model. The CUDA and CPU
            # generators draw different numbers from one seed. On a mesh
            # each rank keeps its block of the same draws.
            draw_on = ("cuda" if torch.cuda.is_available() else "cpu"
                       ) if device.type == "cpu" else device
            params = init_params(
                config, torch.Generator(device=draw_on).manual_seed(0),
                dtype, quantize=quant, mesh=mesh)
        # The byte fallback must span the MODEL's vocab, or sampled ids
        # stream as silence (tokenizer.py).
        tokenizer = get_tokenizer(tpu_cfg.tokenizer_path,
                                  vocab_size=config.vocab_size)
        return cls(
            config, params, tokenizer, mesh=mesh,
            max_slots=tpu_cfg.max_batch_size,
            max_seq_len=tpu_cfg.max_seq_len,
            prefill_buckets=tpu_cfg.prefill_buckets,
            cache_dtype=dtype,
            decode_block=getattr(tpu_cfg, "decode_block", 1),
            kv_quant=tpu_cfg.kv_quantization == "int8",
            pipeline_microbatches=tpu_cfg.pipeline_microbatches,
            prefill_chunk=getattr(tpu_cfg, "prefill_chunk", 256),
            prefill_token_budget=getattr(tpu_cfg, "prefill_token_budget",
                                         None),
            prefix_cache_bytes=int(
                (getattr(tpu_cfg, "prefix_cache_mb", None) or 0) * 2**20),
            prefix_block_tokens=int(
                getattr(tpu_cfg, "prefix_block_tokens", None) or 16),
            prefix_gossip_blocks=int(
                getattr(tpu_cfg, "prefix_gossip_blocks", None) or 0),
            # is-None, not falsy-or: an explicit 0.0 means "recompute on
            # every heartbeat probe", not the default cadence
            prefix_gossip_s=float(
                2.0 if getattr(tpu_cfg, "prefix_gossip_s", None) is None
                else tpu_cfg.prefix_gossip_s),
            speculative=SpecConfig.from_knob(
                getattr(tpu_cfg, "speculative", None)),
            fused_dequant=bool(getattr(tpu_cfg, "fused_dequant", False)),
            profile_sample=int(getattr(tpu_cfg, "profile_sample", 0) or 0),
            role=getattr(tpu_cfg, "role", "unified") or "unified",
            device=device,
        )


def _load_weights(path: str, *, dtype: torch.dtype, quantize: bool,
                  warm: bool, device: torch.device, mesh=None
                  ) -> tuple[dict, Any]:
    """(params, config) from an HF checkpoint directory, through the warm
    cache when `warm` is on (the JAX engine's from_tpu_config order): the
    cache first; else a cold load, quantized for int8 serving as each
    tensor is read (load_checkpoint(quantize=True): the dense tree is never
    held), after which the cache is written, best effort -- a failure to
    cache is logged and never fails serving.

    On a mesh each rank reads its blocks only. The ranks take one path:
    the cache only when every rank finds it current (a cold int8 load
    takes collectives, which a rank on the warm path would never enter),
    and a cache that then fails to read raises. A sharded load writes no
    cache (no rank holds the whole tree); a single-device load of the same
    checkpoint does."""
    if warm and mesh is not None:
        missing = torch.tensor([0 if warm_cache_current(
            path, dtype=dtype, quantize=quantize) else 1], dtype=torch.int32)
        dist.all_reduce(missing, group=mesh.control)
        if int(missing) == 0:
            loaded = load_warm_cache(path, dtype=dtype, quantize=quantize,
                                     device=device, mesh=mesh)
            if loaded is None:
                raise CheckpointError(f"warm cache under {path} became "
                                      f"unreadable on rank {mesh.rank}")
            logger.info(f"weights loaded from warm cache ({path}), this "
                        f"rank's blocks")
            return loaded
        warm = False
    elif warm:
        try:
            loaded = load_warm_cache(path, dtype=dtype, quantize=quantize,
                                     device=device)
        except Exception as exc:  # noqa: BLE001 -- the cache is advisory
            logger.warning(f"warm cache unreadable, cold load: {exc}")
            loaded = None
        if loaded is not None:
            logger.info(f"weights loaded from warm cache ({path})")
            return loaded
    params, config = load_checkpoint(path, dtype=dtype, device=device,
                                     quantize=quantize, mesh=mesh)
    logger.info(f"weights loaded cold from checkpoint ({path})"
                + ("" if mesh is None else ", this rank's blocks"))
    if warm:
        try:
            save_warm_cache(path, params, config, dtype=dtype,
                            quantize=quantize)
            logger.info("warm weight cache written")
        except Exception as exc:  # noqa: BLE001
            logger.warning(f"warm cache not written: {exc}")
    return params, config


def _has_int8(tree: Any) -> bool:
    if isinstance(tree, dict):
        return any(_has_int8(v) for v in tree.values())
    return isinstance(tree, (QuantizedTensor, PackedQuantizedTensor))


def _to_device(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (QuantizedTensor, PackedQuantizedTensor)):
        return tree._replace(q=tree.q.to(device), scale=tree.scale.to(device))
    return tree.to(device)
