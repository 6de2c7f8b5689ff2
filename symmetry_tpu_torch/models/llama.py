"""Llama-family decoder in PyTorch (symmetry_tpu/models/llama.py).

Parameters are a plain dict of tensors under the JAX package's key names and
stacked layout ([L, E, q_dim] and so on), so the weight converter
(symmetry_tpu_torch/convert.py) is a key-by-key map. One forward serves
prefill and decode: masking is by absolute position and cache writes land
at per-slot positions, so a continuous batch of ragged requests runs at
static shapes.

Attention routing in `_layer`:
  - prefill from an empty cache (prefill_flash, S > 1): ops/flash.py;
  - one position per slot (S == 1): ops/decode_attention.py, which also
    writes the step's K/V row (append mode; quantized for an int8 cache,
    init_cache(quantized=True));
  - anything else (a continuation over a live cache): ops/attention.py.
Calls of more than one position write the cache by index assignment
(quantize_kv first for an int8 cache). Weight leaves may be
dense, QuantizedTensor or PackedQuantizedTensor (ops/quant.py qmatmul
routes by layout; packed leaves take ops/qmm.py). On CUDA tensors the
attention routes (the decode step's row write with them) and packed leaves
launch the package's hand-written kernels.

Not ported in this slice: MoE (ROADMAP Queue 1 item 13) and sequence-
parallel prefill (item 14).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch
import torch.nn.functional as F

from symmetry_tpu_torch.ops.attention import gqa_attention
from symmetry_tpu_torch.ops import decode_attention as decode_ops
from symmetry_tpu_torch.ops import flash as flash_ops
from symmetry_tpu_torch.ops.decode_attention import decode_attention
from symmetry_tpu_torch.ops.flash import flash_prefill
from symmetry_tpu_torch.ops.norm import norm_weight, rms_norm
from symmetry_tpu_torch.ops.quant import (
    PackedQuantizedTensor,
    QuantizedTensor,
    pack_tree,
    qmatmul,
    quantize_kv,
    quantize_tree,
)
from symmetry_tpu_torch.ops.quant import quantize as quantize_leaf
from symmetry_tpu_torch.ops.rope import apply_rope


@dataclass(frozen=True)
class ModelConfig:
    vocab_size: int
    hidden_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    intermediate_size: int
    head_dim: int | None = None          # defaults to hidden//heads
    rope_theta: float = 500000.0
    rms_eps: float = 1e-5
    tie_embeddings: bool = False
    sliding_window: int | None = None    # mistral-v0.1 style local attention
    attention_bias: bool = False         # qwen2-style QKV projection biases
    max_position: int = 8192
    # gemma family: gelu-tanh GeGLU, RMSNorm scale stored as (weight - 1),
    # and embeddings multiplied by sqrt(hidden) at lookup
    hidden_act: str = "silu"             # "silu" | "gelu_tanh"
    norm_plus_one: bool = False
    scale_embed: bool = False

    @property
    def dim_per_head(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.dim_per_head

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.dim_per_head


@dataclass(frozen=True)
class MoEConfig(ModelConfig):
    """Mixture-of-experts variant (mixtral family). Not served by this
    package yet: `init_params` and `forward_hidden` raise on it."""

    num_experts: int = 8
    num_experts_per_tok: int = 2
    moe_capacity_factor: float | None = None


MOE_NOT_PORTED = "MoE models are not ported yet (ROADMAP Queue 1 item 13)"

# Named presets; sizes from the public HF configs of each model family.
PRESETS: dict[str, ModelConfig] = {
    # test-scale models (CPU-fast, exercised by the suite)
    "tiny": ModelConfig(
        vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
        num_kv_heads=2, intermediate_size=128, rope_theta=10000.0,
        max_position=512,
    ),
    "tiny-mha": ModelConfig(
        vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
        num_kv_heads=4, intermediate_size=128, rope_theta=10000.0,
        max_position=512,
    ),
    "llama3-8b": ModelConfig(
        vocab_size=128256, hidden_size=4096, num_layers=32, num_heads=32,
        num_kv_heads=8, intermediate_size=14336, rope_theta=500000.0,
    ),
    "llama3-70b": ModelConfig(
        vocab_size=128256, hidden_size=8192, num_layers=80, num_heads=64,
        num_kv_heads=8, intermediate_size=28672, rope_theta=500000.0,
    ),
    "llama3.2-1b": ModelConfig(
        vocab_size=128256, hidden_size=2048, num_layers=16, num_heads=32,
        num_kv_heads=8, intermediate_size=8192, rope_theta=500000.0,
        tie_embeddings=True,
    ),
    "mistral-7b": ModelConfig(
        vocab_size=32768, hidden_size=4096, num_layers=32, num_heads=32,
        num_kv_heads=8, intermediate_size=14336, rope_theta=1000000.0,
    ),
    "tiny-moe": MoEConfig(
        vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
        num_kv_heads=2, intermediate_size=128, rope_theta=10000.0,
        max_position=512, num_experts=4, num_experts_per_tok=2,
    ),
    "mixtral-8x7b": MoEConfig(
        vocab_size=32000, hidden_size=4096, num_layers=32, num_heads=32,
        num_kv_heads=8, intermediate_size=14336, rope_theta=1000000.0,
        num_experts=8, num_experts_per_tok=2,
    ),
    "gemma-7b": ModelConfig(
        vocab_size=256000, hidden_size=3072, num_layers=28, num_heads=16,
        num_kv_heads=16, intermediate_size=24576, head_dim=256,
        rope_theta=10000.0, rms_eps=1e-6, tie_embeddings=True,
        hidden_act="gelu_tanh", norm_plus_one=True, scale_embed=True,
    ),
    "gemma-2b": ModelConfig(
        vocab_size=256000, hidden_size=2048, num_layers=18, num_heads=8,
        num_kv_heads=1, intermediate_size=16384, head_dim=256,
        rope_theta=10000.0, rms_eps=1e-6, tie_embeddings=True,
        hidden_act="gelu_tanh", norm_plus_one=True, scale_embed=True,
    ),
    "tiny-gemma": ModelConfig(
        vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
        num_kv_heads=2, intermediate_size=128, head_dim=16,
        rope_theta=10000.0, max_position=512, tie_embeddings=True,
        hidden_act="gelu_tanh", norm_plus_one=True, scale_embed=True,
    ),
    "qwen2-7b": ModelConfig(
        vocab_size=152064, hidden_size=3584, num_layers=28, num_heads=28,
        num_kv_heads=4, intermediate_size=18944, rope_theta=1000000.0,
        rms_eps=1e-6, attention_bias=True,
    ),
    "tiny-qwen": ModelConfig(
        vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
        num_kv_heads=2, intermediate_size=128, rope_theta=10000.0,
        max_position=512, attention_bias=True,
    ),
}


def preset(name: str) -> ModelConfig:
    if name not in PRESETS:
        raise KeyError(f"unknown model preset {name!r}; have {sorted(PRESETS)}")
    return PRESETS[name]


class KVCache(NamedTuple):
    """Static-shape KV cache: [layers, batch, capacity, kv_heads, head_dim].

    The port writes k/v (and the scale planes) in place; `lengths` is
    replaced, not mutated, by each forward. With quantized=True at init,
    k/v hold int8 payloads and k_scale/v_scale the per-(layer, slot,
    kv_head, position) float32 dequant scales, [layers, batch, kv_heads,
    capacity]: position minor, the JAX package's layout, so cache snapshots
    and handoff frames interchange between the packages."""

    k: torch.Tensor
    v: torch.Tensor
    lengths: torch.Tensor  # [batch] int32: valid entries per slot
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


def init_cache(
    config: ModelConfig, batch: int, capacity: int,
    dtype: torch.dtype = torch.bfloat16, *, quantized: bool = False,
    device: str | torch.device = "cuda",
) -> KVCache:
    shape = (config.num_layers, batch, capacity, config.num_kv_heads,
             config.dim_per_head)
    if quantized:
        scale_shape = (config.num_layers, batch, config.num_kv_heads,
                       capacity)
        return KVCache(
            k=torch.zeros(shape, dtype=torch.int8, device=device),
            v=torch.zeros(shape, dtype=torch.int8, device=device),
            lengths=torch.zeros((batch,), dtype=torch.int32, device=device),
            k_scale=torch.zeros(scale_shape, dtype=torch.float32,
                                device=device),
            v_scale=torch.zeros(scale_shape, dtype=torch.float32,
                                device=device),
        )
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        lengths=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


# ---------------------------------------------------------------------------
# Parameters


def init_params(config: ModelConfig, generator: torch.Generator,
                dtype: torch.dtype = torch.bfloat16, *,
                quantize: bool = False) -> dict:
    """Random init on the generator's device: normal draws scaled by
    1/sqrt(fan-in) (0.02 for the embedding and LM head). Real serving
    loads HF weights instead. Each leaf is drawn in its own dtype and
    scaled in place, so no float32 copy of an 8B-parameter model is ever
    held. The draws differ from the JAX package's init; the tests hand both
    packages the same weights through convert.params_from_numpy.

    quantize=True makes the QUANT_KEYS leaves int8 QuantizedTensors as
    they are drawn: one layer slice (the LM head: one column block) is
    drawn, scaled and quantized at a time, so neither a dense copy of a
    whole leaf nor a float32 one is ever held."""
    c = config
    if getattr(c, "num_experts", 0):
        raise NotImplementedError(MOE_NOT_PORTED)
    device = generator.device

    def draw(shape, scale):
        w = torch.randn(shape, generator=generator, dtype=dtype,
                        device=device)
        return w.mul_(scale)

    def dense(shape, scale=None, name=None):
        scale = scale if scale is not None else shape[-2] ** -0.5
        if not (quantize and name in QUANT_KEYS):
            return draw(shape, scale)
        *lead, K, N = shape
        q = torch.empty(shape, dtype=torch.int8, device=device)
        s = torch.empty((*lead, N), dtype=torch.float32, device=device)
        # one [K, cols] slab per layer (stacks) or column block (2-D)
        cols = N if lead else min(N, _QUANT_INIT_COLS)
        for i in range(lead[0] if lead else 1):
            for n0 in range(0, N, cols):
                qt = quantize_leaf(draw((K, min(cols, N - n0)), scale))
                dst = (q[i], s[i]) if lead else (q, s)
                dst[0][:, n0:n0 + cols] = qt.q
                dst[1][n0:n0 + cols] = qt.scale
        return QuantizedTensor(q=q, scale=s)

    def ones(shape):
        return torch.ones(shape, dtype=dtype, device=device)

    L, E, F = c.num_layers, c.hidden_size, c.intermediate_size
    params = {
        "embed": dense((c.vocab_size, E), scale=0.02),
        "layers": {
            "attn_norm": ones((L, E)),
            "mlp_norm": ones((L, E)),
            "wq": dense((L, E, c.q_dim), name="wq"),
            "wk": dense((L, E, c.kv_dim), name="wk"),
            "wv": dense((L, E, c.kv_dim), name="wv"),
            "wo": dense((L, c.q_dim, E), name="wo"),
            "wg": dense((L, E, F), name="wg"),
            "wu": dense((L, E, F), name="wu"),
            "wd": dense((L, F, E), name="wd"),
        },
        "final_norm": ones((E,)),
    }
    if c.attention_bias:
        # qwen2: biases on q/k/v projections only (not o/mlp)
        for name, width in (("bq", c.q_dim), ("bk", c.kv_dim),
                            ("bv", c.kv_dim)):
            params["layers"][name] = torch.zeros((L, width), dtype=dtype,
                                                 device=device)
    if not c.tie_embeddings:
        params["lm_head"] = dense((E, c.vocab_size), scale=0.02,
                                  name="lm_head")
    return params


# Weights eligible for int8 quantization (all the large matmuls; the
# embedding stays dense: it is gathered, not contracted).
QUANT_KEYS = ("wq", "wk", "wv", "wo", "wg", "wu", "wd", "lm_head")
# Columns of a 2-D leaf quantized at a time by init_params(quantize=True).
_QUANT_INIT_COLS = 16384


def quantize_params(params: dict) -> dict:
    """In-place int8 quantization of all QUANT_KEYS leaves (ops/quant.py)."""
    return quantize_tree(params, QUANT_KEYS)


def pack_params(params: dict, *, mesh=None,
                report: list | None = None) -> dict:
    """In-place packing of the quantized QUANT_KEYS leaves into the W8A16
    kernel's panel layout (`fused_dequant`; ops/quant.py pack_tree). The
    layout is the routing: qmatmul sends PackedQuantizedTensor leaves
    through the kernel and keeps every other int8 leaf on the mixed dot.
    Pass `report` to collect the (path, reason) of leaves that stay flat.
    Single device only: a mesh raises NotImplementedError (ROADMAP Queue 1
    item 14)."""
    return pack_tree(params, QUANT_KEYS, mesh=mesh, report=report)


def layer_slice(w, i: int):
    """Layer i of a stacked leaf: a tensor, or a (Packed)QuantizedTensor
    whose payload and scales both drop the leading layer dim."""
    if isinstance(w, (QuantizedTensor, PackedQuantizedTensor)):
        return type(w)(w.q[i], w.scale[i])
    return w[i]


def _stacked_layers(w) -> int:
    return (w.q if isinstance(w, (QuantizedTensor, PackedQuantizedTensor))
            else w).shape[0]


# ---------------------------------------------------------------------------
# Forward


def _act(x: torch.Tensor, config: ModelConfig) -> torch.Tensor:
    """Gated-MLP activation: silu (llama/mistral/qwen) or tanh-approx gelu
    (gemma's GeGLU)."""
    if config.hidden_act == "gelu_tanh":
        return F.gelu(x, approximate="tanh")
    return F.silu(x)


def _layer(
    h: torch.Tensor,             # [B, S, E]
    lp: dict,                    # one layer's params (leading L dim stripped)
    cache: KVCache,              # FULL [L, B, T, K, D] cache, written in place
    layer: int,
    positions: torch.Tensor,     # [B, S]
    kv_valid: torch.Tensor,      # [B] cache length AFTER this call's writes
    seq_lens: torch.Tensor,      # [B] valid tokens in this call's input
    config: ModelConfig,
    prefill_flash: bool,         # flash self-attention (fresh cache)
) -> torch.Tensor:
    B, S, E = h.shape
    D, nq, nkv = config.dim_per_head, config.num_heads, config.num_kv_heads
    plus_one = config.norm_plus_one

    x = rms_norm(h, norm_weight(lp["attn_norm"], plus_one), config.rms_eps)
    q = qmatmul(x, lp["wq"])
    k = qmatmul(x, lp["wk"])
    v = qmatmul(x, lp["wv"])
    if config.attention_bias:  # qwen2 family
        q = q + lp["bq"]
        k = k + lp["bk"]
        v = v + lp["bv"]
    q = apply_rope(q.reshape(B, S, nq, D), positions, config.rope_theta)
    k = apply_rope(k.reshape(B, S, nkv, D), positions, config.rope_theta)
    v = v.reshape(B, S, nkv, D)

    if S == 1:
        # One position per slot: the decode kernel writes the step's K/V
        # row into the full cache at (layer, slot, min(position, T - 1)) --
        # quantized, for an int8 cache -- and attends over the cache with
        # it, in one launch; the layer is selected inside the kernel. A free
        # slot's length keeps growing with every decode step: the clamp
        # keeps its garbage inside its own lane.
        attn = decode_attention(
            q[:, 0], cache.k, cache.v, layer, kv_valid, cache.k_scale,
            cache.v_scale, window=config.sliding_window,
            append=(k[:, 0].contiguous(), v[:, 0].contiguous(),
                    positions[:, 0].contiguous()))[:, None]
    else:
        # Write the new K/V straight into the full cache at (layer, slot,
        # position), in place. Padded tail tokens write garbage past
        # kv_valid: never read, overwritten later.
        T = cache.k.shape[2]
        b_idx = torch.arange(B, device=h.device)[:, None]
        pos_w = torch.clamp(positions, max=T - 1).long()
        if not prefill_flash:
            # A continuation (a prompt chunk, a cached hit's suffix) may
            # run pad tokens past the capacity. The JAX package drops those
            # writes; here they clamp onto row T - 1, so each carries the
            # row this call writes at T - 1: index assignment with
            # duplicate indices then stays deterministic.
            src = (pos_w - positions[:, :1]).clamp(0, S - 1)[..., None, None]
            k = torch.take_along_dim(k, src, dim=1)
            v = torch.take_along_dim(v, src, dim=1)
        if cache.quantized:
            kq, ks = quantize_kv(k)  # ks [B, S, K]
            vq, vs = quantize_kv(v)
            cache.k[layer][b_idx, pos_w] = kq
            cache.v[layer][b_idx, pos_w] = vq
            # Scale planes are [B, K, T] per layer: the advanced (B, S)
            # index dims go first, matching the [B, S, K] scale values.
            cache.k_scale[layer][b_idx, :, pos_w] = ks
            cache.v_scale[layer][b_idx, :, pos_w] = vs
        else:
            cache.k[layer][b_idx, pos_w] = k.to(cache.k.dtype)
            cache.v[layer][b_idx, pos_w] = v.to(cache.v.dtype)

        if prefill_flash:
            # Prefill from empty: attention over this call's own K/V; the
            # cache is never read back.
            attn = flash_prefill(q, k, v, seq_lens,
                                 window=config.sliding_window)
        else:
            attn = gqa_attention(
                q, cache.k[layer], cache.v[layer], positions, kv_valid,
                sliding_window=config.sliding_window,
                k_scale=cache.k_scale[layer] if cache.quantized else None,
                v_scale=cache.v_scale[layer] if cache.quantized else None)
    h = h + qmatmul(attn.reshape(B, S, nq * D), lp["wo"])

    x = rms_norm(h, norm_weight(lp["mlp_norm"], plus_one), config.rms_eps)
    return h + qmatmul(_act(qmatmul(x, lp["wg"]), config)
                       * qmatmul(x, lp["wu"]), lp["wd"])


def run_layers(
    layers_params: dict,
    h: torch.Tensor,
    cache: KVCache,            # leading layer dim == layers_params' leading dim
    positions: torch.Tensor,
    kv_valid: torch.Tensor,
    seq_lens: torch.Tensor,
    config: ModelConfig,
    *,
    use_flash: bool = False,
) -> torch.Tensor:
    """Run the stack of decoder layers over `h` (a Python loop over the
    stacked layer dim; the cache is written in place)."""
    n_layers = _stacked_layers(layers_params["wq"])
    for i in range(n_layers):
        lp = {name: layer_slice(w, i) for name, w in layers_params.items()}
        h = _layer(h, lp, cache, i, positions, kv_valid, seq_lens, config,
                   use_flash)
    return h


def forward_hidden(
    params: dict,
    config: ModelConfig,
    tokens: torch.Tensor,     # [B, S] integer token ids
    cache: KVCache,           # lengths[b] = tokens already in cache for slot b
    seq_lens: torch.Tensor | None = None,  # [B] valid tokens; None = all S
    *,
    prefill_flash: bool = False,  # caller guarantees the cache is empty
    ring_mesh=None,               # sequence-parallel prefill: not ported
) -> tuple[torch.Tensor, KVCache]:
    """Decoder trunk: returns (final-norm hidden states [B, S, E], cache).

    Split from the LM head so prefill can project only the last valid
    position. prefill_flash=True is VALID ONLY when cache.lengths are all
    zero (the engine's prefill): attention then covers this call's own
    K/V, not the cache."""
    if getattr(config, "num_experts", 0):
        raise NotImplementedError(MOE_NOT_PORTED)
    if ring_mesh is not None:
        raise NotImplementedError("sequence-parallel prefill (ring_mesh) is "
                                  "not ported yet (ROADMAP Queue 1 item 14)")
    B, S = tokens.shape
    if seq_lens is None:
        seq_lens = torch.full((B,), S, dtype=torch.int32,
                              device=tokens.device)
    positions = (cache.lengths[:, None]
                 + torch.arange(S, dtype=torch.int32,
                                device=tokens.device)[None, :])
    kv_valid = cache.lengths + seq_lens
    use_flash = prefill_flash and S > 1

    n_stacked = _stacked_layers(params["layers"]["wq"])
    if n_stacked != config.num_layers:
        # The cache is sized by config: a depth mismatch must fail loudly.
        raise ValueError(f"params carry {n_stacked} stacked layers but "
                         f"config.num_layers = {config.num_layers}")
    h = params["embed"][tokens.long()]
    if h.device.type == "cuda":
        check_attention_kernels(config, h.dtype, flash=use_flash,
                                decode=S == 1)
    if config.scale_embed:
        # gemma: embeddings scaled by sqrt(hidden) at lookup, normalizer
        # cast to the activation dtype (HF modeling_gemma semantics)
        h = h * torch.tensor(config.hidden_size ** 0.5, dtype=h.dtype)
    h = run_layers(params["layers"], h, cache, positions, kv_valid,
                   seq_lens, config, use_flash=use_flash)
    h = rms_norm(h, norm_weight(params["final_norm"], config.norm_plus_one),
                 config.rms_eps)
    return h, cache._replace(lengths=kv_valid)


def check_attention_kernels(config: ModelConfig, dtype: torch.dtype,
                            *, flash: bool, decode: bool) -> None:
    """On the card, every prefill from empty runs the flash kernel and
    every single-position step the decode kernel, with no plain path:
    refuse, before any layer runs, a head dim or group the kernels' gates
    (`flash.kernel_supports`, `decode_attention.kernel_supports`) refuse."""
    D = config.dim_per_head
    if flash and not flash_ops.kernel_supports(dtype, D):
        raise ValueError(f"flash.kernel_supports({dtype}, {D}) is false: "
                         f"the flash kernels take float32 or bf16 at a "
                         f"head_dim that is a multiple of 8 from 16 to 256")
    group = config.num_heads // config.num_kv_heads
    if decode and not decode_ops.kernel_supports(D, group):
        raise ValueError(f"decode_attention.kernel_supports({D}, {group}) is "
                         f"false: the decode kernels take a head_dim that "
                         f"is a multiple of 8 from 16 to 256")


def logits_from_hidden(params: dict, config: ModelConfig,
                       h: torch.Tensor) -> torch.Tensor:
    """LM head: [B, S, E] hidden -> [B, S, vocab] float32 logits."""
    head = params["embed"].T if config.tie_embeddings else params["lm_head"]
    return qmatmul(h, head).to(torch.float32)


def forward(
    params: dict,
    config: ModelConfig,
    tokens: torch.Tensor,     # [B, S]
    cache: KVCache,
    seq_lens: torch.Tensor | None = None,
) -> tuple[torch.Tensor, KVCache]:
    """Run the decoder; returns (logits [B, S, vocab] f32, updated cache).

    Serves prefill (S = padded prompt length) and decode (S = 1 per slot)
    with the same code. Logits at padded positions are garbage by contract;
    callers index the last valid position."""
    h, cache = forward_hidden(params, config, tokens, cache, seq_lens)
    return logits_from_hidden(params, config, h), cache
