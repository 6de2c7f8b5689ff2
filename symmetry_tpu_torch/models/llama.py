"""Llama-family decoder in PyTorch (symmetry_tpu/models/llama.py).

Parameters are a plain dict of tensors under the JAX package's key names and
stacked layout ([L, E, q_dim] and so on), so the weight converter
(symmetry_tpu_torch/convert.py) is a key-by-key map. One forward serves
prefill and decode: masking is by absolute position and cache writes land
at per-slot positions, so a continuous batch of ragged requests runs at
static shapes.

Attention routing in `_layer`:
  - prefill from an empty cache (prefill_flash, S > 1): ops/flash.py;
  - one position per slot (S == 1): ops/decode_attention.py;
  - anything else (a continuation over a live cache): ops/attention.py.
On CUDA tensors the first two launch the package's hand-written kernels.

Not ported in this slice: MoE (ROADMAP Queue 1 item 13), sequence-parallel
prefill (item 14) and int8 KV caches (item 9).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch
import torch.nn.functional as F

from symmetry_tpu_torch.ops.attention import gqa_attention
from symmetry_tpu_torch.ops.decode_attention import decode_attention
from symmetry_tpu_torch.ops.flash import flash_prefill
from symmetry_tpu_torch.ops.norm import norm_weight, rms_norm
from symmetry_tpu_torch.ops.quant import qmatmul
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

    The port writes k/v in place (index assignment); `lengths` is replaced,
    not mutated, by each forward. Quantized caches (k_scale / v_scale
    planes) are not ported yet: the fields stay so the layout matches the
    JAX package's."""

    k: torch.Tensor
    v: torch.Tensor
    lengths: torch.Tensor  # [batch] int32: valid entries per slot
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


KV_QUANT_NOT_PORTED = ("int8 KV caches are not ported yet "
                       "(ROADMAP Queue 1 item 9)")


def init_cache(
    config: ModelConfig, batch: int, capacity: int,
    dtype: torch.dtype = torch.bfloat16, *, quantized: bool = False,
    device: str | torch.device = "cuda",
) -> KVCache:
    if quantized:
        raise NotImplementedError(KV_QUANT_NOT_PORTED)
    shape = (config.num_layers, batch, capacity, config.num_kv_heads,
             config.dim_per_head)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        lengths=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


# ---------------------------------------------------------------------------
# Parameters


def init_params(config: ModelConfig, generator: torch.Generator,
                dtype: torch.dtype = torch.bfloat16) -> dict:
    """Random init on the generator's device: normal draws scaled by
    1/sqrt(fan-in) (0.02 for the embedding and LM head). Real serving
    loads HF weights instead. Each leaf is drawn in its own dtype and
    scaled in place, so no float32 copy of an 8B-parameter model is ever
    held. The draws differ from the JAX package's init; the tests hand both
    packages the same weights through convert.params_from_numpy."""
    c = config
    if getattr(c, "num_experts", 0):
        raise NotImplementedError(MOE_NOT_PORTED)
    device = generator.device

    def dense(shape, scale=None):
        scale = scale if scale is not None else shape[-2] ** -0.5
        w = torch.randn(shape, generator=generator, dtype=dtype,
                        device=device)
        return w.mul_(scale)

    def ones(shape):
        return torch.ones(shape, dtype=dtype, device=device)

    L, E, F = c.num_layers, c.hidden_size, c.intermediate_size
    params = {
        "embed": dense((c.vocab_size, E), scale=0.02),
        "layers": {
            "attn_norm": ones((L, E)),
            "mlp_norm": ones((L, E)),
            "wq": dense((L, E, c.q_dim)),
            "wk": dense((L, E, c.kv_dim)),
            "wv": dense((L, E, c.kv_dim)),
            "wo": dense((L, c.q_dim, E)),
            "wg": dense((L, E, F)),
            "wu": dense((L, E, F)),
            "wd": dense((L, F, E)),
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
        params["lm_head"] = dense((E, c.vocab_size), scale=0.02)
    return params


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

    # Write the new K/V straight into the full cache at (layer, slot,
    # position), in place. Padded tail tokens write garbage past kv_valid:
    # never read, overwritten later. Positions clamp to the capacity: a
    # free slot's length keeps growing with every decode step, and its
    # garbage must land inside its own lane.
    T = cache.k.shape[2]
    b_idx = torch.arange(B, device=h.device)[:, None]
    pos_w = torch.clamp(positions, max=T - 1).long()
    cache.k[layer][b_idx, pos_w] = k.to(cache.k.dtype)
    cache.v[layer][b_idx, pos_w] = v.to(cache.v.dtype)

    if prefill_flash and S > 1:
        # Prefill from empty: attention over this call's own K/V; the cache
        # is never read back.
        attn = flash_prefill(q, k, v, seq_lens, window=config.sliding_window)
    elif S == 1:
        # One position per slot: the full cache is the operand, the layer
        # is selected inside the kernel.
        attn = decode_attention(q[:, 0], cache.k, cache.v, layer, kv_valid,
                                window=config.sliding_window)[:, None]
    else:
        attn = gqa_attention(q, cache.k[layer], cache.v[layer], positions,
                             kv_valid, sliding_window=config.sliding_window)
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
    n_layers = next(iter(layers_params.values())).shape[0]
    for i in range(n_layers):
        lp = {name: w[i] for name, w in layers_params.items()}
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
    if cache.quantized:
        raise NotImplementedError(KV_QUANT_NOT_PORTED)
    B, S = tokens.shape
    if seq_lens is None:
        seq_lens = torch.full((B,), S, dtype=torch.int32,
                              device=tokens.device)
    positions = (cache.lengths[:, None]
                 + torch.arange(S, dtype=torch.int32,
                                device=tokens.device)[None, :])
    kv_valid = cache.lengths + seq_lens
    use_flash = prefill_flash and S > 1

    n_stacked = params["layers"]["wq"].shape[0]
    if n_stacked != config.num_layers:
        # The cache is sized by config: a depth mismatch must fail loudly.
        raise ValueError(f"params carry {n_stacked} stacked layers but "
                         f"config.num_layers = {config.num_layers}")
    h = params["embed"][tokens.long()]
    if config.scale_embed:
        # gemma: embeddings scaled by sqrt(hidden) at lookup, normalizer
        # cast to the activation dtype (HF modeling_gemma semantics)
        h = h * torch.tensor(config.hidden_size ** 0.5, dtype=h.dtype)
    h = run_layers(params["layers"], h, cache, positions, kv_valid,
                   seq_lens, config, use_flash=use_flash)
    h = rms_norm(h, norm_weight(params["final_norm"], config.norm_plus_one),
                 config.rms_eps)
    return h, cache._replace(lengths=kv_valid)


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
