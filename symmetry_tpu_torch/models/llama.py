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

The HF weight layout map and `config_from_hf` (an HF config.json dict to
a ModelConfig) serve engine/weights.py.

MoE (mixtral family, MoEConfig): a layer whose params carry a "router"
runs models/moe.py's mixture in place of the dense MLP; the expert stacks
are [L, X, E, F] (wg, wu) and [L, X, F, E] (wd), the router [L, E, X].
On a mesh a rank holds the experts of its `expert` coordinate over its
`model` block of F, and the mixture sums over both axes (models/moe.py).

Tensor parallelism (`mesh`, parallel/): megatron over the mesh's `model`
axis, from `param_logical_axes` and parallel/sharding.py DEFAULT_RULES.
Each rank holds its block of every leaf (`shard_params`) and of the KV
cache (its kv heads), runs the attention kernels on its num_heads / N and
num_kv_heads / N heads, and sums over the axis once after wo and once
after wd (`_row_parallel`). The embedding is vocab-parallel (a masked
local gather, then a sum); the LM head is vocab-parallel and its logits
are gathered before sampling, so every rank samples the same token. A
dense row-parallel product sums in float32 and rounds to the activation
dtype once, after the sum: GSPMD lowers the JAX package's sharded bf16
dot to a dot with a float32 result, an all-reduce in float32 and one
convert (the compiled HLO on its CPU mesh). An int8 one is summed in
float32 before its per-column scale (ops/qmm.py w8a16_apply_sharded, and
the mixed dot below in the same order).

Sequence-parallel prefill (`ring_mesh`, `sp_mode`): a prefill from an
empty cache shards its attention's sequence over the `context` axis of
`ring_mesh`, by the K/V ring (parallel/ring.py) or by the Ulysses head
scatter (parallel/ulysses.py), in place of the flash kernel, as in the JAX
package. The projections, the MLP and the cache writes run on every rank
of the axis, as the JAX forward leaves them outside its shard_map; the
attention's output shards are all-gathered, so every rank returns the
whole hidden states and its whole block of the cache. Beside `context`,
`ring_mesh` may have every other axis above 1, as the JAX forward serves
it: the attention runs over this rank's `context` line. With `mesh` (the
same shape) a `model` rank runs it on its heads and writes its kv-head
block of the cache, and an MoE layer runs outside it on the rank's experts
and `model` block (models/moe.py); `data`, `expert` (a dense model's) and
`stage` ranks hold the whole batch and are replicas, as under JAX's
DEFAULT_RULES. A stage rank's block of the layers takes no `ring_mesh`
(parallel/pipeline.py; the JAX pipeline takes none).

Pipeline parallelism (parallel/pipeline.py) runs `run_layers` over a stage
rank's block of the layers against its block of the cache
(init_cache(mesh=...) under a stage axis: L / P layers); an MoE layer
there runs on the microbatch, as in the JAX pipeline.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from symmetry_tpu_torch.models.moe import moe_mlp
from symmetry_tpu_torch.ops.attention import gqa_attention
from symmetry_tpu_torch.ops import decode_attention as decode_ops
from symmetry_tpu_torch.ops import flash as flash_ops
from symmetry_tpu_torch.ops.decode_attention import decode_attention
from symmetry_tpu_torch.ops.flash import flash_prefill
from symmetry_tpu_torch.ops.norm import norm_weight, rms_norm
from symmetry_tpu_torch.ops.quant import (
    PackedQuantizedTensor,
    QuantizedTensor,
    mixed_dot,
    pack_tree,
    qmatmul,
    quantize_kv,
    quantize_tree,
)
from symmetry_tpu_torch.ops.quant import quantize as quantize_leaf
from symmetry_tpu_torch.ops.rope import apply_rope
from symmetry_tpu_torch.parallel import ring, ulysses
from symmetry_tpu_torch.parallel.sharding import (
    DEFAULT_RULES,
    Sharding,
    logical_to_spec,
    mesh_rules,
    shard_leaf,
)
from symmetry_tpu_torch.utils.trace import device_range


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
    """Mixture-of-experts variant (mixtral family): each layer's MLP is
    models/moe.py's top-k mixture over `num_experts` experts;
    `moe_capacity_factor` (None: moe.CAPACITY_FACTOR) sizes the prefill
    dispatch."""

    num_experts: int = 8
    num_experts_per_tok: int = 2
    moe_capacity_factor: float | None = None


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
    device: str | torch.device = "cuda", mesh=None,
) -> KVCache:
    """A zeroed cache; on a mesh, this rank's block: its kv heads, and
    under a stage axis its layers (cache_logical_axes under mesh_rules)."""
    kv_heads = config.num_kv_heads // _tp(mesh)
    layers = config.num_layers // _pp(mesh)
    shape = (layers, batch, capacity, kv_heads, config.dim_per_head)
    if quantized:
        scale_shape = (layers, batch, kv_heads, capacity)
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
                quantize: bool = False, mesh=None) -> dict:
    """Random init on the generator's device: normal draws scaled by
    1/sqrt(fan-in) (0.02 for the embedding and LM head). Real serving
    loads HF weights instead. Each leaf is drawn in its own dtype and
    scaled in place, so no float32 copy of an 8B-parameter model is ever
    held. The draws differ from the JAX package's init; the tests hand both
    packages the same weights through convert.params_from_numpy.

    quantize=True makes the QUANT_KEYS leaves int8 QuantizedTensors as
    they are drawn: one [K, N] slab of a stack (a layer, or one expert of a
    layer for an MoE expert stack; the LM head: one column block) is drawn,
    scaled and quantized at a time, so neither a dense copy of a whole leaf
    nor a float32 one is ever held.

    MoE configs (num_experts > 0) draw the expert stacks [L, X, E, F] (wg,
    wu) and [L, X, F, E] (wd) one [K, N] slab per (layer, expert), dense or
    int8, and a dense router [L, E, X], as the JAX package lays them out.

    With `mesh`, every rank draws what one rank draws, in the same order,
    and keeps only its block (shard_param), so every rank's tree is the
    single-device tree's, sliced. A leaf drawn in slabs keeps each slab's
    block as the slab is drawn, so a rank never holds more than its block
    and one slab of it (an expert rank of mixtral-8x7b keeps its experts
    only)."""
    c = config
    device = generator.device
    axes = param_logical_axes(c)

    def local(leaf, leaf_axes):
        return leaf if mesh is None else shard_param(leaf, leaf_axes, mesh)

    def draw(shape, scale):
        w = torch.randn(shape, generator=generator, dtype=dtype,
                        device=device)
        return w.mul_(scale)

    def dense(shape, leaf_axes, scale=None, name=None):
        scale = scale if scale is not None else shape[-2] ** -0.5
        quant = quantize and name in QUANT_KEYS
        if not quant and len(shape) < 4:
            return local(draw(shape, scale), leaf_axes)
        *lead, K, N = shape
        sl = (tuple(slice(0, n) for n in shape) if mesh is None
              else Sharding(mesh, logical_to_spec(
                  leaf_axes, mesh_rules(mesh))).slices(shape))
        out = tuple(b.stop - b.start for b in sl)
        if quant:
            q = torch.empty(out, dtype=torch.int8, device=device)
            s = torch.empty((*out[:-2], out[-1]), dtype=torch.float32,
                            device=device)
        else:
            w = torch.empty(out, dtype=dtype, device=device)
        rows, keep = sl[-2], sl[-1]
        # one [K, cols] slab per leading index (a layer, or a layer's
        # expert) or per column block of a 2-D leaf
        cols = N if lead else min(N, _QUANT_INIT_COLS)
        for i in itertools.product(*(range(n) for n in lead)):
            mine = all(b.start <= j < b.stop for j, b in zip(i, sl[:-2]))
            li = tuple(j - b.start for j, b in zip(i, sl[:-2]))
            for n0 in range(0, N, cols):
                n1 = min(N, n0 + cols)
                slab = draw((K, n1 - n0), scale)
                lo, hi = max(n0, keep.start), min(n1, keep.stop)
                if not mine or lo >= hi:
                    continue
                src = slice(lo - n0, hi - n0)
                dst = slice(lo - keep.start, hi - keep.start)
                if quant:
                    qt = quantize_leaf(slab)
                    q[li][:, dst] = qt.q[rows, src]
                    s[li][dst] = qt.scale[src]
                else:
                    w[li][:, dst] = slab[rows, src]
        return QuantizedTensor(q=q, scale=s) if quant else w

    def ones(shape):
        return torch.ones(shape, dtype=dtype, device=device)

    L, E, F = c.num_layers, c.hidden_size, c.intermediate_size
    n_exp = getattr(c, "num_experts", 0)
    ffn = (L, n_exp, E, F) if n_exp else (L, E, F)
    ffn_d = (L, n_exp, F, E) if n_exp else (L, F, E)
    la = axes["layers"]
    params = {
        "embed": dense((c.vocab_size, E), axes["embed"], scale=0.02),
        "layers": {
            "attn_norm": local(ones((L, E)), la["attn_norm"]),
            "mlp_norm": local(ones((L, E)), la["mlp_norm"]),
            "wq": dense((L, E, c.q_dim), la["wq"], name="wq"),
            "wk": dense((L, E, c.kv_dim), la["wk"], name="wk"),
            "wv": dense((L, E, c.kv_dim), la["wv"], name="wv"),
            "wo": dense((L, c.q_dim, E), la["wo"], name="wo"),
            "wg": dense(ffn, la["wg"], name="wg"),
            "wu": dense(ffn, la["wu"], name="wu"),
            "wd": dense(ffn_d, la["wd"], name="wd"),
        },
        "final_norm": local(ones((E,)), axes["final_norm"]),
    }
    if n_exp:
        # The router stays dense: it is small, and its logits feed a top-k.
        params["layers"]["router"] = dense((L, E, n_exp), la["router"])
    if c.attention_bias:
        # qwen2: biases on q/k/v projections only (not o/mlp)
        for name, width in (("bq", c.q_dim), ("bk", c.kv_dim),
                            ("bv", c.kv_dim)):
            params["layers"][name] = local(
                torch.zeros((L, width), dtype=dtype, device=device),
                la[name])
    if not c.tie_embeddings:
        params["lm_head"] = dense((E, c.vocab_size), axes["lm_head"],
                                  scale=0.02, name="lm_head")
    return params


def param_logical_axes(config: ModelConfig) -> dict:
    """Tree of logical-axis tuples, same structure as init_params output
    (the JAX package's, for parallel/sharding.py)."""
    moe = bool(getattr(config, "num_experts", 0))
    ffn = (("layers", "experts", "embed", "mlp") if moe
           else ("layers", "embed", "mlp"))
    ffn_d = (("layers", "experts", "mlp", "embed") if moe
             else ("layers", "mlp", "embed"))
    axes = {
        "embed": ("vocab", "embed"),
        "layers": {
            "attn_norm": ("layers", "embed"),
            "mlp_norm": ("layers", "embed"),
            "wq": ("layers", "embed", "heads"),
            "wk": ("layers", "embed", "kv_heads"),
            "wv": ("layers", "embed", "kv_heads"),
            "wo": ("layers", "heads", "embed"),
            "wg": ffn,
            "wu": ffn,
            "wd": ffn_d,
        },
        "final_norm": ("embed",),
    }
    if moe:
        axes["layers"]["router"] = ("layers", "embed", None)
    if config.attention_bias:
        axes["layers"]["bq"] = ("layers", "heads")
        axes["layers"]["bk"] = ("layers", "kv_heads")
        axes["layers"]["bv"] = ("layers", "kv_heads")
    if not config.tie_embeddings:
        axes["lm_head"] = ("embed", "vocab")
    return axes


def cache_logical_axes(*, quantized: bool = False) -> KVCache:
    kv = ("layers", "batch", "cache_seq", "kv_heads", "head_dim")
    sc = ("layers", "batch", "kv_heads", "cache_seq") if quantized else None
    return KVCache(k=kv, v=kv, lengths=("batch",), k_scale=sc, v_scale=sc)


def scale_axes(axes: tuple) -> tuple:
    """A QuantizedTensor's scale axes: its weight's minus the contraction
    (second-last) dim."""
    return axes[:-2] + axes[-1:]


def shard_param(leaf, axes: tuple, mesh):
    """This rank's block of one full leaf (a tensor or a QuantizedTensor),
    as a copy: the full leaf is not kept alive by a view."""
    if isinstance(leaf, QuantizedTensor):
        return QuantizedTensor(
            q=shard_leaf(leaf.q, axes, mesh).clone(),
            scale=shard_leaf(leaf.scale, scale_axes(axes), mesh).clone())
    if isinstance(leaf, PackedQuantizedTensor):
        raise TypeError("shard a flat leaf, then pack its block "
                        "(pack_params(mesh=...))")
    return shard_leaf(leaf, axes, mesh).clone()


def shard_params(params: dict, config: ModelConfig, mesh) -> dict:
    """This rank's blocks of a full params tree (dense or flat int8)."""

    def visit(node, axes):
        return {k: visit(v, axes[k]) if isinstance(v, dict)
                else shard_param(v, axes[k], mesh) for k, v in node.items()}

    return visit(params, param_logical_axes(config))


def _tp(mesh) -> int:
    """Tensor-parallel degree: the mesh's `model` axis (1 without one)."""
    return 1 if mesh is None else mesh.axis_size("model")


def _pp(mesh) -> int:
    """Pipeline degree: the mesh's `stage` axis (1 without one)."""
    return 1 if mesh is None else mesh.axis_size("stage")


# Weights eligible for int8 quantization (all the large matmuls; the
# embedding stays dense: it is gathered, not contracted).
QUANT_KEYS = ("wq", "wk", "wv", "wo", "wg", "wu", "wd", "lm_head")
# Columns of a 2-D leaf quantized at a time by init_params(quantize=True).
_QUANT_INIT_COLS = 16384


def quantize_params(params: dict, *, config: ModelConfig | None = None,
                    mesh=None) -> dict:
    """In-place int8 quantization of all QUANT_KEYS leaves (ops/quant.py).

    With `mesh` (+ `config`), `params` holds this rank's blocks: a leaf
    whose contraction dim is split (wo, wd over `model`; an MoE wd's block
    of F included) takes each column's amax over that axis before its
    scale, so every rank's int8 blocks are the whole tree's, quantized and
    sliced. Every rank calls it, in the same order."""
    if mesh is None or mesh.size == 1:
        return quantize_tree(params, QUANT_KEYS)
    if config is None:
        raise ValueError("quantize_params needs `config` to find the "
                         "row-parallel leaves on a mesh")
    rules = mesh_rules(mesh)

    def visit(node, axes):
        for name, child in list(node.items()):
            if isinstance(child, dict):
                visit(child, axes[name])
            elif name in QUANT_KEYS and isinstance(child, torch.Tensor):
                k_axis = logical_to_spec(axes[name], rules)[-2]
                reduce = None
                if mesh.axis_size(k_axis) > 1:
                    def reduce(amax, k_axis=k_axis):
                        return mesh.all_reduce(amax, k_axis, "max")
                node[name] = quantize_leaf(child, amax_reduce=reduce)

    visit(params, param_logical_axes(config))
    return params


def pack_params(params: dict, *, config: ModelConfig | None = None,
                mesh=None, report: list | None = None) -> dict:
    """In-place packing of the quantized QUANT_KEYS leaves into the W8A16
    kernel's panel layout (`fused_dequant`; ops/quant.py pack_tree). The
    layout is the routing: qmatmul sends PackedQuantizedTensor leaves
    through the kernel and keeps every other int8 leaf on the mixed dot.
    Pass `report` to collect the (path, reason) of leaves that stay flat.

    With `mesh` (+ `config`, to resolve each leaf's logical axes), `params`
    holds this rank's blocks and each packs on its own, carrying the mesh
    axes it is sharded over (packed_shard_axes), as the JAX package's
    pack after the sharding decision does."""
    axes = None
    if mesh is not None:
        if config is None:
            raise ValueError("pack_params needs `config` to resolve "
                             "per-leaf shard axes when packing on a mesh")
        axes = packed_shard_axes(config, mesh)
    return pack_tree(params, QUANT_KEYS, axes=axes, mesh=mesh, report=report)


def packed_shard_axes(config: ModelConfig, mesh,
                      rules: dict | None = None) -> dict:
    """leaf name -> (k_mesh_axis, n_mesh_axis) for every QUANT_KEYS leaf,
    resolved from param_logical_axes + the sharding rules (megatron TP:
    wq/wk/wv/wg/wu/lm_head column-parallel over the output dim, wo/wd
    row-parallel over the contraction dim). Mesh axes of size 1 resolve to
    None (nothing to shard)."""
    rules = DEFAULT_RULES if rules is None else rules
    out: dict = {}

    def resolve(logical):
        ax = rules.get(logical) if logical is not None else None
        return ax if ax is not None and mesh.axis_size(ax) > 1 else None

    def visit(node):
        for name, child in node.items():
            if isinstance(child, dict):
                visit(child)
            elif name in QUANT_KEYS:
                out[name] = (resolve(child[-2]), resolve(child[-1]))

    visit(param_logical_axes(config))
    return out


def layer_slice(w, i: int):
    """Layer i of a stacked leaf: a tensor, or a (Packed)QuantizedTensor
    whose payload and scales both drop the leading layer dim."""
    if isinstance(w, (QuantizedTensor, PackedQuantizedTensor)):
        return w._replace(q=w.q[i], scale=w.scale[i])
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


def _layer(h: torch.Tensor, lp: dict, cache: KVCache, layer: int,
           positions: torch.Tensor, kv_valid: torch.Tensor,
           seq_lens: torch.Tensor, config: ModelConfig, prefill_flash: bool,
           mesh=None, ring_mesh=None, sp_mode: str = "ring",
           batch_axis: str | None = None) -> torch.Tensor:
    """One decoder layer: the attention half, then the MLP half, each a
    profiler range (`model.attention`, `model.mlp`) while a profiler
    records, so its kernels are told apart from the other half's."""
    with device_range("model.attention"):
        h = _attention(h, lp, cache, layer, positions, kv_valid, seq_lens,
                       config, prefill_flash, mesh, ring_mesh, sp_mode)
    with device_range("model.mlp"):
        x = rms_norm(h, norm_weight(lp["mlp_norm"], config.norm_plus_one),
                     config.rms_eps)
        if "router" in lp:
            return h + moe_mlp(x, lp, config, mesh, batch_axis)
        return h + _row_parallel(_act(qmatmul(x, lp["wg"]), config)
                                 * qmatmul(x, lp["wu"]), lp["wd"], mesh)


def _attention(
    h: torch.Tensor,             # [B, S, E]
    lp: dict,                    # one layer's params (leading L dim stripped)
    cache: KVCache,              # FULL [L, B, T, K, D] cache, written in place
    layer: int,
    positions: torch.Tensor,     # [B, S]
    kv_valid: torch.Tensor,      # [B] cache length AFTER this call's writes
    seq_lens: torch.Tensor,      # [B] valid tokens in this call's input
    config: ModelConfig,
    prefill_flash: bool,         # flash self-attention (fresh cache)
    mesh=None,                   # tensor parallel over its `model` axis
    ring_mesh=None,              # sequence-parallel prefill (fresh cache)
    sp_mode: str = "ring",       # "ring" | "ulysses"
) -> torch.Tensor:
    """The attention half of a layer: norm, QKV, rope, attention over the
    cache, `wo` and the residual add."""
    B, S, E = h.shape
    tp = _tp(mesh)
    D = config.dim_per_head
    nq, nkv = config.num_heads // tp, config.num_kv_heads // tp
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
        if not (prefill_flash or ring_mesh is not None):
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

        if ring_mesh is not None:
            # Long-context prefill: the sequence sharded over this rank's
            # `context` line -- K/V blocks rotating (parallel/ring.py), or
            # one all-to-all head scatter when heads divide the shard count
            # (parallel/ulysses.py); the output comes back whole, on this
            # rank's heads.
            if sp_mode == "ulysses":
                attn = ulysses.ulysses_attention(
                    q, k, v, seq_lens, ring_mesh,
                    head_axis="model" if tp > 1 else None)
            else:
                attn = ring.ring_attention(q, k, v, seq_lens, ring_mesh)
        elif prefill_flash:
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
    return h + _row_parallel(attn.reshape(B, S, nq * D), lp["wo"], mesh)


def _row_parallel(x: torch.Tensor, w, mesh) -> torch.Tensor:
    """x @ w for a row-parallel leaf (wo, wd): this rank's K-slice of the
    product, summed over the `model` axis in float32 and rounded to the
    activation dtype once. A flat int8 leaf sums its float32 partials
    before the per-column scale, as a sharded packed leaf does inside
    qmatmul (ops/qmm.py w8a16_apply_sharded)."""
    if _tp(mesh) == 1:
        return qmatmul(x, w)
    if isinstance(w, PackedQuantizedTensor):
        if w.k_axis is None:
            raise ValueError("a row-parallel packed leaf on a mesh must "
                             "carry its k_axis (pack_params(mesh=...))")
        return qmatmul(x, w)
    if isinstance(w, QuantizedTensor):
        part = mixed_dot(x, w.q, w.scale, out_dtype=torch.float32,
                         apply_scale=False)
        return (mesh.all_reduce(part, "model") * w.scale).to(x.dtype)
    return mesh.all_reduce(_float32_product(x, w), "model").to(x.dtype)


def _float32_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with a float32 result: products of the activation dtype summed
    in float32 and not rounded back (cuBLAS's bf16 product with a float32
    output on the card; float32 operands, exact for bf16 values, on the
    CPU)."""
    if x.dtype == torch.float32:
        return x @ w
    if x.device.type == "cuda":
        *lead, k = x.shape
        return torch.mm(x.reshape(-1, k), w, out_dtype=torch.float32
                        ).reshape(*lead, w.shape[-1])
    return x.float() @ w.float()


def embed_tokens(embed: torch.Tensor, tokens: torch.Tensor,
                 mesh=None) -> torch.Tensor:
    """Rows of the embedding for `tokens`. Vocab-parallel on a mesh: each
    rank gathers the rows its vocab block holds, zeros elsewhere, and the
    sum over the axis (one nonzero term per row: exact) is the full
    lookup."""
    if _tp(mesh) == 1:
        return embed[tokens.long()]
    rows = embed.shape[0]
    local = tokens.long() - mesh.axis_index("model") * rows
    inside = (local >= 0) & (local < rows)
    h = torch.where(inside[..., None], embed[local.clamp(0, rows - 1)],
                    torch.zeros((), dtype=embed.dtype, device=embed.device))
    return mesh.all_reduce(h, "model")


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
    mesh=None,
    use_ring=None,
    sp_mode: str = "ring",
    cache_layer=lambda i: i,
    batch_axis: str | None = None,
) -> torch.Tensor:
    """Run the stack of decoder layers over `h` (a Python loop over the
    stacked layer dim; the cache is written in place). Layer i of the stack
    reads and writes layer `cache_layer(i)` of the cache: a pipeline stage
    runs its local layers against its local cache, viewed per microbatch
    (parallel/pipeline.py)."""
    n_layers = _stacked_layers(layers_params["wq"])
    for i in range(n_layers):
        lp = {name: layer_slice(w, i) for name, w in layers_params.items()}
        h = _layer(h, lp, cache, cache_layer(i), positions, kv_valid,
                   seq_lens, config, use_flash, mesh, use_ring, sp_mode,
                   batch_axis)
    return h


def forward_hidden(
    params: dict,
    config: ModelConfig,
    tokens: torch.Tensor,     # [B, S] integer token ids
    cache: KVCache,           # lengths[b] = tokens already in cache for slot b
    seq_lens: torch.Tensor | None = None,  # [B] valid tokens; None = all S
    *,
    prefill_flash: bool = False,  # caller guarantees the cache is empty
    ring_mesh=None,               # context-parallel prefill mesh
    sp_mode: str = "ring",        # "ring" | "ulysses"
    mesh=None,                    # tensor parallel (this rank's blocks)
    batch_axis: str | None = None,  # the batch is a block of this axis
) -> tuple[torch.Tensor, KVCache]:
    """Decoder trunk: returns (final-norm hidden states [B, S, E], cache).

    Split from the LM head so prefill can project only the last valid
    position. prefill_flash=True is VALID ONLY when cache.lengths are all
    zero (the engine's prefill): attention then covers this call's own
    K/V, not the cache. With `mesh`, params and cache are this rank's
    blocks and the hidden states come out whole on every rank.

    ring_mesh additionally shards the attention's sequence over the mesh's
    `context` axis (every rank of it calls this with the same inputs); it
    requires prefill_flash's empty-cache contract and S divisible by the
    shard count, and is unused when S == 1. sp_mode picks the scheme:
    "ring" rotates K/V blocks (parallel/ring.py, any head count),
    "ulysses" head-scatters by all-to-all (parallel/ulysses.py, needs
    num_kv_heads % shards == 0, judged on the whole model's heads as the
    JAX function judges them). The schemes take no window: with ring_mesh
    set, a sliding-window model runs the flash kernel instead, as in the
    JAX package. ring_mesh may have any other axis above 1: with `mesh`,
    which must then have its shape, params and cache are this rank's
    blocks (its heads on a `model` rank, its experts on an `expert` rank);
    without, they are whole and the other axes' ranks are replicas. A
    stage rank's block of the layers is refused (pipeline_forward_hidden
    takes no ring_mesh, as the JAX one takes none).

    `batch_axis` names the mesh axis whose ranks each hold a block of the
    batch (the engine's decode and verify on a `data` axis): an MoE layer
    then runs a dispatch-sized call over the whole batch (models/moe.py)."""
    if ring_mesh is not None:
        if not prefill_flash:
            # Ring q/kv positions start at 0 and ignore cached entries: only
            # the prefill-from-empty contract makes that correct.
            raise ValueError("ring_mesh requires prefill_flash=True "
                             "(prefill-from-empty contract)")
        if _pp(mesh) > 1:
            raise ValueError(
                "ring_mesh with a stage rank's block of the layers: "
                "pipeline_forward_hidden takes no ring_mesh, as the JAX "
                "pipeline takes none; pass whole params and cache without "
                "`mesh`, over which the stage ranks are replicas")
        if mesh is not None and mesh.size > 1 and (
                mesh.shape != ring_mesh.shape):
            raise ValueError(f"ring_mesh {ring_mesh.shape} and mesh "
                             f"{mesh.shape} differ: params and cache are "
                             f"blocks of `mesh`, and the ring runs on its "
                             f"ranks")
    B, S = tokens.shape
    if seq_lens is None:
        seq_lens = torch.full((B,), S, dtype=torch.int32,
                              device=tokens.device)
    positions = (cache.lengths[:, None]
                 + torch.arange(S, dtype=torch.int32,
                                device=tokens.device)[None, :])
    kv_valid = cache.lengths + seq_lens
    use_ring = ring_mesh if (ring_mesh is not None and S > 1
                             and config.sliding_window is None) else None
    use_flash = prefill_flash and use_ring is None and S > 1
    if use_ring is not None:
        # refused before any layer runs, as the JAX functions refuse at
        # trace time
        n = use_ring.axis_size("context")
        if sp_mode == "ulysses":
            ulysses.check_shards(S, config.num_heads, config.num_kv_heads, n)
        else:
            ring.check_shards(S, n)

    n_stacked = _stacked_layers(params["layers"]["wq"])
    if n_stacked != config.num_layers:
        # The cache is sized by config: a depth mismatch must fail loudly.
        raise ValueError(f"params carry {n_stacked} stacked layers but "
                         f"config.num_layers = {config.num_layers}")
    h = embed_tokens(params["embed"], tokens, mesh)
    if h.device.type == "cuda":
        check_attention_kernels(config, h.dtype, flash=use_flash,
                                decode=S == 1, tp=_tp(mesh))
    if config.scale_embed:
        # gemma: embeddings scaled by sqrt(hidden) at lookup, normalizer
        # cast to the activation dtype (HF modeling_gemma semantics)
        h = h * torch.tensor(config.hidden_size ** 0.5, dtype=h.dtype)
    h = run_layers(params["layers"], h, cache, positions, kv_valid,
                   seq_lens, config, use_flash=use_flash, mesh=mesh,
                   use_ring=use_ring, sp_mode=sp_mode, batch_axis=batch_axis)
    h = rms_norm(h, norm_weight(params["final_norm"], config.norm_plus_one),
                 config.rms_eps)
    return h, cache._replace(lengths=kv_valid)


def check_attention_kernels(config: ModelConfig, dtype: torch.dtype,
                            *, flash: bool, decode: bool, tp: int = 1
                            ) -> None:
    """On the card, every prefill from empty runs the flash kernel and
    every single-position step the decode kernel, with no plain path:
    refuse, before any layer runs, a head dim or group the kernels' gates
    (`flash.kernel_supports`, `decode_attention.kernel_supports`) refuse.
    At tensor-parallel degree `tp` the kernels see num_heads / tp and
    num_kv_heads / tp heads."""
    D = config.dim_per_head
    if flash and not flash_ops.kernel_supports(dtype, D):
        raise ValueError(f"flash.kernel_supports({dtype}, {D}) is false: "
                         f"the flash kernels take float32 or bf16 at a "
                         f"head_dim that is a multiple of 8 from 16 to 256")
    group = (config.num_heads // tp) // (config.num_kv_heads // tp)
    if decode and not decode_ops.kernel_supports(D, group):
        raise ValueError(f"decode_attention.kernel_supports({D}, {group}) is "
                         f"false: the decode kernels take a head_dim that "
                         f"is a multiple of 8 from 16 to 256")


def logits_from_hidden(params: dict, config: ModelConfig,
                       h: torch.Tensor, mesh=None) -> torch.Tensor:
    """LM head: [B, S, E] hidden -> [B, S, vocab] float32 logits. On a
    mesh each rank projects onto its vocab block and the blocks are
    gathered, so every rank holds the full logits."""
    head = params["embed"].T if config.tie_embeddings else params["lm_head"]
    logits = qmatmul(h, head).to(torch.float32)
    return logits if _tp(mesh) == 1 else mesh.all_gather(logits, "model")


def forward(
    params: dict,
    config: ModelConfig,
    tokens: torch.Tensor,     # [B, S]
    cache: KVCache,
    seq_lens: torch.Tensor | None = None,
    *,
    mesh=None,
) -> tuple[torch.Tensor, KVCache]:
    """Run the decoder; returns (logits [B, S, vocab] f32, updated cache).

    Serves prefill (S = padded prompt length) and decode (S = 1 per slot)
    with the same code. Logits at padded positions are garbage by contract;
    callers index the last valid position."""
    h, cache = forward_hidden(params, config, tokens, cache, seq_lens,
                              mesh=mesh)
    return logits_from_hidden(params, config, h, mesh), cache


# ---------------------------------------------------------------------------
# HF weight layout map (used by engine/weights.py; kept here because it is
# model knowledge). HF linear weights are [out, in] -- transposed vs ours.

HF_TOP_MAP = {
    "model.embed_tokens.weight": ("embed", False),
    "model.norm.weight": ("final_norm", False),
    "lm_head.weight": ("lm_head", True),  # [V,E] -> [E,V]
}
HF_LAYER_MAP = {
    "input_layernorm.weight": ("attn_norm", False),
    "post_attention_layernorm.weight": ("mlp_norm", False),
    "self_attn.q_proj.weight": ("wq", True),
    "self_attn.k_proj.weight": ("wk", True),
    "self_attn.v_proj.weight": ("wv", True),
    # qwen2: QKV projection biases (absent in llama/mistral checkpoints)
    "self_attn.q_proj.bias": ("bq", False),
    "self_attn.k_proj.bias": ("bk", False),
    "self_attn.v_proj.bias": ("bv", False),
    "self_attn.o_proj.weight": ("wo", True),
    "mlp.gate_proj.weight": ("wg", True),
    "mlp.up_proj.weight": ("wu", True),
    "mlp.down_proj.weight": ("wd", True),
}
# Mixtral: the MLP block is `block_sparse_moe` -- a router (`gate`) plus
# per-expert w1/w2/w3 Linears (w1=gate_proj, w2=down_proj, w3=up_proj).
# All are HF [out, in] -> transposed; experts stack on our leading dim.
HF_MOE_ROUTER = "block_sparse_moe.gate.weight"            # -> router (T)
HF_EXPERT_MAP = {"w1": "wg", "w3": "wu", "w2": "wd"}      # all transposed


def hf_expert_name(layer: int, expert: int, ours: str) -> str:
    w = {v: k for k, v in HF_EXPERT_MAP.items()}[ours]
    return f"model.layers.{layer}.block_sparse_moe.experts.{expert}.{w}.weight"


def config_from_hf(hf: dict[str, Any]) -> ModelConfig:
    """Build a ModelConfig from an HF config.json dict (llama/mistral/
    qwen2/gemma/mixtral shapes; mixtral's num_local_experts selects
    MoEConfig)."""
    arch = (hf.get("architectures") or [""])[0]
    # Exact match: gemma-2/3 checkpoints (Gemma2ForCausalLM, ...) need
    # logit softcapping, post-layer norms, and alternating local
    # attention this decoder does not implement -- loading them with
    # gemma-1 semantics would silently generate garbage.
    gemma = arch == "GemmaForCausalLM"
    if arch.startswith("Gemma") and not gemma:
        raise ValueError(
            f"unsupported architecture {arch!r}: only first-generation "
            f"GemmaForCausalLM semantics are implemented")
    # qwen2 configs carry a vestigial sliding_window alongside
    # use_sliding_window: false -- honoring it would silently disable every
    # fast attention path.
    sliding = hf.get("sliding_window")
    if hf.get("use_sliding_window") is False:
        sliding = None
    shape = dict(
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=hf["num_attention_heads"],
        num_kv_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
        intermediate_size=hf["intermediate_size"],
        head_dim=hf.get("head_dim"),
        rope_theta=hf.get("rope_theta", 10000.0),
        rms_eps=hf.get("rms_norm_eps", 1e-5),
        sliding_window=sliding,
        # older qwen2 configs carry no attention_bias key; the architecture
        # implies it (HF modeling_qwen2 hardcodes bias=True on q/k/v).
        attention_bias=hf.get("attention_bias", "Qwen2" in arch),
        max_position=hf.get("max_position_embeddings", 8192),
    )
    if hf.get("num_local_experts"):
        return MoEConfig(
            **shape,
            tie_embeddings=hf.get("tie_word_embeddings", False),
            num_experts=hf["num_local_experts"],
            num_experts_per_tok=hf.get("num_experts_per_tok", 2),
        )
    return ModelConfig(
        **shape,
        # gemma ties embeddings BY DEFAULT, so its config.json often omits
        # the key entirely -- defaulting it False would reject the checkpoint
        tie_embeddings=hf.get("tie_word_embeddings", gemma),
        # gemma: GeGLU + (1+w) norms + scaled embeddings; hidden_activation
        # ("gelu_pytorch_tanh") appears in newer configs, older ones imply it
        hidden_act="gelu_tanh" if gemma else "silu",
        norm_plus_one=gemma,
        scale_embed=gemma,
    )
