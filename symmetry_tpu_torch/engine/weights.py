"""Weight loading: an HF safetensors checkpoint to this package's params
(port of symmetry_tpu/engine/weights.py).

The constraint is host RAM: an 8B model must not be materialized on the
host. Each HF tensor is read from the memory-mapped files
(engine/safetensors_io.py), moved to the device, transposed there (HF
linear weights are [out, in], ours [in, out]) and written into its layer
of the stacked [L, ...] leaf, so the host holds one tensor at a time. The
cast to the engine's dtype rounds to nearest even, as the JAX loader's.

The warm cache keeps the FINISHED tree (stacked, transposed, quantized for
int8 serving) beside the checkpoint, in the JAX package's format: the same
directory and tag, a flat int8 layout, bfloat16 stored as uint16 views, the
same meta.json. Each package reads the other's cache. A restart then reads
one flat file straight to the device.

Mixtral checkpoints (`block_sparse_moe`) load into the MoE layout: the
router [L, E, X] and the expert stacks [L, X, in, out], one HF tensor per
(layer, expert) written into its slot.

On a mesh (`mesh`, parallel/), each rank reads only its block of each
tensor (models/llama.py param_logical_axes under the sharding rules): the
mapped tensor is sliced before anything is copied, so no rank holds a
whole tensor. The block equals slicing the single-device tree, int8
included: a rank quantizing its K-slice of a row-parallel leaf takes each
column's amax over the whole K (a max over the mesh axis) before its
scale, as quantizing the full leaf does. MoE checkpoints do not load on a
mesh (ROADMAP Queue 1 item 14).
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import tempfile
from typing import Any, Iterator

import torch

from symmetry_tpu_torch.engine.safetensors_io import (
    CheckpointError,
    SafetensorsDir,
    SafetensorsFile,
    save_file,
    save_sharded,
)
from symmetry_tpu_torch.models.llama import (
    HF_EXPERT_MAP,
    HF_LAYER_MAP,
    HF_MOE_ROUTER,
    HF_TOP_MAP,
    QUANT_KEYS,
    ModelConfig,
    MoEConfig,
    config_from_hf,
    hf_expert_name,
    param_logical_axes,
    scale_axes,
)
from symmetry_tpu_torch.ops.quant import (
    PackedQuantizedTensor,
    QuantizedTensor,
    quantize as quantize_leaf,
    unpack_quantized,
)

__all__ = ["CheckpointError", "convert_hf_state_dict", "load_checkpoint",
           "save_checkpoint", "save_warm_cache", "load_warm_cache",
           "warm_cache_current"]


def _block(mesh, rules, axes: tuple):
    """The function cutting this rank's block out of a full tensor laid out
    by logical `axes` (identity without a mesh), and whether its
    contraction (second-last) dim is split: a row-parallel leaf, whose
    int8 scales need the amax over every rank's rows."""
    from symmetry_tpu_torch.parallel.sharding import (Sharding,
                                                      logical_to_spec)

    if mesh is None:
        return (lambda t: t), False
    spec = logical_to_spec(axes, rules)
    return Sharding(mesh, spec), (len(spec) >= 2
                                  and mesh.axis_size(spec[-2]) > 1)


_EXPERT_LEAVES = ("wg", "wu", "wd")
# Columns quantized at a time by load_checkpoint(quantize=True): bounds the
# quantizer's float32 temporaries (a wide LM head's would be ~4x its bf16).
_QUANT_COLS = 16384


# ---------------------------------------------------------------------------
# In-memory conversion (tests, tiny models, torch-exported dicts)


def convert_hf_state_dict(tensors: dict[str, Any], config: ModelConfig
                          ) -> dict:
    """Convert a full in-memory HF llama-family or mixtral state dict
    (numpy arrays or tensors) to our params dict of CPU tensors, dtypes
    kept."""
    n_exp = getattr(config, "num_experts", 0)
    per_layer: dict[str, list] = {
        ours: [None] * config.num_layers
        for ours, _ in HF_LAYER_MAP.values()
        # bias params exist only for attention_bias (qwen2) configs
        if config.attention_bias or ours not in ("bq", "bk", "bv")}
    if n_exp:
        # MoE FFN params come per (layer, expert); experts stack inside
        # each layer. The dense FFN names are absent in mixtral files.
        for ours in _EXPERT_LEAVES:
            per_layer[ours] = [[None] * n_exp
                               for _ in range(config.num_layers)]
        per_layer["router"] = [None] * config.num_layers
    top: dict[str, torch.Tensor] = {}
    for name, arr in tensors.items():
        t = torch.as_tensor(arr)
        if name in HF_TOP_MAP:
            ours, transpose = HF_TOP_MAP[name]
            top[ours] = t.T if transpose else t
        elif name.startswith("model.layers."):
            idx_str, _, sub = name[len("model.layers."):].partition(".")
            layer = int(idx_str)
            if n_exp and sub == HF_MOE_ROUTER:
                per_layer["router"][layer] = t.T
            elif n_exp and sub.startswith("block_sparse_moe.experts."):
                parts = sub.split(".")       # experts . <e> . w1 . weight
                expert, w = int(parts[2]), parts[3]
                if w not in HF_EXPERT_MAP:
                    raise CheckpointError(f"unmapped HF tensor {name!r}")
                per_layer[HF_EXPERT_MAP[w]][layer][expert] = t.T
            elif sub in HF_LAYER_MAP:
                ours, transpose = HF_LAYER_MAP[sub]
                if ours not in per_layer:
                    raise CheckpointError(
                        f"checkpoint has {name!r} but the config does not "
                        f"enable attention_bias")
                per_layer[ours][layer] = t.T if transpose else t
            else:
                raise CheckpointError(f"unmapped HF tensor {name!r}")
        else:
            raise CheckpointError(f"unmapped HF tensor {name!r}")

    if n_exp:
        for ours in _EXPERT_LEAVES:
            per_layer[ours] = [
                torch.stack(experts)
                if all(e is not None for e in experts) else None
                for experts in per_layer[ours]]
    for ours, lst in per_layer.items():
        missing = [i for i, a in enumerate(lst) if a is None]
        if missing:
            raise CheckpointError(f"missing layers {missing} for param {ours!r}")

    params: dict = {
        "embed": top["embed"],
        "layers": {ours: torch.stack(lst) for ours, lst in per_layer.items()},
        "final_norm": top["final_norm"],
    }
    if not config.tie_embeddings:
        if "lm_head" not in top:
            raise CheckpointError("checkpoint lacks lm_head and config is untied")
        params["lm_head"] = top["lm_head"]
    return params


# ---------------------------------------------------------------------------
# Streaming safetensors loading


def _leaf_shapes(c: ModelConfig) -> tuple[dict, dict]:
    """(top-level, per-layer) leaf shapes of our params, per layer without
    the leading L (an MoE expert stack keeps its experts dim X)."""
    E, F, V = c.hidden_size, c.intermediate_size, c.vocab_size
    top = {"embed": (V, E), "final_norm": (E,)}
    if not c.tie_embeddings:
        top["lm_head"] = (E, V)
    layer = {"attn_norm": (E,), "mlp_norm": (E,), "wq": (E, c.q_dim),
             "wk": (E, c.kv_dim), "wv": (E, c.kv_dim), "wo": (c.q_dim, E),
             "wg": (E, F), "wu": (E, F), "wd": (F, E)}
    if c.attention_bias:
        layer.update(bq=(c.q_dim,), bk=(c.kv_dim,), bv=(c.kv_dim,))
    n_exp = getattr(c, "num_experts", 0)
    if n_exp:
        layer.update(wg=(n_exp, E, F), wu=(n_exp, E, F), wd=(n_exp, F, E),
                     router=(E, n_exp))
    return top, layer


def read_hf_config(path: str) -> ModelConfig:
    cfg_path = os.path.join(path, "config.json")
    if not os.path.exists(cfg_path):
        raise CheckpointError(f"no config.json under {path}")
    try:
        with open(cfg_path, "r", encoding="utf-8") as fh:
            return config_from_hf(json.load(fh))
    except (OSError, ValueError, KeyError) as exc:
        raise CheckpointError(f"{cfg_path}: unreadable: {exc}") from exc


def load_checkpoint(
    path: str,
    config: ModelConfig | None = None,
    *,
    mesh=None,
    rules: dict[str, str | None] | None = None,
    dtype: torch.dtype = torch.bfloat16,
    device: str | torch.device = "cuda",
    quantize: bool = False,
) -> tuple[dict, ModelConfig]:
    """Load an HF llama-family or mixtral checkpoint dir onto `device`.

    Returns (params, config). If `config` is None it is derived from the
    checkpoint's config.json. A missing or unreadable checkpoint raises
    CheckpointError.

    quantize=True gives the tree quantize_params would make of the dense
    one, bit for bit, without ever holding the dense tree: each QUANT_KEYS
    tensor is cast to `dtype` and quantized as it is read (per-column
    scales, so one layer's or one expert's [K, N] slab at a time gives the
    whole leaf's), into int8 leaves allocated up front. mixtral-8x7b's
    dense tree (~93.4 GB in bf16) does not fit one 80 GB card; its int8
    tree (~46.9 GB) does.

    With `mesh`, this rank's blocks only (see the module docstring);
    every rank of the mesh calls it, in the same order (an int8 load of a
    row-parallel leaf takes a max over the mesh axis per column block)."""
    if config is None:
        config = read_hf_config(path)
    if mesh is not None and getattr(config, "num_experts", 0):
        raise NotImplementedError("MoE checkpoints on a mesh are not "
                                  "ported yet (ROADMAP Queue 1 item 14)")
    device = torch.device(device)
    store = SafetensorsDir(path)
    tied = config.tie_embeddings or "lm_head.weight" not in store.names()
    if tied and not config.tie_embeddings:
        raise CheckpointError("checkpoint ties embeddings but config does not")
    top_shapes, layer_shapes = _leaf_shapes(config)
    axes = param_logical_axes(config)

    def read(hf_name: str, transpose: bool, shape: tuple,
             block=lambda t: t) -> torch.Tensor:
        t = store.get(hf_name)
        t = t.T if transpose else t
        if tuple(t.shape) != shape:
            raise CheckpointError(f"tensor {hf_name!r} has shape "
                                  f"{list(t.shape)}; the config needs "
                                  f"{list(shape)}")
        return block(t).to(device)

    def leaf(name: str, shape: tuple, row_parallel: bool = False):
        """An empty leaf and the function that writes one slab into it."""
        if not (quantize and name in QUANT_KEYS):
            t = torch.empty(shape, dtype=dtype, device=device)

            def put(i: tuple, w: torch.Tensor) -> None:
                t[i].copy_(w)
            return t, put
        q = torch.empty(shape, dtype=torch.int8, device=device)
        s = torch.empty((*shape[:-2], shape[-1]), dtype=torch.float32,
                        device=device)
        reduce = ((lambda amax: mesh.all_reduce(amax, "model", "max"))
                  if row_parallel else None)

        def put(i: tuple, w: torch.Tensor) -> None:
            for n0 in range(0, shape[-1], _QUANT_COLS):
                qt = quantize_leaf(w[:, n0:n0 + _QUANT_COLS].to(dtype),
                                   amax_reduce=reduce)
                q[i][:, n0:n0 + _QUANT_COLS] = qt.q
                s[i][n0:n0 + _QUANT_COLS] = qt.scale
        return QuantizedTensor(q=q, scale=s), put

    def local_shape(block, shape: tuple) -> tuple:
        return block.shard_shape(shape) if mesh is not None else shape

    params: dict = {"layers": {}}
    for hf_name, (ours, transpose) in HF_TOP_MAP.items():
        if ours in top_shapes:
            shape = top_shapes[ours]
            block, row_par = _block(mesh, rules, axes[ours])
            params[ours], put = leaf(ours, local_shape(block, shape),
                                     row_par)
            put((), read(hf_name, transpose, shape, block))
    n_exp = getattr(config, "num_experts", 0)
    L = config.num_layers
    for hf_sub, (ours, transpose) in HF_LAYER_MAP.items():
        if ours not in layer_shapes or (n_exp and ours in _EXPERT_LEAVES):
            continue
        shape = layer_shapes[ours]
        # one layer's block: the leaf's axes without the stacked "layers"
        block, row_par = _block(mesh, rules, axes["layers"][ours][1:])
        params["layers"][ours], put = leaf(
            ours, (L, *local_shape(block, shape)), row_par)
        for layer in range(L):
            put((layer,), read(f"model.layers.{layer}.{hf_sub}", transpose,
                               shape, block))
    if n_exp:
        shape = layer_shapes["router"]
        params["layers"]["router"], put = leaf("router", (L, *shape))
        for layer in range(L):
            put((layer,), read(f"model.layers.{layer}.{HF_MOE_ROUTER}",
                               True, shape))
        # One HF tensor per (layer, expert), straight into its slot.
        for ours in _EXPERT_LEAVES:
            shape = layer_shapes[ours][1:]
            params["layers"][ours], put = leaf(ours, (L, n_exp, *shape))
            for layer in range(L):
                for e in range(n_exp):
                    put((layer, e), read(hf_expert_name(layer, e, ours),
                                         True, shape))
    return params, config


def save_checkpoint(path: str, params: dict, config: ModelConfig, *,
                    dtype: torch.dtype = torch.float32,
                    shards: int = 1) -> None:
    """Write dense params back out in the HF layout (mixtral's
    `block_sparse_moe` names for an MoE config), with the config.json the
    JAX package's save_checkpoint writes: float32 in one model.safetensors
    by default, as there; `dtype` and `shards` (> 1: HF's sharded names
    and index json) for larger fixtures. Tensors move to the host one at a
    time."""
    n_exp = getattr(config, "num_experts", 0)
    os.makedirs(path, exist_ok=True)
    tensors: dict[str, torch.Tensor] = {}
    for hf_name, (ours, transpose) in HF_TOP_MAP.items():
        if ours in params:
            tensors[hf_name] = params[ours].T if transpose else params[ours]
    for hf_sub, (ours, transpose) in HF_LAYER_MAP.items():
        stacked = params["layers"].get(ours)
        if stacked is None or (n_exp and ours in _EXPERT_LEAVES):
            continue
        for layer in range(stacked.shape[0]):
            t = stacked[layer]
            tensors[f"model.layers.{layer}.{hf_sub}"] = t.T if transpose else t
    if n_exp:
        router = params["layers"]["router"]
        for layer in range(router.shape[0]):
            tensors[f"model.layers.{layer}.{HF_MOE_ROUTER}"] = router[layer].T
        for ours in _EXPERT_LEAVES:
            stacked = params["layers"][ours]
            for layer in range(stacked.shape[0]):
                for e in range(stacked.shape[1]):
                    tensors[hf_expert_name(layer, e, ours)] = (
                        stacked[layer, e].T)
    if shards > 1:
        save_sharded(tensors, path, shards, dtype=dtype)
    else:
        save_file(tensors, os.path.join(path, "model.safetensors"),
                  dtype=dtype)
    hf_cfg = {
        "architectures": ["MixtralForCausalLM" if n_exp
                          else ("Qwen2ForCausalLM" if config.attention_bias
                                else "LlamaForCausalLM")],
        "attention_bias": config.attention_bias,
        "vocab_size": config.vocab_size,
        "hidden_size": config.hidden_size,
        "num_hidden_layers": config.num_layers,
        "num_attention_heads": config.num_heads,
        "num_key_value_heads": config.num_kv_heads,
        "intermediate_size": config.intermediate_size,
        "rope_theta": config.rope_theta,
        "rms_norm_eps": config.rms_eps,
        "tie_word_embeddings": config.tie_embeddings,
        "max_position_embeddings": config.max_position,
        "sliding_window": config.sliding_window,
        "head_dim": config.head_dim,
    }
    if n_exp:
        hf_cfg["num_local_experts"] = n_exp
        hf_cfg["num_experts_per_tok"] = config.num_experts_per_tok
    with open(os.path.join(path, "config.json"), "w", encoding="utf-8") as fh:
        json.dump(hf_cfg, fh, indent=2)


# ---------------------------------------------------------------------------
# Warm restart cache
#
# Loading a big checkpoint costs safetensors streaming + HF-layout
# transposition + layer stacking + (for int8 serving) quantization of
# every matmul weight. All of it is deterministic in (checkpoint, dtype,
# quantize), so the first load persists the FINISHED param tree and every
# restart after that is a flat mmap read straight to the device.

_WARM_DIR = ".symmetry_warm"
_WARM_VERSION = 1


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _warm_path(checkpoint_path: str, dtype: torch.dtype, quantize: bool
               ) -> str:
    tag = (f"v{_WARM_VERSION}-{_dtype_name(dtype)}-"
           f"{'int8' if quantize else 'dense'}")
    return os.path.join(checkpoint_path, _WARM_DIR, tag)


def _flatten_params(params: dict, prefix: str = ""
                    ) -> Iterator[tuple[str, torch.Tensor]]:
    for name, child in sorted(params.items()):
        path = f"{prefix}{name}"
        if isinstance(child, dict):
            yield from _flatten_params(child, path + "/")
        elif isinstance(child, (QuantizedTensor, PackedQuantizedTensor)):
            # The cache stores the FLAT int8 layout: the panel layout is a
            # kernel detail (fused_dequant re-packs at engine construction),
            # not checkpoint state.
            if isinstance(child, PackedQuantizedTensor):
                child = unpack_quantized(child)
            yield path + ":q", child.q
            yield path + ":scale", child.scale
        else:
            yield path, child


def _checkpoint_fingerprint(checkpoint_path: str) -> list[list]:
    """(name, mtime, size) of every source file the cache derives from --
    recorded at save, verified at load, so an overwritten checkpoint can
    never be silently served from a stale cache."""
    out = []
    for fname in sorted(os.listdir(checkpoint_path)):
        if fname.endswith(".safetensors") or fname in (
                "config.json", "model.safetensors.index.json"):
            st = os.stat(os.path.join(checkpoint_path, fname))
            out.append([fname, round(st.st_mtime, 3), st.st_size])
    return out


# Guard for the cache WRITE, which an operator can cap or disable.
_WARM_MAX_BYTES = int(float(os.environ.get(
    "SYMMETRY_WARM_CACHE_MAX_GB", "64")) * 1e9)


def save_warm_cache(checkpoint_path: str, params: dict, config: ModelConfig,
                    *, dtype: torch.dtype, quantize: bool) -> None:
    """Persist a finished param tree next to its checkpoint (best effort
    at the caller: failure to cache must never fail serving). bfloat16
    leaves are stored as uint16 views with the dtype recorded. The write
    is ATOMIC (temp dir + rename): a crash mid-save leaves no half-cache a
    later load could trip on. Leaves move to the host one at a time."""
    leaves = dict(_flatten_params(params))
    total = sum(t.numel() * t.element_size() for t in leaves.values())
    if total > _WARM_MAX_BYTES:
        raise RuntimeError(
            f"param tree is {total/1e9:.1f} GB > "
            f"SYMMETRY_WARM_CACHE_MAX_GB; not caching")

    out_dir = _warm_path(checkpoint_path, dtype, quantize)
    dtypes = {name: _dtype_name(t.dtype) for name, t in leaves.items()}
    for name, t in leaves.items():
        if t.dtype not in (torch.float32, torch.float16, torch.int8,
                           torch.int32, torch.bfloat16):
            raise RuntimeError(
                f"unsupported warm-cache dtype {t.dtype} for {name}")
    os.makedirs(os.path.dirname(out_dir), exist_ok=True)
    tmp_dir = tempfile.mkdtemp(dir=os.path.dirname(out_dir))
    try:
        save_file(leaves, os.path.join(tmp_dir, "params.safetensors"),
                  bf16_code="U16")
        meta = {
            "version": _WARM_VERSION,
            "config_class": type(config).__name__,
            "config": dataclasses.asdict(config),
            "dtypes": dtypes,
            "fingerprint": _checkpoint_fingerprint(checkpoint_path),
        }
        with open(os.path.join(tmp_dir, "meta.json"), "w",
                  encoding="utf-8") as fh:
            json.dump(meta, fh)
        if os.path.exists(out_dir):
            shutil.rmtree(out_dir)
        os.rename(tmp_dir, out_dir)
    except BaseException:
        shutil.rmtree(tmp_dir, ignore_errors=True)
        raise


def _warm_meta(checkpoint_path: str, dtype: torch.dtype, quantize: bool
               ) -> dict | None:
    """The warm cache's meta.json when the cache is present and current
    (its version, and the checkpoint files it was made from), else None."""
    out_dir = _warm_path(checkpoint_path, dtype, quantize)
    meta_path = os.path.join(out_dir, "meta.json")
    if not (os.path.exists(meta_path) and os.path.exists(
            os.path.join(out_dir, "params.safetensors"))):
        return None
    try:
        with open(meta_path, "r", encoding="utf-8") as fh:
            meta = json.load(fh)
    except (ValueError, OSError):
        return None
    if not isinstance(meta, dict) or meta.get("version") != _WARM_VERSION:
        return None
    if meta.get("fingerprint") != _checkpoint_fingerprint(checkpoint_path):
        return None  # checkpoint changed since the cache was written
    return meta


def warm_cache_current(checkpoint_path: str, *, dtype: torch.dtype,
                       quantize: bool) -> bool:
    """True when load_warm_cache would find a current cache to read."""
    return _warm_meta(checkpoint_path, dtype, quantize) is not None


def load_warm_cache(checkpoint_path: str, *, dtype: torch.dtype,
                    quantize: bool, mesh=None, rules=None,
                    device: str | torch.device = "cuda"
                    ) -> tuple[dict, ModelConfig] | None:
    """Load a warm cache written by save_warm_cache (by either package)
    onto `device`; None when absent, stale or unreadable (callers fall back
    to the full checkpoint load). With `mesh`, this rank's block of each
    leaf, sliced from the mapped file (the cache holds the whole tree,
    int8 scales taken over the whole contraction)."""
    meta = _warm_meta(checkpoint_path, dtype, quantize)
    if meta is None:
        return None
    try:
        cls = MoEConfig if meta["config_class"] == "MoEConfig" else ModelConfig
        config = cls(**meta["config"])
        dtypes = meta["dtypes"]
        handle = SafetensorsFile(os.path.join(
            _warm_path(checkpoint_path, dtype, quantize),
            "params.safetensors"))
    except (ValueError, TypeError, KeyError, OSError, CheckpointError):
        return None
    if mesh is not None and getattr(config, "num_experts", 0):
        raise NotImplementedError("MoE checkpoints on a mesh are not "
                                  "ported yet (ROADMAP Queue 1 item 14)")
    axes = param_logical_axes(config)

    device = torch.device(device)
    params: dict = {}
    pending_quant: dict[str, dict] = {}
    for name in handle.keys():
        t = handle.get(name)
        want = dtypes.get(name)
        if want == "bfloat16" and t.dtype == torch.uint16:
            t = t.view(torch.bfloat16)
        if _dtype_name(t.dtype) != want:
            return None
        if mesh is not None:
            base, _, part = name.partition(":")
            leaf_axes = axes
            for key in base.split("/"):
                leaf_axes = leaf_axes[key]
            t = _block(mesh, rules, scale_axes(leaf_axes) if part == "scale"
                       else leaf_axes)[0](t)
        arr = t.to(device, copy=True).contiguous()
        if ":" in name:
            base, _, part = name.partition(":")
            pending_quant.setdefault(base, {})[part] = arr
        else:
            _tree_set(params, name.split("/"), arr)
    for base, parts in pending_quant.items():
        _tree_set(params, base.split("/"),
                  QuantizedTensor(q=parts["q"], scale=parts["scale"]))
    return params, config


def _tree_set(tree: dict, parts: list[str], value) -> None:
    for p in parts[:-1]:
        tree = tree.setdefault(p, {})
    tree[parts[-1]] = value

