"""Inference pipeline parallelism: layer stages over the `stage` mesh axis
(port of symmetry_tpu/parallel/pipeline.py).

The model's stacked layers shard across pipeline stages (PIPELINE_RULES,
parallel/sharding.py: a stage rank holds its contiguous L / P layers and
its block of the KV cache), activations flow stage to stage as
point-to-point transfers (Mesh.send / Mesh.recv; no per-layer
collectives), and GPipe microbatching keeps every stage busy once the pipe
fills.

Schedule (M microbatches, P stages): in round t, stage s runs microbatch
t - s when 0 <= t - s < M, then hands its activation to stage s + 1. The
JAX program runs every round on every stage, computes the inactive rounds
on garbage and drops their writes with `where`; here each rank is a
process and SKIPS its inactive rounds, which gives the same results: a
stage's loop is "for each microbatch: receive (or embed, on stage 0), run
the local layers, send on (or keep, on the last stage)", and the blocking
receive is what places microbatch m on stage s in round m + s.

Cache discipline: a rank's cache holds its layers ([L / P, B, ...]), and a
microbatch m's rows are viewed as cache "layer" l * M + m of the
[L / P * M, B / M, ...] view, which is contiguous: the decode kernel and
its fused int8 row write (ops/decode_attention.py, append mode) take it
as they take a whole cache. PR 7 made that fused write bit-equal to the
unfused quantize-and-assign pair, so running it on a stage's unsharded
local cache gives the JAX scatter path's cache (which the JAX pipeline
keeps, `kv_append_ok=False`). Layer indices inside a stage are local.

At the end the last stage's outputs reach every stage by a broadcast over
the axis (the JAX `psum` over zeros elsewhere, which is exact), and the
final norm runs on every rank, so every rank returns the whole hidden
states. Stage 0 scales a gemma embedding (`scale_embed`) as forward_hidden
does; the JAX pipeline leaves that scale out.
"""

from __future__ import annotations

import torch

from symmetry_tpu_torch.models.llama import (
    KVCache,
    ModelConfig,
    _stacked_layers,
    check_attention_kernels,
    embed_tokens,
    run_layers,
)
from symmetry_tpu_torch.ops.norm import norm_weight, rms_norm
from symmetry_tpu_torch.parallel.sharding import PIPELINE_RULES

__all__ = ["PIPELINE_RULES", "pipeline_forward_hidden"]


def _stage_only(mesh) -> None:
    other = [a for a in ("data", "context", "expert", "model")
             if mesh.shape[a] != 1]
    if other:
        # Composing PP with TP/DP/EP needs each stage's blocks cut by the
        # other axes too: refused, as in the JAX package.
        raise ValueError(
            f"pipeline_forward_hidden shards only the stage axis; mesh has "
            f"non-trivial axes {other} — use a stage-only (sub)mesh")


def pipeline_forward_hidden(
    params: dict,
    config: ModelConfig,
    tokens: torch.Tensor,      # [B, S] token ids, the same on every stage
    cache: KVCache,            # this stage's layers
    mesh,
    seq_lens: torch.Tensor | None = None,
    *,
    n_microbatches: int = 2,
    prefill_flash: bool = False,
) -> tuple[torch.Tensor, KVCache]:
    """Pipeline-parallel decoder trunk (embed -> staged layers -> final
    norm). Returns (hidden [B, S, E] on every stage, updated cache).

    `params["layers"]` and the cache hold this stage's layers
    (PIPELINE_RULES: models/llama.py shard_params and init_cache on the
    mesh); the embedding, final norm and head are whole. Every stage calls
    this with the same tokens. The batch must divide n_microbatches.
    prefill_flash routes each stage's local attention through the flash
    kernel, under forward_hidden's empty-cache contract."""
    n_stages = mesh.shape["stage"]
    B, S = tokens.shape
    if B % n_microbatches:
        raise ValueError(f"batch {B} not divisible by {n_microbatches} "
                         f"microbatches")
    if config.num_layers % n_stages:
        raise ValueError(f"{config.num_layers} layers not divisible by "
                         f"{n_stages} stages")
    _stage_only(mesh)
    n_local = _stacked_layers(params["layers"]["wq"])
    if n_local * n_stages != config.num_layers:
        raise ValueError(f"params carry {n_local} stacked layers on a stage "
                         f"of {n_stages} but config.num_layers = "
                         f"{config.num_layers}: shard them with "
                         f"PIPELINE_RULES")
    stage = mesh.axis_index("stage")
    dev = tokens.device
    if seq_lens is None:
        seq_lens = torch.full((B,), S, dtype=torch.int32, device=dev)
    use_flash = prefill_flash and S > 1
    positions = (cache.lengths[:, None]
                 + torch.arange(S, dtype=torch.int32, device=dev)[None, :])
    kv_valid = cache.lengths + seq_lens
    E = config.hidden_size
    dtype = params["embed"].dtype
    if dev.type == "cuda":
        check_attention_kernels(config, dtype, flash=use_flash,
                                decode=S == 1)

    M, bm = n_microbatches, B // n_microbatches

    def view(t):
        # [L, B, ...] -> [L * M, B / M, ...]: microbatch m of layer l is
        # "layer" l * M + m, a contiguous block as the kernels take it.
        return None if t is None else t.view(
            t.shape[0] * M, bm, *t.shape[2:])

    mb_cache = cache if M == 1 else KVCache(
        k=view(cache.k), v=view(cache.v), lengths=cache.lengths,
        k_scale=view(cache.k_scale), v_scale=view(cache.v_scale))
    outputs = []
    for m in range(M):
        rows = slice(m * bm, (m + 1) * bm)
        # copies, not views: the kernels take 16-byte-aligned operands
        pos_m, valid_m, lens_m = (t[rows].clone()
                                  for t in (positions, kv_valid, seq_lens))

        if stage == 0:
            h = embed_tokens(params["embed"], tokens[rows])
            if config.scale_embed:
                h = h * torch.tensor(config.hidden_size ** 0.5, dtype=h.dtype)
        else:
            h = mesh.recv((bm, S, E), dtype, "stage", stage - 1)
        h = run_layers(params["layers"], h, mb_cache, pos_m, valid_m,
                       lens_m, config,
                       use_flash=use_flash,
                       cache_layer=lambda i, m=m: i * M + m)
        if stage < n_stages - 1:
            mesh.send(h, "stage", stage + 1)
        else:
            outputs.append(h)
    out = (torch.cat(outputs) if outputs
           else torch.empty((B, S, E), dtype=dtype, device=dev))
    # Only the last stage holds real outputs: its broadcast is the JAX
    # psum over zeros, which replicates them to every stage.
    h = mesh.broadcast(out, "stage", n_stages - 1)
    h = rms_norm(h, norm_weight(params["final_norm"], config.norm_plus_one),
                 config.rms_eps)
    return h, cache._replace(lengths=kv_valid)
