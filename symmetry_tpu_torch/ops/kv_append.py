"""Fused decode-step KV append into an int8 cache: quantize one new K and V
row per slot and write payload and scale in place.

Port of symmetry_tpu/ops/kv_append.py (`kv_append`, Pallas `_kernel`). On
CUDA tensors `kv_append` launches the hand-written Hopper kernel in
csrc/kv_append.cu; on CPU tensors it runs `kv_append_reference`
(ops/quant.py quantize_kv and index assignment). There is no fallback from
a CUDA tensor to the plain version.

The JAX package takes its kernel only under SYMMETRY_KV_APPEND on a TPU:
that gate is a TPU measurement (XLA's aliasing cost a second cache buffer
there). Here the serving path writes a decode step's row inside the
decode-attention launch instead (ops/decode_attention.py, append mode,
whose int8 write is this kernel's arithmetic and whose plain version is
`kv_append_reference`): a launch of its own for a 17 KB write costs a
launch's fixed time. This kernel stays the TPU kernel's direct counterpart
for a caller that writes rows on their own.

Positions clamp to the last row, min(pos, T - 1): a retired slot's stale
length may reach capacity, and its garbage row stays in its own lane.
"""

from __future__ import annotations

import torch

from symmetry_tpu_torch.ops import kernels
from symmetry_tpu_torch.ops.quant import quantize_kv

MAX_HEAD_DIM = 256


def kv_append(
    cache_k: torch.Tensor,    # [L, B, T, K, D] int8, written in place
    cache_v: torch.Tensor,
    k_scale: torch.Tensor,    # [L, B, K, T] float32 (position minor)
    v_scale: torch.Tensor,
    k_new: torch.Tensor,      # [B, K, D] post-rope K for this step
    v_new: torch.Tensor,
    layer: int,
    positions: torch.Tensor,  # [B] int32 write position per slot
) -> None:
    L, B, T, K, D = cache_k.shape
    if (cache_v.shape != cache_k.shape or k_scale.shape != (L, B, K, T)
            or v_scale.shape != k_scale.shape or k_new.shape != (B, K, D)
            or v_new.shape != k_new.shape or positions.shape != (B,)):
        raise ValueError(
            f"kv_append: caches {tuple(cache_k.shape)} / "
            f"{tuple(cache_v.shape)}, scales {tuple(k_scale.shape)} / "
            f"{tuple(v_scale.shape)}, rows {tuple(k_new.shape)} / "
            f"{tuple(v_new.shape)}, positions {tuple(positions.shape)}")
    layer = int(layer)
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} out of range for {L} layers")
    if cache_k.device.type == "cpu":
        kv_append_reference(cache_k, cache_v, k_scale, v_scale, k_new,
                            v_new, layer, positions)
        return
    if cache_k.device.type != "cuda":
        raise ValueError(f"kv_append: unsupported device {cache_k.device}")
    operands = (("cache_k", cache_k), ("cache_v", cache_v),
                ("k_scale", k_scale), ("v_scale", v_scale), ("k_new", k_new),
                ("v_new", v_new), ("positions", positions))
    for name, t in operands:
        if t.device != cache_k.device:
            raise ValueError(f"kv_append: {name} on {t.device}, cache on "
                             f"{cache_k.device}")
        if not t.is_contiguous():
            raise ValueError(f"kv_append: {name} must be contiguous")
    if cache_k.dtype != torch.int8 or cache_v.dtype != torch.int8:
        raise TypeError("kv_append: the caches must be int8")
    if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
        raise TypeError("kv_append: the scale planes must be float32")
    if v_new.dtype != k_new.dtype or positions.dtype != torch.int32:
        raise TypeError("kv_append: k_new and v_new share one dtype; "
                        "positions are int32")
    if D > MAX_HEAD_DIM:
        raise ValueError(f"kv_append: head_dim {D} > {MAX_HEAD_DIM}")
    lib = kernels.library("kv_append")
    rc = lib.kv_append_launch(
        kernels.dtype_code(k_new.dtype), k_new.data_ptr(), v_new.data_ptr(),
        cache_k.data_ptr(), cache_v.data_ptr(), k_scale.data_ptr(),
        v_scale.data_ptr(), positions.data_ptr(), L, B, T, K, D, layer,
        torch.cuda.current_stream(cache_k.device).cuda_stream)
    kernels.check(rc, "kv_append")
    kv_append.launches += 1


kv_append.launches = 0


def kv_append_reference(cache_k, cache_v, k_scale, v_scale, k_new, v_new,
                        layer: int, positions: torch.Tensor) -> None:
    """Plain version: quantize_kv on each new row, then index assignment at
    (layer, slot, min(pos, T - 1))."""
    B, T = cache_k.shape[1], cache_k.shape[2]
    b = torch.arange(B, device=cache_k.device)
    pos = torch.clamp(positions.long(), 0, T - 1)
    for cache, scales, new in ((cache_k, k_scale, k_new),
                               (cache_v, v_scale, v_new)):
        q, s = quantize_kv(new)            # [B, K, D], [B, K]
        cache[layer, b, pos] = q
        scales[layer, b, :, pos] = s
