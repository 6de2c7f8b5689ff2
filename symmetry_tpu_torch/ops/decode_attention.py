"""Ragged decode attention: one query position per slot against the full
[L, B, T, K, D] cache, reading only each slot's occupied prefix.

Port of symmetry_tpu/ops/decode_attention.py (`decode_attention`, Pallas
`_kernel`, bf16/f32 caches). On a CUDA tensor, `decode_attention` launches
the hand-written Hopper kernel in csrc/decode_attention.cu; on a CPU tensor
it runs `decode_attention_reference`, which is `gqa_attention` at S = 1 on
the layer slice. There is no fallback from a CUDA tensor to the plain
version.

The full cache is the kernel's operand and `layer` selects its slice by
pointer offset, never by a copied slice. One thread block serves one
(slot, KV head) and all of that head's query heads, so each K/V row is read
once for the group. The TPU kernel's capacity gate (`supports`) is a TPU
measurement and is not carried over: every single-position decode on the
card takes this kernel. Int8 caches (`_quant_kernel`) are not ported yet
(ROADMAP Queue 2).
"""

from __future__ import annotations

import torch

from symmetry_tpu_torch.ops import kernels
from symmetry_tpu_torch.ops.attention import gqa_attention

HEAD_DIMS = (16, 32, 64, 128, 256)
GROUPS = (1, 2, 4, 8)


def decode_attention(
    q: torch.Tensor,          # [B, n_q_heads, D] (single decode position)
    k_cache: torch.Tensor,    # [L, B, T, K, D] FULL cache (bf16/f32)
    v_cache: torch.Tensor,
    layer: int,               # which layer's cache to read
    kv_length: torch.Tensor,  # [B] int32 valid entries (incl. current token)
    *,
    window: int | None = None,  # sliding-window span: keys >= length - window
) -> torch.Tensor:
    """Returns [B, n_q_heads, D] in q's dtype. A slot with kv_length 0 gets
    finite garbage, not NaN. Lengths above T are read as T."""
    if k_cache.ndim != 5 or v_cache.shape != k_cache.shape or q.ndim != 3:
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, caches "
                         f"{tuple(k_cache.shape)} / {tuple(v_cache.shape)}")
    L, B, T, K, D = k_cache.shape
    nq = q.shape[1]
    if q.shape[0] != B or q.shape[2] != D or nq % K:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} does not "
                         f"match cache {tuple(k_cache.shape)}")
    if kv_length.shape != (B,):
        raise ValueError(f"kv_length {tuple(kv_length.shape)} != ({B},)")
    layer = int(layer)
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} out of range for {L} layers")
    if q.device.type == "cpu":
        return decode_attention_reference(q, k_cache, v_cache, layer,
                                          kv_length, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache),
                    ("kv_length", kv_length)):
        if t.device != q.device:
            raise ValueError(f"decode_attention: {name} on {t.device}, "
                             f"q on {q.device}")
    if k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError("decode_attention: q and the caches must share one "
                        "dtype (int8 caches are not ported yet)")
    if kv_length.dtype != torch.int32:
        raise TypeError("decode_attention: kv_length must be int32")
    if D not in HEAD_DIMS or nq // K not in GROUPS:
        raise ValueError(f"decode_attention: head_dim {D} / group {nq // K} "
                         f"not in {HEAD_DIMS} / {GROUPS}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("kv_length", kv_length)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"decode_attention: {name} must be contiguous "
                             f"and 16-byte aligned")
    code = kernels.dtype_code(q.dtype)
    out = torch.empty((B, nq, D), dtype=q.dtype, device=q.device)
    lib = kernels.library("decode_attention")
    rc = lib.decode_attention_launch(
        code, q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        kv_length.data_ptr(), out.data_ptr(), L, B, T, K, D, nq, layer,
        int(window or 0), torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check(rc, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


def decode_attention_reference(
    q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
    layer: int, kv_length: torch.Tensor, *, window: int | None = None,
) -> torch.Tensor:
    """Plain version: gqa_attention at S = 1 on the layer slice (the decode
    query sits at position length - 1; lengths are clamped to T as the
    kernel reads them)."""
    T = k_cache.shape[2]
    lengths = torch.clamp(kv_length, max=T)
    positions = (lengths - 1)[:, None]
    return gqa_attention(q[:, None], k_cache[layer], v_cache[layer],
                         positions, lengths, sliding_window=window)[:, 0]
