"""Ragged decode attention: one query position per slot against the full
[L, B, T, K, D] cache, reading only each slot's occupied prefix.

Port of symmetry_tpu/ops/decode_attention.py (`decode_attention`, Pallas
`_kernel` for bf16/f32 caches and `_quant_kernel` for int8 caches). On a
CUDA tensor, `decode_attention` launches the hand-written Hopper kernels in
csrc/decode_attention.cu; on a CPU tensor it runs
`decode_attention_reference`, which is `gqa_attention` at S = 1 on the layer
slice. There is no fallback from a CUDA tensor to the plain version.

The full cache is the kernel's operand and `layer` selects its slice by
pointer offset, never by a copied slice. Each call launches two kernels:
the split kernel runs one thread block per (KV head x chunk of up to 8 of
its query heads, slot, span of `SPAN` positions) -- `split_plan` cuts the
capacity T into those spans -- and writes each live span's float32 partial
softmax (max, sum, unnormalized output) to scratch; the combine kernel
merges a slot's spans into the output. Blocks whose span holds no live
position exit at once. The number of spans comes from T alone, so the
wrapper never reads a device value. Any group size runs
(`kernel_supports`). An int8 cache comes with [L, B, K, T] float32 scale
planes: the k scale multiplies each score and the v scale each
probability, as in `_quant_kernel`. The TPU kernel's capacity gate
(`supports`) is a TPU measurement and is not carried over: every
single-position decode on the card takes this kernel.
"""

from __future__ import annotations

import torch

from symmetry_tpu_torch.ops import kernels
from symmetry_tpu_torch.ops.attention import gqa_attention

HEAD_DIMS = (16, 32, 64, 128, 256)
# Positions a block of the split kernel reads: 16 spans at a 4096
# capacity, so 8 slots x 8 KV heads give up to 1024 blocks on 132 SMs.
SPAN = 256


def kernel_supports(head_dim: int, group: int) -> bool:
    """True when the CUDA kernels take this head dim and query-heads-per-KV-
    head group: any group of at least one head (`group_tile`)."""
    return head_dim in HEAD_DIMS and group >= 1


def split_plan(capacity: int) -> list[tuple[int, int]]:
    """The spans [start, end) the split kernel cuts a capacity into, in
    order; they cover [0, capacity) with no gap or overlap."""
    return [(s, min(s + SPAN, capacity)) for s in range(0, capacity, SPAN)]


def group_tile(group: int) -> int:
    """Query heads a block serves: the smallest register tile of 1, 2, 4 or
    8 heads that holds the group (groups above 8 take several blocks)."""
    return next(t for t in (1, 2, 4, 8) if t >= min(group, 8))


def live_blocks(lengths, capacity: int, n_kv: int, group: int,
                window: int | None = None) -> int:
    """Split-kernel blocks that find live rows for these slot lengths (the
    rest exit at once): spans meeting [max(len - window, 0), len)."""
    per_head = 0
    for n in lengths:
        n = min(max(int(n), 0), capacity)
        lo = max(n - window, 0) if window else 0
        per_head += sum(max(a, lo) < min(b, n)
                        for a, b in split_plan(capacity))
    return per_head * n_kv * -(-group // group_tile(group))


def decode_attention(
    q: torch.Tensor,          # [B, n_q_heads, D] (single decode position)
    k_cache: torch.Tensor,    # [L, B, T, K, D] FULL cache (bf16/f32 or int8)
    v_cache: torch.Tensor,
    layer: int,               # which layer's cache to read
    kv_length: torch.Tensor,  # [B] int32 valid entries (incl. current token)
    k_scale: torch.Tensor | None = None,  # [L, B, K, T] f32 (int8 caches;
    v_scale: torch.Tensor | None = None,  # position minor)
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
    quantized = k_cache.dtype == torch.int8
    if quantized != (k_scale is not None) or (k_scale is None) != (
            v_scale is None):
        raise ValueError("decode_attention: an int8 cache needs both scale "
                         "planes, and only an int8 cache takes them")
    if quantized and (k_scale.shape != (L, B, K, T)
                      or v_scale.shape != k_scale.shape):
        raise ValueError(f"decode_attention: scales {tuple(k_scale.shape)} / "
                         f"{tuple(v_scale.shape)} != {(L, B, K, T)}")
    layer = int(layer)
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} out of range for {L} layers")
    if q.device.type == "cpu":
        return decode_attention_reference(q, k_cache, v_cache, layer,
                                          kv_length, k_scale, v_scale,
                                          window=window)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    operands = [("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                ("kv_length", kv_length)]
    if quantized:
        operands += [("k_scale", k_scale), ("v_scale", v_scale)]
    for name, t in operands:
        if t.device != q.device:
            raise ValueError(f"decode_attention: {name} on {t.device}, "
                             f"q on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"decode_attention: {name} must be contiguous "
                             f"and 16-byte aligned")
    if v_cache.dtype != k_cache.dtype or (not quantized
                                          and k_cache.dtype != q.dtype):
        raise TypeError("decode_attention: the caches share q's dtype, or "
                        "are both int8")
    if quantized and (k_scale.dtype != torch.float32
                      or v_scale.dtype != torch.float32):
        raise TypeError("decode_attention: scale planes must be float32")
    if kv_length.dtype != torch.int32:
        raise TypeError("decode_attention: kv_length must be int32")
    if not kernel_supports(D, nq // K):
        raise ValueError(f"decode_attention: head_dim {D} not in "
                         f"{HEAD_DIMS}")
    code = kernels.dtype_code(q.dtype)
    out = torch.empty((B, nq, D), dtype=q.dtype, device=q.device)
    n_spans = len(split_plan(T))
    scratch = torch.empty(B * nq * n_spans * (D + 2), dtype=torch.float32,
                          device=q.device)
    lib = kernels.library("decode_attention")
    rc = lib.decode_attention_launch(
        code, kernels.DTYPE_INT8 if quantized else code, q.data_ptr(),
        k_cache.data_ptr(), v_cache.data_ptr(),
        k_scale.data_ptr() if quantized else None,
        v_scale.data_ptr() if quantized else None,
        kv_length.data_ptr(), out.data_ptr(), scratch.data_ptr(), L, B, T, K,
        D, nq, layer, int(window or 0), SPAN, n_spans,
        torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check(rc, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


def decode_attention_reference(
    q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
    layer: int, kv_length: torch.Tensor,
    k_scale: torch.Tensor | None = None, v_scale: torch.Tensor | None = None,
    *, window: int | None = None,
) -> torch.Tensor:
    """Plain version: gqa_attention at S = 1 on the layer slice (the decode
    query sits at position length - 1; lengths are clamped to T as the
    kernel reads them)."""
    T = k_cache.shape[2]
    lengths = torch.clamp(kv_length, max=T)
    positions = (lengths - 1)[:, None]
    return gqa_attention(
        q[:, None], k_cache[layer], v_cache[layer], positions, lengths,
        sliding_window=window,
        k_scale=k_scale[layer] if k_scale is not None else None,
        v_scale=v_scale[layer] if v_scale is not None else None)[:, 0]
