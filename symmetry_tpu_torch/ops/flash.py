"""Flash attention for prefill: causal, GQA, ragged lengths, optional window.

Port of symmetry_tpu/ops/flash.py (`flash_prefill`, Pallas `_flash_kernel`).
On a CUDA tensor, `flash_prefill` launches the hand-written Hopper kernel in
csrc/flash_prefill.cu; on a CPU tensor it runs `flash_prefill_reference`,
a masked float32 softmax over materialized scores. Nothing else is accepted:
there is no fallback from a CUDA tensor to the plain version.

The kernel streams K/V tiles through shared memory with an online softmax,
so the [H, S, S] scores never reach device memory. Inputs keep the model's
[B, S, H, D] layout and are read through their strides (no transpose copy);
query head h reads KV head h // group in place, so repeated K/V is never
materialized.
"""

from __future__ import annotations

import torch

from symmetry_tpu_torch.ops import kernels
from symmetry_tpu_torch.ops.attention import NEG_INF

# The bucket contract of the JAX kernel: S must be a multiple of
# min(BLOCK, S). The CUDA kernel tiles 64 rows and masks the ragged edge.
BLOCK = 128
HEAD_DIMS = (16, 32, 64, 128, 256)


def _check_args(q, k, v, seq_lens):
    if q.ndim != 4 or k.shape != v.shape or k.ndim != 4:
        raise ValueError(f"flash_prefill: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    B, S, H, D = q.shape
    if k.shape[0] != B or k.shape[1] != S or k.shape[3] != D:
        raise ValueError("flash_prefill: k/v must be [B, S, K, D] like q")
    if H % k.shape[2]:
        raise ValueError(f"{H} query heads do not group over "
                         f"{k.shape[2]} KV heads")
    if seq_lens.shape != (B,):
        raise ValueError(f"seq_lens {tuple(seq_lens.shape)} != ({B},)")
    blk = min(BLOCK, S)
    if S % blk:
        raise ValueError(f"S={S} not a multiple of blocks {blk}/{blk}")


def flash_prefill(
    q: torch.Tensor,         # [B, S, H, D]
    k: torch.Tensor,         # [B, S, K, D]
    v: torch.Tensor,         # [B, S, K, D]
    seq_lens: torch.Tensor,  # [B] int32 valid prompt lengths
    *,
    window: int | None = None,  # mistral-style sliding-window span
) -> torch.Tensor:
    """Causal self-attention over a fresh (cache-empty) padded prompt.

    Returns [B, S, H, D] in q's dtype. Positions are 0..S-1 (the engine's
    prefill-from-empty contract). Rows at or past a sample's seq_len are
    garbage by contract but finite."""
    _check_args(q, k, v, seq_lens)
    if q.device.type == "cpu":
        return flash_prefill_reference(q, k, v, seq_lens, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_prefill: unsupported device {q.device}")
    B, S, H, D = q.shape
    K = k.shape[2]
    for name, t in (("k", k), ("v", v), ("seq_lens", seq_lens)):
        if t.device != q.device:
            raise ValueError(f"flash_prefill: {name} on {t.device}, "
                             f"q on {q.device}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_prefill: q, k and v must share one dtype")
    if seq_lens.dtype != torch.int32 or not seq_lens.is_contiguous():
        raise TypeError("flash_prefill: seq_lens must be contiguous int32")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_prefill: head_dim {D} not in {HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"flash_prefill: {name}'s head_dim must be "
                             f"contiguous")
    code = kernels.dtype_code(q.dtype)
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lib = kernels.library("flash_prefill")
    rc = lib.flash_prefill_launch(
        code, q.data_ptr(), k.data_ptr(), v.data_ptr(), seq_lens.data_ptr(),
        out.data_ptr(), B, S, H, K, D,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        int(window or 0), torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check(rc, "flash_prefill")
    flash_prefill.launches += 1
    return out


flash_prefill.launches = 0


def flash_prefill_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    seq_lens: torch.Tensor, *, window: int | None = None,
) -> torch.Tensor:
    """Plain version: masked float32 softmax over materialized scores, with
    the kernel's mask (kv <= q, kv < seq_len, kv > q - window)."""
    B, S, H, D = q.shape
    K = k.shape[2]
    group = H // K
    qg = q.reshape(B, S, K, group, D).to(torch.float32) * D ** -0.5
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k.to(torch.float32))
    pos = torch.arange(S, device=q.device)
    mask = ((pos[None, :] <= pos[:, None])[None]
            & (pos[None, None, :] < seq_lens.to(pos.dtype)[:, None, None]))
    if window is not None:
        mask &= (pos[None, :] > pos[:, None] - window)[None]
    scores = torch.where(mask[:, None, None], scores,
                         torch.tensor(NEG_INF, dtype=torch.float32,
                                      device=q.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.to(torch.float32))
    return out.reshape(B, S, H, D).to(q.dtype)
