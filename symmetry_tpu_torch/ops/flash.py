"""Flash attention for prefill: causal, GQA, ragged lengths, optional window.

Port of symmetry_tpu/ops/flash.py (`flash_prefill`, Pallas `_flash_kernel`).
On a CUDA tensor, `flash_prefill` launches one of two hand-written Hopper
kernels in csrc/flash_prefill.cu, chosen by `flash_variant` from (dtype,
head_dim): bf16 wider than 32 takes the tensor-core kernel (wgmma, P
rounded to bf16 before the P V product as the JAX kernel rounds it),
everything else the float32 FMA kernel (float32 inputs must not pass
through the tensor cores' reduced precision). Both serve every head dim
the JAX kernel serves on the card's terms (`kernel_supports`: a multiple
of 8 from 16 to 256): a head dim between the built sizes runs at the next
one (`padded_head_dim`) with the columns past it zero, the softmax scale
from the real head dim, and only its columns stored. On a CPU tensor it runs
`flash_prefill_reference`, a masked float32 softmax over materialized
scores. Nothing else is accepted: there is no fallback from a CUDA tensor to
the plain version or from one variant to the other.

Both kernels stream K/V tiles through shared memory with an online softmax,
so the [H, S, S] scores never reach device memory. Inputs keep the model's
[B, S, H, D] layout and are read through their strides (no transpose copy);
query head h reads KV head h // group in place, so repeated K/V is never
materialized. The tensor-core kernel loads through TMA tensor maps, so its
strides must be multiples of 8 elements and its data 16-byte aligned.
"""

from __future__ import annotations

import torch

from symmetry_tpu_torch.ops import kernels
from symmetry_tpu_torch.ops.attention import NEG_INF

# The bucket contract of the JAX kernel: S must be a multiple of
# min(BLOCK, S). The CUDA kernels tile 64 (FMA) or 128 (tensor-core) query
# rows and mask the ragged edge.
BLOCK = 128
# Head dims the kernels are built for; any multiple of 8 between runs at
# the next of them.
HEAD_DIMS = (16, 32, 64, 128, 256)
TC_HEAD_DIMS = (64, 128, 256)


def kernel_supports(dtype: torch.dtype, head_dim: int) -> bool:
    """True when a CUDA kernel takes (dtype, head_dim): float32 or bf16,
    and a head dim that is a multiple of 8 from 16 to 256. The one gate of
    the wrapper and of models/llama.py."""
    return (dtype in (torch.float32, torch.bfloat16)
            and 16 <= head_dim <= HEAD_DIMS[-1] and head_dim % 8 == 0)


def padded_head_dim(head_dim: int) -> int:
    """The built head dim a kernel runs `head_dim` at: the next of
    HEAD_DIMS."""
    return next(d for d in HEAD_DIMS if d >= head_dim)


def flash_variant(dtype: torch.dtype, head_dim: int) -> str:
    """The CUDA kernel that serves (dtype, head_dim): "tensor_core" for
    bf16 whose padded head dim is 64, 128 or 256, else "fma"."""
    if dtype == torch.bfloat16 and padded_head_dim(head_dim) in TC_HEAD_DIMS:
        return "tensor_core"
    return "fma"


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
    if not kernel_supports(q.dtype, D):
        raise ValueError(f"flash_prefill: flash.kernel_supports({q.dtype}, "
                         f"{D}) is false: the kernels take float32 or bf16 "
                         f"at a head_dim that is a multiple of 8 from 16 "
                         f"to {HEAD_DIMS[-1]}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"flash_prefill: {name}'s head_dim must be "
                             f"contiguous")
    code = kernels.dtype_code(q.dtype)
    variant = flash_variant(q.dtype, D)
    if variant == "tensor_core":
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16 or any(x % 8 for x in t.stride()[:3]):
                raise ValueError(
                    f"flash_prefill: the tensor-core kernel's TMA loads "
                    f"need 16-byte-aligned rows; {name}'s strides "
                    f"{t.stride()} must be multiples of 8 and its data "
                    f"16-byte aligned")
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lib = kernels.library("flash_prefill")
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), seq_lens.data_ptr(),
            out.data_ptr(), B, S, H, K, D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], int(window or 0),
            torch.cuda.current_stream(q.device).cuda_stream)
    if variant == "tensor_core":
        rc = lib.flash_prefill_tc_launch(*args)
    else:
        rc = lib.flash_prefill_launch(code, *args)
    kernels.check(rc, f"flash_prefill ({variant})")
    flash_prefill.launches += 1
    flash_prefill.variant_launches[variant] += 1
    return out


flash_prefill.launches = 0
# Launches by kernel variant (flash_variant); they sum to `launches`.
flash_prefill.variant_launches = {"tensor_core": 0, "fma": 0}


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
