"""RMSNorm with float32 accumulation (symmetry_tpu/ops/norm.py), plus the
gemma family's (1 + w) scale (symmetry_tpu/models/llama.py `_norm_w`)."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """LlamaRMSNorm semantics: normalize in f32, scale, cast back."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * weight.to(torch.float32)).to(x.dtype)


def norm_weight(w: torch.Tensor, plus_one: bool) -> torch.Tensor:
    """The scale rms_norm applies. Gemma stores it as (weight - 1) and the
    model applies (1 + w); the add runs in float32, as HF GemmaRMSNorm does,
    so a bf16 checkpoint does not round the multiplier at every norm."""
    if not plus_one:
        return w
    return w.to(torch.float32) + 1.0
