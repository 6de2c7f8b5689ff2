"""Rotary position embeddings (RoPE), HF-llama rotate-half convention.

Counterpart of symmetry_tpu/ops/rope.py: cos/sin are computed in float32
whatever the activation dtype, and the result is cast back to x's dtype.
"""

from __future__ import annotations

import torch


def rope_cos_sin(
    positions: torch.Tensor,  # [..., seq] integer absolute positions
    head_dim: int,
    theta: float = 500000.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Return (cos, sin) of shape [..., seq, head_dim], float32."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=positions.device) / head_dim
    inv_freq = 1.0 / (theta ** exponent)                       # [head_dim/2]
    freqs = positions.to(torch.float32)[..., None] * inv_freq  # [..., hd/2]
    emb = torch.cat([freqs, freqs], dim=-1)                    # [..., hd]
    return torch.cos(emb), torch.sin(emb)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(
    x: torch.Tensor,          # [batch, seq, heads, head_dim]
    positions: torch.Tensor,  # [batch, seq]
    theta: float = 500000.0,
) -> torch.Tensor:
    """Rotate q or k by absolute position; returns x's dtype."""
    cos, sin = rope_cos_sin(positions, x.shape[-1], theta)
    cos, sin = cos[..., None, :], sin[..., None, :]  # broadcast over heads
    xf = x.to(torch.float32)
    return (xf * cos + _rotate_half(xf) * sin).to(x.dtype)
