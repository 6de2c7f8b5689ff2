"""Grouped-query attention over a static KV cache (symmetry_tpu/ops/attention.py).

The plain continuation path: q covers S positions, the cache already holds
their K/V, and masking is by absolute position, so one routine serves ragged
slots at static shapes. It is also the plain reference for the decode
kernel (ops/decode_attention.py). Query heads are grouped onto their KV head
([B, K, G, S, D]) instead of materializing repeated K/V.
"""

from __future__ import annotations

import torch

NEG_INF = -2.0**30  # large-but-finite: keeps softmax NaN-free for all-masked rows


def gqa_attention(
    q: torch.Tensor,            # [B, S, n_q_heads, head_dim]
    k_cache: torch.Tensor,      # [B, T, n_kv_heads, head_dim]  (T = capacity)
    v_cache: torch.Tensor,      # [B, T, n_kv_heads, head_dim]
    q_positions: torch.Tensor,  # [B, S] absolute position of each query token
    kv_length: torch.Tensor,    # [B] number of valid cache entries per sample
    sliding_window: int | None = None,  # mistral-style local attention span
) -> torch.Tensor:
    """Returns [B, S, n_q_heads, head_dim] in q's dtype. Softmax in f32.

    Products accumulate in float32, as the JAX version's
    preferred_element_type does; probabilities are rounded to q's dtype
    before the value product, as there."""
    B, S, n_q, D = q.shape
    T, n_kv = k_cache.shape[1], k_cache.shape[2]
    group = n_q // n_kv
    scale = D ** -0.5

    qg = q.reshape(B, S, n_kv, group, D).to(torch.float32)
    scores = torch.einsum("bskgd,btkd->bkgst", qg,
                          k_cache.to(torch.float32)) * scale

    kv_pos = torch.arange(T, dtype=torch.int32, device=q.device)
    # key valid iff written (pos < kv_length) and causal (pos <= query pos)
    mask = ((kv_pos[None, None, :] <= q_positions[..., None])
            & (kv_pos[None, None, :] < kv_length[:, None, None]))  # [B, S, T]
    if sliding_window is not None:
        mask &= kv_pos[None, None, :] > q_positions[..., None] - sliding_window
    scores = torch.where(mask[:, None, None], scores,
                         torch.tensor(NEG_INF, dtype=torch.float32,
                                      device=q.device))

    probs = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    probs = probs / probs.sum(dim=-1, keepdim=True)
    probs = probs.to(q.dtype).to(torch.float32)

    out = torch.einsum("bkgst,btkd->bskgd", probs, v_cache.to(torch.float32))
    return out.to(q.dtype).reshape(B, S, n_q, D)
