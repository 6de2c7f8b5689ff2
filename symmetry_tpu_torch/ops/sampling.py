"""Token sampling: greedy / temperature / top-k / top-p, batched
(symmetry_tpu/ops/sampling.py).

Controls are per-slot tensors, so one code path serves a continuous batch
of mixed greedy and sampled requests. Sampling is restricted to the top
SAMPLING_TOP_CAP logits, with the same keep masks as the JAX package:
greedy and any top_k <= cap are exact; top-p loses only the mass beyond the
cap.

Noise: each row draws with its own threefry key (ops/prng.py), as the JAX
package's per-slot `jax.random.categorical`: the [B, cap] Gumbel noise of a
whole batch comes from one vectorized pass on the device, a seeded request
samples the JAX engine's tokens, and one slot's draws never depend on
another's traffic.
"""

from __future__ import annotations

import torch

from symmetry_tpu_torch.ops import prng
from symmetry_tpu_torch.ops.attention import NEG_INF

SAMPLING_TOP_CAP = 64


def masked_top_logits(
    logits: torch.Tensor,       # [B, V] float32
    temperature: torch.Tensor,  # [B] float; 0 => greedy
    top_p: torch.Tensor,        # [B] float in (0, 1]; 1 => disabled
    top_k: torch.Tensor,        # [B] int; 0 => disabled
    cap: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Temperature-scaled logits restricted to the top-`cap` window, with
    the greedy / top-k / top-p keep mask applied (NEG_INF elsewhere).
    Returns (masked [B, cap], vocab indices [B, cap])."""
    safe_t = torch.where(temperature > 0, temperature,
                         torch.ones_like(temperature))
    scaled = logits / safe_t[:, None]
    top_logits, top_idx = torch.topk(scaled, cap, dim=-1, sorted=True)

    ranks = torch.arange(cap, dtype=torch.int64, device=logits.device)
    # top-k keeps ranks < k (0 disables); greedy is k = 1.
    k = torch.where(top_k > 0, top_k.to(torch.int64),
                    torch.full_like(top_k, cap, dtype=torch.int64))
    k = torch.where(temperature > 0, k, torch.ones_like(k))
    keep = ranks[None, :] < k[:, None]
    # top-p keeps the smallest prefix whose mass reaches p (rank 0 always).
    probs = torch.softmax(top_logits, dim=-1)
    mass_before = torch.cumsum(probs, dim=-1) - probs
    keep &= mass_before < top_p[:, None]
    return torch.where(keep, top_logits,
                       torch.tensor(NEG_INF, dtype=top_logits.dtype,
                                    device=logits.device)), top_idx


def sample_tokens(
    logits: torch.Tensor,       # [B, V] float
    keys: torch.Tensor,         # [B, 2] int64 per-row threefry key data
    temperature: torch.Tensor,  # [B] float; 0 => greedy
    top_p: torch.Tensor,        # [B] float in (0, 1]; 1 => disabled
    top_k: torch.Tensor,        # [B] int; 0 => disabled
    cap: int = SAMPLING_TOP_CAP,
) -> torch.Tensor:
    """Returns sampled token ids [B] int64.

    A categorical draw over the top-cap window (prng.categorical: the
    argmax of masked logits plus Gumbel noise). Greedy rows keep only rank
    0 unmasked, and bounded noise cannot lift a NEG_INF lane over it, so
    greedy is the exact argmax."""
    cap = min(cap, logits.shape[-1])
    masked, top_idx = masked_top_logits(logits.to(torch.float32),
                                        temperature, top_p, top_k, cap)
    choice = prng.categorical(keys, masked)
    return torch.gather(top_idx, 1, choice[:, None])[:, 0]
