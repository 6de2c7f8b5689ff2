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

`verify_tokens` scores speculative drafts against exactly the distribution
`sample_tokens` draws from (both go through `masked_top_logits`).
"""

from __future__ import annotations

import torch

from symmetry_tpu_torch.ops import prng
from symmetry_tpu_torch.ops.attention import NEG_INF

SAMPLING_TOP_CAP = 64


def masked_top_logits(
    logits: torch.Tensor,       # [B, ..., V] float32
    temperature: torch.Tensor,  # [B] float; 0 => greedy
    top_p: torch.Tensor,        # [B] float in (0, 1]; 1 => disabled
    top_k: torch.Tensor,        # [B] int; 0 => disabled
    cap: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Temperature-scaled logits restricted to the top-`cap` window, with
    the greedy / top-k / top-p keep mask applied (NEG_INF elsewhere); the
    per-row controls broadcast over any middle axes. Returns (masked
    [B, ..., cap], vocab indices [B, ..., cap])."""
    ctl = (slice(None),) + (None,) * (logits.ndim - 1)  # [B] -> [B, 1, ..]
    safe_t = torch.where(temperature > 0, temperature,
                         torch.ones_like(temperature))
    scaled = logits / safe_t[ctl]
    top_logits, top_idx = torch.topk(scaled, cap, dim=-1, sorted=True)

    ranks = torch.arange(cap, dtype=torch.int64, device=logits.device)
    # top-k keeps ranks < k (0 disables); greedy is k = 1.
    k = torch.where(top_k > 0, top_k.to(torch.int64),
                    torch.full_like(top_k, cap, dtype=torch.int64))
    k = torch.where(temperature > 0, k, torch.ones_like(k))
    keep = ranks < k[ctl]
    # top-p keeps the smallest prefix whose mass reaches p (rank 0 always).
    probs = torch.softmax(top_logits, dim=-1)
    mass_before = torch.cumsum(probs, dim=-1) - probs
    keep = keep & (mass_before < top_p[ctl])
    # NEG_INF as a Python scalar: a tensor made from it on the card would
    # be a host-to-device copy, which waits for the host.
    return torch.where(keep, top_logits, NEG_INF), top_idx


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


def verify_tokens(
    logits: torch.Tensor,       # [B, S, V] float; S = 1 + k draft lanes
    draft: torch.Tensor,        # [B, k] proposed tokens
    n_draft: torch.Tensor,      # [B] int32 valid proposals per slot (0..k)
    keys: torch.Tensor,         # [B, 2] int64 per-slot threefry key data
    temperature: torch.Tensor,  # [B] float; 0 => greedy
    top_p: torch.Tensor,        # [B] float in (0, 1]
    top_k: torch.Tensor,        # [B] int
    cap: int = SAMPLING_TOP_CAP,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Speculative-decoding acceptance (symmetry_tpu/ops/sampling.py
    verify_tokens) over one batched verify forward. `logits[:, j]` is the
    target's next-token distribution given the context plus draft[:, :j],
    so position j scores draft[:, j] and position n_draft holds the
    all-accepted bonus.

    Drafts are accepted left to right while u_j < p_target(draft_j), u_j
    uniform in [0, 1) (the n-gram drafter is a deterministic proposer).
    On the first rejection the bonus token is drawn from the residual (the
    target with the rejected proposal removed); with every proposal
    accepted, from the target at the next position. Greedy lanes (a
    one-hot keep set) accept exactly when the draft is the argmax, so
    speculative greedy output is token-identical to plain decode.

    Draws follow the JAX function's: three splits of each slot's key, `u`
    from the first, the residual and full ranks (categorical over [S, cap])
    from the second and third. Returns (out [B, S] int64, n_emit [B]
    int32): out[b, :n_emit[b]] are the tokens to emit, n_emit >= 1."""
    B, S, V = logits.shape
    cap = min(cap, V)
    dev = logits.device
    masked, top_idx = masked_top_logits(logits.to(torch.float32),
                                        temperature, top_p, top_k, cap)
    p = torch.softmax(masked, dim=-1)       # target probs over the keep set

    # Probability the target gives each proposal (0 outside the top-cap
    # window). Lane S-1 has no proposal; the validity mask drops it.
    draft_ext = torch.cat([draft.to(torch.int64),
                           torch.zeros((B, 1), dtype=torch.int64,
                                       device=dev)], dim=1)     # [B, S]
    match = top_idx == draft_ext[:, :, None]                    # [B, S, cap]
    p_draft = torch.where(match, p, torch.zeros_like(p)).sum(-1)

    ks = prng.split(keys, 3)                                    # [B, 3, 2]
    u = prng.uniform(ks[:, 0], S)                               # [B, S]
    lane = torch.arange(S, dtype=torch.int64, device=dev)[None, :]
    accept = (u < p_draft) & (lane < n_draft[:, None])
    # Longest accepted prefix: rejections (and the padded tail) stop it.
    n_acc = torch.cumprod(accept.to(torch.int32), dim=1).sum(dim=1)

    # Bonus candidates at every position, selected by n_acc below: the
    # residual for a mid-run stop, a plain target draw after a full run.
    resid = torch.where(match, torch.full_like(masked, NEG_INF), masked)
    r_tok = torch.gather(top_idx, -1,
                         prng.categorical(ks[:, 1], resid)[..., None])[..., 0]
    f_tok = torch.gather(top_idx, -1,
                         prng.categorical(ks[:, 2], masked)[..., None])[..., 0]

    stop = n_acc[:, None].to(torch.int64)
    bonus = torch.where(n_acc < n_draft,
                        torch.gather(r_tok, 1, stop)[:, 0],
                        torch.gather(f_tok, 1, stop)[:, 0])
    out = torch.where(lane < stop, draft_ext, torch.zeros_like(draft_ext))
    out = torch.where(lane == stop, bonus[:, None], out)
    return out, (n_acc + 1).to(torch.int32)
