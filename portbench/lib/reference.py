"""The plain float32 reference: Mistral and Mixtral as published.

One decoder layer, written from the models' descriptions (Mistral 7B,
arXiv:2310.06825; Mixtral of Experts, arXiv:2401.04088; the
MistralForCausalLM and MixtralForCausalLM configs): RMSNorm, rotary
positions (rotate-half, base `rope_theta`), causal grouped-query attention
scaled by 1 / sqrt(head_dim), then a SwiGLU MLP, or for Mixtral the sum of
the top-2 experts' SwiGLU outputs weighted by a softmax over the two
selected router logits. Everything is float32 with TF32 off, with no
kernel, cache, batching or padding: each sequence runs whole, and no token
is ever dropped. It imports nothing of the program.

Layers are run one at a time over every sequence, with the layer's weights
drawn again from the seed (weights.py), so the reference needs one layer's
float32 weights at once.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.lib import weights as W

# Query rows per attention block: bounds the [heads, rows, length] scores.
_Q_BLOCK = 512


def exact_float32() -> None:
    """Plain float32 products: TF32 off for matmuls and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [S, heads, D] at positions 0..S-1."""
    S, _, D = x.shape
    inv = 1.0 / theta ** (torch.arange(0, D, 2, dtype=torch.float32,
                                       device=x.device) / D)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos = torch.cat([ang.cos(), ang.cos()], -1)[:, None, :]
    sin = torch.cat([ang.sin(), ang.sin()], -1)[:, None, :]
    rot = torch.cat([-x[..., D // 2:], x[..., :D // 2]], -1)
    return x * cos + rot * sin


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
              ) -> torch.Tensor:
    """Causal GQA: q [S, H, D], k and v [S, K, D] -> [S, H * D]."""
    S, H, D = q.shape
    group = H // k.shape[1]
    k = k.repeat_interleave(group, dim=1).transpose(0, 1)   # [H, S, D]
    v = v.repeat_interleave(group, dim=1).transpose(0, 1)
    qt = q.transpose(0, 1) * D ** -0.5
    out = torch.empty((H, S, D), dtype=torch.float32, device=q.device)
    for r0 in range(0, S, _Q_BLOCK):
        r1 = min(S, r0 + _Q_BLOCK)
        scores = qt[:, r0:r1] @ k[:, :r1].transpose(1, 2)   # [H, r, r1]
        rows = torch.arange(r0, r1, device=q.device)[:, None]
        cols = torch.arange(r1, device=q.device)[None, :]
        scores.masked_fill_(cols > rows, float("-inf"))
        out[:, r0:r1] = torch.softmax(scores, -1) @ v[:, :r1]
    return out.transpose(0, 1).reshape(S, H * D)


def swiglu(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
           wd: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ wg) * (x @ wu)) @ wd


def mixture(x: torch.Tensor, lw: dict, top_k: int) -> torch.Tensor:
    """Mixtral's sparse MLP over x [S, E]: each token's top-k experts by
    router logit, weighted by the softmax over the selected logits."""
    vals, idx = torch.topk(x @ lw["router"], top_k, dim=-1)
    gates = torch.softmax(vals, -1)
    out = torch.zeros_like(x)
    for e in range(lw["wg"].shape[0]):
        tok, choice = torch.nonzero(idx == e, as_tuple=True)
        if tok.numel():
            xe = x[tok]
            y = swiglu(xe, lw["wg"][e], lw["wu"][e], lw["wd"][e])
            out.index_add_(0, tok, y * gates[tok, choice][:, None])
    return out


def layer(h: torch.Tensor, lw: dict, d: W.Dims) -> torch.Tensor:
    """One decoder layer over one sequence's hidden states [S, E]."""
    S = h.shape[0]
    x = rms_norm(h, lw["attn_norm"], d.eps)
    q = rope((x @ lw["wq"]).reshape(S, d.heads, d.head_dim), d.rope_theta)
    k = rope((x @ lw["wk"]).reshape(S, d.kv_heads, d.head_dim),
             d.rope_theta)
    v = (x @ lw["wv"]).reshape(S, d.kv_heads, d.head_dim)
    h = h + attention(q, k, v) @ lw["wo"]
    x = rms_norm(h, lw["mlp_norm"], d.eps)
    if d.experts:
        return h + mixture(x, lw, d.top_k)
    return h + swiglu(x, lw["wg"], lw["wu"], lw["wd"])


def logits_at(d: W.Dims, seqs: list[list[int]], positions: list[list[int]],
              layer_weights, top: dict[str, torch.Tensor],
              device: torch.device) -> list[torch.Tensor]:
    """float32 logits [len(positions[i]), vocab] of each sequence at the
    given positions. `layer_weights(l)` returns layer l's float32 leaves;
    `top` holds embed, final_norm and lm_head."""
    hs = [top["embed"][torch.tensor(s, device=device)] for s in seqs]
    for li in range(d.layers):
        lw = layer_weights(li)
        hs = [layer(h, lw, d) for h in hs]
        del lw
    head = top["embed"].T if d.tie else top["lm_head"]
    out = []
    for h, pos in zip(hs, positions):
        sel = h[torch.tensor(pos, device=device)]
        out.append(rms_norm(sel, top["final_norm"], d.eps) @ head)
    return out


def fp8_columns(w: torch.Tensor) -> torch.Tensor:
    """w rounded through float8 e4m3 with one scale per output column."""
    amax = w.abs().amax(dim=-2, keepdim=True).clamp_min(1e-12)
    scale = amax / 448.0
    return (w / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def int4_columns(w: torch.Tensor) -> torch.Tensor:
    """w rounded to int4 (-7..7) with one scale per output column."""
    amax = w.abs().amax(dim=-2, keepdim=True).clamp_min(1e-12)
    scale = amax / 7.0
    return torch.clamp(torch.round(w / scale), -7, 7) * scale


# The control's precision, one step below what a configuration states.
LOWER = {"bfloat16": fp8_columns, "int8": int4_columns}


def lower_transform(step: str):
    """The control's weight transform: every product's weight (the router
    aside, which stays as stated) through the precision `step`."""
    fn = LOWER[step]

    def transform(name: str, w: torch.Tensor) -> torch.Tensor:
        return w if name == "router" else fn(w)

    return transform
