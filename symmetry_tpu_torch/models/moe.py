"""Mixture-of-experts MLP, mixtral family (port of symmetry_tpu/models/moe.py).

Two shapes of the same function, chosen by the call's token count as the
JAX package chooses them:

  - the DENSE mixture (`moe_mlp` at decode and for calls of fewer than
    MIN_DISPATCH_TOKENS tokens): every expert runs every token, and the
    top-k router gates (zero outside the selected experts) weight the
    combine. A decode batch touches nearly every expert anyway, so all
    expert weights stream regardless.
  - capacity-factor DISPATCH (`moe_mlp_dispatch`, prefill, chunks and
    verifies of 64 tokens or more): each (token, choice) pair is ranked
    within its expert by a one-hot cumsum, pairs past the expert's
    capacity C are dropped into a trash slot, each expert runs one batched
    matmul over its [C, embed] rows, and `index_add_` scatters the gated
    outputs back to token order. Capacity counts the call's padded tokens,
    pad tokens included, as in the JAX package.

Int8 expert stacks (QuantizedTensor [.., X, K, N] with [.., X, N] scales)
follow the JAX package's mixed dot: the int8 payload is the operand,
products and sums are float32, the per-column scale multiplies the float32
accumulator, and the result is cast to the activation dtype. `pack_tree`
leaves expert stacks flat, as in the JAX package, and on the card every
int8 expert product of at most EXPERT_ROWS (64) rows an expert runs on the
grouped GEMV (ops/moe_gemv.py, csrc/moe_gemv.cu), which launches or
raises: one launch a stack reads each slab once, for `wg` and `wu` with x
shared by every expert. That is every dense-mixture call (decode, verify,
calls under MIN_DISPATCH_TOKENS) and a dispatch whose capacity C is at
most 64. A larger product (the capacity dispatch at C > 64) keeps the
float32 path: each expert's payload copied to float32, one expert at a
time (the transient is one [K, N] slab), and a float32 matmul. On the CPU the grouped GEMV's plain version is that same
arithmetic. A bf16 stack keeps its batched `torch.matmul`.

Top-k selection is a stable descending sort: `jax.lax.top_k` keeps the
lower index among tied values, and `torch.topk` does not.

On a mesh (`mesh`, parallel/) the expert stacks are this rank's block:
[X / N, E, F / M] for wg and wu, [X / N, F / M, E] for wd, with N the
`expert` axis and M the `model` axis; the router stays whole. No sharding
rule maps a token to `expert`, so every expert rank holds the whole token
set, and the function is the one-rank call's, split by experts:

  - the gates, and in the dispatch the slot table, cover all X experts
    and are the same on every rank (the capacity C comes from the whole
    call's T, so the same pairs drop as on one rank);
  - a rank runs only its experts over its F / M slice; the down
    projection's float32 partials are summed over `model` and rounded to
    the activation dtype once (an int8 wd: the sum before the scale), so
    each expert's output is the one-rank call's [.., X, E] row;
  - the gated combine over the rank's experts goes into a float32 partial,
    summed over `expert` and rounded once.

Both sums are order-free where they matter: a token has at most k = 2
nonzero gated terms over all ranks, and the zeros of the other experts add
nothing, so a + b (or a + 0 + b) in float32 is the same whatever the
ranks' order. At bf16 the terms are products of two bf16 values, exact in
float32, so the single rounding gives the one-rank combine's value, whose
einsum and index_add_ also reduce two terms. (With k > 2 the order would
matter.)

A call whose batch is this rank's block of a `data` axis (`batch_axis`:
the engine's decode and verify) runs the dense mixture locally, since it
is row-independent; a dispatch-sized call all-gathers its rows over the
axis, runs the whole call and keeps its rows, so capacity and drops are
the JAX engine's, whose one program sees the global batch.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from symmetry_tpu_torch.ops.moe_gemv import EXPERT_ROWS, moe_gemv
from symmetry_tpu_torch.ops.quant import QuantizedTensor

# Per-expert buffer = ceil(T * top_k / X * CAPACITY_FACTOR) tokens. Pairs
# past an expert's capacity contribute nothing (switch semantics, no
# renormalization); `moe_capacity_factor` = num_experts / top_k makes the
# dispatch lossless.
CAPACITY_FACTOR = 2.0
# Below this many tokens the dense mixture is used even at S > 1.
MIN_DISPATCH_TOKENS = 64


def top_k(logits: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest values along the last axis and their indices, in
    `jax.lax.top_k`'s order: descending, ties to the lower index."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softmax over the last axis, op for op in x's dtype (a bf16
    input rounds after the exp, the sum and the division, as there)."""
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def route_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Router logits [.., X] -> dense gates [.., X]: softmax over the top-k
    logits (mixtral semantics: normalized AFTER selection), zero elsewhere."""
    vals, idx = top_k(logits, k)
    probs = _softmax(vals)
    return torch.zeros_like(logits, dtype=probs.dtype).scatter_(-1, idx, probs)


def _mixed(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """x [.., K] @ q [K, N] in float32 (the int8 payload as the operand)."""
    return torch.matmul(x.to(torch.float32), q.to(torch.float32))


def _int8_experts(x: torch.Tensor, w: QuantizedTensor, *,
                  out_dtype: torch.dtype | None = None,
                  apply_scale: bool = True) -> torch.Tensor:
    """x [X' or 1, M, K] (1: shared by every expert) against the int8 stack
    [X', K, N] -> [X', M, N] in out_dtype (default x's): each expert's
    mixed dot. Up to EXPERT_ROWS rows, the grouped GEMV (its plain
    version on the CPU; on the card it launches or raises); past them the
    float32 copy and product of each expert."""
    if x.shape[1] <= EXPERT_ROWS:
        return moe_gemv(x.contiguous(), w.q, w.scale, out_dtype=out_dtype,
                        apply_scale=apply_scale)
    y = torch.stack([_mixed(x[e if x.shape[0] > 1 else 0], w.q[e])
                     for e in range(w.q.shape[0])])
    if apply_scale:
        y = y * w.scale[:, None, :]
    return y.to(out_dtype or x.dtype)


def _experts(x: torch.Tensor, w) -> torch.Tensor:
    """[T, D] through every expert's [D, F] -> [X, T, F], expert-major."""
    if isinstance(w, QuantizedTensor):
        return _int8_experts(x[None], w)
    # One batched product with x broadcast over the experts: the weight is
    # read in place, never permuted into a copy.
    return torch.matmul(x[None], w)


def qmatmul_experts(x: torch.Tensor, w) -> torch.Tensor:
    """[B, S, D] @ per-expert [X, D, F] -> [B, S, X, F]."""
    B, S, D = x.shape
    y = _experts(x.reshape(B * S, D), w)                   # [X, B*S, F]
    return y.permute(1, 0, 2).reshape(B, S, y.shape[0], y.shape[-1])


def _expert_matmul(xg: torch.Tensor, w) -> torch.Tensor:
    """Per-expert batched matmul: [X, C, A] @ [X, A, F] -> [X, C, F]."""
    if isinstance(w, QuantizedTensor):
        return _int8_experts(xg, w)
    return torch.bmm(xg, w)


def router_logits(x: torch.Tensor, router: torch.Tensor) -> torch.Tensor:
    """Router logits in float32: the product in the activation dtype, then
    the cast, as the JAX package computes them (x is not upcast first)."""
    return (x @ router).to(torch.float32)


def _axis(mesh, axis: str | None) -> int:
    return 1 if mesh is None or axis is None else mesh.axis_size(axis)


def _split(mesh) -> bool:
    """Whether this rank holds a block of the experts (an `expert` or
    `model` axis above 1); other axes leave the stacks whole."""
    return _axis(mesh, "expert") * _axis(mesh, "model") > 1


def _expert_block(w, mesh) -> int:
    """The first expert of this rank's block of a stack."""
    n = (w.q if isinstance(w, QuantizedTensor) else w).shape[0]
    return 0 if mesh is None else mesh.axis_index("expert") * n


def _expert_down(h: torch.Tensor, wd, mesh) -> torch.Tensor:
    """Per-expert down projection [X', C, F'] @ [X', F', E] -> [X', C, E] in
    h's dtype. Over a `model` axis each rank holds an F slice: its float32
    partials are summed over the axis and rounded once (an int8 leaf: the
    sum before the per-column scale), as models/llama.py _row_parallel
    sums a dense row-parallel leaf."""
    if _axis(mesh, "model") == 1:
        return _expert_matmul(h, wd)
    if isinstance(wd, QuantizedTensor):
        part = _int8_experts(h, wd, out_dtype=torch.float32,
                             apply_scale=False)
        part = mesh.all_reduce(part, "model")
        return (part * wd.scale[:, None, :]).to(h.dtype)
    from symmetry_tpu_torch.models.llama import _float32_product

    part = torch.stack([_float32_product(h[e], wd[e])
                        for e in range(wd.shape[0])])
    return mesh.all_reduce(part, "model").to(h.dtype)


def moe_mlp(x: torch.Tensor, lp: dict, config, mesh=None,
            batch_axis: str | None = None) -> torch.Tensor:
    """MoE FFN: [B, S, E] -> [B, S, E]. The dense mixture at decode and
    for small calls, capacity-factor dispatch at prefill. On a mesh, this
    rank's experts (see the module docstring); `batch_axis` names the mesh
    axis x's batch is this rank's block of."""
    B, S, _ = x.shape
    dp = _axis(mesh, batch_axis)
    if S > 1 and B * dp * S >= MIN_DISPATCH_TOKENS:
        if dp == 1:
            return moe_mlp_dispatch(x, lp, config, mesh)
        whole = moe_mlp_dispatch(mesh.all_gather(x, batch_axis, 0), lp,
                                 config, mesh)
        lo = mesh.axis_index(batch_axis) * B
        return whole[lo:lo + B]
    gates = route_top_k(router_logits(x, lp["router"]),
                        config.num_experts_per_tok).to(x.dtype)  # [B, S, X]
    xt = x.reshape(B * S, -1)
    h = F.silu(_experts(xt, lp["wg"])) * _experts(xt, lp["wu"])  # [X', T, F']
    X = h.shape[0]
    y = _expert_down(h, lp["wd"], mesh)                         # [X', T, E]
    y = y.transpose(0, 1).reshape(B, S, X, -1)                  # [B, S, X', E]
    if not _split(mesh):
        return torch.einsum("bsxe,bsx->bse", y, gates)
    # The gated combine of this rank's experts in float32, summed over
    # `expert` and rounded once.
    e0 = _expert_block(lp["wd"], mesh)
    partial = torch.einsum("bsxe,bsx->bse", y.float(),
                           gates[..., e0:e0 + X].float())
    return mesh.all_reduce(partial, "expert").to(x.dtype)


def moe_mlp_dispatch(x: torch.Tensor, lp: dict, config, mesh=None
                     ) -> torch.Tensor:
    """Capacity-factor token dispatch (GShard/Switch shape, static sizes).

    Each (token, choice) pair is ranked within its expert by a one-hot
    cumsum; pairs past the expert's capacity are dropped. Each expert runs
    one batched matmul over its gathered tokens, and a scatter-add puts the
    gated outputs back in token order. On a mesh every rank builds the
    whole slot table and runs only its experts' slots."""
    B, S, E = x.shape
    X = config.num_experts
    k = config.num_experts_per_tok
    cf = getattr(config, "moe_capacity_factor", None) or CAPACITY_FACTOR
    T = B * S
    C = min(T, math.ceil(T * k / X * cf))
    dev = x.device

    xf = x.reshape(T, E)
    vals, idx = top_k(router_logits(xf, lp["router"]), k)    # [T, k]
    probs = _softmax(vals)                                    # mixtral renorm

    flat_expert = idx.reshape(-1)                             # [T*k]
    flat_token = torch.arange(T, device=dev).repeat_interleave(k)
    flat_gate = probs.reshape(-1).to(x.dtype)

    # Rank of each pair within its expert = how many earlier pairs chose
    # the same expert (one-hot cumsum: static shapes, no sort).
    onehot = F.one_hot(flat_expert, X)                        # [T*k, X]
    before = onehot.cumsum(0) - onehot
    rank = before.gather(1, flat_expert[:, None])[:, 0]
    keep = rank < C
    # Slot in the [X * C] dispatch buffer; dropped pairs all target the
    # trash slot X * C, which is sliced off. Every other slot is written by
    # at most one pair, so the duplicate writes land only on the trash.
    slot = torch.where(keep, flat_expert * C + rank,
                       torch.full_like(rank, X * C))
    token_for_slot = torch.zeros(X * C + 1, dtype=torch.long, device=dev)
    token_for_slot[slot] = flat_token
    gate_for_slot = torch.zeros(X * C + 1, dtype=x.dtype, device=dev)
    gate_for_slot[slot] = torch.where(keep, flat_gate,
                                      torch.zeros_like(flat_gate))
    # This rank's experts' slots (all of them on one rank).
    n_local = (lp["wd"].q if isinstance(lp["wd"], QuantizedTensor)
               else lp["wd"]).shape[0]
    e0 = _expert_block(lp["wd"], mesh)
    token_for_slot = token_for_slot[e0 * C:(e0 + n_local) * C]
    gate_for_slot = gate_for_slot[e0 * C:(e0 + n_local) * C]

    # An empty slot gathers token 0 with gate 0: it adds +-0 to token 0.
    xg = xf[token_for_slot].reshape(n_local, C, E)
    h = F.silu(_expert_matmul(xg, lp["wg"])) * _expert_matmul(
        xg, lp["wu"])                                         # [X', C, F']
    y = _expert_down(h, lp["wd"], mesh)                       # [X', C, E]

    weighted = y.reshape(n_local * C, E) * gate_for_slot[:, None]
    if _split(mesh):
        out = torch.zeros((T, E), dtype=torch.float32, device=dev)
        out.index_add_(0, token_for_slot, weighted.float())
        return mesh.all_reduce(out, "expert").to(x.dtype).reshape(B, S, E)
    # index_add_ runs on atomics on CUDA, in no fixed order. A token gets at
    # most k = 2 nonzero terms besides the +-0 of empty slots, and 0 + a + b
    # rounds the same in either order, so the sum is deterministic and
    # equal to the JAX scatter-add's. (With k > 2 the order would matter.)
    out = torch.zeros((T, E), dtype=x.dtype, device=dev)
    out.index_add_(0, token_for_slot, weighted)
    return out.reshape(B, S, E)
