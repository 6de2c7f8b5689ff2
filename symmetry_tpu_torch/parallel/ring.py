"""Ring attention: causal attention with K/V sharded over the `context`
mesh axis (port of symmetry_tpu/parallel/ring.py).

Each rank holds one sequence shard of Q/K/V. The K/V shards rotate around
the ring (Mesh.shift: send to the next rank, receive from the previous one,
the JAX ppermute), and every rank folds each visiting K/V block into its
local queries with the online-softmax (running max / running sum) merge the
flash kernel uses, so the full [S, S] score matrix exists nowhere.

Positions are absolute (`my * shard_len + arange`): with Q block-sharded,
later ring steps are partly or wholly masked for low-index ranks, and the
rotation still runs all n steps, as the JAX program's static schedule
does. Plain torch, as the JAX module is plain jnp: no kernel.

`ring_attention` takes the whole q/k/v, as the JAX function takes global
arrays: each rank cuts its shard, runs the ring, and the output shards are
all-gathered on the sequence dim, so every rank returns the whole
[B, S, H, D] (the JAX function's sequence-sharded global result).

On a mesh with other axes above 1 the ring runs over this rank's
`context` line only: the ranks that share its other coordinates (the
shift and the gather use that line's process group). A `model` rank
passes its block of the heads, and attention is independent per head, so
its output is its block of the JAX function's, whose shard_map holds the
heads whole. A `data`, `expert` or `stage` rank holds the whole batch and
every head of its block, as the JAX function replicates them.
"""

from __future__ import annotations

import torch

from symmetry_tpu_torch.ops.attention import NEG_INF


def _partial_attention(q, k, v, q_pos, kv_pos, seq_lens, m, l, acc):
    """Fold one K/V block into the running (m, l, acc) online softmax.

    Grouped GQA shapes throughout: q [B, Sq, H, D]; k/v [B, Sk, K, D];
    q_pos [B, Sq]; kv_pos [Sk]; seq_lens [B];
    m/l [B, K, G, Sq, 1]; acc [B, K, G, Sq, D] (H = K * G). Products
    accumulate in float32; probabilities are rounded to v's dtype before
    the value product, as the JAX version's `p.astype(v.dtype)`."""
    B, Sq, H, D = q.shape
    K = k.shape[2]
    group = H // K
    scale = D ** -0.5

    qg = q.reshape(B, Sq, K, group, D).to(torch.float32)
    s = torch.einsum("bskgd,btkd->bkgst", qg,
                     k.to(torch.float32)) * scale            # [B,K,G,Sq,Sk]

    mask = ((kv_pos[None, None, :] <= q_pos[:, :, None])
            & (kv_pos[None, None, :] < seq_lens[:, None, None]))  # [B,Sq,Sk]
    s = torch.where(mask[:, None, None], s,
                    torch.tensor(NEG_INF, dtype=torch.float32,
                                 device=q.device))

    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    p = torch.exp(s - m_new)
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1, keepdim=True)
    pv = torch.einsum("bkgst,btkd->bkgsd", p.to(v.dtype).to(torch.float32),
                      v.to(torch.float32))
    acc_new = acc * corr + pv
    return m_new, l_new, acc_new


def _ring_shard_fn(q, k, v, seq_lens, mesh, *, axis: str, shard_len: int,
                   n_shards: int):
    """This rank's body. q/k/v [B, Sc, H|K, D] its shards; returns its
    [B, Sc, H, D] block of the output."""
    my = mesh.axis_index(axis)
    B, Sc, H, D = q.shape
    K = k.shape[2]
    group = H // K
    dev = q.device

    ar = torch.arange(Sc, dtype=torch.int32, device=dev)
    q_pos = (my * shard_len + ar)[None, :].expand(B, Sc)

    m = torch.full((B, K, group, Sc, 1), NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((B, K, group, Sc, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, K, group, Sc, D), dtype=torch.float32, device=dev)

    k_cur, v_cur = k, v
    for step in range(n_shards):
        src = (my - step) % n_shards  # whose K/V block this rank holds now
        kv_pos = src * shard_len + ar
        m, l, acc = _partial_attention(q, k_cur, v_cur, q_pos, kv_pos,
                                       seq_lens, m, l, acc)
        if step < n_shards - 1:
            k_cur = mesh.shift(k_cur, axis)
            v_cur = mesh.shift(v_cur, axis)

    l = torch.clamp(l, min=1e-30)  # fully-masked padded rows
    out = (acc / l).to(q.dtype)                      # [B, K, G, Sc, D]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sc, H, D)


def check_shards(S: int, n: int) -> None:
    """The JAX function's refusal, in its words: S must divide by the ring
    size n."""
    if S % n:
        raise ValueError(f"sequence {S} not divisible by ring size {n}")


def ring_attention(
    q: torch.Tensor,         # [B, S, H, D], whole on every rank
    k: torch.Tensor,         # [B, S, K, D]
    v: torch.Tensor,
    seq_lens: torch.Tensor,  # [B] valid lengths
    mesh,
    axis: str = "context",
) -> torch.Tensor:
    """Causal ring attention over the context mesh axis. Returns the whole
    [B, S, H, D] on every rank of the axis; each rank computes its sequence
    shard, and the shards are all-gathered. Any head count: q/k/v may hold
    a rank's block of the heads."""
    n = mesh.axis_size(axis)
    B, S, H, D = q.shape
    check_shards(S, n)
    shard_len = S // n
    lo = mesh.axis_index(axis) * shard_len

    def shard(x):
        return x[:, lo:lo + shard_len].contiguous()

    out = _ring_shard_fn(shard(q), shard(k), shard(v), seq_lens, mesh,
                         axis=axis, shard_len=shard_len, n_shards=n)
    return mesh.all_gather(out, axis, dim=1)
