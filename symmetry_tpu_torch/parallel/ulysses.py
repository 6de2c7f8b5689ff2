"""Ulysses-style sequence parallelism: all-to-all head scatter (port of
symmetry_tpu/parallel/ulysses.py).

The second long-context scheme beside ring attention (parallel/ring.py):

  ring:    K/V blocks rotate through every rank (n shift steps); any head
           count;
  ulysses: ONE all-to-all re-shards the data from sequence-sharded to
           head-sharded, every rank runs plain full-sequence attention on
           its head subset, and a second all-to-all restores sequence
           sharding. Two collectives, but num_kv_heads % shard_count == 0.

The head split under GQA: heads are laid out k-major (h = kv_head * group
+ g), so a contiguous split of the H axis into n chunks is a contiguous
split of the KV-head axis: each rank gets K/n kv heads with all their query
heads, and the local attention's h // group mapping is unchanged.

The local attention is the port's plain `gqa_attention` (ops/attention.py,
absolute-position causal masking, ragged seq_lens), as the JAX module's is
its jnp `gqa_attention`: no kernel.

`ulysses_attention` takes the whole q/k/v, as the JAX function takes
global arrays: each rank cuts its sequence shard, runs the two
all-to-alls around the local attention, and the output shards are
all-gathered on the sequence dim, so every rank returns the whole
[B, S, H, D].

On a mesh with a `model` axis too (`head_axis`), a rank's q/k/v hold its
block of the heads, and the all-to-alls run over its own `context` line.
The JAX function sees the whole heads inside its shard_map (GSPMD gathers
the model-sharded projections in and scatters the output out), so the
refusals judge the whole head counts. Where the rank's kv heads split
over `context` the rank scatters them and no other traffic is added;
where only the whole heads split (`tiny`'s two kv heads at {context: 2,
model: 2}: one a rank), the rank gathers its `model` line's heads first,
runs Ulysses on the whole heads and keeps its block of the output, as
GSPMD does.
"""

from __future__ import annotations

import torch

from symmetry_tpu_torch.ops.attention import gqa_attention


def _ulysses_shard_fn(q, k, v, seq_lens, mesh, *, axis: str):
    """This rank's body. q [B, Sc, H, D], k/v [B, Sc, K, D] its sequence
    shards; returns its [B, Sc, H, D] block of the output."""
    B = q.shape[0]

    def seq_to_heads(x):
        # [B, Sc, heads, D] -> [B, Sc * n, heads / n, D]: split the head
        # axis across ranks, gather the whole sequence in exchange.
        return mesh.all_to_all(x, axis, split_dim=2, concat_dim=1)

    def heads_to_seq(x):
        return mesh.all_to_all(x, axis, split_dim=1, concat_dim=2)

    q_full = seq_to_heads(q)   # [B, S, H/n, D]
    k_full = seq_to_heads(k)   # [B, S, K/n, D]
    v_full = seq_to_heads(v)

    S = q_full.shape[1]
    positions = torch.arange(S, dtype=torch.int32,
                             device=q.device)[None].expand(B, S)
    out = gqa_attention(q_full, k_full, v_full, positions, seq_lens)
    return heads_to_seq(out)   # [B, Sc, H, D]


def check_shards(S: int, H: int, K: int, n: int) -> None:
    """The JAX function's refusals, in its words: S, and the whole head
    counts H and K, must divide by the shard count n."""
    if S % n:
        raise ValueError(f"sequence {S} not divisible by shard count {n}")
    if K % n or H % n:
        raise ValueError(
            f"ulysses needs heads divisible by shards: H={H}, K={K}, n={n} "
            f"(use ring attention otherwise)")


def ulysses_attention(
    q: torch.Tensor,         # [B, S, H, D], whole on every rank
    k: torch.Tensor,         # [B, S, K, D]
    v: torch.Tensor,
    seq_lens: torch.Tensor,  # [B] valid lengths
    mesh,
    axis: str = "context",
    head_axis: str | None = None,
) -> torch.Tensor:
    """Causal attention with sequence parallelism via head scatter.

    Returns the whole [B, S, H, D] on every rank of the axis. Requires
    num_kv_heads (and so num_heads) divisible by the shard count and S
    divisible by it as well. With `head_axis`, q/k/v and the output hold
    this rank's block of the heads along that axis, and the whole head
    counts must divide."""
    n = mesh.axis_size(axis)
    B, S, H, D = q.shape
    K = k.shape[2]
    blocks = mesh.axis_size(head_axis)
    check_shards(S, H * blocks, K * blocks, n)
    shard_len = S // n
    lo = mesh.axis_index(axis) * shard_len

    def shard(x):
        x = x[:, lo:lo + shard_len].contiguous()
        # the local kv heads do not split over the axis: the whole heads do
        return mesh.all_gather(x, head_axis, dim=2) if K % n else x

    out = _ulysses_shard_fn(shard(q), shard(k), shard(v), seq_lens, mesh,
                            axis=axis)
    if K % n:
        h0 = mesh.axis_index(head_axis) * H
        out = out[:, :, h0:h0 + H].contiguous()
    return mesh.all_gather(out, axis, dim=1)
