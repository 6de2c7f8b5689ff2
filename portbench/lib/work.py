"""Operations and bytes a call needs, and the chip's peaks.

Counts follow one rule: each input byte is read once and each output byte
written once, at the lengths the traffic really had, whatever a kernel
reads again or pads. So a kernel's count does not depend on what
implements it.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the 700 W
power limit): 989 TFLOP/s in bf16, 1,979 TOP/s in int8, 67 TFLOP/s in
float32 off the tensor cores, 3.35 TB/s of HBM3.
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def least_seconds(flops: float, nbytes: float,
                  peak_flops: float = PEAK_BF16_FLOPS) -> float:
    """The least time the chip could take: the larger of the two bounds."""
    return max(flops / peak_flops, nbytes / PEAK_BYTES)


def flash_prefill(lens: list[int], heads: int, kv_heads: int,
                  head_dim: int, elem: int = 2) -> tuple[float, float]:
    """Causal self-attention over each row's true length n: QK^T and PV
    over the n(n+1)/2 query-key pairs; q, k and v read, the output
    written."""
    flops = sum(4.0 * heads * head_dim * n * (n + 1) / 2 for n in lens)
    nbytes = sum(n * head_dim * elem * (2 * heads + 2 * kv_heads)
                 for n in lens)
    return flops, nbytes


def decode_attention(kv_lens: list[int], heads: int, kv_heads: int,
                     head_dim: int, kv_elem: int, act_elem: int = 2,
                     scales: bool = False) -> tuple[float, float]:
    """One decode step of one layer over every lane: each lane's query
    attends to its kv_len cached keys and values (the step's own row
    included), which are read once; the step's K/V row is read in the
    activation dtype and written into the cache; the output written."""
    flops = sum(4.0 * heads * head_dim * n for n in kv_lens)
    row = kv_heads * head_dim
    per_pos = 2 * row * kv_elem + (2 * kv_heads * 4 if scales else 0)
    nbytes = 0.0
    for n in kv_lens:
        nbytes += n * per_pos                      # cache read
        nbytes += 2 * heads * head_dim * act_elem  # q read, output written
        nbytes += 2 * row * act_elem + per_pos     # new row read, written
    return flops, nbytes


def w8a16_product(m: int, k: int, n: int, act_elem: int = 2
                  ) -> tuple[float, float]:
    """x [m, k] @ (int8 [k, n] x float32 scales [n]) -> [m, n]."""
    return 2.0 * m * k * n, k * n + 4 * n + m * k * act_elem + m * n * act_elem


def matmul_params(d, logits: bool) -> int:
    """Weights one token multiplies through: every layer's projections, the
    router and the top-k experts' MLPs, and the LM head where the token's
    logits are taken. The embedding is gathered, not multiplied."""
    attn = d.hidden * d.q_dim * 2 + d.hidden * d.kv_dim * 2
    mlp = 3 * d.hidden * d.inter * (d.top_k if d.experts else 1)
    router = d.hidden * d.experts
    total = d.layers * (attn + mlp + router)
    return total + (d.hidden * d.vocab if logits else 0)


def token_flops(d, position: int, logits: bool) -> float:
    """Model FLOPs of one token at `position` (0-based): 2 per weight it
    multiplies through, and QK^T and PV over the position + 1 keys it
    attends to, in every layer."""
    return (2.0 * matmul_params(d, logits)
            + 4.0 * d.layers * d.q_dim * (position + 1))


def span_flops(d, start: int, end: int, logits_at_end: bool) -> float:
    """token_flops summed over positions start..end-1, the last one's
    logits taken where `logits_at_end` (a prefill samples one token)."""
    n = end - start
    if n <= 0:
        return 0.0
    attn = 4.0 * d.layers * d.q_dim * (start + end + 1) * n / 2
    return (2.0 * matmul_params(d, False) * n + attn
            + (2.0 * d.hidden * d.vocab if logits_at_end else 0.0))
