"""Threefry-2x32 keys and draws, bit for bit as the JAX package's `jax.random`
computes them (jax_threefry_partitionable on, 64-bit types off: the
installed JAX's defaults), so a seeded request samples the same tokens in
both packages.

Port of what symmetry_tpu/engine/engine.py and symmetry_tpu/ops/sampling.py
call: `jax.random.key(seed)` (key data as `jax.random.key_data` gives it),
`split`, `fold_in`, 32-bit `bits`, `uniform(minval=tiny, maxval=1)`, the
Gumbel draw, and `categorical` (argmax of logits plus Gumbel noise).

A key is two 32-bit words. On tensors a key is int64 [..., 2] holding
values below 2**32 and every operation masks back to 32 bits, so the CPU
and the card give the same words; `threefry2x32` takes Python ints as well
(the host derives a request's keys with no tensor at all). Every function
over tensors is vectorized over the leading dims: one pass draws the noise
of a whole batch, and nothing reads a device value back to the host.
`torch.log` may differ from XLA's `log` in the last bit, so a Gumbel draw
agrees with JAX's to within an ulp or two; the bits and the uniforms are
bit-equal.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_TINY = torch.finfo(torch.float32).tiny


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of the counter pair (x1, x2)
    under the key (k1, k2): Python ints or int64 tensors of 32-bit values,
    broadcast together. Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & M32
    x2 = (x2 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & M32
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & M32
    return x1, x2


def key_data(seed: int) -> tuple[int, int]:
    """`jax.random.key_data(jax.random.key(seed))` with 64-bit types off:
    the seed is taken as a 32-bit integer (its low 32 bits, two's
    complement), the high word zero."""
    return 0, int(seed) & M32


def split_key(key: tuple[int, int], num: int = 2) -> list[tuple[int, int]]:
    """`jax.random.split` of one key, on the host: key i hashes the counter
    (0, i)."""
    return [threefry2x32(key[0], key[1], 0, i) for i in range(num)]


def fold_in_key(key: tuple[int, int], data: int) -> tuple[int, int]:
    """`jax.random.fold_in` of one key with a 32-bit datum, on the host:
    the hash of the counter (0, data)."""
    return threefry2x32(key[0], key[1], 0, int(data) & M32)


def split(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
    """`jax.random.split` over int64 keys [..., 2] -> [..., num, 2]."""
    lo = torch.arange(num, dtype=torch.int64, device=keys.device)
    y1, y2 = threefry2x32(keys[..., 0, None], keys[..., 1, None], 0, lo)
    return torch.stack((y1, y2), dim=-1)


def bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """`jax.random.bits(key, (n,))`, 32-bit, over int64 keys [..., 2] ->
    [..., n] int64: the two words of the hash of the counter (0, j) xored."""
    lo = torch.arange(n, dtype=torch.int64, device=keys.device)
    y1, y2 = threefry2x32(keys[..., 0, None], keys[..., 1, None], 0, lo)
    return y1 ^ y2


def uniform(keys: torch.Tensor, n: int, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """`jax.random.uniform(key, (n,), float32, minval, maxval)` over keys
    [..., 2] -> [..., n] float32: 23 random mantissa bits under the
    exponent of 1.0, minus 1, scaled into [minval, maxval), at least
    minval."""
    f = ((bits(keys, n) >> 9) | 0x3F800000).to(torch.int32)
    # The bounds as float32 values, and their float32 difference (host
    # scalars: no copy to the card).
    lo32, hi32 = (torch.tensor(v, dtype=torch.float32)
                  for v in (minval, maxval))
    lo, span = float(lo32), float(hi32 - lo32)
    floats = f.view(torch.float32) - 1.0
    return torch.clamp_min(floats * span + lo, lo)


def gumbel(keys: torch.Tensor, n: int) -> torch.Tensor:
    """`jax.random.gumbel(key, (n,), float32)` (mode "low"): -log(-log(u))
    with u uniform in [tiny, 1)."""
    return -torch.log(-torch.log(uniform(keys, n, minval=_TINY)))


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """`jax.random.categorical(key, logits_b)` for each b: keys [B, 2],
    logits [B, ..., n] float32 -> [B, ...] int64, the argmax over the last
    axis of logits plus Gumbel noise drawn over logits_b's whole shape in
    C order, as JAX draws it (first index on a tie, as jnp.argmax)."""
    noise = gumbel(keys, logits[0].numel()).reshape(logits.shape)
    return torch.argmax(logits + noise, dim=-1)
